"""Layout rules for the launch tooling: which block of each leaf a rank
holds, how many bytes that is, and the sharded state that stores those
blocks and gathers them on use.

Port of ``repro/launch/sharding.py``.  The placement rules are the
reference's, leaf by leaf (``param_specs`` / ``cache_specs`` give the same
spec for every leaf on the same mesh shape):

* the greedy divisibility rule (:func:`_greedy_spec`): each weight axis
  ('model', then the FSDP axes) goes to the largest still-free dim (after
  the node and layer axes) that it divides at least twice over;
  ``tie_break_last`` prefers the last dim on a size tie (square weights);
* MoE expert stacks pin 'model' on the expert axis when it divides;
* the node axis rides 'data' in a pod, or 'pod' across pods, where 'data'
  shards the weights too (FSDP); ``n_nodes=1`` shards them over every
  axis (QHM);
* caches put the batch on the data axes (else the longest divisible dim)
  and, with ``shard_features``, 'model' on the last divisible dim.

Specs are tuples in the form of a JAX ``PartitionSpec``: an entry per dim,
an axis name, a tuple of names, or None.  A mesh is a
``launch/mesh.RankMesh`` (ranks), a ``NodeMesh`` (one axis) or a
``MeshShape`` (the shape alone, for a ``meta`` trace).

The port's extensions, each where the reference's rules have no case:
a mesh without a 'model' axis places no weight axis (the node-only meshes
of the dry run); a node count that no axis carries on a mesh whose other
axes are all 1 keeps the node stack whole on every rank (``mesh=None``'s
layout, on a one-rank 'model' group), and :func:`batch_specs` then skips
the stack's leading dim as it skips a node axis.

The sharded state (:class:`Placement`): each rank stores only its block of
every weight, optimizer buffer and cache, cut along the dims these specs
name (:func:`shard_tree`).  Before each use in the forward the model
all-gathers the full tensor (:class:`_GatherOnUse`, one
``all_gather_into_tensor`` a leaf and axis) and drops it after.

The batch (:class:`Rows`, FSDP's data parallelism): a node's batch rows
lie over the plan's data axes where :func:`batch_specs` puts them, and
each rank computes its own rows.  The gradient of a block gathered over an
axis that carries rows is reduce-scattered in the gather's backward (the
ranks' partial sums, each rank keeping its block); over 'model', whose
ranks compute the same rows, the backward keeps the rank's slice.  A leaf
not stored along a row axis has its gradient all-reduced over that axis
once a step (:meth:`Rows.reduce_grads`).  Each rank's loss is its rows'
mean over the row count R, so the ranks' losses sum to the node's.  Where
the reference's constraints name the batch dims None (``shard_activations``
and ``megatron_attn`` in train and prefill) the batch stays whole, as
there.  At one rank every collective returns its input and R = 1 divides
exactly, so the step is ``mesh=None``'s bit for bit.

The compute split (:class:`Split`): the reference's GSPMD also splits the
compute over 'model' under ``megatron_attn``, ``shard_activations`` and
``pin_moe_dispatch``; the port does it with explicit collectives (*f*,
all-reduce, reduce-scatter, all-gather, all-to-all, each an autograd
function with its own vmap rule) on the stored blocks, and never gathers
whole a leaf the split computes with.  Its leaves a rank computes with are the ones a
knob uses; every other leaf is gathered on use as above.

The attention heads split as GSPMD pads them (``Split.head_range``): with
H query heads over a 'model' axis of M ranks, ``c = ceil(H / M)``, and
rank r computes heads ``[r c, min((r + 1) c, H))``, none where ``r c >=
H`` (24 heads over 16: ranks 0-11 two each, 12-15 none).  Where M divides
H that is the rank's block.  Else q reaches the rank's heads from the
stored 'model' block of ``wq`` by one all-to-all (a column block, a
permutation), or as the whole projection cut to the range (a row block's
partial sums all-reduced first); the output goes back to the rows that
'model' stores of ``wo`` by the inverse all-to-all, then row-parallel, its
partial sums reduced over 'model' in the collective's order, as where M
divides H.  A dry run on a ``MeshShape`` traces rank 0, which holds ``c``
heads: the busiest rank.

A decode step's split takes every block kind too: a Mamba-2 mixer's
``in_proj`` and ``out_proj`` on their stored 'model' blocks (the one-token
projection made whole between them) and its ``conv_w`` where 'model'
stores it by the conv cache's channel block, and a cross block's ``wq``,
``wo`` and MLP as a self-attention block's.

The pinned decode (:class:`CacheBlock`, the reference's
``pin_decode_cache``): a decode step attends over, and writes into, the
rank's stored block of each cache leaf, with no cache leaf gathered: the
partial scores summed over the ranks that split the features, a softmax
across the ranks that split the cache's length, and the outputs (rows,
heads, features) all-gathered; ``models/transformer.py`` and
``models/ssm.py`` take the block through the reductions it names.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.models import layers
from repro_torch.tree import tree_flatten, tree_map, tree_paths, \
    tree_unflatten

from .mesh import MeshShape

__all__ = ["ShardingPlan", "NamedSharding", "Placement", "CacheBlock",
           "Split", "Rows", "Tally", "make_plan", "pinned_cache_spec",
           "same_layout", "row_axes",
           "param_specs", "batch_specs", "cache_specs", "named",
           "bytes_per_rank", "local_shape", "shard_tree", "gather_tree",
           "weight_axes"]

PyTree = Any

_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Any
    node_axis: Optional[str]       # 'data' | 'pod' | None
    fsdp_axes: tuple = ()          # axes sharding the weights beside 'model'

    @property
    def data_axes(self) -> tuple:
        """Mesh axes that carry the (per-node) batch in the reference."""
        names = [a for a in dict(self.mesh.shape) if a != self.node_axis]
        return tuple(a for a in names if a != "model")

    @property
    def node_count(self) -> int:
        """Nodes the node axis carries (1 without one)."""
        return dict(self.mesh.shape)[self.node_axis] if self.node_axis \
            else 1

    @property
    def keeps_nodes(self) -> bool:
        """The port's extension: no axis carries the nodes and none shards
        the weights, on a mesh whose axes other than 'model' are all 1 (the
        node stack whole on every rank)."""
        return self.node_axis is None and not self.fsdp_axes \
            and bool(self.data_axes)


def make_plan(mesh, *, n_nodes: int) -> ShardingPlan:
    """The reference's plan: one node (QHM) shards the weights over every
    axis; ``n_nodes`` equal to the 'pod' axis puts the nodes there with
    FSDP over 'data'; equal to 'data' puts them there ('pod' then shards
    the weights).  A mesh whose axes other than 'model' are all 1 keeps any
    node count whole on every rank."""
    axes = dict(mesh.shape)
    if n_nodes <= 1:
        return ShardingPlan(mesh, None,
                            tuple(a for a in axes if a != "model"))
    if "pod" in axes and n_nodes == axes["pod"]:
        return ShardingPlan(mesh, "pod", ("data",))
    if n_nodes == axes.get("data"):
        return ShardingPlan(mesh, "data", ("pod",) if "pod" in axes else ())
    if all(size == 1 for a, size in axes.items() if a != "model"):
        return ShardingPlan(mesh, None, ())
    raise ValueError(f"n_nodes={n_nodes} does not match any mesh axis of "
                     f"{axes}")


def weight_axes(plan: ShardingPlan) -> tuple:
    """The axes that shard weights on ``plan``'s mesh ('model' and the
    FSDP axes that the mesh has)."""
    axes = dict(plan.mesh.shape)
    return tuple(a for a in ("model", *plan.fsdp_axes) if a in axes)


def _greedy_spec(shape, axis_order, mesh_shape, skip_leading=0,
                 pinned=None, tie_break_last=False) -> tuple:
    """Assign mesh axes to dims greedily by size: each axis of
    ``axis_order`` to the largest unassigned dim past ``skip_leading``
    that it divides with at least two blocks; ``tie_break_last`` takes the
    last of equal sizes (output-dim parallelism for square weights)."""
    assign: dict[int, str] = dict(pinned or {})
    used_dims = set(assign)
    for ax in axis_order:
        if ax in assign.values():
            continue
        size = mesh_shape[ax]
        best = None
        for i in range(skip_leading, len(shape)):
            if i in used_dims:
                continue
            if shape[i] % size == 0 and shape[i] >= 2 * size:
                better = best is None or shape[i] > shape[best] or (
                    tie_break_last and shape[i] == shape[best])
                if better:
                    best = i
        if best is not None:
            assign[best] = ax
            used_dims.add(best)
    return tuple(assign.get(i) for i in range(len(shape)))


def _keyed_map(fn, tree):
    """``fn(path, leaf)`` over ``tree``'s leaves, in the tree's shape."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(path, leaf) for path, leaf in
                                    zip(tree_paths(tree), leaves)])


def param_specs(plan: ShardingPlan, params_shape: PyTree, *,
                node_stacked: bool = False,
                tie_break_last: bool = False) -> PyTree:
    """Per-leaf specs of a params (or optimizer-state) tree."""
    mesh_shape = dict(plan.mesh.shape)
    order = weight_axes(plan)
    model = mesh_shape.get("model")

    def spec_for(keys, leaf):
        skip = 0
        pinned = {}
        if node_stacked:
            skip = 1  # node axis (size n_nodes, possibly 1)
            if plan.node_axis:
                pinned[0] = plan.node_axis
        if "blocks" in keys:
            skip += 1  # stacked layer axis stays unsharded
        shape = tuple(leaf.shape)
        # expert parallelism: experts axis (first after skips) -> 'model'
        if model and any(k in keys for k in _EXPERT_KEYS) \
                and len(shape) > skip:
            e = shape[skip]
            if e % model == 0 and e >= model:
                pinned[skip] = "model"
        return _greedy_spec(shape, order, mesh_shape, skip_leading=skip,
                            pinned=pinned, tie_break_last=tie_break_last)

    return _keyed_map(spec_for, params_shape)


def batch_specs(plan: ShardingPlan, batch_shape: PyTree) -> PyTree:
    """Batches ``[n_nodes, per_node_batch, ...]`` (or ``[batch, ...]``):
    the reference's rule leaf by leaf.  The node axis on dim 0 where the
    plan has one and the dim is over 1, a leading dim of 1 skipped (one
    node), then the data axes (one axis, or a tuple of them) on the first
    dim their product divides.  That dim is a leaf's rows wherever they
    divide; where they do not it can be a later one (:func:`row_axes` says
    which the step builders take).  A plan that keeps the node stack whole
    (:attr:`ShardingPlan.keeps_nodes`) skips the stack's dim."""
    mesh_shape = dict(plan.mesh.shape)
    daxes = plan.data_axes
    total = math.prod(mesh_shape[a] for a in daxes)

    def spec_for(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        start = 0
        if plan.node_axis and shape and shape[0] > 1:
            spec[0] = plan.node_axis
            start = 1
        elif shape and (shape[0] == 1 or plan.keeps_nodes):
            start = 1
        if daxes:
            for i in range(start, len(shape)):
                if shape[i] % total == 0 and shape[i] >= total:
                    spec[i] = daxes if len(daxes) > 1 else daxes[0]
                    break
        return tuple(spec)

    return tree_map(spec_for, batch_shape)


def row_axes(plan: ShardingPlan, batch: dict, specs: dict, *, key: str,
             lead: int) -> tuple:
    """The data axes that carry a batch's rows under ``specs``
    (:func:`batch_specs`), decided by its tokens (the leaf ``key``), whose
    rows are dim ``lead`` (1 under a node stack, else 0); () where they do
    not divide, and the batch is then whole, as the reference's then is
    (an image's other dims placed over the data axes alike).  Where the
    rule puts the tokens' data axes of more than one rank on another dim
    (their sequence, when the rows do not divide) this raises, naming the
    leaf: no shape of the dry run on the reference's meshes does that, and
    the port splits no batch along its sequence.  Every other leaf splits
    its rows where the tokens do."""
    mesh_shape = dict(plan.mesh.shape)

    def placed(spec):
        return [(i, tuple(a for a in _entry_axes(e) if a in plan.data_axes))
                for i, e in enumerate(spec)
                if set(_entry_axes(e)) & set(plan.data_axes)]

    def fail(name, i, axes, why):
        shape = tuple(batch[name].shape)
        raise ValueError(
            f"batch leaf {name} of shape {shape}: {why} the data axes {axes} "
            f"({math.prod(mesh_shape[a] for a in axes)} ranks), which "
            f"batch_specs puts on its dim {i}; the port splits a batch by "
            "its rows only")

    axes = ()
    for i, ax in placed(specs[key]):
        if i == lead:
            axes = ax
        elif math.prod(mesh_shape[a] for a in ax) > 1:
            fail(key, i, ax, f"its {batch[key].shape[lead]} rows do not "
                 "divide over")
    if axes:
        for name, spec in specs.items():
            if placed(spec) != [(lead, axes)]:
                fail(name, lead, axes, "its rows do not split as the "
                     "tokens' over")
    return axes


def cache_specs(plan: ShardingPlan, cache_shape: PyTree, *,
                shard_features: bool = True) -> PyTree:
    """KV caches ``[(layers), B, T, K, D]`` / SSM states: the batch over
    the data axes where it divides (else the next dim it divides twice
    over), and with ``shard_features`` 'model' on the last divisible dim
    (feature dims before the cache's length: sharding T would gather the
    whole cache every decode step in the reference)."""
    mesh_shape = dict(plan.mesh.shape)
    daxes = plan.data_axes
    d_total = math.prod(mesh_shape[a] for a in daxes)
    model = mesh_shape.get("model")
    dspec = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)

    def spec_for(keys, leaf):
        shape = tuple(leaf.shape)
        skip = 1 if "blocks" in keys or "shared_attn" in keys else 0
        spec = [None] * len(shape)
        used = set()
        if len(shape) > skip and shape[skip] % d_total == 0 and \
                shape[skip] >= d_total and daxes:
            spec[skip] = dspec
            used.add(skip)
        else:
            for i in range(skip + 1, len(shape)):
                if i not in used and shape[i] % d_total == 0 and \
                        shape[i] >= 2 * d_total and daxes:
                    spec[i] = dspec
                    used.add(i)
                    break
        if not shard_features or not model:
            return tuple(spec)
        for i in range(len(shape) - 1, skip, -1):
            if i in used:
                continue
            if shape[i] % model == 0 and shape[i] >= model:
                spec[i] = "model"
                break
        return tuple(spec)

    return _keyed_map(spec_for, cache_shape)


# ---------------------------------------------------------------------------
# a rank's blocks
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, axis: str) -> int:
    return dict(mesh.shape)[axis]


def _coord(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (0 on a shape-only mesh)."""
    if isinstance(mesh, MeshShape):
        return 0
    return mesh.axis(axis).rank


def _block_index(mesh, axes) -> int:
    """The rank's block along a dim split over ``axes`` (row-major: the
    first axis outermost)."""
    index = 0
    for a in axes:
        index = index * _axis_size(mesh, a) + _coord(mesh, a)
    return index


def _without(spec: tuple, skip) -> tuple:
    return tuple(None if set(_entry_axes(e)) & set(skip) else e
                 for e in spec)


def local_shape(mesh, spec: tuple, shape) -> tuple:
    """The shape of a rank's block of a leaf of ``shape`` under ``spec``."""
    out = list(shape)
    for i, entry in enumerate(spec):
        for axis in _entry_axes(entry):
            out[i] //= _axis_size(mesh, axis)
    return tuple(out)


def _cut(mesh, spec: tuple, x: torch.Tensor) -> torch.Tensor:
    """The rank's block of ``x`` (a view), dims counted from the end so
    that ``x`` may carry extra leading dims."""
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            d = i - len(spec)
            block = x.shape[d] // math.prod(_axis_size(mesh, a)
                                            for a in axes)
            x = x.narrow(d, _block_index(mesh, axes) * block, block)
    return x


def _all_gather(x: torch.Tensor, dim: int, mesh, axis: str,
                tally=None) -> torch.Tensor:
    """The blocks of ``x`` over ``axis`` joined along ``dim``: one
    ``all_gather_into_tensor``; on ``meta`` (or a shape-only mesh) the
    joined shape alone.  ``tally`` (a :class:`Tally`) adds the bytes this
    rank receives."""
    size = _axis_size(mesh, axis)
    if tally is not None:
        tally.add(x.numel() * x.element_size() * (size - 1))
    if isinstance(mesh, MeshShape) or x.device.type == "meta":
        shape = list(x.shape)
        shape[dim] *= size
        return x.new_empty(shape)
    return mesh.axis(axis).all_gather_dim(x, dim)


def _gather(mesh, spec: tuple, x: torch.Tensor, tally=None) -> torch.Tensor:
    """The whole of a leaf from the rank's block ``x`` under ``spec`` (the
    inner axis of a shared dim first)."""
    for i, entry in reversed(list(enumerate(spec))):
        for axis in reversed(_entry_axes(entry)):
            x = _all_gather(x, i - len(spec), mesh, axis, tally)
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the reference's ``jax.sharding.NamedSharding``:
    :meth:`shard` cuts this rank's block of a whole tensor
    (:func:`gather_tree` joins blocks back)."""

    mesh: Any
    spec: tuple

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x``: ``x`` itself where the block is all
        of it, else a contiguous copy (a ``meta`` block for ``meta``)."""
        out = _cut(self.mesh, self.spec, x)
        if tuple(out.shape) == tuple(x.shape):
            return x
        return out.clone(memory_format=torch.contiguous_format)


def _is_spec(node) -> bool:
    return isinstance(node, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in node)


def named(plan: ShardingPlan, specs: PyTree) -> PyTree:
    """A :class:`NamedSharding` for each spec of ``specs`` (a tuple whose
    entries are axis names, tuples of names or None is a spec)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if _is_spec(node):
            return NamedSharding(plan.mesh, node)
        return tuple(walk(v) for v in node)

    return walk(specs)


def shard_tree(plan: ShardingPlan, specs: PyTree, tree: PyTree, *,
               shapes: PyTree = None, skip=()) -> PyTree:
    """This rank's blocks of ``tree`` under ``specs`` (the axes in ``skip``
    left whole).  With ``shapes`` (the global tree, ``meta`` tensors) a
    leaf of its global shape is cut and a leaf already of its block's
    shape kept; any other shape raises.  Without, every leaf is global."""
    def cut(x, spec, like):
        spec = _without(spec, skip)
        if like is not None and tuple(x.shape) != tuple(like.shape):
            block = local_shape(plan.mesh, spec, like.shape)
            if tuple(x.shape) == block:
                return x
            raise ValueError(
                f"a leaf of shape {tuple(x.shape)} is neither the global "
                f"{tuple(like.shape)} nor its block {block} under {spec}")
        return NamedSharding(plan.mesh, spec).shard(x)

    if shapes is None:
        return tree_map(lambda x, spec: cut(x, spec, None), tree, specs)
    return tree_map(cut, tree, specs, shapes)


def gather_tree(plan: ShardingPlan, specs: PyTree, tree: PyTree, *,
                skip=()) -> PyTree:
    """The global tree from this rank's blocks (a collective)."""
    return tree_map(lambda x, spec: _gather(plan.mesh, _without(spec, skip),
                                            x), tree, specs)


def bytes_per_rank(plan: ShardingPlan, tree: PyTree, specs: PyTree) -> int:
    """Bytes one rank stores of ``tree`` (tensors, ``meta`` ones included)
    laid out by ``specs``: each leaf's bytes over the product of the sizes
    of the axes its spec names."""
    def nbytes(leaf, spec):
        parts = math.prod(_axis_size(plan.mesh, a) for e in spec
                          for a in _entry_axes(e))
        return leaf.numel() * leaf.element_size() // parts

    return int(sum(tree_flatten(tree_map(nbytes, tree, specs))[0]))


# ---------------------------------------------------------------------------
# the sharded state: store blocks, gather on use
# ---------------------------------------------------------------------------

class Tally:
    """Bytes a rank receives (an object, not a list: the autograd
    functions' arguments pass through ``torch.func``'s pytree handling,
    which would copy a container): ``bytes`` by a placement's gathers of
    weights and caches, ``leaves`` the weights' by leaf path (a tuple of
    keys from the params root), ``caches`` the cache leaves' by path (from
    the cache root), and ``wire`` the collectives of activations by kind
    (``all-reduce``, ``reduce-scatter``, ``all-gather``, ``all-to-all``;
    the ring algorithm's bytes, an all-to-all's from the other ranks): a
    :class:`Split`'s, and a pinned decode's on the cache blocks
    (:class:`CacheBlock`)."""

    def __init__(self):
        self.bytes = 0
        self.leaves = {}
        self.caches = {}
        self.wire = {}

    def add(self, nbytes, *, leaf=None, kind=None, cache=None) -> None:
        if kind is not None:
            self.wire[kind] = self.wire.get(kind, 0) + nbytes
            return
        self.bytes += nbytes
        if leaf is not None:
            self.leaves[leaf] = self.leaves.get(leaf, 0) + nbytes
        if cache is not None:
            self.caches[cache] = self.caches.get(cache, 0) + nbytes


class _Count:
    """What one collective call site adds to a :class:`Tally` (a leaf's
    gathers, or a kind of the split's collectives)."""

    def __init__(self, tally: Tally, *, leaf=None, kind=None, cache=None):
        self.tally, self.leaf, self.kind = tally, leaf, kind
        self.cache = cache

    def add(self, nbytes) -> None:
        self.tally.add(nbytes, leaf=self.leaf, kind=self.kind,
                       cache=self.cache)


@dataclasses.dataclass(frozen=True, eq=False)
class Rows:
    """A node's batch rows over the data ``axes`` (:func:`row_axes`): the
    rank computes the rows of its block (row-major over the axes, the
    first outermost, as :func:`_block_index`), and these are the
    collectives that make the ranks' partial results the node's, each
    counted in ``tally.wire`` under its kind (the bytes a rank receives)
    and in ``calls`` (the calls, an axis of one rank's too).  On a
    ``MeshShape`` (or ``meta``) they give the shapes alone.  At one rank
    each returns its input's values."""

    mesh: Any
    axes: tuple
    tally: Tally = dataclasses.field(default_factory=Tally)
    calls: dict = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        """R, the ranks that split a node's rows."""
        return math.prod(_axis_size(self.mesh, a) for a in self.axes)

    @property
    def index(self) -> int:
        """The rank's block of the rows."""
        return _block_index(self.mesh, self.axes)

    def _shape_only(self, x) -> bool:
        return isinstance(self.mesh, MeshShape) or x.device.type == "meta"

    def _count(self, kind: str, nbytes: float) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        if nbytes:      # an axis of one rank moves nothing
            self.tally.add(nbytes, kind=kind)

    def cut(self, x, dim: int = 0):
        """The rank's rows of a node's ``x`` along ``dim`` (a view)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)

    def reduce(self, x):
        """``x`` summed over the row ranks (an all-reduce an axis), with no
        autograd."""
        for axis in self.axes:
            m = _axis_size(self.mesh, axis)
            self._count("all-reduce",
                        x.numel() * x.element_size() * 2 * (m - 1) / m)
            x = x.clone() if self._shape_only(x) else \
                self.mesh.axis(axis).all_reduce(x)
        return x

    def join(self, x, dim: int = 0):
        """The row ranks' ``x`` joined along ``dim`` in row order (an
        all-gather an axis, the inner first), with no autograd."""
        for axis in reversed(self.axes):
            self._count("all-gather", x.numel() * x.element_size()
                        * (_axis_size(self.mesh, axis) - 1))
            x = _all_gather(x, dim, self.mesh, axis)
        return x

    def scatter(self, x, dim: int, axis: str):
        """``x`` summed over ``axis``, the rank keeping its block along
        ``dim``: one reduce-scatter."""
        m = _axis_size(self.mesh, axis)
        self._count("reduce-scatter",
                    x.numel() * x.element_size() * (m - 1) / m)
        if self._shape_only(x):
            shape = list(x.shape)
            shape[dim] //= m
            return x.new_empty(shape)
        return self.mesh.axis(axis).reduce_scatter_dim(x, dim)

    def sum(self, x):
        """``x`` summed over the row ranks for a value every rank uses (a
        node's mean over its rows): the backward sums the ranks'
        gradients too, since the node's loss is the ranks' losses' sum."""
        return _RowSum.apply(x, self)

    def before(self, x):
        """The sum of the earlier row ranks' ``x`` (zeros at the first):
        one all-gather of ``x``, no gradient."""
        return _RowsBefore.apply(x, self)

    def reduce_grads(self, grads, specs):
        """The node's gradients from the ranks' partial ones, for the
        leaves whose spec does not name a row axis (a norm, a bias, a dim
        no axis divides): all-reduced over each such axis, a leaf at a
        time (a new tensor each, so no leaf waits on a buffer of all of
        them).  A leaf stored along a row axis was reduce-scattered over
        it in its gather's backward."""
        def one(g, spec):
            stored = {a for e in spec for a in _entry_axes(e)}
            for axis in self.axes:
                if axis in stored:
                    continue
                m = _axis_size(self.mesh, axis)
                self._count("all-reduce",
                            g.numel() * g.element_size() * 2 * (m - 1) / m)
                if not self._shape_only(g):
                    g = self.mesh.axis(axis).all_reduce(g)
            return g

        return tree_map(one, grads, specs)


class _RowSum(torch.autograd.Function):
    """:meth:`Rows.sum`: an all-reduce over the row axes whose backward is
    the same all-reduce."""

    @staticmethod
    def forward(x, rows):
        return rows.reduce(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.rows = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return ctx.rows.reduce(grad), None

    @staticmethod
    def vmap(info, in_dims, x, rows):
        return _on_stack(_RowSum, in_dims, x, rows)


class _RowsBefore(torch.autograd.Function):
    """:meth:`Rows.before` (integer counts: no gradient)."""

    @staticmethod
    def forward(x, rows):
        return rows.join(x.unsqueeze(0), 0)[:rows.index].sum(0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, rows):
        return _on_stack(_RowsBefore, in_dims, x, rows)


class _GatherOnUse(torch.autograd.Function):
    """``x``'s blocks over ``axis`` joined along ``dim`` (counted from the
    end).  The backward keeps this rank's slice of the full gradient where
    every rank of the axis computed the same gradient ('model'), and
    reduce-scatters it over an axis that carries rows (``rows``, a
    :class:`Rows`, whose ranks computed their own rows' partial sums).
    ``torch.func.vmap`` over the node axis runs it on the whole node stack
    at once (one collective a leaf, not one a node)."""

    @staticmethod
    def forward(x, dim, mesh, axis, tally, rows):
        return _all_gather(x, dim, mesh, axis, tally)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dim, mesh, axis, _, rows = inputs
        ctx.dim, ctx.block = dim, x.shape[dim]
        ctx.index = _coord(mesh, axis)
        ctx.axis, ctx.rows = axis, rows

    @staticmethod
    def backward(ctx, grad):
        if ctx.rows is not None:
            grad = ctx.rows.scatter(grad, ctx.dim, ctx.axis)
        else:
            grad = grad.narrow(ctx.dim, ctx.index * ctx.block, ctx.block)
        return grad, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, mesh, axis, tally, rows):
        if in_dims[0] is None:
            return _GatherOnUse.apply(x, dim, mesh, axis, tally, rows), None
        return _GatherOnUse.apply(x.movedim(in_dims[0], 0), dim, mesh, axis,
                                  tally, rows), 0


@dataclasses.dataclass(frozen=True)
class _LeafAxes:
    """One leaf's sharded dims, ``((dim, (axis, ...)), ...)`` with dims
    counted from the end: a view that drops the leaf's leading node and
    layer axes gathers along the same dims."""

    dims: tuple

    @property
    def spec(self) -> tuple:
        out = [None] * (max((-d for d, _ in self.dims), default=0))
        for d, axes in self.dims:
            out[d] = axes
        return tuple(out)


def _leaf_axes(spec: tuple, skip) -> _LeafAxes:
    return _LeafAxes(tuple((i - len(spec), _entry_axes(e)) for i, e in
                           enumerate(_without(spec, skip)) if e))


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """A step's sharded state on ``mesh``: which dims of each params leaf
    (``params``) and cache leaf (``cache``) the rank stores a block of.
    The model calls :meth:`gather_params` on a block's params just before
    it uses them and drops what it gathered after; a decode step gathers
    each layer's cache (:meth:`gather_cache`), writes it in place and puts
    the rank's block back (:meth:`store_cache`), or, pinned to the stored
    layout (the reference's ``pin_decode_cache``), attends over and writes
    into the rank's blocks as they are (:meth:`cache_blocks`); a prefill
    cuts each new cache to the rank's block (:meth:`cut_cache`).  ``key``
    is the path of the subtree in the params or cache tree, ``("blocks",
    j)`` for the ``j``-th period position (a period's view of a stacked
    leaf gathers as the leaf).  ``tally`` counts the bytes the rank's
    gathers receive."""

    mesh: Any
    params: Any = None
    cache: Any = None
    rows: Optional[Rows] = None
    tally: Tally = dataclasses.field(default_factory=Tally)
    _blocks: dict = dataclasses.field(default_factory=dict, repr=False)

    @staticmethod
    def make(plan: ShardingPlan, *, params=None, param_specs=None,
             cache=None, cache_specs=None, rows=None) -> "Placement":
        """From the global trees (``meta`` tensors) and their specs; the
        node axis is never gathered.  ``rows`` (a :class:`Rows`): the
        rank computes its rows, so a gather over a row axis reduce-scatters
        its gradient; ``cache_specs`` then name no row axis on a cache's
        rows (they are the rank's already)."""
        skip = (plan.node_axis,) if plan.node_axis else ()

        def axes(tree, specs):
            if tree is None:
                return None
            return tree_map(lambda x, spec: _leaf_axes(spec, skip), tree,
                            specs)

        return Placement(plan.mesh, axes(params, param_specs),
                         axes(cache, cache_specs), rows)

    @staticmethod
    def _at(tree, key):
        for k in key:
            tree = tree[k]
        return tree

    def gather_params(self, tree, *key, keep=None):
        """``tree`` (the params at ``key``) whole, from the rank's blocks.
        ``keep(path)`` (a :class:`Split`'s) names the leaves whose 'model'
        block the split computes with: those gather their other axes only
        (the FSDP axes) and stay the rank's block along 'model'."""
        rows = self.rows

        def one(path, x, leaf):
            path = key + path
            count = _Count(self.tally, leaf=path)
            skip = ("model",) if keep is not None and keep(path) else ()
            for d, axes in reversed(leaf.dims):
                for axis in reversed(axes):
                    if axis not in skip:
                        x = _GatherOnUse.apply(x, d, self.mesh, axis, count,
                                               rows if rows is not None and
                                               axis in rows.axes else None)
            return x

        leaves, treedef = tree_flatten(tree)
        axes = tree_flatten(self._at(self.params, key))[0]
        return tree_unflatten(treedef, [
            one(path, x, leaf)
            for path, x, leaf in zip(tree_paths(tree), leaves, axes)])

    def model_dim(self, path) -> Optional[int]:
        """The dim (counted from the end) of the params leaf at ``path``
        that 'model' splits alone, or None."""
        for d, axes in self._at(self.params, path).dims:
            if axes == ("model",):
                return d
        return None

    def gather_cache(self, tree, *key):
        """``tree`` (the cache at ``key``) whole, each leaf's bytes counted
        under its path (``tally.caches``)."""
        leaves, treedef = tree_flatten(tree)
        axes = tree_flatten(self._at(self.cache, key))[0]
        return tree_unflatten(treedef, [
            _gather(self.mesh, leaf.spec, x,
                    _Count(self.tally, cache=key + path))
            for path, x, leaf in zip(tree_paths(tree), leaves, axes)])

    def cache_blocks(self, *key) -> dict:
        """The :class:`CacheBlock` of each leaf of the cache at ``key`` (a
        layer's leaves by name), made once a key."""
        if key not in self._blocks:
            self._blocks[key] = {
                name: CacheBlock(self, leaf)
                for name, leaf in self._at(self.cache, key).items()}
        return self._blocks[key]

    def cut_cache(self, tree, *key):
        return tree_map(lambda x, leaf: _cut(self.mesh, leaf.spec, x)
                        .contiguous(), tree, self._at(self.cache, key))

    def store_cache(self, blocks, full, *key) -> None:
        tree_map(lambda b, x, leaf: b.copy_(_cut(self.mesh, leaf.spec, x)),
                 blocks, full, self._at(self.cache, key))


@dataclasses.dataclass(frozen=True, eq=False)
class CacheBlock:
    """The rank's block of one cache leaf, as a pinned decode step computes
    on it: which mesh axes store each dim of a layer's view of the leaf
    (dims counted from the end, the stacked layer axis dropped), where the
    rank's block starts along each, and the collectives over those axes
    (counted in the placement's ``tally.wire``).  At one rank every
    collective returns its input's values."""

    placement: Placement
    leaf: _LeafAxes

    @property
    def mesh(self):
        return self.placement.mesh

    def axes(self, dim: int) -> tuple:
        """The axes that store ``dim`` (outer first), () for a whole dim."""
        return dict(self.leaf.dims).get(dim, ())

    def parts(self, dim: int) -> int:
        """Blocks along ``dim`` (1 for a dim the rank holds whole)."""
        return math.prod(_axis_size(self.mesh, a) for a in self.axes(dim))

    def start(self, dim: int, length: int) -> int:
        """The first index of the rank's block along ``dim``, the block
        ``length`` long."""
        return _block_index(self.mesh, self.axes(dim)) * length

    def cut(self, x, dim: int, at: Optional[int] = None):
        """The rank's block along ``dim`` of ``x``, whole along its dim
        ``at`` (``dim`` by default): a view."""
        at = dim if at is None else at
        n = x.shape[at] // self.parts(dim)
        return x.narrow(at, self.start(dim, n), n) if self.axes(dim) else x

    def join(self, x, dim: int, at: Optional[int] = None):
        """Every rank's block along ``dim`` joined along ``x``'s dim ``at``
        (``dim`` by default): an all-gather an axis, the inner first."""
        at = dim if at is None else at
        for axis in reversed(self.axes(dim)):
            x = _all_gather(x, at, self.mesh, axis,
                            _Count(self.placement.tally, kind="all-gather"))
        return x

    def reduce(self, x, dim: int, op: str = "sum"):
        """``x`` summed (or maxed) over the ranks whose blocks along
        ``dim`` differ: an all-reduce an axis."""
        for axis in self.axes(dim):
            m = _axis_size(self.mesh, axis)
            self.placement.tally.add(
                x.numel() * x.element_size() * 2 * (m - 1) / m,
                kind="all-reduce")
            if isinstance(self.mesh, MeshShape) or x.device.type == "meta":
                x = x.clone()
            else:
                x = self.mesh.axis(axis).all_reduce(x, op)
        return x


def pinned_cache_spec(cache_shape: PyTree, specs: PyTree) -> Optional[tuple]:
    """The reference's decode pin (``lower_decode`` under
    ``pin_decode_cache``): the spec of the first stacked attention K leaf
    (``("blocks", j, "k")``), its layer dim dropped; None where no block
    keeps a K cache."""
    held = tree_flatten(tree_map(lambda x, spec: [spec], cache_shape,
                                 specs))[0]
    for path, (spec,) in zip(tree_paths(cache_shape), held):
        if path[-1] == "k" and "blocks" in path:
            return tuple(spec[1:])
    return None


def same_layout(a, b) -> bool:
    """Whether two specs name the same axes for every dim (an axis name
    and a one-name tuple alike)."""
    if a is None or b is None:
        return a is None and b is None
    return tuple(map(_entry_axes, a)) == tuple(map(_entry_axes, b))


# ---------------------------------------------------------------------------
# the compute split over 'model'
# ---------------------------------------------------------------------------

#: the leaves of a self- or cross-attention the heads split computes with
_ATTN_KEYS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")

#: the leaves of a Mamba-2 mixer the SSM heads split computes with in a
#: train or prefill forward (the depthwise conv's ``conv_w`` is gathered
#: whole on use: its channel blocks do not line up with the heads)
_SSM_KEYS = ("in_proj", "out_proj", "dt_bias", "a_log", "d_skip")

#: a decode step's: the projections on their stored 'model' blocks, and
#: ``conv_w`` where its block is the conv cache's channel block
#: (:meth:`Split._conv_on_cache`); the per-head vectors are gathered whole,
#: as the SSM state is whole over the heads
_SSM_DECODE_KEYS = ("in_proj", "out_proj", "conv_w")


def _on_stack(fn, in_dims, x, *args):
    """A collective's ``torch.func.vmap`` rule: the node axis moved to the
    front and one collective for the whole node stack (the collectives'
    dims count from the end)."""
    if in_dims[0] is None:
        return fn.apply(x, *args), None
    return fn.apply(x.movedim(in_dims[0], 0), *args), 0


class _Copy(torch.autograd.Function):
    """Megatron's *f*: the identity forward into a part that each rank
    computes for itself (its heads, its features, its experts); the
    backward sums the ranks' gradients over 'model'."""

    @staticmethod
    def forward(x, split):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.split = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return ctx.split._sum(grad), None

    @staticmethod
    def vmap(info, in_dims, x, split):
        return _on_stack(_Copy, in_dims, x, split)


class _AllReduce(torch.autograd.Function):
    """The ranks' partial sums summed over 'model'; the gradient of each
    partial sum is the whole sum's (the identity).  ``local``: the sum
    feeds a part each rank computes for itself, so the backward sums the
    ranks' gradients first (an all-reduce followed by *f*, in one
    function)."""

    @staticmethod
    def forward(x, split, local):
        return split._sum(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.split, ctx.local = inputs[1:]

    @staticmethod
    def backward(ctx, grad):
        return (ctx.split._sum(grad) if ctx.local else grad), None, None

    @staticmethod
    def vmap(info, in_dims, x, split, local):
        return _on_stack(_AllReduce, in_dims, x, split, local)


class _ReduceScatter(torch.autograd.Function):
    """The ranks' partial sums summed over 'model', this rank keeping its
    block along ``dim``; the backward all-gathers the blocks' gradients
    (each partial sum's gradient is the whole sum's)."""

    @staticmethod
    def forward(x, dim, split):
        return split._scatter(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.split = inputs[1:]

    @staticmethod
    def backward(ctx, grad):
        return ctx.split._gather(grad, ctx.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, split):
        return _on_stack(_ReduceScatter, in_dims, x, dim, split)


class _AllGather(torch.autograd.Function):
    """The ranks' blocks joined along ``dim`` for a part each rank computes
    for itself: the backward reduce-scatters the gradient (an all-gather
    followed by *f*).  A gather whose result every rank uses alike is
    :class:`_GatherOnUse`, whose backward keeps the rank's slice."""

    @staticmethod
    def forward(x, dim, split):
        return split._gather(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.split = inputs[1:]

    @staticmethod
    def backward(ctx, grad):
        return ctx.split._scatter(grad, ctx.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, split):
        return _on_stack(_AllGather, in_dims, x, dim, split)


def _join(parts, like):
    """``parts`` joined along dim 0 (none: ``like``'s first 0 rows)."""
    return torch.cat(parts) if parts else like[:0]


@dataclasses.dataclass(frozen=True)
class _Regroup:
    """Columns of a last dim stored by contiguous blocks of ``width``
    (rank ``q`` holds ``[q * width, (q + 1) * width)``), moved so that each
    rank holds the column ranges it computes with, in its own order.
    ``runs[q][t]``: the ``(start, length)`` runs (whole-dim columns) of
    rank ``q``'s block that rank ``t`` takes, in ``t``'s order; a column
    goes to one rank at most.  The methods work on tensors with the columns
    first (dim 0)."""

    width: int
    runs: tuple
    ranges: tuple           # ranges[t]: rank t's (start, length) ranges

    @staticmethod
    def make(width: int, m: int, ranges) -> "_Regroup":
        """``ranges(t)``: rank ``t``'s ``(start, length)`` column ranges,
        in the order it holds them."""
        held = tuple(tuple(ranges(t)) for t in range(m))

        def cut(q, t):
            lo, hi = q * width, (q + 1) * width
            return tuple((max(a, lo), min(a + n, hi) - max(a, lo))
                         for a, n in held[t] if max(a, lo) < min(a + n, hi))

        return _Regroup(width, tuple(tuple(cut(q, t) for t in range(m))
                                     for q in range(m)), held)

    def rows(self, q: int, t: int) -> int:
        """Columns rank ``q`` sends rank ``t``."""
        return sum(n for _, n in self.runs[q][t])

    def _sent(self, r: int) -> list:
        """``(offset in r's block, length)`` of each run r sends, in the
        order sent."""
        return [(a - r * self.width, n) for row in self.runs[r]
                for a, n in row]

    def _received(self, r: int) -> list:
        """``(offset received, offset in r's order, length)`` of each run r
        receives, in the order received."""
        bases, at = [], 0
        for start, n in self.ranges[r]:
            bases.append((start, n, at))
            at += n
        out, at = [], 0
        for q in range(len(self.runs)):
            for a, n in self.runs[q][r]:
                out.append((at, next(base + a - start for start, ln, base
                                     in bases if start <= a < start + ln),
                            n))
                at += n
        return out

    def take(self, x, r: int):
        """Rank ``r``'s block cut into what each rank takes."""
        return _join([x.narrow(0, a, n) for a, n in self._sent(r)], x)

    def order(self, got, r: int):
        """The received runs in rank ``r``'s order."""
        return _join([got.narrow(0, g, n) for g, _, n in
                      sorted(self._received(r), key=lambda e: e[1])], got)

    def unorder(self, g, r: int):
        """:meth:`order`'s inverse: ``g`` in rank ``r``'s order, cut into
        the runs as they were received."""
        return _join([g.narrow(0, o, n) for _, o, n in self._received(r)], g)

    def untake(self, back, r: int):
        """:meth:`take`'s inverse: the runs rank ``r`` sent, back in its
        block, zeros where no rank took a column."""
        at, placed = 0, []
        for a, n in self._sent(r):
            placed.append((a, at, n))
            at += n
        parts, pos = [], 0
        for a, b, n in sorted(placed):
            if a > pos:
                parts.append(back.new_zeros((a - pos,) + back.shape[1:]))
            parts.append(back.narrow(0, b, n))
            pos = a + n
        if pos < self.width:
            parts.append(back.new_zeros((self.width - pos,)
                                        + back.shape[1:]))
        return torch.cat(parts)


class _AllToAll(torch.autograd.Function):
    """The rank's column block ``x`` regrouped (:class:`_Regroup`) into
    the column ranges the rank computes with, by one all-to-all over
    'model'; the backward sends each column's gradient back to the rank
    that holds it (zero where no rank took a column).  ``back``: the
    inverse, the rank's ranges ``x`` back to its block (zero where no rank
    holds a column), the backward the forward regroup.  A permutation: the
    values move, none is summed."""

    @staticmethod
    def forward(x, plan, split, back):
        return split._regroup(x, plan, back=back)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan, ctx.split, ctx.back = inputs[1:]

    @staticmethod
    def backward(ctx, grad):
        return (ctx.split._regroup(grad, ctx.plan, back=not ctx.back), None,
                None, None)

    @staticmethod
    def vmap(info, in_dims, x, plan, split, back):
        return _on_stack(_AllToAll, in_dims, x, plan, split, back)


class _VocabLogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of logits split over 'model'
    by vocabulary blocks: the max and the sum of exps reduced over 'model',
    in ``torch.logsumexp``'s own steps (an infinite max taken as 0), so one
    rank's result is its bits.  The result is whole on every rank, so the
    backward is ``torch.logsumexp``'s formula on the rank's block, with no
    collective."""

    @staticmethod
    def forward(x, split):
        m = split._sum(torch.amax(x, dim=-1, keepdim=True), op="max")
        m = m.masked_fill(m.abs() == float("inf"), 0)
        s = split._sum(torch.sum(torch.exp(x - m), dim=-1))
        return torch.log(s) + m[..., 0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, grad):
        x, lse = ctx.saved_tensors
        return grad[..., None] * (x - lse[..., None]).exp(), None

    @staticmethod
    def vmap(info, in_dims, x, split):
        return _on_stack(_VocabLogSumExp, in_dims, x, split)


@dataclasses.dataclass(frozen=True, eq=False)
class Split:
    """The compute split over the 'model' axis, the reference's GSPMD
    layouts (``megatron_attn``, ``shard_activations``,
    ``pin_moe_dispatch``) as explicit collectives, on a placement's stored
    blocks.  ``heads``: each rank computes its heads of every self- and
    cross-attention, ``H / M`` where M divides H, else GSPMD's padded
    split (:meth:`head_range`: ``ceil(H / M)`` a rank from rank 0 on, none
    on the ranks past the last head), with K/V repeated to H heads first
    where their heads do not divide; ``ssm``: its ``nh / M`` heads of
    every Mamba-2 mixer (``models/ssm.py``); ``features``: the residual
    stream between blocks is the rank's ``D / M`` features, the MLPs
    column- then row-parallel, and with ``vocab`` the embedding and the
    head split by vocabulary rows; ``experts``: each rank runs its ``E /
    M`` experts on every token routed to them.  :meth:`make` turns each
    knob on where the config's dims divide (the attention heads wherever
    the config attends), and names in ``whole`` the blocks a knob leaves
    whole on every rank.  ``decode``: a decode step's split, where ``ssm``
    computes each Mamba-2 mixer's projections on their stored 'model'
    blocks (``ssm.mamba_decode(split=)``: the one-token state is cut by
    the cache's layout, not by heads), and a cross block splits as a
    decode's self-attention block.

    One rule for every product with a weight the rank stores a 'model'
    block of (:meth:`linear`): a block of output features is column-parallel
    (the whole input, entered through *f*), a block of input features
    row-parallel (the input's matching block, partial sums out); a leaf the
    split does not use is gathered whole on use (:meth:`keep`).  A tensor is
    ``"R"`` (whole, the same on every rank), ``"S"`` (the rank's block of
    its last dim) or ``"P"`` (the rank's partial sums); :meth:`to` moves it
    between the three by the collectives above, each an autograd function
    with its own vmap rule.  Whatever a rank computes for itself from an
    ``"R"`` tensor goes through *f* (:meth:`copy`, :meth:`enter`,
    :meth:`cut`), so every whole tensor's gradient is whole on every rank,
    as the gathers' backward (:class:`_GatherOnUse`) needs.

    At one rank every collective returns its input's values, so the split
    step is the unsplit one's bits.  On a ``MeshShape`` (or ``meta``) the
    collectives give the shapes alone.  ``tally.wire`` counts the bytes
    each kind of collective receives."""

    placement: Placement
    cfg: Any
    heads: bool = False
    features: bool = False
    experts: bool = False
    vocab: bool = False
    ssm: bool = False
    decode: bool = False
    whole: tuple = ()
    tally: Tally = dataclasses.field(default_factory=Tally)
    _dims: dict = dataclasses.field(default_factory=dict, repr=False)

    axis = "model"

    @staticmethod
    def make(placement: Placement, cfg, *, heads: bool = False,
             features: bool = False, experts: bool = False,
             decode: bool = False) -> Optional["Split"]:
        """The split of ``cfg`` on ``placement``'s mesh, or None where its
        mesh has no 'model' axis or no knob applies.  ``heads`` splits the
        attention heads wherever the config attends (``n_heads > 0``), any
        head count (:meth:`head_range`), and the Mamba-2 heads where ``nh``
        divides (in a decode step wherever the config has Mamba blocks);
        ``features`` needs the model width, ``experts`` the expert stacks
        stored on 'model'; the vocabulary split follows ``features`` where
        the embedding (and an untied head) are stored by vocabulary rows.
        ``decode``: a decode step's split."""
        m = dict(placement.mesh.shape).get("model")
        if placement.params is None or not m:
            return None
        attends = cfg.n_heads > 0 and (cfg.shared_attn_every or any(
            k != "mamba" for k in cfg.period))
        whole = []
        attn_heads = heads and bool(attends)
        nh = cfg.ssm.n_heads(cfg.d_model) if cfg.ssm is not None else 0
        ssm = heads and "mamba" in cfg.period and (decode or nh % m == 0)
        if heads and "mamba" in cfg.period and not ssm:
            whole.append(f"mamba: {nh} SSM heads over 'model' {m}")
        features = features and cfg.d_model % m == 0
        vocab = features and placement.model_dim(("embed",)) == -2 and (
            cfg.tie_embeddings or placement.model_dim(("lm_head",)) == -1)
        experts = experts and cfg.moe is not None and any(
            placement.model_dim(("blocks", j, "moe", "w_gate")) == -3
            for j, kind in enumerate(cfg.period) if kind == "moe")
        if not (attn_heads or ssm or features or experts):
            return None
        return Split(placement, cfg, attn_heads, features, experts, vocab,
                     ssm, decode, tuple(whole))

    # -- the axis ------------------------------------------------------------
    @property
    def size(self) -> int:
        return _axis_size(self.placement.mesh, self.axis)

    @property
    def index(self) -> int:
        return _coord(self.placement.mesh, self.axis)

    @property
    def residual(self) -> str:
        """The residual stream's state between blocks."""
        return "S" if self.features else "R"

    def _uses(self, path) -> bool:
        name = path[-1]
        if path[0] not in ("blocks", "tail", "shared_attn"):
            # embed, lm_head, final_norm
            return (self.vocab and name in ("embed", "lm_head")) or (
                self.features and name == "final_norm")
        if path[-2] in ("attn", "xattn"):
            return self.heads and name in _ATTN_KEYS
        if path[-2] == "mixer":
            if not self.decode:
                return self.ssm and name in _SSM_KEYS
            return self.ssm and name in _SSM_DECODE_KEYS and (
                name != "conv_w" or self._conv_on_cache(path))
        if path[-2] in ("mlp", "dense") or name in ("ln", "ln1", "ln2"):
            return self.features
        return self.experts and path[-2] == "moe" and name in _EXPERT_KEYS \
            and self.placement.model_dim(path) == -3

    def _conv_on_cache(self, path) -> bool:
        """Whether 'model' stores the mixer's ``conv_w`` at ``path`` by the
        channel block that it stores the layer's conv cache by (the conv
        then runs on the rank's channels, each with its own weights)."""
        cache = self.placement.cache
        if cache is None:
            return False
        conv = Placement._at(cache, path[:-2] + ("conv",))
        return self.placement.model_dim(path) == -1 \
            and dict(conv.dims).get(-1) == ("model",)

    def keep(self, path) -> bool:
        """Whether the split computes with the rank's 'model' block of the
        params leaf at ``path`` (else it is gathered whole on use)."""
        return self.model_dim(path) is not None

    def model_dim(self, path) -> Optional[int]:
        """The 'model' dim (from the end) of the leaf at ``path`` as the
        split uses it: None for a leaf gathered whole (resolved once a
        path)."""
        if path not in self._dims:
            d = self.placement.model_dim(path)
            self._dims[path] = d if d is not None and self._uses(path) \
                else None
        return self._dims[path]

    # -- the collectives, on tensors (no autograd) ---------------------------
    def _shape_only(self, x) -> bool:
        return isinstance(self.placement.mesh, MeshShape) \
            or x.device.type == "meta"

    def _count(self, kind, x, share) -> None:
        self.tally.add(x.numel() * x.element_size() * share, kind=kind)

    def _sum(self, x, op: str = "sum"):
        m = self.size
        self._count("all-reduce", x, 2 * (m - 1) / m)
        if self._shape_only(x):
            return x.clone()
        return self.placement.mesh.axis(self.axis).all_reduce(x, op)

    def _scatter(self, x, dim):
        m = self.size
        self._count("reduce-scatter", x, (m - 1) / m)
        if self._shape_only(x):
            shape = list(x.shape)
            shape[dim] //= m
            return x.new_empty(shape)
        return self.placement.mesh.axis(self.axis).reduce_scatter_dim(x,
                                                                      dim)

    def _gather(self, x, dim):
        return _all_gather(x, dim, self.placement.mesh, self.axis,
                           _Count(self.tally, kind="all-gather"))

    def _regroup(self, x, plan: _Regroup, *, back: bool):
        """:class:`_AllToAll`'s forward (``back`` False: the block ``x`` to
        the rank's ranges) or backward (the ranges' gradient ``x`` to the
        block) on tensors: one all-to-all, the bytes from the other ranks
        counted."""
        m, r = self.size, self.index
        cols = x.movedim(-1, 0)
        send = plan.unorder(cols, r) if back else plan.take(cols, r)
        sends = [plan.rows(q, r) if back else plan.rows(r, q)
                 for q in range(m)]
        recvs = [plan.rows(r, q) if back else plan.rows(q, r)
                 for q in range(m)]
        row = math.prod(send.shape[1:]) * send.element_size()
        self.tally.add(row * (sum(recvs) - recvs[r]), kind="all-to-all")
        if self._shape_only(x):
            got = send.new_empty((sum(recvs),) + tuple(send.shape[1:]))
        else:
            got = self.placement.mesh.axis(self.axis).all_to_all(
                send, recvs, sends)
        out = plan.untake(got, r) if back else plan.order(got, r)
        # the columns last in memory too, as a product's operand is laid
        # out without the split (its sums then run in the same order)
        return out.movedim(0, -1).contiguous()

    # -- the collectives, under autograd -------------------------------------
    def copy(self, x):
        """*f*: ``x`` itself; its gradient summed over 'model'."""
        return _Copy.apply(x, self)

    def all_reduce(self, x, *, local: bool = False):
        """The partial sums summed; ``local``: for a part each rank
        computes for itself (the backward sums the gradients too)."""
        return _AllReduce.apply(x, self, local)

    def reduce_scatter(self, x, dim: int = -1):
        return _ReduceScatter.apply(x, dim, self)

    def all_gather(self, x, dim: int = -1, *, local: bool = False):
        """The blocks joined along ``dim``; ``local``: for a part each rank
        computes for itself (the backward reduce-scatters), else for a part
        every rank computes alike (the backward keeps the rank's slice)."""
        if local:
            return _AllGather.apply(x, dim, self)
        return _GatherOnUse.apply(x, dim, self.placement.mesh, self.axis,
                                  _Count(self.tally, kind="all-gather"),
                                  None)

    def regroup(self, x, ranges):
        """The column ranges ``ranges(t)`` (rank ``t``'s ``(start,
        length)`` runs of the whole last dim, in its order) of a tensor
        whose last dim is ``"S"``, the rank's contiguous block: this rank's
        ranges joined in its order, by one all-to-all (:class:`_AllToAll`).
        A column no rank takes gets no gradient from it."""
        plan = _Regroup.make(x.shape[-1], self.size, ranges)
        return _AllToAll.apply(x, plan, self, False)

    def unregroup(self, x, ranges, width: int):
        """:meth:`regroup`'s inverse: this rank's ranges ``x`` (in its
        order) back to its contiguous block of ``width`` columns, ``"S"``,
        by one all-to-all; zeros where no rank holds a column."""
        plan = _Regroup.make(width, self.size, ranges)
        return _AllToAll.apply(x, plan, self, True)

    def block(self, x, dim: int = -1):
        """The rank's block of ``x`` along ``dim`` (a view)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)

    def cut(self, x, dim: int = -1):
        """The rank's block of a whole ``x``, through *f*."""
        return self.block(self.copy(x), dim)

    # -- the attention heads, as GSPMD pads them -----------------------------
    def head_range(self, n: Optional[int] = None,
                   rank: Optional[int] = None) -> tuple:
        """``(first, count)`` of rank ``rank``'s heads (this rank's by
        default) of ``n`` (the config's query heads by default): ``c =
        ceil(n / M)`` heads a rank from rank 0 on, as GSPMD pads the head
        dim to a multiple of 'model'; ``count`` is 0 past the last head.
        Where M divides ``n`` it is :meth:`block`'s range."""
        n = self.cfg.n_heads if n is None else n
        rank = self.index if rank is None else rank
        c = -(-n // self.size)
        lo = min(rank * c, n)
        return lo, min(lo + c, n) - lo

    def head_block(self, x, n: Optional[int] = None, dim: int = -1):
        """The rank's heads (:meth:`head_range`) of ``x``, whose ``dim``
        holds ``n`` heads side by side: a view, possibly empty."""
        n = self.cfg.n_heads if n is None else n
        lo, count = self.head_range(n)
        w = x.shape[dim] // n
        return x.narrow(dim, lo * w, count * w)

    def head_cut(self, x, n: Optional[int] = None, dim: int = -1):
        """The rank's heads of a whole ``x``, through *f*."""
        return self.head_block(self.copy(x), n, dim)

    def _head_runs(self, hd: int):
        """:meth:`regroup`'s ``ranges`` of the query heads: each rank's
        head range, one run of ``hd``-wide heads (none past the last)."""
        def ranges(t):
            lo, count = self.head_range(rank=t)
            return ((lo * hd, count * hd),) if count else ()
        return ranges

    def to_heads(self, x, state: str, hd: int):
        """The rank's query heads of ``x``, whose last dim holds the
        config's ``H`` heads of ``hd`` features, in ``state``.  Where M
        divides H, :meth:`to` ``"S"``.  Else a stored column block
        (``"S"``, ``H * hd / M`` columns, which need not line up with the
        heads) is regrouped by one all-to-all, and partial sums
        (``"P"``) are all-reduced whole; a whole ``x`` is cut to the range
        through *f* (:meth:`head_cut`)."""
        if self.cfg.n_heads % self.size == 0:
            return self.to(x, state, "S")
        if state == "S":
            return self.regroup(x, self._head_runs(hd))
        return self.head_cut(self.to(x, state, "R"))

    def linear_heads(self, x, w, path, hd: int):
        """``x @ w`` of the rank's heads ``x`` of an attention's output (its
        :meth:`head_range` of the config's heads, ``hd`` features each) and
        ``wo`` at ``path``, as :meth:`linear`.  Where M divides the heads
        ``x`` is ``"S"``.  Else, where 'model' stores ``wo`` by rows, ``x``
        is moved to those rows by one all-to-all (:meth:`unregroup`), then
        row-parallel; elsewhere ``x`` enters as its partial sums, zero
        outside the rank's range."""
        n = self.cfg.n_heads
        if n % self.size == 0:
            return self.linear(x, "S", w, path)
        if self.model_dim(path) == -2:
            x = self.unregroup(x, self._head_runs(hd), n * hd // self.size)
            return x @ w, "P"
        lo, count = self.head_range(n)
        x = torch.nn.functional.pad(x, (lo * hd, (n - lo - count) * hd))
        return self.linear(x, "P", w, path)

    def own(self, w, path):
        """The rank's block along the last dim of the params leaf ``w`` at
        ``path``: the stored block where the split keeps it, else cut from
        the whole leaf (:meth:`cut`)."""
        return w if self.model_dim(path) == -1 else self.cut(w)

    def logsumexp(self, x):
        """``torch.logsumexp(x, -1)`` of vocabulary-split logits."""
        return _VocabLogSumExp.apply(x, self)

    def to(self, x, state: str, want: str, dim: int = -1):
        """``x`` from ``state`` to ``want`` (``"R"``, ``"S"`` along ``dim``
        or, as a source only, ``"P"``)."""
        if state == want:
            return x
        if state == "P":
            return self.all_reduce(x) if want == "R" \
                else self.reduce_scatter(x, dim)
        if state == "S":
            return self.all_gather(x, dim)
        return self.cut(x, dim)

    def enter(self, x, state: str):
        """The whole of ``x`` for a part the rank computes for itself."""
        if state == "S":
            return self.all_gather(x, local=True)
        if state == "P":
            return self.all_reduce(x, local=True)
        return self.copy(x)

    def linear(self, x, state: str, w, path, inputs: dict | None = None):
        """``x @ w`` for ``x`` in ``state``, by where the split keeps
        ``w``'s 'model' block (the leaf at ``path``): ``(y, "S")`` column-
        parallel, ``(y, "P")`` row-parallel, ``(y, "R")`` for a leaf
        gathered whole.  ``inputs`` shares the moved ``x`` between the
        products that read the same one."""
        d = self.model_dim(path)
        route = {-1: "S", -2: "P"}.get(d, "R")
        inputs = {} if inputs is None else inputs
        if route not in inputs:
            inputs[route] = (self.enter(x, state) if route == "S" else
                             self.to(x, state, "S" if route == "P" else "R"))
        return inputs[route] @ w, route

    def rms_norm(self, x, weight, eps: float):
        """``layers.rms_norm`` of the residual in its state: over the
        rank's features, the sum of squares all-reduced."""
        if not self.features:
            return layers.rms_norm(x, weight, eps)
        if weight.shape[-1] != x.shape[-1]:    # a weight gathered whole
            weight = self.cut(weight)
        return layers.rms_norm(x, weight, eps, split=self)
