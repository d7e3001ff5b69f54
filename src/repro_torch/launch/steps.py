"""Step builders shared by the dry run and the launchers.

Port of ``repro/launch/steps.py``.  Three step kinds, matching the input
shapes:

  train_step   decentralized QG-DSGDm-N step: per-node grads (the loss
               mapped over the node axis) -> local QG half-step -> gossip ->
               buffer update.  n_nodes=1 degrades to QHM (paper §4.2) for
               the archs whose per-node copies exceed a card (DESIGN.md §5).
  prefill_step tokens [B,S] -> (last logits, KV caches)
  decode_step  one token + caches (seq_len capacity) -> (logits, caches)

The builders are closures over a :class:`StepConfig`; the spec functions
give the inputs as ``meta`` tensors (shapes and dtypes, nothing allocated),
which the dry run (``launch/dryrun.py``) traces.

With a mesh (``launch/mesh.RankMesh``, a ``NodeMesh``, or a ``MeshShape``
for a ``meta`` trace) the builders lay the state out by
``launch/sharding.py``'s plan: each rank stores its block of every weight
and optimizer buffer (and cache), and the model gathers each block's
weights just before it uses them (``sharding.Placement``).  The steps take
global trees (each leaf cut to the rank's block) or the blocks, and return
the blocks; ``sharding.gather_tree`` joins them (a built step's
``layout`` attribute is its :class:`Layout`, None without a mesh).  The optimizer runs on the
blocks: it is elementwise along every dim but the node axis, over which the
gossip mixes as before.  A node's batch rows lie over the plan's data axes
(every axis but the node axis and 'model') where the reference's
``batch_specs`` puts them, and each rank computes its own rows
(``Layout.rows``, ``sharding.Rows``): its loss is its rows' mean over R,
the ranks' gradients are summed over those axes, and a serving step's
logits are all-gathered whole.  At one rank the values are the unsharded
step's bit for bit; across ranks the rows' sums meet in another order.

Per-node gradients are ``torch.autograd.grad`` of the node losses' sum (the
loss mapped over the node axis with ``torch.func.vmap``; node i's loss
depends on node i's params only, so the sum differentiates to exact
per-node grads), as the runtimes' ``_stage_compute`` takes them.  The
reference's ``vmap(value_and_grad)`` maps to ``torch.func.vmap`` of
``torch.func.grad_and_value`` in form, but that differentiates with
``create_graph=True``, which holds every saved tensor and the backward's
own graph to the end: 2.2x the peak memory of the same step (a 4-layer
d-1024 TinyLlama cut on the CPU), and it cancels ``remat``.

The TPU knobs of the reference's ``StepConfig``, one rule each:

* ``remat="full"`` (the default, as the reference's) recomputes each
  period in the backward (``models/transformer.py``'s ``_PeriodRemat``);
  ``"none"`` keeps the activations.  The values are the same bit for bit;
  only the peak memory and the flops move.
* ``megatron_attn``, ``shard_activations`` and ``pin_moe_dispatch``
  split the train, prefill and decode steps' compute over a mesh's
  'model' axis (``sharding.Split``, on the blocks the placement stores):
  each rank computes its heads (``megatron_attn``; ``wo`` row-parallel;
  also a cross block's heads and, in train and prefill, a Mamba-2 mixer's
  SSM heads, ``out_proj`` row-parallel; a decode computes the mixer's
  ``in_proj`` / ``out_proj`` and, where 'model' stores it by the conv
  cache's channels, ``conv_w`` on their stored blocks), keeps its
  features of the residual stream between blocks with the MLP column-
  then row-parallel and the embedding, head and loss split by vocabulary
  (``shard_activations``), and runs its experts (``pin_moe_dispatch``).
  Each knob applies where the config's dims divide over 'model'
  (``Split.make``); off, the weights are gathered whole on use.  At one
  'model' rank the split step is the unsplit step's bits; across ranks
  the partial sums are reduced in another order.
* ``pin_decode_cache`` (or a ``cache_constraint`` equal to the stored
  layout, :func:`build_decode_step`) makes a decode step on a mesh attend
  over, and write into, the rank's stored cache blocks
  (``sharding.CacheBlock``), with no K/V, cross or Mamba state leaf
  gathered; off, each layer's cache is gathered on use, written and its
  block put back.  At one rank either is ``mesh=None``'s bits.
* ``repeat_kv`` (or ``megatron_attn``) repeats K/V to the head count in
  the plain attention, with or without a mesh, as in the reference
  (``attention.chunked_attention``).
* ``unroll`` (:data:`IGNORED_KNOBS`) steers XLA's scan, which has no
  counterpart: it is accepted and does nothing, and every dry-run record
  lists it under ``"ignored"``.
* ``shard_tie_break_last`` and ``cache_shard_features`` pick the dims the
  weights and caches are stored by (``sharding.param_specs`` /
  ``cache_specs``), as in the reference.
* ``remat_attention`` (train) and ``skip_masked_chunks`` (train and
  prefill) reach the plain attention as in the reference
  (``models/attention.chunked_attention``).
* ``decode_lowp`` reaches ``tf.decode_step`` as in the reference.
* ``param_dtype`` also picks the optimizer's route (:func:`make_opt`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import gossip, topology as topo_lib
from repro_torch.core.optim import make_optimizer
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

from . import sharding
from .mesh import MeshShape
from .roofline import H100

__all__ = ["HBM_BYTES", "NODE_BUDGET", "H100_HBM_BYTES", "H100_NODE_BUDGET",
           "IGNORED_KNOBS", "StepConfig", "choose_n_nodes",
           "train_batch_specs", "params_shape", "opt_state_shape",
           "prefill_specs", "decode_specs", "make_opt", "step_topology",
           "train_loss_fn", "node_grads", "make_split", "Layout",
           "build_train_step", "build_prefill_step",
           "pinned_cache_constraint", "build_decode_step"]

PyTree = Any

# the reference's per-chip budget that decides decentralized feasibility
# (TPU v5e: 16 GB HBM; headroom for activations); its rows only
HBM_BYTES = 16e9
NODE_BUDGET = 14e9

# the card's: H100 SXM5 data sheet, 80 GB HBM3 (``roofline.H100``); 16 GB
# of headroom for activations and the caching allocator's slack
H100_HBM_BYTES = H100.hbm_bytes
H100_NODE_BUDGET = 64e9

#: StepConfig fields that steer XLA alone (scan unrolling) and change
#: nothing in the port
IGNORED_KNOBS = ("unroll",)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    cfg: ModelConfig
    shape: InputShape
    n_nodes: int
    lr: float = 0.1
    beta: float = 0.9
    weight_decay: float = 1e-4
    chunk: int = 1024          # attention kv-chunk
    ssd_chunk: int = 256
    unroll: bool = False
    remat: str = "full"
    param_dtype: Any = torch.bfloat16
    gossip_schedule: str = "dense"   # dense | ring_ppermute | sparse_ppermute
    topology: str = "ring"           # any core/topology.get_topology name
    runtime: str = "vmap"            # vmap | sharded: 'sharded' runs one
                                     # node a rank over a NodeMesh
    skip_masked_chunks: bool = False
    cache_shard_features: bool = True
    remat_attention: bool = False
    pin_decode_cache: bool = False
    shard_tie_break_last: bool = False
    decode_lowp: bool = False           # decode attn in the cache dtype
    shard_activations: bool = False
    repeat_kv: bool = False
    megatron_attn: bool = False
    pin_moe_dispatch: bool = False


def _check(sc: StepConfig) -> None:
    if sc.remat not in tf.REMAT_MODES:
        raise ValueError(f"StepConfig.remat must be one of "
                         f"{tf.REMAT_MODES}, got {sc.remat!r}")


def choose_n_nodes(cfg: ModelConfig, mesh, *, budget: float = NODE_BUDGET,
                   param_bytes: int = 2) -> int:
    """Decentralization arity for a mesh (DESIGN.md §5 feasibility table).

    ``mesh`` is a ``launch/mesh.RankMesh``, a ``NodeMesh`` or a
    ``MeshShape``.  A 'pod' axis makes each pod a node (hierarchical pods
    as clients); else the ``data`` axis carries the nodes when a node's x
    + m_hat + grads (``param_bytes`` each), stored over its 'model' ranks,
    fit ``budget``, and one node (QHM) runs otherwise.  ``budget`` is the
    reference's v5e figure by default; the dry run passes
    :data:`H100_NODE_BUDGET`."""
    axes = dict(mesh.shape)
    if "pod" in axes:
        return axes["pod"]
    if "data" not in axes:
        warnings.warn(
            f"mesh axes {sorted(axes)} have no 'data' axis to carry the "
            "node index; falling back to n_nodes=1 (pure local QHM)")
        return 1
    n = axes["data"]
    per_rank = cfg.n_params() * param_bytes * 3 / axes.get("model", 1)
    return n if per_rank <= budget else 1


# ---------------------------------------------------------------------------
# input specs (meta tensors; nothing allocated)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(sc: StepConfig) -> dict:
    cfg, shape = sc.cfg, sc.shape
    n = sc.n_nodes
    assert shape.global_batch % n == 0
    b = shape.global_batch // n
    batch = {"tokens": _meta((n, b, shape.seq_len), torch.int32),
             "labels": _meta((n, b, shape.seq_len), torch.int32)}
    if cfg.n_image_tokens:
        batch["image_embeds"] = _meta(
            (n, b, cfg.n_image_tokens, cfg.d_model), sc.param_dtype)
    return batch


def params_shape(sc: StepConfig, *, node_stacked: bool) -> PyTree:
    base = tf.init_lm(None, sc.cfg, dtype=sc.param_dtype, device="meta")
    if not node_stacked:
        return base
    return tree_map(lambda l: _meta((sc.n_nodes,) + tuple(l.shape), l.dtype),
                    base)


def opt_state_shape(sc: StepConfig, params: PyTree) -> PyTree:
    return make_opt(sc).init(params)


def prefill_specs(sc: StepConfig) -> dict:
    cfg, shape = sc.cfg, sc.shape
    out = {"tokens": _meta((shape.global_batch, shape.seq_len), torch.int32)}
    if cfg.n_image_tokens:
        out["img"] = _meta((shape.global_batch, cfg.n_image_tokens,
                            cfg.d_model), sc.param_dtype)
    return out


def decode_specs(sc: StepConfig) -> dict:
    cfg, shape = sc.cfg, sc.shape
    return {"token": _meta((shape.global_batch, 1), torch.int32),
            "pos": _meta((), torch.int32),
            "cache": tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   dtype=sc.param_dtype, device="meta")}


# ---------------------------------------------------------------------------
# optimizers / gossip
# ---------------------------------------------------------------------------

def make_opt(sc: StepConfig):
    """Chain-built optimizer from the registry (``core/transforms.py``):
    QHM is the n_nodes=1 reduction (zero mix sites); QG-DSGDm-N otherwise.
    Non-dense schedules are installed by the step builder.

    The dtype rule: the optimizer kernels take fp32 leaves only, and a
    non-fp32 leaf on a CUDA device raises in the fused chain (there is no
    quiet plain path on the card).  So an fp32 ``param_dtype`` keeps
    ``fused='auto'`` (the kernels on CUDA tensors: one ``qg_step`` launch
    a plan slice on the dense mix) and any other dtype builds the chain
    with ``fused='off'``, stage by stage.  A rule on the dtype, fixed when
    the optimizer is built; nothing falls back at run time."""
    fused = "auto" if sc.param_dtype == torch.float32 else "off"
    if sc.n_nodes == 1:
        return make_optimizer("qhm", lr=sc.lr, beta=sc.beta,
                              weight_decay=sc.weight_decay, fused=fused)
    return make_optimizer("qg_dsgdm_n", lr=sc.lr, beta=sc.beta,
                          weight_decay=sc.weight_decay,
                          mix_fn=gossip.mix_dense, fused=fused)


def step_topology(sc: StepConfig) -> topo_lib.Topology:
    """The StepConfig's topology (n_nodes=1 degrades to the trivial ring)."""
    if sc.n_nodes == 1:
        return topo_lib.ring(1)
    return topo_lib.get_topology(sc.topology, sc.n_nodes)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def train_loss_fn(sc: StepConfig, placement=None, split=None, rows=None):
    """One node's loss ``loss(params, batch) -> 0-d``: ``tf.train_loss``
    at the StepConfig's chunks, ``remat`` and attention knobs; with a
    ``placement`` the params are the rank's blocks, with a ``split`` the
    compute is split over 'model', with ``rows`` (``sharding.Rows``) the
    batch is the rank's rows and the loss its share of the node's."""
    cfg = sc.cfg

    def loss_fn(p, batch):
        return tf.train_loss(p, batch, cfg, chunk=sc.chunk,
                             ssd_chunk=sc.ssd_chunk, remat=sc.remat,
                             skip_masked_chunks=sc.skip_masked_chunks,
                             remat_attention=sc.remat_attention,
                             repeat_kv=_repeat_kv(sc), placement=placement,
                             split=split, rows=rows)

    return loss_fn


def _repeat_kv(sc: StepConfig) -> bool:
    return sc.repeat_kv or sc.megatron_attn


def make_split(sc: StepConfig, layout, *, decode: bool = False):
    """The compute split of ``sc``'s knobs on ``layout``'s placement
    (``sharding.Split.make``; ``decode`` for a decode step's), or None."""
    if layout is None or layout.placement is None:
        return None
    return sharding.Split.make(layout.placement, sc.cfg,
                               heads=sc.megatron_attn,
                               features=sc.shard_activations,
                               experts=sc.pin_moe_dispatch, decode=decode)


def node_grads(sc: StepConfig, params, batch):
    """``(losses [n], grads)`` of node-stacked ``params`` on ``batch``:
    the train step's gradient half, as :func:`build_train_step` takes
    it."""
    _check(sc)
    return _node_grads(train_loss_fn(sc), params, batch)


def _row_grads(layout, loss_fn, params, batch):
    """:func:`_node_grads` on the rank's rows: where a ``layout`` splits
    the rows (``layout.rows``), the ranks' losses summed into the nodes'
    and the gradients of the leaves stored along no row axis all-reduced
    (the others were reduce-scattered in their gathers' backward)."""
    losses, grads = _node_grads(loss_fn, params, batch)
    rows = layout.rows if layout is not None else None
    if rows is None:
        return losses, grads
    return rows.reduce(losses), rows.reduce_grads(grads,
                                                  layout.specs["params"])


def _node_grads(loss_fn, params, batch):
    """``(losses [n], grads)``: the loss mapped over the node axis, and the
    gradient of the losses' sum (exact per-node grads), contiguous."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        losses = torch.func.vmap(loss_fn)(tree_unflatten(treedef, leaves),
                                          batch)
        grads = torch.autograd.grad(losses.sum(), leaves)
    return losses.detach(), tree_unflatten(
        treedef, [g.contiguous() for g in grads])


class _OnDevice:
    """The builder's constants (the mixing matrix ``W(0)``, a compiled
    plan) made once a device, on first use: the step takes its device from
    the params it is given."""

    def __init__(self, make):
        self._make, self._made = make, {}

    def __call__(self, device):
        key = torch.device(device)
        if key not in self._made:
            self._made[key] = self._make(key)
        return self._made[key]


def _rows_cut(sc: StepConfig, specs, axes: tuple):
    """The cache ``specs`` without the row ``axes`` on each leaf's rows
    (the dim whose length is the batch's: a rank computes its rows of
    those whole), for a placement that gathers, writes and cuts the rest;
    a leaf with no rows (a ring buffer's ``slot_pos``) keeps its spec."""
    one, two = (tf.init_cache(sc.cfg, b, sc.shape.seq_len, device="meta")
                for b in (1, 2))

    def cut(a, spec, b):
        rows = [i for i, (m, n) in enumerate(zip(a.shape, b.shape)) if m != n]
        if not rows:
            return spec
        if not sharding.same_layout((spec[rows[0]],), (axes,)):
            raise ValueError(f"a cache leaf's rows are stored by "
                             f"{spec[rows[0]]}, not by the row axes {axes}")
        return tuple(None if i == rows[0] else e for i, e in enumerate(spec))

    return tree_map(cut, one, specs, two)


@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """A step's state on a mesh (``sharding.make_plan``'s plan): the specs
    of its trees, their global shapes (``meta``) and the ``placement``
    that gathers the weights on use (None where no axis shards a weight).
    ``keep`` names the axes a rank holds whole although the specs name
    them: the vmap runtime holds every node on each rank.  ``rows``
    (``sharding.Rows``, or None): the data axes over which the rank
    computes its rows of a node's batch (``specs["batch"]``, the
    reference's ``batch_specs``), None where the batch is whole."""

    plan: Any
    specs: dict
    shapes: dict
    placement: Any
    keep: tuple = ()
    rows: Any = None

    @staticmethod
    def make(sc: StepConfig, mesh, *, kind: str, keep_nodes: bool = False,
             rows: bool = True) -> "Layout":
        """``kind``: 'train' (node-stacked params, optimizer state and
        batch), 'prefill' or 'decode' (params, the caches, and the tokens
        (and image) as the batch).  ``rows``: split a node's batch rows
        over the data axes where the reference's ``batch_specs`` does
        (``sharding.row_axes``), except in train and prefill under
        ``megatron_attn`` or ``shard_activations``, whose constraints in
        the reference name the batch dims None; False keeps it whole (the
        pinned decode, which computes on its cache blocks' rows itself)."""
        n_nodes = sc.n_nodes if kind == "train" else 1
        plan = sharding.make_plan(mesh, n_nodes=n_nodes)
        tie = sc.shard_tie_break_last
        if kind == "train":
            p = params_shape(sc, node_stacked=True)
            o = opt_state_shape(sc, p)
            shapes = {"params": p, "opt_state": o,
                      "batch": train_batch_specs(sc)}
            specs = {"params": sharding.param_specs(
                         plan, p, node_stacked=True, tie_break_last=tie),
                     "opt_state": sharding.param_specs(
                         plan, o, node_stacked=True, tie_break_last=tie)}
        else:
            p = params_shape(sc, node_stacked=False)
            d = decode_specs(sc)
            shapes = {"params": p, "cache": d["cache"],
                      "batch": prefill_specs(sc) if kind == "prefill"
                      else {"token": d["token"]}}
            specs = {"params": sharding.param_specs(plan, p,
                                                    tie_break_last=tie),
                     "cache": sharding.cache_specs(
                         plan, shapes["cache"],
                         shard_features=sc.cache_shard_features)}
        specs["batch"] = sharding.batch_specs(plan, shapes["batch"])
        whole = not rows or (kind != "decode" and (
            sc.megatron_attn or sc.shard_activations))
        axes = () if whole else sharding.row_axes(
            plan, shapes["batch"], specs["batch"],
            key="token" if kind == "decode" else "tokens",
            lead=1 if kind == "train" else 0)
        if not axes:
            specs["batch"] = tree_map(
                lambda x, spec: tuple(e if e == plan.node_axis else None
                                      for e in spec),
                shapes["batch"], specs["batch"])
        row_split = sharding.Rows(plan.mesh, axes) if axes else None
        cache_specs = specs.get("cache")
        if row_split is not None and cache_specs is not None:
            cache_specs = _rows_cut(sc, cache_specs, axes)
        placement = None
        if sharding.weight_axes(plan):
            placement = sharding.Placement.make(
                plan, params=p, param_specs=specs["params"],
                cache=shapes.get("cache"), cache_specs=cache_specs,
                rows=row_split)
        keep = (plan.node_axis,) if keep_nodes and plan.node_axis else ()
        return Layout(plan, specs, shapes, placement, keep, row_split)

    def local(self, what: str, tree):
        """This rank's blocks of the ``what`` tree (global or blocks)."""
        return sharding.shard_tree(self.plan, self.specs[what], tree,
                                   shapes=self.shapes[what], skip=self.keep)

    def batch_leaf(self, name: str, x):
        """This rank's rows of the batch leaf ``name`` (a serving step's
        ``tokens``, ``img`` or ``token``, of any length: the node's rows,
        or the rank's)."""
        if self.rows is None:
            return x
        b = self.shapes["batch"][name].shape[0]
        if x.shape[0] == b // self.rows.size:
            return x
        if x.shape[0] != b:
            raise ValueError(f"{name}: {x.shape[0]} rows are neither the "
                             f"batch's {b} nor a rank's {b // self.rows.size}")
        return self.rows.cut(x).contiguous()


def build_train_step(sc: StepConfig, *, mesh=None,
                     node_axis: str | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    mean loss)`` on node-stacked trees (``[n, ...]``; with
    ``runtime='sharded'`` see :func:`_build_sharded_train_step`).  With a
    ``mesh`` the trees are laid out by its plan (:class:`Layout`); the vmap
    runtime holds every node on each rank, so a real mesh whose axes carry
    the nodes needs ``runtime='sharded'``."""
    _check(sc)
    topo = step_topology(sc)
    # the builder's step is phase-static (it passes t=0), so time-varying
    # topologies contribute their first phase here
    w_np = np.asarray(topo.w(0), np.float32)
    w_on = _OnDevice(lambda dev: torch.as_tensor(w_np, device=dev))
    opt = make_opt(sc)
    layout = None
    if mesh is not None:
        layout = Layout.make(sc, mesh, kind="train",
                             keep_nodes=sc.runtime == "vmap")
    split = make_split(sc, layout)
    rows = layout.rows if layout else None
    loss_fn = train_loss_fn(sc, layout.placement if layout else None, split,
                            rows)

    if sc.runtime == "sharded":
        step = _build_sharded_train_step(sc, topo, w_on, loss_fn, opt,
                                         mesh=mesh, node_axis=node_axis,
                                         layout=layout)
        step.split = split
        return step
    if sc.runtime != "vmap":
        raise ValueError(f"StepConfig.runtime must be 'vmap' or 'sharded', "
                         f"got {sc.runtime!r}")
    if layout is not None and layout.plan.node_count > 1 \
            and not isinstance(mesh, MeshShape):
        raise ValueError(
            f"runtime='vmap' holds all {sc.n_nodes} nodes on each rank, "
            f"but the mesh's {layout.plan.node_axis!r} axis carries one "
            "node a rank: build with runtime='sharded'")

    # schedule selection lives in ONE resolver shared with the trainer; the
    # dense kind keeps the optimizer's gossip.mix_dense (the hook the fused
    # dispatcher matches to one qg_step launch), a compiled schedule runs as
    # local gathers over the stack, as the vmap runtime installs it
    resolved = gossip.resolve_gossip(topo, schedule=sc.gossip_schedule,
                                     mesh=mesh, node_axis=node_axis)
    plan_on = None
    if resolved.kind != "dense":
        sched = resolved.schedule or gossip.compile_gossip_schedule(topo)
        bsched = gossip.compile_block_schedule(sched, 1)
        plan_on = _OnDevice(lambda dev: bsched.on_rank(0, dev))

    def train_step(params, opt_state, batch):
        if layout is not None:
            params = layout.local("params", params)
            opt_state = layout.local("opt_state", opt_state)
            batch = layout.local("batch", batch)
        dev = tree_flatten(params)[0][0].device
        w = w_on(dev)
        step_opt = opt
        if plan_on is not None:
            step_opt = dataclasses.replace(
                opt, mix_fn=gossip.make_block_mix_fn(plan_on(dev), mesh=None,
                                                     w_ref=w, t=0))
        losses, grads = _row_grads(layout, loss_fn, params, batch)
        with torch.no_grad():
            new_params, new_opt = step_opt.step(params, grads, opt_state,
                                                w=w, lr=sc.lr, t=0)
        return new_params, new_opt, torch.mean(losses)

    train_step.layout, train_step.split = layout, split
    return train_step


def _build_sharded_train_step(sc: StepConfig, topo, w_on, loss_fn, opt, *,
                              mesh, node_axis, layout):
    """The sharded-runtime variant: one node a rank of the mesh's
    ``node_axis`` (DESIGN.md §9; a ``launch/mesh.NodeMesh``, or that axis
    of a ``RankMesh``).  Each rank computes only its own node: per-node
    grad, the transform chain, and the compiled gossip rounds over the
    axis's group (``gossip.make_local_mix_fn``).

    ``train_step`` takes node-stacked trees, global (each leaf cut to this
    rank's block by the layout: its row of the node axis, its block of the
    weight axes) or this rank's blocks, and returns this rank's blocks of
    the new params and opt state and the loss averaged over the nodes;
    ``sharding.gather_tree`` joins blocks back to ``[n, ...]``."""
    if mesh is None or node_axis is None:
        raise ValueError("StepConfig.runtime='sharded' needs mesh= and "
                         "node_axis=")
    if layout.plan.node_axis != node_axis:
        raise ValueError(
            f"runtime='sharded': {sc.n_nodes} nodes ride the mesh's "
            f"{layout.plan.node_axis!r} axis, not {node_axis!r}")
    n = topo.n
    if dict(mesh.shape).get(node_axis) != n:
        raise ValueError(
            f"runtime='sharded': mesh axis {node_axis!r} has size "
            f"{dict(mesh.shape).get(node_axis)}, topology has n={n}")
    resolved = gossip.resolve_gossip(topo, schedule=sc.gossip_schedule,
                                     mesh=mesh, node_axis=node_axis)
    if resolved.kind == "dense":
        schedule = None           # every site: the all-gather contraction
    elif resolved.schedule is not None:
        schedule = resolved.schedule
    else:                         # 'ring' carries no schedule
        schedule = gossip.compile_gossip_schedule(topo)

    nodes = mesh.axis(node_axis)

    def train_step(params, opt_state, batch):
        params = layout.local("params", params)
        opt_state = layout.local("opt_state", opt_state)
        batch = layout.local("batch", batch)
        w = w_on(tree_flatten(params)[0][0].device)
        losses, grads = _row_grads(layout, loss_fn, params, batch)
        mix = gossip.make_local_mix_fn(schedule, mesh=nodes, w_ref=w, t=0)
        with torch.no_grad():
            new_params, new_opt = dataclasses.replace(opt, mix_fn=mix).step(
                params, grads, opt_state, w=w, lr=sc.lr, t=0, n_nodes=n,
                mesh=nodes)
        loss = nodes.all_reduce(torch.mean(losses)) / n
        return new_params, new_opt, loss

    train_step.layout = layout
    return train_step


def _serve_layout(sc: StepConfig, mesh, kind: str, rows: bool = True):
    if mesh is None:
        return None, None
    layout = Layout.make(sc, mesh, kind=kind, rows=rows)
    return layout, layout.placement


def build_prefill_step(sc: StepConfig, *, mesh=None):
    """``prefill_step(params, tokens, img=None) -> (last logits, caches)``.
    With a ``mesh`` the params are global or the rank's blocks and the
    caches come back as the rank's blocks (``sharding.cache_specs``); the
    tokens and the image are global or the rank's rows, each rank computes
    its rows where the layout splits them (``Layout.rows``; else the whole
    batch), and the split knobs divide its compute over 'model'
    (:func:`make_split`); the last logits come back whole."""
    _check(sc)
    cfg = sc.cfg
    layout, placement = _serve_layout(sc, mesh, "prefill")
    split = make_split(sc, layout)
    rows = layout.rows if layout else None

    def prefill_step(params, tokens, img=None):
        if layout is not None:
            params = layout.local("params", params)
            tokens = layout.batch_leaf("tokens", tokens)
            if img is not None:
                img = layout.batch_leaf("img", img)
        logits, cache = tf.prefill(
            params, tokens, cfg, img=img, chunk=sc.chunk,
            ssd_chunk=sc.ssd_chunk, cache_len=sc.shape.seq_len,
            skip_masked_chunks=sc.skip_masked_chunks,
            repeat_kv=_repeat_kv(sc), placement=placement, split=split,
            rows=rows)
        return (logits if rows is None else rows.join(logits)), cache

    prefill_step.layout, prefill_step.split = layout, split
    return prefill_step


def pinned_cache_constraint(layout: Layout):
    """The reference's decode pin on ``layout`` (``lower_decode`` under
    ``pin_decode_cache``): a ``sharding.NamedSharding`` of a layer's K
    spec, or None where no block keeps a K cache."""
    spec = sharding.pinned_cache_spec(layout.shapes["cache"],
                                      layout.specs["cache"])
    return None if spec is None else sharding.NamedSharding(layout.plan.mesh,
                                                            spec)


def _check_constraint(constraint, layout) -> None:
    """A ``cache_constraint`` must be the layout the cache is stored by
    (:func:`pinned_cache_constraint`); any other raises, naming both."""
    stored = None if layout is None else pinned_cache_constraint(layout)
    got = getattr(constraint, "spec", constraint)
    mesh = getattr(constraint, "mesh", None)
    if stored is not None and sharding.same_layout(got, stored.spec) and (
            mesh is None or dict(mesh.shape) == dict(stored.mesh.shape)):
        return
    raise ValueError(
        f"cache_constraint {got} (mesh "
        f"{None if mesh is None else dict(mesh.shape)}) is not the layout "
        f"the decode cache is stored by: "
        f"{None if stored is None else stored.spec} (mesh "
        f"{None if layout is None else dict(layout.plan.mesh.shape)}), a "
        "layer's K spec under sharding.cache_specs")


def build_decode_step(sc: StepConfig, *, cache_constraint=None, mesh=None):
    """``decode_step(params, token, pos, cache) -> (logits, cache)``, the
    cache written in place (with a ``mesh``: the rank's blocks, as the
    prefill step returns them; the token is global or the rank's rows, the
    rank computes its rows where the layout splits them, and each layer's
    cache is gathered along the other axes, written and its block put
    back; the logits come back whole).  Pinned (``sc.pin_decode_cache``, or a
    ``cache_constraint`` equal to the layout the cache is stored by, which
    implies the pin; the mesh may come with it, a ``sharding.
    NamedSharding``), the step attends over and writes into the rank's
    cache blocks and gathers no cache leaf.  The split knobs divide its
    weight products over 'model' (:func:`make_split`)."""
    _check(sc)
    if mesh is None and cache_constraint is not None:
        mesh = getattr(cache_constraint, "mesh", None)
    cfg = sc.cfg
    pin = sc.pin_decode_cache or cache_constraint is not None
    layout, placement = _serve_layout(sc, mesh, "decode", rows=not pin)
    if cache_constraint is not None:
        _check_constraint(cache_constraint, layout)
    split = make_split(sc, layout, decode=True)
    rows = layout.rows if layout else None

    def decode_step(params, token, pos, cache):
        if layout is not None:
            params = layout.local("params", params)
            cache = layout.local("cache", cache)
            token = layout.batch_leaf("token", token)
        logits, cache = tf.decode_step(params, token, pos, cache, cfg,
                                       decode_lowp=sc.decode_lowp,
                                       placement=placement, split=split,
                                       pin_cache=pin, rows=rows)
        return (logits if rows is None else rows.join(logits)), cache

    decode_step.layout, decode_step.split = layout, split
    decode_step.pinned = pin and placement is not None
    return decode_step
