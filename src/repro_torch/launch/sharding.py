"""Layout rules for the launch tooling: which leaves a rank holds, and how
many bytes that is.

Port of ``repro/launch/sharding.py``, the node axis only.  The reference
places a node axis ('data' in a pod, or 'pod' across pods) and shards every
weight over a 'model' axis (tensor parallelism) and, where the nodes ride
on 'pod', over 'data' as well (FSDP).  The port runs one node a rank over a
``torch.distributed`` group (``launch/mesh.NodeMesh``, or its shape alone,
``MeshShape``): a node-stacked leaf ``[n, ...]`` puts row ``r`` on rank
``r``, and everything else is whole on every rank.  A plan that needs a
'model' axis, FSDP, ``tie_break_last`` or ``shard_features`` raises,
naming the tensor or data parallelism the port does not have.

Specs are per-leaf tuples in ``runtime/sharded.node_leaf_spec``'s form
(``("data", None, ...)`` for a node-stacked leaf, ``()`` for a whole one),
so the runtimes and the dry run read one rule.  The reference's ``named``
(``NamedSharding`` over a JAX mesh) has no counterpart: a rank's block is
cut by the runtimes, not by a sharding annotation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.runtime.sharded import node_leaf_spec
from repro_torch.tree import tree_flatten, tree_map

__all__ = ["ShardingPlan", "make_plan", "param_specs", "batch_specs",
           "cache_specs", "bytes_per_rank"]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Any
    node_axis: Optional[str]       # 'data' | None (one node: no node axis)

    @property
    def node_count(self) -> int:
        """Nodes the node axis carries (1 without one)."""
        return dict(self.mesh.shape)[self.node_axis] if self.node_axis \
            else 1


def _refuse_axes(axes: dict) -> None:
    if "pod" in axes:
        raise ValueError(
            "a 'pod' axis puts one node on a pod and shards its weights over "
            "the pod's data axis (FSDP, data parallelism inside a node); "
            "the port runs one node a rank and has no FSDP")
    if axes.get("model", 1) != 1:
        raise ValueError(
            f"a 'model' axis of {axes['model']} shards every weight over "
            "its ranks (tensor parallelism); the port has none")


def make_plan(mesh, *, n_nodes: int) -> ShardingPlan:
    """``data`` carries the node axis when ``n_nodes`` equals its size;
    ``n_nodes <= 1`` gives no node axis (each rank that runs the step
    holds all of it)."""
    axes = dict(mesh.shape)
    _refuse_axes(axes)
    if n_nodes <= 1:
        return ShardingPlan(mesh, None)
    if n_nodes == axes.get("data"):
        return ShardingPlan(mesh, "data")
    raise ValueError(f"n_nodes={n_nodes} does not match any mesh axis of "
                     f"{axes}")


def _node_spec(plan: ShardingPlan, leaf) -> tuple:
    if plan.node_axis is None:
        return ()
    return node_leaf_spec(leaf, n=plan.node_count, axis_name=plan.node_axis)


def param_specs(plan: ShardingPlan, params_shape: PyTree, *,
                node_stacked: bool = False,
                tie_break_last: bool = False) -> PyTree:
    """Per-leaf specs of a params (or opt-state) tree: the node axis on
    dim 0 of a node-stacked leaf, every other dim whole.
    ``tie_break_last`` picks the 'model' dim of square weights in the
    reference; there is no 'model' axis here, so ``True`` raises."""
    if tie_break_last:
        raise ValueError("tie_break_last places the 'model' axis (tensor "
                         "parallelism), which the port does not have")
    if not node_stacked:
        return tree_map(lambda leaf: (), params_shape)
    return tree_map(lambda leaf: _node_spec(plan, leaf), params_shape)


def batch_specs(plan: ShardingPlan, batch_shape: PyTree) -> PyTree:
    """Batches ``[n_nodes, per_node_batch, ...]`` put node ``r``'s rows on
    rank ``r``; a batch without the node axis is whole on its rank (the
    reference shards it over the data axes, data parallelism the port does
    not have)."""
    return tree_map(lambda leaf: _node_spec(plan, leaf), batch_shape)


def cache_specs(plan: ShardingPlan, cache_shape: PyTree, *,
                shard_features: bool = False) -> PyTree:
    """KV caches and SSM states are whole on the serving rank.
    ``shard_features`` shards their feature dims over 'model' in the
    reference; ``True`` raises here."""
    if shard_features:
        raise ValueError("shard_features shards the caches over the 'model' "
                         "axis (tensor parallelism), which the port does "
                         "not have")
    return tree_map(lambda leaf: (), cache_shape)


def bytes_per_rank(plan: ShardingPlan, tree: PyTree) -> int:
    """Bytes one rank holds of ``tree`` (tensors, ``meta`` ones included),
    by the specs above: a leaf that carries the node axis holds one row of
    it, any other all of itself."""
    total = 0
    for leaf in tree_flatten(tree)[0]:
        nbytes = leaf.numel() * leaf.element_size()
        spec = _node_spec(plan, leaf)
        if spec:
            nbytes //= leaf.shape[spec.index(plan.node_axis)]
        total += nbytes
    return int(total)
