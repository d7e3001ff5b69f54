"""Execution backends for the decentralized trainer.

Port of ``repro/runtime``: one interface, three backends behind it:

  * ``'vmap'``    -- every node stacked on one device (the leading axis of
                     every tensor);
  * ``'sharded'`` -- one node a rank over a ``torch.distributed`` node axis
                     (``repro_torch.launch.mesh.NodeMesh`` of world size n),
                     the node-granular compiled gossip schedule;
  * ``'hybrid'``  -- ``b = n / d`` nodes a rank over d ranks, the
                     block-compiled schedule (the thousand-node scenario
                     backend; on one card, d = 1);
  * ``'auto'``    -- sharded when the trainer's mesh has the node axis at
                     size n, hybrid when that size properly divides n, vmap
                     otherwise.

Trajectories agree across backends up to the sum order of the mix (a
sparse schedule sums the few neighbours of a node in round order, the
dense one a matrix product); the stochastic compressors (random-k, QSGD)
draw per rank, so they differ by layout, as the reference documents.
"""
from __future__ import annotations

from typing import Any

from .base import Runtime
from .hybrid import HybridRuntime
from .overlap import OVERLAPS
from .sharded import ShardedRuntime
from .vmap import VmapRuntime

__all__ = ["Runtime", "VmapRuntime", "ShardedRuntime", "HybridRuntime",
           "RUNTIMES", "OVERLAPS", "resolve_runtime", "make_runtime"]

RUNTIMES = ("auto", "vmap", "sharded", "hybrid")


def resolve_runtime(name: str, *, mesh: Any = None,
                    node_axis: str | None = None, n: int = 1) -> str:
    """The backend selection rules: 'vmap' / 'sharded' / 'hybrid' as asked
    (checked against the mesh when the backend is built); 'auto' picks
    'sharded' iff a mesh carries ``node_axis`` at size ``n``, 'hybrid' iff
    that size properly divides ``n``, 'vmap' otherwise."""
    if name not in RUNTIMES:
        raise ValueError(f"unknown runtime {name!r}; valid: "
                         f"{' | '.join(RUNTIMES)}")
    if name != "auto":
        return name
    if mesh is not None and node_axis is not None:
        size = dict(mesh.shape).get(node_axis)
        if size == n:
            return "sharded"
        if size and size > 1 and n % size == 0:
            return "hybrid"
    return "vmap"


def make_runtime(trainer) -> Runtime:
    """The backend a :class:`~repro_torch.train.DecentralizedTrainer` asked
    for (its ``runtime``), 'auto' resolved against its mesh."""
    kind = resolve_runtime(trainer.runtime, mesh=trainer.mesh,
                           node_axis=trainer.node_axis,
                           n=trainer.topology.n)
    overlap = getattr(trainer, "overlap", "none")
    if kind == "sharded":
        return ShardedRuntime(trainer, overlap=overlap)
    if kind == "hybrid":
        return HybridRuntime(trainer, overlap=overlap)
    return VmapRuntime(trainer, overlap=overlap)
