"""The node axis over a ``torch.distributed`` process group.

Port of ``repro/launch/mesh.py``'s role: where the reference lays the node
index over a JAX mesh axis, the port lays it over the ranks of a process
group, one rank a card (or a CPU process under gloo).  :class:`NodeMesh`
carries the group, this process's rank, the world size, the axis name and
the rank's device, and offers the collectives the sparse and block gossip
executors (``core/gossip.py``) and the sharded and hybrid runtimes use:

* ``post`` -- point-to-point sends and receives in one
  ``dist.batch_isend_irecv`` (the counterpart of ``jax.lax.ppermute``);
* ``all_gather`` / ``gather_nodes`` (``jax.lax.all_gather``);
* ``all_reduce`` (``psum`` / ``pmax``).

Build one with :func:`make_node_mesh` after
:func:`repro_torch.launch.distributed.initialize`.  Its ``shape`` is
``{axis_name: size}``, as a JAX mesh's, so the runtime-selection rules read
it as the reference reads a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["NodeMesh", "MeshShape", "make_node_mesh"]


@dataclasses.dataclass(frozen=True, eq=False)
class NodeMesh:
    """A node axis of ``size`` ranks; this process is ``rank`` on
    ``device``.  ``group`` is the process group (None: the default one)."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis_name: str = "data"

    @property
    def shape(self) -> dict:
        """``{axis_name: size}``, the form of a JAX mesh's ``shape``."""
        return {self.axis_name: self.size}

    def _global(self, rank: int) -> int:
        """The default group's rank of this group's ``rank`` (the
        point-to-point calls take that one)."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)

    # -- collectives ---------------------------------------------------------
    def post(self, sends, recvs) -> list:
        """Post ``sends`` and ``recvs`` (lists of ``(peer rank, tensor)``)
        as one ``batch_isend_irecv``; returns the work handles to wait on.
        Each peer pair's messages keep their order."""
        ops = [dist.P2POp(dist.isend, t, self._global(peer), self.group)
               for peer, t in sends]
        ops += [dist.P2POp(dist.irecv, t, self._global(peer), self.group)
                for peer, t in recvs]
        return dist.batch_isend_irecv(ops) if ops else []

    def all_gather(self, x: torch.Tensor, async_op: bool = False):
        """``[size, *x.shape]``: every rank's ``x`` in rank order.  With
        ``async_op`` returns ``(work, finish)``, ``finish()`` giving the
        stack once the work is waited on."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        work = dist.all_gather(parts, x, group=self.group, async_op=async_op)
        finish = lambda: torch.stack(parts)
        return (work, finish) if async_op else finish()

    def gather_nodes(self, x: torch.Tensor) -> torch.Tensor:
        """A block-sharded ``[b, ...]`` tensor as the global ``[n, ...]``
        stack, node ``g`` at row ``g`` (block-major: rank ``r`` holds rows
        ``r*b .. r*b + b - 1``)."""
        g = self.all_gather(x)
        return g.reshape((g.shape[0] * g.shape[1],) + tuple(g.shape[2:]))

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: ``x`` summed (``op='sum'``) or maxed (``'max'``)
        over the ranks."""
        out = x.clone()
        dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        return out


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """The shape of a node axis and nothing else: what the launch tooling
    (``launch/steps.py``, ``launch/sharding.py``, the dry run) reads of a
    mesh, with no process group behind it.  ``axes`` is ``((name,
    size), ...)``; ``shape`` reads as a :class:`NodeMesh`'s and a JAX
    mesh's, ``size`` is the rank count."""

    axes: tuple

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def size(self) -> int:
        out = 1
        for _, n in self.axes:
            out *= n
        return out


def make_node_mesh(size: int | None = None, *,
                   axis_name: str = "data") -> NodeMesh:
    """The node axis over the default process group, which
    :func:`repro_torch.launch.distributed.initialize` set up: ``size`` is
    the axis length the caller needs, and the group must have exactly that
    many ranks.  The rank's device is its card (``cuda:<current device>``)
    under NCCL and the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_node_mesh needs a torch.distributed process group: call "
            "repro_torch.launch.distributed.initialize(coordinator=, "
            "num_processes=, process_id=) in every process first")
    world = dist.get_world_size()
    if size is not None and size > world:
        raise RuntimeError(
            f"need {size} ranks for a node axis of {size}, have {world} — "
            f"start {size} processes, each with repro_torch.launch."
            f"distributed.initialize(coordinator=, num_processes={size}, "
            "process_id=<its rank>)")
    if size is not None and size < world:
        raise RuntimeError(
            f"the process group has {world} ranks but the node axis asks "
            f"for {size}: a node mesh spans the whole group; start "
            f"{size} processes")
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    return NodeMesh(group=None, rank=dist.get_rank(), size=world,
                    device=device, axis_name=axis_name)
