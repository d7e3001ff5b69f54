"""Meshes of ranks: the node axis, and named axes over a
``torch.distributed`` process group.

Port of ``repro/launch/mesh.py``: where the reference lays its axes over a
JAX device mesh, the port lays them over the ranks of a process group, one
rank a card (or a CPU process under gloo).  :class:`NodeMesh` is one axis:
the group, this process's rank in it, its size, the axis name and the
rank's device, with the collectives the sparse and block gossip executors
(``core/gossip.py``), the sharded and hybrid runtimes and the sharded
launch state (``launch/sharding.py``) use:

* ``post`` -- point-to-point sends and receives in one
  ``dist.batch_isend_irecv`` (the counterpart of ``jax.lax.ppermute``);
* ``all_gather`` / ``gather_nodes`` (``jax.lax.all_gather``);
* ``all_reduce`` (``psum`` / ``pmax``), ``reduce_scatter_dim``
  (``psum_scatter``), ``all_gather_dim`` and ``all_to_all``
  (``jax.lax.all_to_all``, with blocks of any size).

Build one with :func:`make_node_mesh` after
:func:`repro_torch.launch.distributed.initialize`.  Its ``shape`` is
``{axis_name: size}``, as a JAX mesh's, so the runtime-selection rules read
it as the reference reads a mesh.

:class:`RankMesh` names several axes over the whole group, the reference's
``('data', 'model')`` and ``('pod', 'data', 'model')`` meshes
(:func:`make_production_mesh`, :func:`make_debug_mesh`): the ranks laid out
row-major over the shape (process-major, as the reference's
``_device_grid``: rank ``r`` sits at ``numpy.unravel_index(r, shape)``, so
'model' varies fastest), each axis a :class:`NodeMesh` over the subgroup of
ranks that differ only along it.  On the ``meta`` device a mesh is its
shape alone (:class:`MeshShape`, no process group): what the dry run
traces a 256- or 512-rank mesh with.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["NodeMesh", "MeshShape", "RankMesh", "make_node_mesh",
           "make_mesh", "make_production_mesh", "make_debug_mesh"]


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

    def axis(self, name: str) -> "NodeMesh":
        """This mesh, which is its one axis ``name``."""
        if name != self.axis_name:
            raise KeyError(f"a node mesh has the one axis "
                           f"{self.axis_name!r}, not {name!r}")
        return self

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

    def all_gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` joined along ``dim`` in rank order, by one
        ``all_gather_into_tensor``; a new contiguous tensor."""
        x = x.contiguous()
        # the blocks one after another along dim 0 (the layout every
        # backend takes)
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.group)
        dim = dim % x.dim()
        if dim == 0:
            return out
        shape = list(x.shape)
        shape[dim] *= self.size
        return out.view((self.size,) + tuple(x.shape)).movedim(
            0, dim).reshape(shape)

    def reduce_scatter_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` summed over the ranks, this rank's block along ``dim`` (the
        ``rank``-th of ``size`` equal blocks), by one reduce-scatter; a new
        contiguous tensor."""
        dim = dim % x.dim()
        # the blocks one after another along dim 0 (the layout every
        # backend takes)
        parts = x.movedim(dim, 0).contiguous()
        out = parts.new_empty((parts.shape[0] // self.size,)
                              + tuple(parts.shape[1:]))
        dist.reduce_scatter_tensor(out, parts, group=self.group)
        return out.movedim(0, dim).contiguous()

    def all_to_all(self, x: torch.Tensor, out_rows, in_rows) -> torch.Tensor:
        """Rows of ``x`` sent to the ranks in rank order (``in_rows[t]``
        to rank ``t``), and the rows every rank sends this one joined in
        rank order (``out_rows[q]`` from rank ``q``), by one
        ``all_to_all_single``; a new contiguous tensor."""
        x = x.contiguous()
        out = x.new_empty((sum(out_rows),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x, list(out_rows), list(in_rows),
                               group=self.group)
        return out

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
    """The shape of a mesh and nothing else: what the launch tooling
    (``launch/steps.py``, ``launch/sharding.py``, the dry run) reads of a
    mesh, with no process group behind it (a ``meta`` trace).  ``axes`` is
    ``((name, size), ...)``; ``shape`` reads as a :class:`RankMesh`'s and a
    JAX mesh's, ``size`` is the rank count."""

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

    @property
    def axis_names(self) -> tuple:
        return tuple(name for name, _ in self.axes)


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh:
    """Named axes over every rank of the default group (this process is
    global ``rank`` on ``device``): ``axes`` is ``((name, size), ...)``,
    ``coords`` this rank's index along each, ``groups`` each axis's
    :class:`NodeMesh` (the ranks that share every other coordinate).
    ``shape`` and ``axis_names`` read as a JAX mesh's."""

    axes: tuple
    rank: int
    device: torch.device
    coords: dict
    groups: dict

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def size(self) -> int:
        return math.prod(n for _, n in self.axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(name for name, _ in self.axes)

    def axis(self, name: str) -> NodeMesh:
        """The :class:`NodeMesh` of axis ``name`` through this rank."""
        return self.groups[name]


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


def make_mesh(shape, axes, *, device=None):
    """A mesh of ``shape`` with axis names ``axes`` over the default
    process group, whose ranks must number ``prod(shape)``; the ranks are
    laid out row-major (process-major), the rank's device is its card
    under NCCL and the CPU under gloo.  Every rank makes the same subgroups
    in the same order, so every rank must call this.  ``device="meta"``
    gives the shape alone (:class:`MeshShape`), with no process group."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"a mesh needs one distinct name an axis: shape "
                         f"{shape}, axes {axes}")
    if device is not None and torch.device(device).type == "meta":
        return MeshShape(tuple(zip(axes, shape)))
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {shape} needs a torch.distributed process group of "
            f"{n} ranks: call repro_torch.launch.distributed.initialize("
            f"coordinator=, num_processes={n}, process_id=) in every "
            "process first (or pass device='meta' for the shape alone)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, the process group has {world} "
            f"-- start {n} processes, each with repro_torch.launch."
            f"distributed.initialize(num_processes={n}, process_id=<its "
            "rank>)")
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    grid = np.arange(n).reshape(shape)
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    groups = {}
    for k, name in enumerate(axes):
        for line in np.moveaxis(grid, k, -1).reshape(-1, shape[k]):
            ranks = [int(r) for r in line]
            # the whole group needs no subgroup (and a one-rank world has
            # only this one)
            group = None if len(ranks) == world else dist.new_group(ranks)
            if rank in ranks:
                groups[name] = NodeMesh(group=group, rank=ranks.index(rank),
                                        size=shape[k], device=device,
                                        axis_name=name)
    return RankMesh(axes=tuple(zip(axes, shape)), rank=rank, device=device,
                    coords=coords, groups=groups)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production meshes: ``(16, 16)`` over ``('data',
    'model')``, or ``(2, 16, 16)`` over ``('pod', 'data', 'model')`` with
    ``multi_pod``; :func:`make_mesh`'s rules."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), *, device=None):
    """A small mesh for tests (gloo ranks on the CPU, or ``meta``)."""
    return make_mesh(shape, axes, device=device)
