"""ShardedRuntime: one node a rank over a ``torch.distributed`` node axis.

Port of ``repro/runtime/sharded.py``.  The node index is the node axis of a
:class:`~repro_torch.launch.mesh.NodeMesh` of world size n: each rank holds
its own node's params, optimizer, model and comm state (``[1, ...]``
blocks, so the memory a rank needs does not grow with n) and runs the whole
step on them; the gossip is the compiled node-granular schedule
(``gossip.apply_schedule_local``), point-to-point messages along the
graph's edges only.  The transform chain runs unchanged on the local
blocks: elementwise stages do not see the layout, and the node-reducing
ones reduce over the mesh (``StepCtx.mesh``).

The layout rule (``node_leaf_spec``): a leaf is node-stacked iff its global
leading dimension is n; such leaves are cut to this rank's rows, every
other leaf (step counters) is kept whole.  Every step metric is reduced
over all ranks; a per-node one (the loss, a model metric) is gathered to
``[n]`` and reduced as the vmap backend reduces it, so each rank's history
is the vmap history, up to the sum order of the mix.  Evaluation gathers
the per-node sums, so the host aggregation is the vmap one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import gossip
from repro_torch.tree import tree_map

from .base import Runtime

__all__ = ["ShardedRuntime", "node_leaf_spec", "node_specs"]


def node_leaf_spec(leaf, *, n: int, axis_name: str, lead: int = 0) -> tuple:
    """The layout rule in one place, in the form of a JAX partition spec:
    ``(None, ..., axis_name, None, ...)`` (the axis at dim ``lead``) for a
    node-stacked leaf, whose dim ``lead`` is the global node count ``n``;
    ``()`` (kept whole) for any other.  ``lead=1`` for a chunk's
    ``[k, n, ...]`` batches."""
    shape = getattr(leaf, "shape", None)
    if shape is not None and len(shape) > lead and shape[lead] == n:
        spec = [None] * len(shape)
        spec[lead] = axis_name
        return tuple(spec)
    return ()


def node_specs(tree, *, n: int, axis_name: str, lead: int = 0):
    """Per-leaf :func:`node_leaf_spec` tree."""
    return tree_map(lambda l: node_leaf_spec(l, n=n, axis_name=axis_name,
                                             lead=lead), tree)


@dataclasses.dataclass
class ShardedRuntime(Runtime):
    name: str = "sharded"

    def __post_init__(self):
        super().__post_init__()
        tr = self.trainer
        n = tr.topology.n
        if tr.mesh is None:
            raise ValueError(
                "runtime='sharded' needs a mesh whose node axis carries the "
                "n node index; pass DecentralizedTrainer(mesh=, node_axis=) "
                "or use runtime='vmap'")
        axes = dict(tr.mesh.shape)
        if axes.get(tr.node_axis) != n:
            raise ValueError(
                f"runtime='sharded': mesh axis {tr.node_axis!r} has size "
                f"{axes.get(tr.node_axis)}, topology has n={n}")
        self.mesh = tr.mesh
        self._b = 1
        # 'ring' (the two-neighbour special case) compiles to the same
        # rounds; forced 'dense' runs every site as an all-gather
        r = tr._resolved
        if r.kind == "sparse":
            self._schedule = r.schedule
        elif r.kind == "dense":
            self._schedule = None
        else:
            self._schedule = gossip.compile_gossip_schedule(tr.topology)

    @property
    def uses_host_t(self) -> bool:
        return self._schedule is not None and len(self._schedule.phases) > 1

    # -- the layout ----------------------------------------------------------
    def _cut(self, a, lead: int = 0):
        """This rank's rows of a node-stacked array or tensor (dim
        ``lead``), anything else whole."""
        if not node_leaf_spec(a, n=self.trainer.topology.n, axis_name="",
                              lead=lead):
            return a
        r0 = self.mesh.rank * self._b
        index = (slice(None),) * lead + (slice(r0, r0 + self._b),)
        return a[index]

    @staticmethod
    def _map_state(state, fn):
        """``fn`` on every leaf of the state's trees (the comm sites and the
        exchange buffers are lists of trees); the step counter kept."""
        trees = {f: tree_map(fn, getattr(state, f))
                 for f in ("params", "opt_state", "model_state")}
        for f in ("comm_state", "mix_buf"):
            if getattr(state, f) is not None:
                trees[f] = [tree_map(fn, site) for site in getattr(state, f)]
        return dataclasses.replace(state, **trees)

    def finalize_state(self, state):
        """A node-stacked state (a checkpoint's) cut to this rank's rows."""
        return self._map_state(state, lambda a: self._cut(a).clone())

    def gather_state(self, state):
        """The node-stacked ``[n, ...]`` state: every leaf of ``b`` rows
        gathered over the ranks (a collective: every rank calls it)."""
        def gather(a):
            if a.dim() >= 1 and a.shape[0] == self._b:
                return self.mesh.gather_nodes(a)
            return a

        return self._map_state(state, gather)

    def put_batch(self, batch, lead: int = 0):
        """This rank's rows of a host batch (the same in every process;
        node axis at ``lead``) onto the device, one copy an array."""
        dev = self.trainer.device
        return tuple(torch.from_numpy(np.ascontiguousarray(
            self._cut(a, lead))).to(dev) for a in batch)

    # -- node-axis hooks -----------------------------------------------------
    def _node_mean_scalar(self, x):
        # the per-node values gathered in node order: the vmap mean, bit
        # for bit
        return torch.mean(self.mesh.gather_nodes(x.reshape(-1)))

    def _node_sum_scalar(self, x):
        return self.mesh.all_reduce(x)

    def _node_max_scalar(self, x):
        return self.mesh.all_reduce(torch.max(x), "max")

    def _mix_impl(self, w, t, mix_mask=None):
        # always installed: the dense default would contract the local
        # leading axis (size 1), not the node axis
        if mix_mask is not None:
            raise ValueError(
                "scenario fault injection is not supported on "
                "runtime='sharded'; use runtime='hybrid' (one node per "
                "device is hybrid with n_devices == n) or 'vmap'")
        return gossip.make_local_mix_fn(self._schedule, mesh=self.mesh,
                                        w_ref=w, t=t)

    # -- evaluation -----------------------------------------------------------
    def eval_batch(self, state, eval_fn, batch) -> dict:
        """Each rank evaluates its nodes on the whole (shared) batch; the
        per-node sums are gathered to ``[n]`` in node order."""
        dev = self.trainer.device
        batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in batch)
        with torch.no_grad():
            res = eval_fn(state.params, state.model_state, batch)
        return {k: self.mesh.gather_nodes(v) for k, v in res.items()}

