"""HybridRuntime: n nodes on d ranks, b = n / d a rank.

Port of ``repro/runtime/hybrid.py``.  The sharded backend puts one node on
a rank; a population of a thousand nodes has no such group.  This backend
keeps the sharded backend's structure (the whole step on this rank's
state, every metric reduced over the ranks) but each rank holds a
contiguous block of ``b = n / d`` nodes: node ``g`` at slot ``g % b`` of
rank ``g // b``.  Per-node work is the batched step of the vmap backend
over the local block.  The layout rule, state placement and evaluation are
the sharded backend's.  What changes:

* gossip runs the block-compiled schedule
  (``gossip.compile_block_schedule``): a round's edges grouped by rank
  offset into whole-block messages and per-slot gathers;
* under a scenario each rank draws only the masks of the nodes its block
  rounds read (``ScenarioContext.masks(t, ids=)``; every node when a phase
  is dense), and the mix executors read them through a
  :class:`~repro_torch.core.gossip.BlockMask`; the alive and mix fractions
  are exact sums of 0/1 values over the ranks, bit-equal to the vmap
  backend's.

With ``d = 1`` (one rank, as on one card) every sparse phase is local
gathers and the block rounds are the node rounds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import gossip
from repro_torch.tree import tree_flatten, tree_unflatten

from .base import Runtime
from .sharded import ShardedRuntime

__all__ = ["HybridRuntime"]


@dataclasses.dataclass
class HybridRuntime(ShardedRuntime):
    name: str = "hybrid"

    def __post_init__(self):
        Runtime.__post_init__(self)   # not ShardedRuntime's n == axis check
        tr = self.trainer
        n = tr.topology.n
        if tr.mesh is None:
            raise ValueError(
                "runtime='hybrid' needs a mesh whose node axis carries the "
                "device blocks; pass DecentralizedTrainer(mesh=, node_axis=)"
                " or use runtime='vmap'")
        d = dict(tr.mesh.shape).get(tr.node_axis)
        if not d or n % d:
            raise ValueError(
                f"runtime='hybrid': mesh axis {tr.node_axis!r} has size "
                f"{d}, which must divide the topology's n={n}")
        self.mesh = tr.mesh
        self._d, self._b = d, n // d
        # forced 'dense' keeps every site an all-gather contraction
        r = tr._resolved
        self._bsched = None
        if r.schedule is not None:
            self._bsched = gossip.compile_block_schedule(r.schedule, d)
        elif tr.gossip_schedule != "dense" and n > 1:
            self._bsched = gossip.compile_block_schedule(
                gossip.compile_gossip_schedule(tr.topology), d)
        self._plan = (None if self._bsched is None else
                      self._bsched.on_rank(self.mesh.rank, tr.device))
        self.mask_ids = None
        if tr.scenario is not None and not tr.scenario.trivial:
            self._mask_tables()

    @property
    def uses_host_t(self) -> bool:
        return self._plan is not None and len(self._plan.phases) > 1

    def _mask_tables(self) -> None:
        """The node ids this rank draws masks for (its block and every
        source its block rounds read; all n when a phase is dense), with
        device tables from a node id and from the block's slots to their
        position in the draw."""
        n, b, r = self.trainer.topology.n, self._b, self.mesh.rank
        own = np.arange(r * b, (r + 1) * b)
        if self._bsched is None or any(p.dense for p in
                                       self._bsched.phases):
            ids = np.arange(n)
        else:
            peers = [g.src_node[r] for p in self._bsched.phases
                     for rnd in p.rounds for g in rnd.groups]
            ids = np.unique(np.concatenate([own, *peers]))
        pos = np.full(n, -1, np.int64)
        pos[ids] = np.arange(len(ids))
        dev = self.trainer.device
        self.mask_ids = ids
        self._all_ids = len(ids) == n
        self._mask_pos = torch.as_tensor(pos, device=dev)
        self._own_pos = torch.as_tensor(pos[own], device=dev)

    # -- node-axis hooks -----------------------------------------------------
    def _local_update_mask(self, u):
        """The block's rows of an update mask drawn over ``mask_ids``."""
        return u.index_select(0, self._own_pos)

    def _scenario_masks(self, masks):
        """This round's masks over ``mask_ids`` (``[2, len(mask_ids)]``):
        the update mask of the block, a :class:`BlockMask` of the mix mask,
        and the fractions, exact sums over the ranks times 1/n."""
        n = self.trainer.topology.n
        u_ids, m_ids = masks[0], masks[1]
        u_loc = self._local_update_mask(u_ids)
        m_loc = m_ids.index_select(0, self._own_pos)
        sums = self.mesh.all_reduce(torch.stack([torch.sum(u_loc),
                                                 torch.sum(m_loc)]))
        pos = self._mask_pos

        def full():
            if not self._all_ids:
                raise RuntimeError("a dense phase needs every node's mask")
            return m_ids

        mask = gossip.BlockMask(
            local=m_loc, of=lambda ids: m_ids.index_select(
                0, pos.index_select(0, ids)), full=full)
        return u_loc, mask, (sums[0] * (1.0 / n), sums[1] * (1.0 / n))

    def _mix_impl(self, w, t, mix_mask=None):
        return gossip.make_block_mix_fn(
            self._plan, mesh=self.mesh, w_ref=w, t=t, d=self._d, b=self._b,
            mask=mix_mask)

    def _post_mix(self, tree, w, t):
        """Post the block schedule's messages for every leaf of ``tree``
        now; the returned ``finish()`` waits for them and sums."""
        if self._plan is None:
            return super()._post_mix(tree, w, t)
        leaves, treedef = tree_flatten(tree)
        finish = gossip.post_block_mix(leaves, self._plan, t,
                                       mesh=self.mesh)
        return lambda: tree_unflatten(treedef, finish())
