"""Thousand-node scenario engine.

Port of ``repro/scenario``:

* :mod:`~repro_torch.scenario.graphs`: generated power-law / small-world
  gossip graphs with Metropolis weights (``get_topology('powerlaw:2.5',
  n)``);
* :mod:`~repro_torch.scenario.sampling`: per-round client sampling;
* :mod:`~repro_torch.scenario.faults`: churn (windowed dropout) and
  stragglers, with the mixing renormalized onto the alive subgraph;
* :class:`ScenarioContext`: the resolved per-run object the runtime
  consults: ``masks(t)`` returns the round's ``(update_mask, mix_mask)``
  pair, pure functions of ``(seed, t)``.

The masks are drawn on the host with numpy (bit-equal to the reference's
``jax.random`` draws), a chunk of steps in one vectorised call, and reach
the device with the chunk's batches: a step reads nothing back to the
host.  The scenario runs on the vmap runtime with dense masked gossip
and on the hybrid runtime, whose ranks draw only the nodes their block
rounds read (``ids=``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import faults, graphs, sampling
from .faults import churn_mask, effective_mixing, straggler_mask
from .graphs import powerlaw, smallworld
from .sampling import participation_mask

__all__ = [
    "ScenarioContext",
    "faults", "graphs", "sampling",
    "churn_mask", "straggler_mask", "effective_mixing",
    "participation_mask", "powerlaw", "smallworld",
]


@dataclasses.dataclass(frozen=True)
class ScenarioContext:
    """Resolved participation/fault model for one run.

    ``masks(t)`` -> ``(update_mask, mix_mask)``, float32 ``[n]`` numpy
    arrays (``[len(t), n]`` for an array of steps):

    * ``update_mask``: 1 where the node computes and applies its local
      update this round (sampled and not dropped by churn).  Nodes at 0
      hold params and optimizer state exactly.
    * ``mix_mask``: 1 where the node takes part in this round's gossip:
      ``update_mask`` minus stragglers.  The mix renormalizes the mixing
      matrix onto this alive subgraph (``gossip.mask_renormalize``).
    """

    n: int
    seed: int = 0
    participation: float = 1.0
    dropout: float = 0.0
    churn_window: int = 1
    straggler: float = 0.0

    @property
    def trivial(self) -> bool:
        """True when every mask is all ones (no fault configured): the
        runtime then skips masking, and the step is the no-scenario step."""
        return (self.participation >= 1.0 and self.dropout <= 0.0
                and self.straggler <= 0.0)

    def masks(self, t, ids=None):
        """Masks for round ``t`` (an int, or an array of steps): the full
        ``[n]`` pair, or, with ``ids``, those nodes' entries only.  Node
        ``g``'s draw is the same either way."""
        key = sampling.prng_key(self.seed)
        shape = np.shape(t) + ((self.n,) if ids is None else np.shape(ids))
        u = np.ones(shape, np.float32)
        if self.participation < 1.0:
            u = u * sampling.participation_mask(key, t, self.n,
                                                self.participation, ids=ids)
        if self.dropout > 0.0:
            u = u * faults.churn_mask(key, t, self.n, self.dropout,
                                      self.churn_window, ids=ids)
        m = u
        if self.straggler > 0.0:
            m = m * (np.float32(1.0) - faults.straggler_mask(
                key, t, self.n, self.straggler, ids=ids))
        return u, m

    def stacked_masks(self, t, ids=None) -> np.ndarray:
        """``masks(t, ids)`` as one float32 array ``[..., 2, n]`` (update
        mask, then mix mask; ``[..., 2, len(ids)]`` with ``ids``): what the
        training loops copy to the device with a chunk's batches."""
        u, m = self.masks(t, ids=ids)
        return np.stack((u, m), axis=-2)
