"""Fault injection for scenario runs: churn (correlated dropout) and
straggler delay.

Port of ``repro/scenario/faults.py``.  Semantics:

* a **dropped** node neither computes an update nor gossips this round: it
  holds params and momentum exactly and its mixing row becomes the
  identity;
* a **straggler** computes its local update but misses this round's gossip
  (nobody reads it, it reads nobody);
* alive nodes renormalize their mixing weights onto the alive subgraph
  (``gossip.mask_renormalize``): dead-neighbour mass folds back into the
  diagonal, so the effective matrix stays doubly stochastic for symmetric
  ``W``.

Like :mod:`~repro_torch.scenario.sampling`, every mask is a pure function
of ``(scenario seed, step, node id)``, drawn on the host with numpy and
bit-equal to the reference's, for any node-id subset (``ids=``) and for an
array of steps at once.  Churn redraws the alive set once per ``window``
steps (``t // window``), so outages persist.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import gossip

from .sampling import per_node_bernoulli, round_key

__all__ = ["churn_mask", "straggler_mask", "effective_mixing"]

_TAG_CHURN = 0xC4A2
_TAG_STRAG = 0x57A6


def churn_mask(key: np.ndarray, t, n: int, dropout: float,
               window: int = 1, ids=None) -> np.ndarray:
    """Float mask (``[n]``, or ``ids``' shape; ``[len(t), ...]`` for an
    array of steps), 1 = node alive during the window containing ``t``.
    Each node drops with probability ``dropout`` per window."""
    epoch = np.asarray(t, np.int32) // np.int32(max(1, int(window)))
    if ids is None:
        ids = np.arange(n)
    return np.float32(1.0) - per_node_bernoulli(
        round_key(key, _TAG_CHURN, epoch), np.asarray(ids), dropout)


def straggler_mask(key: np.ndarray, t, n: int, prob: float,
                   ids=None) -> np.ndarray:
    """Float mask (``[n]``, or ``ids``' shape; ``[len(t), ...]`` for an
    array of steps), 1 = node straggles in round ``t``: its gossip misses
    the round, its local step still happens.  Redrawn per round."""
    if ids is None:
        ids = np.arange(n)
    return per_node_bernoulli(round_key(key, _TAG_STRAG, t),
                              np.asarray(ids), prob)


def effective_mixing(w: np.ndarray, m: np.ndarray) -> np.ndarray:
    """The effective mixing matrix under mix-mask ``m``, in float64 on the
    host: the matrix the masked gossip implements, for validation
    (``Topology.spectral_gap`` of it measures the alive subgraph's
    connectivity)."""
    return gossip.mask_renormalize(
        torch.from_numpy(np.asarray(w, np.float64)),
        torch.from_numpy(np.asarray(m, np.float64))).numpy()
