"""Gossip averaging over a node-stacked tree (dense schedule).

Port of the dense schedule of ``repro/core/gossip.py``: ``mix_leaf_dense``,
``mix_dense``, ``node_mean``, ``consensus_distance`` and the scenario
engine's ``mask_renormalize``.  Every leaf carries
the node index as its leading axis ``[n, ...]``; mixing is the fp32
contraction ``W @ x`` over that axis, a plain matrix product left to
``torch.matmul`` as the reference leaves it to XLA.  The sparse ppermute
schedules come with slice 8b of the port.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["mix_leaf_dense", "mix_dense", "node_mean", "consensus_distance",
           "mask_renormalize"]


def mix_leaf_dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x[n, ...] -> (W @ x) with the contraction on the node axis.

    The contraction runs in (at least) fp32 whatever the leaf dtype: a bf16
    W leaves rows summing to 1 +- ~1e-2, a consensus drift that compounds
    over steps; in fp32 the row-sum error rounds away on the cast back.
    """
    flat = x.reshape(x.shape[0], -1)
    cdt = torch.promote_types(flat.dtype, torch.float32)
    out = torch.matmul(w.to(cdt), flat.to(cdt))
    return out.to(x.dtype).reshape(x.shape)


def mix_dense(w: torch.Tensor, tree):
    """Dense mixing of a node-stacked tree:
    leaf[n,...] <- sum_m W[n,m] leaf[m,...]."""
    return tree_map(lambda x: mix_leaf_dense(w, x), tree)


def node_mean(tree):
    """Average over the node axis, keepdims (broadcasts against [n, ...])."""
    return tree_map(lambda x: torch.mean(x, dim=0, keepdim=True), tree)


def consensus_distance(tree) -> torch.Tensor:
    """sqrt( mean_i || x_i - x_bar ||^2 / n ) aggregated over all leaves --
    the quantity plotted in Fig. 3.  A 0-d tensor on the leaves' device."""
    sq, cnt = 0.0, 0
    for leaf in tree_leaves(tree):
        mean = torch.mean(leaf, dim=0, keepdim=True)
        sq = sq + torch.sum((leaf - mean) ** 2) / leaf.shape[0]
        cnt += leaf[0].numel()
    return torch.sqrt(sq / cnt)


def mask_renormalize(w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Effective mixing matrix when only nodes with ``m_i = 1`` gossip, in
    ``w``'s dtype (fp32 on the step's device, as the reference computes it).

    Off-diagonal mass flows only over edges whose both endpoints are alive
    (``w_ij m_i m_j``); each alive node folds the mass of its dead
    neighbours back into its own diagonal (row sums stay 1), and a dead
    node keeps its state exactly (identity row).  For symmetric ``W`` the
    result is again symmetric, hence doubly stochastic on the alive
    subgraph."""
    m = m.to(w.dtype)
    eye = torch.eye(w.shape[0], dtype=w.dtype, device=w.device)
    offd = w * (m[:, None] * m[None, :]) * (1.0 - eye)
    diag = m * (1.0 - offd.sum(dim=1)) + (1.0 - m)
    return offd + eye * diag
