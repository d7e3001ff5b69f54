"""Generated gossip graphs for thousand-node scenarios.

Port of ``repro/scenario/graphs.py``, plain numpy, so every graph's
mixing matrix is bit-equal to the reference's (pinned in
tests/test_torch_scenario.py):

* :func:`powerlaw`: a Chung-Lu graph whose expected degrees follow
  ``deg_i ∝ (i + i0)^(-1/(gamma-1))``, overlaid on a ring so that it is
  always connected;
* :func:`smallworld`: Watts-Strogatz, a ring lattice where every node
  links its ``k`` nearest neighbours and each edge rewires to a uniform
  random endpoint with probability ``p``.

Both return :class:`~repro_torch.core.topology.Topology` objects with
Metropolis-Hastings weights and are deterministic under ``seed``.
``core/topology.get_topology`` takes them as ``powerlaw`` /
``powerlaw:2.5`` and ``smallworld`` / ``smallworld:0.1``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.topology import (Topology, _neighbors_from_adj,
                                       metropolis_weights)

__all__ = ["powerlaw", "smallworld"]


def _ring_adj(n: int) -> np.ndarray:
    adj = np.zeros((n, n), dtype=np.int64)
    idx = np.arange(n)
    adj[idx, (idx - 1) % n] = 1
    adj[idx, (idx + 1) % n] = 1
    return adj


def powerlaw(n: int, gamma: float = 2.5, *, seed: int = 0,
             mean_degree: float = 4.0) -> Topology:
    """Chung-Lu power-law graph with exponent ``gamma`` + ring backbone.

    Expected degrees are scaled to ``mean_degree`` and capped so that no
    edge probability ``w_i w_j / sum(w)`` exceeds 1."""
    if n < 2:
        return Topology(f"powerlaw{n}", 1, np.ones((1, 1, 1)), ((),))
    if gamma <= 1.0:
        raise ValueError(f"powerlaw exponent must be > 1, got {gamma}")
    rng = np.random.default_rng((seed, n, int(gamma * 1e6)))
    i0 = max(1.0, n ** (1.0 / (gamma - 1.0)) / 10.0)
    wts = (np.arange(n) + i0) ** (-1.0 / (gamma - 1.0))
    wts = wts * (mean_degree * n / wts.sum())
    # cap so p_ij = w_i w_j / S stays a probability
    s = wts.sum()
    wts = np.minimum(wts, np.sqrt(s))
    p = np.clip(np.outer(wts, wts) / s, 0.0, 1.0)
    np.fill_diagonal(p, 0.0)
    upper = np.triu(rng.random((n, n)) < p, k=1)
    adj = (upper | upper.T).astype(np.int64) | _ring_adj(n)
    w = metropolis_weights(adj)
    return Topology(f"powerlaw{n}_g{gamma:g}", n, w[None],
                    _neighbors_from_adj(adj))


def smallworld(n: int, p: float = 0.1, *, k: int = 4,
               seed: int = 0) -> Topology:
    """Watts-Strogatz small-world graph: a ring lattice of degree ``k`` with
    each edge rewired to a random endpoint with probability ``p``.  The
    rewired edge keeps its source endpoint, and a node left with no edge is
    linked to its ring successor."""
    if n < 2:
        return Topology(f"smallworld{n}", 1, np.ones((1, 1, 1)), ((),))
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"smallworld rewiring probability must be in "
                         f"[0, 1], got {p}")
    k = max(2, min(int(k), n - 1))
    if k % 2:
        k -= 1 if k > 2 else 0
    rng = np.random.default_rng((seed, n, k, int(p * 1e6)))
    adj = np.zeros((n, n), dtype=np.int64)
    for off in range(1, k // 2 + 1):
        idx = np.arange(n)
        adj[idx, (idx + off) % n] = 1
        adj[(idx + off) % n, idx] = 1
    # rewire each lattice edge (i, i+off) with probability p
    for i in range(n):
        for off in range(1, k // 2 + 1):
            j = (i + off) % n
            if adj[i, j] and rng.random() < p:
                choices = np.nonzero(
                    (adj[i] == 0) & (np.arange(n) != i))[0]
                if len(choices):
                    new_j = int(rng.choice(choices))
                    adj[i, j] = adj[j, i] = 0
                    adj[i, new_j] = adj[new_j, i] = 1
    deg = adj.sum(axis=1)
    for i in np.nonzero(deg == 0)[0]:
        j = (int(i) + 1) % n
        adj[i, j] = adj[j, i] = 1
    w = metropolis_weights(adj)
    return Topology(f"smallworld{n}_p{p:g}", n, w[None],
                    _neighbors_from_adj(adj))
