"""Communication topologies and doubly-stochastic mixing matrices.

Port of ``repro/core/topology.py`` for the ring (the main path).  Plain
numpy, copied so this package needs nothing of the JAX one: ``ring(n).w()``
is bit-equal to the reference's (pinned in tests/test_torch_data.py).  The
other registry names raise ``NotImplementedError`` naming the port slice
that brings them.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Topology", "ring", "spectral_gap", "is_doubly_stochastic",
           "get_topology"]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A (possibly time-varying) gossip topology.

    ``mixing`` is a ``[T, n, n]`` float64 stack of doubly-stochastic
    matrices (``T == 1`` when time-invariant); step ``t`` uses
    ``mixing[t % T]``.  ``neighbors`` lists the union graph's adjacency.
    """

    name: str
    n: int
    mixing: np.ndarray  # [T, n, n] float64
    neighbors: tuple[tuple[int, ...], ...]

    def w(self, t: int = 0) -> np.ndarray:
        return self.mixing[t % self.mixing.shape[0]]

    def spectral_gap(self) -> float:
        """``1 - lambda_2(E[W^T W])`` over the whole phase stack."""
        return spectral_gap(self.mixing)

    def validate(self, atol: float = 1e-10) -> None:
        for k in range(self.mixing.shape[0]):
            if not is_doubly_stochastic(self.mixing[k], atol=atol):
                raise ValueError(f"{self.name}: mixing[{k}] not doubly stochastic")


def is_doubly_stochastic(w: np.ndarray, atol: float = 1e-8) -> bool:
    n = w.shape[0]
    ones = np.ones(n)
    return (
        w.shape == (n, n)
        and bool(np.all(w >= -atol))
        and bool(np.allclose(w @ ones, ones, atol=atol))
        and bool(np.allclose(w.T @ ones, ones, atol=atol))
    )


def spectral_gap(w: np.ndarray) -> float:
    """rho = 1 - lambda_2(E[W^T W]) over a phase stack (Assumption 1.4).
    Accepts a single ``[n, n]`` matrix or a ``[T, n, n]`` stack."""
    w = np.asarray(w, dtype=np.float64)
    if w.ndim == 2:
        w = w[None]
    m = np.mean([wk.T @ wk for wk in w], axis=0)
    eig = np.sort(np.linalg.eigvalsh(m))[::-1]
    lam2 = eig[1] if len(eig) > 1 else 0.0
    return float(1.0 - min(max(lam2, 0.0), 1.0))


def _neighbors_from_adj(adj: np.ndarray) -> tuple[tuple[int, ...], ...]:
    return tuple(tuple(int(j) for j in np.nonzero(row)[0]) for row in adj)


def ring(n: int, *, self_weight: float | None = None, name: str = "ring") -> Topology:
    """Undirected ring; default uniform 1/3 weights (paper's choice for n>2)."""
    if n == 1:
        w = np.ones((1, 1, 1))
        return Topology(name, 1, w, ((),))
    adj = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        adj[i, (i - 1) % n] = 1
        adj[i, (i + 1) % n] = 1
    if n == 2:
        w = np.array([[[0.5, 0.5], [0.5, 0.5]]])
        return Topology(name, 2, w, _neighbors_from_adj(adj))
    if self_weight is None:
        self_weight = 1.0 / 3.0
    side = (1.0 - self_weight) / 2.0
    w = np.zeros((n, n))
    for i in range(n):
        w[i, i] = self_weight
        w[i, (i - 1) % n] = side
        w[i, (i + 1) % n] = side
    return Topology(name, n, w[None], _neighbors_from_adj(adj))


#: registry names of the reference, by the port slice that brings each
_LATER = {"complete": 2, "star": 2, "social": 2, "exp": 2, "torus": 2,
          "powerlaw": 8, "smallworld": 8}


def get_topology(name: str, n: int) -> Topology:
    """Registry accessor used by the spec layer.  Only ``'ring'`` is ported;
    the reference's other names raise ``NotImplementedError``."""
    kind = name.partition(":")[0]
    if name == "ring":
        return ring(n)
    if kind in _LATER:
        raise NotImplementedError(
            f"topology {name!r} is not ported yet: it comes with slice "
            f"{_LATER[kind]} of the port (repro_torch has 'ring')")
    raise ValueError(f"topology spec {name!r}: unknown topology {kind!r}; "
                     f"valid forms: 'ring'")
