"""Communication topologies and doubly-stochastic mixing matrices.

Port of ``repro/core/topology.py``: the ring (n=16), the Davis "Southern
Women" social network (n=32), the 1-peer directed exponential graph
(time-varying), the complete graph, torus and star, each with its
doubly-stochastic mixing stack (Metropolis-Hastings weights for the
undirected graphs).  Plain numpy, copied so this package needs nothing of
the JAX one: every registry topology's ``mixing`` is bit-equal to the
reference's (pinned in tests/test_torch_topology.py).  The generated graphs
``powerlaw`` and ``smallworld`` live in ``repro_torch/scenario/graphs.py``,
as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Topology", "ring", "torus", "star", "complete", "social_network",
    "one_peer_exponential", "metropolis_weights", "spectral_gap",
    "is_doubly_stochastic", "TOPOLOGIES", "get_topology",
]


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

    @property
    def time_varying(self) -> bool:
        return self.mixing.shape[0] > 1

    def w(self, t: int = 0) -> np.ndarray:
        return self.mixing[t % self.mixing.shape[0]]

    @property
    def max_degree(self) -> int:
        return max(len(nb) for nb in self.neighbors)

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


def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings doubly-stochastic weights from a 0/1 adjacency."""
    adj = np.asarray(adj)
    deg = adj.sum(axis=1)
    off = np.where(adj != 0,
                   1.0 / (1.0 + np.maximum(deg[:, None], deg[None, :])),
                   0.0)
    np.fill_diagonal(off, 0.0)
    return off + np.diag(1.0 - off.sum(axis=1))


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


def torus(rows: int, cols: int) -> Topology:
    """2D torus with Metropolis weights (App. D.1)."""
    n = rows * cols
    adj = np.zeros((n, n), dtype=np.int64)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                if j != i:
                    adj[i, j] = 1
    w = metropolis_weights(adj)
    return Topology(f"torus{rows}x{cols}", n, w[None], _neighbors_from_adj(adj))


def star(n: int) -> Topology:
    adj = np.zeros((n, n), dtype=np.int64)
    adj[0, 1:] = 1
    adj[1:, 0] = 1
    w = metropolis_weights(adj)
    return Topology(f"star{n}", n, w[None], _neighbors_from_adj(adj))


def complete(n: int) -> Topology:
    w = np.full((n, n), 1.0 / n)
    adj = 1 - np.eye(n, dtype=np.int64)
    return Topology(f"complete{n}", n, w[None], _neighbors_from_adj(adj))


#: Davis, Gardner & Gardner (1941), Table 1: which of 14 events each of 18
#: women attended.  The paper's Social Network is the bipartite graph itself
#: (18 + 14 = 32 nodes), hard-coded so no networkx is needed.
_DAVIS_ATTENDANCE = np.array(
    # events:1  2  3  4  5  6  7  8  9 10 11 12 13 14
    [
        [1, 1, 1, 1, 1, 1, 0, 1, 1, 0, 0, 0, 0, 0],  # Evelyn
        [1, 1, 1, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0],  # Laura
        [0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],  # Theresa
        [1, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0],  # Brenda
        [0, 0, 1, 1, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0],  # Charlotte
        [0, 0, 1, 0, 1, 1, 0, 1, 0, 0, 0, 0, 0, 0],  # Frances
        [0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0],  # Eleanor
        [0, 0, 0, 0, 0, 1, 0, 1, 1, 0, 0, 0, 0, 0],  # Pearl
        [0, 0, 0, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 0],  # Ruth
        [0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0],  # Verne
        [0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0],  # Myra
        [0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1],  # Katherine
        [0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 1, 1, 1],  # Sylvia
        [0, 0, 0, 0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1],  # Nora
        [0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 0],  # Helen
        [0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0],  # Dorothy
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0],  # Olivia
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0],  # Flora
    ],
    dtype=np.int64,
)


def social_network() -> Topology:
    """Davis Southern Women bipartite social graph: 18 women + 14 events = 32
    nodes (the paper's Social Network, n=32).  Metropolis weights."""
    a = _DAVIS_ATTENDANCE
    n_w, n_e = a.shape
    n = n_w + n_e
    adj = np.zeros((n, n), dtype=np.int64)
    adj[:n_w, n_w:] = a
    adj[n_w:, :n_w] = a.T
    w = metropolis_weights(adj)
    return Topology("social32", n, w[None], _neighbors_from_adj(adj))


def one_peer_exponential(n: int) -> Topology:
    """1-peer directed exponential graph (Assran et al. 2019): time-varying,
    at phase k each node i sends to (i + 2^k) mod n and averages with weight
    1/2.  Each phase matrix is doubly stochastic (a permutation average).
    ``neighbors`` is the symmetric closure of the union graph (send and
    receive edges)."""
    if n & (n - 1):
        raise ValueError("one_peer_exponential requires power-of-two n")
    phases = int(np.log2(n))
    mats = []
    adj = np.zeros((n, n), dtype=np.int64)
    for k in range(phases):
        off = 2**k
        w = np.zeros((n, n))
        for i in range(n):
            w[i, i] = 0.5
            w[(i + off) % n, i] = 0.5  # column i: node i's mass goes to i and i+off
            adj[i, (i + off) % n] = 1  # send edge
            adj[(i + off) % n, i] = 1  # recv edge (symmetric closure)
        mats.append(w)
    return Topology(f"exp{n}", n, np.stack(mats), _neighbors_from_adj(adj))


def _torus_for(n: int) -> Topology:
    r = int(np.sqrt(n))
    while n % r:
        r -= 1
    return torus(r, n // r)


def _social_for(n: int) -> Topology:
    topo = social_network()
    if n not in (0, topo.n):
        raise ValueError(f"social topology has fixed n=32, got {n}")
    return topo


def _powerlaw_for(n: int, param: float | None) -> Topology:
    from repro_torch.scenario.graphs import powerlaw  # core <-> scenario
    return powerlaw(n, param if param is not None else 2.5)


def _smallworld_for(n: int, param: float | None) -> Topology:
    from repro_torch.scenario.graphs import smallworld
    return smallworld(n, param if param is not None else 0.1)


#: name -> (builder(n, param), takes_param), the reference's registry.
#: Builders without a parameter reject ``name:param`` forms;
#: parameterized ones default when bare.
TOPOLOGIES: dict = {
    "ring": (lambda n, _p: ring(n), False),
    "complete": (lambda n, _p: complete(n), False),
    "star": (lambda n, _p: star(n), False),
    "social": (lambda n, _p: _social_for(n), False),
    "exp": (lambda n, _p: one_peer_exponential(n), False),
    "torus": (lambda n, _p: _torus_for(n), False),
    "powerlaw": (_powerlaw_for, True),      # param = degree exponent gamma
    "smallworld": (_smallworld_for, True),  # param = rewiring probability
}


def get_topology(name: str, n: int) -> Topology:
    """Registry accessor used by the spec layer.  Accepts ``name:param``
    forms for the parameterized generated graphs (``powerlaw:2.5``,
    ``smallworld:0.1``); unknown names raise ``ValueError`` listing every
    valid form, with the reference's texts."""
    kind, sep, arg = name.partition(":")

    def bad(why: str):
        forms = ", ".join(
            f"'{k}:<param>'" if takes else f"'{k}'"
            for k, (_, takes) in sorted(TOPOLOGIES.items()))
        raise ValueError(f"topology spec {name!r}: {why}; valid forms: "
                         f"{forms}")

    if kind not in TOPOLOGIES:
        bad(f"unknown topology {kind!r}")
    builder, takes_param = TOPOLOGIES[kind]
    param = None
    if sep:
        if not takes_param:
            bad(f"{kind!r} takes no parameter")
        try:
            param = float(arg)
        except ValueError:
            bad(f"parameter {arg!r} is not a number")
    return builder(n, param)
