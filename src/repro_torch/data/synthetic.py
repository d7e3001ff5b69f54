"""Synthetic classification data and the per-node batch iterator.

Port of ``repro/data/synthetic.py`` (``make_classification``,
``ClientDataset``).  Plain numpy, copied so this package needs nothing of
the JAX one: the arrays and batch streams are bit-equal to the reference's
for the same seed (pinned in tests/test_torch_data.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["make_classification", "ClientDataset"]


def make_classification(
    n: int = 4096, *, n_classes: int = 10, hw: int = 32, channels: int = 3,
    noise: float = 0.6, seed: int = 0,
):
    """Images [n, hw, hw, c] float32 in ~N(0,1) scale, labels [n] int32."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, hw, hw, channels)).astype(np.float32)
    # low-frequency prototypes: smooth with a box filter so convs have
    # spatial structure to latch on to
    for _ in range(3):
        protos = (protos
                  + np.roll(protos, 1, axis=1) + np.roll(protos, -1, axis=1)
                  + np.roll(protos, 1, axis=2) + np.roll(protos, -1, axis=2)
                  ) / 5.0
    protos /= protos.std(axis=(1, 2, 3), keepdims=True)
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = protos[labels] + noise * rng.normal(
        size=(n, hw, hw, channels)).astype(np.float32)
    return x.astype(np.float32), labels


@dataclasses.dataclass
class ClientDataset:
    """Node-partitioned dataset with an infinite batch iterator that yields
    node-stacked batches [n_nodes, batch, ...]."""

    arrays: tuple[np.ndarray, ...]     # aligned arrays, e.g. (x, y)
    parts: list[np.ndarray]            # per-node index sets
    batch: int
    seed: int = 0

    def __post_init__(self):
        self._rngs = [np.random.default_rng(self.seed + 977 * i)
                      for i in range(len(self.parts))]
        self._order = [r.permutation(p) for r, p in zip(self._rngs, self.parts)]
        self._cursor = [0] * len(self.parts)

    @property
    def n_nodes(self) -> int:
        return len(self.parts)

    def next_batch(self) -> tuple[np.ndarray, ...]:
        """[n_nodes, batch, ...] per array; per-node sampling w/ reshuffle."""
        outs = [[] for _ in self.arrays]
        for i in range(self.n_nodes):
            take = []
            need = self.batch
            while need > 0:
                avail = len(self._order[i]) - self._cursor[i]
                if avail == 0:
                    self._order[i] = self._rngs[i].permutation(self.parts[i])
                    self._cursor[i] = 0
                    avail = len(self._order[i])
                k = min(need, avail)
                take.append(self._order[i][self._cursor[i]:self._cursor[i] + k])
                self._cursor[i] += k
                need -= k
            idx = np.concatenate(take)
            for a_i, arr in enumerate(self.arrays):
                outs[a_i].append(arr[idx])
        return tuple(np.stack(o) for o in outs)
