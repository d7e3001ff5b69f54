"""Synthetic datasets and the per-node batch iterator.

Port of ``repro/data/synthetic.py``:

* ``make_classification`` -- CIFAR-shaped class-conditional image data;
* ``make_lm_domains`` -- token streams from ``n_domains`` distinct bigram
  generators; decentralized heterogeneity is a Dirichlet mixture over
  domains per node (the LM analogue of label skew);
* ``ClientDataset`` / ``iterate_client_batches`` -- the per-node epoch
  iterator over a partition.

Plain numpy, copied so this package needs nothing of the JAX one: the
arrays and batch streams are bit-equal to the reference's for the same
seed (pinned in tests/test_torch_data.py and tests/test_torch_lm_train.py).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["make_classification", "make_lm_domains", "iterate_client_batches",
           "ClientDataset"]


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


def make_lm_domains(
    n_domains: int = 8, *, vocab: int = 512, seq_len: int = 128,
    n_seq_per_domain: int = 256, skew: float = 8.0, seed: int = 0,
):
    """Per-domain bigram LMs -> (tokens [D*ns, S+1] int32, domain [D*ns]).

    Tokens include one extra position so callers can split inputs/labels.
    Each domain draws a ``vocab x vocab`` Dirichlet transition matrix in
    float64 (0.5 GB at vocab 8192): the stream is the reference's, draw for
    draw, so the algorithm stays as it is."""
    rng = np.random.default_rng(seed)
    all_tokens, all_domain = [], []
    for d in range(n_domains):
        # sparse random bigram transition per domain
        trans = rng.dirichlet(np.full(vocab, 1.0 / skew), size=vocab)
        cum = np.cumsum(trans, axis=1)
        del trans
        toks = np.empty((n_seq_per_domain, seq_len + 1), np.int32)
        cur = rng.integers(0, vocab, size=n_seq_per_domain)
        toks[:, 0] = cur
        u = rng.random(size=(n_seq_per_domain, seq_len))
        for t in range(seq_len):
            cur = (cum[cur] < u[:, t:t + 1]).sum(axis=1)
            cur = np.minimum(cur, vocab - 1)
            toks[:, t + 1] = cur
        all_tokens.append(toks)
        all_domain.append(np.full(n_seq_per_domain, d, np.int32))
    return np.concatenate(all_tokens), np.concatenate(all_domain)


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


def iterate_client_batches(ds: ClientDataset, steps: int
                           ) -> Iterator[tuple[np.ndarray, ...]]:
    for _ in range(steps):
        yield ds.next_batch()
