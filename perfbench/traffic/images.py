"""CIFAR-shaped image batches over a Dirichlet label split.

The generator of the ``generator: images`` traffic mixes. A frozen copy of
``repro_torch/data/synthetic.py::make_classification`` (class prototypes,
box-smoothed three times, plus Gaussian noise) and of the Dirichlet split of
``repro_torch/data/partition.py::dirichlet_partition`` (per class, a
Dir(alpha) draw over the nodes, over-full nodes zeroed), so that the
traffic stays what it is whatever the program's data code becomes. The
split tops up nodes below ``3 * batch`` images from the largest ones, so
that the first three steps read rows that all differ.

Mix parameters: ``nodes``, ``batch`` (images a node a step), ``alpha``,
``pool`` (images drawn), ``noise``, ``distinct_batches`` (batches made at
set-up and cycled through in the window). The configuration gives
``image_hw``, ``channels`` and ``classes``.
"""
from __future__ import annotations

import numpy as np


def make_classification(n: int, *, n_classes: int, hw: int, channels: int,
                        noise: float, rng: np.random.Generator):
    """Images [n, hw, hw, c] float32, labels [n] int32."""
    protos = rng.normal(size=(n_classes, hw, hw, channels)).astype(np.float32)
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


def dirichlet_split(labels: np.ndarray, nodes: int, alpha: float,
                    min_per_node: int, rng: np.random.Generator):
    """Disjoint index arrays, one a node, each of at least
    ``min_per_node``."""
    n_classes = int(labels.max()) + 1
    counts = np.zeros(nodes, dtype=np.int64)
    parts: list[list[np.ndarray]] = [[] for _ in range(nodes)]
    for c in range(n_classes):
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(nodes, alpha))
        props = props * (counts < len(labels) / nodes)
        props = (props / props.sum() if props.sum() > 0
                 else np.full(nodes, 1.0 / nodes))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for i, chunk in enumerate(np.split(idx, cuts)):
            parts[i].append(chunk)
            counts[i] += len(chunk)
    out = [np.concatenate(p) for p in parts]
    if sum(len(o) for o in out) < nodes * min_per_node:
        raise ValueError(f"images: {len(labels)} images cannot give "
                         f"{nodes} nodes {min_per_node} each")
    for i in range(nodes):
        while len(out[i]) < min_per_node:
            donor = int(np.argmax([len(o) for o in out]))
            take = min(len(out[donor]) - min_per_node,
                       min_per_node - len(out[i]))
            out[i] = np.concatenate([out[i], out[donor][-take:]])
            out[donor] = out[donor][:-take]
    return out


def batches(mix: dict, config: dict, seed: int) -> list[tuple]:
    """``mix['distinct_batches']`` host batches ``(x [n, B, hw, hw, c]
    float32, y [n, B] int32)``, made from ``seed``."""
    rng = np.random.default_rng(seed)
    nodes, b = int(mix["nodes"]), int(mix["batch"])
    x, y = make_classification(
        int(mix["pool"]), n_classes=int(config["classes"]),
        hw=int(config["image_hw"]), channels=int(config["channels"]),
        noise=float(mix["noise"]), rng=rng)
    parts = dirichlet_split(y, nodes, float(mix["alpha"]), 3 * b, rng)
    order = [rng.permutation(p) for p in parts]
    cursor = [0] * nodes
    out = []
    for _ in range(int(mix["distinct_batches"])):
        idx = []
        for i in range(nodes):
            if cursor[i] + b > len(order[i]):
                order[i], cursor[i] = rng.permutation(parts[i]), 0
            idx.append(order[i][cursor[i]:cursor[i] + b])
            cursor[i] += b
        idx = np.stack(idx)
        out.append((x[idx], y[idx]))
    return out
