"""DataSpec -> Task: dataset synthesis + Dirichlet client partition.

Port of ``repro/api/data.py`` for ``dataset='classification'``: the batch
stream and the eval split are bit-equal to the reference's for the same
spec (pinned in tests/test_torch_data.py).  ``'lm_domains'`` comes with
slice 6 of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.data import (ClientDataset, dirichlet_partition,
                              heterogeneity_stats, make_classification)

__all__ = ["Task", "build_task"]


@dataclasses.dataclass(frozen=True)
class Task:
    """Built data for one experiment: a fresh-iterator factory of host
    (numpy) node-stacked batches, the eval batches, and model metadata."""

    n_nodes: int
    seed: int
    make_iter: Callable                 # () -> infinite node-stacked batches
    eval_batches: tuple = ()            # batches for the eval protocol
    d_in: Optional[int] = None          # flattened input dim
    n_classes: Optional[int] = None
    meta: dict = dataclasses.field(default_factory=dict)


def _eval_split(arrays: tuple, batch: int) -> tuple:
    """Whole set as one batch (batch=0) or fixed-size chunks."""
    n = len(arrays[0])
    if not n:
        return ()
    if batch <= 0 or batch >= n:
        return (arrays,)
    return tuple(tuple(a[i:i + batch] for a in arrays)
                 for i in range(0, n, batch))


def build_task(spec, n_nodes: int) -> Task:
    d = spec.data
    seed = spec.seed if d.seed is None else d.seed
    if d.dataset != "classification":
        raise NotImplementedError(
            f"dataset {d.dataset!r} is not ported yet (slice 6 brings "
            "'lm_domains'); repro_torch has 'classification'")
    x, y = make_classification(n=d.n_data, hw=d.hw, n_classes=d.n_classes,
                               noise=d.noise, seed=seed)
    n_train = int(d.n_data * d.train_frac)
    x_tr, y_tr = x[:n_train], y[:n_train]
    x_te, y_te = x[n_train:], y[n_train:]
    parts = dirichlet_partition(y_tr, n_nodes, d.alpha, seed=seed,
                                min_per_client=d.min_per_client,
                                ensure_min=d.ensure_min)
    het = heterogeneity_stats(y_tr, parts)

    def make_iter():
        ds = ClientDataset((x_tr, y_tr), parts, batch=d.batch, seed=seed)
        return iter(lambda: ds.next_batch(), None)

    return Task(n_nodes=n_nodes, seed=seed, make_iter=make_iter,
                eval_batches=_eval_split((x_te, y_te), spec.eval.batch),
                d_in=int(np.prod(x.shape[1:])), n_classes=d.n_classes,
                meta={"n_train": n_train, "n_eval": len(y_te),
                      "heterogeneity": {
                          "mean_tv": float(het["mean_tv"]),
                          "min_client_size": int(min(het["sizes"])),
                          "max_client_size": int(max(het["sizes"]))}})
