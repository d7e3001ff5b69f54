"""DataSpec -> Task: dataset synthesis + Dirichlet client partition.

Port of ``repro/api/data.py``: ``dataset='classification'`` (synthetic
images, Dirichlet split over labels) and ``'lm_domains'`` (bigram token
streams, Dirichlet split over domains).  The batch streams, the eval split
and the metadata are bit-equal to the reference's for the same spec
(pinned in tests/test_torch_data.py and tests/test_torch_lm_train.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.data import (ClientDataset, dirichlet_partition,
                              heterogeneity_stats, make_classification,
                              make_lm_domains)

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


def _het(labels, parts) -> dict:
    het = heterogeneity_stats(labels, parts)
    return {"mean_tv": float(het["mean_tv"]),
            "min_client_size": int(min(het["sizes"])),
            "max_client_size": int(max(het["sizes"]))}


def build_task(spec, n_nodes: int) -> Task:
    d = spec.data
    seed = spec.seed if d.seed is None else d.seed
    if d.dataset == "lm_domains":
        return _lm_task(spec, n_nodes, seed)
    if d.dataset != "classification":
        raise ValueError(f"unknown dataset {d.dataset!r}")
    x, y = make_classification(n=d.n_data, hw=d.hw, n_classes=d.n_classes,
                               noise=d.noise, seed=seed)
    n_train = int(d.n_data * d.train_frac)
    x_tr, y_tr = x[:n_train], y[:n_train]
    x_te, y_te = x[n_train:], y[n_train:]
    parts = dirichlet_partition(y_tr, n_nodes, d.alpha, seed=seed,
                                min_per_client=d.min_per_client,
                                ensure_min=d.ensure_min)

    def make_iter():
        ds = ClientDataset((x_tr, y_tr), parts, batch=d.batch, seed=seed)
        return iter(lambda: ds.next_batch(), None)

    return Task(n_nodes=n_nodes, seed=seed, make_iter=make_iter,
                eval_batches=_eval_split((x_te, y_te), spec.eval.batch),
                d_in=int(np.prod(x.shape[1:])), n_classes=d.n_classes,
                meta={"n_train": n_train, "n_eval": len(y_te),
                      "heterogeneity": _het(y_tr, parts)})


def _lm_task(spec, n_nodes: int, seed: int) -> Task:
    """Token streams of ``n_domains`` bigram LMs (vocab from the model
    config unless ``data.vocab`` is set), split over the nodes by a
    Dirichlet partition over domains.  Batches are ``(tokens [n, B,
    S+1],)``; there is no eval set."""
    d = spec.data
    vocab = d.vocab
    if vocab == 0:
        from repro_torch.api.models import model_vocab
        vocab = model_vocab(spec)
    n_domains = d.n_domains or n_nodes
    n_seq = d.n_seq_per_domain or max(64, 16 * d.batch)
    tokens, domain = make_lm_domains(
        n_domains=n_domains, vocab=vocab, seq_len=d.seq_len,
        n_seq_per_domain=n_seq, seed=seed)
    parts = dirichlet_partition(domain, n_nodes, d.alpha, seed=seed,
                                min_per_client=d.min_per_client,
                                ensure_min=d.ensure_min)

    def make_iter():
        ds = ClientDataset((tokens,), parts, batch=d.batch, seed=seed)
        return iter(lambda: ds.next_batch(), None)

    return Task(n_nodes=n_nodes, seed=seed, make_iter=make_iter,
                meta={"vocab": vocab, "n_domains": n_domains,
                      "n_seq_per_domain": n_seq,
                      "heterogeneity": _het(domain, parts)})
