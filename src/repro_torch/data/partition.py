"""Dirichlet non-i.i.d. client partitioning (paper App. A.2).

Port of ``repro/data/partition.py``.  Plain numpy, copied so this package
needs nothing of the JAX one; the partitions are bit-equal to the
reference's for the same seed (pinned in tests/test_torch_data.py).

Each client's class distribution q_i ~ Dir(alpha * p) with prior p uniform.
The partition is disjoint and fixed for the whole run.
"""
from __future__ import annotations

import numpy as np

__all__ = ["dirichlet_partition", "heterogeneity_stats"]


def dirichlet_partition(
    labels: np.ndarray,
    n_clients: int,
    alpha: float,
    *,
    seed: int = 0,
    min_per_client: int = 2,
    max_retries: int = 100,
    ensure_min: str = "retry",
) -> list[np.ndarray]:
    """Return a list of disjoint index arrays, one per client.

    For each class, split its sample indices among clients proportionally
    to a Dir(alpha) draw.  Draws are rejected until every client holds
    ``min_per_client`` samples; each retry is reseeded
    (``default_rng((seed, attempt))``), and after ``max_retries`` failures a
    ``ValueError`` reports the best minimum achieved.
    ``ensure_min='redistribute'`` keeps the first draw and tops up
    under-full clients from the largest ones, deterministically.
    """
    if ensure_min not in ("retry", "redistribute"):
        raise ValueError(f"ensure_min must be 'retry' | 'redistribute', "
                         f"got {ensure_min!r}")
    if n_clients * min_per_client > len(labels):
        raise ValueError(
            f"min_per_client={min_per_client} unsatisfiable: {n_clients} "
            f"clients need {n_clients * min_per_client} samples, have "
            f"{len(labels)}")
    n_classes = int(labels.max()) + 1
    best_min = -1
    for attempt in range(max_retries):
        # the rng call order (per-class shuffles, then one dirichlet per
        # class) is the only stream consumer; the rest is bookkeeping
        rng = np.random.default_rng(seed if attempt == 0 else (seed, attempt))
        idx_by_class = [np.nonzero(labels == c)[0] for c in range(n_classes)]
        for idx in idx_by_class:
            rng.shuffle(idx)
        counts = np.zeros(n_clients, dtype=np.int64)
        owner_parts: list[np.ndarray] = []   # per class: owner of each sample
        for c in range(n_classes):
            props = rng.dirichlet(np.full(n_clients, alpha))
            # balance: zero out clients already over-full (standard trick)
            props = props * (counts < len(labels) / n_clients)
            s = props.sum()
            if s <= 0:
                props = np.full(n_clients, 1.0 / n_clients)
            else:
                props = props / s
            n_c = len(idx_by_class[c])
            cuts = (np.cumsum(props) * n_c).astype(int)[:-1]
            bounds = np.concatenate(([0], cuts, [n_c]))
            sizes_c = np.maximum(np.diff(bounds), 0)
            owner_parts.append(np.repeat(np.arange(n_clients), sizes_c))
            counts += sizes_c
        best_min = max(best_min, int(counts.min()))
        if counts.min() >= min_per_client or ensure_min == "redistribute":
            owners = np.concatenate(owner_parts)
            samples = np.concatenate(idx_by_class)
            order = np.lexsort((samples, owners))  # by client, then index
            out = list(np.split(samples[order].astype(np.int64),
                                np.cumsum(counts)[:-1]))
            if counts.min() < min_per_client:
                _redistribute_min(out, min_per_client)
                out = [np.sort(o) for o in out]
            if sum(len(o) for o in out) != len(labels):
                raise RuntimeError("dirichlet_partition lost samples")
            return out
    raise ValueError(
        f"dirichlet_partition: could not give every client "
        f">= {min_per_client} samples in {max_retries} attempts "
        f"(best achieved minimum: {best_min}); relax min_per_client, raise "
        f"alpha, or use fewer clients")


def _redistribute_min(parts: list[np.ndarray], min_per_client: int) -> None:
    """Deterministic top-up (in place): every client below ``min_per_client``
    takes trailing samples from the currently largest client."""
    sizes = np.array([len(p) for p in parts])
    for i in np.nonzero(sizes < min_per_client)[0]:
        while sizes[i] < min_per_client:
            donor = int(np.argmax(sizes))
            if sizes[donor] <= min_per_client:
                raise ValueError(
                    f"redistribute: not enough samples to give every client "
                    f">= {min_per_client}")
            take = min(int(sizes[donor]) - min_per_client,
                       min_per_client - int(sizes[i]))
            parts[i] = np.concatenate([parts[i], parts[donor][-take:]])
            parts[donor] = parts[donor][:-take]
            sizes[i] += take
            sizes[donor] -= take


def heterogeneity_stats(labels: np.ndarray,
                        parts: list[np.ndarray]) -> dict:
    """Per-client class histograms + mean pairwise TV distance."""
    n_classes = int(labels.max()) + 1
    hists = np.stack([
        np.bincount(labels[p], minlength=n_classes) / max(1, len(p))
        for p in parts])
    n = len(parts)
    # all-pairs TV in row chunks (keeps the broadcast a few MB at n=1024)
    tv = 0.0
    chunk = max(1, 2**22 // max(1, n * n_classes))
    for i in range(0, n, chunk):
        d = np.abs(hists[i:i + chunk, None, :] - hists[None, :, :])
        tv += 0.5 * d.sum()
    cnt = n * (n - 1) // 2
    # the chunked sum counts each unordered pair twice (diagonal adds 0)
    return {"hists": hists, "mean_tv": tv / 2.0 / max(1, cnt),
            "sizes": [len(p) for p in parts]}
