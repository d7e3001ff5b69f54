"""QG-DSGDm-N (Lin et al., arXiv:2102.04761, Algorithm 1 with Nesterov's
momentum) written out over node-stacked leaves, and the readings the
benchmark compares.

The reference of cells whose configuration trains with ``optimizer:
qg_dsgdm_n`` (an optimizer's reference is ``reference/<optimizer>.py``,
and takes the configuration's ``lr``, ``weight_decay`` and ``kwargs``). A
step of node i, with the quasi-global buffer m_i (zero at the start):

    g'    = g_i + wd x_i
    m'    = beta m_i + g'
    half  = x_i - lr (beta m' + g')
    x_i  <- gossip(half)_i          (dense: sum_j W_ij half_j)
    m_i  <- mu m_i + (1 - mu) (x_i^old - x_i) / lr

The readings of the first steps of a run, by leaf path:

* ``loss``: the mean over the nodes of each step's loss;
* ``grad``: the norm of m after the first step, which is
  ``(1 - mu)(1 + beta) W (g + wd x0)`` there: the first gradient as the
  optimizer took it;
* ``grad_raw``: the norm of the first step's gradient itself, by which
  the comparison leaves out leaves whose gradient is nought to rounding;
* ``change``: the norm of the parameters' change over all the steps.

The sums of the norms run in float64. Nothing here imports the program.
"""
from __future__ import annotations

import torch

from perfbench.tree_paths import norm64


def train_readings(node_grad, x0: dict, batches: list, gossip, *,
                   lr: float, weight_decay: float, beta: float, mu: float,
                   ) -> dict:
    """Run ``len(batches)`` steps from ``x0`` (one node's leaves by path,
    every node starting there) over node-stacked device ``batches`` and
    return the readings. ``node_grad(leaves, batch) -> (loss, grads)``
    gives one node's loss and gradients by path; ``gossip(path, half)``
    mixes a leaf's node-stacked half-steps (``gossip/<name>.py``)."""
    n = batches[0][0].shape[0]
    x = {p: v.unsqueeze(0).expand(n, *v.shape).clone() for p, v in x0.items()}
    m = {p: torch.zeros_like(v) for p, v in x.items()}
    out = {"loss": []}
    for step, batch in enumerate(batches):
        half = {p: torch.empty_like(v) for p, v in x.items()}
        losses, raw = [], {p: 0.0 for p in x}
        for i in range(n):
            leaves = {p: v[i].detach().requires_grad_(True)
                      for p, v in x.items()}
            loss, grads = node_grad(leaves, tuple(a[i] for a in batch))
            losses.append(float(loss))
            with torch.no_grad():
                for p, g in grads.items():
                    if step == 0:
                        raw[p] += norm64(g) ** 2
                    ge = g + weight_decay * x[p][i]
                    mn = beta * m[p][i] + ge
                    half[p][i] = x[p][i] - lr * (beta * mn + ge)
        with torch.no_grad():
            for p in x:
                mixed = gossip(p, half.pop(p))
                m[p] = mu * m[p] + (1.0 - mu) * (x[p] - mixed) * (1.0 / lr)
                x[p] = mixed
        out["loss"].append(sum(losses) / n)
        if step == 0:
            out["grad"] = {p: norm64(v) for p, v in m.items()}
            out["grad_raw"] = {p: v ** 0.5 for p, v in raw.items()}
    with torch.no_grad():
        out["change"] = {p: sum(norm64(v[i] - x0[p]) ** 2
                                for i in range(n)) ** 0.5
                         for p, v in x.items()}
    return out
