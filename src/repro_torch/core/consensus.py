"""Distributed average-consensus experiments (paper §4.1 / Fig. 3, App. D.1).

Port of ``repro/core/consensus.py``.  Isolated from learning: plain gossip
averaging ``X <- W X`` against the gradient-free QG iteration (Eq. 4)

    X^{t+1} = W (X^t - beta M^t)
    M^{t+1} = mu M^t + (1-mu) (X^t - X^{t+1})

measuring the consensus distance ``||X - X_bar||_F / sqrt(n)`` per round.
The loop runs on ``device`` (the CUDA device unless the caller asks for
the CPU): round t takes ``mixing[t % T]`` from the stack on the device, the
distance history stays there and comes back once, at the end.  The start
``X^0`` is the reference's numpy draw, so both packages start from the same
numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from .topology import Topology

__all__ = ["run_gossip", "run_qg_consensus", "steps_to_distance"]


def _dist(x: torch.Tensor, sqrt_n: torch.Tensor) -> torch.Tensor:
    d = x - torch.mean(x, dim=0, keepdim=True)
    return torch.sqrt(torch.sum(d * d)) / sqrt_n


def _init(topo: Topology, dim: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(topo.n, dim)).astype(np.float32)


def _setup(topo: Topology, dim: int, seed: int, device):
    dev = resolve_device(device)
    ws = torch.as_tensor(topo.mixing, dtype=torch.float32).to(dev)
    x = torch.from_numpy(_init(topo, dim, seed)).to(dev)
    sqrt_n = torch.sqrt(torch.tensor(float(topo.n), dtype=torch.float32,
                                     device=dev))
    return ws, x, sqrt_n


def run_gossip(topo: Topology, *, dim: int = 128, steps: int = 200,
               seed: int = 0, device="cuda") -> np.ndarray:
    """Consensus distance history for plain gossip averaging."""
    ws, x, sqrt_n = _setup(topo, dim, seed, device)
    hist = torch.empty(steps, dtype=torch.float32, device=x.device)
    for t in range(steps):
        x = ws[t % ws.shape[0]] @ x
        hist[t] = _dist(x, sqrt_n)
    return hist.cpu().numpy()


def run_qg_consensus(topo: Topology, *, beta: float = 0.9, mu: float = 0.9,
                     dim: int = 128, steps: int = 200, seed: int = 0,
                     device="cuda") -> np.ndarray:
    """Consensus distance history for the QG iteration (Eq. 4)."""
    ws, x, sqrt_n = _setup(topo, dim, seed, device)
    m = torch.zeros_like(x)
    hist = torch.empty(steps, dtype=torch.float32, device=x.device)
    for t in range(steps):
        x_new = ws[t % ws.shape[0]] @ (x - beta * m)
        m = mu * m + (1.0 - mu) * (x - x_new)
        x = x_new
        hist[t] = _dist(x, sqrt_n)
    return hist.cpu().numpy()


def steps_to_distance(history: np.ndarray, target: float) -> int:
    """First round index at which the consensus distance drops below target
    (relative to the round-0 distance); -1 if never."""
    rel = history / history[0]
    hits = np.nonzero(rel <= target)[0]
    return int(hits[0]) if hits.size else -1
