"""Dense gossip, the exchange of mixes whose ``program.comm.compressor`` is
``dense`` (the port's default): every node takes the W-weighted sum of
every node's half-step.

A gossip module gives ``mixer(w, comm)``: from the mixing matrix ``w`` (a
tensor on the reference's device) and the mix's ``comm`` settings, a
function ``(path, stacked) -> mixed`` that the optimizer's reference calls
once a leaf a step on the node-stacked ``stacked``. A compressed gossip
keeps its replicas by ``path``.
"""
from __future__ import annotations

import torch


def mixer(w: torch.Tensor, comm: dict):
    def mix(path: str, stacked: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(w.to(stacked.dtype), stacked,
                               dims=([1], [0]))
    return mix
