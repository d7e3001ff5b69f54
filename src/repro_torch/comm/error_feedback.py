"""Error-feedback residual buffers for compressed communication.

Port of ``repro/comm/error_feedback.py``.  Two flavours, both pure functions
over node-stacked trees, so the buffers slot straight into trainer state:

* **EF14** (Seide'14 / Stich'18): keep the compression residual and fold it
  back into the next message.  ``q_t = C(v_t + e_t)``,
  ``e_{t+1} = v_t + e_t - q_t``; telescoping gives
  ``sum_t q_t + e_T = sum_t v_t`` exactly: information is only delayed.
* **EF21** (Richtarik'21): keep an estimate ``h`` of a moving target and ship
  compressed innovations: ``q_t = C(x_t - h_t)``, ``h_{t+1} = h_t + q_t``.
  CHOCO's replica variables ``x̂`` are exactly EF21 estimates.

``gen`` (a ``torch.Generator``) or ``noise`` (per-leaf draws) feed a
compressor that draws random numbers; see ``comm/compressors.py``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_map

from .compressors import Compressor

Tree = Any

__all__ = ["init_residual", "ef_compress", "ef21_innovation", "ef21_update"]


def init_residual(tree: Tree) -> Tree:
    """Zero residual buffer shaped like the node-stacked message tree."""
    return tree_map(torch.zeros_like, tree)


def ef_compress(compressor: Compressor, gen, value: Tree, residual: Tree, *,
                noise=None) -> tuple[Tree, Tree]:
    """One EF14 round: compress (value + residual), return (q, new_residual)
    through the fused compress+residual path."""
    corrected = tree_map(torch.add, value, residual)
    return compressor.compress_with_residual(gen, corrected, noise=noise)


def ef21_innovation(compressor: Compressor, gen, target: Tree,
                    estimate: Tree, *, noise=None) -> Tree:
    """The message of one EF21 round, q = C_contractive(target -
    estimate)."""
    diff = tree_map(torch.subtract, target, estimate)
    return compressor.contractive_compress(gen, diff, noise=noise)


def ef21_update(compressor: Compressor, gen, target: Tree, estimate: Tree, *,
                noise=None) -> tuple[Tree, Tree]:
    """One EF21 round: ship q = C_contractive(target - estimate) and advance
    the estimate.  Returns (new_estimate, q)."""
    q = ef21_innovation(compressor, gen, target, estimate, noise=noise)
    return tree_map(torch.add, estimate, q), q
