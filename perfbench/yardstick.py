"""The benchmark's fixed arithmetic: the card's peaks and the byte counts
of the optimizer's kernel.

Frozen copies, kept here so that a change to the program cannot move the
yardstick:

* ``H100_FP32_FLOPS`` and ``H100_HBM_BYTES_PER_S`` are NVIDIA's H100 SXM5
  data sheet figures (dense, without sparsity) that
  ``src/repro_torch/launch/roofline.py`` (``H100``) also quotes: 67 TFLOP/s
  in float32 outside the tensor cores (the port turns TF32 off, so this is
  the peak its matrix products can reach) and 3.35 TB/s of HBM3.
* ``six_n_d`` is the 6·N·D rule of ``roofline.py``'s ``model_flops``: a
  forward and a backward pass cost 6 FLOPs a weight a token.
* ``qg_step_bytes`` counts ``qg_step``'s traffic as the port's kernel
  table counts row 11: x, m and g read once, x_new and m_out written once,
  4 bytes each, for every element of the node-stacked tree.

Each configuration's model FLOPs are counted from its published shapes in
its own module under ``reference/`` (``flops_per_step``).
"""
from __future__ import annotations

H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


def six_n_d(weights_per_token: float, tokens: float) -> float:
    """Training FLOPs of ``tokens`` through ``weights_per_token`` weights:
    2 a multiply-add forward, twice that backward."""
    return 6.0 * weights_per_token * tokens


def qg_step_bytes(elements: int) -> float:
    """Bytes ``qg_step`` must move a step over a node-stacked tree of
    ``elements`` fp32 elements: three streams in, two out."""
    return 5 * 4 * float(elements)
