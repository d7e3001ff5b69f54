"""Launch wrappers of the CUDA compressed-gossip kernels.

The kernels live in ``csrc/compress.cu`` (built and bound by
``kernels/build.py``); each replaces one Pallas kernel of
``repro/kernels/compress.py``:

  * ``gamma_correct``        the CHOCO/EF post-exchange correction
    ``x + gamma*(mixed - anchor)`` in one pass over the packed tree;
  * ``threshold_mask``       top-k's mask and residual on ``[rows, f]``,
    ``q = x*[|x| >= thr_row]``, ``r = x - q`` (the per-row k-th magnitude
    is computed outside, as in the reference);
  * ``quantize_dequantize``  QSGD's stochastic quantize -> dequantize and
    residual on ``[rows, f]``, with the uniform noise ``u`` an operand.

Every wrapper takes CUDA tensors only, checks them (device, fp32,
contiguity, shapes), allocates its outputs with ``torch.empty`` and launches
on the current stream; ``kernels/ops.py`` routes CPU tensors to the plain
versions instead.  ``LAUNCHES`` counts the launches of each kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build as _build

__all__ = ["gamma_correct", "threshold_mask", "quantize_dequantize",
           "LAUNCHES"]

#: launches of each kernel in this process (bumped once per kernel launch)
LAUNCHES = {"gamma_correct": 0, "threshold_mask": 0,
            "quantize_dequantize": 0}

_P, _N, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "cmp_gamma_correct": [_P, _P, _P, _P, _N, _F, _P],
    "cmp_threshold_mask": [_P, _P, _P, _P, _N, _N, _P],
    "cmp_quantize_dequantize": [_P, _P, _P, _P, _P, _N, _N, _F, _P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The typed library handle, built on the first CUDA launch."""
    return _build.bind("compress", _SIGNATURES, "cmp_error_string")


def _run(kernel: str, fn: str, dev: torch.device, *args) -> None:
    _build.launch(_lib(), "cmp_error_string", LAUNCHES, kernel, fn, dev,
                  *args)


def gamma_correct(x, mixed, anchor, *, gamma: float):
    """``x + gamma*(mixed - anchor)``; ``gamma`` is folded to fp32."""
    dev = _build.check_operands(
        "gamma_correct", {"x": x, "mixed": mixed, "anchor": anchor})
    out = torch.empty_like(x)
    if out.numel():
        _run("gamma_correct", "cmp_gamma_correct", dev, x.data_ptr(),
             mixed.data_ptr(), anchor.data_ptr(), out.data_ptr(),
             out.numel(), gamma)
    return out


def _rowwise_check(kernel: str, x2d, extra: dict, row: dict):
    if x2d.dim() != 2:
        raise ValueError(f"{kernel}: x2d must be [rows, f], got shape "
                         f"{tuple(x2d.shape)}")
    for name, t in extra.items():
        if isinstance(t, torch.Tensor) and t.shape != x2d.shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"x2d {tuple(x2d.shape)}")
    return _build.check_operands(kernel, {"x2d": x2d, **extra}, row,
                                 scalar_len=x2d.shape[0])


def threshold_mask(x2d, thr):
    """``(q, r)`` with ``q = x*[|x| >= thr[row]]`` and ``r = x - q``;
    ``x2d`` [rows, f], ``thr`` [rows]."""
    dev = _rowwise_check("threshold_mask", x2d, {}, {"thr": thr})
    q, r = torch.empty_like(x2d), torch.empty_like(x2d)
    if q.numel():
        _run("threshold_mask", "cmp_threshold_mask", dev, x2d.data_ptr(),
             thr.data_ptr(), q.data_ptr(), r.data_ptr(), *x2d.shape)
    return q, r


def quantize_dequantize(x2d, scale, u, *, levels: int):
    """QSGD ``(q, r)`` on ``x2d`` [rows, f] with ``scale`` [rows] and the
    uniform noise ``u`` [rows, f]; ``levels`` = 2^bits - 1."""
    dev = _rowwise_check("quantize_dequantize", x2d, {"u": u},
                         {"scale": scale})
    q, r = torch.empty_like(x2d), torch.empty_like(x2d)
    if q.numel():
        _run("quantize_dequantize", "cmp_quantize_dequantize", dev,
             x2d.data_ptr(), scale.data_ptr(), u.data_ptr(), q.data_ptr(),
             r.data_ptr(), *x2d.shape, float(levels))
    return q, r
