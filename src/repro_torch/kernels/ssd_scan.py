"""Launch wrapper of the CUDA SSD scan kernel.

The kernel lives in ``csrc/ssd_scan.cu`` (built and bound by
``kernels/build.py``) and replaces the Pallas kernel
``repro/kernels/ssd_scan.py:77`` ``ssd_scan_bh`` together with its wrapper
``repro/kernels/ops.py:84``: it reads the model layout in place (no
head-major copies, no H-fold broadcast of b and c), forms ``a * dt`` and
adds the D-skip term itself.  It is the Mamba-2 mixer's scan under
``use_pallas`` (``models/ssm.py``), one launch per mamba layer of a
``train`` or ``prefill`` forward.

Bound on an H100 (``csrc/ssd_scan.cu`` has the design): the recurrence's
own operations at the fp32 rate of 67 TFLOP/s (TF32 off) -- at
[2,2048,24,64,128] about 4.0 GFLOP, 0.060 ms.

x, b and c are fp32 or bf16 (one dtype; ``TypeError`` otherwise), dt, a and
d_skip fp32.  x [B,S,H,P] and b/c [B,S,N] may be contiguous or a slice of
the last axis of a contiguous tensor (the mixer passes views of its conv
output): each token's row must be dense and the rows evenly spaced.  The
wrapper checks dtypes, shapes, ``S % min(chunk, S)`` (the reference's limit,
kept), P % 16 == 0 and N % 4 == 0, device and layout (CUDA tensors only),
allocates ``y`` and the final state with ``torch.empty`` and launches on the
current stream; ``kernels/ops.py`` routes CPU tensors to the plain version
in ``kernels/ref.py`` instead.  ``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build as _build
from . import ref

__all__ = ["ssd_scan", "LAUNCHES"]

#: launches of the kernel in this process (bumped once per launch)
LAUNCHES = {"ssd_scan": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ssd_scan_forward": [_P] * 8 + [_I] * 5 + [_LL] * 3 + [_I] * 2 + [_P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The typed library handle, built on the first CUDA launch."""
    return _build.bind("ssd_scan", _SIGNATURES, "ssd_error_string")


def _token_stride(name: str, t: torch.Tensor, inner: tuple) -> int:
    """The stride between consecutive tokens of ``t`` [B, S, *inner], whose
    rows (one token's ``inner`` elements) must be dense and evenly spaced
    across the batch, as in a contiguous tensor or a slice of its last
    axis; raises ``ValueError`` otherwise."""
    b, s = t.shape[:2]
    row = 1
    for d in inner:
        row *= d
    ts = t.stride(1) if s > 1 else (t.stride(0) if b > 1 else row)
    want, step = [s * ts, ts], 1
    for d in reversed(inner):
        want.insert(2, step)
        step *= d
    for size, got, w in zip(t.shape, t.stride(), want):
        if size > 1 and got != w:
            raise ValueError(f"ssd_scan: {name} must be contiguous or a slice "
                             f"of the last axis of a contiguous tensor, got "
                             f"strides {t.stride()} for shape "
                             f"{tuple(t.shape)}")
    return ts


def ssd_scan(x, dt, a, b, c, d_skip, *, chunk: int = 128):
    """x [B,S,H,P]; dt [B,S,H]; a [H] (negative); b/c [B,S,N]; d_skip [H]
    -> ``(y [B,S,H,P] in x's dtype, final state [B,H,N,P] fp32)``.  A block
    owns 32 of the P columns where 32 divides P, else 16."""
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, b and c must be one dtype, float32 or "
                        f"bfloat16, got {x.dtype}, {b.dtype}, {c.dtype}")
    for name, t in (("dt", dt), ("a", a), ("d_skip", d_skip)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, got "
                            f"{t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x [B,S,H,P] expected, got "
                         f"{tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if (tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,)
            or tuple(d_skip.shape) != (h,) or tuple(b.shape) != (bsz, s, n)
            or tuple(c.shape) != (bsz, s, n)):
        raise ValueError(f"ssd_scan: dt [B,S,H], a [H], b/c [B,S,N], d_skip "
                         f"[H] expected for x {tuple(x.shape)}, got "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}, "
                         f"{tuple(d_skip.shape)}")
    ref.ssd_chunk_len(s, chunk)
    if p % 16 or n % 4 or n == 0:
        raise ValueError(f"ssd_scan: need P % 16 == 0 and N % 4 == 0, got "
                         f"P = {p}, N = {n}")
    if bsz > 65535 or h > 65535:
        raise ValueError(f"ssd_scan: B = {bsz} or H = {h} > 65535")
    tensors = {"x": x, "dt": dt, "a": a, "b": b, "c": c, "d_skip": d_skip}
    dev = x.device
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan: {name} must be a CUDA tensor (CPU "
                             "tensors go through kernels.ops)")
        if t.device != dev:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, not {dev}")
    for name in ("dt", "a", "d_skip"):
        if not tensors[name].is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    sx = _token_stride("x", x, (h, p))
    sb = _token_stride("b", b, (n,))
    sc = _token_stride("c", c, (n,))
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=dev)
    fin = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev)
    if bsz == 0 or h == 0:
        return y, fin
    p_tile = 32 if p % 32 == 0 else 16
    _build.launch(_lib(), "ssd_error_string", LAUNCHES, "ssd_scan",
                  "ssd_scan_forward", dev, x.data_ptr(), dt.data_ptr(),
                  a.data_ptr(), b.data_ptr(), c.data_ptr(), d_skip.data_ptr(),
                  y.data_ptr(), fin.data_ptr(), bsz, s, h, p, n, sx, sb, sc,
                  p_tile, _DTYPES[x.dtype])
    return y, fin
