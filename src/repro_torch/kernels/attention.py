"""Launch wrappers of the CUDA attention kernels.

The kernels live in ``csrc/attention.cu`` (built and bound by
``kernels/build.py``); each replaces one Pallas kernel of
``repro/kernels/flash_attention.py``:

  * ``flash_attention``         causal or non-causal GQA attention over
    q [B,S,H,D] and k/v [B,T,K,D] with an optional sliding window and tanh
    softcap (the prefill path, ``transformer.prefill(use_pallas=True)``);
  * ``paged_decode_attention``  one decode token per serving slot over the
    page pools k/v [NP,ps,K,D], through ``block_tables`` [B,P] (-1 =
    unallocated) and ``lengths`` [B] (every batched decode step of
    ``ServeEngine(use_pallas=True)``).

Bounds on an H100 (``csrc/attention.cu`` has the design): with TF32 off,
the fp32 flash kernel is bound by the 67 TFLOP/s fp32 rate -- at
[2,1024,32,64] causal about 8.6 GFLOP, 0.128 ms; the paged decode kernel
by the live K/V bytes at 3.35 TB/s.

Both take fp32 or bf16 (``TypeError`` on any other dtype) and compute in
fp32; flash takes head_dim 32, 64 or 128 (``ValueError`` on any other).
Every wrapper checks its arguments (dtype, shapes, then device and
contiguity: CUDA tensors only), allocates its output with ``torch.empty``
and launches on the current stream; ``kernels/ops.py`` routes CPU tensors
to the plain versions in ``kernels/ref.py`` instead.  ``LAUNCHES`` counts
the launches of each kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build as _build
from . import ref

__all__ = ["flash_attention", "paged_decode_attention", "LAUNCHES",
           "FLASH_HEAD_DIMS"]

#: launches of each kernel in this process (bumped once per kernel launch)
LAUNCHES = {"flash_attention": 0, "paged_decode_attention": 0}

#: head dims the flash kernel is instantiated for (reduced configs,
#: TinyLlama, Gemma-2)
FLASH_HEAD_DIMS = (32, 64, 128)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "attn_flash_forward": [_P] * 4 + [_I] * 8 + [_F, _F, _I, _P],
    "attn_paged_decode": [_P] * 6 + [_I] * 8 + [_F, _F, _I, _P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The typed library handle, built on the first CUDA launch."""
    return _build.bind("attention", _SIGNATURES, "attn_error_string")


def _run(kernel: str, fn: str, dev: torch.device, *args) -> None:
    _build.launch(_lib(), "attn_error_string", LAUNCHES, kernel, fn, dev,
                  *args)


def _check(kernel: str, tensors: dict, dtypes) -> torch.device:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    whose dtype is in ``dtypes`` (a dict name -> allowed dtypes)."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} must be a CUDA tensor (CPU "
                             "tensors go through kernels.ops)")
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, not {dev}")
        if t.dtype not in dtypes[name]:
            raise TypeError(f"{kernel}: {name} must be one of "
                            f"{sorted(str(d) for d in dtypes[name])}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    return dev


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q [B,S,H,D]; k/v [B,T,K,D] -> [B,S,H,D] in q's dtype; H % K == 0."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B,S,H,D] and k, v [B,T,K,D] "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or not kh or h % kh:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (same B and D, H % K == 0)")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"{FLASH_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} > 65535")
    same = {q.dtype}
    dev = _check("flash_attention", {"q": q, "k": k, "v": v},
                 {"q": same, "k": same, "v": same})
    out = torch.empty_like(q)
    if out.numel():
        if t == 0:
            raise ValueError("flash_attention: no keys (T = 0)")
        _run("flash_attention", "attn_flash_forward", dev, q.data_ptr(),
             k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, h, kh, d,
             int(causal), int(window), float(softcap), ref.attn_scale(d),
             _DTYPES[q.dtype])
    return out


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           window: int = 0, softcap: float = 0.0):
    """q [B,1,H,D]; k/v_pages [NP,ps,K,D]; ``block_tables`` [B,P] and
    ``lengths`` [B] int32 -> [B,1,H,D] in q's dtype.  A slot of length 0
    (nothing visible) gives 0."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_decode_attention: q must be float32 or "
                        f"bfloat16, got {q.dtype}")
    if (q.dim() != 4 or q.shape[1] != 1 or k_pages.dim() != 4
            or k_pages.shape != v_pages.shape):
        raise ValueError(f"paged_decode_attention: q [B,1,H,D] and k/v "
                         f"pages [NP,ps,K,D] expected, got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    b, _, h, d = q.shape
    n_p, ps, kh, _ = k_pages.shape
    if k_pages.shape[3] != d or not kh or h % kh:
        raise ValueError(f"paged_decode_attention: pages "
                         f"{tuple(k_pages.shape)} do not fit q "
                         f"{tuple(q.shape)} (same D, H % K == 0)")
    if (block_tables.dim() != 2 or block_tables.shape[0] != b
            or tuple(lengths.shape) != (b,)):
        raise ValueError(f"paged_decode_attention: block_tables [B,P] and "
                         f"lengths [B] expected for B = {b}, got "
                         f"{tuple(block_tables.shape)}, "
                         f"{tuple(lengths.shape)}")
    if b > 65535:
        raise ValueError(f"paged_decode_attention: B = {b} > 65535")
    same, idx = {q.dtype}, {torch.int32}
    dev = _check("paged_decode_attention",
                 {"q": q, "k_pages": k_pages, "v_pages": v_pages,
                  "block_tables": block_tables, "lengths": lengths},
                 {"q": same, "k_pages": same, "v_pages": same,
                  "block_tables": idx, "lengths": idx})
    out = torch.empty_like(q)
    if out.numel():
        _run("paged_decode_attention", "attn_paged_decode", dev,
             q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), b,
             h, kh, d, n_p, ps, block_tables.shape[1], int(window),
             float(softcap), ref.attn_scale(d), _DTYPES[q.dtype])
    return out
