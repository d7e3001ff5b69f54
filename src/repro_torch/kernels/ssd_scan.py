"""Launch wrappers of the CUDA SSD scan kernels.

The kernels live in ``csrc/ssd_scan.cu`` (built and bound by
``kernels/build.py``) and replace the Pallas kernel
``repro/kernels/ssd_scan.py:77`` ``ssd_scan_bh`` together with its wrapper
``repro/kernels/ops.py:84``: they read the model layout in place (no
head-major copies, no H-fold broadcast of b and c), form ``a * dt`` and add
the D-skip term themselves.  ``ssd_scan`` is the Mamba-2 mixer's scan under
``use_pallas`` (``models/ssm.py``), one call per mamba layer of a ``train``
or ``prefill`` forward.

A call runs the chunk-parallel form in three launches over chunks of
``ref.SSD_BLOCK`` (64) tokens, whatever the caller's ``chunk``:

* :func:`chunk_states` -- each chunk's own state ``dS`` [B,nc,H,N,P] and
  decay ``exp(cum_L)`` [B,nc,H], in parallel (``LAUNCHES["ssd_scan"]``:
  one per call of ``ssd_scan``);
* :func:`state_passing` -- the serial pass over the chunks, in place
  (``dS`` becomes each chunk's incoming state), and the final state
  (``LAUNCHES["ssd_scan_passing"]``);
* :func:`chunk_outputs` -- y (``LAUNCHES["ssd_scan_outputs"]``).

Their plain versions are ``ref.ssd_chunk_states``, ``ref.ssd_state_passing``
and ``ref.ssd_chunk_outputs``.  Products run on the tensor cores to fp32
accuracy (3xTF32); bound on an H100 (``csrc/ssd_scan.cu`` has the design):
the recurrence's own operations at 165 TFLOP/s -- at [2,2048,24,64,128]
about 4.0 GFLOP, 0.025 ms.

x, b and c are fp32 or bf16 (one dtype; ``TypeError`` otherwise), dt, a and
d_skip fp32.  x [B,S,H,P] and b/c [B,S,N] may be contiguous or a slice of
the last axis of a contiguous tensor (the mixer passes views of its conv
output): each token's row must be dense and the rows evenly spaced.  The
wrappers check dtypes, shapes, ``S % min(chunk, S)`` (the reference's limit,
kept), P % 16 == 0, N % 4 == 0, the shared memory a block needs (N up to
336 where 32 divides P, else 344), device and layout (CUDA tensors only;
the scratch states 16-byte aligned), all before building or launching; they allocate outputs and the scratch states with
``torch.empty`` and launch on the current stream.  ``kernels/ops.py``
routes CPU tensors to the sequential plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build as _build
from . import ref

__all__ = ["ssd_scan", "chunk_states", "state_passing", "chunk_outputs",
           "head_group", "smem_bytes", "LAUNCHES"]

#: launches of each kernel in this process (bumped once per launch):
#: ``ssd_scan`` is the chunk pass, the first of every scan
LAUNCHES = {"ssd_scan": 0, "ssd_scan_passing": 0, "ssd_scan_outputs": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel constants of ``csrc/ssd_scan.cu``: heads a block at most, shared
#: memory a block may have, the padded pitch of G
_MAX_HEADS, _MAX_SMEM, _G_PITCH = 8, 232448, ref.SSD_BLOCK + 4

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ssd_chunk_states_forward": [_P] * 6 + [_I] * 6 + [_LL] * 2 + [_I] * 3
                                + [_P],
    "ssd_state_pass_forward": [_P] * 3 + [_I] * 5 + [_P],
    "ssd_chunk_outputs_forward": [_P] * 8 + [_I] * 6 + [_LL] * 3 + [_I] * 3
                                 + [_P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The typed library handle, built on the first CUDA launch."""
    return _build.bind("ssd_scan", _SIGNATURES, "ssd_error_string")


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def smem_bytes(n: int, p: int) -> tuple[int, int]:
    """Shared memory of a block of the chunk pass and of the output pass,
    in bytes (``states_smem`` / ``outputs_smem`` of ``csrc/ssd_scan.cu``)."""
    ell, npad = ref.SSD_BLOCK, _round16(n)
    pw = min(p, 64 if p % 32 == 0 else 48)
    states = ell * (npad + 8) + 2 * ell * (pw + 8) + _MAX_HEADS * ell
    outputs = (ell * (npad + 4) + max(ell * (npad + 4), npad * (pw + 8))
               + ell * _G_PITCH + ell * (pw + 8) + 3 * _MAX_HEADS * ell)
    return 4 * states, 4 * outputs


def head_group(bsz: int, nc: int, h: int, sms: int) -> int:
    """Heads a block of the chunk and output passes owns (1..8): the one
    that minimises waves x (heads + 0.5) on ``sms`` SMs at two blocks an
    SM, a block's time taken as its heads plus half a head for what it
    shares (staging B and C, G = C B^T); ties go to fewer heads."""
    best, best_cost = 1, math.inf
    for hg in range(1, min(_MAX_HEADS, h) + 1):
        blocks = bsz * nc * -(-h // hg)
        cost = -(-blocks // (2 * sms)) * (hg + 0.5)
        if cost < best_cost:
            best, best_cost = hg, cost
    return best


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _check(x, dt, a, b, c=None, d_skip=None, chunk=None) -> dict:
    """Dtypes, shapes, the chunk, P, N, shared memory, device and layout of
    the scan's operands (``c``, ``d_skip`` and ``chunk`` where the call
    takes them); raises before anything is built.  Returns the geometry the
    launchers take."""
    if x.dtype not in _DTYPES or b.dtype != x.dtype or (
            c is not None and c.dtype != x.dtype):
        raise TypeError(f"ssd_scan: x, b and c must be one dtype, float32 or "
                        f"bfloat16, got {x.dtype}, {b.dtype}, "
                        f"{None if c is None else c.dtype}")
    for name, t in (("dt", dt), ("a", a), ("d_skip", d_skip)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, got "
                            f"{t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x [B,S,H,P] expected, got "
                         f"{tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if (tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,)
            or (d_skip is not None and tuple(d_skip.shape) != (h,))
            or tuple(b.shape) != (bsz, s, n)
            or (c is not None and tuple(c.shape) != (bsz, s, n))):
        raise ValueError(f"ssd_scan: dt [B,S,H], a [H], b/c [B,S,N], d_skip "
                         f"[H] expected for x {tuple(x.shape)}, got "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, "
                         f"{None if c is None else tuple(c.shape)}, "
                         f"{None if d_skip is None else tuple(d_skip.shape)}")
    if chunk is not None:
        ref.ssd_chunk_len(s, chunk)
    elif s < 1:
        raise ValueError("ssd_scan: need S >= 1")
    if p % 16 or n % 4 or n == 0:
        raise ValueError(f"ssd_scan: need P % 16 == 0 and N % 4 == 0, got "
                         f"P = {p}, N = {n}")
    if max(smem_bytes(n, p)) > _MAX_SMEM:
        raise ValueError(f"ssd_scan: N = {n} needs {max(smem_bytes(n, p))} "
                         f"bytes of shared memory a block, more than "
                         f"{_MAX_SMEM}")
    if bsz > 65535 or h > 65535:
        raise ValueError(f"ssd_scan: B = {bsz} or H = {h} > 65535")
    tensors = {"x": x, "dt": dt, "a": a, "b": b, "c": c, "d_skip": d_skip}
    tensors = {k: v for k, v in tensors.items() if v is not None}
    dev = x.device
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan: {name} must be a CUDA tensor (CPU "
                             "tensors go through kernels.ops)")
        if t.device != dev:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, not {dev}")
    for name in ("dt", "a", "d_skip"):
        if name in tensors and not tensors[name].is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    strides = {"x": _token_stride("x", x, (h, p)),
               "b": _token_stride("b", b, (n,))}
    if c is not None:
        strides["c"] = _token_stride("c", c, (n,))
    align = 16 if x.dtype == torch.float32 else 8
    vec = all(tensors[k].data_ptr() % align == 0 and ts % 4 == 0
              for k, ts in strides.items())
    nc = -(-s // ref.SSD_BLOCK)
    return {"bsz": bsz, "s": s, "h": h, "p": p, "n": n, "nc": nc,
            "dev": dev, "strides": strides, "vec": int(vec),
            "p_tile": 32 if p % 32 == 0 else 16,
            "dtype": _DTYPES[x.dtype]}


def _head_group(g: dict) -> int:
    return head_group(g["bsz"], g["nc"], g["h"], _sms(g["dev"].index))


def _chunk_states(x, dt, a, b, g, hg):
    dstate = torch.empty((g["bsz"], g["nc"], g["h"], g["n"], g["p"]),
                         dtype=torch.float32, device=g["dev"])
    decay = torch.empty((g["bsz"], g["nc"], g["h"]), dtype=torch.float32,
                        device=g["dev"])
    _build.launch(_lib(), "ssd_error_string", LAUNCHES, "ssd_scan",
                  "ssd_chunk_states_forward", g["dev"], x.data_ptr(),
                  dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                  dstate.data_ptr(), decay.data_ptr(), g["bsz"], g["s"],
                  g["h"], g["p"], g["n"], hg, g["strides"]["x"],
                  g["strides"]["b"], g["p_tile"], g["vec"], g["dtype"])
    return dstate, decay


def _state_passing(states, decay):
    bsz, nc, h, n, p = states.shape
    fin = torch.empty((bsz, h, n, p), dtype=torch.float32,
                      device=states.device)
    _build.launch(_lib(), "ssd_error_string", LAUNCHES, "ssd_scan_passing",
                  "ssd_state_pass_forward", states.device, states.data_ptr(),
                  decay.data_ptr(), fin.data_ptr(), bsz, nc, h, n, p)
    return states, fin


def _chunk_outputs(x, dt, a, b, c, d_skip, s_in, g, hg):
    y = torch.empty((g["bsz"], g["s"], g["h"], g["p"]), dtype=x.dtype,
                    device=g["dev"])
    _build.launch(_lib(), "ssd_error_string", LAUNCHES, "ssd_scan_outputs",
                  "ssd_chunk_outputs_forward", g["dev"], x.data_ptr(),
                  dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                  d_skip.data_ptr(), s_in.data_ptr(), y.data_ptr(),
                  g["bsz"], g["s"], g["h"], g["p"], g["n"], hg,
                  g["strides"]["x"], g["strides"]["b"], g["strides"]["c"],
                  g["p_tile"], g["vec"], g["dtype"])
    return y


def _check_states(states, want=None, decay=None) -> None:
    """``states`` [B,nc,H,N,P] (shape ``want`` where given) and ``decay``
    [B,nc,H]: contiguous fp32 on one CUDA device; ``states`` 16-byte
    aligned (the kernels read it by float4 and 16-byte ``cp.async``)."""
    if states.data_ptr() % 16:
        raise ValueError("ssd_scan: states must be 16-byte aligned")
    for name, t in (("states", states), ("decay", decay)):
        if t is not None and (t.dtype != torch.float32
                              or t.device.type != "cuda"
                              or t.device != states.device
                              or not t.is_contiguous()):
            raise ValueError(f"ssd_scan: {name} must be a contiguous "
                             f"float32 CUDA tensor on {states.device}")
    if states.dim() != 5 or (want is not None
                             and tuple(states.shape) != want):
        raise ValueError(f"ssd_scan: states {tuple(states.shape)}, want "
                         f"{want or '[B,nc,H,N,P]'}")
    if decay is not None and tuple(decay.shape) != tuple(states.shape[:3]):
        raise ValueError(f"ssd_scan: decay {tuple(decay.shape)} does not "
                         f"match states {tuple(states.shape)}")
    if (states.shape[3] * states.shape[4]) % 4:
        raise ValueError("ssd_scan: N * P must be a multiple of 4")


def chunk_states(x, dt, a, b):
    """The chunk pass alone: ``(dS [B,nc,H,N,P], decay [B,nc,H])`` fp32, as
    ``ref.ssd_chunk_states``."""
    g = _check(x, dt, a, b)
    return _chunk_states(x, dt, a, b, g, _head_group(g))


def state_passing(states, decay):
    """The state pass alone, in place on ``states`` (each chunk's dS becomes
    its incoming state): ``(states, final [B,H,N,P])``, as
    ``ref.ssd_state_passing``."""
    _check_states(states, decay=decay)
    return _state_passing(states, decay)


def chunk_outputs(x, dt, a, b, c, d_skip, s_in):
    """The output pass alone: y [B,S,H,P] in x's dtype from each chunk's
    incoming state ``s_in`` [B,nc,H,N,P], as ``ref.ssd_chunk_outputs``."""
    g = _check(x, dt, a, b, c, d_skip)
    _check_states(s_in, (g["bsz"], g["nc"], g["h"], g["n"], g["p"]))
    return _chunk_outputs(x, dt, a, b, c, d_skip, s_in, g, _head_group(g))


def ssd_scan(x, dt, a, b, c, d_skip, *, chunk: int = 128):
    """x [B,S,H,P]; dt [B,S,H]; a [H] (negative); b/c [B,S,N]; d_skip [H]
    -> ``(y [B,S,H,P] in x's dtype, final state [B,H,N,P] fp32)``, by the
    three passes (three launches)."""
    g = _check(x, dt, a, b, c, d_skip, chunk)
    if g["bsz"] == 0 or g["h"] == 0:
        return (torch.empty(x.shape, dtype=x.dtype, device=g["dev"]),
                torch.empty((g["bsz"], g["h"], g["n"], g["p"]),
                            dtype=torch.float32, device=g["dev"]))
    hg = _head_group(g)
    states, decay = _chunk_states(x, dt, a, b, g, hg)
    states, fin = _state_passing(states, decay)
    return _chunk_outputs(x, dt, a, b, c, d_skip, states, g, hg), fin
