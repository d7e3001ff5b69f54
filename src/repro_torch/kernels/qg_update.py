"""Launch wrappers of the CUDA quasi-global momentum kernels.

The kernels live in ``csrc/qg_update.cu`` (built and bound by
``kernels/build.py``); each replaces one Pallas kernel of
``repro/kernels/qg_update.py``:

  * ``fused_halfstep``   weight decay + HeavyBall/QG-seeded momentum + the
    gossip half step in one pass, emitting the half step and, for stateful
    momentum (``emit_m``), the new buffer;
  * ``fused_qg_buffer``  the post-mix QG refresh behind the tau gate;
  * ``qg_local_step`` / ``qg_buffer_update``  the static-lr forms.

The fused forms take the lr and the refresh gate as fp32 [1] device tensors
(a schedule value, read by the kernel, never by the host).  Every wrapper
takes CUDA tensors only, checks them (device, fp32, contiguity, equal
lengths), allocates its outputs with ``torch.empty`` and launches on the
current stream; ``kernels/ops.py`` routes CPU tensors to the plain versions
instead.  ``LAUNCHES`` counts the launches of each kernel, so that a run can
show that its main path went through them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build as _build

__all__ = ["fused_halfstep", "fused_qg_buffer", "qg_local_step",
           "qg_buffer_update", "LAUNCHES"]

#: launches of each kernel in this process (bumped once per kernel launch)
LAUNCHES = {"fused_halfstep": 0, "fused_qg_buffer": 0, "qg_local_step": 0,
            "qg_buffer_update": 0}

_P, _N, _F, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
_SIGNATURES = {
    "qg_fused_halfstep": [_P, _P, _P, _P, _P, _P, _N, _F, _F, _I, _I, _P],
    "qg_fused_qg_buffer": [_P, _P, _P, _P, _P, _P, _N, _F, _F, _P],
    "qg_local_step": [_P, _P, _P, _P, _N, _F, _F, _I, _P],
    "qg_buffer_update": [_P, _P, _P, _P, _N, _F, _F, _F, _P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The typed library handle, built on the first CUDA launch."""
    return _build.bind("qg_update", _SIGNATURES, "qg_error_string")


def _run(kernel: str, fn: str, dev: torch.device, *args) -> None:
    _build.launch(_lib(), "qg_error_string", LAUNCHES, kernel, fn, dev, *args)


def fused_halfstep(x, m, g, eta, *, beta: float, wd: float = 0.0,
                   nesterov: bool = False, emit_m: bool = True):
    """``(half, m_new)`` with ``emit_m``, else ``half``; see the module
    docstring.  ``eta`` is a fp32 [1] CUDA tensor."""
    dev = _build.check_operands("fused_halfstep", {"x": x, "m": m, "g": g},
                                {"eta": eta})
    half = torch.empty_like(x)
    m_new = torch.empty_like(x) if emit_m else None
    if x.numel():
        _run("fused_halfstep", "qg_fused_halfstep", dev,
             x.data_ptr(), m.data_ptr(), g.data_ptr(), eta.data_ptr(),
             half.data_ptr(), m_new.data_ptr() if emit_m else None,
             x.numel(), beta, wd, int(nesterov), int(bool(wd)))
    return (half, m_new) if emit_m else half


def fused_qg_buffer(x_pre, x_post, m_hat, eta, refresh, *, mu: float):
    """``mu*m_hat + (1-mu)*(x_pre - x_post)/eta`` where ``refresh != 0``,
    else ``m_hat``.  ``eta`` and ``refresh`` are fp32 [1] CUDA tensors."""
    dev = _build.check_operands(
        "fused_qg_buffer", {"x_pre": x_pre, "x_post": x_post, "m_hat": m_hat},
        {"eta": eta, "refresh": refresh})
    out = torch.empty_like(m_hat)
    if out.numel():
        _run("fused_qg_buffer", "qg_fused_qg_buffer", dev,
             x_pre.data_ptr(), x_post.data_ptr(), m_hat.data_ptr(),
             eta.data_ptr(), refresh.data_ptr(), out.data_ptr(),
             out.numel(), mu, 1.0 - mu)
    return out


def qg_local_step(x, m_hat, g, *, eta: float, beta: float,
                  nesterov: bool = False):
    """``x - eta*(beta*m_hat + g)`` (Nesterov: ``x - eta*(g +
    beta*(beta*m_hat + g))``) with a static ``eta``."""
    dev = _build.check_operands("qg_local_step",
                                {"x": x, "m_hat": m_hat, "g": g})
    out = torch.empty_like(x)
    if out.numel():
        _run("qg_local_step", "qg_local_step", dev,
             x.data_ptr(), m_hat.data_ptr(), g.data_ptr(), out.data_ptr(),
             out.numel(), eta, beta, int(nesterov))
    return out


def qg_buffer_update(x_old, x_new, m_hat, *, eta: float, mu: float):
    """``mu*m_hat + (1-mu)*(x_old - x_new)/eta`` with a static ``eta``."""
    dev = _build.check_operands(
        "qg_buffer_update", {"x_old": x_old, "x_new": x_new, "m_hat": m_hat})
    out = torch.empty_like(m_hat)
    if out.numel():
        _run("qg_buffer_update", "qg_buffer_update", dev,
             x_old.data_ptr(), x_new.data_ptr(), m_hat.data_ptr(),
             out.data_ptr(), out.numel(), mu, 1.0 - mu, 1.0 / eta)
    return out
