"""Public kernel entry points: dispatch by the tensors' device.

Port of ``repro/kernels/ops.py`` for the ``qg_update``, ``compress``,
attention and SSD scan kernels.  Where the reference picks Pallas interpret
mode off the TPU, the port picks by device: CPU tensors go to the plain
PyTorch version (``kernels/ref.py``), CUDA tensors to the hand-written
kernel (``kernels/qg_update.py``, ``kernels/compress.py``,
``kernels/attention.py``, ``kernels/ssd_scan.py``), which launches or
raises.  There is no fallback
from one to the other.
"""
from __future__ import annotations

import torch

from . import attention as _att
from . import compress as _cmp
from . import qg_update as _qg
from . import ref
from . import ssd_scan as _ssd

__all__ = ["fused_halfstep", "fused_qg_buffer", "qg_local_step",
           "qg_buffer_update", "qg_step", "gamma_correct", "choco_exchange",
           "threshold_mask", "quantize_dequantize", "threshold_mask_group",
           "quantize_dequantize_group", "flash_attention",
           "paged_decode_attention", "ssd_scan", "launch_counts",
           "reset_launch_counts"]


def _on_cpu(*args) -> bool:
    """True for CPU tensors, False for CUDA ones; raises on a mix or on any
    other device.  Non-tensor arguments (float coefficients) are ignored."""
    devices = {a.device.type for a in args if isinstance(a, torch.Tensor)}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"kernel operands must all lie on the CPU or all on "
                     f"CUDA devices, got {sorted(devices)}")


def fused_halfstep(x, m, g, eta, *, beta, wd=0.0, nesterov=False,
                   emit_m=True):
    if _on_cpu(x, m, g, eta):
        half, mn = ref.fused_halfstep(x, m, g, eta, beta=beta, wd=wd,
                                      nesterov=nesterov)
        return (half, mn) if emit_m else half
    return _qg.fused_halfstep(x, m, g, eta, beta=beta, wd=wd,
                              nesterov=nesterov, emit_m=emit_m)


def fused_qg_buffer(x_pre, x_post, m_hat, eta, refresh, *, mu):
    if _on_cpu(x_pre, x_post, m_hat, eta, refresh):
        return ref.fused_qg_buffer(x_pre, x_post, m_hat, eta, refresh, mu=mu)
    return _qg.fused_qg_buffer(x_pre, x_post, m_hat, eta, refresh, mu=mu)


def qg_local_step(x, m_hat, g, *, eta, beta, nesterov=False):
    if _on_cpu(x, m_hat, g):
        return ref.qg_local_step(x, m_hat, g, eta=eta, beta=beta,
                                 nesterov=nesterov)
    return _qg.qg_local_step(x, m_hat, g, eta=eta, beta=beta,
                             nesterov=nesterov)


def qg_buffer_update(x_old, x_new, m_hat, *, eta, mu):
    if _on_cpu(x_old, x_new, m_hat):
        return ref.qg_buffer_update(x_old, x_new, m_hat, eta=eta, mu=mu)
    return _qg.qg_buffer_update(x_old, x_new, m_hat, eta=eta, mu=mu)


def qg_step(xs, ms, gs, w, eta, refresh=None, *, beta, wd=0.0,
            nesterov=False, mu=None):
    """``fused_halfstep``, the dense mix and (``mu`` given) ``fused_qg_buffer``
    of every leaf: ``(x_new, m_out)``; on CUDA tensors one launch (per
    ``qg_update.MAX_LEAVES`` leaves)."""
    if _on_cpu(*xs, *ms, *gs, w, eta, refresh):
        return ref.qg_step(xs, ms, gs, w, eta, refresh, beta=beta, wd=wd,
                           nesterov=nesterov, mu=mu)
    return _qg.qg_step(xs, ms, gs, w, eta, refresh, beta=beta, wd=wd,
                       nesterov=nesterov, mu=mu)


def gamma_correct(x, mixed, anchor, *, gamma):
    if _on_cpu(x, mixed, anchor):
        return ref.gamma_correct(x, mixed, anchor, gamma=gamma)
    return _cmp.gamma_correct(x, mixed, anchor, gamma=gamma)


def choco_exchange(halves, qs, w, *, gamma, x_hats=None, x_pres=None,
                   m_hats=None, eta=None, refresh=None, mu=None):
    """The replica advance, the dense mix of the anchors and
    ``gamma_correct`` of a compressed round (and, ``mu`` given,
    ``fused_qg_buffer``) of every leaf: ``(x_out, x_hat_new, m_out)``; on
    CUDA tensors one launch (per ``compress.MAX_LEAVES`` leaves)."""
    kw = dict(gamma=gamma, x_hats=x_hats, x_pres=x_pres, m_hats=m_hats,
              eta=eta, refresh=refresh, mu=mu)
    if _on_cpu(*halves, *qs, w, *(x_hats or ()), *(x_pres or ()),
               *(m_hats or ()), eta, refresh):
        return ref.choco_exchange(halves, qs, w, **kw)
    return _cmp.choco_exchange(halves, qs, w, **kw)


def threshold_mask(x2d, thr):
    if _on_cpu(x2d, thr):
        return ref.threshold_mask(x2d, thr)
    return _cmp.threshold_mask(x2d, thr)


def quantize_dequantize(x2d, scale, u, *, levels):
    if _on_cpu(x2d, scale, u):
        return ref.quantize_dequantize(x2d, scale, u, levels=levels)
    return _cmp.quantize_dequantize(x2d, scale, u, levels=levels)


def threshold_mask_group(x2ds, thrs):
    """``threshold_mask`` of every leaf of a message; on CUDA tensors one
    launch (per ``compress.MAX_LEAVES`` leaves)."""
    if not x2ds:
        return []
    if _on_cpu(*x2ds, *thrs):
        return ref.threshold_mask_group(x2ds, thrs)
    return _cmp.threshold_mask_group(x2ds, thrs)


def quantize_dequantize_group(x2ds, scales, us, *, levels):
    """``quantize_dequantize`` of every leaf of a message; on CUDA tensors
    one launch (per ``compress.MAX_LEAVES`` leaves)."""
    if not x2ds:
        return []
    if _on_cpu(*x2ds, *scales, *us):
        return ref.quantize_dequantize_group(x2ds, scales, us, levels=levels)
    return _cmp.quantize_dequantize_group(x2ds, scales, us, levels=levels)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    if _on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    return _att.flash_attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           window=0, softcap=0.0):
    if _on_cpu(q, k_pages, v_pages, block_tables, lengths):
        return ref.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                          lengths, window=window,
                                          softcap=softcap)
    return _att.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                       lengths, window=window,
                                       softcap=softcap)


def ssd_scan(x, dt, a, b, c, d_skip, *, chunk=128):
    """Model-layout entry, as the reference's: x [B,S,H,P], dt [B,S,H],
    a [H], b/c [B,S,N], d_skip [H] -> ``(y [B,S,H,P], final_state
    [B,H,N,P])``, the D-skip term included.  ``S % min(chunk, S)`` must be
    0 on either device."""
    if _on_cpu(x, dt, a, b, c, d_skip):
        ref.ssd_chunk_len(x.shape[1], chunk)
        return ref.ssd_scan(x, dt, a, b, c, d_skip)
    return _ssd.ssd_scan(x, dt.float(), a.float(), b, c, d_skip.float(),
                         chunk=chunk)


_COUNTERS = (_qg.LAUNCHES, _cmp.LAUNCHES, _att.LAUNCHES, _ssd.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far in this process, by kernel name."""
    return {k: v for c in _COUNTERS for k, v in c.items()}


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
