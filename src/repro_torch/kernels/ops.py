"""Public kernel entry points: dispatch by the tensors' device.

Port of ``repro/kernels/ops.py`` for the ``qg_update`` kernels.  Where the
reference picks Pallas interpret mode off the TPU, the port picks by device:
CPU tensors go to the plain PyTorch version (``kernels/ref.py``), CUDA
tensors to the hand-written kernel (``kernels/qg_update.py``), which
launches or raises.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from . import qg_update as _qg
from . import ref

__all__ = ["fused_halfstep", "fused_qg_buffer", "qg_local_step",
           "qg_buffer_update", "launch_counts", "reset_launch_counts"]


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


def launch_counts() -> dict[str, int]:
    """Kernel launches so far in this process, by kernel name."""
    return dict(_qg.LAUNCHES)


def reset_launch_counts() -> None:
    for k in _qg.LAUNCHES:
        _qg.LAUNCHES[k] = 0
