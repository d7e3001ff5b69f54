"""Plain PyTorch versions of the ``qg_update`` and ``compress`` kernels.

Port of ``repro/kernels/ref.py:16-80``.  Each function keeps the expression
order of the Pallas body it stands for (``repro/kernels/qg_update.py``,
``repro/kernels/compress.py``), so that on the same fp32 inputs it rounds
exactly as the CUDA kernel in ``csrc/qg_update.cu`` or ``csrc/compress.cu``
does: every product, sum and quotient is its own rounded operation, and the
coefficients fold the way the reference folds them.  A quotient is always a
true division of two tensors on one device: PyTorch computes
``scalar / tensor`` as ``tensor.reciprocal() * scalar``, and on CUDA
``tensor / python_scalar`` as a product with the reciprocal, neither of which
rounds as the reference's division does.
They are the kernels' test oracle and serve CPU tensors in
``kernels/ops.py``; they run on any device.
"""
from __future__ import annotations

import torch

__all__ = ["qg_local_step", "qg_buffer_update", "fused_halfstep",
           "fused_qg_buffer", "gamma_correct", "threshold_mask",
           "quantize_dequantize"]


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d fp32 tensor on ``like``'s device (a [1] operand or a float)."""
    return torch.as_tensor(v, dtype=torch.float32,
                           device=like.device).reshape(())


def qg_local_step(x, m_hat, g, *, eta: float, beta: float,
                  nesterov: bool) -> torch.Tensor:
    """Alg. 1 lines 5-6 (+ Nesterov): ``x - eta * upd`` with
    ``upd = beta*m_hat + g`` or ``g + beta*(beta*m_hat + g)``."""
    m_local = beta * m_hat + g
    upd = g + beta * m_local if nesterov else m_local
    return x - eta * upd


def qg_buffer_update(x_old, x_new, m_hat, *, eta: float,
                     mu: float) -> torch.Tensor:
    """Alg. 1 lines 8-9: ``mu*m_hat + (1-mu)*(x_old - x_new)/eta``, in the
    Pallas body's form: ``1/eta`` and ``1-mu`` are folded in double on the
    host and multiply, rather than divide, the difference."""
    return mu * m_hat + (1.0 - mu) * (x_old - x_new) * (1.0 / eta)


def fused_halfstep(x, m, g, eta, *, beta: float, wd: float = 0.0,
                   nesterov: bool = False):
    """Weight decay + HeavyBall/QG-seeded momentum + the gossip half step.
    ``eta`` is a fp32 [1] tensor (or a float).  Returns ``(half, m_new)``."""
    eta = _scalar(eta, x)
    ge = g + wd * x if wd else g
    mn = beta * m + ge
    upd = beta * mn + ge if nesterov else mn
    return -eta * upd + x, mn


def fused_qg_buffer(x_pre, x_post, m_hat, eta, refresh, *, mu: float):
    """Post-mix QG refresh with the Alg. 3 tau gate: where ``refresh`` is
    nonzero, ``mu*m_hat + (1-mu)*(1/eta)*(x_pre - x_post)``, else the old
    buffer carries through."""
    s = torch.reciprocal(_scalar(eta, x_pre))
    d = s * (x_pre - x_post)
    new = mu * m_hat + (1.0 - mu) * d
    return torch.where(_scalar(refresh, x_pre) != 0.0, new, m_hat)


def gamma_correct(x, mixed, anchor, *, gamma: float) -> torch.Tensor:
    """CHOCO/EF post-exchange correction ``x + gamma*(mixed - anchor)``;
    ``gamma`` rounds to fp32 as the reference's weak-typed scalar does."""
    return x + gamma * (mixed - anchor)


def threshold_mask(x2d, thr):
    """Magnitude-threshold sparsification with residual.  ``x2d`` [rows, f],
    ``thr`` [rows]; keeps every entry with ``|x| >= thr`` of its row (ties at
    the threshold included).  Returns ``(kept, residual)`` in fp32."""
    x = x2d.to(torch.float32)
    q = torch.where(x.abs() >= thr.to(torch.float32)[:, None], x, 0.0)
    return q, x - q


def quantize_dequantize(x2d, scale, u, *, levels: int):
    """QSGD stochastic quantize->dequantize with residual.  ``x2d`` [rows, f],
    ``scale`` [rows] (max ``|x|`` per row), ``u`` [rows, f] uniform in
    [0, 1); ``q = sign(x) * min(floor(|x|*(L/s) + u), L) * (s/L)`` with
    ``s = max(scale, 1e-12)``.  Returns ``(q, x - q)`` in fp32."""
    x = x2d.to(torch.float32)
    s = torch.clamp_min(scale.to(torch.float32), 1e-12)[:, None]
    lv = torch.full_like(s, float(levels))
    y = x.abs() * (lv / s)
    xi = torch.clamp_max(torch.floor(y + u.to(torch.float32)), levels)
    q = torch.sign(x) * xi * (s / lv)
    return q, x - q
