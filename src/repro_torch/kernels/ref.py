"""Plain PyTorch versions of the four ``qg_update`` kernels.

Port of ``repro/kernels/ref.py:16-52``.  Each function keeps the expression
order of the Pallas body it stands for (``repro/kernels/qg_update.py``), so
that on the same fp32 inputs it rounds exactly as the CUDA kernel in
``csrc/qg_update.cu`` does: every product and sum is its own rounded
operation, and the coefficients fold the way the reference folds them.
They are the kernels' test oracle and serve CPU tensors in
``kernels/ops.py``; they run on any device.
"""
from __future__ import annotations

import torch

__all__ = ["qg_local_step", "qg_buffer_update", "fused_halfstep",
           "fused_qg_buffer"]


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
