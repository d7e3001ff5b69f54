"""Decentralized optimizers of the main path.

Port of ``repro/core/optim.py`` for the DSGD family and quasi-global
momentum.  Each algorithm is a ``chain()`` of stages from
``core/transforms.py``; the classes keep the reference's constructor
fields.  All act on node-stacked trees (leaves ``[n_nodes, ...]``):

    params', state' = opt.step(params, grads, state, w=W_t, lr=eta_t, t=t)

  dsgd          DSGD                                   [Eq. DSGD]
  dsgdm         DSGD + local HeavyBall momentum        [Alg. 1 left]
  dsgdm_n       DSGD + local Nesterov momentum         [§3.1 naming]
  qg_dsgdm      Quasi-Global momentum, HeavyBall       [Alg. 1 right]
  qg_dsgdm_n    Quasi-Global momentum, Nesterov        [§5, QG-DSGDm-N]
  qg_dsgdm_tau  multi-step variant, update m̂ every τ   [Alg. 3 / App. D.8]

The reference's other registry entries come with slice 2 of the port and
raise ``NotImplementedError`` until then.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.tree import tree_leaves

from . import gossip
from . import transforms as T

__all__ = ["DecentralizedOptimizer", "DSGD", "DSGDm", "QGDSGDm",
           "make_optimizer", "OPTIMIZERS"]


@dataclasses.dataclass(frozen=True)
class DecentralizedOptimizer:
    """A named stage chain behind the reference's step signature.
    ``mix_fn(w, tree)`` performs one gossip round (dense ``W @ x`` by
    default); ``fused`` is the ``chain_apply`` knob."""

    lr: float = 0.1
    weight_decay: float = 0.0
    mix_fn: Callable = dataclasses.field(default=gossip.mix_dense)
    name: str = "base"
    fused: str = "auto"

    def _stages(self) -> tuple[T.Stage, ...]:
        raise NotImplementedError

    def init(self, params):
        return T.chain_init(self._stages(), params)

    def step(self, params, grads, state, *, w=None, lr=None, t=0):
        """One chained step.  ``lr`` and ``t`` may be tensors on the params'
        device (the trainer passes them so) or plain numbers."""
        dev = tree_leaves(params)[0].device
        lr = torch.as_tensor(self.lr if lr is None else lr,
                             dtype=torch.float32, device=dev).reshape(1)
        ctx = T.StepCtx(w=w, lr=lr, t=torch.as_tensor(t, device=dev),
                        mix_fn=self.mix_fn)
        sv = T.StepVars(grads=grads, update=grads, params=params,
                        params_pre_mix=params)
        sv, new_state = T.chain_apply(self._stages(), ctx, sv, state,
                                      fused=self.fused)
        return sv.params, new_state


@dataclasses.dataclass(frozen=True)
class DSGD(DecentralizedOptimizer):
    name: str = "dsgd"

    def _stages(self):
        return T.chain(T.weight_decay(self.weight_decay), T.gossip_mix())


@dataclasses.dataclass(frozen=True)
class DSGDm(DecentralizedOptimizer):
    """Local HeavyBall: m <- beta m + g ; x <- W(x - eta m)."""

    beta: float = 0.9
    nesterov: bool = False
    name: str = "dsgdm"

    def _stages(self):
        return T.chain(T.weight_decay(self.weight_decay),
                       T.heavyball(self.beta, nesterov=self.nesterov),
                       T.gossip_mix())


@dataclasses.dataclass(frozen=True)
class QGDSGDm(DecentralizedOptimizer):
    """Algorithm 1 (right column) and its Nesterov flavour: a heavyball stage
    seeded from the quasi-global buffer, which refreshes post-mix from the
    model difference d = (x_t - x_{t+1}) / eta.  ``tau > 1`` refreshes the
    buffer only on steps with (t+1) % tau == 0 (Alg. 3)."""

    beta: float = 0.9
    mu: float | None = None  # paper sets mu = beta
    nesterov: bool = False
    tau: int = 1
    name: str = "qg_dsgdm"

    @property
    def _mu(self):
        return self.beta if self.mu is None else self.mu

    def _stages(self):
        return T.chain(
            T.weight_decay(self.weight_decay),
            T.heavyball(self.beta, nesterov=self.nesterov,
                        seed_from="qg_buffer"),
            T.gossip_mix(),
            T.qg_buffer(self._mu, tau=self.tau))


OPTIMIZERS: dict[str, Callable[..., DecentralizedOptimizer]] = {
    "dsgd": DSGD,
    "dsgdm": lambda **kw: DSGDm(nesterov=False, name="dsgdm", **kw),
    "dsgdm_n": lambda **kw: DSGDm(nesterov=True, name="dsgdm_n", **kw),
    "qg_dsgdm": lambda **kw: QGDSGDm(nesterov=False, name="qg_dsgdm", **kw),
    "qg_dsgdm_n": lambda **kw: QGDSGDm(nesterov=True, name="qg_dsgdm_n", **kw),
    "qg_dsgdm_tau": lambda **kw: QGDSGDm(
        nesterov=False, name="qg_dsgdm_tau", **{"tau": 4, **kw}),
}

#: the reference's other registry entries, ported in slice 2
SLICE_2_OPTIMIZERS = (
    "dsgdm_sync", "dsgdm_n_sync", "dsgdm_n_sync_global", "qhm", "dadam",
    "qg_dadam", "slowmo", "dmsgd", "d2", "d2_plus", "gt", "gt_dsgdm_n",
    "mt_dsgdm", "gut")


def make_optimizer(name: str, **kwargs) -> DecentralizedOptimizer:
    if name in SLICE_2_OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet: it comes with slice 2 "
            f"of the port; repro_torch has {sorted(OPTIMIZERS)}")
    if name not in OPTIMIZERS:
        raise ValueError(
            f"unknown optimizer {name!r}; have {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](**kwargs)
