"""Decentralized optimizer zoo: the paper's method and every baseline it
compares.

Port of ``repro/core/optim.py``.  Each algorithm is a ``chain()`` of stages
from ``core/transforms.py``; the classes keep the reference's constructor
fields and defaults.  All act on node-stacked trees (leaves
``[n_nodes, ...]``):

    params', state' = opt.step(params, grads, state, w=W_t, lr=eta_t, t=t)

  dsgd          DSGD                                   [Eq. DSGD]
  dsgdm         DSGD + local HeavyBall momentum        [Alg. 1 left]
  dsgdm_n       DSGD + local Nesterov momentum         [§3.1 naming]
  qg_dsgdm      Quasi-Global momentum, HeavyBall       [Alg. 1 right]
  qg_dsgdm_n    Quasi-Global momentum, Nesterov        [§5, QG-DSGDm-N]
  qg_dsgdm_tau  multi-step variant, update m̂ every τ   [Alg. 3 / App. D.8]
  qhm           single-worker reduction of QG-DSGDm    [§4.2 / App. B.3.1]
  dadam         decentralized Adam (local buffers)     [Table 6 baseline]
  qg_dadam      Quasi-Global Adam                      [Alg. 2]
  dsgdm_sync    DSGDm(-N) + momentum-buffer gossip     [Table 5 rows 3/8/9]
  slowmo        SlowMo (Wang et al. 2020c)             [Alg. 5]
  dmsgd         DMSGD option I/II (Balu et al. 2020)   [Alg. 8 / App. B.2]
  d2            D^2 (Tang et al. 2018b)                [Table 2]
  d2_plus       D^2 with lr-decay fix                  [footnote 9]
  gt            DSGD with gradient tracking            [Table 2]
  gt_dsgdm_n    DSGDm-N on tracked gradients           [Table 2]
  mt_dsgdm      Momentum Tracking (Takezawa et al. 22) [tracking family]
  gut           Global Update Tracking (Aketi et al.)  [tracking family]

``ChainOptimizer`` builds an explicit chain from ``(stage name, kwargs)``
pairs (the ``OptimSpec.stages`` form).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.tree import tree_leaves

from . import gossip
from . import transforms as T

__all__ = ["DecentralizedOptimizer", "DSGD", "DSGDm", "QGDSGDm", "QHM",
           "DAdam", "QGDAdam", "SlowMo", "DMSGD", "D2", "GradientTracking",
           "GlobalUpdateTracking", "ChainOptimizer", "make_optimizer",
           "OPTIMIZERS"]


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

    def step(self, params, grads, state, *, w=None, lr=None, t=0,
             n_nodes=None, mesh=None):
        """One chained step.  ``lr`` and ``t`` may be tensors on the params'
        device (the trainer passes them so) or plain numbers; ``n_nodes``
        and ``mesh`` are ``StepCtx.n_nodes`` and ``StepCtx.mesh``."""
        dev = tree_leaves(params)[0].device
        lr = torch.as_tensor(self.lr if lr is None else lr,
                             dtype=torch.float32, device=dev).reshape(1)
        ctx = T.StepCtx(w=w, lr=lr, t=torch.as_tensor(t, device=dev),
                        mix_fn=self.mix_fn, n_nodes=n_nodes, mesh=mesh)
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
    """Local HeavyBall: m <- beta m + g ; x <- W(x - eta m).  Optionally
    gossips the momentum buffer too (Table 5 'extra communication' rows):
    ``sync='ring'`` mixes m with the same W after the params mix site,
    ``sync='complete'`` averages it globally every step."""

    beta: float = 0.9
    nesterov: bool = False
    sync: str | None = None  # None | 'ring' (same W) | 'complete'
    name: str = "dsgdm"

    def _stages(self):
        stages = [T.weight_decay(self.weight_decay),
                  T.heavyball(self.beta, nesterov=self.nesterov),
                  T.gossip_mix()]
        if self.sync:
            stages.append(T.buffer_sync("heavyball", mode=self.sync))
        return T.chain(*stages)


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


@dataclasses.dataclass(frozen=True)
class QHM(DecentralizedOptimizer):
    """Quasi-Hyperbolic Momentum, the exact single-worker reduction of
    QG-DSGDm (App. B.3.1).  Local descent only: no mix call site."""

    beta: float = 0.9
    mu: float | None = None
    name: str = "qhm"

    @property
    def _mu(self):
        return self.beta if self.mu is None else self.mu

    def _stages(self):
        return T.chain(
            T.weight_decay(self.weight_decay),
            T.qhm_momentum(self.beta, self._mu),
            T.descent())


@dataclasses.dataclass(frozen=True)
class DAdam(DecentralizedOptimizer):
    """Decentralized Adam with local buffers (Table 6 baseline)."""

    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-8
    name: str = "dadam"

    def _stages(self):
        return T.chain(
            T.weight_decay(self.weight_decay),
            T.adam_scale(self.beta1, self.beta2, self.eps),
            T.gossip_mix())


@dataclasses.dataclass(frozen=True)
class QGDAdam(DecentralizedOptimizer):
    """Algorithm 2: Adam whose moment buffers are refreshed from the
    L2-normalized model difference d_hat after each gossip round."""

    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-8
    name: str = "qg_dadam"

    def _stages(self):
        return T.chain(
            T.weight_decay(self.weight_decay),
            T.adam_scale(self.beta1, self.beta2, self.eps,
                         seed_from="qg_adam"),
            T.gossip_mix(),
            T.qg_adam_buffer(self.beta1, self.beta2))


@dataclasses.dataclass(frozen=True)
class SlowMo(DecentralizedOptimizer):
    """Base optimizer DSGDm(-N); every tau steps ``slow_outer`` averages the
    model over all nodes, applies the slow momentum update on the outer
    iterates and resets the base momentum buffer."""

    beta: float = 0.9        # base momentum
    slow_beta: float = 0.7
    slow_alpha: float = 1.0
    tau: int = 12
    nesterov: bool = True
    name: str = "slowmo"

    def _stages(self):
        return T.chain(
            T.weight_decay(self.weight_decay),
            T.heavyball(self.beta, nesterov=self.nesterov),
            T.gossip_mix(),
            T.slow_outer(self.slow_beta, self.slow_alpha, self.tau,
                         base="heavyball"))


@dataclasses.dataclass(frozen=True)
class DMSGD(DecentralizedOptimizer):
    """Re-organized DMSGD (Alg. 7/8): heavyball seeded from the DMSGD
    buffer, which blends the local update with the post-mix model
    difference (Option II) or also replays the previous step (Option I)."""

    beta: float = 0.9
    mu: float = 0.5
    option: int = 2
    name: str = "dmsgd"

    def _stages(self):
        return T.chain(
            T.weight_decay(self.weight_decay),
            T.heavyball(self.beta, seed_from="dmsgd_buffer"),
            T.gossip_mix(),
            T.dmsgd_buffer(self.beta, self.mu, option=self.option))


@dataclasses.dataclass(frozen=True)
class D2(DecentralizedOptimizer):
    """D^2 (Tang et al. 2018b): x^{t+1} = W(2x^t - x^{t-1} - eta(g^t -
    g^{t-1})), first step plain DSGD.  ``plus=True`` is the paper's D^2_+
    fix that rescales the model-difference term by the previous learning
    rate (footnote 9)."""

    plus: bool = False
    name: str = "d2"

    def _stages(self):
        return T.chain(
            T.weight_decay(self.weight_decay),
            T.d2_correction(plus=self.plus),
            T.gossip_mix())


@dataclasses.dataclass(frozen=True)
class GradientTracking(DecentralizedOptimizer):
    """DSGD with gradient tracking: the tracker y mixes in its own gossip
    round before the params mix site.  ``momentum``/``nesterov`` put a
    DSGDm(-N) buffer on top of y: momentum without Nesterov is Momentum
    Tracking, with it the Table 2 'DSGDm-N (w/ GT)' row."""

    momentum: float = 0.0
    nesterov: bool = False
    name: str = "gt"

    def _stages(self):
        stages = [T.weight_decay(self.weight_decay), T.grad_track()]
        if self.momentum:
            stages.append(T.heavyball(self.momentum, nesterov=self.nesterov))
        stages.append(T.gossip_mix())
        return T.chain(*stages)


@dataclasses.dataclass(frozen=True)
class GlobalUpdateTracking(DecentralizedOptimizer):
    """Global Update Tracking (Aketi et al., 2023): Momentum Tracking's
    stages in the other order, so the tracker runs on the momentum update.
    On a fixed W the two orders commute; they part on a time-varying W and
    under compressed gossip."""

    beta: float = 0.9
    nesterov: bool = False
    name: str = "gut"

    def _stages(self):
        return T.chain(
            T.weight_decay(self.weight_decay),
            T.heavyball(self.beta, nesterov=self.nesterov),
            T.grad_track(),
            T.gossip_mix())


@dataclasses.dataclass(frozen=True)
class ChainOptimizer(DecentralizedOptimizer):
    """An optimizer from an explicit stage chain: ``stage_specs`` is a
    tuple of ``(factory_name, kwargs)`` pairs resolved through
    ``transforms.STAGES``, the form an ``OptimSpec.stages`` JSON holds."""

    stage_specs: tuple = ()
    name: str = "chain"

    def _stages(self):
        return T.chain(*(T.make_stage(n, **dict(kw))
                         for n, kw in self.stage_specs))


OPTIMIZERS: dict[str, Callable[..., DecentralizedOptimizer]] = {
    "dsgd": DSGD,
    "dsgdm": lambda **kw: DSGDm(nesterov=False, name="dsgdm", **kw),
    "dsgdm_n": lambda **kw: DSGDm(nesterov=True, name="dsgdm_n", **kw),
    "dsgdm_sync": lambda **kw: DSGDm(nesterov=False, sync="ring",
                                     name="dsgdm_sync", **kw),
    "dsgdm_n_sync": lambda **kw: DSGDm(nesterov=True, sync="ring",
                                       name="dsgdm_n_sync", **kw),
    "dsgdm_n_sync_global": lambda **kw: DSGDm(
        nesterov=True, sync="complete", name="dsgdm_n_sync_global", **kw),
    "qg_dsgdm": lambda **kw: QGDSGDm(nesterov=False, name="qg_dsgdm", **kw),
    "qg_dsgdm_n": lambda **kw: QGDSGDm(nesterov=True, name="qg_dsgdm_n", **kw),
    "qg_dsgdm_tau": lambda **kw: QGDSGDm(
        nesterov=False, name="qg_dsgdm_tau", **{"tau": 4, **kw}),
    "qhm": QHM,
    "dadam": DAdam,
    "qg_dadam": QGDAdam,
    "slowmo": SlowMo,
    "dmsgd": DMSGD,
    "d2": lambda **kw: D2(plus=False, name="d2", **kw),
    "d2_plus": lambda **kw: D2(plus=True, name="d2_plus", **kw),
    "gt": GradientTracking,
    "gt_dsgdm_n": lambda **kw: GradientTracking(
        momentum=0.9, nesterov=True, name="gt_dsgdm_n", **kw),
    "mt_dsgdm": lambda **kw: GradientTracking(
        **{"momentum": 0.9, "nesterov": False, "name": "mt_dsgdm", **kw}),
    "gut": GlobalUpdateTracking,
}


def make_optimizer(name: str, **kwargs) -> DecentralizedOptimizer:
    if name not in OPTIMIZERS:
        raise ValueError(
            f"unknown optimizer {name!r}; have {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](**kwargs)
