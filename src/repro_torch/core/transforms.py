"""Composable optimizer-transform algebra (the main-path stages).

Port of ``repro/core/transforms.py``.  Every algorithm in ``core/optim.py``
is a ``chain()`` of named stages; a stage is an ``(init, apply)`` pair

    init(params)                -> stage state tree (or None if stateless)
    apply(ctx, sv, states)      -> (sv', states')

over node-stacked trees (dicts of ``[n_nodes, ...]`` tensors), where ``ctx``
is the per-step :class:`StepCtx` (mixing matrix, lr, step counter, gossip
hook), ``sv`` the :class:`StepVars` flowing down the chain and ``states``
the ``{stage_name: state}`` mapping, updated in chain order.

Every stage of the reference is ported, with its ``STAGES`` registry and
``make_stage`` (the serializable ``OptimSpec.stages`` form), the chain
runner, the fused dispatcher and the analytic bytes-moved model.  Gates
that depend on the step (a tracker's first step, SlowMo's outer step, the
QG refresh) are device tensors selected with ``torch.where``: no stage
reads ``t`` or ``lr`` back to the host.

``chain_apply(fused=...)`` routes the segments it recognises through the
kernels (the dense-gossip step through one ``qg_step`` launch, the exchange
of a compressed round through one ``choco_exchange`` launch, other
segments through the packed one-pass kernels): ``'kernel'`` always (CPU
tensors then take the kernels' plain versions, see ``kernels/ops.py``),
``'off'`` never, and
``'auto'`` iff the tensors lie on a CUDA device.  ``'pallas'`` is accepted
as another name for ``'kernel'`` so the reference's spec JSON loads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.comm.choco import CompressedMix
from repro_torch.kernels import ops
from repro_torch.kernels import pack as _kp
from repro_torch.kernels import qg_update as _kqg
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_paths, tree_unflatten

from . import gossip

Tree = Any
MixFn = Callable[[torch.Tensor, Tree], Tree]

__all__ = [
    "Stage", "StepCtx", "StepVars", "chain", "chain_init", "chain_apply",
    "chain_bytes_moved", "FUSED_MODES",
    "weight_decay", "heavyball", "qhm_momentum", "adam_scale", "gossip_mix",
    "descent", "qg_buffer", "qg_adam_buffer", "dmsgd_buffer", "grad_track",
    "d2_correction", "slow_outer", "buffer_sync", "STAGES", "make_stage",
]

#: values of the ``fused`` knob ('pallas' = 'kernel', for reference JSON)
FUSED_MODES = ("kernel", "pallas", "off", "auto")


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _sub(a, b):
    return tree_map(torch.subtract, a, b)


def _scale(s, a):
    return tree_map(lambda x: s * x, a)


def _axpy(s, a, b):
    """s*a + b"""
    return tree_map(lambda x, y: s * x + y, a, b)


def _lerp(mu, a, b):
    """mu*a + (1-mu)*b"""
    return tree_map(lambda x, y: mu * x + (1.0 - mu) * y, a, b)


# ---------------------------------------------------------------------------
# the algebra
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepCtx:
    """Per-step inputs every stage sees.  ``lr`` is a fp32 [1] tensor on the
    params' device (the schedule value), ``t`` the 0-d int step counter
    there too: neither is ever read back by the host.  ``n_nodes`` is the
    global node count for the node-reducing stages (None: the leaves'
    leading-axis size); ``mesh`` the node axis
    (``repro_torch.launch.mesh.NodeMesh``) when the leaves are this rank's
    block of the nodes, which those stages then reduce over (None: the
    leaves hold every node)."""

    w: Any                      # mixing matrix for this round (None if local)
    lr: Any                     # resolved learning rate eta_t
    t: Any                      # step counter
    mix_fn: MixFn               # the gossip hook
    n_nodes: Optional[int] = None
    mesh: Any = None


@dataclasses.dataclass(frozen=True)
class StepVars:
    """The value flowing down a chain: the effective (weight-decayed)
    gradient, the current update direction, the current params, and the
    params on either side of the gossip round."""

    grads: Tree
    update: Tree
    params: Tree
    params_pre_mix: Tree
    params_post_mix: Optional[Tree] = None

    def replace(self, **kw) -> "StepVars":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Stage:
    """A named (init, apply) transform stage.  ``meta`` is the fusion
    descriptor (``{"kind": ..., <static coefficients>}``) the fused
    executor pattern-matches on; stages without one always run unfused."""

    name: str
    init: Callable[[Tree], Optional[Tree]]
    apply: Callable[[StepCtx, StepVars, dict], tuple[StepVars, dict]]
    meta: Optional[dict] = None


def chain(*stages: Stage) -> tuple[Stage, ...]:
    """Validate and freeze a stage sequence (names must be unique)."""
    names = [s.name for s in stages]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate stage names in chain: {names}")
    return tuple(stages)


def chain_init(stages: tuple[Stage, ...], params: Tree) -> dict:
    """State dict for a chain; stateless stages contribute no entry."""
    out = {}
    for s in stages:
        st = s.init(params)
        if st is not None:
            out[s.name] = st
    return out


def chain_apply(stages: tuple[Stage, ...], ctx: StepCtx, sv: StepVars,
                states: dict, *, fused: str = "off") -> tuple[StepVars, dict]:
    """Run the chain, through the fused kernels where ``fused`` resolves
    on (see the module docstring).  Fusion never changes which stages run."""
    if _fused_enabled(fused, tree_leaves(sv.params)[0].device):
        return _chain_apply_fused(stages, ctx, sv, states)
    states = dict(states)
    for s in stages:
        sv, states = s.apply(ctx, sv, states)
    return sv, states


def _fused_enabled(fused: str, device) -> bool:
    if fused not in FUSED_MODES:
        raise ValueError(
            f"fused must be one of {', '.join(map(repr, FUSED_MODES))}; "
            f"got {fused!r}")
    if fused == "auto":
        return torch.device(device).type == "cuda"
    return fused != "off"


def _stateless(name: str, fn, *, meta: Optional[dict] = None) -> Stage:
    return Stage(name=name, init=lambda params: None, apply=fn, meta=meta)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def weight_decay(wd: float, *, name: str = "weight_decay") -> Stage:
    """Coupled L2 added to the raw gradient before any momentum logic."""

    def apply(ctx, sv, states):
        if not wd:
            return sv, states
        g = tree_map(lambda g_, p: g_ + wd * p, sv.update, sv.params_pre_mix)
        return sv.replace(update=g, grads=g), states

    return _stateless(name, apply,
                      meta={"kind": "weight_decay", "wd": float(wd)})


def heavyball(beta: float, *, nesterov: bool = False,
              seed_from: str | None = None,
              name: str = "heavyball") -> Stage:
    """HeavyBall / Nesterov momentum on the incoming update.  ``seed_from``
    re-seeds the buffer each step from another stage's ``m_hat`` (the
    quasi-global pattern, Alg. 1 line 5) instead of keeping local state."""

    def init(params):
        return None if seed_from else {"m": _zeros_like(params)}

    def apply(ctx, sv, states):
        m_prev = (states[seed_from]["m_hat"] if seed_from
                  else states[name]["m"])
        m = _axpy(beta, m_prev, sv.update)
        upd = _axpy(beta, m, sv.update) if nesterov else m
        sv = sv.replace(update=upd)
        if seed_from:
            return sv, states
        return sv, {**states, name: {"m": m}}

    return Stage(name=name, init=init, apply=apply,
                 meta={"kind": "heavyball", "beta": float(beta),
                       "nesterov": bool(nesterov), "seed_from": seed_from})


def qhm_momentum(beta: float, mu: float, *, name: str = "qhm") -> Stage:
    """Quasi-Hyperbolic momentum, the exact single-worker reduction of
    QG-DSGDm (App. B.3.1): with beta_hat = mu + (1-mu)*beta,

        m <- beta_hat m + g ;  upd = (1 - mu/beta_hat) m + (mu/beta_hat) g
    """
    beta_hat = mu + (1.0 - mu) * beta
    c1 = 1.0 - mu / beta_hat
    c2 = mu / beta_hat

    def init(params):
        return {"m": _zeros_like(params)}

    def apply(ctx, sv, states):
        m = _axpy(beta_hat, states[name]["m"], sv.update)
        upd = tree_map(lambda mm, gg: c1 * mm + c2 * gg, m, sv.update)
        return sv.replace(update=upd), {**states, name: {"m": m}}

    return Stage(name=name, init=init, apply=apply)


def adam_scale(beta1: float, beta2: float, eps: float, *,
               seed_from: str | None = None, name: str = "adam") -> Stage:
    """Adam moment update and preconditioned direction, no bias correction
    (the paper's decentralized Adam baselines, Table 6).  ``seed_from``
    reads the moments from a quasi-global buffer stage (Alg. 2) instead of
    local state, as :func:`heavyball` does."""

    def init(params):
        if seed_from:
            return None
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    def apply(ctx, sv, states):
        if seed_from:
            m_prev = states[seed_from]["m_hat"]
            v_prev = states[seed_from]["v_hat"]
        else:
            m_prev = states[name]["m"]
            v_prev = states[name]["v"]
        g = sv.update
        m = _lerp(beta1, m_prev, g)
        v = tree_map(lambda vv, gg: beta2 * vv + (1 - beta2) * gg * gg,
                     v_prev, g)
        upd = tree_map(lambda mm, vv: mm / (torch.sqrt(vv) + eps), m, v)
        sv = sv.replace(update=upd)
        if seed_from:
            return sv, states
        return sv, {**states, name: {"m": m, "v": v}}

    return Stage(name=name, init=init, apply=apply)


def _counter(params) -> torch.Tensor:
    """A stage's own 0-d int32 step counter, on the params' device."""
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def grad_track(*, name: str = "grad_track") -> Stage:
    """Gossip-tracking of the incoming update's global average:

        y^t = W y^{t-1} + u^t - u^{t-1}        (y^0 = u^0)

    Right after ``weight_decay`` this is gradient tracking (Table 2); after
    a momentum stage it tracks the momentum update itself (Global Update
    Tracking).  One ``mix_fn`` call, before the params mix site."""

    def init(params):
        return {"y": _zeros_like(params), "prev_u": _zeros_like(params),
                "t": _counter(params)}

    def apply(ctx, sv, states):
        st = states[name]
        first = st["t"] == 0
        u = sv.update
        y_mixed = ctx.mix_fn(ctx.w, st["y"])
        y = tree_map(lambda ym, uu, pu: torch.where(first, uu, ym + uu - pu),
                     y_mixed, u, st["prev_u"])
        new = {"y": y, "prev_u": u, "t": st["t"] + 1}
        return sv.replace(update=y), {**states, name: new}

    return Stage(name=name, init=init, apply=apply)


def d2_correction(*, plus: bool = False, name: str = "d2") -> Stage:
    """D^2 (Tang et al. 2018b) correction of the update:

        u <- (x^{t-1} - x^t) * scale / eta + g^t - g^{t-1}

    (plain g on the first step).  ``plus`` rescales the model-difference
    term by eta_t / eta_{t-1}, the paper's D^2_+ lr-decay fix (footnote
    9).  ``prev_lr`` is kept on the device."""

    def init(params):
        leaf = tree_leaves(params)[0]
        return {"prev_x": tree_map(torch.clone, params),
                "prev_g": _zeros_like(params),
                "prev_lr": torch.zeros((), dtype=torch.float32,
                                       device=leaf.device),
                "t": _counter(params)}

    def apply(ctx, sv, states):
        st = states[name]
        eta = ctx.lr
        first = st["t"] == 0
        prev_lr = torch.where(first, eta, st["prev_lr"])
        scale = (eta / prev_lr) if plus else 1.0
        u = sv.update
        corr = tree_map(
            lambda xp, x, g, gp: torch.where(
                first, g, scale * (xp - x) / eta + g - gp),
            st["prev_x"], sv.params_pre_mix, u, st["prev_g"])
        new = {"prev_x": sv.params_pre_mix, "prev_g": u,
               "prev_lr": eta.to(torch.float32).reshape(()),
               "t": st["t"] + 1}
        return sv.replace(update=corr), {**states, name: new}

    return Stage(name=name, init=init, apply=apply)


def gossip_mix(*, name: str = "gossip_mix") -> Stage:
    """The mix point: the local half step x - eta*u, then one gossip round
    through ``ctx.mix_fn``.  Records ``params_post_mix``."""

    def apply(ctx, sv, states):
        half = _axpy(-ctx.lr, sv.update, sv.params)
        mixed = ctx.mix_fn(ctx.w, half)
        return sv.replace(params=mixed, params_post_mix=mixed), states

    return _stateless(name, apply, meta={"kind": "gossip_mix"})


def descent(*, name: str = "descent") -> Stage:
    """Local step x - eta*u with no gossip round."""

    def apply(ctx, sv, states):
        new = _axpy(-ctx.lr, sv.update, sv.params)
        return sv.replace(params=new, params_post_mix=new), states

    return _stateless(name, apply)


def _refresh_gate(t, tau: int) -> torch.Tensor:
    """Alg. 3: the buffer refreshes on steps with (t+1) % tau == 0, as a
    fp32 [1] tensor on ``t``'s device (1.0 every step for tau == 1)."""
    if tau > 1:
        return ((t + 1) % tau == 0).to(torch.float32).reshape(1)
    return torch.ones(1, dtype=torch.float32, device=t.device)


def qg_buffer(mu: float, *, tau: int = 1, name: str = "qg_buffer") -> Stage:
    """Quasi-global momentum buffer (Alg. 1 lines 8-9):

        d     = (x_pre - x_post) / eta
        m_hat <- mu * m_hat + (1 - mu) * d

    ``tau > 1`` refreshes only on steps with (t+1) % tau == 0 (Alg. 3).
    Pair with ``heavyball(seed_from=<this name>)`` before the mix point.
    """

    def init(params):
        return {"m_hat": _zeros_like(params)}

    def apply(ctx, sv, states):
        m_hat = states[name]["m_hat"]
        d = _scale(torch.reciprocal(ctx.lr),
                   _sub(sv.params_pre_mix, sv.params_post_mix))
        new_m_hat = _lerp(mu, m_hat, d)
        if tau > 1:
            refresh = _refresh_gate(ctx.t, tau) != 0
            new_m_hat = tree_map(
                lambda new, old: torch.where(refresh, new, old),
                new_m_hat, m_hat)
        return sv, {**states, name: {"m_hat": new_m_hat}}

    return Stage(name=name, init=init, apply=apply,
                 meta={"kind": "qg_buffer", "mu": float(mu),
                       "tau": int(tau)})


def qg_adam_buffer(beta1: float, beta2: float, *,
                   name: str = "qg_adam") -> Stage:
    """Quasi-global Adam buffers (Alg. 2 lines 8-10): refresh both moments
    from the per-node L2-normalized model difference d_hat after the gossip
    round.  The squared norm sums the leaves in tree order, as the
    reference does.  Pair with ``adam_scale(seed_from=<this name>)``."""

    def init(params):
        return {"m_hat": _zeros_like(params), "v_hat": _zeros_like(params)}

    def apply(ctx, sv, states):
        st = states[name]
        d = _sub(sv.params_pre_mix, sv.params_post_mix)
        flat = tree_leaves(d)
        n_nodes = flat[0].shape[0]
        sq = sum(torch.sum(l.reshape(n_nodes, -1).to(torch.float32) ** 2,
                           dim=-1) for l in flat)
        inv_norm = 1.0 / (torch.sqrt(sq) + 1e-12)  # [n]

        def _nrm(leaf):
            bshape = (n_nodes,) + (1,) * (leaf.dim() - 1)
            return leaf * inv_norm.reshape(bshape).to(leaf.dtype)

        d_hat = tree_map(_nrm, d)
        m_hat = _lerp(beta1, st["m_hat"], d_hat)
        v_hat = tree_map(lambda vv, dd: beta2 * vv + (1 - beta2) * dd * dd,
                         st["v_hat"], d_hat)
        return sv, {**states, name: {"m_hat": m_hat, "v_hat": v_hat}}

    return Stage(name=name, init=init, apply=apply)


def dmsgd_buffer(beta: float, mu: float, *, option: int = 2,
                 name: str = "dmsgd_buffer") -> Stage:
    """DMSGD re-organized buffer (Balu et al. 2020, Alg. 7/8).  Option II:

        m_hat <- mu * (beta m_hat + g) + (1 - mu) * (x_pre - x_post)/eta

    Option I also replays the previous step's quantities (App. B.2).  The
    ``beta m_hat + g`` term is the incoming update of the paired
    ``heavyball(seed_from=<this name>)`` stage."""

    def init(params):
        z = _zeros_like(params)
        if option == 1:
            return {"m_hat": z, "prev_m_hat": z, "prev_g": z,
                    "prev_x": tree_map(torch.clone, params)}
        return {"m_hat": z}

    def apply(ctx, sv, states):
        st = states[name]
        eta = ctx.lr
        local = sv.update  # beta * m_hat + g from the seeded heavyball
        d = _scale(torch.reciprocal(eta),
                   _sub(sv.params_pre_mix, sv.params_post_mix))
        if option == 2:
            return sv, {**states, name: {"m_hat": _lerp(mu, local, d)}}
        inner = tree_map(
            lambda loc, xp, x, pm, pg: loc + (xp - x) / eta
            - beta * pm - pg,
            local, st["prev_x"], sv.params_pre_mix, st["prev_m_hat"],
            st["prev_g"])
        new = {"m_hat": _lerp(mu, inner, d), "prev_m_hat": st["m_hat"],
               "prev_g": sv.grads, "prev_x": sv.params_pre_mix}
        return sv, {**states, name: new}

    return Stage(name=name, init=init, apply=apply)


def slow_outer(slow_beta: float, slow_alpha: float, tau: int, *,
               base: str = "heavyball", name: str = "slow_outer") -> Stage:
    """SlowMo outer loop (Wang et al. 2020c, Alg. 5): every ``tau`` steps
    average the model over all nodes, apply slow momentum on the outer
    iterates and reset the ``base`` momentum stage's buffer.  A write into
    another stage's state, so it is chained after that stage.  The outer
    step is a device gate, ``(t+1) % tau == 0``, applied by
    ``torch.where``."""

    def init(params):
        return {"slow_m": _zeros_like(params),
                "anchor": tree_map(torch.clone, params)}

    def apply(ctx, sv, states):
        st = states[name]
        eta = ctx.lr
        do_outer = (ctx.t + 1) % tau == 0
        n = tree_leaves(sv.params)[0].shape[0]
        avg = tree_map(lambda a: a.expand((n,) + a.shape[1:]),
                       gossip.node_mean(sv.params, mesh=ctx.mesh))
        slow_m_new = tree_map(
            lambda sm, x0, xt: slow_beta * sm + (x0 - xt) / eta,
            st["slow_m"], st["anchor"], avg)
        outer = tree_map(lambda x0, sm: x0 - slow_alpha * eta * sm,
                         st["anchor"], slow_m_new)

        def sel(a, b):
            return tree_map(lambda x, y: torch.where(do_outer, x, y), a, b)

        out_params = sel(outer, sv.params)
        base_m = states[base]["m"]
        new_states = {
            **states,
            base: {**states[base], "m": sel(_zeros_like(base_m), base_m)},
            name: {"slow_m": sel(slow_m_new, st["slow_m"]),
                   "anchor": sel(outer, st["anchor"])},
        }
        return sv.replace(params=out_params), new_states

    return Stage(name=name, init=init, apply=apply)


def buffer_sync(target: str = "heavyball", *, mode: str = "ring",
                name: str = "buffer_sync") -> Stage:
    """Gossip another stage's momentum buffer after the params mix (Table 5
    'extra communication' rows): ``mode='ring'`` mixes with the same W
    through ``mix_fn`` (a second compressed-comm site), ``mode='complete'``
    averages it globally every step, through ``mix_fn`` too, with the 1/n
    matrix."""

    def apply(ctx, sv, states):
        m = states[target]["m"]
        if mode == "ring":
            m = ctx.mix_fn(ctx.w, m)
        elif mode == "complete":
            leaf = tree_leaves(m)[0]
            n = ctx.n_nodes or leaf.shape[0]
            m = ctx.mix_fn(torch.full((n, n), 1.0 / n, dtype=torch.float32,
                                      device=leaf.device), m)
        else:
            raise ValueError(f"unknown buffer_sync mode {mode!r}")
        return sv, {**states, target: {**states[target], "m": m}}

    return _stateless(name, apply)


# ---------------------------------------------------------------------------
# stage-factory registry (serializable chains: OptimSpec.stages)
# ---------------------------------------------------------------------------

STAGES: dict[str, Callable[..., Stage]] = {
    "weight_decay": weight_decay,
    "heavyball": heavyball,
    "qhm_momentum": qhm_momentum,
    "adam_scale": adam_scale,
    "gossip_mix": gossip_mix,
    "descent": descent,
    "qg_buffer": qg_buffer,
    "qg_adam_buffer": qg_adam_buffer,
    "dmsgd_buffer": dmsgd_buffer,
    "grad_track": grad_track,
    "d2_correction": d2_correction,
    "slow_outer": slow_outer,
    "buffer_sync": buffer_sync,
}


def make_stage(name: str, /, **kwargs) -> Stage:
    """Build one registered stage from its factory name and kwargs, the
    serializable form of an ``OptimSpec.stages`` chain."""
    if name not in STAGES:
        raise ValueError(
            f"unknown transform stage {name!r}; have {sorted(STAGES)}")
    try:
        return STAGES[name](**kwargs)
    except TypeError as e:
        raise ValueError(
            f"bad kwargs for stage {name!r}: {e}") from None


# ---------------------------------------------------------------------------
# fused execution (packed one-pass kernels)
# ---------------------------------------------------------------------------
#
# The reference's fusion boundary is the mix site: gossip needs the
# per-node tree, so its fused segments cover what lies between mix sites:
#
#   pre-mix   [weight_decay?] heavyball gossip_mix   -> fused_halfstep
#   post-mix  qg_buffer                              -> fused_qg_buffer
#
# Each packs the node-stacked trees into one contiguous fp32 buffer per role
# and streams them once; the gossip exchange runs between them on the
# unpacked tree through ``ctx.mix_fn``.  The dense mix W @ x mixes along the
# node axis only, so where ``ctx.mix_fn`` is ``gossip.mix_dense`` and the
# tree has at most ``qg_update.STEP_MAX_NODES`` nodes, the whole segment
# (the pre-mix one, and the qg_buffer that seeds its heavyball, if any) is
# one ``qg_step`` launch instead, with the mix inside the kernel and
# nothing packed (``_match_step`` decides, from the chain and n alone).
# Where ``ctx.mix_fn`` is a compressed round (``comm/choco.py``'s
# ``CompressedMix``) on the dense mix with the kernel compressors, the
# segment runs ``fused_halfstep``, the round's compress half, then the rest
# of the round and the ``qg_buffer`` after it in one ``choco_exchange``
# launch (``_match_exchange``).  The warm-start capture, any other mix hook
# and more nodes keep the two-kernel path.  Segments that match none of
# these run unfused: the same stages, just more passes.  A matched segment
# that cannot take its kernel (non-fp32 leaves, params rewritten by an
# earlier stage) runs unfused only on CPU tensors; on a device it raises, so
# a kernel is never silently replaced by its plain version.

#: stage kinds that may follow a fused gossip_mix: they read only
#: params_pre_mix/params_post_mix and their own state, never sv.update or
#: sv.grads (which the fused pass leaves stale)
_FUSED_TRAILING = ("qg_buffer",)


def _meta_kind(s: Stage) -> Optional[str]:
    return (s.meta or {}).get("kind")


def _non_f32(**trees) -> Optional[str]:
    """Why the named trees cannot be packed for a kernel (the first leaf
    that is not fp32), or None."""
    for role, t in trees.items():
        for i, l in enumerate(tree_leaves(t)):
            if l.dtype != torch.float32:
                return (f"{role} leaf {tree_paths(t)[i]!r} is {l.dtype}, "
                        "not float32")
    return None


def _unfused_or_raise(stage: Stage, sv: StepVars, why: str) -> None:
    """Allow the stage-by-stage fall-through for CPU tensors only."""
    dev = tree_leaves(sv.params)[0].device
    if dev.type != "cpu":
        raise TypeError(f"fused chain on {dev}: stage {stage.name!r} "
                        f"matches a kernel but cannot take it: {why}")


def _match_halfstep(stages: tuple[Stage, ...], i: int):
    """Match ``[weight_decay?] heavyball gossip_mix`` at ``stages[i:]`` with
    only fusion-safe trailing stages.  Returns (wd, heavyball_stage,
    n_consumed) or None."""
    j, wd = i, 0.0
    if j < len(stages) and _meta_kind(stages[j]) == "weight_decay":
        wd = stages[j].meta["wd"]
        j += 1
    if j >= len(stages) or _meta_kind(stages[j]) != "heavyball":
        return None
    hb = stages[j]
    j += 1
    if j >= len(stages) or _meta_kind(stages[j]) != "gossip_mix":
        return None
    j += 1
    if any(_meta_kind(s) not in _FUSED_TRAILING for s in stages[j:]):
        return None
    return wd, hb, j - i


def _match_segment(stages: tuple[Stage, ...], i: int):
    """Match ``[weight_decay?] heavyball gossip_mix`` at ``stages[i:]``,
    ending the chain (DSGDm) or followed only by the ``qg_buffer`` that
    seeds the heavyball (QG): the segment one ``qg_step`` or
    ``choco_exchange`` launch takes.  Returns (wd, heavyball_stage,
    qg_buffer_stage or None, n_consumed) or None."""
    seg = _match_halfstep(stages, i)
    if seg is None:
        return None
    wd, hb, consumed = seg
    rest = stages[i + consumed:]
    seed = hb.meta["seed_from"]
    if seed is None and not rest:
        return wd, hb, None, consumed
    if (seed is not None and len(rest) == 1 and rest[0].name == seed
            and _meta_kind(rest[0]) == "qg_buffer"):
        return wd, hb, rest[0], consumed + 1
    return None


def _match_step(stages: tuple[Stage, ...], i: int, mix_fn, n: int):
    """:func:`_match_segment` where ``mix_fn`` is the dense mix and ``n <=
    STEP_MAX_NODES``: the segment one ``qg_step`` launch takes.  Else None,
    and the segment takes ``fused_halfstep``, ``mix_fn`` and
    ``fused_qg_buffer``."""
    if mix_fn is not gossip.mix_dense or n > _kqg.STEP_MAX_NODES:
        return None
    return _match_segment(stages, i)


def _match_exchange(stages: tuple[Stage, ...], i: int, mix_fn, n: int):
    """:func:`_match_segment` where ``mix_fn`` is a compressed round
    (``CompressedMix``) with the kernel compressors (backend 'pallas') on
    the dense mix (``mix_impl`` None or ``gossip.mix_dense``) and ``n <=
    STEP_MAX_NODES``: the segment that takes ``fused_halfstep``, the
    round's compress half and one ``choco_exchange`` launch.  Else None."""
    if (not isinstance(mix_fn, CompressedMix)
            or mix_fn.comm.compressor.backend != "pallas"
            or mix_fn.mix_impl not in (None, gossip.mix_dense)
            or n > _kqg.STEP_MAX_NODES):
        return None
    return _match_segment(stages, i)


def _apply_qg_step(ctx, sv, states, wd, hb, qg, m_prev):
    """weight_decay + heavyball + the dense gossip round (+ the QG refresh
    of ``qg``) of every leaf in one ``qg_step`` launch."""
    hbm = hb.meta
    xs, treedef = tree_flatten(sv.params)
    refresh = mu = None
    if qg is not None:
        refresh = _refresh_gate(ctx.t, qg.meta["tau"])
        mu = qg.meta["mu"]
    x_new, m_out = ops.qg_step(
        xs, tree_leaves(m_prev), tree_leaves(sv.update),
        ctx.w, ctx.lr, refresh, beta=hbm["beta"], wd=wd,
        nesterov=hbm["nesterov"], mu=mu)
    mixed = tree_unflatten(treedef, x_new)
    m_new = tree_unflatten(treedef, m_out)
    states = {**states, **({qg.name: {"m_hat": m_new}} if qg is not None
                           else {hb.name: {"m": m_new}})}
    return sv.replace(params=mixed, params_post_mix=mixed), states


def _halfstep(ctx, sv, states, wd, hb, m_prev):
    """weight_decay + heavyball + the gossip half step in one packed pass:
    ``(half, states)``, the half step unpacked (views, no copy) and, for
    stateful momentum, the new buffer in ``states``."""
    hbm = hb.meta
    spec = _kp.plan_pack(sv.params)
    x = _kp.pack(spec, sv.params)
    m = _kp.pack(spec, m_prev)
    g = _kp.pack(spec, sv.update)
    emit_m = hbm["seed_from"] is None
    out = ops.fused_halfstep(x, m, g, ctx.lr, beta=hbm["beta"], wd=wd,
                             nesterov=hbm["nesterov"], emit_m=emit_m)
    if emit_m:
        half_buf, m_buf = out
        states = {**states, hb.name: {"m": _kp.unpack(spec, m_buf)}}
    else:
        half_buf = out  # seeded momentum: the local buffer is discarded
    return _kp.unpack(spec, half_buf), states


def _apply_fused_halfstep(ctx, sv, states, wd, hb, m_prev):
    """:func:`_halfstep`, then the gossip exchange on the unpacked tree."""
    half, states = _halfstep(ctx, sv, states, wd, hb, m_prev)
    mixed = ctx.mix_fn(ctx.w, half)
    return sv.replace(params=mixed, params_post_mix=mixed), states


def _apply_exchange(ctx, sv, states, wd, hb, qg, m_prev):
    """:func:`_halfstep`, then the compressed round on it (and the QG
    refresh of ``qg``) through ``ctx.mix_fn.exchange``: the compress half
    and one ``choco_exchange`` launch."""
    half, states = _halfstep(ctx, sv, states, wd, hb, m_prev)
    qg_kw = {} if qg is None else dict(
        x_pre=sv.params_pre_mix, m_hat=m_prev, eta=ctx.lr,
        refresh=_refresh_gate(ctx.t, qg.meta["tau"]), mu=qg.meta["mu"])
    mixed, m_new = ctx.mix_fn.exchange(ctx.w, half, **qg_kw)
    if qg is not None:
        states = {**states, qg.name: {"m_hat": m_new}}
    return sv.replace(params=mixed, params_post_mix=mixed), states


def _apply_fused_qg_buffer(ctx, sv, states, stage):
    spec = _kp.plan_pack(sv.params_pre_mix)
    pre = _kp.pack(spec, sv.params_pre_mix)
    post = _kp.pack(spec, sv.params_post_mix)
    m = _kp.pack(spec, states[stage.name]["m_hat"])
    new = ops.fused_qg_buffer(pre, post, m, ctx.lr,
                              _refresh_gate(ctx.t, stage.meta["tau"]),
                              mu=stage.meta["mu"])
    return sv, {**states, stage.name: {"m_hat": _kp.unpack(spec, new)}}


def _chain_apply_fused(stages, ctx, sv, states):
    states = dict(states)
    n = tree_leaves(sv.params)[0].shape[0]
    i = 0
    while i < len(stages):
        s = stages[i]
        step = _match_step(stages, i, ctx.mix_fn, n)
        exchange = _match_exchange(stages, i, ctx.mix_fn, n)
        seg = _match_halfstep(stages, i)
        if seg is not None:
            wd, hb, consumed = seg
            hbm = hb.meta
            m_prev = (states[hbm["seed_from"]]["m_hat"]
                      if hbm["seed_from"] else states[hb.name]["m"])
            # an earlier stage rewriting params would desync the weight-decay
            # read (params_pre_mix) from the half-step base (params): never
            # fuse the wrong expression
            why = ("params were rewritten by an earlier stage"
                   if sv.params is not sv.params_pre_mix else
                   _non_f32(params=sv.params, update=sv.update,
                            momentum=m_prev))
            if why is None and step is not None:
                sv, states = _apply_qg_step(ctx, sv, states, wd, hb,
                                            step[2], m_prev)
                i += step[3]
                continue
            if why is None and exchange is not None:
                sv, states = _apply_exchange(ctx, sv, states, wd, hb,
                                             exchange[2], m_prev)
                i += exchange[3]
                continue
            if why is None:
                sv, states = _apply_fused_halfstep(
                    ctx, sv, states, wd, hb, m_prev)
                i += consumed
                continue
            _unfused_or_raise(hb, sv, why)
        elif _meta_kind(s) == "qg_buffer":
            why = ("no gossip_mix or descent precedes it"
                   if sv.params_post_mix is None else
                   _non_f32(params_pre_mix=sv.params_pre_mix,
                            params_post_mix=sv.params_post_mix,
                            m_hat=states[s.name]["m_hat"]))
            if why is None:
                sv, states = _apply_fused_qg_buffer(ctx, sv, states, s)
                i += 1
                continue
            _unfused_or_raise(s, sv, why)
        sv, states = s.apply(ctx, sv, states)
        i += 1
    return sv, states


# ---------------------------------------------------------------------------
# analytic traffic model (bytes each optimizer step moves)
# ---------------------------------------------------------------------------

#: streaming passes (reads + writes of one n-element fp32 array) per
#: unfused stage, by fusion kind.  The gossip exchange itself is excluded
#: everywhere: it is identical fused or not.
_PASSES_BY_KIND = {
    "weight_decay": lambda m: 3 if m["wd"] else 0,
    "heavyball": lambda m: 6 if m["nesterov"] else 3,
    "gossip_mix": lambda m: 3,
    "qg_buffer": lambda m: 8 + (3 if m["tau"] > 1 else 0),
}


#: passes by stage name for the stages without a fusion kind (the
#: reference's figures; informational: no kernel takes these stages)
_PASSES_BY_NAME = {
    "qhm": 6, "adam": 9, "grad_track": 4, "descent": 3, "d2": 4,
    "qg_adam": 12, "dmsgd_buffer": 8, "slow_outer": 9, "buffer_sync": 0,
}


def _stage_passes(s: Stage) -> int:
    """Passes of one unfused stage: by fusion kind, else by name, else 3
    (two reads, one write)."""
    kind = _meta_kind(s)
    if kind in _PASSES_BY_KIND:
        return _PASSES_BY_KIND[kind](s.meta)
    return _PASSES_BY_NAME.get(s.name, 3)


def chain_bytes_moved(stages: tuple[Stage, ...], n_elems: int, *,
                      fused: str = "off", device="cpu") -> int:
    """Analytic device-memory bytes per optimizer step for an
    ``n_elems``-parameter node-stacked model: each unfused stage re-reads
    its operands and writes one output; each fused segment streams every
    operand once.  Fused byte counts use the ``PACK_TILE``-padded length, as
    the reference charges them, so the numbers equal the JAX package's.
    ``device`` resolves ``fused='auto'``."""
    if not _fused_enabled(fused, device):
        return sum(_stage_passes(s) for s in stages) * n_elems * 4

    padded = max(_kp.PACK_TILE, -(-n_elems // _kp.PACK_TILE) * _kp.PACK_TILE)
    total = 0
    i = 0
    while i < len(stages):
        seg = _match_halfstep(stages, i)
        if seg is not None:
            _, hb, consumed = seg
            # 3 reads (x, m, g) + half write (+ m_new write if stateful)
            total += (4 if hb.meta["seed_from"] else 5) * padded * 4
            i += consumed
            continue
        s = stages[i]
        if _meta_kind(s) == "qg_buffer":
            # 3 reads (pre, post, m_hat) + 1 write
            total += 4 * padded * 4
            i += 1
            continue
        total += _stage_passes(s) * n_elems * 4
        i += 1
    return total
