"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Port of ``repro/models/moe.py``: softmax routing in fp32, top-k with the
gates renormalised, per-expert capacity ``C = max(1, int(T*k/E * factor))``,
queue positions by a cumsum over the flattened (token, slot) stream,
overflow dropped, the serving ``token_mask`` kept out of the queues, the
arctic-style dense residual branch and the Switch balance loss.
``MoEConfig`` lives in ``configs/base.py``.

Where the port differs, and why:

* Top-k is a stable descending sort cut to k: among equal router
  probabilities the lower expert index comes first, on the CPU and the
  card alike, which is XLA's ``TopK`` rule (``jax.lax.top_k``);
  ``torch.topk`` states no order for ties.
* The combine is a gather, not a scatter-add: token ``t`` sums
  ``where(valid[t, j], gate[t, j] * ye[slot[t, j]], 0)`` over its k slots
  in rank order.  The reference adds each expert's output back with
  ``.at[tok].add``; on CUDA that is an atomic ``index_add_`` whose order
  changes from run to run, so greedy tokens at a near-tie could change
  between two identical runs.  The gather sums in another order than the
  reference's (a few ulps) and gives the same bits every run.
* Dropped slots go to the reference's sentinel entry ``E*C`` of an array
  of ``E*C + 1`` (in bounds), which is then discarded.

Every shape is fixed by ``x``'s (the capacity is a Python int) and every
op is out of place with no ``.item()``, so :func:`moe_ffn` runs under
``torch.func.vmap`` over the node axis (the training plugin) and on the
card with no host sync.  :func:`recording` totals the (token, slot) pairs
dropped for capacity, on the device, for a serving run to report, and can
keep each call's routing, so that two paths' routes can be compared.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from . import layers

__all__ = ["MoEConfig", "init_moe", "moe_ffn", "capacity", "recording"]

#: while :func:`recording` is open, what it records, else None
_RECORD: dict | None = None


def init_moe(gen, d_model: int, d_ff: int, cfg: MoEConfig, *, device,
             dtype=torch.float32) -> dict:
    """Router (fp32), the experts' SwiGLU weights ``[E, d, f]`` /
    ``[E, f, d]`` and, with ``dense_ff``, the dense residual MLP, at the
    reference's scales (``device="meta"`` builds the shapes only)."""
    e = cfg.n_experts
    s = 1.0 / d_model ** 0.5
    kw = dict(device=device, dtype=dtype)
    p = {"router": layers.dense_init(gen, d_model, e, device=device),
         "w_gate": layers.normal_init(gen, (e, d_model, d_ff), s, **kw),
         "w_up": layers.normal_init(gen, (e, d_model, d_ff), s, **kw),
         "w_down": layers.normal_init(gen, (e, d_ff, d_model),
                                      1.0 / d_ff ** 0.5, **kw)}
    if cfg.dense_ff:
        p["dense"] = layers.init_mlp(gen, d_model, cfg.dense_ff, **kw)
    return p


def capacity(n_tok: int, cfg: MoEConfig) -> int:
    """Queue length of each expert for a call over ``n_tok`` tokens (the
    physical count: a serving batch's masked rows count too)."""
    return max(1, int(n_tok * cfg.top_k / cfg.n_experts *
                      cfg.capacity_factor))


@contextlib.contextmanager
def recording(routes: bool = False):
    """Record the calls of :func:`moe_ffn` inside the block; yields a dict
    of device tensors (no host sync): ``"routed"`` and ``"dropped"``, the
    (token, slot) pairs routed (``token_mask`` rows only) and dropped for
    capacity, totalled; with ``routes``, ``"routes"``, one entry a call:
    its ``expert_idx`` [T, k], ``valid`` [T, k] and ``gap`` [T], the least
    difference of two neighbours among each token's first k+1 router
    probabilities, sorted (how near its ranked top-k is to a tie).  Not
    under ``vmap``."""
    global _RECORD
    prev, _RECORD = _RECORD, {"routes": [] if routes else None}
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _record(rep, valid, expert_idx, sorted_probs) -> None:
    routed = valid.new_ones(()).long() * valid.numel() if rep is None \
        else rep.sum()
    dropped = routed - valid.sum()
    for key, n in (("routed", routed), ("dropped", dropped)):
        _RECORD[key] = _RECORD[key] + n if key in _RECORD else n
    if _RECORD["routes"] is not None:
        top = sorted_probs[:, :expert_idx.shape[1] + 1]
        gap = (top[:, :-1] - top[:, 1:]).amin(dim=-1)
        _RECORD["routes"].append({"expert_idx": expert_idx,
                                  "valid": valid.reshape(expert_idx.shape),
                                  "gap": gap})


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
            token_mask=None, split=None, rows=None):
    """x: [B, S, d] -> (y [B, S, d], aux_loss 0-d fp32).

    ``token_mask`` [B, S] bool (serving): masked-out tokens take no queue
    position, give exactly zero output and stay out of the balance loss,
    so whatever sits in a batch's padded rows cannot change the valid
    tokens' outputs.

    ``split`` (``launch/sharding.Split``, the experts over 'model'): the
    expert stacks are the rank's ``E / M`` experts, every rank routes all
    of ``x``'s tokens (so the capacity and the routes are the unsplit
    ones), runs its experts' queues and returns its partial sums of ``y``
    (the slots of its experts), which the caller sums over 'model'.

    ``rows`` (``launch/sharding.Rows``): ``x`` is the rank's rows of a
    node's batch, R ranks' equal shares of its token stream in row order,
    and the queues are the node's: the capacity of the node's ``R T``
    tokens, and each (token, slot) queued after the earlier ranks' entries
    of its expert (their per-expert counts, one all-gather of an ``[E]``
    vector).  The rank runs the slots of its own entries, at most ``min(C,
    T)`` an expert since a token picks an expert once (``C`` where R is 1,
    ``mesh=None``'s shape), so the drops are the node's.  The balance
    loss's ``me`` and ``ce`` are the node's means, the ranks' shares
    summed (``Rows.sum``, whose backward sums the ranks' gradients, as the
    ranks' losses sum to the node's)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_tok = b * s
    tokens = x.reshape(n_tok, d)
    dev = x.device
    r = 1 if rows is None else rows.size
    if rows is not None and token_mask is not None:
        raise ValueError("moe_ffn: a serving token_mask and a node's rows "
                         "do not meet (the paged step takes no rows)")

    logits = tokens.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                        # [T, E]
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = srt.values[:, :k], srt.indices[:, :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    cap = capacity(n_tok * r, cfg)
    ql = cap if r == 1 else min(cap, n_tok)      # a rank's queue length
    experts = torch.arange(e, device=dev)
    flat_e = expert_idx.reshape(-1)                              # [T*k]
    onehot = (flat_e[:, None] == experts).long()                 # [T*k, E]
    rep = None
    if token_mask is not None:
        tmask = token_mask.reshape(-1)
        rep = tmask.repeat_interleave(k)                         # [T*k]
        onehot = onehot * rep[:, None].long()
    pos = (torch.cumsum(onehot, dim=0) - 1) * onehot
    flat_pos = pos.sum(dim=-1)
    queued = flat_pos
    if rows is not None:    # the node's queue: after the earlier ranks'
        queued = flat_pos + rows.before(onehot.sum(dim=0)).index_select(
            0, flat_e)
    valid = queued < cap
    if rep is not None:
        valid = valid & rep
    if _RECORD is not None:
        _record(rep, valid, expert_idx, srt.values)

    # per-expert queues [E*C (+ the sentinel)]: the token of each filled slot
    slot = torch.where(valid, flat_e * ql + flat_pos, e * ql)
    token_id = torch.arange(n_tok, device=dev).repeat_interleave(k)
    tok_for_slot = torch.zeros(e * ql + 1, dtype=torch.long,
                               device=dev).scatter(0, slot, token_id)[:-1]
    filled = torch.zeros(e * ql + 1, dtype=torch.bool, device=dev).scatter(
        0, slot, torch.ones_like(valid))[:-1]

    el, mine, xin, gates = e, valid, tokens, gate_vals
    if split is not None:   # this rank's experts: queue slots lo .. hi - 1
        el = e // split.size
        lo = split.index * el * ql
        tok_for_slot = tok_for_slot[lo:lo + el * ql]
        filled = filled[lo:lo + el * ql]
        mine = valid & (slot >= lo) & (slot < lo + el * ql)
        slot = torch.where(mine, slot - lo, el * ql)
        xin, gates = split.copy(tokens), split.copy(gate_vals)
    xe = xin.index_select(0, tok_for_slot)                       # [E*C, d]
    xe = torch.where(filled[:, None], xe, 0.0).reshape(el, ql, d)
    h = F.silu(torch.matmul(xe, params["w_gate"])) * torch.matmul(
        xe, params["w_up"])
    ye = torch.matmul(h, params["w_down"]).reshape(el * ql, d)  # [E*C, d]

    # combine by a gather, in rank order: deterministic on every device
    picked = torch.cat([ye, ye.new_zeros(1, d)]).index_select(0, slot)
    picked = picked.reshape(n_tok, k, d) * gates.to(ye.dtype)[..., None]
    picked = torch.where(mine.reshape(n_tok, k)[..., None], picked, 0.0)
    y = picked[:, 0]
    for j in range(1, k):
        y = y + picked[:, j]

    if cfg.dense_ff:
        dp = params["dense"]
        y = y + layers.swiglu(tokens, dp["gate"], dp["up"], dp["down"])

    # Switch-style load-balance loss
    top1 = (expert_idx[:, 0, None] == experts).float()           # [T, E]
    if token_mask is None:
        me = probs.mean(dim=0)
        ce = top1.mean(dim=0)
        if rows is not None:    # the node's means: the ranks' shares summed
            me, ce = rows.sum(me / r), rows.sum(ce / r)
    else:
        w = tmask.float()[:, None]
        denom = torch.clamp_min(w.sum(), 1.0)
        me = (probs * w).sum(dim=0) / denom
        ce = (top1 * w).sum(dim=0) / denom
    aux = cfg.aux_loss_coef * e * torch.sum(me * ce)
    return y.reshape(b, s, d), aux
