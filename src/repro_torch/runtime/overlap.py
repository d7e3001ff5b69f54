"""Delayed (one-step-stale) gossip: ``overlap='delayed_1'``.

Port of ``repro/runtime/overlap.py`` (DESIGN.md §12).  A synchronous step
mixes the half-updated tree of this round, so the exchange waits for the
round's gradients.  The delayed mix exchanges the previous round's values
instead:

    mixed_i = (W_t @ sent)_i            # gossip of the stale buffer, posted
                                        # before this round's gradients
    out_i   = tree_i + 1/2 (mixed_i - sent_i)
    sent'_i = tree_i                    # next round's exchange

At t = 0 every node holds the broadcast x^0, so the correction is exactly
zero and the first step is the synchronous one.  The damping by 1/2 mixes
with the lazy matrix ``(I + W) / 2``, whose spectrum is nonnegative for
every doubly stochastic W: the undamped delayed recurrence diverges on any
W with a negative eigenvalue (ring-4 already has one), so ``DAMPING`` is a
stability requirement, not a tuning knob.  The delayed run is another
trajectory than the synchronous one; it is held against a delayed run.

Topology mix sites are told apart from other mix calls by the identity of
the ``w`` object, as every runtime's mix hook does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import tree_map

__all__ = ["OVERLAPS", "DAMPING", "capture_topology_mix_sites",
           "make_delayed_mix_fn"]

#: valid ``overlap=`` values: 'none' is the synchronous step, 'delayed_1'
#: the one-step-stale pipelined mix
OVERLAPS = ("none", "delayed_1")

#: delayed corrections apply through the lazy matrix (I + W) / 2
DAMPING = 0.5


def capture_topology_mix_sites(optimizer, params, w, *, lr: float = 0.1,
                               mesh=None) -> list:
    """The t = 0 exchange buffers: one tree a mix call site that contracts
    the topology matrix (``w`` by identity) on a zero-gradient first step
    at ``lr`` (0.1, as the reference's).  Sites that mix another matrix
    (``buffer_sync('complete')``'s 1/n average) stay synchronous and are
    skipped.  The step is the optimizer's own chain, so on CUDA tensors it
    launches the fused kernels once; ``mesh`` is the node axis of
    block-sharded ``params``."""
    targets: list = []

    def capturing_mix(w_, tree):
        if w_ is w:
            targets.append(tree)
        return tree

    opt = dataclasses.replace(optimizer, mix_fn=capturing_mix)
    with torch.no_grad():
        opt.step(params, tree_map(torch.zeros_like, params),
                 optimizer.init(params), w=w, lr=lr, t=0, mesh=mesh)
    if not targets:
        raise ValueError(
            "overlap='delayed_1' needs at least one topology mix site in "
            "the optimizer's transform chain (a gossip_mix / grad_track "
            "stage contracting the topology matrix); this chain has none")
    return targets


def make_delayed_mix_fn(sent_in: list, mixed: list, sent_out: list, *,
                        w_ref, fallback=None):
    """The ``mix_fn`` of a delayed step's finish stage.  Topology sites
    (``w is w_ref``) take, in call order, the launch stage's
    ``mixed[i] = W @ sent_in[i]`` (a ``finish()`` callable while its
    messages are in flight), apply ``tree + (mixed - sent) / 2`` and
    deposit ``tree`` in ``sent_out[i]``.  Other matrices go to ``fallback``
    (the runtime's synchronous mix hook) or, without one, the dense
    contraction."""
    from repro_torch.core import gossip

    counter = [0]

    def mix_fn(w, tree):
        if w is not w_ref:
            return (fallback or gossip.mix_dense)(w, tree)
        i = counter[0]
        counter[0] += 1
        sent, mx = sent_in[i], mixed[i]
        if callable(mx):
            mx = mx()
        sent_out[i] = tree
        return tree_map(lambda p, m, s: p + DAMPING * (m - s),
                        tree, mx, sent)

    return mix_fn
