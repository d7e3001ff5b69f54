"""CHOCO-style compressed gossip (Koloskova'19) behind the ``mix_fn`` hook.

Port of ``repro/comm/choco.py``.  Every optimizer mixes only through
``mix_fn(w, tree)`` (the ``gossip_mix`` stage of ``core/transforms.py``),
so compression behind that signature upgrades every chain without
per-algorithm changes.  Compressed gossip is stateful: each node keeps
public replica estimates ``x̂`` that advance by compressed innovations.

One CHOCO round at a *mix call site*:

    q      = C(x - x̂)               # compressed innovation
    x̂'     = x̂ + q                  # all replicas advance identically
    x_out  = x + gamma * (W - I) x̂'  # gossip on the public replicas

``x̂`` is an EF21 estimate (``error_feedback.ef21_update``).  With
``error_feedback=True`` the round is a DeepSqueeze-style EF14 value
exchange instead (see :meth:`CompressedGossip.mix_site`).

``capture_mix_targets`` discovers the call sites once at init: one
zero-gradient step whose mix hook records each site's tree, which is both
the site count and each site's warm start.  The trainer threads a list of
per-site states through its step: the :class:`CompressedMix` installed as
``mix_fn`` pops site i's state on the i-th call and deposits the new one.
``count_mix_sites`` counts the sites without arithmetic (meta tensors).

On the kernel path (``core/transforms.py``'s ``_match_exchange``) a round
on the dense mix does not go through the call: the fused chain takes the
compress half (:meth:`CompressedMix.compress`) and then runs the rest of
the round, and the QG refresh after it, in one ``choco_exchange`` launch
(:meth:`CompressedMix.exchange`).

Random draws (random-k, QSGD) come from one ``torch.Generator`` on the
tensors' device, site after site and leaf after leaf, where the reference
folds a per-step ``jax.random`` key per site and leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import gossip
from repro_torch.kernels import ops
from repro_torch.kernels import pack as _kp
from repro_torch.kernels import ref
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_paths, tree_unflatten

from . import error_feedback as ef
from .compressors import Compressor, Identity, make_compressor, tree_wire_bits

Tree = Any

__all__ = ["CompressedGossip", "CompressedMix", "capture_mix_targets",
           "count_mix_sites", "make_comm"]


def count_mix_sites(optimizer, params: Tree, w, *, lr: float = 0.1) -> int:
    """Number of times ``optimizer.step`` invokes its mix hook, found by a
    step over meta tensors (shapes only, no arithmetic, no kernel launch:
    the chain runs stage by stage, which calls the hook the same number of
    times as the fused chain)."""
    counter = [0]

    def counting_mix(w_, tree):
        counter[0] += 1
        return tree

    opt = dataclasses.replace(optimizer, mix_fn=counting_mix, fused="off")
    meta = tree_map(lambda p: torch.empty_like(p, device="meta"), params)
    with torch.no_grad():
        opt.step(meta, tree_map(torch.zeros_like, meta), opt.init(meta),
                 w=w, lr=lr, t=0)
    return counter[0]


def capture_mix_targets(optimizer, params: Tree, w, *,
                        lr: float = 0.1) -> list[Tree]:
    """The tree each mix call site receives on a zero-gradient first step
    at ``lr`` (0.1 as in the reference, whatever the run's lr): the t=0
    warm start per site.  A params-mixing site sees the half step from
    x^0; a buffer-mixing site sees its zero init.  The step is the
    optimizer's own chain, so on CUDA tensors it launches the fused kernels
    once."""
    targets: list[Tree] = []

    def capturing_mix(w_, tree):
        targets.append(tree)
        return tree

    opt = dataclasses.replace(optimizer, mix_fn=capturing_mix)
    with torch.no_grad():
        opt.step(params, tree_map(torch.zeros_like, params),
                 optimizer.init(params), w=w, lr=lr, t=0)
    return targets


@dataclasses.dataclass(frozen=True)
class CompressedGossip:
    """Compressed-gossip schedule: compressor + consensus step size gamma.

    ``gamma=None`` resolves to the smallest per-leaf
    ``compressor.default_gamma(d)`` of the tree.
    """

    compressor: Compressor = dataclasses.field(default_factory=Identity)
    gamma: float | None = None
    error_feedback: bool = False
    warm_start: bool = True

    # -- state ---------------------------------------------------------------
    def init_site(self, tree: Tree) -> dict:
        """Fresh site state.  CHOCO mode: replica estimates x̂, warm-started
        with the site's actual t=0 tree (every node starts from the same
        x^0, so x̂_0 = x^0 is known to all), or zeros.  EF mode: only the
        EF14 residual."""
        if self.error_feedback:
            return {"residual": ef.init_residual(tree)}
        if self.warm_start:
            return {"x_hat": tree_map(torch.clone, tree)}
        return {"x_hat": tree_map(torch.zeros_like, tree)}

    def init_state(self, optimizer, params: Tree, w) -> list[dict]:
        """One site state per mix call the optimizer makes per step, each
        warm-started with the tree that site mixes at t=0."""
        targets = capture_mix_targets(optimizer, params, w)
        return [self.init_site(t) for t in targets]

    # -- constants -----------------------------------------------------------
    def resolved_gamma(self, tree: Tree) -> float:
        if self.gamma is not None:
            return float(self.gamma)
        ds = [max(int(l.numel() // l.shape[0]), 1) for l in tree_leaves(tree)]
        if not ds:
            return 1.0
        return float(min(self.compressor.default_gamma(d) for d in ds))

    def wire_bits_per_site(self, tree: Tree) -> float:
        return tree_wire_bits(self.compressor, tree)

    # -- one compressed gossip round ------------------------------------------
    def mix_site(self, w, tree: Tree, site: dict, *, gen, gamma: float,
                 mix_impl=None, noise=None) -> tuple[Tree, dict]:
        """One compressed gossip round at this call site.

        CHOCO mode (default): EF21 replica tracking; the x̂ lag is the error
        memory, so no separate residual is stacked on top.

        EF mode: DeepSqueeze-style error-compensated value exchange: each
        node ships q = C(x + e), keeps e' = x + e - q, and gossips on the
        compressed values, x <- x + gamma * (W - I) q.

        ``gen`` feeds a compressor that draws (``noise``, per-leaf draws,
        replaces it); ``mix_impl(w, tree)`` is the inner gossip on the
        anchors, ``gossip.mix_dense`` by default.
        """
        if self.error_feedback:
            q, new_residual = ef.ef_compress(
                self.compressor, gen, tree, site["residual"], noise=noise)
            new_site = {"residual": new_residual}
            anchor = q
        else:
            new_x_hat, _ = ef.ef21_update(self.compressor, gen, tree,
                                          site["x_hat"], noise=noise)
            new_site = {"x_hat": new_x_hat}
            anchor = new_x_hat
        mixed = (mix_impl or gossip.mix_dense)(w, anchor)
        return self._decompress(tree, mixed, anchor, gamma), new_site

    def _decompress(self, tree, mixed, anchor, gamma):
        """Post-exchange correction x + gamma*(mixed - anchor).  With the
        kernel backend the trees are packed (``kernels/pack.py``, one
        ``torch.cat`` per tree) and streamed through ``gamma_correct`` in one
        pass; the 'jnp' path runs the plain expression leaf by leaf.  A leaf
        that is not fp32 cannot take the kernel: on CPU tensors the leaf
        path runs instead, on any other device it raises."""
        if self.compressor.backend == "pallas":
            leaves = tree_leaves(tree)
            bad = next((i for i, l in enumerate(leaves)
                        if l.dtype != torch.float32), None)
            if bad is None:
                spec = _kp.plan_pack(tree)
                out = ops.gamma_correct(
                    _kp.pack(spec, tree), _kp.pack(spec, mixed),
                    _kp.pack(spec, anchor), gamma=float(gamma))
                return _kp.unpack(spec, out)
            dev = leaves[0].device
            if dev.type != "cpu":
                raise TypeError(f"gamma_correct on {dev}: leaf "
                                f"{tree_paths(tree)[bad]!r} is "
                                f"{leaves[bad].dtype}, not float32: the "
                                "kernel cannot take it")
        return tree_map(lambda x, mh, h: ref.gamma_correct(x, mh, h,
                                                           gamma=gamma),
                        tree, mixed, anchor)

    # -- trainer hook --------------------------------------------------------
    def make_mix_fn(self, sites_in: list[dict], sites_out: list[dict], gen,
                    gamma: float, mix_impl=None) -> "CompressedMix":
        """The ``mix_fn`` hook of one step.  The i-th call consumes
        ``sites_in[i]`` and writes ``sites_out[i]``."""
        return CompressedMix(self, sites_in, sites_out, gen, gamma, mix_impl)


@dataclasses.dataclass
class CompressedMix:
    """The ``mix_fn`` hook of one step's compressed rounds: calling it runs
    the next site's round (:meth:`CompressedGossip.mix_site`) and records
    the site's new state in ``sites_out``.  ``compress`` and ``exchange``
    split that round for the fused chain, which runs its exchange half in
    one ``choco_exchange`` launch."""

    comm: CompressedGossip
    sites_in: list[dict]
    sites_out: list[dict]
    gen: Any
    gamma: float
    mix_impl: Any = None
    calls: int = 0

    def _next_site(self) -> int:
        i = self.calls
        self.calls += 1
        if i >= len(self.sites_in):
            raise RuntimeError(
                f"optimizer made {i + 1} mix calls but comm state has "
                f"{len(self.sites_in)} sites: re-init the trainer state")
        return i

    def __call__(self, w, tree: Tree) -> Tree:
        i = self._next_site()
        out, self.sites_out[i] = self.comm.mix_site(
            w, tree, self.sites_in[i], gen=self.gen, gamma=self.gamma,
            mix_impl=self.mix_impl)
        return out

    def compress(self, tree: Tree) -> tuple[int, Tree]:
        """The compress half of the next site's round on ``tree``: ``(i,
        q)``, the site's index and its message, ``ef21_innovation``'s
        ``C(tree - x_hat)`` (CHOCO) or ``ef_compress``'s ``C(tree + e)``
        (EF, whose new residual goes to ``sites_out[i]`` here).  It takes
        the site as a call would."""
        i = self._next_site()
        site = self.sites_in[i]
        if self.comm.error_feedback:
            q, residual = ef.ef_compress(self.comm.compressor, self.gen, tree,
                                         site["residual"])
            self.sites_out[i] = {"residual": residual}
            return i, q
        return i, ef.ef21_innovation(self.comm.compressor, self.gen, tree,
                                     site["x_hat"])

    def exchange(self, w, half: Tree, *, x_pre=None, m_hat=None, eta=None,
                 refresh=None, mu: float | None = None):
        """The next site's round on ``half`` with the dense mix, followed,
        ``mu`` given, by the QG refresh of ``m_hat`` from ``x_pre`` and the
        round's output: the compress half, then ``ops.choco_exchange`` (one
        launch on CUDA tensors), which also gives the site its new replicas
        (CHOCO).  Returns ``(x_out, m_hat_new or None)``."""
        i, q = self.compress(half)
        halves, treedef = tree_flatten(half)
        x_hat = (None if self.comm.error_feedback
                 else tree_leaves(self.sites_in[i]["x_hat"]))
        qg = {} if mu is None else dict(
            x_pres=tree_leaves(x_pre), m_hats=tree_leaves(m_hat), eta=eta,
            refresh=refresh, mu=mu)
        x_out, x_hat_new, m_out = ops.choco_exchange(
            halves, tree_leaves(q), w, gamma=float(self.gamma),
            x_hats=x_hat, **qg)
        if x_hat_new is not None:
            self.sites_out[i] = {"x_hat": tree_unflatten(treedef,
                                                         x_hat_new)}
        return (tree_unflatten(treedef, x_out),
                None if m_out is None else tree_unflatten(treedef, m_out))


def make_comm(spec: str, *, gamma: float | None = None,
              error_feedback: bool = False,
              backend: str = "jnp") -> CompressedGossip | None:
    """'dense'/''/None -> None (no comm wrapping); otherwise a
    CompressedGossip from a compressor spec string like 'topk:0.01'.

    Malformed specs raise ``ValueError`` listing the valid forms (see
    ``make_compressor``); ``gamma`` outside ``(0, 1]`` is rejected the same
    way.
    """
    if not spec or spec.lower() in ("dense", "none"):
        return None
    if gamma is not None and not 0.0 < gamma <= 1.0:
        raise ValueError(
            f"CHOCO consensus step size gamma must be in (0, 1], got "
            f"{gamma!r} (None = per-compressor default)")
    return CompressedGossip(
        compressor=make_compressor(spec, backend=backend), gamma=gamma,
        error_feedback=error_feedback)
