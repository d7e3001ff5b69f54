"""Execution-backend base: the one decentralized step, written once.

Port of ``repro/runtime/base.py``.  A :class:`Runtime` owns how the node
axis is laid out: the vmap backend keeps every node stacked on one device,
the sharded and hybrid backends (``sharded.py``, ``hybrid.py``) keep this
rank's block of ``b = n / d`` nodes over a ``torch.distributed`` node axis
(``self.mesh``).  All run the same step math, below, through a handful of
node-axis hooks (``_node_mean_scalar``, ``_node_sum_scalar``,
``_node_max_scalar``, ``_mix_impl``, ``_scenario_masks``); what the hooks
do not touch is shared verbatim.

The step is a three-stage pipeline (DESIGN.md §12):

    launch_mix  -- under ``overlap='delayed_1'``, post the gossip of the
                   one-step-stale exchange buffers ``state.mix_buf`` (over
                   ``torch.distributed``: the point-to-point messages);
    compute     -- per-node loss and gradient;
    finish_mix  -- the transform-stage chain: local update + gossip round,
                   through the backend's mix hook, a compressed round when
                   the trainer has comm, or under the overlap the delayed
                   consumer, which waits for the launch stage's messages and
                   applies ``tree + (W s - s) / 2``.

With ``collect`` a step also runs the trainer's telemetry collectors and
returns their scalars under the ``tm.`` prefix; without it, it is the
telemetry-free step.  Under a scenario (``repro_torch.scenario``) a step
takes the round's update and mix masks on the device: the gossip mixes
through the masks, and nodes outside the update mask hold params,
optimizer and model state exactly (``_hold_nodes``).

A step reads nothing back to the host: the lr, the step counter, the masks
and every metric stay on the device, and a chunk's metrics are fetched
once, when the loop records them.  A schedule that changes from step to
step picks its phase from the host step index the loops carry (``t``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import gossip
from repro_torch.telemetry.metrics import TM_PREFIX, CollectorCtx
from repro_torch.telemetry.trace import StepTimer, graph_span
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _hold_nodes(mask: torch.Tensor, new, old):
    """Per-node old-vs-new select for the scenario's hold: leaves whose
    leading axis is the mask's length are node-stacked, and take ``new``
    where ``mask`` is 1 and ``old`` where it is 0.  Other leaves take
    ``new``."""
    mb = mask.to(torch.bool)

    def sel(a, b):
        shape = getattr(a, "shape", ())
        if len(shape) >= 1 and shape[0] == mb.shape[0]:
            return torch.where(mb.reshape((shape[0],) + (1,) *
                                          (len(shape) - 1)), a, b)
        return a

    return tree_map(sel, new, old)


def _masked_mix(mix_mask: torch.Tensor):
    """The scenario's mix hook: dense gossip over the mixing matrix
    renormalized onto the nodes of ``mix_mask``."""
    return lambda w, tree: gossip.mix_dense(
        gossip.mask_renormalize(w, mix_mask), tree)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Runtime:
    """Base execution backend over the owning
    :class:`~repro_torch.train.trainer.DecentralizedTrainer`.  ``overlap``
    is ``'none'`` or ``'delayed_1'``; ``mesh`` the node axis of the
    sharded and hybrid backends (None: every node on this device)."""

    trainer: Any
    name: str = "base"
    overlap: str = "none"
    mesh: Any = None

    def __post_init__(self):
        self.gossip_timer = StepTimer()
        self._local_plan = None   # d = 1 plan of the vmap sparse mix

    # -- node-axis hooks (every node on this device) -------------------------
    @property
    def uses_host_t(self) -> bool:
        """Whether a step needs the host step index: a compiled schedule
        picks its phase from it."""
        return self.trainer._resolved.kind != "dense"

    def _node_mean_scalar(self, x):
        """Mean over the nodes of a per-node ``[n]`` quantity."""
        return torch.mean(x)

    def _node_sum_scalar(self, x):
        """``x`` already sums this device's nodes: the sum over all."""
        return x

    def _node_max_scalar(self, x):
        return torch.max(x)

    def _local_update_mask(self, u):
        """This backend's rows of the round's update mask (all of them
        here)."""
        return u

    def _mix_impl(self, w, t, mix_mask=None):
        """The mix hook to install (None keeps the optimizer's dense
        default).  ``mix_mask`` is the scenario's ``[n]`` mix mask (None:
        no scenario).  With a mesh (runtime='vmap' asked for explicitly)
        the compiled schedule runs as local gathers over the stack."""
        r = self.trainer._resolved
        if r.kind == "dense":
            return None if mix_mask is None else _masked_mix(mix_mask)
        if mix_mask is not None:
            raise ValueError(
                "scenario fault injection needs runtime='vmap' (dense "
                "gossip) or runtime='hybrid'")  # the trainer checks first
        if self._local_plan is None:
            sched = r.schedule or gossip.compile_gossip_schedule(
                self.trainer.topology)
            self._local_plan = gossip.compile_block_schedule(
                sched, 1).on_rank(0, self.trainer.device)
        return gossip.make_block_mix_fn(self._local_plan, mesh=None,
                                        w_ref=w, t=t)

    def _scenario_masks(self, masks):
        """The round's ``[2, n]`` masks (update, mix) in this backend's
        carve-up: ``(update mask of the local nodes, mix mask for the mix
        hook, (alive_frac, mix_frac))``.  The fractions are exact sums of
        0/1 values (integers <= n in fp32) times 1/n, as XLA computes the
        reference's sum / n: bit-equal at any n and any carve-up."""
        n = self.trainer.topology.n
        alive, mix_mask = masks[0], masks[1]
        return (self._local_update_mask(alive), mix_mask,
                (torch.sum(alive) * (1.0 / n),
                 torch.sum(mix_mask) * (1.0 / n)))

    def _mixing_at(self, t_dev, t=None):
        """``mixing[t % T]``: by the host step ``t`` when given, else by
        the device counter without reading it on the host."""
        mixing = self.trainer._mixing
        if mixing.shape[0] == 1:
            return mixing[0]
        if t is not None:
            return mixing[t % mixing.shape[0]]
        return mixing.index_select(
            0, (t_dev % mixing.shape[0]).reshape(1))[0]

    def _post_mix(self, tree, w, t):
        """One synchronous gossip of an arbitrary tree in this layout,
        posted now: the mixed tree, or a ``finish()`` giving it once the
        messages are in (the launch stage's primitive)."""
        mi = self._mix_impl(w, t)
        return gossip.mix_dense(w, tree) if mi is None else mi(w, tree)

    # -- the step pipeline ---------------------------------------------------
    def _stage_launch_mix(self, state, w, t=None):
        """Stage 1: under the overlap, post the gossip of the stale
        exchange buffers; these messages depend on the previous step only,
        never on this round's gradients.  None when synchronous."""
        if self.overlap == "none" or state.mix_buf is None:
            return None
        return [self._post_mix(s, w, t) for s in state.mix_buf]

    def _stage_compute(self, state, batch):
        """Stage 2: per-node loss and gradient on the node-stacked params.
        The summed per-node losses differentiate to exact per-node grads:
        node i's loss depends on node i's params only.  The gradients come
        back contiguous (a weight the model permutes, as the conv weights of
        ``models/resnet.py``, gets a permuted gradient, which the kernels
        refuse) and the new model state detached (BN's running statistics
        would otherwise keep each step's graph alive)."""
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state.params)]
        treedef = self.trainer.params_treedef
        with torch.enable_grad():
            loss, (new_ms, metrics) = self.trainer.loss_fn(
                tree_unflatten(treedef, leaves), state.model_state, batch)
            grads = torch.autograd.grad(loss.sum(), leaves)
        return (loss.detach(), tree_map(torch.Tensor.detach, new_ms), metrics,
                tree_unflatten(treedef, [g.contiguous() for g in grads]))

    def _stage_finish_mix(self, state, grads, w, lr, t=None, mix_mask=None,
                          inflight=None):
        """Stage 3: the transform-stage chain with the mix hook installed:
        the backend's mix (a scenario's masked one), a compressed round
        when the trainer has comm (one site per mix call, its anchors
        gossiped through the backend's mix), or, with ``inflight``, the
        delayed consumer.  Returns ``(new_params, new_opt, new_comm,
        new_mix_buf)``."""
        from repro_torch.runtime.overlap import make_delayed_mix_fn

        tr = self.trainer
        opt = tr.optimizer
        new_comm, new_buf = state.comm_state, state.mix_buf
        if inflight is not None:
            new_buf = list(state.mix_buf)
            opt = dataclasses.replace(opt, mix_fn=make_delayed_mix_fn(
                state.mix_buf, inflight, new_buf, w_ref=w,
                fallback=self._mix_impl(w, t)))
        else:
            mix_impl = self._mix_impl(w, t, mix_mask)
            if mix_impl is not None:
                opt = dataclasses.replace(opt, mix_fn=mix_impl)
            if tr.comm is not None and state.comm_state is not None:
                sites_in = list(state.comm_state)
                new_comm = list(sites_in)
                opt = dataclasses.replace(opt, mix_fn=tr.comm.make_mix_fn(
                    sites_in, new_comm, tr._comm_gen, tr._comm_gamma,
                    mix_impl=mix_impl))
        new_params, new_opt = opt.step(
            state.params, grads, state.opt_state, w=w, lr=lr, t=state.t,
            n_nodes=tr.topology.n, mesh=self.mesh)
        return new_params, new_opt, new_comm, new_buf

    @torch.no_grad()
    def _step_math(self, state, batch, collect: bool = False, masks=None,
                   t=None):
        """One decentralized step; returns (new TrainState, metrics), the
        metrics as 0-d device tensors reduced over every node.  ``collect``
        adds the telemetry collectors' scalars (``tm.``-prefixed) and
        labels the stages with NVTX ranges (``tm/grad``, ``tm/finish_mix``,
        ``tm/collect``).  ``masks`` is the round's ``[2, n]`` (update mask,
        mix mask) pair on the device under a non-trivial scenario (the
        hybrid backend's: over its mask ids), else None; ``t`` the host
        step index (None: the schedule does not need it)."""
        from repro_torch.train.trainer import TrainState

        tr = self.trainer
        n = tr.topology.n
        collect = collect and tr.telemetry is not None
        label = graph_span if collect else contextlib.nullcontext
        lr = tr.lr_fn(state.t)
        w = self._mixing_at(state.t, t)
        alive = mix_mask = fracs = None
        if masks is not None:
            alive, mix_mask, fracs = self._scenario_masks(masks)
        inflight = self._stage_launch_mix(state, w, t)
        with label("tm/grad"):
            loss, new_ms, metrics, grads = self._stage_compute(state, batch)
        with label("tm/finish_mix"):
            new_params, new_opt, new_comm, new_buf = self._stage_finish_mix(
                state, grads, w, lr, t, mix_mask, inflight)
        if alive is not None:
            # dropped and unsampled nodes hold their state exactly; their
            # mixing rows were the identity, so no alive node read the
            # values discarded here
            new_params = _hold_nodes(alive, new_params, state.params)
            new_opt = _hold_nodes(alive, new_opt, state.opt_state)
            new_ms = _hold_nodes(alive, new_ms, state.model_state)
        out = {
            "loss": self._node_mean_scalar(loss),
            "lr": lr.reshape(()),
            "consensus": gossip.consensus_distance(new_params,
                                                   mesh=self.mesh),
            "grad_norm": torch.sqrt(self._node_sum_scalar(sum(
                torch.sum(g.to(torch.float32) ** 2)
                for g in tree_leaves(grads))) / n),
        }
        if tr.comm is not None and state.comm_state is not None:
            # constants: filled on the device, never copied from the host
            out["comm_bits_per_node"] = torch.full(
                (), tr._comm_bits * len(state.comm_state),
                dtype=torch.float32, device=tr.device)
            out["comm_ratio"] = torch.full(
                (), tr._dense_bits / max(tr._comm_bits, 1e-9),
                dtype=torch.float32, device=tr.device)
        for k, v in metrics.items():
            out[k] = self._node_mean_scalar(v)
        if alive is not None:
            out["alive_frac"], out["mix_frac"] = fracs
        if collect:
            ctx = CollectorCtx(
                grads=grads, params_old=state.params, params_new=new_params,
                opt_state_old=state.opt_state, opt_state_new=new_opt,
                comm_state_old=state.comm_state, comm_state_new=new_comm,
                lr=lr, t=state.t, n_nodes=n, static=tr.telemetry.static,
                device=tr.device, alive=alive, mesh=self.mesh,
                mix_buf_old=state.mix_buf, mix_buf_new=new_buf)
            with graph_span("tm/collect"):
                out.update({TM_PREFIX + k: v for k, v in
                            tr.telemetry.collect(ctx).items()})
        return TrainState(new_params, new_opt, new_ms, state.t + 1,
                          new_comm, new_buf), out

    def _chunk_math(self, state, batches, collect: bool = False,
                    masks=None, t=None):
        """``k`` steps over a batch tuple stacked ``[k, b, ...]`` (and the
        scenario's masks stacked ``[k, 2, m]``) from host step ``t``; the
        metrics come back stacked ``[k]``."""
        rows = []
        for j in range(batches[0].shape[0]):
            kw = {} if t is None else {"t": t + j}
            state, m = self._step_math(
                state, tuple(b[j] for b in batches), collect,
                None if masks is None else masks[j], **kw)
            rows.append(m)
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    # -- backend surface ------------------------------------------------------
    def step(self, state, batch, collect: bool = False, masks=None, t=None):
        kw = {} if t is None else {"t": t}
        return self._step_math(state, batch, collect, masks, **kw)

    def step_chunk(self, state, batches, collect: bool = False, masks=None,
                   t=None):
        return self._chunk_math(state, batches, collect, masks, t)

    def put_batch(self, batch, lead: int = 0):
        """Host numpy batch -> tensors on the trainer's device, one copy per
        array (``lead``: the node axis, 1 for a chunk's ``[k, n, ...]``)."""
        dev = self.trainer.device
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in batch)

    def finalize_state(self, state):
        """A node-stacked ``[n, ...]`` state (a checkpoint's, another
        package's) in this backend's layout: as it is here."""
        return state

    def gather_state(self, state):
        """This backend's state as the node-stacked ``[n, ...]`` one (what a
        checkpoint holds): as it is here."""
        return state

    # -- overlap probe (tm.gossip_wait_ms) -----------------------------------
    def probe_metrics(self, state, batch, t=None, chunked: bool = False
                      ) -> dict:
        """The gossip wait the overlap could not hide: post the launch
        stage, run the compute stage and wait for it, then time how long
        the in-flight mix takes beyond that (host clock between two device
        syncs; ``tm.gossip_wait_ms``).  Runs beside the real step, on
        collect steps only, and changes no state; {} when synchronous."""
        if self.overlap == "none" or state.mix_buf is None:
            return {}
        dev = self.trainer.device
        with torch.no_grad():
            inflight = self._stage_launch_mix(
                state, self._mixing_at(state.t, t), t)
            if chunked:
                batch = tuple(b[0] for b in batch)
            self._stage_compute(state, batch)
            _sync(dev)
            self.gossip_timer.arm()
            for mx in inflight:
                if callable(mx):
                    mx()
            _sync(dev)
            self.gossip_timer.lap(1)
        return {TM_PREFIX + "gossip_wait_ms":
                float(self.gossip_timer.last_s * 1e3)}

    # -- evaluation -----------------------------------------------------------
    def eval_batch(self, state, eval_fn, batch) -> dict:
        """Per-node sums for one eval batch: dict of ``[n]`` tensors."""
        with torch.no_grad():
            return eval_fn(state.params, state.model_state,
                           self.put_batch(batch))

    def evaluate(self, state, eval_fn, batches) -> dict:
        """Paper protocol: evaluate each node's model on the full eval set,
        then report each metric's mean over nodes and, as
        ``<metric>_std_over_nodes``, its spread."""
        totals: dict[str, np.ndarray] = {}
        for batch in batches:
            for k, v in self.eval_batch(state, eval_fn, batch).items():
                totals[k] = totals.get(k, 0) + v.cpu().numpy()
        if not totals:
            return {}
        count = totals.pop("count")
        out = {}
        for k, v in totals.items():
            out[k] = float(np.mean(v / count))
            out[k + "_std_over_nodes"] = float(np.std(v / count))
        return out
