"""Execution-backend base: the one decentralized step, written once.

Port of the synchronous path of ``repro/runtime/base.py``: per-node
loss/grad (``_stage_compute``), then the transform-stage chain with the
gossip round (``_stage_finish_mix``), composed by ``_step_math``;
``_chunk_math`` runs k of those steps.  The node index is the stacked
leading axis of every tensor.  With compressed comm the gossip round is a
CHOCO/EF round against the state's per-site ``comm_state``.  With
``collect`` a step also runs the trainer's telemetry collectors and
returns their scalars under the ``tm.`` prefix; without it, it is the
telemetry-free step.  The reference's overlap pipeline comes with slice 8b
of the port; the trainer refuses it.

Under a scenario (``repro_torch.scenario``) a step takes the round's
update and mix masks as a device tensor ``[2, n]``: the gossip mixes
through ``mask_renormalize(W, mix_mask)``, and nodes outside the update
mask hold params, optimizer and model state exactly (``_hold_nodes``).  A
trivial scenario runs the no-scenario step.

A step reads nothing back to the host: the lr, the step counter, the
masks and every metric stay on the device, and a chunk's metrics are
fetched once, when the loop records them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import gossip
from repro_torch.telemetry.metrics import TM_PREFIX, CollectorCtx
from repro_torch.telemetry.trace import graph_span
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


@dataclasses.dataclass
class Runtime:
    """Base execution backend over the owning
    :class:`~repro_torch.train.trainer.DecentralizedTrainer`."""

    trainer: Any
    name: str = "base"

    # -- the step pipeline ---------------------------------------------------
    def _stage_compute(self, state, batch):
        """Per-node loss and gradient on the node-stacked params.  The
        summed per-node losses differentiate to exact per-node grads: node
        i's loss depends on node i's params only.  The gradients come back
        contiguous (a weight the model permutes, as the conv weights of
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

    def _stage_finish_mix(self, state, grads, w, lr, mix_impl=None):
        """The transform-stage chain: local update + gossip round, with the
        mix hook ``mix_impl`` (a scenario's masked mix) or a compressed
        round when the trainer has comm (one site per mix call).  Returns
        ``(new_params, new_opt, new_comm)``."""
        tr = self.trainer
        opt = tr.optimizer
        if mix_impl is not None:
            opt = dataclasses.replace(opt, mix_fn=mix_impl)
        new_comm = state.comm_state
        if tr.comm is not None and state.comm_state is not None:
            sites_in = list(state.comm_state)
            new_comm = list(sites_in)
            opt = dataclasses.replace(opt, mix_fn=tr.comm.make_mix_fn(
                sites_in, new_comm, tr._comm_gen, tr._comm_gamma))
        new_params, new_opt = opt.step(
            state.params, grads, state.opt_state, w=w, lr=lr, t=state.t)
        return new_params, new_opt, new_comm

    def _mixing_at(self, t):
        """``mixing[t % T]`` without reading ``t`` on the host."""
        mixing = self.trainer._mixing
        if mixing.shape[0] == 1:
            return mixing[0]
        return mixing.index_select(0, (t % mixing.shape[0]).reshape(1))[0]

    @torch.no_grad()
    def _step_math(self, state, batch, collect: bool = False, masks=None):
        """One decentralized step; returns (new TrainState, metrics), the
        metrics as 0-d device tensors.  ``collect`` adds the telemetry
        collectors' scalars (``tm.``-prefixed) and labels the stages with
        NVTX ranges (``tm/grad``, ``tm/finish_mix``, ``tm/collect``);
        False is the telemetry-free step, unlabelled.  ``masks`` is the
        round's ``[2, n]`` (update mask, mix mask) pair on the device under
        a non-trivial scenario, else None."""
        from repro_torch.train.trainer import TrainState

        tr = self.trainer
        n = tr.topology.n
        collect = collect and tr.telemetry is not None
        label = graph_span if collect else contextlib.nullcontext
        lr = tr.lr_fn(state.t)
        alive = mix_impl = None
        if masks is not None:
            alive, mix_mask = masks[0], masks[1]
            mix_impl = _masked_mix(mix_mask)
        with label("tm/grad"):
            loss, new_ms, metrics, grads = self._stage_compute(state, batch)
        with label("tm/finish_mix"):
            new_params, new_opt, new_comm = self._stage_finish_mix(
                state, grads, self._mixing_at(state.t), lr, mix_impl)
        if alive is not None:
            # dropped and unsampled nodes hold their state exactly; their
            # mixing rows were the identity, so no alive node read the
            # values discarded here
            new_params = _hold_nodes(alive, new_params, state.params)
            new_opt = _hold_nodes(alive, new_opt, state.opt_state)
            new_ms = _hold_nodes(alive, new_ms, state.model_state)
        out = {
            "loss": torch.mean(loss),
            "lr": lr.reshape(()),
            "consensus": gossip.consensus_distance(new_params),
            "grad_norm": torch.sqrt(sum(
                torch.sum(g.to(torch.float32) ** 2)
                for g in tree_leaves(grads)) / n),
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
            out[k] = torch.mean(v)
        if alive is not None:
            # exact sums of 0/1 values (integers <= n in fp32), times 1/n
            # as XLA computes the reference's sum / n: bit-equal at any n
            out["alive_frac"] = torch.sum(alive) * (1.0 / n)
            out["mix_frac"] = torch.sum(mix_mask) * (1.0 / n)
        if collect:
            ctx = CollectorCtx(
                grads=grads, params_old=state.params, params_new=new_params,
                opt_state_old=state.opt_state, opt_state_new=new_opt,
                comm_state_old=state.comm_state, comm_state_new=new_comm,
                lr=lr, t=state.t, n_nodes=n, static=tr.telemetry.static,
                device=tr.device, alive=alive)
            with graph_span("tm/collect"):
                out.update({TM_PREFIX + k: v for k, v in
                            tr.telemetry.collect(ctx).items()})
        return TrainState(new_params, new_opt, new_ms, state.t + 1,
                          new_comm), out

    def _chunk_math(self, state, batches, collect: bool = False,
                    masks=None):
        """``k`` steps over a batch tuple stacked ``[k, n, ...]`` (and the
        scenario's masks stacked ``[k, 2, n]``); the metrics come back
        stacked ``[k]``."""
        rows = []
        for j in range(batches[0].shape[0]):
            state, m = self._step_math(
                state, tuple(b[j] for b in batches), collect,
                None if masks is None else masks[j])
            rows.append(m)
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    # -- backend surface ------------------------------------------------------
    def step(self, state, batch, collect: bool = False, masks=None):
        return self._step_math(state, batch, collect, masks)

    def step_chunk(self, state, batches, collect: bool = False, masks=None):
        return self._chunk_math(state, batches, collect, masks)

    def put_batch(self, batch):
        """Host numpy batch -> tensors on the trainer's device, one copy per
        array."""
        dev = self.trainer.device
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in batch)

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
