"""Decentralized training engine.

Port of ``repro/train/trainer.py``: ``TrainState``, ``lr_schedule``,
``DecentralizedTrainer`` (``init``/``step``/``step_chunk``/``evaluate``),
``run_training`` and ``run_training_scanned``.  The step math lives in the
execution backend (``repro_torch.runtime``):

    grads = per-node grad(loss)
    params, opt_state = opt.step(params, grads, w=W_t, lr=eta_t, t=t)

Where the reference fuses a chunk of steps under ``lax.scan``, the port
runs them as a Python loop over one host-to-device copy of the chunk's
batches (a CUDA graph of the chunk is later work).  The reference's per-step
rng is dropped: no ported model draws random numbers in its loss.  The
compressors that draw (random-k, QSGD) draw from the trainer's own
``torch.Generator`` on its device, seeded with ``rng_seed``; a checkpoint
carries its state (``train/checkpoint.py``).

With a ``telemetry`` config, an on-cadence step also runs the collectors
(``repro_torch.telemetry``); the cadence is decided on the host by the
loops' recorder, so an off-cadence step is the unchanged step.

Model state stays per node and is never gossiped.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.optim import DecentralizedOptimizer
from repro_torch.core.topology import Topology
from repro_torch.core.transforms import FUSED_MODES
from repro_torch.device import resolve_device
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

__all__ = ["TrainState", "lr_schedule", "DecentralizedTrainer",
           "run_training", "run_training_scanned"]


@dataclasses.dataclass
class TrainState:
    params: Any             # [n, ...] tensors
    opt_state: Any
    model_state: Any        # [n, ...], never gossiped
    t: torch.Tensor         # 0-d int32 step counter, on the device
    comm_state: Any = None  # compressed-gossip sites: one dict per mix call


def lr_schedule(base_lr: float, *, total_steps: int, warmup: int = 0,
                decay_at: tuple[float, ...] = (), decay: float = 0.1,
                warmup_from: float = 0.1):
    """Paper recipe: linear warmup from ``warmup_from``, then stage-wise
    decay at the given fractions of total steps.  ``fn(t)`` takes the device
    step counter and returns the fp32 [1] lr on that device."""
    decay_steps = tuple(int(f * total_steps) for f in decay_at)

    def fn(t):
        t = t.to(torch.float32)
        lr = torch.full_like(t, base_lr)
        if warmup:
            frac = torch.clamp(t / warmup, 0.0, 1.0)
            start = min(warmup_from, base_lr)
            lr = start + (base_lr - start) * frac
        for ds in decay_steps:
            lr = torch.where(t >= ds, lr * decay, lr)
        return lr.reshape(1)

    return fn


@dataclasses.dataclass
class DecentralizedTrainer:
    """``loss_fn(params, model_state, batch) -> (loss [n], (model_state,
    metrics))`` over node-stacked params and batches, one loss per node.

    ``comm`` is a :class:`~repro_torch.comm.CompressedGossip` (or None for
    dense gossip); its random draws come from a ``torch.Generator`` on
    ``device`` seeded with ``rng_seed``, which advances from step to step.
    ``telemetry`` is a resolved
    :class:`~repro_torch.telemetry.TelemetryConfig` (or None): steps asked
    to ``collect`` run its collectors.  ``mesh``, ``overlap`` and
    ``scenario`` are the reference's options that slice 8 of the port
    brings; set to anything but their defaults they raise
    ``NotImplementedError``."""

    loss_fn: Callable
    optimizer: DecentralizedOptimizer
    topology: Topology
    lr_fn: Optional[Callable] = None  # defaults to optimizer.lr constant
    device: Any = "cuda"
    runtime: str = "auto"
    comm: Any = None
    rng_seed: int = 0
    mesh: Any = None
    overlap: str = "none"
    scenario: Any = None
    telemetry: Any = None

    def __post_init__(self):
        if getattr(self.optimizer, "fused", "off") not in FUSED_MODES:
            raise ValueError(
                f"optimizer.fused must be one of {FUSED_MODES}, got "
                f"{self.optimizer.fused!r}")
        for option, value, default, where in (
                ("mesh", self.mesh, None, 8),
                ("overlap", self.overlap, "none", 8),
                ("scenario", self.scenario, None, 8)):
            if value != default:
                raise NotImplementedError(
                    f"trainer option {option}={value!r} is not ported yet: "
                    f"it comes with slice {where} of the port")
        self.device = resolve_device(self.device)
        if self.lr_fn is None:
            lr = torch.full((1,), self.optimizer.lr, dtype=torch.float32,
                            device=self.device)
            self.lr_fn = lambda t: lr
        self._mixing = torch.as_tensor(self.topology.mixing,
                                       dtype=torch.float32).to(self.device)
        self._comm_gen = None
        self._comm_gamma = None   # resolved on first sight of params
        self.params_treedef = None   # likewise: the step rebuilds from it
        if self.comm is not None:
            self._comm_gen = torch.Generator(
                device=self.device).manual_seed(self.rng_seed)
        from repro_torch.runtime import make_runtime
        self._runtime = make_runtime(self, self.runtime)

    def _setup(self, params) -> None:
        """Keep the params' treedef (a run's structure is fixed) and
        resolve gamma and the wire bits per site and node, once."""
        if self.params_treedef is None:
            self.params_treedef = tree_flatten(params)[1]
        if self.comm is None or self._comm_gamma is not None:
            return
        self._comm_gamma = self.comm.resolved_gamma(params)
        self._comm_bits = self.comm.wire_bits_per_site(params)
        self._dense_bits = sum(32.0 * l.numel() / l.shape[0]
                               for l in tree_leaves(params))

    # -- init ---------------------------------------------------------------
    def init(self, init_fn, generator: torch.Generator) -> TrainState:
        """``init_fn(generator) -> (params, model_state)`` for one node; every
        node starts from the same x^0 (the paper's setup)."""
        params, mstate = init_fn(generator)
        n = self.topology.n
        stack = lambda tree: tree_map(
            lambda x: x.to(self.device).expand(n, *x.shape).clone(), tree)
        params_n = stack(params)
        comm_state = None
        if self.comm is not None:
            comm_state = self.comm.init_state(self.optimizer, params_n,
                                              self._mixing[0])
        return TrainState(params=params_n,
                          opt_state=self.optimizer.init(params_n),
                          model_state=stack(mstate),
                          t=torch.zeros((), dtype=torch.int32,
                                        device=self.device),
                          comm_state=comm_state)

    # -- steps ---------------------------------------------------------------
    def step(self, state: TrainState, batch, collect: bool = False):
        """One decentralized step on device tensors (see :meth:`put_batch`);
        returns (new state, metrics as 0-d device tensors).  ``collect``
        also runs the telemetry collectors (``tm.`` metrics)."""
        self._setup(state.params)
        return self._runtime.step(state, batch, collect)

    def step_chunk(self, state: TrainState, batches, collect: bool = False):
        """``k`` steps over batches stacked ``[k, n, ...]``; metrics come
        back stacked ``[k]``.  ``collect`` collects on every step."""
        self._setup(state.params)
        return self._runtime.step_chunk(state, batches, collect)

    def put_batch(self, batch):
        """One host batch (a tuple of numpy arrays) onto the device."""
        return self._runtime.put_batch(batch)

    def evaluate(self, state: TrainState, eval_fn, batches) -> dict:
        """Each node's model on the full eval set: each metric's mean over
        nodes and its ``_std_over_nodes``."""
        return self._runtime.evaluate(state, eval_fn, batches)


def _record_step(history, i, steps, log_every, log_fn, get_metrics):
    """The logging cadence shared by both loops: print+append on log_every
    boundaries and the final step, append silently on the final step
    otherwise.  ``get_metrics`` is called only for a recorded step."""
    if log_every and (i % log_every == 0 or i == steps - 1):
        m = get_metrics()
        history.append({"step": i, **m})
        log_fn(f"step {i:5d}  " + "  ".join(
            f"{k}={v:.4f}" for k, v in m.items()))
    elif i == steps - 1:
        history.append({"step": i, **get_metrics()})


def run_training(trainer: DecentralizedTrainer, state: TrainState,
                 batch_iter, steps: int, *, log_every: int = 0,
                 log_fn=print, checkpoint_every: int = 0,
                 checkpoint_fn=None, step_offset: int = 0,
                 telemetry=None) -> tuple[TrainState, list[dict]]:
    """Per-step Python loop, one host-to-device copy per step.

    ``checkpoint_fn(done, state)`` is called whenever ``done`` (absolute
    completed steps, ``step_offset`` included) hits a multiple of
    ``checkpoint_every``; a run restarted from that state (and the
    trainer's generator state, which ``checkpoint_fn`` saves beside it)
    continues as the uninterrupted run.  ``step_offset`` makes a resumed
    run record absolute step indices.

    ``telemetry`` is an optional recorder
    (``repro_torch.telemetry.TelemetryRecorder``): on-cadence steps
    (``telemetry.wants(i)``) run the collectors, and each step's metrics
    pass through ``telemetry.consume(i, metrics)``, which keeps the ``tm.``
    values and returns the rest, so ``history`` has the same keys either
    way and off-cadence steps are the telemetry-free step."""
    history = []
    total = step_offset + steps
    for i, batch in zip(range(step_offset, total), batch_iter):
        collect = telemetry is not None and telemetry.wants(i)
        state, metrics = trainer.step(state, trainer.put_batch(batch),
                                      collect)
        if telemetry is not None:
            metrics = telemetry.consume(i, metrics)
        _record_step(history, i, total, log_every, log_fn,
                     lambda: {k: float(v) for k, v in metrics.items()})
        if checkpoint_fn and checkpoint_every \
                and (i + 1) % checkpoint_every == 0:
            checkpoint_fn(i + 1, state)
    return state, history


def run_training_scanned(trainer: DecentralizedTrainer, state: TrainState,
                         batch_iter, steps: int, *, chunk: int = 16,
                         log_every: int = 0, log_fn=print,
                         checkpoint_every: int = 0, checkpoint_fn=None,
                         step_offset: int = 0, telemetry=None
                         ) -> tuple[TrainState, list[dict]]:
    """``run_training`` in chunks of ``chunk`` steps: the chunk's batches
    are stacked on the host and copied to the device once, and its metrics
    come back at most once.  Same math and the same history as
    ``run_training``.  If ``batch_iter`` runs dry, the loop stops, warns
    through ``log_fn``, and the history covers the steps that ran.

    ``checkpoint_fn(done, state)`` fires at the first chunk boundary at or
    after each multiple of ``checkpoint_every`` of the absolute step count,
    as the reference's does.  A chunk with an on-cadence step
    (``telemetry.wants_chunk``) collects on all its steps, and
    ``telemetry.consume_chunk`` keeps the on-cadence rows; a chunk without
    one runs the telemetry-free steps."""
    it = iter(batch_iter)
    history = []
    done = 0
    exhausted = False
    last_metrics = None   # () -> metrics of the last executed step
    while done < steps and not exhausted:
        k = min(chunk, steps - done)
        batches = []
        for _ in range(k):
            try:
                batches.append(next(it))
            except StopIteration:
                exhausted = True
                break
        if not batches:
            break
        k = len(batches)
        total = done + k if exhausted else steps
        stacked = trainer.put_batch(
            tuple(np.stack(xs) for xs in zip(*batches)))
        collect = (telemetry is not None
                   and telemetry.wants_chunk(step_offset + done, k))
        state, metrics = trainer.step_chunk(state, stacked, collect)
        if telemetry is not None:
            metrics = telemetry.consume_chunk(step_offset + done, metrics)

        host: dict = {}  # chunk metrics, fetched once and only if needed

        def chunk_metrics(j, metrics=metrics, host=host):
            if not host:
                host.update({mk: mv.cpu().numpy()
                             for mk, mv in metrics.items()})
            return {mk: float(mv[j]) for mk, mv in host.items()}

        for j in range(k):
            _record_step(history, step_offset + done + j,
                         step_offset + total, log_every, log_fn,
                         lambda j=j: chunk_metrics(j))
        last_metrics = lambda k=k, cm=chunk_metrics: cm(k - 1)
        abs_done = step_offset + done
        if checkpoint_fn and checkpoint_every and (
                (abs_done + k) // checkpoint_every
                > abs_done // checkpoint_every):
            checkpoint_fn(abs_done + k, state)
        done += k
    if done < steps:
        log_fn(f"warning: batch_iter exhausted after {done} steps "
               f"({steps} requested); history covers the {done} steps run")
        if last_metrics is not None and (
                not history
                or history[-1]["step"] != step_offset + done - 1):
            history.append({"step": step_offset + done - 1,
                            **last_metrics()})
    return state, history
