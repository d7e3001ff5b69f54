"""Decentralized training engine.

Port of ``repro/train/trainer.py``: ``TrainState``, ``lr_schedule``,
``DecentralizedTrainer`` (``init``/``step``/``step_chunk``/``evaluate``),
``run_training`` and ``run_training_scanned``.  The step math lives in the
execution backend (``repro_torch.runtime``):

    grads = per-node grad(loss)
    params, opt_state = opt.step(params, grads, w=W_t, lr=eta_t, t=t)

Where the reference fuses a chunk of steps under ``lax.scan``, the port
runs them as a Python loop over one host-to-device copy of the chunk's
batches (a CUDA graph of the chunk is later work).

With a ``mesh`` (``repro_torch.launch.mesh.NodeMesh``, a
``torch.distributed`` node axis) the trainer runs on the sharded or hybrid
backend: each rank holds its block of the nodes, copies only its rows of
each batch (the same batch in every process) and gossips through the
compiled schedule (``gossip_schedule``).  ``overlap='delayed_1'`` mixes
the one-step-stale exchange buffers (``TrainState.mix_buf``, captured at
:meth:`DecentralizedTrainer.init`) on any backend.  A schedule that
changes from step to step picks its phase from the loops' host step
index.  The reference's per-step
rng is dropped: no ported model draws random numbers in its loss.  The
compressors that draw (random-k, QSGD) draw from the trainer's own
``torch.Generator`` on its device, seeded with ``rng_seed``; a checkpoint
carries its state (``train/checkpoint.py``).

With a ``telemetry`` config, an on-cadence step also runs the collectors
(``repro_torch.telemetry``); the cadence is decided on the host by the
loops' recorder, so an off-cadence step is the unchanged step.

With a ``scenario`` (``repro_torch.scenario.ScenarioContext``) the loops
draw each step's update and mix masks on the host, keyed by the loop's own
absolute step index, ``MASK_BLOCK`` steps in one vectorised draw, and copy
a step's or a chunk's masks to the device with its batches, so that a step
reads nothing back to the host; :meth:`DecentralizedTrainer.step` called
on its own reads ``state.t`` once instead.  The host time of the draws
adds up in ``mask_host_s``.

Model state stays per node and is never gossiped.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.optim import DecentralizedOptimizer
from repro_torch.core.topology import Topology
from repro_torch.core.transforms import FUSED_MODES
from repro_torch.device import resolve_device
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

__all__ = ["TrainState", "lr_schedule", "DecentralizedTrainer",
           "run_training", "run_training_scanned", "MASK_BLOCK"]

#: steps of scenario masks drawn in one vectorised host call (at n = 1024,
#: 512 KiB of host memory)
MASK_BLOCK = 64


@dataclasses.dataclass
class TrainState:
    params: Any             # [n, ...] tensors
    opt_state: Any
    model_state: Any        # [n, ...], never gossiped
    t: torch.Tensor         # 0-d int32 step counter, on the device
    comm_state: Any = None  # compressed-gossip sites: one dict per mix call
    mix_buf: Any = None     # overlap='delayed_1': the in-flight exchange
                            # buffers, one tree per topology mix site


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
    to ``collect`` run its collectors.  ``scenario`` is a
    :class:`~repro_torch.scenario.ScenarioContext` (or None: full
    participation); a non-trivial one needs uncompressed comm, its ``n``
    equal to the topology's and symmetric mixing, as in the reference.

    ``mesh`` is a :class:`~repro_torch.launch.mesh.NodeMesh` whose
    ``node_axis`` carries the nodes: ``runtime='auto'`` then picks the
    sharded backend (axis size n) or the hybrid one (a size that divides
    n), and the trainer's device is the mesh's.  ``gossip_schedule`` is one
    of ``gossip.GOSSIP_SCHEDULES``; ``overlap`` one of
    ``runtime.OVERLAPS``.  Every unsupported combination raises
    ``ValueError`` here, with the reference's text."""

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
    node_axis: str = "data"
    gossip_schedule: str = "auto"

    def __post_init__(self):
        from repro_torch.core import gossip
        from repro_torch.launch.mesh import NodeMesh
        from repro_torch.runtime import make_runtime, resolve_runtime

        if getattr(self.optimizer, "fused", "off") not in FUSED_MODES:
            raise ValueError(
                f"optimizer.fused must be one of {FUSED_MODES}, got "
                f"{self.optimizer.fused!r}")
        self.device = resolve_device(self.device)
        if self.mesh is not None:
            if not isinstance(self.mesh, NodeMesh):
                raise TypeError(
                    "mesh must be a repro_torch.launch.mesh.NodeMesh "
                    "(make_node_mesh() after launch.distributed."
                    f"initialize()), got {type(self.mesh).__name__}")
            if self.mesh.device.type != self.device.type:
                raise ValueError(
                    f"the mesh's ranks run on {self.mesh.device}, the "
                    f"trainer was asked for {self.device}")
            self.device = self.mesh.device
        n = self.topology.n
        kind = resolve_runtime(self.runtime, mesh=self.mesh,
                               node_axis=self.node_axis, n=n)
        if kind == "hybrid":
            # the node-granular resolver would refuse the mesh (its size is
            # not n); the hybrid backend block-compiles the schedule, and
            # _resolved keeps the node rounds for the wire accounting
            if self.gossip_schedule == "ring_ppermute":
                raise ValueError(
                    "gossip_schedule='ring_ppermute' is the one-node-per-"
                    "device special case; runtime='hybrid' uses 'auto' | "
                    "'sparse_ppermute' | 'dense'")
            if self.gossip_schedule not in gossip.GOSSIP_SCHEDULES:
                raise ValueError(
                    f"unknown gossip schedule {self.gossip_schedule!r}; "
                    f"valid: {' | '.join(gossip.GOSSIP_SCHEDULES)}")
            if self.gossip_schedule == "dense" or n == 1:
                self._resolved = gossip.ResolvedGossip("dense")
            else:
                self._resolved = gossip.ResolvedGossip(
                    "sparse", gossip.compile_gossip_schedule(self.topology),
                    self.mesh, self.node_axis)
        else:
            self._resolved = gossip.resolve_gossip(
                self.topology, schedule=self.gossip_schedule, mesh=self.mesh,
                node_axis=self.node_axis if self.mesh is not None else None)
        self._validate_scenario(kind)
        self._validate_overlap()
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
        self._masks_ahead = None   # (first step, host masks [b, 2, n])
        self.mask_host_s = 0.0     # host time of the scenario's draws
        self._runtime = make_runtime(self)

    @property
    def _scenario(self):
        """The scenario when it masks anything, else None (a trivial one
        runs the no-scenario step)."""
        sc = self.scenario
        return None if sc is None or sc.trivial else sc

    def _validate_scenario(self, kind: str) -> None:
        """The reference's eager checks of the participation/fault model,
        with its texts."""
        sc = self.scenario
        if sc is None or getattr(sc, "trivial", False):
            return
        if sc.n != self.topology.n:
            raise ValueError(
                f"scenario is configured for n={sc.n} nodes, topology has "
                f"n={self.topology.n}")
        if self.comm is not None:
            raise ValueError(
                "scenario fault injection with compressed comm is not "
                "supported: CHOCO/EF replica states assume every node "
                "completes every round; run uncompressed (comm=None)")
        if kind == "sharded" or (kind == "vmap"
                                 and self._resolved.kind != "dense"):
            raise ValueError(
                "scenario fault injection runs on runtime='hybrid' (block-"
                "sparse masked gossip) or runtime='vmap' with dense gossip;"
                f" got runtime={kind!r}, gossip={self._resolved.kind!r}")
        mix = np.asarray(self.topology.mixing)
        if not np.allclose(mix, np.swapaxes(mix, 1, 2), atol=1e-8):
            raise ValueError(
                "scenario fault injection requires symmetric mixing "
                "(Metropolis weights) so the alive-subgraph renormalization "
                f"stays doubly stochastic; topology {self.topology.name!r} "
                "is asymmetric (e.g. one-peer exponential)")

    def _validate_overlap(self) -> None:
        """The reference's eager checks of the delayed-gossip pipeline."""
        from repro_torch.runtime import OVERLAPS
        if self.overlap not in OVERLAPS:
            raise ValueError(
                f"overlap={self.overlap!r} is not one of {OVERLAPS}")
        if self.overlap == "none":
            return
        if self.comm is not None:
            raise ValueError(
                "overlap='delayed_1' with compressed comm is not supported: "
                "the CHOCO replica exchange already defines its own buffer "
                "protocol; run uncompressed (comm=None)")
        if self.scenario is not None and not getattr(
                self.scenario, "trivial", False):
            raise ValueError(
                "overlap='delayed_1' with scenario fault injection is not "
                "supported: the stale exchange buffers of dropped nodes "
                "would re-inject discarded state; run scenario=None")

    def scenario_masks(self, start: int, k: int, until: int = 0):
        """The scenario's masks of steps ``start .. start + k - 1`` as a
        host array ``[k, 2, n]`` (update mask, mix mask; on the hybrid
        backend over its ``mask_ids``), or None without a scenario that
        masks.  Drawn ``MASK_BLOCK`` steps (at least
        ``k``, none from step ``until`` on if it is given) at a time and
        kept until a step outside the block is asked; the draws' host time
        adds up in ``mask_host_s``."""
        sc = self._scenario
        if sc is None:
            return None
        t0 = time.perf_counter()
        ahead = self._masks_ahead
        if (ahead is None or start < ahead[0]
                or start + k > ahead[0] + len(ahead[1])):
            stop = start + max(k, MASK_BLOCK)
            if until:
                stop = max(start + k, min(stop, until))
            ahead = (start, sc.stacked_masks(
                np.arange(start, stop),
                ids=getattr(self._runtime, "mask_ids", None)))
            self._masks_ahead = ahead
        out = ahead[1][start - ahead[0]:start - ahead[0] + k]
        self.mask_host_s += time.perf_counter() - t0
        return out

    def put_steps(self, batch, start: int, k: Optional[int] = None,
                  until: int = 0):
        """One step's host batch (``k`` None) or ``k`` steps' stacked
        ``[k, n, ...]``, with the scenario's masks of the steps from
        ``start`` (drawn ahead up to step ``until``, see
        :meth:`scenario_masks`), onto the device, one copy an array:
        ``(batch, masks)``, the masks ``[2, n]`` (``[k, 2, n]``) or
        None."""
        masks = self.scenario_masks(start, 1 if k is None else k, until)
        batch = self.put_batch(batch, lead=0 if k is None else 1)
        if masks is None:
            return batch, None
        return batch, self._put_masks(masks[0] if k is None else masks)

    def _put_masks(self, masks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(masks)).to(self.device)

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
        node starts from the same x^0 (the paper's setup).  On the sharded
        and hybrid backends the state holds this rank's nodes only.  Under
        the overlap, ``mix_buf`` is captured here: the tree each topology
        mix site would contract on the first step."""
        params, mstate = init_fn(generator)
        rows = getattr(self._runtime, "_b", self.topology.n)
        stack = lambda tree: tree_map(
            lambda x: x.to(self.device).expand(rows, *x.shape).clone(), tree)
        params_n = stack(params)
        comm_state = mix_buf = None
        if self.comm is not None:
            comm_state = self.comm.init_state(self.optimizer, params_n,
                                              self._mixing[0])
        if self.overlap != "none":
            from repro_torch.runtime.overlap import \
                capture_topology_mix_sites
            mix_buf = capture_topology_mix_sites(
                self.optimizer, params_n, self._mixing[0],
                mesh=self._runtime.mesh)
        return TrainState(params=params_n,
                          opt_state=self.optimizer.init(params_n),
                          model_state=stack(mstate),
                          t=torch.zeros((), dtype=torch.int32,
                                        device=self.device),
                          comm_state=comm_state, mix_buf=mix_buf)

    def finalize_state(self, state: TrainState) -> TrainState:
        """A node-stacked ``[n, ...]`` state (a checkpoint's, the
        reference's init) in the backend's layout: this rank's rows on the
        sharded and hybrid backends, as it is on vmap."""
        return self._runtime.finalize_state(state)

    def gather_state(self, state: TrainState) -> TrainState:
        """The node-stacked ``[n, ...]`` form of ``state`` (what a
        checkpoint holds); a collective on the sharded and hybrid
        backends, which every rank calls."""
        return self._runtime.gather_state(state)

    # -- steps ---------------------------------------------------------------
    def _host_t(self, state, t, masks):
        """The host step index where a step needs one (a schedule that
        changes from step to step, a scenario's draw): ``t``, or
        ``state.t`` read once."""
        if t is None and (self._runtime.uses_host_t
                          or (masks is None and self._scenario is not None)):
            t = int(state.t)
        return t

    def step(self, state: TrainState, batch, collect: bool = False,
             masks=None, t: Optional[int] = None):
        """One decentralized step on device tensors (see :meth:`put_batch`);
        returns (new state, metrics as 0-d device tensors).  ``collect``
        also runs the telemetry collectors (``tm.`` metrics).  ``masks``:
        the scenario's ``[2, n]`` masks of this step on the device (see
        :meth:`put_steps`); ``t``: the step's index on the host, by which a
        compiled schedule that changes from step to step picks its phase.
        Without them, a scenario that masks or such a schedule reads
        ``state.t`` once."""
        self._setup(state.params)
        t = self._host_t(state, t, masks)
        if masks is None and self._scenario is not None:
            masks = self._put_masks(self.scenario_masks(t, 1)[0])
        return self._runtime.step(
            state, batch, collect, masks,
            t if self._runtime.uses_host_t else None)

    def step_chunk(self, state: TrainState, batches, collect: bool = False,
                   masks=None, t: Optional[int] = None):
        """``k`` steps over batches stacked ``[k, n, ...]`` from host step
        ``t``; metrics come back stacked ``[k]``.  ``collect`` collects on
        every step.  ``masks``: the scenario's ``[k, 2, n]``, as for
        :meth:`step`."""
        self._setup(state.params)
        t = self._host_t(state, t, masks)
        if masks is None and self._scenario is not None:
            masks = self._put_masks(
                self.scenario_masks(t, batches[0].shape[0]))
        return self._runtime.step_chunk(
            state, batches, collect, masks,
            t if self._runtime.uses_host_t else None)

    def put_batch(self, batch, lead: int = 0):
        """One host batch (a tuple of numpy arrays, the same in every
        process) onto the device: this rank's rows of it on the sharded and
        hybrid backends (``lead``: the node axis, 1 for a chunk)."""
        return self._runtime.put_batch(batch, lead)

    def probe_metrics(self, state: TrainState, batch, t: Optional[int] = None,
                      chunked: bool = False) -> dict:
        """The overlap's ``tm.gossip_wait_ms`` for this step (host-timed,
        state unchanged); {} unless ``overlap`` is on.  Call before the
        step."""
        self._setup(state.params)
        return self._runtime.probe_metrics(
            state, batch, t if self._runtime.uses_host_t else None, chunked)

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
    """Per-step Python loop, one host-to-device copy per step (with the
    scenario's masks of the step, if any).

    ``checkpoint_fn(done, state)`` is called whenever ``done`` (absolute
    completed steps, ``step_offset`` included) hits a multiple of
    ``checkpoint_every``; a run restarted from that state (and the
    trainer's generator state, which ``checkpoint_fn`` saves beside it)
    continues as the uninterrupted run.  ``step_offset`` makes a resumed
    run record absolute step indices, and keys its scenario masks by them:
    ``state.t`` must equal ``step_offset``.

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
        batch, masks = trainer.put_steps(batch, i, until=total)
        probe = trainer.probe_metrics(state, batch, i) if collect else {}
        state, metrics = trainer.step(state, batch, collect, masks, t=i)
        if telemetry is not None:
            metrics = telemetry.consume(i, {**metrics, **probe})
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
    (and the scenario's masks of its steps) are stacked on the host and
    copied to the device once, and its metrics come back at most once.  Same math and the same history as
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
        stacked, masks = trainer.put_steps(
            tuple(np.stack(xs) for xs in zip(*batches)), step_offset + done,
            k, until=step_offset + steps)
        collect = (telemetry is not None
                   and telemetry.wants_chunk(step_offset + done, k))
        probe = (trainer.probe_metrics(state, stacked, step_offset + done,
                                       chunked=True) if collect else {})
        state, metrics = trainer.step_chunk(state, stacked, collect, masks,
                                            t=step_offset + done)
        if telemetry is not None:
            # a host probe value stands for every step of the chunk
            metrics = telemetry.consume_chunk(step_offset + done, {
                **metrics, **{mk: np.full((k,), mv, np.float32)
                              for mk, mv in probe.items()}})

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
