"""The one assembly path: ``build(spec) -> Experiment`` and
``run(spec) -> Result``.

Port of ``repro/api/build.py``: a registry optimizer, or a
``ChainOptimizer`` from ``spec.optim.stages``, on the CUDA device unless the
caller passes ``device="cpu"`` (without a CUDA device the default raises).
``mesh`` (a :class:`~repro_torch.launch.mesh.NodeMesh`, a runtime object
and so not part of the spec) puts the run on the sharded or hybrid backend
over a ``torch.distributed`` node axis; every rank then calls ``run`` with
the same spec, holds its block of the nodes and returns the same history.
A checkpoint holds the whole node-stacked state (gathered, written by rank
0) and resumes on any backend.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.comm import count_mix_sites, make_comm
from repro_torch.core import topology as topo_lib
from repro_torch.core import transforms as T
from repro_torch.core.optim import ChainOptimizer, make_optimizer
from repro_torch.device import describe_device, resolve_device
from repro_torch.train import (DecentralizedTrainer, TrainState, lr_schedule,
                               restore_train_state, run_training,
                               run_training_scanned, save_train_state)
from repro_torch.tree import tree_leaves

from .data import Task, build_task
from .models import MODELS, ModelBundle
from .spec import ExperimentSpec

__all__ = ["Experiment", "Result", "build", "run", "wire_stats"]


@dataclasses.dataclass
class Experiment:
    """A built (but not yet run) experiment: everything ``run`` needs."""

    spec: ExperimentSpec
    trainer: DecentralizedTrainer
    state: TrainState                  # freshly initialized
    task: Task
    bundle: ModelBundle

    @property
    def eval_fn(self):
        return self.bundle.eval_fn


@dataclasses.dataclass
class Result:
    """JSON-dumpable outcome of ``run(spec)``; ``device`` names where it
    ran."""

    spec: dict
    history: list
    final: dict                        # last-step train metrics + eval
    steps_run: int
    wall_time_s: float
    wire: dict                         # bytes-on-the-wire accounting
    device: str = ""
    telemetry: Optional[dict] = None   # recorder summary (sink path, row
                                       # count, step-time percentiles) when
                                       # spec.telemetry.enabled
    heterogeneity: Optional[dict] = None  # partition stats from the task
    scenario: Optional[dict] = None    # the scenario masks' host time
                                       # (mask_host_s, mask_host_ms_per_step)
                                       # when the run's scenario masks

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, *, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)


def _make_opt(spec: ExperimentSpec):
    o = spec.optim
    if o.stages:
        return ChainOptimizer(
            lr=o.lr, weight_decay=o.weight_decay, fused=o.fused,
            stage_specs=tuple((n, dict(kw)) for n, kw in o.stages))
    return make_optimizer(o.name, lr=o.lr, weight_decay=o.weight_decay,
                          fused=o.fused, **o.kwargs)


def build(spec: ExperimentSpec, *, device="cuda",
          task: Task | None = None, mesh=None) -> Experiment:
    """Validate the spec, then assemble trainer + init state + client data +
    model bundle on ``device`` (with a ``mesh``, the mesh's device; see the
    module docstring).  The init draws from a ``torch.Generator``
    seeded with ``spec.seed`` (the reference's ``jax.random`` init cannot be
    reproduced; inject it with ``repro_torch.interop`` for parity).
    ``task`` is client data already built for specs of the same data
    section, model vocab, seed and node count (a Task hands out fresh
    batch iterators, so runs can share one); None builds it."""
    spec.validate()
    dev = resolve_device(device)
    topo = topo_lib.get_topology(spec.topology.name, spec.topology.n)
    if task is None:
        task = build_task(spec, topo.n)
    bundle = MODELS[spec.model.name](spec, task)

    lp = spec.loop
    lr_fn = None
    if lp.warmup or lp.decay_at:
        lr_fn = lr_schedule(spec.optim.lr, total_steps=lp.steps,
                            warmup=lp.warmup, decay_at=lp.decay_at,
                            decay=lp.decay, warmup_from=lp.warmup_from)
    opt = _make_opt(spec)
    c = spec.comm
    comm = make_comm(c.compressor, gamma=c.gamma,
                     error_feedback=c.error_feedback, backend=c.backend)
    telemetry_cfg = None
    if spec.telemetry.enabled:
        from repro_torch.telemetry import resolve_config
        telemetry_cfg = resolve_config(spec.telemetry.metrics,
                                       spec.telemetry.every)
    scenario = None
    sc = spec.scenario
    if sc.enabled:
        from repro_torch.scenario import ScenarioContext
        scenario = ScenarioContext(
            n=topo.n, seed=sc.seed, participation=sc.participation,
            dropout=sc.dropout, churn_window=sc.churn_window,
            straggler=sc.straggler)
    trainer = DecentralizedTrainer(
        bundle.loss_fn, opt, topo, lr_fn=lr_fn, device=dev,
        runtime=spec.runtime, comm=comm, rng_seed=lp.rng_seed or 0,
        mesh=mesh, overlap=spec.overlap, scenario=scenario,
        telemetry=telemetry_cfg, node_axis=spec.gossip.node_axis,
        gossip_schedule=spec.gossip.schedule)
    gen = torch.Generator().manual_seed(spec.seed)
    state = trainer.init(bundle.init_fn, gen)
    if telemetry_cfg is not None:
        # build-time constants of the 'wire', 'mixing', 'scenario' and
        # 'kernel' collectors, as the reference resolves them
        gap = topo.spectral_gap()
        ws = wire_stats(trainer, state.params)
        telemetry_cfg.static.update({
            "spectral_gap": gap,
            # consensus distance (a sqrt) contracts by sqrt(lambda_2)
            "rho": float(np.sqrt(max(1.0 - gap, 0.0))),
            "wire_bits_per_node_per_step": ws["bits_per_node_per_step"],
            "data_mean_tv": float(task.meta["heterogeneity"]["mean_tv"]),
            # the optimizer's analytic bytes for the path it takes
            # (fused='auto' resolves against the trainer's device), over
            # all n nodes whatever this rank holds
            "kernel_bytes_moved": float(T.chain_bytes_moved(
                opt._stages(), ws["params_per_node"] * topo.n,
                fused=opt.fused, device=trainer.device))})
        if "messages_per_step" in ws:
            telemetry_cfg.static["wire_messages_per_step"] = \
                ws["messages_per_step"]
    return Experiment(spec=spec, trainer=trainer, state=state, task=task,
                      bundle=bundle)


def wire_stats(trainer: DecentralizedTrainer, params) -> dict:
    """Bits each node puts on the wire per step (one whole-tree
    transmission per mix site).  Dense baseline: the full 32-bit tree per
    site.  Compressed comm replaces it with the compressor's bits; under a
    compiled schedule (gossip kind ``ring`` / ``sparse``), which ships the
    CHOCO/EF anchors whole, one message an edge a site, their bits are
    charged on top, and ``messages_per_step`` counts the schedule's
    messages (``GossipSchedule.messages_per_step``).  The dense mix on one
    device ships no extra message.  Shapes only: ``params`` may be this
    rank's block."""
    per_node = sum(l[0].numel() for l in tree_leaves(params))
    sites = count_mix_sites(trainer.optimizer, params, trainer._mixing[0])
    dense_bits = 32.0 * per_node * sites
    out = {"mix_sites": int(sites), "params_per_node": int(per_node),
           "dense_bits_per_node_per_step": dense_bits}
    messages = None
    resolved = trainer._resolved
    if resolved.kind in ("ring", "sparse"):
        from repro_torch.core.gossip import compile_gossip_schedule
        schedule = (resolved.schedule
                    or compile_gossip_schedule(trainer.topology))
        messages = schedule.messages_per_step()
        out["messages_per_step"] = messages
    if trainer.comm is not None:
        comp_bits = trainer.comm.wire_bits_per_site(params) * sites
        anchor_bits = 0.0
        if messages is not None:
            # a full-width anchor an edge message, over the n senders
            anchor_bits = 32.0 * per_node * sites * (
                messages / trainer.topology.n)
        out["compressed_bits_per_node_per_step"] = comp_bits
        out["anchor_bits_per_node_per_step"] = anchor_bits
        out["bits_per_node_per_step"] = comp_bits + anchor_bits
    else:
        out["bits_per_node_per_step"] = dense_bits
    out["ratio_vs_dense"] = dense_bits / max(out["bits_per_node_per_step"],
                                             1e-9)
    return out


def _make_recorder(ex: Experiment, telemetry_path: str = ""):
    """Recorder and sink for a telemetry-enabled experiment (None
    otherwise).  ``telemetry_path`` overrides ``spec.telemetry.path``; a
    file sink with neither writes ``metrics.<ext>`` in the working
    directory."""
    if ex.trainer.telemetry is None:
        return None
    from repro_torch.telemetry import TelemetryRecorder, make_sink
    tl = ex.spec.telemetry
    path = telemetry_path or tl.path
    if tl.sink != "memory" and not path:
        path = "metrics.jsonl" if tl.sink == "jsonl" else "metrics.csv"
    return TelemetryRecorder(ex.trainer.telemetry, make_sink(tl.sink, path))


def run(spec: ExperimentSpec, *, device="cuda", log_fn=print,
        state: TrainState | None = None, with_state: bool = False,
        checkpoint_path: str = "", resume: str = "",
        telemetry_path: str = "", task: Task | None = None, mesh=None):
    """Build + train + evaluate one spec on ``device``; returns a
    :class:`Result`, or with ``with_state=True`` ``(result, final_state)``
    (for a consensus export or a launcher's own checkpoint).  ``state``
    replaces the built initial state, e.g. the reference's init carried
    over with ``repro_torch.interop.train_state_from_numpy`` (node-stacked
    ``[n, ...]``: each rank keeps its rows); ``task`` and ``mesh`` are
    passed to :func:`build`, and with a mesh the returned state is this
    rank's block.

    ``checkpoint_path`` with ``spec.loop.checkpoint_every`` saves the full
    TrainState (params, opt, model and comm state, step counter) and the
    trainer's generator state every that many steps, and once at the end;
    ``resume=<path>`` restores such a checkpoint (written by either
    package), replays the batch stream to its step and runs the remaining
    ``loop.steps - step`` steps, so that the run ends as the uninterrupted
    one.  History ``step`` indices are absolute.

    With ``spec.telemetry.enabled`` on-cadence steps run the collectors and
    one row per such step goes to the sink (``telemetry_path`` overrides
    its location); ``Result.telemetry`` holds the recorder's summary."""
    ex = build(spec, device=device, task=task, mesh=mesh)
    recorder = _make_recorder(ex, telemetry_path)
    lp = spec.loop
    state = ex.state if state is None else ex.trainer.finalize_state(state)
    # the reference's loop rng key, kept for its resume (the port has none)
    rng = np.array([0, lp.rng_seed or 0], np.uint32)
    start = 0
    batch_iter = ex.task.make_iter()
    if resume:
        state, rng, meta = restore_train_state(
            resume, ex.trainer.gather_state(ex.state),
            generator=ex.trainer._comm_gen)
        state = ex.trainer.finalize_state(state)
        start = int(meta["step"])
        if start > lp.steps:
            raise ValueError(
                f"resume checkpoint is at step {start} but loop.steps="
                f"{lp.steps}; raise loop.steps to continue")
        for _ in range(start):       # replay the deterministic batch stream
            next(batch_iter)
        log_fn(f"resumed from {resume} at step {start}")

    def save(done, st):
        # every rank gathers (a collective); rank 0 writes
        full = ex.trainer.gather_state(st)
        if mesh is None or mesh.rank == 0:
            save_train_state(checkpoint_path, full, rng=rng,
                             generator=ex.trainer._comm_gen, step=done)

    ckpt_kw = {}
    if checkpoint_path and lp.checkpoint_every:
        ckpt_kw = {"checkpoint_every": lp.checkpoint_every,
                   "checkpoint_fn": save}

    t0 = time.perf_counter()
    if lp.chunk > 1:
        state, history = run_training_scanned(
            ex.trainer, state, batch_iter, lp.steps - start, chunk=lp.chunk,
            log_every=lp.log_every, log_fn=log_fn, step_offset=start,
            telemetry=recorder, **ckpt_kw)
    else:
        state, history = run_training(
            ex.trainer, state, batch_iter, lp.steps - start,
            log_every=lp.log_every, log_fn=log_fn, step_offset=start,
            telemetry=recorder, **ckpt_kw)
    if ex.trainer.device.type == "cuda":
        torch.cuda.synchronize(ex.trainer.device)
    wall = time.perf_counter() - t0
    if checkpoint_path:
        save(int(state.t), state)

    final = dict(history[-1]) if history else {}
    final.pop("step", None)
    if spec.eval.enabled and ex.bundle.eval_fn is not None \
            and ex.task.eval_batches:
        final.update(ex.trainer.evaluate(state, ex.bundle.eval_fn,
                                         ex.task.eval_batches))

    steps_run = (history[-1]["step"] + 1) if history else 0
    masks_info = None
    if ex.trainer._scenario is not None:
        masks_info = {"mask_host_s": ex.trainer.mask_host_s,
                      "mask_host_ms_per_step": ex.trainer.mask_host_s
                      * 1e3 / max(steps_run - start, 1)}
    wire = wire_stats(ex.trainer, state.params)
    wire["total_mbytes_per_node"] = (
        wire["bits_per_node_per_step"] * steps_run / 8e6)
    result = Result(spec=spec.to_dict(), history=history, final=final,
                    steps_run=steps_run, wall_time_s=wall, wire=wire,
                    device=describe_device(ex.trainer.device),
                    telemetry=(recorder.close() if recorder is not None
                               else None),
                    heterogeneity=ex.task.meta.get("heterogeneity"),
                    scenario=masks_info)
    return (result, state) if with_state else result
