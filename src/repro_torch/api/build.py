"""The one assembly path: ``build(spec) -> Experiment`` and
``run(spec) -> Result``.

Port of ``repro/api/build.py`` for the slice the spec layer accepts (see
``api/spec.py``): a registry optimizer, or a ``ChainOptimizer`` from
``spec.optim.stages``.  Both run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device the default raises.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import torch

from repro_torch.comm import count_mix_sites, make_comm
from repro_torch.core import topology as topo_lib
from repro_torch.core.optim import ChainOptimizer, make_optimizer
from repro_torch.device import describe_device, resolve_device
from repro_torch.train import (DecentralizedTrainer, TrainState, lr_schedule,
                               run_training, run_training_scanned)
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
    telemetry: Optional[dict] = None   # always None until slice 5
    heterogeneity: Optional[dict] = None  # partition stats from the task

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


def build(spec: ExperimentSpec, *, device="cuda") -> Experiment:
    """Validate the spec, then assemble trainer + init state + client data +
    model bundle on ``device``.  The init draws from a ``torch.Generator``
    seeded with ``spec.seed`` (the reference's ``jax.random`` init cannot be
    reproduced; inject it with ``repro_torch.interop`` for parity)."""
    spec.validate()
    dev = resolve_device(device)
    topo = topo_lib.get_topology(spec.topology.name, spec.topology.n)
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
    trainer = DecentralizedTrainer(
        bundle.loss_fn, opt, topo, lr_fn=lr_fn, device=dev,
        runtime=spec.runtime, comm=comm, rng_seed=lp.rng_seed or 0)
    gen = torch.Generator().manual_seed(spec.seed)
    state = trainer.init(bundle.init_fn, gen)
    return Experiment(spec=spec, trainer=trainer, state=state, task=task,
                      bundle=bundle)


def wire_stats(trainer: DecentralizedTrainer, params) -> dict:
    """Bits each node puts on the wire per step (one whole-tree
    transmission per mix site).  Dense baseline: the full 32-bit tree per
    site.  Compressed comm replaces it with the compressor's bits; the
    anchor gossip is dense ``W @ x`` on one device, which ships no extra
    message, so its bits are 0 (the reference charges them only under a
    ppermute schedule, which comes with slice 8)."""
    per_node = sum(l[0].numel() for l in tree_leaves(params))
    sites = count_mix_sites(trainer.optimizer, params, trainer._mixing[0])
    dense_bits = 32.0 * per_node * sites
    out = {"mix_sites": int(sites), "params_per_node": int(per_node),
           "dense_bits_per_node_per_step": dense_bits}
    if trainer.comm is not None:
        comp_bits = trainer.comm.wire_bits_per_site(params) * sites
        out["compressed_bits_per_node_per_step"] = comp_bits
        out["anchor_bits_per_node_per_step"] = 0.0
        out["bits_per_node_per_step"] = comp_bits
    else:
        out["bits_per_node_per_step"] = dense_bits
    out["ratio_vs_dense"] = dense_bits / max(out["bits_per_node_per_step"],
                                             1e-9)
    return out


def run(spec: ExperimentSpec, *, device="cuda", log_fn=print,
        state: TrainState | None = None) -> Result:
    """Build + train + evaluate one spec on ``device``.  ``state`` replaces
    the built initial state, e.g. the reference's init carried over with
    ``repro_torch.interop.train_state_from_numpy``."""
    ex = build(spec, device=device)
    lp = spec.loop
    state = ex.state if state is None else state
    batch_iter = ex.task.make_iter()

    t0 = time.perf_counter()
    if lp.chunk > 1:
        state, history = run_training_scanned(
            ex.trainer, state, batch_iter, lp.steps, chunk=lp.chunk,
            log_every=lp.log_every, log_fn=log_fn)
    else:
        state, history = run_training(
            ex.trainer, state, batch_iter, lp.steps,
            log_every=lp.log_every, log_fn=log_fn)
    if ex.trainer.device.type == "cuda":
        torch.cuda.synchronize(ex.trainer.device)
    wall = time.perf_counter() - t0

    final = dict(history[-1]) if history else {}
    final.pop("step", None)
    if spec.eval.enabled and ex.bundle.eval_fn is not None \
            and ex.task.eval_batches:
        final.update(ex.trainer.evaluate(state, ex.bundle.eval_fn,
                                         ex.task.eval_batches))

    steps_run = (history[-1]["step"] + 1) if history else 0
    wire = wire_stats(ex.trainer, state.params)
    wire["total_mbytes_per_node"] = (
        wire["bits_per_node_per_step"] * steps_run / 8e6)
    return Result(spec=spec.to_dict(), history=history, final=final,
                  steps_run=steps_run, wall_time_s=wall, wire=wire,
                  device=describe_device(ex.trainer.device),
                  heterogeneity=ex.task.meta.get("heterogeneity"))
