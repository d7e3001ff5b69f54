"""The benchmark of the port's decentralized training step.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>``, the
file its entry gives) and a traffic mix (``traffic/<name>.json``); its
limits are ``limits/<cell>.json``. Each piece is found by name:

* the configuration's ``family``: ``reference/<family>.py`` makes the
  benchmark's weights, holds the plain reference of the model and counts
  its FLOPs;
* the configuration's ``training.optimizer``: ``reference/<optimizer>.py``
  is the optimizer's reference, given ``lr``, ``weight_decay`` and
  ``kwargs``;
* the mix's ``generator``: ``traffic/<generator>.py`` makes the batches;
* the mix's ``topology``: ``topology/<topology>.py`` gives W;
* the mix's ``program`` block sets the sections of the port's
  ``ExperimentSpec`` that it names (``runtime``, ``comm``, ``gossip``,
  ``overlap``, ...), and its ``comm.compressor`` (``dense`` where it names
  none) picks the exchange's reference, ``gossip/<compressor>.py``;
* each metric is read by ``metrics/<metric>.py``.

A new cell, configuration, mix, topology, exchange, optimizer or metric is
new files and entries; nothing here names one. A run uses one card: the
harness has no path across processes yet, and refuses a cell of more.

A run (``run_cell``):

1. builds the trainer through the port's ``repro_torch.api.build`` of the
   cell's ``ExperimentSpec`` (every mix here: ``runtime='vmap'``, dense
   gossip, ``fused='auto'``, so that the optimizer launches ``qg_step``)
   and hands it the benchmark's weights, drawn on the device from the
   seed, through ``trainer.init``;
2. makes the mix's batches from the seed on the host;
3. drives the first three steps through ``put_batch`` and ``step``, as
   the window does, on rows that all differ, and keeps their readings
   (each step's loss, the first gradient as the optimizer's buffer holds
   it, the parameters' change), then two more steps, all of them set-up;
4. times ``put_batch`` and ``step`` in a loop for ``seconds``, with no
   read of the device inside the window;
5. with ``trace``, profiles the device over a few more steps;
6. frees the program's state and has the reference follow the same three
   steps from the same weights and batches, and compares.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from perfbench import tree_paths
from perfbench.trace import TraceWindow, from_profile

ROOT = Path(__file__).resolve().parents[1]

#: top-level module names that no run may hold: JAX and the JAX package
BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")

#: cards a run uses
CARDS = 1
#: steps the reference follows and the readings compare
CHECKED_STEPS = 3
#: further warm-up steps before the window
WARM_STEPS = 2
#: host seconds of steps a traced window holds, and its bounds in steps
TRACE_SECONDS, TRACE_MIN_STEPS, TRACE_MAX_STEPS = 2.0, 3, 20
#: a leaf whose first gradient in the reference is under this share of the
#: median leaf's moves by weight decay and rounding alone: left out of the
#: change's comparison
NOUGHT_GRAD = 1e-3


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    config: dict
    mix: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list

    def module(self, kind: str, name: str):
        """``perfbench/<kind>/<name>.py`` of this checkout, loaded."""
        path = self.root / "perfbench" / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"perfbench.{kind}.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    @functools.cached_property
    def family(self):
        """``reference/<family>.py``: the weights, the reference, the
        FLOPs."""
        return self.module("reference", self.config["family"])

    @functools.cached_property
    def traffic(self):
        """``traffic/<generator>.py``: ``batches(mix, config, seed)``."""
        return self.module("traffic", self.mix["generator"])

    @functools.cached_property
    def optimizer(self):
        """``reference/<optimizer>.py``: ``train_readings``."""
        return self.module("reference", self.config["training"]["optimizer"])

    @functools.cached_property
    def topology(self):
        """``topology/<topology>.py``: ``mixing(n)``."""
        return self.module("topology", self.mix["topology"])

    @property
    def comm(self) -> dict:
        """The mix's settings of the port's ``CommSpec``."""
        return self.mix.get("program", {}).get("comm", {})

    @functools.cached_property
    def gossip(self):
        """``gossip/<compressor>.py``: ``mixer(w, comm)``."""
        return self.module("gossip", self.comm.get("compressor", "dense"))


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    applies = lambda m: name in m.get("workloads", [name])
    return Cell(
        name=name, root=root, config=_load(root / conf["file"]),
        mix=_load(root / "perfbench" / "traffic" / f"{cell['traffic']}.json"),
        limits=_load(root / "perfbench" / "limits" / f"{name}.json"),
        chips=int(cell["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def make_spec(cell: Cell, seed: int):
    """The port's ``ExperimentSpec`` of a cell: its data, graph, optimizer
    and model, then the sections that the mix's ``program`` block sets."""
    from repro_torch.api.spec import (DataSpec, EvalSpec, ExperimentSpec,
                                      LoopSpec, ModelSpec, OptimSpec,
                                      TopologySpec)
    c, mix, tr = cell.config, cell.mix, cell.config["training"]
    data = {"dataset": c["program"]["dataset"], "alpha": mix["alpha"],
            "batch": mix["batch"]}
    if "seq_len" in mix:
        data.update(seq_len=mix["seq_len"], vocab=c["vocab_size"])
    if "image_hw" in c:
        data.update(hw=c["image_hw"], n_classes=c["classes"])
    return ExperimentSpec(
        name=cell.name, seed=seed, data=DataSpec(**data),
        topology=TopologySpec(name=mix["topology"], n=mix["nodes"]),
        optim=OptimSpec(name=tr["optimizer"], lr=tr["lr"],
                        weight_decay=tr["weight_decay"],
                        kwargs=tr.get("kwargs", {}),
                        fused=tr.get("fused", "auto")),
        loop=LoopSpec(steps=1), eval=EvalSpec(enabled=False),
        model=ModelSpec(**c["program"]["model"]),
    ).replace(**mix.get("program", {}))


def build_program(cell: Cell, seed: int, device: str):
    """``(trainer, state, x0)``: the trainer from ``api.build`` and its
    state from the benchmark's weights (``x0``, one node's tree)."""
    from repro_torch.api import build
    from repro_torch.api.data import Task
    c = cell.config
    task = Task(n_nodes=cell.mix["nodes"], seed=seed,
                make_iter=lambda: iter(()),
                d_in=(c["image_hw"] ** 2 * c["channels"]
                      if "image_hw" in c else None),
                n_classes=c.get("classes"), meta={})
    ex = build(make_spec(cell, seed), device=device, task=task)
    trainer = ex.trainer
    del ex          # with build's own host-drawn state, replaced below
    gc.collect()
    made = {}

    def init_fn(generator):
        made["x0"], model_state = cell.family.init_params(
            c, generator, trainer.device)
        return made["x0"], model_state

    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    state = trainer.init(init_fn, gen)
    return trainer, state, made["x0"]


def _state_at(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def first_steps(cell: Cell, trainer, state, x0, host: list):
    """Steps 1..3 through the window's calls, and their readings."""
    readings = {"loss": []}
    for k in range(CHECKED_STEPS):
        state, met = trainer.step(state, trainer.put_batch(host[k]))
        readings["loss"].append(float(met["loss"]))
        if k == 0:
            buf = _state_at(state.opt_state,
                            cell.config["training"]["buffer"])
            readings["grad"] = {p: tree_paths.norm64(v) for p, v in
                                tree_paths.flatten(buf).items()}
    start = tree_paths.flatten(x0)
    with torch.no_grad():
        readings["change"] = {
            p: math.sqrt(sum(tree_paths.norm64(v[i] - start[p]) ** 2
                             for i in range(v.shape[0])))
            for p, v in tree_paths.flatten(state.params).items()}
    return state, readings


def window(trainer, state, host: list, first: int, seconds: float = 0.0,
           steps: int = 0):
    """``put_batch`` and ``step`` from host batch ``first`` on, cycling,
    for ``seconds`` (or ``steps`` steps), between two device syncs:
    ``(state, steps, seconds, host seconds inside step)``."""
    dev = trainer.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    done, dispatch = 0, 0.0
    while True:
        batch = trainer.put_batch(host[(first + done) % len(host)])
        t = time.perf_counter()
        state, _ = trainer.step(state, batch)
        dispatch += time.perf_counter() - t
        done += 1
        if (steps and done >= steps) or (
                not steps and time.perf_counter() - t0 >= seconds):
            break
    sync()
    return state, done, time.perf_counter() - t0, dispatch


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products and cuDNN's convolutions in TF32 or in fp32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def reference_readings(cell: Cell, seed: int, host: list, device, *,
                       tf32: bool = False, fault: str = "") -> dict:
    """The reference's readings of the first steps from the seed's weights
    and batches. ``tf32`` computes it one precision below the
    configuration's (the control); ``fault`` plants one in it: ``half``
    (each node's loss over the first half of its rows), ``nomix`` (no
    exchange between the nodes)."""
    c, family = cell.config, cell.family
    tr = c["training"]
    gen = torch.Generator(device=device).manual_seed(seed)
    template, _ = family.init_params(c, gen, device)
    n = cell.mix["nodes"]
    w = torch.tensor(cell.topology.mixing(n), dtype=torch.float32,
                     device=device)
    if fault == "nomix":
        w = torch.eye(n, device=device)
    batches = [tuple(torch.from_numpy(a).to(device) for a in hb)
               for hb in host[:CHECKED_STEPS]]

    def node_grad(leaves: dict, batch: tuple):
        if fault == "half":
            batch = tuple(a[:a.shape[0] // 2] for a in batch)
        with torch.enable_grad():
            loss = family.node_loss(
                c, tree_paths.rebuild(template, leaves), batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), dict(zip(leaves, grads))

    with precision(tf32):
        return cell.optimizer.train_readings(
            node_grad, tree_paths.flatten(template), batches,
            cell.gossip.mixer(w, cell.comm), lr=tr["lr"],
            weight_decay=tr["weight_decay"], **tr.get("kwargs", {}))


def leaf_gaps(got: dict, ref: dict, key: str) -> dict:
    """By leaf path, the gap of ``key``'s norm (not the norm of the
    difference) over the reference's norm of that leaf or of the median
    leaf, whichever is larger; for ``change`` only the leaves whose first
    gradient is not nought to rounding."""
    keys = list(ref[key])
    if key == "change":
        raw = ref["grad_raw"]
        floor = NOUGHT_GRAD * statistics.median(raw.values())
        keys = [p for p in keys if raw[p] >= floor]
    scale = statistics.median(ref[key][p] for p in keys)
    return {p: _finite(abs(got[key][p] - ref[key][p])
                       / max(ref[key][p], scale)) for p in keys}


def _finite(v: float) -> float:
    """A gap that is not a finite number (a NaN or an overflow on either
    side) reads infinite, so that no maximum passes over it."""
    return v if math.isfinite(v) else math.inf


def compare(got: dict, ref: dict) -> dict:
    """The numbers compared: ``loss_gap``, the largest relative gap of a
    step's loss; ``grad_gap`` and ``change_gap``, the largest of
    :func:`leaf_gaps`."""
    return {"loss_gap": max(_finite(abs(a - b) / abs(b)) for a, b in
                            zip(got["loss"], ref["loss"])),
            "grad_gap": max(leaf_gaps(got, ref, "grad").values()),
            "change_gap": max(leaf_gaps(got, ref, "change").values())}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunStats:
    """What the metric readers read (``metrics/<name>.py``)."""
    steps: int
    window_s: float
    dispatch_s: float          # host time inside trainer.step
    setup_s: float
    peak_bytes: int
    flops_per_step: float
    elements: int
    trace: TraceWindow | None = None

    @property
    def step_ms(self) -> float:
        return self.window_s * 1e3 / self.steps


def card() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    return {"nvidia_smi": out[0] if out else "not read"}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start,
             device: str = "cuda") -> tuple[dict, dict]:
    """One run: ``(result line, {number: (value, limit)})``."""
    host = cell.traffic.batches(cell.mix, cell.config, seed)
    trainer, state, x0 = build_program(cell, seed, device)
    elements = sum(v.numel() for v in
                   tree_paths.flatten(state.params).values())
    state, got = first_steps(cell, trainer, state, x0, host)
    del x0
    state = window(trainer, state, host, CHECKED_STEPS,
                   steps=WARM_STEPS)[0]
    dev = trainer.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    first = CHECKED_STEPS + WARM_STEPS
    state, steps, window_s, dispatch_s = window(trainer, state, host, first,
                                                seconds)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    stats = RunStats(steps, window_s, dispatch_s, setup_s, peak,
                     cell.family.flops_per_step(cell.config, cell.mix),
                     elements)
    if trace:
        traced = min(TRACE_MAX_STEPS, max(
            TRACE_MIN_STEPS, round(TRACE_SECONDS * 1e3 / stats.step_ms)))
        acts = [torch.profiler.ProfilerActivity.CUDA if cuda
                else torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            state, _, traced_s, _ = window(trainer, state, host,
                                           first + steps, steps=traced)
        stats.trace = from_profile(prof, traced, traced_s)
        del prof
    del state, trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_readings(cell, seed, host, dev)
    gaps = compare(got, ref)
    numbers = {k: (v, float(cell.limits[k])) for k, v in gaps.items()}
    kinds = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in kinds:
        value = cell.module("metrics", m["name"]).read(stats)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": CARDS, "memory_peak_bytes": peak}
    result = {"correct": all(v <= lim for v, lim in numbers.values()),
              "attempted": steps,
              "failed": sum(v > lim for v, lim in numbers.values()),
              "metrics": metrics, "device": dev_info}
    if stats.trace is not None:
        dev_info["busy_s"] = stats.trace.busy_s()
        dev_info["window_s"] = stats.trace.window_s
        result["breakdown"] = stats.trace.breakdown()
    result["card"] = card() if cuda else {}
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in numbers.items()}
    return result, numbers


def banned_modules() -> list:
    """The top-level names of ``BANNED_MODULES`` that this process holds."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(BANNED_MODULES))
