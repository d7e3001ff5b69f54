#!/usr/bin/env python3
"""Milliseconds a training step of the port takes on the card, whole runs,
the tokens/s of serving TinyLlama-1.1B, and where the time of the launch
tooling's split train step goes.

    python3 scripts/torch_step_time.py [--src DIR] [--reps N] [--label L]
                                       [--runs NAME ...]

Runs each spec of STEP_RUNS through ``repro_torch.api.run`` on the CUDA
device: one short warm-up run (kernel build, cuBLAS and allocator set-up),
then ``--reps`` full runs.  A run's time is ``api.run``'s wall time, which
covers the training loop and ends in a device sync.  Then it serves
TinyLlama-1.1B at full width (random weights from seed 0) through the
paged-decode kernel as ``python -m repro_torch.serve --arch tinyllama-1.1b
--full --use-pallas --requests 16`` does: one warm-up run of the engine,
then ``--reps`` runs, each a fresh engine (tokens/s over the engine's run,
ending in a device sync, and its decode-step p50).  Prints one JSON line
per run (label, run, ms/step or tokens/s, card) and nothing else on stdout.
``--runs`` keeps the named runs only (default: all).

The ``tinyllama_split`` run times the launch tooling's train step on
TinyLlama-1.1B at its published size (fp32, 2 nodes x [1, 1024], remat
full; chip_smoke's ``launch`` step) three ways in one process: ``mesh=None``
with the split's knobs (``megatron_attn``, ``shard_activations``,
``pin_moe_dispatch``: only ``repeat_kv`` acts there), the compute split over
'model' on a ``('data', 'model')`` mesh of (1, 1) over a one-rank NCCL group
with the same knobs, and the gather-on-use step (the knobs off) on that
mesh.  For each: ``--reps`` steps after one warm-up, each timed between two
device syncs; one more step timed when it returns to the host and after the
device sync (a step whose host return is its wall time is host-bound); the
caching allocator's counters over the timed steps.  Then one split step
under ``torch.profiler``: its device and host self-time totals and the ops
that take the most of each.

The ``pinned_decode`` run times the launch tooling's pinned decode
(``pin_decode_cache`` with the split's knobs, on that one-rank mesh)
beside ``mesh=None`` on zamba2-7b and llama-3.2-vision-11b at their
published widths cut in depth (chip_smoke's ``PIN_CUTS``) and mamba2-130m
whole, fp32: a [2, 64] prefill through the prefill builder, one warm-up
decode step, then ``--reps`` steps each timed between two device syncs,
the ``torch.distributed`` collectives a step (counted by wrapping the
module's functions), and one more step of each under ``torch.profiler``
(device and host self-time totals).

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two commits are timed by the same script
on the same card: unpack one of them elsewhere and alternate the two.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

#: (label, preset, overrides): the quickstart QG preset (one ``qg_step`` a
#: step), the CHOCO top-k preset on the kernels, and the CIFAR preset
#: (ResNet-20's 80 leaves: the loop that walks the most leaves a step)
STEP_RUNS = [
    ("quickstart_qg", "quickstart_ring16_alpha0.1_qg", ()),
    ("choco_topk_auto", "choco_topk0.01_ring16_qg", ("comm.backend=auto",)),
    ("cifar_qg", "cifar_ring16_alpha0.1_qg", ()),
]
#: the serve CLI's defaults and request set, at 16 requests
SERVE_KW = {"n_slots": 8, "page_size": 16, "max_len": 256,
            "prefill_chunk": 32}
SERVE_REQUESTS, SERVE_MAX_NEW = 16, 16
SERVE_RUN = "tinyllama_serve"
SPLIT_RUN = "tinyllama_split"
PIN_RUN = "pinned_decode"
#: (arch, config overrides): the published widths, cut in depth
PIN_CUTS = (("zamba2-7b", {"n_layers": 7, "tail_layers": 1}),
            ("llama-3.2-vision-11b", {"n_layers": 5}),
            ("mamba2-130m", {}))
PIN_BATCH, PIN_PROMPT = 2, 64
COLLECTIVES = ("all_gather_into_tensor", "all_reduce",
               "reduce_scatter_tensor", "all_to_all_single")
SPLIT_KNOBS = dict(megatron_attn=True, shard_activations=True,
                   pin_moe_dispatch=True)
ALLOCATOR = ("num_alloc_retries", "num_sync_all_streams", "num_device_alloc",
             "num_device_free")
RUN_NAMES = [label for label, _, _ in STEP_RUNS] + [SERVE_RUN, SPLIT_RUN,
                                                    PIN_RUN]


def serve_runs(reps: int):
    """``(tokens/s, decode p50 ms)`` of ``reps`` engine runs serving
    TinyLlama-1.1B at full width, after one warm-up run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.__main__ import make_requests

    cfg = get_config("tinyllama-1.1b")
    params = tf.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    reqs = make_requests(SERVE_REQUESTS, cfg.vocab_size, seed=0,
                         max_new=SERVE_MAX_NEW)
    out = []
    for rep in range(reps + 1):
        eng = ServeEngine(params, cfg, use_pallas=True, **SERVE_KW)
        t0 = time.perf_counter()
        outs = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rep:
            out.append((sum(len(o.tokens) for o in outs) / wall,
                        eng.stats()["phases"]["decode"]["p50_s"] * 1e3))
    return out


def _synced_ms(torch, fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _top(rows, key: str, n: int = 8) -> list:
    """The ``n`` rows of a profile with the most ``key`` (microseconds):
    ``[name (cut to 80 characters), ms, calls]``."""
    rows = sorted(rows, key=lambda e: getattr(e, key), reverse=True)[:n]
    return [[e.key[:80], getattr(e, key) / 1e3, e.count] for e in rows]


def split_runs(reps: int):
    """``(step, record)`` of the ``tinyllama_split`` run's three steps and
    the split step's profile (module docstring)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import distributed, steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    store = Path(tempfile.mkdtemp()) / "store"
    dev = distributed.initialize(f"file://{store}", 1, 0, backend="nccl",
                                 timeout_s=120)
    sc = steps.StepConfig(get_config("tinyllama-1.1b"), InputShape(
        "split_train", seq_len=1024, global_batch=2, kind="train"),
        n_nodes=2, param_dtype=torch.float32, **SPLIT_KNOBS)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tree_map(lambda *ls: torch.stack(ls),
                      *[tf.init_lm(gen, sc.cfg) for _ in range(2)])
    toks = np.random.default_rng(0).integers(0, sc.cfg.vocab_size,
                                             size=(2, 1, 1025),
                                             dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks[..., :-1].copy()).to(dev),
             "labels": torch.from_numpy(toks[..., 1:].copy()).to(dev)}
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    off = dataclasses.replace(sc, **{k: False for k in SPLIT_KNOBS})
    try:
        for label, mesh_, s in (("mesh=None", None, sc), ("split", mesh, sc),
                                ("gather-on-use", mesh, off)):
            step = steps.build_train_step(s, mesh=mesh_)
            opt = steps.make_opt(s).init(params)
            _synced_ms(torch, step, params, opt, batch)       # warm-up
            before = torch.cuda.memory_stats(dev)
            ms = [_synced_ms(torch, step, params, opt, batch)[1]
                  for _ in range(reps)]
            after = torch.cuda.memory_stats(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, opt, batch)
            host = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            del out
            yield label, {
                "ms_per_step": ms, "host_return_ms": host, "wall_ms": wall,
                "allocator": {k: after.get(k, 0) - before.get(k, 0)
                              for k in ALLOCATOR}}
            if label == "split":
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    out = step(params, opt, batch)
                    torch.cuda.synchronize()
                del out
                # the device's rows are its kernels and copies (the
                # totals of the profiler's own table)
                ka = prof.key_averages()
                kernels = [e for e in ka if e.device_type == DeviceType.CUDA
                           and not e.is_user_annotation]
                yield "split profile", {
                    "device_self_ms": sum(e.self_device_time_total
                                          for e in kernels) / 1e3,
                    "host_self_ms": sum(e.self_cpu_time_total
                                        for e in ka) / 1e3,
                    "top_device": _top(kernels, "self_device_time_total"),
                    "top_host": _top(ka, "self_cpu_time_total")}
            del opt, step
            torch.cuda.empty_cache()
    finally:
        distributed.shutdown()


def _profiled(torch, fn, *args) -> dict:
    """Device and host self-time totals (ms) of one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn(*args)
        torch.cuda.synchronize()
    del out
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    return {"device_self_ms": sum(e.self_device_time_total
                                  for e in kernels) / 1e3,
            "host_self_ms": sum(e.self_cpu_time_total for e in ka) / 1e3}


def _counted(counts: dict):
    """Adds one to ``counts[name]`` a call of each of
    ``torch.distributed``'s COLLECTIVES (``launch/mesh.py`` reaches them
    through the module's attributes); returns the restoring function."""
    import torch.distributed as dist
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name, f):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return f(*args, **kwargs)
        return call

    for name, f in saved.items():
        setattr(dist, name, wrap(name, f))

    def restore():
        for name, f in saved.items():
            setattr(dist, name, f)
    return restore


def pin_runs(reps: int):
    """``(arch, way, record)`` of the ``pinned_decode`` run (module
    docstring)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import distributed, steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    store = Path(tempfile.mkdtemp()) / "store"
    dev = distributed.initialize(f"file://{store}", 1, 0, backend="nccl",
                                 timeout_s=120)
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    rng = np.random.default_rng(0)
    try:
        for arch, cut in PIN_CUTS:
            cfg = dataclasses.replace(get_config(arch), **cut)
            params = tf.init_lm(torch.Generator(device=dev).manual_seed(0),
                                cfg)
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, size=(PIN_BATCH, PIN_PROMPT),
                dtype=np.int32)).to(dev)
            img = None
            if cfg.n_image_tokens:
                img = torch.from_numpy(rng.standard_normal(
                    (PIN_BATCH, cfg.n_image_tokens, cfg.d_model)).astype(
                        np.float32)).to(dev)
            sc = steps.StepConfig(cfg, InputShape(
                "pin", PIN_PROMPT + reps + 2, PIN_BATCH, "decode"),
                n_nodes=1, param_dtype=torch.float32)
            pinned = dataclasses.replace(sc, pin_decode_cache=True,
                                         **SPLIT_KNOBS)
            for way, s, mesh_ in (("mesh=None", sc, None),
                                  ("pinned", pinned, mesh)):
                logits, cache = steps.build_prefill_step(s, mesh=mesh_)(
                    params, tokens, img)
                decode = steps.build_decode_step(s, mesh=mesh_)
                token = torch.argmax(logits, -1, keepdim=True)
                pos = PIN_PROMPT
                _synced_ms(torch, decode, params, token, pos, cache)
                counts, ms = {}, []
                restore = _counted(counts)
                try:
                    for i in range(reps):
                        ms.append(_synced_ms(torch, decode, params, token,
                                             pos + 1 + i, cache)[1])
                finally:
                    restore()
                prof = _profiled(torch, decode, params, token,
                                 pos + 1 + reps, cache)
                yield arch, way, {
                    "ms_per_step": ms,
                    "collectives_per_step": {k: v / reps
                                             for k, v in counts.items()},
                    **prof}
                del logits, cache, decode
                torch.cuda.empty_cache()
            del params
            torch.cuda.empty_cache()
    finally:
        distributed.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--label", default="")
    ap.add_argument("--runs", nargs="+", default=RUN_NAMES,
                    choices=RUN_NAMES)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_step_time: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch import api

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    quiet = lambda *_: None
    for label, preset, overrides in STEP_RUNS:
        if label not in args.runs:
            continue
        spec = api.presets.get(preset).override(*overrides)
        api.run(spec.override("loop.steps=25"), log_fn=quiet)
        for rep in range(args.reps):
            res = api.run(spec, log_fn=quiet)
            print(json.dumps({
                "label": args.label, "run": label, "rep": rep,
                "steps": res.steps_run,
                "ms_per_step": res.wall_time_s / res.steps_run * 1e3,
                "card": card}), flush=True)
    serve = serve_runs(args.reps) if SERVE_RUN in args.runs else []
    for rep, (tps, p50) in enumerate(serve):
        print(json.dumps({
            "label": args.label, "run": SERVE_RUN, "rep": rep,
            "requests": SERVE_REQUESTS, "tokens_per_s": tps,
            "decode_p50_ms": p50, "card": card}), flush=True)
    if SPLIT_RUN in args.runs:
        for step, rec in split_runs(args.reps):
            print(json.dumps({"label": args.label, "run": SPLIT_RUN,
                              "step": step, **rec, "card": card}),
                  flush=True)
    if PIN_RUN in args.runs:
        for arch, way, rec in pin_runs(args.reps):
            print(json.dumps({"label": args.label, "run": PIN_RUN,
                              "arch": arch, "way": way, **rec,
                              "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
