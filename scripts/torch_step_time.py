#!/usr/bin/env python3
"""Milliseconds a training step of the port takes on the card, whole runs,
and the tokens/s of serving TinyLlama-1.1B.

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
RUN_NAMES = [label for label, _, _ in STEP_RUNS] + [SERVE_RUN]


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
    return 0


if __name__ == "__main__":
    sys.exit(main())
