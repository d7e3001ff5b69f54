#!/usr/bin/env python3
"""Milliseconds a training step of the port takes on the card, whole runs.

    python3 scripts/torch_step_time.py [--src DIR] [--reps N] [--label L]

Runs each spec of STEP_RUNS through ``repro_torch.api.run`` on the CUDA
device: one short warm-up run (kernel build, cuBLAS and allocator set-up),
then ``--reps`` full runs.  A run's time is ``api.run``'s wall time, which
covers the training loop and ends in a device sync.  Prints one JSON line
per run (label, spec, ms/step, card) and nothing else on stdout.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two commits are timed by the same script
on the same card: unpack one of them elsewhere and alternate the two.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

#: (label, preset, overrides): the quickstart QG preset (one ``qg_step`` a
#: step) and the CHOCO top-k preset on the kernels
STEP_RUNS = [
    ("quickstart_qg", "quickstart_ring16_alpha0.1_qg", ()),
    ("choco_topk_auto", "choco_topk0.01_ring16_qg", ("comm.backend=auto",)),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--label", default="")
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
        spec = api.presets.get(preset).override(*overrides)
        api.run(spec.override("loop.steps=25"), log_fn=quiet)
        for rep in range(args.reps):
            res = api.run(spec, log_fn=quiet)
            print(json.dumps({
                "label": args.label, "run": label, "rep": rep,
                "steps": res.steps_run,
                "ms_per_step": res.wall_time_s / res.steps_run * 1e3,
                "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
