"""Run a spec from the command line:

    python -m repro_torch.api <preset-name> [--set k=v ...] [--out result.json]
    python -m repro_torch.api path/to/spec.json [--device cpu]
    python -m repro_torch.api --list

A spec JSON written by the reference (``repro.api``) loads unchanged.  The
run goes to the CUDA device unless ``--device cpu`` is given.

``--checkpoint ckpt.npz`` with ``--set loop.checkpoint_every=N`` saves the
full TrainState every N steps and at the end; ``--resume ckpt.npz``
continues a saved run to ``loop.steps`` as the uninterrupted run would have
gone (checkpoints of either package load in the other).  With
``--set telemetry.enabled=true`` and ``--out r.json`` the telemetry stream
goes to ``r.metrics.jsonl``.  ``--export-consensus lm.npz`` averages a
transformer run's node-stacked params after the run and writes a serving
checkpoint (serve it with ``python -m repro_torch.serve --checkpoint
lm.npz``).
"""
from __future__ import annotations

import argparse
import os
import sys

from . import presets
from .build import run
from .spec import ExperimentSpec


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api",
        description="Run a declarative ExperimentSpec (preset or JSON file) "
                    "with the PyTorch port.")
    ap.add_argument("spec", nargs="?",
                    help="preset name (see --list) or path to a spec JSON")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="dotted spec override; repeatable")
    ap.add_argument("--out", default="", help="write the Result JSON here")
    ap.add_argument("--checkpoint", default="", metavar="PATH",
                    help="save the full TrainState here every "
                         "loop.checkpoint_every steps (and at the end)")
    ap.add_argument("--resume", default="", metavar="PATH",
                    help="restore a --checkpoint save and continue to "
                         "loop.steps")
    ap.add_argument("--export-consensus", default="", metavar="PATH",
                    help="after the run, consensus-average the node-stacked "
                         "params and write a serving checkpoint here "
                         "(serve it with `python -m repro_torch.serve "
                         "--checkpoint PATH`)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--list", action="store_true", help="list presets")
    args = ap.parse_args(argv)

    if args.list or not args.spec:
        print("\n".join(presets.names()))
        return 0

    if os.path.exists(args.spec):
        with open(args.spec) as f:
            spec = ExperimentSpec.from_json(f.read())
    else:
        spec = presets.get(args.spec)
    if args.overrides:
        spec = spec.override(*args.overrides)

    # the telemetry stream lands next to the Result: <out stem>.metrics.*
    # (spec.telemetry.path wins if set)
    telemetry_path = ""
    if args.out and spec.telemetry.enabled and not spec.telemetry.path:
        ext = "jsonl" if spec.telemetry.sink != "csv" else "csv"
        telemetry_path = os.path.splitext(args.out)[0] + f".metrics.{ext}"

    result = run(spec, device=args.device, checkpoint_path=args.checkpoint,
                 resume=args.resume, telemetry_path=telemetry_path,
                 with_state=bool(args.export_consensus))
    if args.export_consensus:
        from repro_torch.serve import export_consensus, save_serving_checkpoint
        result, state = result
        params, cfg = export_consensus(result, state=state)
        if cfg is None:
            raise SystemExit(
                "--export-consensus: only transformer models can be "
                "exported for serving")
        save_serving_checkpoint(args.export_consensus, params, cfg)
        print("consensus serving checkpoint ->", args.export_consensus)
    if result.telemetry and result.telemetry.get("path"):
        print(f"telemetry -> {result.telemetry['path']} "
              f"({result.telemetry['rows_emitted']} rows)")
    print(f"[{spec.name or 'spec'}] device={result.device} "
          f"steps={result.steps_run} wall={result.wall_time_s:.1f}s final="
          + "  ".join(f"{k}={v:.4f}" for k, v in sorted(result.final.items())
                      if isinstance(v, float)))
    if args.out:
        with open(args.out, "w") as f:
            f.write(result.to_json())
        print("result ->", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
