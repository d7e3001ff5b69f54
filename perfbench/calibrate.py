"""Readings that set a cell's limits (``limits/<cell>.json``), on the card
at the cell's own size: the lower readings of sound runs of the program,
and the upper readings of the control and of the faults, each put in the
program's place.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--variants 3] [--out FILE]

For every seed: the program's first three steps through the window's
calls (set-up as a run makes it, no window) against the reference. For
the first ``--variants`` seeds also, against the same reference readings:

* ``control``: the reference one precision below the configuration's
  (TF32 for the matrix products and cuDNN's convolutions);
* ``half``: the reference with each node's loss over half of its rows;
* ``nomix``: the reference with the exchange between the nodes left out.

A state left unchanged reads 1 on ``change_gap`` and needs no run. Prints
one JSON line a reading, and writes them to ``--out``.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--fused", default="auto",
                    help="the optimizer's path: 'auto' (qg_step on the "
                    "card) or 'off' (the unfused chain), a second witness")
    args = ap.parse_args()

    import torch
    from perfbench import harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.resolve(args.workload)
    cell.config["training"]["fused"] = args.fused
    dev = torch.device("cuda")
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        host = cell.traffic.batches(cell.mix, cell.config, seed)
        t0 = time.perf_counter()
        trainer, state, x0 = harness.build_program(cell, seed, "cuda")
        state, got = harness.first_steps(cell, trainer, state, x0, host)
        del trainer, state, x0
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ref = harness.reference_readings(cell, seed, host, dev)
        t2 = time.perf_counter()
        rows = [("program", got)]
        if i < args.variants:
            rows += [("control", harness.reference_readings(
                         cell, seed, host, dev, tf32=True)),
                     ("half", harness.reference_readings(
                         cell, seed, host, dev, fault="half")),
                     ("nomix", harness.reference_readings(
                         cell, seed, host, dev, fault="nomix"))]
        for name, readings in rows:
            line = json.dumps({"cell": cell.name, "seed": seed,
                               "variant": name,
                               "fused": args.fused,
                               **harness.compare(readings, ref),
                               "worst_leaves": {
                                   key: sorted(harness.leaf_gaps(
                                       readings, ref, key).items(),
                                       key=lambda kv: -kv[1])[:3]
                                   for key in ("grad", "change")},
                               "loss": readings["loss"],
                               "ref_loss": ref["loss"],
                               "program_s": t1 - t0, "reference_s": t2 - t1})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
