"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout, on a machine with a CUDA card (a cell of
more than one card is refused: no run here spans processes yet). The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared beside its
limit); the numbers compared are also the last lines of standard error.
Without the cards, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits with a code other than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    from perfbench import harness

    # one intra-op thread: the host's dispatch, which sets the pace of the
    # step, then shares the machine's cores with no pool of its own process
    torch.set_num_threads(1)

    cell = harness.resolve(args.workload)
    if cell.chips != harness.CARDS:
        print(f"perfbench: {args.workload} asks for {cell.chips} cards; a "
              f"run here uses {harness.CARDS}", file=sys.stderr)
        return 3
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, numbers = harness.run_cell(cell, args.seed, args.seconds,
                                       bool(args.trace), T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"perfbench: the run loaded {banned}; it may load neither "
              "JAX nor the JAX package", file=sys.stderr)
        return 4
    for name, (value, limit) in numbers.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
