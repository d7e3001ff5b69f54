#!/usr/bin/env python3
"""SASS of the flash kernel's instances, from two source trees side by side.

    python3 scripts/flash_sass.py --base <other checkout>/src/repro_torch/kernels/csrc

Compiles ``attention.cu`` of this checkout and of ``--base`` (another
revision's ``csrc/`` directory) with the port's ``NVCC_FLAGS`` into
``build/flash_sass/``, and prints one JSON line a ``flash_tc`` instance:
its tensor-core products (HMMA) and instructions in each tree (by
``cuobjdump -sass``, through chip_smoke's ``sass_mma_counts``), and its
registers and spill bytes (by ``ptxas -v``).
Exits 1 if an instance present in both trees differs in any of these, so
that a change meant for one head dim can be shown to leave the others'
machine code as it was.  Needs the CUDA toolkit (no GPU).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _compile(csrc: Path, out: Path) -> tuple[Path, str]:
    from repro_torch.kernels import build
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "attention.so"
    res = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                          str(lib), str(csrc / "attention.cu")],
                         capture_output=True, text=True, check=True)
    return lib, res.stdout + res.stderr


def _ptxas(log: str) -> dict:
    """``{mangled name: (registers, spill store bytes, spill load
    bytes)}`` from a ``ptxas -v`` log."""
    out, fn = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            fn = hit.group(1)
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)
        if fn and hit:
            out.setdefault(fn, [0, 0, 0])[1:] = [int(hit.group(1)),
                                                 int(hit.group(2))]
        hit = re.search(r"Used (\d+) registers", line)
        if fn and hit:
            out.setdefault(fn, [0, 0, 0])[0] = int(hit.group(1))
    return out


def _instance(name: str) -> str:
    """``flash_tc<fp32|bf16, D>`` from a mangled name."""
    hit = re.search(r"flash_tcI(\w+?)Li(\d+)E", name)
    dtype = "bf16" if "bfloat16" in name else "fp32"
    return f"flash_tc<{dtype}, {hit.group(2)}>" if hit else name


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True,
                    help="csrc/ directory of the revision to compare with")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    trees = {"base": Path(args.base), "this": build.CSRC}
    sass_counts = _chip_smoke().sass_mma_counts
    seen = {}
    for label, csrc in trees.items():
        lib, log = _compile(csrc, ROOT / "build" / "flash_sass" / label)
        regs = _ptxas(log)
        seen[label] = {
            _instance(fn): {"hmma": c[0], "instructions": c[1],
                            "registers": regs.get(fn, [None] * 3)[0],
                            "spill_bytes": sum(regs.get(fn, [0, 0, 0])[1:])}
            for fn, c in sass_counts(lib).items() if "flash_tc" in fn}
    changed = []
    for inst in sorted(set(seen["base"]) | set(seen["this"])):
        a, b = seen["base"].get(inst), seen["this"].get(inst)
        same = a == b if a and b else None
        if same is False:
            changed.append(inst)
        print(json.dumps({"instance": inst, "base": a, "this": b,
                          "unchanged": same}))
    print(json.dumps({"changed": changed}))
    return 1 if changed else 0


if __name__ == "__main__":
    sys.exit(main())
