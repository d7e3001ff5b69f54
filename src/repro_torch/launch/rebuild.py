"""Recompute the roofline summaries in dry-run artifacts from their stored
raw probe costs (after a change to ``launch/roofline.py``'s arithmetic).

Port of ``repro/launch/rebuild.py``.

    PYTHONPATH=src python -m repro_torch.launch.rebuild \\
        [--dir experiments/dryrun_torch]

The records keep their hardware and dtype (``"hardware"``, ``"dtype"``);
one without them is a record of the reference's and is summarized on
``roofline.V5E``, as the reference would.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import torch

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import roofline

__all__ = ["rebuild", "main"]

_HARDWARE = {hw.name: hw for hw in (roofline.V5E, roofline.H100)}


def rebuild(path: str) -> bool:
    with open(path) as fh:
        rec = json.load(fh)
    if "probe1" not in rec or "probe2" not in rec:
        return False
    cfg = get_config(rec["arch"])
    shape = INPUT_SHAPES[rec["shape"]]
    p1 = roofline.ProbeCost(**rec["probe1"])
    p2 = roofline.ProbeCost(**rec["probe2"])
    hw = _HARDWARE[rec.get("hardware", roofline.V5E.name)]
    dtype = getattr(torch, rec.get("dtype", "torch.bfloat16").replace(
        "torch.", ""))
    summary = roofline.summarize(
        cfg, shape, n_chips=rec["n_chips"], probe1=p1, probe2=p2,
        n_periods=cfg.n_periods, memory_analysis=rec.get("memory_analysis"),
        extra={"probe1": rec["probe1"], "probe2": rec["probe2"]},
        hw=hw, dtype=dtype)
    rec.update({k: v for k, v in summary.items()
                if k not in ("arch", "shape", "memory_analysis")})
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.rebuild")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    n = 0
    for p in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        if rebuild(p):
            n += 1
    print(f"rebuilt {n} artifacts")


if __name__ == "__main__":
    main()
