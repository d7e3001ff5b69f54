#!/usr/bin/env python3
"""A rank's gathered weight bytes for one pinned decode step on the
reference's (16, 16) production mesh, by leaf path (``meta`` tensors, no
card).

    PYTHONPATH=src python3 scripts/decode_gathered.py [--src DIR]
        [--arch zamba2-7b,mamba2-130m,llama-3.2-vision-11b]
        [--shape decode_32k]

With ``megatron_attn``, ``shard_activations``, ``pin_moe_dispatch`` and
``pin_decode_cache``, at the published sizes and depths, it builds the
decode step as the dry run does (``launch/dryrun.trace_step``: the
rank's blocks, the reference's cache pin) and runs it once on ``meta``.
``Placement.tally.leaves`` holds the bytes the rank's gathers receive, by
the leaf's path from the params root; a stacked leaf's path names its
period position, here relabelled by its block kind (``cross/xattn/wq``),
so that a VLM's dense and cross layers stay apart where the dry run's
record sums them by leaf name.

``--src`` runs another tree's package (a ``git archive`` of another
commit), to compare two commits.  Prints one JSON line an arch: the
gathered bytes by kind and path, their total, and the decode split's
flags.  A few seconds an arch.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KNOBS = dict(megatron_attn=True, shard_activations=True,
             pin_moe_dispatch=True, pin_decode_cache=True)


def _label(cfg, path) -> str:
    """``path`` with a period position replaced by its block kind."""
    if path[0] == "blocks":
        return "/".join([cfg.period[path[1]], *map(str, path[2:])])
    return "/".join(map(str, path))


def gathered(arch: str, shape: str) -> dict:
    import torch
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun, sharding, steps

    cfg = get_config(arch)
    mesh = dryrun.MESHES["production"]
    sc = steps.StepConfig(cfg=cfg, shape=INPUT_SHAPES[shape], n_nodes=1,
                          ssd_chunk=256, **KNOBS)
    layout = steps.Layout.make(sc, mesh, kind="decode")

    def local(what):
        return sharding.shard_tree(layout.plan, layout.specs[what],
                                   layout.shapes[what])

    d = steps.decode_specs(sc)
    fn = steps.build_decode_step(
        sc, mesh=mesh,
        cache_constraint=steps.pinned_cache_constraint(layout))
    with torch.no_grad():
        fn(local("params"), d["token"], d["pos"], local("cache"))
    by_path = {}
    for path, nbytes in fn.layout.placement.tally.leaves.items():
        label = _label(cfg, path)
        by_path[label] = by_path.get(label, 0) + nbytes
    sp = fn.split
    return {"arch": arch, "shape": shape,
            "total": sum(by_path.values()),
            "gathered": dict(sorted(by_path.items())),
            "split": None if sp is None else {
                "heads": sp.heads, "ssm": sp.ssm, "features": sp.features,
                "experts": sp.experts, "whole": list(sp.whole)}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch runs")
    ap.add_argument("--arch",
                    default="zamba2-7b,mamba2-130m,llama-3.2-vision-11b")
    ap.add_argument("--shape", default="decode_32k")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    for arch in args.arch.split(","):
        rec = gathered(arch, args.shape)
        rec["src"] = args.src
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
