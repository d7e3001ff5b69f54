"""Dry run of the port: trace every (arch x input-shape x mesh) step on the
``meta`` device, prove the step builds at the published widths, and write
roofline and per-rank memory records.  Nothing is allocated and no card is
needed.

Port of ``repro/launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh production
  ... --mesh both                # the node-only meshes, single and multi
  ... --gossip sparse_ppermute   # the compiled schedule's wire bytes

Meshes (H100s under NCCL, ``launch/mesh.py``; shapes only here):
``production`` is the reference's ``(16, 16)`` ``('data', 'model')`` mesh
and ``production_multipod`` its ``(2, 16, 16)`` ``('pod', 'data',
'model')`` one (``mesh.make_production_mesh``); ``single`` and ``multi``
are 16 and 32 ranks of one 'data' axis.  A train step decentralizes over
'data' when a node's params, m_hat and grads, stored over its 'model'
ranks, fit a card (``steps.choose_n_nodes`` under
``steps.H100_NODE_BUDGET``), over 'pod' on the multipod mesh, else it is
QHM with the weights stored over every axis.  Each rank stores its block
of every weight, buffer and cache (``launch/sharding.py``) and gathers a
weight whole just before its use.

Per combo this traces (one rank's blocks, ``meta`` tensors):
  full   the step at full depth: proves it builds, and gives the per-rank
         memory (``argument``: the rank's blocks and its batch, exact from
         ``sharding.bytes_per_rank``; ``temp`` the peak of what the step
         allocates, gathered weights included, by
         ``torch.distributed._tools.mem_tracker.MemTracker`` on ``meta``
         tensors, which reads the same peak as under ``FakeTensorMode``
         and traces faster; ``fits`` tests argument + temp against the
         card's 80 GB);
  probe1/probe2  the 1- and 2-period steps, whose counts
         (``roofline.trace_cost``) extrapolate linearly to the full depth.
The trace of a node-stacked step holds every node; a rank holds one, so its
flops, bytes and temp are the trace's over the node count.  A rank computes
its rows of its node's batch where the reference's ``batch_specs`` splits
them over the data axes (``steps.Layout.rows``), and its ``argument``
counts those rows.  The flops split into ``rows`` (the forward and backward
of the rank's rows, a node's whole batch where they do not split) and
``sharded`` (the gossip mix over the rank's blocks); the wire adds the
weights' and the caches' gathers (``all-gather``), the activations'
collectives (a split's, a pinned decode's) and the rows' (the gradients'
``reduce-scatter`` and ``all-reduce``).  A decode
under ``--set pin_decode_cache=true`` is built with the reference's
``cache_constraint`` (``steps.pinned_cache_constraint``) and computes on
the rank's cache blocks.

Artifacts: experiments/dryrun_torch/<arch>__<shape>__<mesh>[__<gossip>].json,
with the reference's keys, ``memory`` / ``fits`` and the StepConfig knobs
that change nothing on a card under ``ignored`` (``steps.IGNORED_KNOBS``);
on a mesh that shards the weights, ``gathered`` (a rank's gathered weight
bytes by leaf name), and under the split knobs ``split`` (which parts
they divide, and the blocks they leave whole on every rank by name:
``sharding.Split.whole``).
A model that does not fit even at one node gets a record with ``fits:
false``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
from torch.distributed._tools.mem_tracker import MemTracker

from repro_torch.comm import count_mix_sites
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.core import gossip
from repro_torch.launch import roofline, sharding, steps
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.tree import tree_flatten

__all__ = ["MESHES", "probe_cfg", "trace_step", "run_combo", "main"]

#: the dry run's meshes, shapes only
MESHES = {"single": MeshShape((("data", 16),)),
          "multi": MeshShape((("data", 32),)),
          "production": make_production_mesh(device="meta"),
          "production_multipod": make_production_mesh(multi_pod=True,
                                                      device="meta")}


def probe_cfg(cfg, k: int):
    """k periods + the constant tail."""
    return dataclasses.replace(
        cfg, n_layers=len(cfg.period) * k + cfg.tail_layers)


def _nbytes(tree) -> int:
    return int(sum(t.numel() * t.element_size()
                   for t in tree_flatten(tree)[0]
                   if isinstance(t, torch.Tensor)))


def _peak(mt: MemTracker) -> int:
    return int(sum(snap["Total"] for snap in
                   mt.get_tracker_snapshot("peak").values()))


def trace_step(sc: steps.StepConfig, plan: sharding.ShardingPlan, *,
               memory: bool = True) -> dict:
    """Trace one step of ``sc`` on ``meta`` on ``plan.mesh``'s layout
    (``steps.Layout``): a rank's ``flops`` (and their ``flops_split``),
    ``bytes_accessed``, ``wire`` (bytes by collective kind) and, with
    ``memory``, its ``argument`` / ``output`` / ``temp`` bytes."""
    kind = sc.shape.kind
    if kind == "train":
        fn = steps.build_train_step(sc, mesh=plan.mesh,
                                    node_axis=plan.node_axis)
    elif kind == "prefill":
        fn = steps.build_prefill_step(sc, mesh=plan.mesh)
    else:
        # the reference's lower_decode: under pin_decode_cache, the pin of a
        # layer's K spec (the decode then computes on the cache blocks)
        fn = steps.build_decode_step(
            sc, mesh=plan.mesh, cache_constraint=steps.pinned_cache_constraint(
                steps.Layout.make(sc, plan.mesh, kind=kind))
            if sc.pin_decode_cache else None)
    layout = fn.layout
    lp = layout.plan

    def local(what):
        return sharding.shard_tree(lp, layout.specs[what],
                                   layout.shapes[what], skip=layout.keep)

    # a rank holds its blocks of the state and its rows of the batch
    # (``layout.specs["batch"]``: the reference's batch_specs where the
    # rows split, else the batch whole)
    held = [(layout.shapes[w], layout.specs[w]) for w in
            {"train": ("params", "opt_state", "batch"),
             "prefill": ("params", "batch")}.get(
                 kind, ("params", "cache", "batch"))]
    batch = layout.shapes["batch"]
    if kind == "train":
        args = (local("params"), local("opt_state"), batch)
    elif kind == "prefill":
        args = (local("params"),) + tuple(batch.values())
    else:
        pos = steps.decode_specs(sc)["pos"]
        args = (local("params"), batch["token"], pos, local("cache"))
        held.append(((pos,), ((),)))
    mt = MemTracker()
    with mt:
        out, flops, nbytes = roofline.trace_cost(fn, *args)
    per = lp.node_count      # a rank's share of the node-stacked trace
    rec = {"flops": flops / per, "bytes_accessed": nbytes / per,
           "wire": {}}
    placement = layout.placement
    gathered = placement.tally.bytes / per if placement else 0
    sharded = 0.0
    if kind == "train" and sc.n_nodes > 1:
        # the mix over the rank's blocks: the one flop count that shrinks
        # with the weight axes
        sharded = roofline.mix_flops(sc.n_nodes, sum(
            leaf[0].numel() for leaf in tree_flatten(args[0])[0])) / per
    # "rows": the forward (and backward) of the rank's rows of its node's
    # batch (the whole batch where the rows do not split)
    rec["flops_split"] = {"rows": rec["flops"] - sharded,
                          "sharded": sharded}
    if memory:
        # outputs written in place (a decode step's caches) are arguments
        ins = {id(t) for t in tree_flatten(args)[0]}
        fresh = [t for t in tree_flatten(out)[0]
                 if isinstance(t, torch.Tensor) and id(t) not in ins]
        rec.update(argument=sum(sharding.bytes_per_rank(lp, tree, specs)
                                for tree, specs in held),
                   output=sum(t.numel() * t.element_size()
                              for t in fresh) // per,
                   temp=_peak(mt) // per)
    if kind == "train" and sc.n_nodes > 1:
        topo = steps.step_topology(sc)
        resolved = gossip.resolve_gossip(
            topo, schedule=sc.gossip_schedule, mesh=lp.mesh,
            node_axis=lp.node_axis)
        sched = (None if resolved.kind == "dense" else
                 resolved.schedule or gossip.compile_gossip_schedule(topo))
        # a node's blocks on this rank: what its gossip sends
        rec["wire"] = roofline.wire_bytes(
            resolved.kind, n=sc.n_nodes,
            node_bytes=_nbytes(args[0]) // sc.n_nodes,
            sites=count_mix_sites(steps.make_opt(sc), args[0],
                                  torch.as_tensor(topo.w(0))),
            messages_per_step=sched.messages_per_step() if sched else None)
    if gathered:
        rec["wire"]["all-gather"] = rec["wire"].get("all-gather", 0.0) + \
            gathered
    # the activations' collectives: the split's over 'model', a pinned
    # decode's over its cache blocks' axes; the rows' (the gradients'
    # reduce-scatters and all-reduces, the MoE's counts and means, the
    # logits gathered whole)
    wires = [fn.split.tally.wire] if fn.split is not None else []
    if placement is not None:
        wires.append(placement.tally.wire)
    if layout.rows is not None:
        wires.append(layout.rows.tally.wire)
    for wire in wires:
        for k, v in wire.items():
            rec["wire"][k] = rec["wire"].get(k, 0.0) + v / per
    if placement is not None:
        # a rank's gathered weight bytes by leaf name ("in_proj", ...)
        rec["gathered"] = {}
        for path, v in placement.tally.leaves.items():
            rec["gathered"][path[-1]] = rec["gathered"].get(path[-1], 0.0) \
                + v / per
    if fn.split is not None:
        sp = fn.split
        rec["split"] = {"heads": sp.heads, "ssm": sp.ssm,
                        "features": sp.features, "vocab": sp.vocab,
                        "experts": sp.experts, "whole": list(sp.whole)}
    return rec


def _memory_summary(m: dict) -> str:
    """The reference's ``memory_analysis`` string, per rank; ``fits``
    comes before ``output`` so that a report's 70-character cut keeps
    it."""
    return (f"argument={m['argument']/1e9:.3f}GB "
            f"temp={m['temp']/1e9:.3f}GB "
            f"total={m['total']/1e9:.3f}GB "
            f"fits={'yes' if m['fits'] else 'no'} "
            f"output={m['output']/1e9:.3f}GB")


def run_combo(arch: str, shape_name: str, mesh_name: str, *,
              gossip_schedule: str = "dense", out_dir: str,
              skip_existing: bool = True, probes_only: bool = False,
              full_only: bool = False, variant: str = "",
              overrides: dict | None = None, cfg=None, shape=None,
              mesh=None) -> dict | None:
    """``variant``/``overrides`` are the reference's hillclimb runs:
    ``overrides`` are extra StepConfig fields and the artifact gets a
    ``__<variant>`` suffix.  ``cfg`` / ``shape`` / ``mesh`` (a
    ``MeshShape``) replace the registry's and :data:`MESHES`'s (a reduced
    config in tests); ``mesh_name`` names the mesh in the record."""
    overrides = dict(overrides or {})
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else INPUT_SHAPES[shape_name]

    if shape.name == "long_500k" and not cfg.supports_long_context:
        return None  # documented skip (DESIGN.md §5)

    suffix = "" if gossip_schedule == "dense" else f"__{gossip_schedule}"
    if variant:
        suffix += f"__{variant}"
    tag = f"{arch}__{shape_name}__{mesh_name}{suffix}"
    out_path = os.path.join(out_dir, tag + ".json")
    if skip_existing and os.path.exists(out_path):
        with open(out_path) as fh:
            return json.load(fh)

    mesh = mesh if mesh is not None else MESHES[mesh_name]
    n_chips = mesh.size
    dtype = overrides.get("param_dtype", torch.bfloat16)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
        overrides["param_dtype"] = dtype
    if shape.kind == "train":
        n_nodes = steps.choose_n_nodes(
            cfg, mesh, budget=steps.H100_NODE_BUDGET,
            param_bytes=torch.empty((), dtype=dtype).element_size())
    else:
        n_nodes = 1
    plan = sharding.make_plan(mesh, n_nodes=n_nodes)

    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_chips": int(n_chips), "n_nodes": int(n_nodes),
        "node_axis": plan.node_axis, "kind": shape.kind,
        "gossip": gossip_schedule if shape.kind == "train" else None,
        "variant": variant or "baseline",
        "overrides": {k: str(v) for k, v in overrides.items()},
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "hardware": roofline.H100.name, "dtype": str(dtype),
        "ignored": list(steps.IGNORED_KNOBS),
    }
    # SSD chunking: keep the number of probe chunk bodies bounded, as the
    # reference does (len(period) periods x 2 x S/chunk <= ~256): zamba2
    # prefill_32k gets chunk 2048 instead of 256
    ssd_chunk = int(overrides.pop("ssd_chunk", 256))
    if shape.kind != "decode" and cfg.ssm is not None \
            and "ssd_chunk" not in record["overrides"]:
        need = len(cfg.period) * 2 * shape.seq_len / 256
        if need > 256:
            ssd_chunk = 1 << math.ceil(math.log2(
                len(cfg.period) * 2 * shape.seq_len / 256))
    record["ssd_chunk"] = ssd_chunk

    t0 = time.time()
    mem = "<skipped>"
    if not probes_only:
        sc_full = steps.StepConfig(cfg=cfg, shape=shape, n_nodes=n_nodes,
                                   ssd_chunk=ssd_chunk,
                                   gossip_schedule=gossip_schedule,
                                   **overrides)
        full = trace_step(sc_full, plan)
        memory = {k: full[k] for k in ("argument", "output", "temp")}
        memory["total"] = memory["argument"] + memory["temp"]
        memory["fits"] = memory["total"] <= steps.H100_HBM_BYTES
        mem = _memory_summary(memory)
        record["memory"] = memory
        record["fits"] = memory["fits"]
        for k in ("split", "gathered"):
            if k in full:
                record[k] = full[k]
        record["full_compile_s"] = round(time.time() - t0, 1)
    record["memory_analysis"] = mem

    if not full_only:
        pcosts = []
        for k in (1, 2):
            t1 = time.time()
            sc_k = steps.StepConfig(cfg=probe_cfg(cfg, k), shape=shape,
                                    n_nodes=n_nodes, unroll=True,
                                    ssd_chunk=ssd_chunk,
                                    gossip_schedule=gossip_schedule,
                                    **overrides)
            c = trace_step(sc_k, plan, memory=False)
            detail = roofline.collective_detail(c["wire"])
            pcosts.append(roofline.ProbeCost(
                flops=c["flops"], bytes_accessed=c["bytes_accessed"],
                collective_bytes=detail["total_link_bytes"],
                collective_detail=detail))
            record[f"probe{k}_compile_s"] = round(time.time() - t1, 1)
        summary = roofline.summarize(
            cfg, shape, n_chips=n_chips, probe1=pcosts[0], probe2=pcosts[1],
            n_periods=cfg.n_periods, memory_analysis=mem,
            extra={"probe1": dataclasses.asdict(pcosts[0]),
                   "probe2": dataclasses.asdict(pcosts[1])},
            hw=roofline.H100, dtype=dtype)
        record.update({k: v for k, v in summary.items()
                       if k not in ("arch", "shape", "memory_analysis")})

    os.makedirs(out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1, default=str)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["both", *MESHES])
    ap.add_argument("--gossip", default="dense",
                    choices=["dense", "ring_ppermute", "sparse_ppermute"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--probes-only", action="store_true")
    ap.add_argument("--full-only", action="store_true")
    ap.add_argument("--variant", default="",
                    help="hillclimb tag; combine with --set key=value")
    ap.add_argument("--set", action="append", default=[],
                    help="StepConfig override, e.g. --set ssd_chunk=64")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            v = {"true": True, "false": False}.get(v.lower(), v)
        overrides[k] = v

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                tag = f"{arch} x {shape_name} x {mesh_name}"
                try:
                    t0 = time.time()
                    rec = run_combo(
                        arch, shape_name, mesh_name,
                        gossip_schedule=args.gossip, out_dir=args.out,
                        skip_existing=not args.force,
                        probes_only=args.probes_only,
                        full_only=args.full_only, variant=args.variant,
                        overrides=overrides)
                    if rec is None:
                        print(f"[skip] {tag} (long-context not supported)")
                        continue
                    rt = rec.get("roofline", {})
                    print(f"[ok]   {tag}  {time.time()-t0:.0f}s  "
                          f"bottleneck={rt.get('bottleneck','-')}  "
                          f"mem: {rec.get('memory_analysis','')[:80]}")
                except Exception as e:
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for t, e in failures:
            print(" ", t, e)
        sys.exit(1)
    print("\nall requested combos traced OK")


if __name__ == "__main__":
    main()
