"""Render the dry-run / roofline markdown tables from dry-run artifacts,
and the serve and kernels bench tables.

Port of ``repro/launch/report.py``:

    PYTHONPATH=src python -m repro_torch.launch.report \\
        [--dir experiments/dryrun_torch] [--what both] [--out report.md]

Table and formatting helpers live in ``repro_torch.telemetry.report``; this
module is the dry-run front end.  The same records give the same markdown
as the reference's.  A port record's ``memory_analysis`` is per rank
(``argument``, ``temp``, ``total`` and ``fits`` against the card's 80 GB;
``launch/dryrun.py``), so the dry-run table's memory column shows those,
and the roofline table's ``temp`` column reads the same string.
``memory_table`` (``--what memory``) is the port's own: a rank's bytes,
``fits`` and the roofline bound, single and multi side by side (or the
meshes ``--mesh`` names, comma-separated: ``--mesh production``).  Records
are partial by design: a dry run that failed before the roofline or the
memory still leaves a JSON artifact, so every lookup here tolerates
missing optional keys (``roofline``, ``memory_analysis``, ``n_chips``, ...)
instead of raising.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.telemetry.report import fmt_s, markdown_table

__all__ = ["load", "roofline_table", "dryrun_table", "memory_table",
           "serve_table", "kernels_table", "main"]


def load(dir_: str) -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as fh:
            r = json.load(fh)
        r["_file"] = os.path.basename(p)
        recs.append(r)
    return recs


def roofline_table(recs: list[dict], mesh: str = "single",
                   gossip: str | None = None) -> str:
    rows = []
    for r in recs:
        if r.get("mesh") != mesh or "roofline" not in r:
            continue
        if r.get("variant", "baseline") != "baseline":
            continue
        if gossip is not None and (r.get("gossip") or "dense") != gossip:
            continue
        if gossip is None and (r.get("gossip") or "dense") != "dense":
            continue
        rt = r["roofline"]
        mem = str(r.get("memory_analysis", ""))
        temp = ""
        if "temp=" in mem:
            temp = mem.split("temp=")[1].split(" ")[0]
        rows.append([
            r.get("arch", "?"), r.get("shape", "?"),
            r.get("n_nodes", "-"),
            fmt_s(rt.get("compute_s", 0.0)), fmt_s(rt.get("memory_s", 0.0)),
            fmt_s(rt.get("collective_s", 0.0)),
            f"**{rt.get('bottleneck', '?')}**",
            f"{r.get('useful_flops_ratio', 0):.2f}", temp])
    return markdown_table(
        ["arch", "shape", "nodes", "compute", "memory", "collective",
         "bottleneck", "useful FLOPs", "per-chip temp mem"], rows)


def dryrun_table(recs: list[dict]) -> str:
    rows = []
    for r in recs:
        if r.get("variant", "baseline") != "baseline" or \
                (r.get("gossip") or "dense") != "dense":
            continue
        ok = "yes" if ("memory_analysis" in r and
                       "failed" not in str(r["memory_analysis"])) else "?"
        rows.append([
            r.get("arch", "?"), r.get("shape", "?"), r.get("mesh", "?"),
            r.get("n_chips", "-"),
            f"{ok} ({r.get('full_compile_s', '-')}s)",
            str(r.get("memory_analysis", ""))[:70]])
    return markdown_table(
        ["arch", "shape", "mesh", "chips", "compiled",
         "memory analysis (per chip)"], rows)


def memory_table(recs: list[dict], meshes=("single", "multi")) -> str:
    """The port's per-rank table, one row an (arch, shape) with a column
    pair a mesh (``single / multi``): nodes, the rank's argument and temp
    bytes (GB), whether they fit the card, and the step's roofline bound
    on the card's data sheet with its bottleneck.  Baseline dense-gossip
    records with a ``memory`` entry only (the port's; the reference's
    records have none)."""
    cells: dict = {}
    for r in recs:
        if r.get("variant", "baseline") != "baseline" or \
                (r.get("gossip") or "dense") != "dense" or \
                "memory" not in r or r.get("mesh") not in meshes:
            continue
        cells.setdefault((r.get("arch", "?"), r.get("shape", "?")),
                         {})[r["mesh"]] = r

    def pair(by_mesh, fn):
        return " / ".join(fn(by_mesh[m]) if m in by_mesh else "-"
                          for m in meshes)

    rows = []
    for (arch, shape), by_mesh in sorted(cells.items()):
        rows.append([
            arch, shape,
            pair(by_mesh, lambda r: str(r.get("n_nodes", "-"))),
            pair(by_mesh, lambda r: f"{r['memory']['argument'] / 1e9:.1f}"),
            pair(by_mesh, lambda r: f"{r['memory']['temp'] / 1e9:.1f}"),
            pair(by_mesh, lambda r: "yes" if r["memory"]["fits"] else "no"),
            pair(by_mesh, lambda r: fmt_s(r.get("roofline", {}).get(
                "step_s_lower_bound", 0.0))),
            pair(by_mesh, lambda r: r.get("roofline", {}).get(
                "bottleneck", "-"))])
    return markdown_table(
        ["arch", "shape", "nodes", "argument GB / rank", "temp GB / rank",
         "fits 80 GB", "bound", "bottleneck"], rows)


def serve_table(path: str) -> str:
    """§Serve table from a ``BENCH_serve.json`` (benchmarks.run --only
    serve): tokens/s + per-token latency percentiles for the continuous-
    batching engine vs the sequential dense-cache baseline.  Tolerates an
    absent/empty file (serving benches are optional artifacts)."""
    if not os.path.exists(path):
        return f"*no serve bench found at {path}*"
    try:
        with open(path) as fh:
            rows = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return f"*unreadable serve bench at {path}*"
    by_mode = {}
    out = []
    for r in rows:
        mode = r.get("name", "").rsplit("/", 1)[-1] or r.get("mode", "?")
        by_mode[mode] = r
        out.append([
            r.get("name", mode),
            f"{r.get('tokens_per_s', 0.0):.1f}",
            f"{r.get('p50_token_ms', 0.0):.3f}",
            f"{r.get('p95_token_ms', 0.0):.3f}",
            str(int(r["peak_cache_bytes"]))
            if "peak_cache_bytes" in r else "-",
            str(int(r.get("mismatches", 0) or 0))])
    if not out:
        return f"*no serve rows in {path}*"
    table = markdown_table(
        ["serve path", "tokens/s", "p50 token ms", "p95 token ms",
         "peak cache bytes", "mismatches"], out)
    if "engine" in by_mode and "sequential" in by_mode and \
            by_mode["sequential"].get("tokens_per_s"):
        ratio = (by_mode["engine"].get("tokens_per_s", 0.0)
                 / by_mode["sequential"]["tokens_per_s"])
        table += (f"\n\ncontinuous batching vs sequential: "
                  f"**{ratio:.2f}x** tokens/s (gate: >= 1.5x)")
    return table


def kernels_table(path: str) -> str:
    """§Kernels table from a ``BENCH_kernels.json`` (benchmarks.run --only
    kernels): the fused-chain loop bench (analytic bytes-moved per step +
    trajectory parity) and the per-kernel interpret-mode microbench rows.
    The gate line compares the fused chain's HBM byte model against the
    unfused stage-by-stage pass count — roofline-anchored, not wall-clock
    (DESIGN.md §14).  Tolerates an absent/empty file."""
    if not os.path.exists(path):
        return f"*no kernels bench found at {path}*"
    try:
        with open(path) as fh:
            rows = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return f"*unreadable kernels bench at {path}*"
    by_mode = {}
    out = []
    for r in rows:
        name = r.get("name", "")
        if not name.startswith("kernels/"):
            continue
        if "bytes_moved_per_step" in r:
            by_mode[name.rsplit("/", 1)[-1]] = r
        out.append([
            name, f"{r.get('us_per_call', 0.0):.1f}",
            str(int(r["bytes_moved_per_step"]))
            if "bytes_moved_per_step" in r else "-",
            str(int(r["mismatches"])) if "mismatches" in r else "-",
            f"{r['jnp_ref_us']:.1f}" if "jnp_ref_us" in r else "-"])
    if not out:
        return f"*no kernels rows in {path}*"
    table = markdown_table(
        ["kernel path", "us/call", "bytes moved/step", "mismatches",
         "jnp ref us"], out)
    if "fused" in by_mode and "unfused" in by_mode and \
            by_mode["unfused"].get("bytes_moved_per_step"):
        ratio = (by_mode["fused"]["bytes_moved_per_step"]
                 / by_mode["unfused"]["bytes_moved_per_step"])
        mism = int(by_mode["fused"].get("mismatches", 0) or 0)
        table += (f"\n\nfused vs unfused bytes-moved: **{ratio:.3f}x** "
                  f"(gate: <= 0.5x); trajectory parity mismatches: "
                  f"**{mism}** (gate: == 0)")
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--what", default="roofline",
                    choices=["roofline", "dryrun", "serve", "kernels",
                             "both", "all", "memory"],
                    help="'memory': the port's per-rank table "
                         "(memory_table); the others as the reference's")
    ap.add_argument("--mesh", default=None,
                    help="the roofline table's mesh (default single); "
                         "--what memory: the meshes side by side, "
                         "comma-separated (default single,multi)")
    ap.add_argument("--gossip", default=None)
    ap.add_argument("--bench-serve", default="BENCH_serve.json",
                    metavar="PATH", help="serve bench JSON for --what "
                    "serve/all (absent file renders a placeholder)")
    ap.add_argument("--bench-kernels", default="BENCH_kernels.json",
                    metavar="PATH", help="kernels bench JSON for --what "
                    "kernels/all (absent file renders a placeholder)")
    ap.add_argument("--out", default=None,
                    help="write the rendered markdown here instead of stdout")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    parts = []
    if args.what in ("roofline", "both", "all"):
        parts.append(roofline_table(recs, mesh=args.mesh or "single",
                                    gossip=args.gossip))
    if args.what in ("dryrun", "both", "all"):
        parts.append(dryrun_table(recs))
    if args.what == "memory":
        parts.append(memory_table(recs, meshes=tuple(
            (args.mesh or "single,multi").split(","))))
    if args.what in ("serve", "all"):
        parts.append(serve_table(args.bench_serve))
    if args.what in ("kernels", "all"):
        parts.append(kernels_table(args.bench_kernels))
    text = "\n\n".join(parts)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote {args.out}")
    else:
        print(text)


if __name__ == "__main__":
    main()
