"""Render a telemetry stream as markdown tables + sparklines.

Port of ``repro/telemetry/report.py``:

    PYTHONPATH=src python -m repro_torch.telemetry.report metrics.jsonl
    PYTHONPATH=src python -m repro_torch.telemetry.report metrics.jsonl \
        --columns consensus_post,align_qg_buffer --out report.md

Reads back what the JSONL/CSV sinks wrote (``--format`` inferred from the
extension) and renders, per metric column: first/last value, min/max, and a
unicode sparkline of the trajectory — the quickest possible answer to "did
consensus contract, did the QG buffer stay aligned" without leaving the
terminal.  It renders a stream written by either package the same way.
"""
from __future__ import annotations

import argparse
import math
import os

from repro_torch.telemetry.sinks import read_csv, read_jsonl

__all__ = ["markdown_table", "fmt_s", "fmt_val", "sparkline",
           "summarize", "render", "main"]

_SPARK = "▁▂▃▄▅▆▇█"


# -- formatting helpers -----------------------------------------------------

def markdown_table(headers: list[str], rows: list[list[str]]) -> str:
    """Plain GitHub-markdown table from pre-formatted string cells."""
    head = "| " + " | ".join(headers) + " |"
    sep = "|" + "|".join("---" for _ in headers) + "|"
    body = ["| " + " | ".join(str(c) for c in r) + " |" for r in rows]
    return "\n".join([head, sep] + body)


def fmt_s(x: float) -> str:
    """Humanized seconds: 1.23s / 4.5ms / 120us."""
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def fmt_val(x) -> str:
    """Compact numeric cell: fixed-point near 1, scientific elsewhere."""
    if not isinstance(x, (int, float)):
        return str(x)
    if x == 0:
        return "0"
    if not math.isfinite(x):
        return str(x)
    a = abs(x)
    if 1e-3 <= a < 1e5:
        return f"{x:.4g}"
    return f"{x:.2e}"


def sparkline(values: list[float], width: int = 24) -> str:
    """Unicode sparkline, downsampled to ``width`` buckets by striding."""
    xs = [v for v in values if isinstance(v, (int, float))
          and math.isfinite(v)]
    if not xs:
        return ""
    if len(xs) > width:
        stride = len(xs) / width
        xs = [xs[min(int(i * stride), len(xs) - 1)] for i in range(width)]
    lo, hi = min(xs), max(xs)
    if hi <= lo:
        return _SPARK[0] * len(xs)
    scale = (len(_SPARK) - 1) / (hi - lo)
    return "".join(_SPARK[int((v - lo) * scale)] for v in xs)


# -- telemetry-stream rendering ----------------------------------------------

def load(path: str) -> list[dict]:
    if path.endswith(".csv"):
        return read_csv(path)
    return read_jsonl(path)


def summarize(rows: list[dict], columns: list[str] | None = None) -> str:
    """One markdown table: a row per metric column with first/last/min/max
    and a sparkline over the recorded steps."""
    if not rows:
        return "(no telemetry rows)"
    cols = columns or sorted(
        {k for r in rows for k in r if k != "step"})
    table_rows = []
    for c in cols:
        series = [r[c] for r in rows if c in r
                  and isinstance(r[c], (int, float))]
        if not series:
            continue
        table_rows.append([
            f"`{c}`", fmt_val(series[0]), fmt_val(series[-1]),
            fmt_val(min(series)), fmt_val(max(series)), sparkline(series)])
    steps = [r.get("step") for r in rows if "step" in r]
    caption = (f"{len(rows)} rows, steps "
               f"{min(steps)}..{max(steps)}" if steps else f"{len(rows)} rows")
    return caption + "\n\n" + markdown_table(
        ["metric", "first", "last", "min", "max", "trend"], table_rows)


def render(path: str, columns: list[str] | None = None) -> str:
    return (f"# Telemetry report — `{os.path.basename(path)}`\n\n"
            + summarize(load(path), columns))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="render markdown tables/sparklines from a telemetry "
                    "metrics stream (.jsonl or .csv)")
    ap.add_argument("path", help="metrics.jsonl / metrics.csv from a run")
    ap.add_argument("--columns", default=None,
                    help="comma-separated metric columns (default: all)")
    ap.add_argument("--out", default=None,
                    help="write the rendered markdown here instead of stdout")
    args = ap.parse_args(argv)
    cols = args.columns.split(",") if args.columns else None
    text = render(args.path, cols)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote {args.out}")
    else:
        print(text)


if __name__ == "__main__":
    main()
