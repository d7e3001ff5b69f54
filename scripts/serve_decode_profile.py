#!/usr/bin/env python3
"""Where a decode step of the paged serving engine spends its time, by depth.

    python3 scripts/serve_decode_profile.py [--out PATH]

Serves 16 requests (the serve CLI's defaults and request set) with random
weights through the paged-decode kernel for two dense archs: TinyLlama-1.1B
at full width, and the model of the ``lm100m_ring8_alpha0.1_qg`` preset
(TinyLlama's blocks at d_model 768, 12 query heads over 4 KV heads, d_ff
2048, vocab 8192), each cut to several depths.  For each (arch, depth),
after one warm-up run of the engine: the decode-step p50 and tokens/s of a
timed run, then one run under ``torch.profiler``: host ops and device
activities per engine step, ``paged_decode_attention`` launches per decode
step, host self time and device time per step, and the device's busy
share.  A least-squares line of the decode-step p50 over depth splits each
arch's step into a fixed part and a part per layer.

Prints one JSON line per (arch, depth) and one per arch with the line,
each with the card's name and power limit; ``--out`` also writes the
profiler's top host ops per (arch, depth) there as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: TinyLlama-1.1B, and ``llama-100m``: the model of the LM preset
ARCHS = ("tinyllama-1.1b", "llama-100m")
LM_PRESET = "lm100m_ring8_alpha0.1_qg"
DEPTHS = (2, 8, 22)
SERVE_KW = {"n_slots": 8, "page_size": 16, "max_len": 256,
            "prefill_chunk": 32}
SERVE_REQUESTS, SERVE_MAX_NEW = 16, 16


def _config(name: str, depth: int):
    from repro_torch.api import presets
    from repro_torch.api.models import resolve_transformer_config
    from repro_torch.configs import get_config

    if name == "llama-100m":
        cfg = resolve_transformer_config(presets.get(LM_PRESET).model)
    else:
        cfg = get_config(name)
    return dataclasses.replace(cfg, n_layers=depth)


def _measure(cfg) -> tuple[dict, list]:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.__main__ import make_requests
    from torch.profiler import ProfilerActivity, profile

    params = tf.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    reqs = make_requests(SERVE_REQUESTS, cfg.vocab_size, seed=0,
                         max_new=SERVE_MAX_NEW)

    def engine_run():
        eng = ServeEngine(params, cfg, use_pallas=True, **SERVE_KW)
        t0 = time.perf_counter()
        outs = eng.run(reqs)
        torch.cuda.synchronize()
        return eng, outs, time.perf_counter() - t0

    engine_run()                                   # warm-up
    eng, outs, wall = engine_run()
    row = {"n_layers": cfg.n_layers,
           "tokens_per_s": sum(len(o.tokens) for o in outs) / wall,
           "decode_p50_ms": eng.stats()["phases"]["decode"]["p50_s"] * 1e3,
           "prefill_p50_ms":
               eng.stats()["phases"]["prefill"]["p50_s"] * 1e3}
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng, _, wall = engine_run()
    paged = ops.launch_counts().get("paged_decode_attention", 0)
    dec = eng.timers["decode"].total_laps
    steps = dec + eng.timers["prefill"].total_laps
    dev_ms = dev_n = host_ms = host_n = 0.0
    host = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dt = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            if dt:
                dev_ms += dt / 1e3
                dev_n += e.count
        elif e.self_cpu_time_total:
            host_ms += e.self_cpu_time_total / 1e3
            host_n += e.count
            host.append((e.key, e.self_cpu_time_total / 1e3, e.count))
    host.sort(key=lambda r: -r[1])
    row.update({
        "engine_steps": steps, "decode_steps": dec,
        "paged_launches_per_decode_step": paged / max(dec, 1),
        "host_ops_per_step": host_n / steps,
        "host_ops_per_step_per_layer": host_n / steps / cfg.n_layers,
        "host_self_ms_per_step": host_ms / steps,
        "device_activities_per_step": dev_n / steps,
        "device_ms_per_step": dev_ms / steps,
        "busy": dev_ms / (wall * 1e3), "profiled_wall_ms": wall * 1e3})
    del params
    torch.cuda.empty_cache()
    return row, [{"op": k, "self_ms": m, "count": c} for k, m, c in host[:15]]


def _line(xs, ys) -> tuple[float, float]:
    """Least-squares ``y = a + b x``: ``(a, b)``."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    b = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
         / sum((x - mx) ** 2 for x in xs))
    return my - b * mx, b


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_decode_profile: no CUDA device available",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    tops = {}
    for name in ARCHS:
        rows = []
        for depth in DEPTHS:
            row, top = _measure(_config(name, depth))
            rows.append(row)
            tops[f"{name}@{depth}"] = top
            print(json.dumps({"arch": name, **row, "card": card}),
                  flush=True)
        fixed, per_layer = _line([r["n_layers"] for r in rows],
                                 [r["decode_p50_ms"] for r in rows])
        print(json.dumps({"arch": name, "fit": "decode_p50_ms = fixed + "
                          "per_layer * n_layers", "fixed_ms": fixed,
                          "per_layer_ms": per_layer, "card": card}),
              flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(tops, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
