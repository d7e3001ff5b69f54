#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit; run from the root of a
checkout.  Phases, each of which fails the run (non-zero exit, no result
line) if anything goes wrong:

1. build    compile every CUDA kernel of the main path from ``csrc/``;
2. kernels  hold each kernel against its plain PyTorch version on the card
            over lengths 0-d .. 2**27+5, every flag combination and an
            unaligned view; time kernel and plain version (CUDA graphs
            replayed between CUDA events, so device time without host
            dispatch; eager dispatch timed apart) at the quickstart's packed
            length and at 2**27+5 elements;
3. main     run the two quickstart presets for their full 150 steps through
            ``repro_torch.api.run(spec, device="cuda")``, with the kernel
            launch counters zeroed just before and read just after each
            run; rerun QG with ``fused="off"`` and on the CPU and hold the
            histories against each other;
4. profile  the QG training loop under ``torch.profiler``: device time by
            kernel, host time by op.

Imports nothing of JAX nor of the JAX package.  The second-to-last lines
are the card's name and power limit and a JSON ``kernels`` line; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "build" / "chip_smoke"

#: the packed node-stacked length of the quickstart MLP (16 x 13,652)
QUICKSTART_LEN = 218_432
BIG_LEN = 2 ** 27 + 5
LENGTHS = [(), (1,), (7,), (8191,), (8193,), (QUICKSTART_LEN,), (BIG_LEN,)]

#: kernel vs plain version: the kernels round every step as the plain
#: PyTorch ops do (explicit _rn intrinsics, -fmad=false), so they must agree
#: to the bit
MAX_ULP = 0

#: fused vs unfused QG history on the card: the same arithmetic in the same
#: order, so equal up to this (the reference's own fused-vs-unfused bound,
#: tests/test_fused.py)
HIST_RTOL, HIST_ATOL = 1e-5, 1e-6

#: card vs CPU history (same init, same batches): matmul summation order
#: differs between cuBLAS and the CPU BLAS, and the difference grows over
#: 150 steps of training (1.2e-4 relative seen on an H100)
CPU_RTOL, CPU_ATOL, CPU_ACC_ATOL = 1e-3, 1e-5, 5e-3

#: reference accuracies (JAX package, CPU) and the port's band around them:
#: the port's init is a torch draw at the same scales, not the reference's
REF_ACC = {"quickstart_ring16_alpha0.1_dsgdm": 0.9711,
           "quickstart_ring16_alpha0.1_qg": 0.9839}
ACC_ATOL = 0.03

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor flop/s
PEAK_BYTES_S, PEAK_F32_FLOPS = 3.35e12, 67e12


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def _ulp_diff(a, b) -> int:
    """Largest distance in units in the last place between fp32 tensors."""
    import torch
    if a.numel() == 0:
        return 0
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    # map the sign-magnitude order onto a monotone integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def _compare(name, case, got, want, worst):
    import torch
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{name} {case}: shape {tuple(g.shape)} vs "
                                 f"plain {tuple(w.shape)}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} {case}: non-finite output")
        ulp = _ulp_diff(g, w)
        err = float((g - w).abs().max()) if g.numel() else 0.0
        w_ = worst.setdefault(name, {"ulp": 0, "abs": 0.0, "cases": 0})
        w_["ulp"], w_["abs"] = max(w_["ulp"], ulp), max(w_["abs"], err)
        w_["cases"] += 1
        if ulp > MAX_ULP:
            raise AssertionError(f"{name} {case}: kernel differs from its "
                                 f"plain version by {ulp} ulp (max abs "
                                 f"{err:.3e}); allowed {MAX_ULP}")


def _cases():
    """(kernel name, case label, kernel call, plain call) for every flag
    combination; each call maps (a, b, c, eta) to a tuple of outputs."""
    from repro_torch.kernels import qg_update as K
    from repro_torch.kernels import ref

    for nest in (False, True):
        for wd in (0.0, 1e-4):
            for emit in (True, False):
                def k(x, m, g, eta, nest=nest, wd=wd, emit=emit):
                    out = K.fused_halfstep(x, m, g, eta, beta=0.9, wd=wd,
                                           nesterov=nest, emit_m=emit)
                    return out if emit else (out,)

                def p(x, m, g, eta, nest=nest, wd=wd, emit=emit):
                    half, mn = ref.fused_halfstep(x, m, g, eta, beta=0.9,
                                                  wd=wd, nesterov=nest)
                    return (half, mn) if emit else (half,)

                yield ("fused_halfstep",
                       f"nesterov={nest} wd={wd} emit_m={emit}", k, p)
    for rf in (0.0, 1.0):
        yield ("fused_qg_buffer", f"refresh={rf}",
               lambda a, b, c, eta, rf=rf: (K.fused_qg_buffer(
                   a, b, c, eta, _full(rf, eta), mu=0.9),),
               lambda a, b, c, eta, rf=rf: (ref.fused_qg_buffer(
                   a, b, c, eta, _full(rf, eta), mu=0.9),))
    for nest in (False, True):
        yield ("qg_local_step", f"nesterov={nest}",
               lambda a, b, c, eta, nest=nest: (K.qg_local_step(
                   a, b, c, eta=0.1, beta=0.9, nesterov=nest),),
               lambda a, b, c, eta, nest=nest: (ref.qg_local_step(
                   a, b, c, eta=0.1, beta=0.9, nesterov=nest),))
    for mu in (0.5, 0.9):
        yield ("qg_buffer_update", f"mu={mu}",
               lambda a, b, c, eta, mu=mu: (K.qg_buffer_update(
                   a, b, c, eta=0.05, mu=mu),),
               lambda a, b, c, eta, mu=mu: (ref.qg_buffer_update(
                   a, b, c, eta=0.05, mu=mu),))


def _full(v, like):
    import torch
    return torch.full((1,), v, dtype=torch.float32, device=like.device)


def phase_kernels(dev) -> dict:
    """Every kernel against its plain version at every length; returns the
    worst error per kernel."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    eta = _full(0.1, torch.empty(0, device=dev))
    worst: dict = {}
    for shape in LENGTHS:
        ops_in = [torch.randn(shape, generator=gen, device=dev)
                  for _ in range(3)]
        for name, case, k, p in _cases():
            _compare(name, f"{case} shape={shape}", k(*ops_in, eta),
                     p(*ops_in, eta), worst)
    # an unaligned view (offset by one element) takes the scalar path
    base = [torch.randn(8194, generator=gen, device=dev) for _ in range(3)]
    views = [b[1:] for b in base]
    for name, case, k, p in _cases():
        _compare(name, f"{case} unaligned", k(*views, eta), p(*views, eta),
                 worst)
    torch.cuda.synchronize(dev)
    for name, w in worst.items():
        log(f"kernel {name}: {w['cases']} outputs match the plain version, "
            f"max {w['ulp']} ulp, max abs err {w['abs']:.3e}")
    return worst


def _time_ms(fn, iters: int, reps: int = 7) -> float:
    """Device ms per call: ``iters`` calls are captured once in a CUDA
    graph, and the median over ``reps`` replays, each timed with CUDA
    events, is divided by ``iters``.  Host dispatch (argument checks,
    allocation, ctypes) is thus not charged to the kernel."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    del graph
    return statistics.median(times)


def _dispatch_ms(fn, reps: int = 7, iters: int = 20) -> float:
    """Ms per call of ``iters`` back-to-back eager calls from Python (median
    over ``reps``, CUDA events): the kernel plus its host dispatch, which
    is what the eager training step pays."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


#: fp32 operations per element of each kernel, in the configuration timed
#: (halfstep with weight decay and Nesterov: 4 products, 4 sums)
_FLOPS = {"fused_halfstep": 8, "fused_qg_buffer": 5, "qg_local_step": 6,
          "qg_buffer_update": 5}


def phase_timing(dev) -> dict:
    """Kernel, plain and bound ms of each kernel at the quickstart length
    and at 2**27+5, in the configuration the main path uses."""
    import torch
    from repro_torch.kernels import qg_update as K
    from repro_torch.kernels import ref

    eta = _full(0.1, torch.empty(0, device=dev))
    one = _full(1.0, eta)
    timed = {}
    for n in (QUICKSTART_LEN, BIG_LEN):
        gen = torch.Generator(device=dev).manual_seed(1)
        a, b, c = (torch.randn(n, generator=gen, device=dev)
                   for _ in range(3))
        cfg = {  # name: (kernel, plain, outputs, scalar operands)
            "fused_halfstep": (
                lambda: K.fused_halfstep(a, b, c, eta, beta=0.9, wd=1e-4,
                                         nesterov=True, emit_m=False),
                lambda: ref.fused_halfstep(a, b, c, eta, beta=0.9, wd=1e-4,
                                           nesterov=True)[0], 1, 1),
            "fused_halfstep[emit_m]": (
                lambda: K.fused_halfstep(a, b, c, eta, beta=0.9, wd=1e-4,
                                         nesterov=True, emit_m=True),
                lambda: ref.fused_halfstep(a, b, c, eta, beta=0.9, wd=1e-4,
                                           nesterov=True), 2, 1),
            "fused_qg_buffer": (
                lambda: K.fused_qg_buffer(a, b, c, eta, one, mu=0.9),
                lambda: ref.fused_qg_buffer(a, b, c, eta, one, mu=0.9), 1, 2),
            "qg_local_step": (
                lambda: K.qg_local_step(a, b, c, eta=0.1, beta=0.9,
                                        nesterov=True),
                lambda: ref.qg_local_step(a, b, c, eta=0.1, beta=0.9,
                                          nesterov=True), 1, 0),
            "qg_buffer_update": (
                lambda: K.qg_buffer_update(a, b, c, eta=0.05, mu=0.9),
                lambda: ref.qg_buffer_update(a, b, c, eta=0.05, mu=0.9),
                1, 0),
        }
        # fewer captured calls at 2**27+5: each holds its outputs (and the
        # plain version's temporaries, 512 MiB apiece) in the graph's pool
        iters = 20 if n == QUICKSTART_LEN else 4
        for name, (kfn, pfn, n_out, n_scalar) in cfg.items():
            kms, pms = _time_ms(kfn, iters), _time_ms(pfn, iters)
            kdisp = _dispatch_ms(kfn)
            nbytes = (3 + n_out) * n * 4 + 4 * n_scalar
            flops = _FLOPS[name.split("[")[0]] * n
            bytes_ms = nbytes / PEAK_BYTES_S * 1e3
            ops_ms = flops / PEAK_F32_FLOPS * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            row = {"n": n, "ms": kms, "plain_ms": pms, "bound_ms": bound_ms,
                   "bound_by": "bytes" if bytes_ms >= ops_ms else
                   "operations", "bytes": nbytes, "dispatch_ms": kdisp}
            timed[(name, n)] = row
            log(f"time {name} n={n}: kernel {kms:.6f} ms, plain "
                f"{pms:.6f} ms (CUDA graph of {iters} calls), bound "
                f"{bound_ms:.6f} ms ({row['bound_by']}, {nbytes} B), "
                f"{nbytes / kms / 1e6:.1f} GB/s, library: none; kernel "
                f"with eager dispatch {kdisp:.6f} ms")
        del a, b, c
        torch.cuda.empty_cache()
    return timed


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def _history_close(h_a, h_b, rtol, atol, what):
    import numpy as np
    if len(h_a) != len(h_b):
        raise AssertionError(f"{what}: {len(h_a)} vs {len(h_b)} history rows")
    worst = 0.0
    for ra, rb in zip(h_a, h_b):
        for k in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(ra[k], rb[k], rtol=rtol, atol=atol,
                                       err_msg=f"{what}: step {ra['step']} "
                                               f"{k}")
            worst = max(worst, abs(ra[k] - rb[k]) / max(abs(rb[k]), 1e-30))
    return worst


def phase_main(dev) -> dict:
    import numpy as np
    from repro_torch import api
    from repro_torch.kernels import ops

    quiet = lambda *_: None
    # warm-up, so that cuBLAS and allocator set-up is not charged to the
    # first timed run; its launches are not the main path's
    api.run(api.presets.get("quickstart_ring16_alpha0.1_qg").override(
        "loop.steps=25"), device=dev, log_fn=quiet)
    results, launches = {}, {}
    for preset in ("quickstart_ring16_alpha0.1_dsgdm",
                   "quickstart_ring16_alpha0.1_qg"):
        spec = api.presets.get(preset).override("loop.log_every=1")
        ops.reset_launch_counts()
        res = api.run(spec, device=dev, log_fn=quiet)
        counts = ops.launch_counts()
        results[preset], launches[preset] = res, counts
        want_qg = 150 if preset.endswith("_qg") else 0
        if counts["fused_halfstep"] != 150 or \
                counts["fused_qg_buffer"] != want_qg:
            raise AssertionError(f"{preset}: launches {counts}, want "
                                 f"fused_halfstep=150 fused_qg_buffer="
                                 f"{want_qg}")
        losses = [r["loss"] for r in res.history]
        if res.steps_run != 150 or not np.all(np.isfinite(losses)):
            raise AssertionError(f"{preset}: {res.steps_run} steps, finite "
                                 f"losses: {np.all(np.isfinite(losses))}")
        acc = res.final["acc"]
        if abs(acc - REF_ACC[preset]) > ACC_ATOL:
            raise AssertionError(f"{preset}: test acc {acc:.4f} is not "
                                 f"within {ACC_ATOL} of the reference's "
                                 f"{REF_ACC[preset]}")
        log(f"main {preset}: device {res.device}, 150 steps in "
            f"{res.wall_time_s:.4f} s ({res.wall_time_s / 150 * 1e3:.4f} "
            f"ms/step), final loss {res.final['loss']:.6f}, test acc "
            f"{acc:.4f} (reference {REF_ACC[preset]}), consensus "
            f"{res.final['consensus']:.3e}, launches {counts}")
    qg, ds = (results["quickstart_ring16_alpha0.1_qg"],
              results["quickstart_ring16_alpha0.1_dsgdm"])
    if qg.final["acc"] < ds.final["acc"]:
        raise AssertionError(f"QG acc {qg.final['acc']} < DSGDm "
                             f"{ds.final['acc']}")

    # the same QG run with the stage-by-stage chain, on the card
    spec = api.presets.get("quickstart_ring16_alpha0.1_qg").override(
        "loop.log_every=1", "optim.fused=off")
    ops.reset_launch_counts()
    off = api.run(spec, device=dev, log_fn=quiet)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"fused=off launched {ops.launch_counts()}")
    rel = _history_close(qg.history, off.history, HIST_RTOL, HIST_ATOL,
                         "fused vs unfused")
    log(f"main fused vs unfused QG on the card: 150 steps agree, max rel "
        f"diff {rel:.3e} (rtol {HIST_RTOL}, atol {HIST_ATOL}); unfused "
        f"{off.wall_time_s / 150 * 1e3:.4f} ms/step, test acc "
        f"{off.final['acc']:.4f}")

    # and on the CPU, through the kernels' plain versions
    cpu = api.run(spec.override("optim.fused=kernel"), device="cpu",
                  log_fn=quiet)
    rel = _history_close(qg.history, cpu.history, CPU_RTOL, CPU_ATOL,
                         "card vs CPU")
    dacc = abs(qg.final["acc"] - cpu.final["acc"])
    if dacc > CPU_ACC_ATOL:
        raise AssertionError(f"card vs CPU: test acc {qg.final['acc']} vs "
                             f"{cpu.final['acc']}")
    log(f"main card vs CPU QG: max rel diff {rel:.3e} over 150 steps, test "
        f"acc {qg.final['acc']:.4f} vs {cpu.final['acc']:.4f}")
    return {"launches": launches, "results": results}


def phase_profile(dev) -> None:
    """Device time by kernel and host time by op over the 150-step training
    loop of one QG run (a measurement: printed, and written to
    build/chip_smoke/profile_qg.json)."""
    import torch
    from repro_torch import api
    from repro_torch.train import run_training_scanned
    from torch.profiler import ProfilerActivity, profile

    spec = api.presets.get("quickstart_ring16_alpha0.1_qg")
    ex = api.build(spec, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_training_scanned(ex.trainer, ex.state, ex.task.make_iter(), 150,
                             chunk=spec.loop.chunk, log_fn=lambda *_: None)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_rows, host_rows = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dt = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            if dt:
                dev_rows.append((e.key, dt / 1e3, e.count))
        elif e.self_cpu_time_total:
            host_rows.append((e.key, e.self_cpu_time_total / 1e3, e.count))
    if not dev_rows:
        log("profile: the profiler recorded no device time")
        return
    dev_rows.sort(key=lambda r: -r[1])
    host_rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in dev_rows)
    launches = sum(r[2] for r in dev_rows)
    log(f"profile QG training loop, 150 steps (profiler on): wall "
        f"{wall_ms:.3f} ms, device kernel time {busy:.3f} ms "
        f"({100 * busy / wall_ms:.2f}% busy), {launches} device "
        f"activities ({launches / 150:.1f} per step)")
    ours = [r for r in dev_rows if "stream3" in r[0]]  # csrc/qg_update.cu
    for key, ms, count in dev_rows[:10] + [r for r in ours
                                           if r not in dev_rows[:10]]:
        log(f"profile device {ms:10.4f} ms {count:6d}x "
            f"{ms / count * 1e3:9.3f} us each  {key[:80]}")
    for key, ms, count in host_rows[:10]:
        log(f"profile host   {ms:10.4f} ms {count:6d}x "
            f"{ms / count * 1e3:9.3f} us each  {key[:80]}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "profile_qg.json").write_text(json.dumps(
        {"wall_ms": wall_ms, "device_ms": busy,
         "device": [{"name": k, "ms": m, "count": c}
                    for k, m, c in dev_rows],
         "host": [{"name": k, "ms": m, "count": c}
                  for k, m, c in host_rows]}, indent=1))


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, ops

    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 1. build
    secs = build.build("qg_update")
    log(f"build qg_update: {secs['qg_update']:.3f} s")
    for line in build._library_path("qg_update").with_suffix(
            ".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"build   {line.strip()}")

    # 2. kernels against their plain versions, then their times
    worst = phase_kernels(dev)
    timed = phase_timing(dev)

    # 3. the main path
    main_out = phase_main(dev)

    # 4. where the device time goes
    phase_profile(dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    sources = {"fused_halfstep": "src/repro/kernels/qg_update.py:116",
               "fused_qg_buffer": "src/repro/kernels/qg_update.py:133",
               "qg_local_step": "src/repro/kernels/qg_update.py:68",
               "qg_buffer_update": "src/repro/kernels/qg_update.py:76"}
    main_launches = {k: sum(c[k] for c in main_out["launches"].values())
                     for k in sources}
    kernels = []
    for name, replaces in sources.items():
        t = timed[(name, QUICKSTART_LEN)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/qg_update.cu",
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": worst[name]["abs"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # any failed phase: report it, print no result line
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
