#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit; run from the root of a
checkout.  Phases, each of which fails the run (non-zero exit, no result
line) if anything goes wrong:

1. build    compile every CUDA kernel of the main path from ``csrc/``
            (``qg_update`` and ``compress``, one ``nvcc`` each, together);
2. kernels  hold each kernel against its plain PyTorch version on the card:
            the streaming kernels over lengths 0-d .. 2**27+5, every flag
            combination and an unaligned view; the row-wise compress kernels
            at the quickstart MLP's four leaf shapes, odd shapes and
            [16, 2**23+5], QSGD at L = 1 and 15 with a zero-scale row and u
            just under 1.  Time kernel and plain version (CUDA graphs
            replayed between CUDA events, so device time without host
            dispatch; eager dispatch timed apart) at the main path's sizes
            and at ~2**27 elements;
3. main     run the two quickstart presets and the three compressed-gossip
            runs (CHOCO top-k, EF sign+norm, CHOCO QSGD, each with
            ``comm.backend=auto``) for their full 150 steps through
            ``repro_torch.api.run(spec, device="cuda")``, with the kernel
            launch counters zeroed just before and read just after each
            run; rerun QG with ``fused="off"``, top-k and EF with
            ``comm.backend=jnp``, and QG and top-k on the CPU, and hold the
            histories against each other;
4. profile  the QG and the top-k training loops under ``torch.profiler``:
            device time by kernel, host time by op.

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

#: fused vs unfused QG history, and kernel vs ``comm.backend=jnp``
#: compressed histories, on the card: the same arithmetic in the same order,
#: so equal up to this (the reference's own fused-vs-unfused bound,
#: tests/test_fused.py)
HIST_RTOL, HIST_ATOL = 1e-5, 1e-6

#: card vs CPU history (same init, same batches): matmul summation order
#: differs between cuBLAS and the CPU BLAS, and the difference grows over
#: 150 steps of training (1.2e-4 relative seen on an H100)
CPU_RTOL, CPU_ATOL, CPU_ACC_ATOL = 1e-3, 1e-5, 5e-3

#: card vs CPU top-k history: top-k is discontinuous, so a rounding
#: difference that moves an entry across the k-th magnitude changes the
#: message by that entry.  On the CPU a 1e-7 change of the init moves the
#: port's own 150-step top-k history by 5e-3 to 5e-2 relative
#: (tests/test_torch_slice.py asserts both ends), so the bound is 5e-2
CPU_TOPK_RTOL = 5e-2

#: the compressed runs: the JAX package's test acc, consensus and
#: wire.ratio_vs_dense for these specs (JAX 0.9.0 on the CPU, 150 steps).
#: The ratio is a count and must match; the port's init is a torch draw, so
#: accuracy is held to the band ACC_ATOL around the reference's
COMPRESSED = {
    "topk": ("choco_topk0.01_ring16_qg", (), 0.5815, 3.416e-2,
             49.46376811594203),
    "ef_signnorm": ("ef_signnorm_ring16_qg", (), 0.9061, 3.524e-2,
                    31.70275761973875),
    "qsgd": ("choco_topk0.01_ring16_qg", ("comm.compressor=qsgd:4",),
             0.9402, 4.525e-3, 6.388021290284845),
}

#: the quickstart MLP's node-stacked leaves (b1, b2, w1, w2), what the
#: row-wise compress kernels see on the main path
LEAF_SHAPES = [(16, 64), (16, 20), (16, 12288), (16, 1280)]
ROW_SHAPES = LEAF_SHAPES + [(1, 1), (3, 517), (5, 8193), (16, 2 ** 23 + 5)]
#: the largest u below 1 in fp32: floor(y + u) must still stop at L
U_MAX = 1.0 - 2.0 ** -24

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
    from repro_torch.kernels import compress as C
    from repro_torch.kernels import qg_update as K
    from repro_torch.kernels import ref

    for gamma in (0.3, 0.02002):   # EF's gamma; top-k's resolved one
        yield ("gamma_correct", f"gamma={gamma}",
               lambda a, b, c, eta, g=gamma: (C.gamma_correct(
                   a, b, c, gamma=g),),
               lambda a, b, c, eta, g=gamma: (ref.gamma_correct(
                   a, b, c, gamma=g),))
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
    _rowwise_checks(dev, gen, worst)
    torch.cuda.synchronize(dev)
    for name, w in worst.items():
        log(f"kernel {name}: {w['cases']} outputs match the plain version, "
            f"max {w['ulp']} ulp (+0 == -0), max abs err {w['abs']:.3e}")
    return worst


def _topk_threshold(x2d):
    """The k-th largest magnitude per row, as the top-1% compressor of the
    main path computes it for ``threshold_mask``."""
    from repro_torch.comm import TopK
    return TopK(frac=0.01)._threshold(x2d)


def _rowwise_checks(dev, gen, worst) -> None:
    """``threshold_mask`` and ``quantize_dequantize`` against their plain
    versions at every row shape, QSGD at L = 1 and 15 with a zero-scale row
    and u just under 1 in every third column."""
    import torch
    from repro_torch.kernels import compress as C
    from repro_torch.kernels import ref

    for shape in ROW_SHAPES:
        x = torch.randn(shape, generator=gen, device=dev)
        thr = _topk_threshold(x)
        _compare("threshold_mask", f"shape={shape}", C.threshold_mask(x, thr),
                 ref.threshold_mask(x, thr), worst)
        u = torch.rand(shape, generator=gen, device=dev)
        u[:, ::3] = U_MAX
        scale = x.abs().amax(dim=1)
        if shape[0] > 1:
            x[-1] = 0.0
            scale[-1] = 0.0
        for levels in (1, 15):
            got = C.quantize_dequantize(x, scale, u, levels=levels)
            _compare("quantize_dequantize", f"L={levels} shape={shape}", got,
                     ref.quantize_dequantize(x, scale, u, levels=levels),
                     worst)
            if shape[0] > 1 and bool(got[0][-1].any()):
                raise AssertionError("quantize_dequantize: a zero-scale row "
                                     "did not quantize to zero")
        del x, u, thr, scale


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
#: (halfstep with weight decay and Nesterov: 4 products, 4 sums; QSGD:
#: abs, product, sum, floor, min, sign, two products, difference)
_FLOPS = {"fused_halfstep": 8, "fused_qg_buffer": 5, "qg_local_step": 6,
          "qg_buffer_update": 5, "gamma_correct": 3, "threshold_mask": 3,
          "quantize_dequantize": 9}


def _time_row(name, size, kfn, pfn, nbytes, n_elems, iters) -> dict:
    """Kernel and plain ms (CUDA graphs of ``iters`` calls), the kernel's
    eager ms, and the bound: the larger of ``nbytes`` (each input read once,
    each output written once) over the card's memory rate and the fp32
    operations over its fp32 rate."""
    kms, pms = _time_ms(kfn, iters), _time_ms(pfn, iters)
    kdisp = _dispatch_ms(kfn)
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = _FLOPS[name.split("[")[0]] * n_elems / PEAK_F32_FLOPS * 1e3
    row = {"size": size, "ms": kms, "plain_ms": pms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "dispatch_ms": kdisp}
    log(f"time {name} size={size}: kernel {kms:.6f} ms, plain {pms:.6f} ms "
        f"(CUDA graph of {iters} calls), bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}, {nbytes} B), {nbytes / kms / 1e6:.1f} GB/s, "
        f"library: none; kernel with eager dispatch {kdisp:.6f} ms")
    return row


def phase_timing(dev) -> dict:
    """Kernel, plain and bound ms of each kernel at the main path's size
    (the quickstart's packed length; the MLP's largest leaf for the
    row-wise kernels) and at about 2**27 elements, in the configuration
    the main path uses."""
    import torch
    from repro_torch.kernels import compress as C
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
            "gamma_correct": (
                lambda: C.gamma_correct(a, b, c, gamma=0.3),
                lambda: ref.gamma_correct(a, b, c, gamma=0.3), 1, 0),
        }
        # fewer captured calls at 2**27+5: each holds its outputs (and the
        # plain version's temporaries, 512 MiB apiece) in the graph's pool
        iters = 20 if n == QUICKSTART_LEN else 4
        for name, (kfn, pfn, n_out, n_scalar) in cfg.items():
            timed[(name, n)] = _time_row(
                name, n, kfn, pfn, (3 + n_out) * n * 4 + 4 * n_scalar, n,
                iters)
        del a, b, c
        torch.cuda.empty_cache()
    for shape in (LEAF_SHAPES[2], ROW_SHAPES[-1]):
        gen = torch.Generator(device=dev).manual_seed(2)
        x = torch.randn(shape, generator=gen, device=dev)
        u = torch.rand(shape, generator=gen, device=dev)
        thr, scale = _topk_threshold(x), x.abs().amax(dim=1)
        n, rows = x.numel(), shape[0]
        iters = 20 if shape == LEAF_SHAPES[2] else 4
        timed[("threshold_mask", shape)] = _time_row(
            "threshold_mask", shape, lambda: C.threshold_mask(x, thr),
            lambda: ref.threshold_mask(x, thr), 12 * n + 4 * rows, n, iters)
        timed[("quantize_dequantize", shape)] = _time_row(
            "quantize_dequantize", shape,
            lambda: C.quantize_dequantize(x, scale, u, levels=15),
            lambda: ref.quantize_dequantize(x, scale, u, levels=15),
            16 * n + 4 * rows, n, iters)
        del x, u, thr, scale
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


def _expect_launches(what: str, counts: dict, want: dict) -> None:
    """Every kernel's launch count equals ``want`` (0 where unlisted)."""
    full = {k: want.get(k, 0) for k in counts}
    if counts != full:
        raise AssertionError(f"{what}: launches {counts}, want {full}")


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
        _expect_launches(preset, counts, {
            "fused_halfstep": 150,
            "fused_qg_buffer": 150 if preset.endswith("_qg") else 0})
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


#: launches of the warm-start capture (``comm/choco.py``): one zero-gradient
#: step of the run's own chain, which on the card is one fused_halfstep and
#: one fused_qg_buffer launch for QG-DSGDm-N
CAPTURE_LAUNCHES = {"fused_halfstep": 1, "fused_qg_buffer": 1}


def phase_compressed(dev) -> dict:
    """The three compressed-gossip runs through the kernels
    (``comm.backend=auto``), each with exact launch counts; top-k and EF
    rerun with ``comm.backend=jnp`` on the card, top-k rerun on the CPU."""
    import numpy as np
    from repro_torch import api
    from repro_torch.kernels import ops

    quiet = lambda *_: None
    api.run(api.presets.get("choco_topk0.01_ring16_qg").override(
        "loop.steps=25", "comm.backend=auto"), device=dev, log_fn=quiet)
    per_step = {  # launches per step of each run, by kernel
        "topk": {"threshold_mask": 4, "gamma_correct": 1},
        "ef_signnorm": {"gamma_correct": 1},
        "qsgd": {"quantize_dequantize": 4, "gamma_correct": 1}}
    specs, results, launches = {}, {}, {}
    for label, (preset, overrides, ref_acc, ref_cons, ref_ratio) in \
            COMPRESSED.items():
        spec = api.presets.get(preset).override(
            *overrides, "comm.backend=auto", "loop.log_every=1")
        ops.reset_launch_counts()
        res = api.run(spec, device=dev, log_fn=quiet)
        counts = ops.launch_counts()
        want = {k: 150 * v for k, v in per_step[label].items()}
        want["fused_halfstep"] = 150 + CAPTURE_LAUNCHES["fused_halfstep"]
        want["fused_qg_buffer"] = 150 + CAPTURE_LAUNCHES["fused_qg_buffer"]
        _expect_launches(label, counts, want)
        specs[label], results[label], launches[label] = spec, res, counts
        losses = [r["loss"] for r in res.history]
        if res.steps_run != 150 or not np.all(np.isfinite(losses)):
            raise AssertionError(f"{label}: {res.steps_run} steps, finite "
                                 f"losses: {np.all(np.isfinite(losses))}")
        acc, ratio = res.final["acc"], res.wire["ratio_vs_dense"]
        if ratio != ref_ratio:
            raise AssertionError(f"{label}: wire ratio {ratio} vs the "
                                 f"reference's {ref_ratio}")
        if abs(acc - ref_acc) > ACC_ATOL:
            raise AssertionError(f"{label}: test acc {acc:.4f} is not within "
                                 f"{ACC_ATOL} of the reference's {ref_acc}")
        log(f"main {label} ({' '.join((preset, *overrides))} "
            f"comm.backend=auto): 150 steps in {res.wall_time_s:.4f} s "
            f"({res.wall_time_s / 150 * 1e3:.4f} ms/step), final loss "
            f"{res.final['loss']:.6f}, test acc {acc:.4f} (reference "
            f"{ref_acc}), consensus {res.final['consensus']:.3e} (reference "
            f"{ref_cons:.3e}), wire.ratio_vs_dense {ratio:.4f} (reference "
            f"{ref_ratio:.4f}), launches {counts}")

    # the same runs on the leaf-by-leaf path: the same arithmetic
    for label in ("topk", "ef_signnorm"):
        ops.reset_launch_counts()
        jnp = api.run(specs[label].override("comm.backend=jnp"), device=dev,
                      log_fn=quiet)
        _expect_launches(f"{label} comm.backend=jnp", ops.launch_counts(), {
            "fused_halfstep": 151, "fused_qg_buffer": 151})
        rel = _history_close(results[label].history, jnp.history, HIST_RTOL,
                             HIST_ATOL, f"{label} kernels vs jnp")
        log(f"main {label} kernels vs comm.backend=jnp on the card: 150 "
            f"steps agree, max rel diff {rel:.3e} (rtol {HIST_RTOL}); jnp "
            f"{jnp.wall_time_s / 150 * 1e3:.4f} ms/step, test acc "
            f"{jnp.final['acc']:.4f}")

    # top-k on the CPU, through the kernels' plain versions
    topk = results["topk"]
    cpu = api.run(specs["topk"], device="cpu", log_fn=quiet)
    rel = _history_close(topk.history, cpu.history, CPU_TOPK_RTOL, CPU_ATOL,
                         "top-k card vs CPU")
    if abs(topk.final["acc"] - cpu.final["acc"]) > CPU_ACC_ATOL:
        raise AssertionError(f"top-k card vs CPU: test acc "
                             f"{topk.final['acc']} vs {cpu.final['acc']}")
    log(f"main card vs CPU top-k: max rel diff {rel:.3e} over 150 steps "
        f"(rtol {CPU_TOPK_RTOL}), test acc {topk.final['acc']:.4f} vs "
        f"{cpu.final['acc']:.4f}")
    return {"launches": launches, "results": results}


def phase_profile(dev, label: str, spec) -> None:
    """Device time by kernel and host time by op over the 150-step training
    loop of one run of ``spec`` (a measurement: printed, and written to
    build/chip_smoke/profile_<label>.json)."""
    import torch
    from repro_torch import api
    from repro_torch.train import run_training_scanned
    from torch.profiler import ProfilerActivity, profile

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
    log(f"profile {label} training loop, 150 steps (profiler on): wall "
        f"{wall_ms:.3f} ms, device kernel time {busy:.3f} ms "
        f"({100 * busy / wall_ms:.2f}% busy), {launches} device "
        f"activities ({launches / 150:.1f} per step)")
    # the kernels of csrc/ (templates of csrc/elementwise.cuh)
    ours = [r for r in dev_rows if "stream3" in r[0] or "rowwise" in r[0]]
    for key, ms, count in dev_rows[:10] + [r for r in ours
                                           if r not in dev_rows[:10]]:
        log(f"profile {label} device {ms:10.4f} ms {count:6d}x "
            f"{ms / count * 1e3:9.3f} us each  {key[:80]}")
    for key, ms, count in host_rows[:10]:
        log(f"profile {label} host   {ms:10.4f} ms {count:6d}x "
            f"{ms / count * 1e3:9.3f} us each  {key[:80]}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"profile_{label}.json").write_text(json.dumps(
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

    # 1. build: one nvcc per source, started together
    libs = ("qg_update", "compress")
    secs = build.build(*libs)
    for lib in libs:
        log(f"build {lib}: {secs[lib]:.3f} s")
        for line in build._library_path(lib).with_suffix(
                ".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"build   {lib}: {line.strip()}")

    # 2. kernels against their plain versions, then their times
    worst = phase_kernels(dev)
    timed = phase_timing(dev)

    # 3. the main path: the quickstart pair, then the compressed runs
    main_out = phase_main(dev)
    comp_out = phase_compressed(dev)

    # 4. where the device time goes
    from repro_torch import api
    phase_profile(dev, "qg", api.presets.get("quickstart_ring16_alpha0.1_qg"))
    phase_profile(dev, "topk", api.presets.get(
        "choco_topk0.01_ring16_qg").override("comm.backend=auto"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    csrc = "src/repro_torch/kernels/csrc/"
    sources = {  # name: (TPU kernel it replaces, source, timed at)
        "fused_halfstep": ("src/repro/kernels/qg_update.py:116",
                           "qg_update.cu", QUICKSTART_LEN),
        "fused_qg_buffer": ("src/repro/kernels/qg_update.py:133",
                            "qg_update.cu", QUICKSTART_LEN),
        "qg_local_step": ("src/repro/kernels/qg_update.py:68",
                          "qg_update.cu", QUICKSTART_LEN),
        "qg_buffer_update": ("src/repro/kernels/qg_update.py:76",
                             "qg_update.cu", QUICKSTART_LEN),
        "gamma_correct": ("src/repro/kernels/compress.py:115",
                          "compress.cu", QUICKSTART_LEN),
        "threshold_mask": ("src/repro/kernels/compress.py:93",
                           "compress.cu", LEAF_SHAPES[2]),
        "quantize_dequantize": ("src/repro/kernels/compress.py:101",
                                "compress.cu", LEAF_SHAPES[2])}
    runs = {**main_out["launches"], **comp_out["launches"]}
    main_launches = {k: sum(c[k] for c in runs.values()) for k in sources}
    kernels = []
    for name, (replaces, src, size) in sources.items():
        t = timed[(name, size)]
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": worst[name]["abs"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))  # the one device this run drives
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # any failed phase: report it, print no result line
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
