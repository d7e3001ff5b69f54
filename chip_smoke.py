#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit; run from the root of a
checkout.  Phases, each of which fails the run (non-zero exit, no result
line) if anything goes wrong:

1. build    compile every CUDA kernel from ``csrc/`` (``qg_update``,
            ``compress``, ``attention`` and ``ssd_scan``, one ``nvcc`` each,
            together), and fail unless ``cuobjdump -sass`` finds tensor-core
            products (HMMA) in every flash kernel instance;
2. kernels  hold each kernel against its plain PyTorch version on the card:
            the streaming kernels over lengths 0-d .. 2**27+5, every flag
            combination and an unaligned view; the row-wise compress kernels
            at the quickstart MLP's four leaf shapes, odd shapes and
            [16, 2**23+5], QSGD at L = 1 and 15 with a zero-scale row and u
            just under 1.  Time kernel and plain version (CUDA graphs
            replayed between CUDA events, so device time without host
            dispatch; eager dispatch timed apart) at the main path's sizes
            and at ~2**27 elements.  The two attention kernels against
            their plain versions in fp32 and bf16 (tolerance ATT_TOL): flash
            at the reference's ATTN_CASES, TinyLlama's [2,1024,32/4,64]
            prefill, a Gemma-2 local layer (D 128, window 4096, softcap 50)
            at 4608 tokens, S = 1 and 1000; paged decode at the reference's
            four cases, the engine's shape with inactive slots (which must
            give 0), 8 slots x 4096 tokens, the same with ragged lengths
            and a length-0 slot, and with window 1000 (the last three split
            over pages and merge: one merge launch per call, checked); each
            timed beside its bound, its plain version and one
            ``scaled_dot_product_attention`` call, paged decode's split and
            merge passes apart under the profiler;
3. main     run the two quickstart presets and the three compressed-gossip
            runs (CHOCO top-k, EF sign+norm, CHOCO QSGD, each with
            ``comm.backend=auto``) for their full 150 steps through
            ``repro_torch.api.run(spec, device="cuda")``, with the kernel
            launch counters zeroed just before and read just after each
            run; rerun QG with ``fused="off"``, top-k and EF with
            ``comm.backend=jnp``, and QG and top-k on the CPU, and hold the
            histories against each other;
4. profile  the QG and the top-k training loops under ``torch.profiler``:
            device time by kernel, host time by op;
5. serve    slice 7's main path: ``python -m repro_torch.serve --arch
            tinyllama-1.1b --full --use-pallas --requests 16`` in code (a
            seeded init at the published widths and 22 layers), with
            ``paged_decode_attention`` launched exactly 22 times per decode
            step, tokens equal to the ``use_pallas=False`` engine's and to
            ``sequential_generate``'s (or parting only at a reported
            near-tie); tokens/s, decode p50/p95, peak cache bytes; then
            ``prefill`` of [2, 1024] tokens through 22 ``flash_attention``
            launches against the chunked path (logits and every layer's
            K/V) and once under ``torch.profiler`` (wall beside device
            time), and the serving run under the profiler (0 merges);
6. mamba    the SSD scan kernel against its plain version in fp32 and bf16
            at the reference's SSD_CASES, S = 1 and 17, chunk 64 vs 256, dt
            x 1e-2 and the main shape (every P-tile), timed at the main
            shape and at [8, 4096]; then slice 6b-i's main path on
            mamba2-130m at its published widths and depth: ``prefill`` of
            [2, 2048] tokens through exactly 24 ``ssd_scan`` launches
            against the plain path (logits, conv and SSM states), 32 greedy
            decode steps from the kernel prefill's state (no launch)
            against ``sequential_generate``, a train-mode forward of [1,
            512] through 24 launches, ``python -m repro_torch.serve --arch
            mamba2-130m --full --baseline --requests 16`` in code (with and
            without ``--use-pallas``), the engine's refusal, and the
            prefill under ``torch.profiler``.

Imports nothing of JAX nor of the JAX package.  The second-to-last lines
are the card's name and power limit and a JSON ``kernels`` line; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
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
#: fp32-accurate products on the tensor cores: 495 TFLOP/s TF32, three TF32
#: products per fp32 product (3xTF32), the flash kernel's yardstick whatever
#: implements it
PEAK_3XTF32_FLOPS = 495e12 / 3


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
# the attention kernels (slice 7) against their plain versions
# ---------------------------------------------------------------------------

#: kernel vs plain version, max abs error at N(0,1) inputs.  Both compute in
#: fp32 but sum in other orders (the kernels online over 64-key tiles or one
#: page at a time, the plain versions one softmax over the whole row), so
#: they agree to rounding, not to the bit: 2e-5 in fp32, where outputs are
#: weighted means of N(0,1) values of order 1 (the reference's own bound
#: for its flash kernel, tests/test_kernels.py:182); in bf16 both round the
#: same fp32 value to bf16 except within rounding of a bf16 boundary, where
#: they differ by one bf16 ulp, 2**-6 = 0.0156 for |out| in [2, 4): 2e-2
ATT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}

#: (B, S, T, H, K, D, kwargs): the reference's ATTN_CASES
#: (tests/test_kernels.py:162), TinyLlama-1.1B's prefill (the main path's
#: shape), a Gemma-2 27B local layer past its window, one query, S = 1000
FLASH_CASES = [
    (1, 128, 128, 4, 4, 32, {}), (2, 256, 256, 8, 2, 64, {}),
    (1, 200, 200, 4, 2, 32, {}), (1, 256, 256, 4, 4, 32, {"window": 64}),
    (1, 256, 256, 4, 4, 32, {"softcap": 30.0}),
    (1, 128, 192, 4, 4, 32, {"causal": False}),
    (2, 1024, 1024, 32, 4, 64, {}),
    (1, 4608, 4608, 32, 16, 128, {"window": 4096, "softcap": 50.0}),
    (1, 1, 1, 32, 4, 64, {}), (1, 1000, 1000, 32, 4, 64, {}),
]
FLASH_MAIN, FLASH_LONG = FLASH_CASES[6], FLASH_CASES[7]

#: (B, H, K, D, ps, P, NP, window, softcap, lengths): the reference's four
#: cases (tests/test_serve.py:234, lengths drawn in [1, P*ps]), the
#: engine's shape at the serving CLI's defaults with two inactive slots
#: (length 0, block-table rows all -1), 8 slots x 4096 tokens, the same
#: with ragged lengths (splits past a slot's length, a length-0 slot) and
#: with window 1000 (splits wholly outside the window): the last three
#: split over pages and merge
PAGED_CASES = [
    (3, 8, 2, 32, 16, 8, 6, 0, 0.0, None),
    (2, 4, 4, 64, 8, 4, 8, 0, 30.0, None),
    (4, 8, 2, 32, 16, 8, 6, 20, 50.0, None),
    (1, 4, 2, 16, 1, 16, 16, 0, 0.0, None),
    (8, 32, 4, 64, 16, 16, 128, 0, 0.0, (0, 24, 33, 48, 16, 0, 40, 31)),
    (8, 32, 4, 64, 16, 256, 2048, 0, 0.0, (4096,) * 8),
    (8, 32, 4, 64, 16, 256, 2048, 0, 0.0,
     (1, 17, 300, 4096, 0, 2048, 4095, 16)),
    (8, 32, 4, 64, 16, 256, 2048, 1000, 0.0, (4096,) * 8),
]
PAGED_MAIN, PAGED_LONG = PAGED_CASES[4], PAGED_CASES[5]


def _flash_inputs(case, dtype, dev, seed):
    import torch
    b, s, t, h, kh, d, kw = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))
    return q, k, v, kw


def _paged_inputs(case, dtype, dev, seed):
    import numpy as np
    import torch
    b, h, kh, d, ps, p_max, n_p, window, softcap, lengths = case
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(dtype)
    kp, vp = (torch.randn((n_p, ps, kh, d), generator=gen,
                          device=dev).to(dtype) for _ in range(2))
    if lengths is None:
        lengths = rng.integers(1, min(p_max, n_p) * ps + 1, size=b)
    lengths = np.asarray(lengths, np.int32)
    need = -(-lengths // ps)
    perm = rng.permutation(n_p)
    bt = np.full((b, p_max), -1, np.int32)
    if need.sum() <= n_p:      # every slot's pages distinct
        starts = np.concatenate([[0], np.cumsum(need)])
        for i in range(b):
            bt[i, :need[i]] = perm[starts[i]:starts[i + 1]]
    else:                      # the reference's draw: distinct per slot
        for i in range(b):
            bt[i, :need[i]] = rng.choice(n_p, size=need[i], replace=False)
    return (q, kp, vp, torch.from_numpy(bt).to(dev),
            torch.from_numpy(lengths).to(dev),
            {"window": window, "softcap": softcap})


def phase_attention_kernels(dev) -> dict:
    """Both attention kernels against their plain versions at every listed
    shape, in fp32 and bf16; an inactive paged slot must give exactly 0
    from both.  Returns the worst fp32 and bf16 error per kernel."""
    import torch
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import ref

    worst = {"flash_attention": {}, "paged_decode_attention": {}}

    def check(name, label, dtype, got, want):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {label}: {got.shape} {got.dtype} "
                                 f"vs plain {want.shape} {want.dtype}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {label}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        key = str(dtype).replace("torch.", "")
        worst[name][key] = max(worst[name].get(key, 0.0), err)
        if err > ATT_TOL[key]:
            raise AssertionError(f"{name} {label}: max abs err {err:.3e} vs "
                                 f"its plain version; allowed {ATT_TOL[key]}")
        return err

    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(FLASH_CASES):
            q, k, v, kw = _flash_inputs(case, dtype, dev, 10 + i)
            err = check("flash_attention", f"{case[:6]} {kw} {dtype}", dtype,
                        A.flash_attention(q, k, v, **kw),
                        ref.flash_attention(q, k, v, **kw))
            log(f"kernel flash_attention {dtype} B,S,T,H,K,D={case[:6]} "
                f"{kw}: max abs err {err:.3e}")
            del q, k, v
        for i, case in enumerate(PAGED_CASES):
            q, kp, vp, bt, ln, kw = _paged_inputs(case, dtype, dev, 20 + i)
            merges = A.LAUNCHES["paged_decode_merge"]
            got = A.paged_decode_attention(q, kp, vp, bt, ln, **kw)
            merges = A.LAUNCHES["paged_decode_merge"] - merges
            splits = A.paged_splits(case[0], case[2], case[5], case[4])
            if merges != (splits[0] > 1):
                raise AssertionError(f"paged_decode_attention {case[:9]}: "
                                     f"{merges} merge launches with "
                                     f"(splits, pages per split) {splits}")
            want = ref.paged_decode_attention(q, kp, vp, bt, ln, **kw)
            err = check("paged_decode_attention", f"{case[:9]} {dtype}",
                        dtype, got, want)
            dead = (ln == 0).nonzero().flatten()
            if len(dead) and (bool(got[dead].any())
                              or bool(want[dead].any())):
                raise AssertionError(f"paged_decode_attention {case[:9]}: "
                                     f"an inactive slot is not 0")
            log(f"kernel paged_decode_attention {dtype} "
                f"B,H,K,D,ps,P,NP={case[:7]} window={kw['window']} "
                f"softcap={kw['softcap']} lengths="
                f"{ln.tolist() if len(ln) <= 8 else '...'}: (splits, pages "
                f"per split) {splits}, {merges} merge launch(es); max abs "
                f"err {err:.3e}, {len(dead)} inactive slot(s) 0 in both")
            del q, kp, vp
        torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    return worst


def _band_pairs(s, t, causal, window) -> int:
    """(query, key) pairs inside the mask of one (batch, head)."""
    import numpy as np
    i = np.arange(s)
    hi = np.minimum(i + 1, t) if causal else np.full(s, t)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def _bound(nbytes, flops, peak=PEAK_F32_FLOPS):
    """The larger of ``nbytes`` over the memory rate and ``flops`` over
    ``peak``, the rate of the kernel's operations on this card, in ms."""
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = flops / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _profile_kernels(dev, fn, reps: int = 20) -> tuple[float, dict]:
    """One warm-up call of ``fn``, then ``reps`` eager calls under
    ``torch.profiler``: (wall ms per call on the host clock, device ms per
    call of each kernel launched, by its short name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3 / reps
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dt = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            if dt:
                hit = re.search(r"::(\w+<[^>]*>)", e.key)
                name = hit.group(1) if hit else e.key[:60]
                out[name] = out.get(name, 0.0) + dt / 1e3 / reps
    return wall, out


def phase_attention_timing(dev) -> dict:
    """Kernel, plain and library ms (CUDA graphs of the calls) and the
    bound of each attention kernel at the main path's shape and at a long
    shape, fp32.  The library yardstick is one
    ``F.scaled_dot_product_attention`` call (GQA by ``enable_gqa``); for
    paged decode it runs on a cache gathered beforehand, so it leaves the
    gather out.  The port never calls it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention as A
    from repro_torch.kernels import ref

    timed = {}
    for label, case, iters in (("main", FLASH_MAIN, 10),
                               ("long", FLASH_LONG, 2)):
        q, k, v, kw = _flash_inputs(case, torch.float32, dev, 30)
        b, s, t, h, kh, d, _ = case
        causal, window = kw.get("causal", True), kw.get("window", 0)
        pairs = _band_pairs(s, t, causal, window) * b * h
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
        bound, by = _bound(nbytes, 4 * d * pairs, PEAK_3XTF32_FLOPS)
        lib_ms = None
        if not kw.get("softcap") and not window:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), iters)
            del qt, kt, vt
        row = {"shape": case[:6], "kw": kw,
               "ms": _time_ms(lambda: A.flash_attention(q, k, v, **kw),
                              iters),
               "plain_ms": _time_ms(lambda: ref.flash_attention(q, k, v,
                                                                **kw), iters),
               "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
               "flops": 4 * d * pairs, "bytes": nbytes}
        timed[("flash_attention", label)] = row
        if label == "main":   # the bf16 instance: one product for Q K^T
            qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
            row["bf16_ms"] = _time_ms(
                lambda: A.flash_attention(qb, kb, vb, **kw), iters)
            del qb, kb, vb
        log(f"time flash_attention {label} B,S,T,H,K,D={case[:6]} {kw} fp32: "
            f"kernel {row['ms']:.6f} ms, plain {row['plain_ms']:.6f} ms, "
            f"library {lib_ms if lib_ms is None else f'{lib_ms:.6f}'} ms "
            f"(CUDA graphs of {iters} calls), bound {bound:.6f} ms ({by}: "
            f"{4 * d * pairs} flop at 165 TFLOP/s, {nbytes} B), "
            f"{4 * d * pairs / row['ms'] / 1e9:.2f} TFLOP/s"
            + (f"; bf16 kernel {row['bf16_ms']:.6f} ms" if "bf16_ms" in row
               else ""))
        del q, k, v
        torch.cuda.empty_cache()
    for label, case, iters in (("main", PAGED_MAIN, 20),
                               ("long", PAGED_LONG, 10)):
        q, kp, vp, bt, ln, kw = _paged_inputs(case, torch.float32, dev, 40)
        b, h, kh, d, ps = case[:5]
        rows = int(ln.sum())     # visible rows (no window on these shapes)
        nbytes = 4 * (2 * q.numel() + bt.numel() + ln.numel()
                      + 2 * rows * kh * d)
        bound, by = _bound(nbytes, 4 * d * h * rows)
        t_idx = torch.arange(bt.shape[1] * ps, device=dev)
        gidx = torch.clamp(bt.long()[:, t_idx // ps] * ps + t_idx % ps, 0,
                           kp.shape[0] * ps - 1)
        kd, vd = (p.reshape(-1, kh, d)[gidx].transpose(1, 2).contiguous()
                  for p in (kp, vp))
        mask = (t_idx[None, :] < ln[:, None])[:, None, None, :]
        qt = q.transpose(1, 2).contiguous()
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kd, vd, attn_mask=mask, enable_gqa=True), iters)
        before = dict(A.LAUNCHES)
        A.paged_decode_attention(q, kp, vp, bt, ln, **kw)
        per_call = {k: A.LAUNCHES[k] - before[k] for k in before}
        _, parts = _profile_kernels(dev, lambda: A.paged_decode_attention(
            q, kp, vp, bt, ln, **kw))
        splits = A.paged_splits(b, kh, case[5], ps)
        row = {"shape": case[:7], "lengths": ln.tolist(),
               "splits": splits, "launches_per_call": per_call,
               "ms": _time_ms(lambda: A.paged_decode_attention(
                   q, kp, vp, bt, ln, **kw), iters),
               "plain_ms": _time_ms(lambda: ref.paged_decode_attention(
                   q, kp, vp, bt, ln, **kw), iters),
               "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
               "bytes": nbytes}
        timed[("paged_decode_attention", label)] = row
        log(f"time paged_decode_attention {label} B,H,K,D,ps,P,NP="
            f"{case[:7]} fp32, {rows} visible rows: kernel "
            f"{row['ms']:.6f} ms, plain {row['plain_ms']:.6f} ms, library "
            f"(SDPA on a pre-gathered cache, gather not counted) "
            f"{lib_ms:.6f} ms (CUDA graphs of {iters} calls), bound "
            f"{bound:.6f} ms ({by}: {nbytes} B), "
            f"{nbytes / row['ms'] / 1e6:.1f} GB/s; (splits, pages per "
            f"split) {splits}, launches per call {per_call}; by kernel "
            f"(profiler, eager) "
            + ", ".join(f"{k} {v:.6f} ms" for k, v in parts.items()))
        del q, kp, vp, kd, vd
        torch.cuda.empty_cache()
    return timed


# ---------------------------------------------------------------------------
# the serving path (slice 7's main path) and the full-width prefill
# ---------------------------------------------------------------------------

#: the serving main path, as ``python -m repro_torch.serve --arch
#: tinyllama-1.1b --full --use-pallas --requests 16`` runs it: a fresh
#: seeded init at the published widths and depth, the CLI's defaults
SERVE_ARCH, SERVE_REDUCED = "tinyllama-1.1b", False
SERVE_KW = {"n_slots": 8, "page_size": 16, "max_len": 256,
            "prefill_chunk": 32}
SERVE_REQUESTS, SERVE_MAX_NEW, SERVE_SEED = 16, 16, 0
PREFILL_SHAPE = (2, 1024)

#: tokens of two serving paths may part only at a near-tie: where the top-2
#: logit gap at the first divergence is below this, the step and gap are
#: reported and the tokens compared up to it.  1e-3 is ten times the
#: largest logit difference allowed between two fp32 forward paths below
LOGIT_TOL = 1e-3

#: full-width prefill, flash kernel vs the chunked path: last-position
#: logits and every layer's K/V cache, max abs difference.  Two fp32 sums
#: in other orders per layer, carried through 22 layers: 1e-4
PREFILL_TOL = 1e-4


def _serve_setup(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve.__main__ import make_requests

    cfg = get_config(SERVE_ARCH, reduced=SERVE_REDUCED)
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    params = tf.init_lm(gen, cfg)
    reqs = make_requests(SERVE_REQUESTS, cfg.vocab_size, seed=SERVE_SEED,
                         max_new=SERVE_MAX_NEW)
    return cfg, params, reqs


def _compare_tokens(what, params, cfg, reqs, got, want, dev) -> list:
    """Request by request, ``got`` equals ``want``, or they part at a
    near-tie (top-2 gap of the dense prefill's logits there below
    LOGIT_TOL), reported and compared up to that step."""
    import torch
    from repro_torch.models import transformer as tf

    ties = []
    for r, g, w in zip(reqs, got, want):
        if g == w:
            continue
        i = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        prefix = torch.tensor([list(r.prompt) + list(g[:i])], device=dev)
        logits, _ = tf.prefill(params, prefix, cfg)
        top = logits[0].float().topk(2).values
        gap = float(top[0] - top[1])
        if gap >= LOGIT_TOL:
            raise AssertionError(f"{what}: request {r.id} parts at token {i} "
                                 f"({g[i]} vs {w[i]}) with top-2 gap "
                                 f"{gap:.3e} >= {LOGIT_TOL}")
        ties.append((r.id, i, gap))
        log(f"serve {what}: request {r.id} parts at token {i} at a near-tie "
            f"(top-2 gap {gap:.3e} < {LOGIT_TOL}); equal before it")
    return ties


def phase_serve(dev, cfg, params, reqs) -> dict:
    """The engine through the paged-decode kernel with exact launch counts,
    held against the engine without the kernels and against
    ``sequential_generate``, request by request."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine, sequential_generate

    # warm-up (allocator, cuBLAS handles); its launches are not the path's
    ServeEngine(params, cfg, use_pallas=True, **SERVE_KW).run(reqs[:2])
    eng = ServeEngine(params, cfg, use_pallas=True, **SERVE_KW)
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = eng.timers["decode"].total_laps
    _expect_launches("serve", counts,
                     {"paged_decode_attention": steps * cfg.n_layers})
    n_tok = sum(len(o.tokens) for o in outs)
    st = eng.stats()
    dec = st["phases"]["decode"]
    log(f"main serve {cfg.name} ({cfg.n_params()} params, "
        f"{len(reqs)} requests, {SERVE_KW}): {n_tok} tokens in {wall:.4f} s "
        f"= {n_tok / wall:.2f} tokens/s; {steps} decode steps, p50 "
        f"{dec['p50_s'] * 1e3:.4f} ms, p95 {dec['p95_s'] * 1e3:.4f} ms, "
        f"mean {dec['mean_s'] * 1e3:.4f} ms; "
        f"{st['phases']['prefill'].get('count', 0)} prefill chunks, p50 "
        f"{st['phases']['prefill']['p50_s'] * 1e3:.4f} ms; peak cache "
        f"{st['peak_cache_bytes']} B of a {st['pool_bytes']} B pool; "
        f"launches {counts}")
    if n_tok != len(reqs) * SERVE_MAX_NEW:
        raise AssertionError(f"serve: {n_tok} tokens")

    ops.reset_launch_counts()
    plain = ServeEngine(params, cfg, use_pallas=False, **SERVE_KW).run(reqs)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"use_pallas=False launched "
                             f"{ops.launch_counts()}")
    got = [o.tokens for o in outs]
    ties = _compare_tokens("kernel engine vs use_pallas=False engine",
                           params, cfg, reqs, got,
                           [o.tokens for o in plain], dev)
    seq = []
    for r in reqs:
        prompt = torch.tensor([r.prompt], dtype=torch.int32, device=dev)
        toks = sequential_generate(params, cfg, prompt, gen_len=r.max_new,
                                   cache_len=len(r.prompt) + r.max_new)
        seq.append(tuple(toks[0, len(r.prompt):].tolist()))
    ties += _compare_tokens("kernel engine vs sequential_generate", params,
                            cfg, reqs, got, seq, dev)
    log(f"main serve tokens: kernel engine == use_pallas=False engine == "
        f"sequential_generate for {len(reqs)} requests"
        + (f" up to {len(ties)} near-tie(s)" if ties else " (all equal)"))
    return {"launches": counts, "tokens_per_s": n_tok / wall, "steps": steps,
            "stats": st, "wall_s": wall, "ties": ties}


def _allocator(dev) -> str:
    """The caching allocator's state: what it holds, what the device has
    free, and how often it called cudaMalloc and cudaFree and how often a
    cudaMalloc failed so that it freed its cache and tried again."""
    import torch
    st = torch.cuda.memory_stats(dev)
    free, total = torch.cuda.mem_get_info(dev)
    return (f"allocated {st['allocated_bytes.all.current']} B, reserved "
            f"{st['reserved_bytes.all.current']} B, device free {free} of "
            f"{total} B, {st['num_device_alloc']} cudaMalloc, "
            f"{st['num_device_free']} cudaFree, {st['num_alloc_retries']} "
            f"retries")


def phase_prefill(dev, cfg, params) -> dict:
    """``prefill(tokens [2, 1024], use_pallas=True)`` at full width: 22
    flash launches, logits and every layer's K/V within PREFILL_TOL of the
    chunked path, which is timed on its first call and again (the
    allocator's state logged around the first); then one kernel-path call
    under the profiler: its wall time beside its device time."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    rng = np.random.default_rng(SERVE_SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           size=PREFILL_SHAPE)).to(dev)
    tf.prefill(params, tokens, cfg, use_pallas=True)        # warm-up
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = tf.prefill(params, tokens, cfg, use_pallas=True)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    _expect_launches("prefill", counts, {"flash_attention": cfg.n_layers})
    log(f"main prefill allocator before the chunked path: "
        f"{_allocator(dev)}")
    plain_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        want, want_cache = tf.prefill(params, tokens, cfg, use_pallas=False)
        torch.cuda.synchronize(dev)
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        if len(plain_ms) == 1:
            log(f"main prefill allocator after its first call: "
                f"{_allocator(dev)}")
    errs = {"logits": float((logits - want).abs().max())}
    for j, (c, w) in enumerate(zip(cache["blocks"], want_cache["blocks"])):
        for key in ("k", "v"):
            errs[f"blocks[{j}].{key}"] = float((c[key] - w[key]).abs().max())
        if not torch.equal(c["slot_pos"], w["slot_pos"]):
            raise AssertionError("prefill: slot_pos differs")
    worst = max(errs.values())
    if not torch.isfinite(logits).all() or worst > PREFILL_TOL:
        raise AssertionError(f"prefill: flash vs chunked {errs}; allowed "
                             f"{PREFILL_TOL}")
    log(f"main prefill {cfg.name} tokens {list(PREFILL_SHAPE)}: flash "
        f"{ms:.4f} ms (after a warm-up), chunked {plain_ms[0]:.4f} ms first "
        f"call, {plain_ms[1]:.4f} ms second (host clock); max abs diff "
        f"logits {errs['logits']:.3e}, K/V "
        f"{max(v for k, v in errs.items() if k != 'logits'):.3e} (allowed "
        f"{PREFILL_TOL}); launches {counts}")
    del want, want_cache, cache
    wall, parts = _profile_kernels(
        dev, lambda: tf.prefill(params, tokens, cfg, use_pallas=True), 1)
    busy = sum(parts.values())
    flash = sum(v for k, v in parts.items() if k.startswith("flash_tc"))
    log(f"main prefill {cfg.name} tokens {list(PREFILL_SHAPE)} under the "
        f"profiler: wall {wall:.4f} ms, device kernel time {busy:.4f} ms "
        f"({100 * busy / wall:.2f}% busy), flash_attention {flash:.4f} ms "
        f"({100 * flash / max(busy, 1e-9):.2f}% of device time)")
    return {"launches": counts, "errs": errs, "ms": ms, "plain_ms": plain_ms,
            "profiled_wall_ms": wall, "device_ms": busy, "flash_ms": flash}


def phase_serve_profile(dev, cfg, params, reqs) -> dict:
    """The kernel engine's run under ``torch.profiler``: device busy share,
    device time by kernel, and the decode step beside its weight-read
    bound (every batched step reads all fp32 weights once)."""
    import torch
    from repro_torch.serve import ServeEngine
    from torch.profiler import ProfilerActivity, profile

    eng = ServeEngine(params, cfg, use_pallas=True, **SERVE_KW)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, host_rows = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dt = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            if dt:
                rows.append((e.key, dt / 1e3, e.count))
        elif e.self_cpu_time_total:
            host_rows.append((e.key, e.self_cpu_time_total / 1e3, e.count))
    host_rows.sort(key=lambda r: -r[1])
    weight_ms = 4 * cfg.n_params() / PEAK_BYTES_S * 1e3
    dec = eng.stats()["phases"]["decode"]
    out = {"wall_ms": wall_ms, "weight_bound_ms": weight_ms,
           "decode_p50_ms": dec["p50_s"] * 1e3}
    if not rows:
        log("profile serve: the profiler recorded no device time")
        return out
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    ours = [r for r in rows if "paged_decode" in r[0]]
    out.update(device_ms=busy, busy=busy / wall_ms,
               paged_ms=sum(r[1] for r in ours))
    log(f"profile serve {cfg.name} engine run, {len(reqs)} requests "
        f"(profiler on): wall {wall_ms:.3f} ms, device kernel time "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.2f}% busy); decode step p50 "
        f"{dec['p50_s'] * 1e3:.4f} ms beside its weight-read bound "
        f"{weight_ms:.4f} ms ({4 * cfg.n_params()} B at 3.35 TB/s); "
        f"paged_decode_attention {out['paged_ms']:.4f} ms "
        f"({100 * out['paged_ms'] / busy:.2f}% of device time)")
    steps = eng.timers["decode"].total_laps + eng.timers["prefill"].total_laps
    log(f"profile serve: {sum(r[2] for r in rows)} device activities, "
        f"{sum(r[2] for r in rows) / steps:.1f} per engine step ({steps} "
        f"decode and prefill steps)")
    for key, ms, count in rows[:12] + [r for r in ours if r not in rows[:12]]:
        log(f"profile serve device {ms:10.4f} ms {count:6d}x "
            f"{ms / count * 1e3:9.3f} us each  {key[:80]}")
    syncs = [r for r in host_rows if "Synchronize" in r[0]
             or r[0] in ("aten::item", "aten::_local_scalar_dense")]
    for key, ms, count in host_rows[:12] + [r for r in syncs
                                            if r not in host_rows[:12]]:
        log(f"profile serve host   {ms:10.4f} ms {count:6d}x "
            f"{ms / count * 1e3:9.3f} us each  {key[:80]}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "profile_serve.json").write_text(json.dumps(
        {"wall_ms": wall_ms, "device_ms": busy,
         "device": [{"name": k, "ms": m, "count": c} for k, m, c in rows],
         "host": [{"name": k, "ms": m, "count": c}
                  for k, m, c in host_rows]}, indent=1))
    return out


# ---------------------------------------------------------------------------
# the Mamba-2 SSD scan (slice 6b-i) against its plain version, and the
# Mamba path at full width
# ---------------------------------------------------------------------------

#: kernel vs plain version: y within atol + rtol * |y_plain| and the final
#: state likewise.  fp32: the reference's own bound between its kernel and
#: its sequential oracle (tests/test_kernels.py:221); the kernel sums each
#: chunk as three products where the plain version steps token by token.
#: bf16: both compute in fp32 and round y once to bf16, so they differ by
#: at most one bf16 ulp where the two fp32 values straddle a rounding
#: boundary (2**-7 relative): 2e-2
SSD_TOL = {"float32": (5e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}

#: (B, S, H, P, N, chunk, dt scale): the reference's SSD_CASES
#: (tests/test_kernels.py:199), one token and 17 tokens (chunk = S), P 48
#: (three blocks of 16 columns; P 32 and 64 take blocks of 32, P 16 one of
#: 16), chunk 64 and 256 on the same inputs, dt x 1e-2 (exp(a dt) near 1:
#: the state carries across every chunk), and the main path's shape
#: (mamba2-130m at [2, 2048]) at both dt scales
SSD_CASES = [
    (1, 128, 2, 32, 16, 64, 1.0), (2, 256, 3, 64, 32, 64, 1.0),
    (1, 256, 1, 16, 128, 128, 1.0), (2, 512, 4, 32, 64, 256, 1.0),
    (1, 1, 2, 32, 16, 128, 1.0), (1, 17, 2, 32, 16, 128, 1.0),
    (2, 256, 3, 48, 64, 128, 1.0),
    (1, 256, 2, 32, 16, 64, 1e-2), (1, 256, 2, 32, 16, 256, 1e-2),
    (2, 512, 4, 32, 64, 256, 1e-2),
    (2, 2048, 24, 64, 128, 128, 1.0), (2, 2048, 24, 64, 128, 128, 1e-2),
]
SSD_MAIN = SSD_CASES[-1]
SSD_LARGE = (8, 4096, 24, 64, 128, 128, 1e-2)

#: the Mamba path: mamba2-130m (configs/mamba2_130m.py) at its published
#: widths and depth, a seeded init, fp32 with TF32 off
MAMBA_ARCH, MAMBA_SEED = "mamba2-130m", 0
MAMBA_PREFILL, MAMBA_TRAIN, MAMBA_DECODE = (2, 2048), (1, 512), 32

#: kernel path vs plain path of a whole forward: max |diff| / max |plain|
#: of the last logits and of every layer's conv and SSM state.  Both are
#: fp32; the scan sums in other orders (1e-6 relative per layer seen on
#: reduced configs), carried through 24 layers: 1e-4
MAMBA_TOL = 1e-4


def _ssd_inputs(case, dtype, dev, seed):
    """x, dt, a, b, c, d_skip at the reference test's scales (x 0.5, b and
    c 0.3, dt = softplus(N(0, 1)) times the case's scale, a = -exp(0.3 N))."""
    import torch
    b, s, h, p, n, _, dt_scale = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    x = (rnd(b, s, h, p) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, s, h)) * dt_scale
    a = -torch.exp(rnd(h) * 0.3)
    bm, cm = ((rnd(b, s, n) * 0.3).to(dtype) for _ in range(2))
    d = 1.0 + 0.5 * rnd(h)
    return x, dt, a, bm, cm, d


def phase_ssd_kernels(dev) -> dict:
    """The SSD scan against its plain version at every case in fp32 and
    bf16 (y and the final state); returns the worst max abs error per
    dtype."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as K

    worst = {}

    def check(label, dtype, got, want):
        atol, rtol = SSD_TOL[str(dtype).replace("torch.", "")]
        errs = []
        for g, w, what in zip(got, want, ("y", "state")):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"ssd_scan {label}: {what} {g.shape} "
                                     f"{g.dtype} vs plain {w.shape} {w.dtype}")
            if not torch.isfinite(g).all():
                raise AssertionError(f"ssd_scan {label}: non-finite {what}")
            d = (g.float() - w.float()).abs()
            excess = float((d - rtol * w.float().abs()).max())
            if excess > atol:
                raise AssertionError(
                    f"ssd_scan {label}: {what} off its plain version by "
                    f"{excess:.3e} beyond rtol {rtol} (max abs "
                    f"{float(d.max()):.3e}); allowed atol {atol}")
            errs.append(float(d.max()))
        key = str(dtype).replace("torch.", "")
        worst[key] = max(worst.get(key, 0.0), *errs)
        return errs

    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(SSD_CASES):
            x, dt, a, bm, cm, d = _ssd_inputs(case, dtype, dev, 50 + i)
            got = K.ssd_scan(x, dt, a, bm, cm, d, chunk=case[5])
            want = ref.ssd_scan(x, dt, a, bm, cm, d)
            ey, es = check(f"{case} {dtype}", dtype, got, want)
            log(f"kernel ssd_scan {dtype} B,S,H,P,N,chunk={case[:6]} dt x "
                f"{case[6]}: max abs err y {ey:.3e}, state {es:.3e} (max "
                f"|state| {float(want[1].abs().max()):.3e})")
            del x, bm, cm, got, want
    # chunk 64 against chunk 256 on the same inputs (cases 7 and 8 share
    # shapes; draw once)
    x, dt, a, bm, cm, d = _ssd_inputs(SSD_CASES[7], torch.float32, dev, 70)
    y64, f64 = K.ssd_scan(x, dt, a, bm, cm, d, chunk=64)
    y256, f256 = K.ssd_scan(x, dt, a, bm, cm, d, chunk=256)
    ey, es = check("chunk 64 vs 256", torch.float32, (y64, f64), (y256, f256))
    log(f"kernel ssd_scan chunk 64 vs chunk 256 on the same inputs: max abs "
        f"diff y {ey:.3e}, state {es:.3e}")
    del x, bm, cm, y64, f64, y256, f256
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    log(f"kernel ssd_scan: every case within its tolerance {SSD_TOL}; worst "
        f"max abs err fp32 {worst['float32']:.3e}, bf16 "
        f"{worst['bfloat16']:.3e}")
    return worst


def _ssd_cost(case):
    """(flops, bytes) of one scan.  Flops: the least the function needs,
    the recurrence's own per token and head -- N*P for the state's decay,
    2*N*P + P for dt B x^T, 2*N*P for C h, 2*P for the D-skip, 2 for a*dt
    and its exp; a chunked form does more (C.B^T and the intra-chunk
    combine).  Bytes: fp32 x and y, b and c read once, dt, a, d_skip and
    the final state."""
    b, s, h, p, n, _, _ = case
    flops = b * s * h * (5 * n * p + 3 * p + 2)
    nbytes = 4 * (2 * b * s * h * p + 2 * b * s * n + b * s * h + 2 * h
                  + b * h * n * p)
    return flops, nbytes


def phase_ssd_timing(dev) -> dict:
    """Kernel and plain ms (CUDA graphs) and bound of the SSD scan at the
    main shape and at [8, 4096] with the same widths, fp32.  No single
    PyTorch call computes the scan: the library column is none."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as K

    timed = {}
    for label, case, iters in (("main", SSD_MAIN, 10),
                               ("large", SSD_LARGE, 4)):
        x, dt, a, bm, cm, d = _ssd_inputs(case, torch.float32, dev, 80)
        flops, nbytes = _ssd_cost(case)
        bound, by = _bound(nbytes, flops)
        row = {"shape": case[:6],
               "ms": _time_ms(lambda: K.ssd_scan(x, dt, a, bm, cm, d),
                              iters),
               "plain_ms": _time_ms(lambda: ref.ssd_scan(x, dt, a, bm, cm,
                                                         d), 1, reps=3),
               "bound_ms": bound, "bound_by": by, "library_ms": None,
               "flops": flops, "bytes": nbytes,
               "dispatch_ms": _dispatch_ms(lambda: K.ssd_scan(
                   x, dt, a, bm, cm, d))}
        timed[label] = row
        log(f"time ssd_scan {label} B,S,H,P,N,chunk={case[:6]} fp32: kernel "
            f"{row['ms']:.6f} ms (CUDA graph of {iters} calls), plain "
            f"{row['plain_ms']:.6f} ms (sequential over S, CUDA graph of 1 "
            f"call), library: none, bound {bound:.6f} ms ({by}: "
            f"{flops} flop, {nbytes} B), {flops / row['ms'] / 1e9:.2f} "
            f"TFLOP/s; kernel with eager dispatch {row['dispatch_ms']:.6f} "
            f"ms")
        del x, dt, a, bm, cm, d
        torch.cuda.empty_cache()
    return timed


def _rel_err(got, want) -> float:
    """max |got - want| / max |want| (0 for two zero tensors)."""
    scale = float(want.float().abs().max())
    diff = float((got.float() - want.float()).abs().max())
    return diff / scale if scale else diff


def phase_mamba(dev) -> dict:
    """Slice 6b-i's main path at the published widths and depth: prefill
    [2, 2048] through exactly 24 ``ssd_scan`` launches against the plain
    path, 32 greedy decode steps from the kernel prefill's state (no
    launch) against ``sequential_generate``, a train-mode forward through
    24 launches, the ``--baseline`` serving CLI, and the engine's refusal."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ServeEngine, sequential_generate
    from repro_torch.serve.__main__ import main as serve_main

    cfg = get_config(MAMBA_ARCH)
    gen = torch.Generator(device=dev).manual_seed(MAMBA_SEED)
    params = tf.init_lm(gen, cfg)
    rng = np.random.default_rng(MAMBA_SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           size=MAMBA_PREFILL)).to(dev)
    tf.prefill(params, tokens[:, :256], cfg, use_pallas=True)   # warm-up
    tf.prefill(params, tokens[:, :256], cfg, use_pallas=False)
    torch.cuda.synchronize(dev)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = tf.prefill(params, tokens, cfg, use_pallas=True)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    _expect_launches("mamba prefill", counts, {"ssd_scan": cfg.n_layers})
    t0 = time.perf_counter()
    want, want_cache = tf.prefill(params, tokens, cfg, use_pallas=False)
    torch.cuda.synchronize(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = {"logits": _rel_err(logits, want)}
    for key in ("conv", "ssm"):
        errs[key] = _rel_err(cache["blocks"][0][key],
                             want_cache["blocks"][0][key])
    if not torch.isfinite(logits).all() or max(errs.values()) > MAMBA_TOL:
        raise AssertionError(f"mamba prefill: kernel vs plain path {errs} "
                             f"(max |diff| / max |plain|); allowed "
                             f"{MAMBA_TOL}")
    log(f"main mamba prefill {cfg.name} ({cfg.n_params()} params) tokens "
        f"{list(MAMBA_PREFILL)}: kernel path {ms:.4f} ms, plain path "
        f"{plain_ms:.4f} ms (host clock, one call each); relative error "
        f"logits {errs['logits']:.3e}, conv state {errs['conv']:.3e}, ssm "
        f"state {errs['ssm']:.3e} (allowed {MAMBA_TOL}); launches {counts}")

    # greedy decode from the kernel prefill's state: no launch
    ops.reset_launch_counts()
    tok = torch.argmax(logits, dim=-1)[:, None]
    out, step_logits = [tok], [logits]
    s = MAMBA_PREFILL[1]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(MAMBA_DECODE):
        lg, cache = tf.decode_step(params, tok, s + i, cache, cfg)
        tok = torch.argmax(lg, dim=-1)[:, None]
        out.append(tok)
        step_logits.append(lg)
    torch.cuda.synchronize(dev)
    dec_ms = (time.perf_counter() - t0) * 1e3 / MAMBA_DECODE
    _expect_launches("mamba decode", ops.launch_counts(), {})
    got = torch.cat(out, dim=1)
    seq = sequential_generate(params, cfg, tokens, gen_len=MAMBA_DECODE + 1,
                              cache_len=s + MAMBA_DECODE + 1)[:, s:]
    ties = []
    for r in range(got.shape[0]):
        diff = (got[r] != seq[r]).nonzero().flatten()
        if not len(diff):
            continue
        i = int(diff[0])
        top = step_logits[i][r].float().topk(2).values
        gap = float(top[0] - top[1])
        if gap >= LOGIT_TOL:
            raise AssertionError(f"mamba decode: row {r} parts from "
                                 f"sequential_generate at token {i} with "
                                 f"top-2 gap {gap:.3e} >= {LOGIT_TOL}")
        ties.append((r, i, gap))
        log(f"main mamba decode: row {r} parts at token {i} at a near-tie "
            f"(top-2 gap {gap:.3e} < {LOGIT_TOL}); equal before it")
    log(f"main mamba decode: {MAMBA_DECODE} greedy steps from the kernel "
        f"prefill's state, {dec_ms:.4f} ms a step (host clock), 0 launches; "
        f"tokens == sequential_generate's (chunked prefill)"
        + (f" up to {len(ties)} near-tie(s)" if ties else " (all equal)"))

    # a train-mode forward through the kernel
    train_toks = tokens[:MAMBA_TRAIN[0], :MAMBA_TRAIN[1]]
    ops.reset_launch_counts()
    tl, _, _ = tf.forward(params, train_toks, cfg, mode="train",
                          use_pallas=True)
    torch.cuda.synchronize(dev)
    train_counts = ops.launch_counts()
    _expect_launches("mamba train forward", train_counts,
                     {"ssd_scan": cfg.n_layers})
    tw, _, _ = tf.forward(params, train_toks, cfg, mode="train")
    terr = _rel_err(tl, tw)
    if not torch.isfinite(tl).all() or terr > MAMBA_TOL:
        raise AssertionError(f"mamba train forward: relative error {terr} "
                             f"> {MAMBA_TOL}")
    log(f"main mamba train forward tokens {list(MAMBA_TRAIN)}: logits "
        f"{tuple(tl.shape)}, relative error {terr:.3e} vs the plain path; "
        f"launches {train_counts}")
    del tl, tw

    # the serving CLI's baseline, in process, without and with the kernel
    rows = {}
    for extra, want_n in (((), 0), (("--use-pallas",), 16 * cfg.n_layers)):
        ops.reset_launch_counts()
        rows[extra] = serve_main(["--arch", MAMBA_ARCH, "--full",
                                  "--baseline", "--requests", "16", *extra])
        _expect_launches(f"serve --baseline {' '.join(extra)}",
                         ops.launch_counts(),
                         {"ssd_scan": want_n} if want_n else {})
        log(f"main mamba serve --full --baseline {' '.join(extra)}: "
            f"{rows[extra]['tokens_per_s']:.2f} tokens/s, "
            f"{rows[extra]['wall_s']:.4f} s; launches {ops.launch_counts()}")
    try:
        ServeEngine(params, cfg)
    except NotImplementedError as e:
        log(f"main mamba engine: refused as the reference's is ({e})")
    else:
        raise AssertionError("mamba: the paged engine accepted mamba2")
    return {"launches": counts, "train_launches": train_counts,
            "errs": errs, "train_err": terr, "ties": ties, "ms": ms,
            "plain_ms": plain_ms, "decode_ms": dec_ms, "serve": rows,
            "cfg": cfg, "params": params, "tokens": tokens}


def phase_mamba_profile(dev, cfg, params, tokens) -> None:
    """The full-width kernel prefill under ``torch.profiler``: device busy
    share, device time by kernel, and the scan's share of device time."""
    import torch
    from repro_torch.models import transformer as tf
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tf.prefill(params, tokens, cfg, use_pallas=True)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dt = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            if dt:
                rows.append((e.key, dt / 1e3, e.count))
    if not rows:
        log("profile mamba: the profiler recorded no device time")
        return
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    ours = [r for r in rows if "ssd_fwd" in r[0]]
    ssd_ms = sum(r[1] for r in ours)
    log(f"profile mamba prefill {cfg.name} tokens {list(tokens.shape)} "
        f"(profiler on): wall {wall_ms:.3f} ms, device kernel time "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.2f}% busy), "
        f"{sum(r[2] for r in rows)} device activities; ssd_scan "
        f"{ssd_ms:.4f} ms ({100 * ssd_ms / busy:.2f}% of device time)")
    for key, ms, count in rows[:12] + [r for r in ours if r not in rows[:12]]:
        log(f"profile mamba device {ms:10.4f} ms {count:6d}x "
            f"{ms / count * 1e3:9.3f} us each  {key[:80]}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "profile_mamba.json").write_text(json.dumps(
        {"wall_ms": wall_ms, "device_ms": busy,
         "device": [{"name": k, "ms": m, "count": c} for k, m, c in rows]},
        indent=1))


def sass_mma_counts(lib: Path) -> dict:
    """``(HMMA, all)`` instructions per kernel in ``lib``'s SASS (HMMA: the
    tensor-core products), by ``cuobjdump -sass`` from the toolkit that
    built it."""
    from repro_torch.kernels import build
    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0]
        elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[fn][1] += 1
            counts[fn][0] += "HMMA" in line
    return {k: tuple(v) for k, v in counts.items()}


def check_flash_on_tensor_cores() -> None:
    """Fail unless every flash kernel instance in the attention library
    issues tensor-core products (and log the count of each)."""
    from repro_torch.kernels import build
    counts = sass_mma_counts(build._library_path("attention"))
    flash = {k: v[0] for k, v in counts.items() if "flash_tc" in k}
    for fn, (n, total) in sorted(counts.items()):
        log(f"build   attention SASS: {n:5d} HMMA of {total:6d} "
            f"instructions in {fn}")
    if not flash or not all(flash.values()):
        raise AssertionError(f"flash kernel without HMMA: {flash}")


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
    libs = build.LIBRARIES
    secs = build.build(*libs)
    for lib in libs:
        log(f"build {lib}: {secs[lib]:.3f} s")
        for line in build._library_path(lib).with_suffix(
                ".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"build   {lib}: {line.strip()}")
    check_flash_on_tensor_cores()

    # 2. kernels against their plain versions, then their times
    worst = phase_kernels(dev)
    att_worst = phase_attention_kernels(dev)
    ssd_worst = phase_ssd_kernels(dev)
    timed = phase_timing(dev)
    att_timed = phase_attention_timing(dev)
    ssd_timed = phase_ssd_timing(dev)
    log(f"allocator after the kernel timings: {_allocator(dev)}")

    # 3. the main path: the quickstart pair, then the compressed runs
    main_out = phase_main(dev)
    comp_out = phase_compressed(dev)

    # 4. where the device time goes
    from repro_torch import api
    phase_profile(dev, "qg", api.presets.get("quickstart_ring16_alpha0.1_qg"))
    phase_profile(dev, "topk", api.presets.get(
        "choco_topk0.01_ring16_qg").override("comm.backend=auto"))

    # 5. slice 7's main path: TinyLlama-1.1B served through the
    # paged-decode kernel, its full-width prefill through the flash kernel,
    # and the serving run under the profiler
    cfg, params, reqs = _serve_setup(dev)
    serve_out = phase_serve(dev, cfg, params, reqs)
    prefill_out = phase_prefill(dev, cfg, params)
    phase_serve_profile(dev, cfg, params, reqs)
    del params
    torch.cuda.empty_cache()

    # 6. slice 6b-i's main path: mamba2-130m prefilled through the SSD scan
    # kernel, decoded from the state it leaves, and profiled
    mamba_out = phase_mamba(dev)
    phase_mamba_profile(dev, mamba_out.pop("cfg"), mamba_out.pop("params"),
                        mamba_out.pop("tokens"))
    torch.cuda.empty_cache()

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
    att_sources = {  # name: (TPU kernel it replaces, main-path launches)
        "flash_attention": ("src/repro/kernels/flash_attention.py:81",
                            prefill_out["launches"]["flash_attention"]),
        "paged_decode_attention": (
            "src/repro/kernels/flash_attention.py:194",
            serve_out["launches"]["paged_decode_attention"])}
    for name, (replaces, launches) in att_sources.items():
        t = att_timed[(name, "main")]
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + "attention.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": att_worst[name]["float32"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    t = ssd_timed["main"]
    kernels.append({
        "name": "ssd_scan", "route": "cuda", "source": csrc + "ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:77",
        "launches": mamba_out["launches"]["ssd_scan"],
        "max_abs_err": ssd_worst["float32"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # any failed phase: report it, print no result line
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
