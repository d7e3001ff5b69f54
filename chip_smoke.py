#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit; run from the root of a
checkout.  Phases, each of which fails the run (non-zero exit, no result
line) if anything goes wrong:

1. build    compile every CUDA kernel from ``csrc/`` (``qg_update``,
            ``compress``, ``attention`` and ``ssd_scan``, one ``nvcc`` each,
            together), and fail unless ``cuobjdump -sass`` finds tensor-core
            products (HMMA) in every flash kernel instance and in every
            instance of the scan's two product passes;
2. kernels  hold each kernel against its plain PyTorch version on the card:
            the streaming kernels over lengths 0-d .. 2**27+5, every flag
            combination and an unaligned view; the row-wise compress kernels
            at the quickstart MLP's four leaf shapes, odd shapes and
            [16, 2**23+5], QSGD at L = 1 and 15 with a zero-scale row and u
            just under 1, alone and as grouped calls (the four leaves, all
            ROW_SHAPES, ResNet-20's 80 leaves in two launches, views
            offset by 1-4 and 20 elements; heads peeled to 128 bytes and to
            16), with the float4 or scalar path of every leaf checked; ``qg_step`` (the dense-gossip step in one
            launch) against ``ref.qg_step`` (tolerance STEP_ULP) and bit
            for bit against the same composition with the mix summed in
            node order, both forms, every flag, 16 and 32 nodes, over the
            quickstart's leaves, a leaf of 1001 columns, views 1-4
            elements in, 49 leaves, two leaves of more tiles than the
            card holds blocks and ResNet-20's 80 leaves, with its launches
            and paths checked;
            ``choco_exchange`` (the exchange half of a compressed round and
            the QG refresh in one launch) likewise against
            ``ref.choco_exchange`` and bit for bit against the node-order
            composition, CHOCO and EF, QG (refresh 0 and 1) and DSGDm, over
            the same trees.  Time kernel and plain
            version (CUDA graphs replayed between CUDA events, so device
            time without host dispatch; eager dispatch timed apart) at the
            main path's sizes and at ~2**27 elements; the row-wise kernels
            at each quickstart leaf, the four-leaf grouped call beside four
            single launches, and [16, 2**23+5] beside [16, 2**23+8], each
            with heads peeled to 128 bytes and to 16; ``qg_step`` at the
            quickstart's tree, at ResNet-20's (80 leaves, two launches)
            and at STEP_LARGE beside ``ref.qg_step`` and
            the sequence it replaces (pack, ``fused_halfstep``, the
            products, pack, ``fused_qg_buffer``), with the device
            activities of each; ``choco_exchange`` at the quickstart's tree
            (three forms) and at EXCHANGE_LARGE beside
            ``ref.choco_exchange`` and the sequence it replaces (the
            replica advance, the products, pack, ``gamma_correct``, pack,
            ``fused_qg_buffer``).  The
            two attention kernels against their plain versions in fp32 and
            bf16 (tolerance ATT_TOL): flash
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
            run (the quickstart pair: one ``qg_step`` launch a step; the
            compressed runs: ``fused_halfstep``, one row-wise launch (a
            message's leaves go in one grouped call) and one
            ``choco_exchange`` a step, ``fused_qg_buffer`` only in the
            warm-start capture); rerun QG with ``fused="off"``, top-k and
            EF through the two-kernel path with a node-order mix hook (bit
            for bit) and with ``comm.backend=jnp``, and QG and top-k on the
            CPU, and hold the histories against each other;
4. profile  the QG and the top-k training loops under ``torch.profiler``:
            device time by kernel, host time by op (every profiled loop
            PROFILE_STEPS deep, the LM's half that);
5. zoo      slice 2: ``social32_alpha0.1_qg`` (32 nodes) and
            ``exp16_alpha0.1_qg`` (a W that changes every step) for 150
            steps with one ``qg_step`` a step, accuracy within ACC_ATOL of
            the JAX package's, history within CPU_RTOL of the port's CPU
            run, each profiled; 8 exp16 steps with every ``qg_step``'s W
            recorded under CUDA sync debugging (the stack's phase t % 4,
            no host sync); the 14 new registry entries on the quickstart
            task against their CPU runs (``qg_step`` 150 for
            ``gt_dsgdm_n`` and ``mt_dsgdm``, no launch for the others; the
            chaotic Adam pair held over its first steps, ZOO_CHAOTIC); the
            paper's comparison on ring16 and social32; ``mt_dsgdm`` and
            ``gut`` under CHOCO top-k with ``comm.backend=auto`` (two
            sites, the predicted launches, MT's ``choco_exchange`` at site
            1, the reference's wire ratio); ``run_gossip`` and
            ``run_qg_consensus`` on ring16, ring32, social32 and exp16
            against the JAX package's histories (CONSENSUS_REF) and the
            port's CPU runs; the zoo's launches on a line of their own;
6. cifar    slices 4 and 5: ``cifar_ring16_alpha0.1_qg`` (ResNet-20 with
            EvoNorm at width 1, 16 nodes) and its DSGDm-N twin for 60
            steps with ``qg_step`` 120 times a run (48 + 32 leaves a step,
            ``head_b`` on the scalar loop) and no other kernel; QG's
            accuracy in the JAX package's seed range widened by ACC_ATOL
            (CIFAR_REF) and above DSGDm-N's; QG against the port's CPU run
            (CIFAR_CPU_RTOL over CIFAR_CPU_STEPS, accuracy within ACC_ATOL;
            the same run with TF32 convs must fail it) and against
            ``fused="off"`` (HIST_RTOL); GN and BN for 20 steps (48 + 13
            leaves); CHOCO top-k with ``comm.backend=auto`` for 20 steps
            with the launches CIFAR_TOPK predicts; telemetry at every 1 and
            10 on the quickstart and the CIFAR runs (histories bit-equal to
            the runs without, launches unchanged, rows on cadence), 8 steps
            under CUDA sync debugging (no host sync); under cuDNN's
            deterministic algorithms, runs interrupted after a checkpoint
            at step 10 of 20 and resumed bit-equal to the whole run (BN,
            whose running statistics are checked local to each node, and
            top-k), and top-k bit-equal to ``comm.backend=jnp`` with a
            node-order mix hook and within CIFAR_TOPK_TOL of the preset's
            ``comm.backend=jnp`` and of the CPU; the loop profiled
            (ms/step, busy share, the convs' share, ``qg_step``); the
            phase's launches on a line of their own;
7. serve    slice 7's main path: ``python -m repro_torch.serve --arch
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
8. mamba    the SSD scan kernels (chunk pass, state pass, output pass)
            against the sequential plain version in fp32 and bf16 at the
            reference's SSD_CASES, S = 1 and 17, chunk 64 vs 256, dt x 1e-2,
            P 48 and the main shape, and at SSD_PATH_CASES (P in several
            column tiles, N padded, unaligned rows), and each pass against
            its plain pass at the path cases and the main shape; timed at the main shape and at [8, 4096], each
            pass apart under the profiler; then slice 6b-i's main path on
            mamba2-130m at its published widths and depth: ``prefill`` of
            [2, 2048] tokens through exactly 24 launches of each scan
            kernel against the plain path (logits, conv and SSM states),
            32 greedy decode steps from the kernel prefill's state (no
            launch) against ``sequential_generate``, a train-mode forward
            of [1, 512] through 24 launches of each, ``python -m
            repro_torch.serve --arch mamba2-130m --full --baseline
            --requests 16`` in code (with and without ``--use-pallas``),
            the engine's refusal, and the
            prefill under ``torch.profiler``;
9. lm       slice 6b-ii's main path on ``lm100m_ring8_alpha0.1_qg`` at its
            published widths (8 nodes x 62,927,616 parameters): the data
            generator's host time; ``qg_step`` at the LM's 12-leaf tree
            (one launch, bit-equal to the node-order composition, within
            STEP_ULP of its plain version, timed beside its bound and the
            sequence it replaces); the preset cut to 2 layers, 3 steps from
            a numpy init, against the JAX package's losses and leaf norms
            (LM_REF); QG-DSGDm-N for 200 steps through ``python -m
            repro_torch.api ... --export-consensus`` and DSGDm-N through
            ``api.run``, one ``qg_step`` a step and no other kernel, QG's
            last 20 losses below ln V and its first; the export bit-equal
            to the node mean of the final state; 20 steps under the
            profiler; the export served through ``python -m
            repro_torch.serve --checkpoint ... --use-pallas --requests 16``
            and held as in phase 7 (a paged launch a layer a decode step),
            and its [2, 512] prefill through a flash launch a layer.
            The attention kernels are also held and timed at the LM's
            12 query over 4 KV heads in phase 2;
10. scenario slice 8a's main path: ``n1024_ring``, ``n1024_powerlaw`` and
            ``n1024_churn`` (1024 nodes, 40 steps) through ``python -m
            repro_torch.api``, each with exactly 40 ``fused_halfstep`` and
            40 ``fused_qg_buffer`` launches and no ``qg_step`` (more than
            64 nodes, and the churn run's masked mix hook), final accuracy
            in the JAX package's seed range widened by ACC_ATOL
            (N1024_ACC) and ordered powerlaw > churn > ring; the churn
            run's alive/mix fractions at all 40 steps equal to the JAX
            package's (N1024_CHURN_FRACS, from ``scripts/n1024_ref.py``);
            ``fused_halfstep`` and ``fused_qg_buffer`` at the presets'
            packed shape against their plain versions (0 ulp) and timed
            beside their bound, and the dense [1024, 1024] mix, the masked
            mix and ``mask_renormalize`` timed; card against the CPU over
            N1024_CPU_STEPS steps; DSGDm-N on ``n1024_churn``; each
            preset's loop under the profiler;
11. lmstack slice 6b-iii's main paths at the published widths: the hold
            against the JAX package (granite at 2 layers, zamba2 at 7 with
            one tail layer, the VLM at one period with its gates at 0.5;
            a [1, 64] prompt's prefill through the kernels and 4 decode
            steps within LMSTACK_REF_RTOL of LMSTACK_REF, from
            ``scripts/lmstack_ref.py``); ``python -m repro_torch.serve
            --arch granite-moe-3b-a800m --full --use-pallas --requests 16``
            in code (32 paged launches a decode step, no merge, tokens equal
            to the plain engine's, a second run token for token, the pairs
            dropped for capacity, and at a capacity factor that drops
            nothing the engine against ``sequential_generate``), its [2,
            1024] prefill through 32 flash launches; zamba2-7b's [1, 4608]
            prefill through 81 launches of each scan kernel and 13 flash
            launches at head_dim 112 (window 4096: the shared block's
            caches ring buffers) against the plain path, 32 decode steps
            against ``sequential_generate``, the serving CLI's baseline
            with and without ``--use-pallas``, the engine's refusal; ``python
            -m repro_torch.launch.serve --arch llama-3.2-vision-11b --full
            --use-pallas --batch 2 --prompt-len 512 --gen-len 16`` in code
            (32 flash launches, tokens equal without the kernel), and its
            prefill with the gates at 0.5, kernel against plain path; the
            LM preset on reduced granite trained 20 steps (one ``qg_step``
            a step) against the port's CPU run.  Flash at head_dim 112 is
            also held (FLASH_CASES) and timed (``zamba2``) in phase 2;
12. runtimes slice 8b's main paths over a one-rank NCCL group (d = 1:
            the sharded/hybrid code, every sparse phase local gathers):
            ``n1024_ring``, ``n1024_powerlaw`` and ``n1024_churn`` with
            ``runtime=hybrid`` through ``api.run(spec, mesh=)``, 40
            ``fused_halfstep`` + 40 ``fused_qg_buffer`` each and no
            ``qg_step``, accuracy in N1024_BAND and ordered, the churn
            fractions equal to N1024_CHURN_FRACS at every step, the
            histories within N1024_CPU_RTOL of vmap runs over their first
            N1024_CPU_STEPS steps, N1024_MESSAGES wire messages a step,
            the hybrid mix
            timed beside the dense one; the quickstart pair with
            ``overlap=delayed_1`` on vmap and hybrid (150 steps, the
            init capture's launch, DELAYED_ACC, card vs CPU, hybrid vs
            vmap, telemetry's ``staleness_gap`` / ``gossip_wait_ms`` with
            the history unchanged, a checkpoint cut at 10 of 20 and resumed
            bit-equal with ``mix_buf``); exp16 on hybrid with no host sync
            (CUDA sync debugging 'error'); CHOCO top-k on hybrid
            (``comm.backend=auto``); each loop profiled;
13. launch  slice 9's main path: ``launch/steps.build_train_step`` on
            TinyLlama-1.1B at its published size (fp32, 2 nodes of a ring,
            [1, 1024] a node, remat 'full') for 3 steps from a seeded init,
            with exactly one ``qg_step`` launch a plan slice a step and no
            ``fused_halfstep`` / ``fused_qg_buffer``; ms/step, peak memory
            and the ratio to the roofline bound of the same StepConfig
            (``launch/roofline.py`` under ``H100``); the dry run's per-rank
            bytes equal to the card's tensors' and its ``meta`` flop count
            equal to the card's plus the kernel's mix; step 1 against the
            unfused chain (HIST_RTOL / HIST_ATOL, leaf by leaf); remat
            'none' bit-equal with its peak; a bf16 step with no launch (the
            dtype rule); the prefill and decode builders at [1, 2048] and 8
            tokens against the direct model calls;
14. shard   slice 10's main path: the same step through
            ``build_train_step(sc, mesh=)`` on a ('data', 'model') mesh of
            (1, 1) over a one-rank NCCL group, every weight and m_hat
            stored as the rank's block and gathered on use
            (``sharding.Placement``), 3 steps bit-equal to phase 13's
            (losses and the final state), one ``qg_step`` a step, ms/step
            beside the bound of the same layout's ``meta`` trace, whose
            per-rank argument equals the card's bytes; ``remat_attention``
            step 1 bit-equal, its peak and a warm step's time; zamba2-7b
            fp32 at published widths, ``build_prefill_step`` at [1,
            SHARD_PREFILL] with ``skip_masked_chunks`` off and on (no
            kernel), logits within SHARD_LOGIT_RTOL of max |logit|,
            argmax equal.  Slice 11's main path, the compute split over
            'model' (``sharding.Split``): the same TinyLlama step with
            ``megatron_attn``, ``shard_activations`` and
            ``pin_moe_dispatch`` on the (1, 1) mesh (each collective of
            one rank), 3 steps bit-equal to ``mesh=None`` with the same
            knobs, one ``qg_step`` a step, its warm ms/step beside
            ``mesh=None``'s and the gather-on-use step's and its step-1
            peak; granite-moe-3b fp32 at published widths,
            ``build_prefill_step`` at [1, SPLIT_MOE_PREFILL] with the heads
            and the experts split, logits within SHARD_LOGIT_RTOL of
            ``mesh=None``'s max |logit|, argmax and routes equal.

Imports nothing of JAX nor of the JAX package.  The second-to-last lines
are the card's name and power limit and a JSON ``kernels`` line; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import json
import math
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

#: the compressed runs through the kernels (``comm.backend=auto``) against
#: the same runs with ``comm.backend=jnp``, (steps, rtol): the kernel path
#: sums the mix of the anchors in node order, the jnp path by cuBLAS.  Top-k
#: moves an entry across the k-th magnitude on such a rounding difference,
#: as it does between the card and the CPU (3.291e-03 measured on an H100):
#: CPU_TOPK_RTOL over the run.  Sign+norm flips a sign on one, and the EF
#: run is chaotic (a 1e-7 change of the init leaves the reference's own
#: history within rounding for 12 steps only, tests/test_torch_slice.py;
#: 3.402 relative by step 31 here): HIST_RTOL over its first 12 steps.  The
#: same runs with the jnp path's mix summed in node order are held bit for
#: bit over all 150.
JNP_RTOL = {"topk": (150, CPU_TOPK_RTOL), "ef_signnorm": (12, HIST_RTOL)}

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
#: leaves held as views into a larger buffer: rows that begin off a line,
#: odd widths, a row shorter than its head
VIEW_SHAPES = [(3, 517), (16, 1280), (5, 8193), (4, 2)]
#: [16, 2**23+8], every row aligned, beside ROW_SHAPES[-1]: the peel's cost
ALIGNED_LARGE = (16, 2 ** 23 + 8)
#: the largest u below 1 in fp32: floor(y + u) must still stop at L
U_MAX = 1.0 - 2.0 ** -24

#: qg_step against ref.qg_step, whose mix is the library's product (summed
#: in another order than the kernel's node order, with FMAs): x_new within
#: STEP_ULP ulp, the ulp taken at sum_k |W[i,k]| |half[k,j]| (the scale of a
#: dot product's rounding; x_new's own ulp where the terms share a sign);
#: DSGDm's m_new bit-equal (no mix in it); QG's m_hat within (1-mu)/eta
#: times that x bound (the refresh's factor on an error of x_new) plus 2 ulp
#: at mu|m_hat| + (1-mu)|d|, d = (x - x_new)/eta (its own roundings of a
#: different d, at the scale of its terms as for x).  Against the same
#: composition with the mix summed in node order (_node_order_step) every
#: output is bit-equal.
STEP_ULP = 4
#: node counts of the qg_step checks: the presets' 16 and the reference's
#: social32 preset's 32
STEP_NODES = (16, 32)
#: qg_step's one-leaf timing shapes: odd rows (the scalar loop) at 16 and
#: 32 nodes, and rows on 16 bytes (float4) beside them
STEP_LARGE = [(16, 2 ** 23 + 5), (32, 2 ** 22 + 5), (16, 2 ** 23 + 8)]

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
    worst["qg_step"] = _qg_step_checks(dev, gen)
    worst["choco_exchange"] = _exchange_checks(dev, gen)
    return worst


# ---------------------------------------------------------------------------
# qg_step: the dense-gossip step in one launch
# ---------------------------------------------------------------------------

def _step_mixing(n, dev):
    """A ring's mixing matrix (the presets' topology) at ``n`` nodes."""
    import torch
    from repro_torch.core import topology
    return torch.as_tensor(topology.ring(n).mixing[0],
                           dtype=torch.float32).to(dev)


def _node_order(w, x):
    """``W @ x`` along the nodes of ``x`` [n, ...], summed as the kernels
    sum it: in node order k = 0..n-1, one rounded product and one rounded
    sum a term."""
    h = x.reshape(x.shape[0], -1)
    acc = w[:, :1] * h[:1]
    for k in range(1, h.shape[0]):
        acc = acc + w[:, k:k + 1] * h[k:k + 1]
    return acc.reshape(x.shape)


def _node_order_mix(w, tree):
    """A mix hook (``mix_impl``) that mixes every leaf by ``_node_order``."""
    from repro_torch.tree import tree_map
    return tree_map(lambda x: _node_order(w, x), tree)


def _node_order_step(xs, ms, gs, w, eta, refresh, *, beta, wd, nesterov,
                     mu):
    """``ref.qg_step`` with the mix summed as the kernel sums it
    (``_node_order``)."""
    from repro_torch.kernels import ref
    x_new, m_out = [], []
    for x, m, g in zip(xs, ms, gs):
        half, mn = ref.fused_halfstep(x, m, g, eta, beta=beta, wd=wd,
                                      nesterov=nesterov)
        xn = _node_order(w, half)
        x_new.append(xn)
        m_out.append(mn if mu is None else
                     ref.fused_qg_buffer(x, xn, m, eta, refresh, mu=mu))
    return x_new, m_out


def _ulp_at(v):
    """The fp32 spacing at |v|, elementwise."""
    import torch
    a = v.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def _step_trees(n, gen, dev, roles: int = 3):
    """(label, *role lists, (launches, vector, scalar)) of the qg_step
    (``roles`` 3: xs, ms, gs) and choco_exchange checks at ``n`` nodes,
    with the launches and the leaves on each path they must take: the
    quickstart MLP's four leaves and a leaf of 1001 columns (scalar loop);
    leaves viewed 1, 2, 3 and 4 elements into larger buffers; 49 leaves
    (two launches); a leaf of 70001 columns and one of 65540, 2119 tiles
    (each block takes several); ResNet-20's 80 leaves (EvoNorm, the CIFAR
    preset's tree: two launches, ``head_b`` on the scalar loop)."""
    import torch

    def draw(shape):
        return [torch.randn(shape, generator=gen, device=dev)
                for _ in range(roles)]

    qs = [draw((n, f)) for _, f in LEAF_SHAPES] + [draw((n, 1001))]
    yield ("quickstart + f=1001", *map(list, zip(*qs)), (1, 4, 1))
    views = []
    for off, f in zip((1, 2, 3, 4), (517, 64, 1280, 20)):
        bufs = draw(n * f + off)
        views.append([b[off:].view(n, f) for b in bufs])
    yield ("views 1-4 elements in", *map(list, zip(*views)), (1, 1, 3))
    widths = [4 * (1 + i % 7) + (i % 3 == 0) for i in range(49)]
    many = [draw((n, f)) for f in widths]
    vec = sum(f % 4 == 0 for f in widths)
    yield ("49 leaves", *map(list, zip(*many)), (2, vec, 49 - vec))
    big = [draw((n, 70001)), draw((n, 65540))]
    yield ("2119 tiles", *map(list, zip(*big)), (1, 1, 1))
    del big
    resnet = [draw(shape) for shape in _resnet20_shapes(n=n)]
    yield ("ResNet-20", *map(list, zip(*resnet)), (2, 79, 1))


def _qg_step_checks(dev, gen) -> dict:
    """``qg_step`` against ``ref.qg_step`` (tolerance STEP_ULP, above) and
    bit for bit against ``_node_order_step``: both forms, wd 0 and 1e-4,
    Nesterov on and off, refresh 0 and 1, at STEP_NODES nodes over
    ``_step_trees``; each tree's launches and float4/scalar leaves
    checked.  Returns the worst errors."""
    import torch
    from repro_torch.kernels import qg_update as K
    from repro_torch.kernels import ref

    eta = _full(0.1, torch.empty(0, device=dev))
    worst = {"ulp": 0.0, "abs": 0.0, "m_abs": 0.0, "cases": 0}
    for n in STEP_NODES:
        w = _step_mixing(n, dev)
        for label, xs, ms, gs, want in _step_trees(n, gen, dev):
            for mu, rf in ((None, 1.0), (0.9, 0.0), (0.9, 1.0)):
                for wd in (0.0, 1e-4):
                    for nest in (False, True):
                        case = (f"n={n} {label} mu={mu} refresh={rf} wd={wd} "
                                f"nesterov={nest}")
                        kw = dict(beta=0.9, wd=wd, nesterov=nest, mu=mu)
                        refresh = _full(rf, eta)
                        before = (K.LAUNCHES["qg_step"],
                                  *K.STEP_PATHS.values())
                        got = K.qg_step(xs, ms, gs, w, eta, refresh, **kw)
                        after = (K.LAUNCHES["qg_step"],
                                 *K.STEP_PATHS.values())
                        ran = tuple(a - b for a, b in zip(after, before))
                        if ran != want:
                            raise AssertionError(
                                f"qg_step {case}: (launches, vector, "
                                f"scalar) {ran}, want {want}")
                        _step_compare(case, got, ref.qg_step(
                            xs, ms, gs, w, eta, refresh, **kw),
                            _node_order_step(xs, ms, gs, w, eta, refresh,
                                             **kw),
                            (xs, ms, gs, w, eta, kw), worst)
    torch.cuda.synchronize(dev)
    log(f"kernel qg_step: {worst['cases']} leaves x 2 outputs bit-equal to "
        f"the node-order composition; against ref.qg_step x_new within "
        f"{worst['ulp']:.2f} ulp at sum|W||half| (allowed {STEP_ULP}), max "
        f"abs err {worst['abs']:.3e}, m_out max abs err "
        f"{worst['m_abs']:.3e}")
    return worst


def _step_compare(case, got, plain, node_order, inputs, worst) -> None:
    import torch
    from repro_torch.kernels import ref
    xs, ms, gs, w, eta, kw = inputs
    mu = kw["mu"]
    for i, (gx, gm, px, pm, nx, nm) in enumerate(zip(*got, *plain,
                                                    *node_order)):
        what = f"qg_step {case} leaf {i}"
        for g, p in ((gx, px), (gm, pm)):
            if g.shape != p.shape or not torch.isfinite(g).all():
                raise AssertionError(f"{what}: shape {tuple(g.shape)} vs "
                                     f"{tuple(p.shape)} or non-finite")
        for name, g, p in (("x_new", gx, nx), ("m_out", gm, nm)):
            ulp = _ulp_diff(g, p)
            if ulp:
                raise AssertionError(f"{what}: {name} differs from the "
                                     f"node-order composition by {ulp} ulp")
        half, _ = ref.fused_halfstep(xs[i], ms[i], gs[i], eta, beta=0.9,
                                     wd=kw["wd"], nesterov=kw["nesterov"])
        n = half.shape[0]
        scale = (w.abs() @ half.reshape(n, -1).abs()).reshape(half.shape)
        x_tol = STEP_ULP * _ulp_at(scale)
        dx = (gx - px).abs()
        if (dx > x_tol).any():
            raise AssertionError(f"{what}: x_new off the plain version by "
                                 f"{float((dx / x_tol).max()) * STEP_ULP:.2f}"
                                 f" ulp at sum|W||half| (allowed {STEP_ULP})")
        dm = (gm - pm).abs()
        m_tol = torch.zeros_like(dm)
        if mu is not None:
            terms = mu * ms[i].abs() + (1.0 - mu) * (xs[i] - px).abs() / eta
            m_tol = (1.0 - mu) / eta * x_tol + 2 * _ulp_at(terms)
        if (dm > m_tol).any():
            raise AssertionError(f"{what}: m_out off the plain version by "
                                 f"{float(dm.max()):.3e} (allowed "
                                 f"{'0' if mu is None else 'the x bound'})")
        if gx.numel():
            worst["ulp"] = max(worst["ulp"],
                               float((dx / x_tol).max()) * STEP_ULP)
            worst["abs"] = max(worst["abs"], float(dx.max()))
            worst["m_abs"] = max(worst["m_abs"], float(dm.max()))
        worst["cases"] += 1


# ---------------------------------------------------------------------------
# choco_exchange: the exchange half of a compressed round in one launch
# ---------------------------------------------------------------------------

#: choco_exchange's forms, (label, CHOCO, mu, refresh, gamma): CHOCO (top-k's
#: resolved gamma) and EF (sign+norm's), each QG with the refresh gate on
#: and off, and DSGDm
EXCHANGE_FORMS = [
    (f"{mode} {form}", mode == "choco", mu, rf, gamma)
    for mode, gamma in (("choco", 0.02002), ("ef", 0.3))
    for form, mu, rf in (("qg refresh=1", 0.9, 1.0),
                         ("qg refresh=0", 0.9, 0.0), ("dsgdm", None, 1.0))]
#: choco_exchange's one-leaf timing shapes: odd rows (the scalar loop) and
#: rows on 16 bytes (float4), CHOCO/QG form
EXCHANGE_LARGE = [(16, 2 ** 23 + 5), (16, 2 ** 23 + 8)]


def _exchange_args(roles, w, eta, choco, mu, rf, gamma):
    """choco_exchange's operands from the role lists (half, q, x_hat,
    x_pre, m_hat) in one form."""
    half, q, x_hat, x_pre, m_hat = roles
    kw = dict(gamma=gamma, x_hats=x_hat if choco else None)
    if mu is not None:
        kw.update(x_pres=x_pre, m_hats=m_hat, eta=eta,
                  refresh=_full(rf, eta), mu=mu)
    return (half, q, w), kw


def _node_order_exchange(halves, qs, w, *, gamma, x_hats=None, x_pres=None,
                         m_hats=None, eta=None, refresh=None, mu=None):
    """``ref.choco_exchange`` with the mix summed as the kernel sums it
    (``_node_order``)."""
    from repro_torch.kernels import ref
    x_out, anchors, m_out = [], [], []
    for i, (half, q) in enumerate(zip(halves, qs)):
        a = q if x_hats is None else x_hats[i] + q
        xo = ref.gamma_correct(half, _node_order(w, a), a, gamma=gamma)
        x_out.append(xo)
        anchors.append(a)
        if mu is not None:
            m_out.append(ref.fused_qg_buffer(x_pres[i], xo, m_hats[i], eta,
                                             refresh, mu=mu))
    return (x_out, None if x_hats is None else anchors,
            None if mu is None else m_out)


def _exchange_checks(dev, gen) -> dict:
    """``choco_exchange`` against ``ref.choco_exchange`` and bit for bit
    against ``_node_order_exchange`` in every EXCHANGE_FORMS form at
    STEP_NODES nodes over ``_step_trees``, each tree's launches and
    float4/scalar leaves checked.  Against the plain version: the new
    replicas bit-equal (no mix in them); x_out within gamma times the mix's
    bound, STEP_ULP ulp at sum_k |W[i,k]| |a[k,j]|, plus 4 ulp at |half| +
    gamma |mixed - a| (the correction's roundings: mixed - a, the product
    with gamma, the sum with half, each of which may round a different
    operand the other way); m_out as in ``_step_compare``.  Returns the
    worst errors."""
    import torch
    from repro_torch.kernels import compress as C
    from repro_torch.kernels import ref

    eta = _full(0.1, torch.empty(0, device=dev))
    worst = {"ulp": 0.0, "abs": 0.0, "m_abs": 0.0, "cases": 0}
    for n in STEP_NODES:
        w = _step_mixing(n, dev)
        for label, *roles, want in _step_trees(n, gen, dev, roles=5):
            for form, choco, mu, rf, gamma in EXCHANGE_FORMS:
                case = f"n={n} {label} {form}"
                args, kw = _exchange_args(roles, w, eta, choco, mu, rf, gamma)
                before = (C.LAUNCHES["choco_exchange"],
                          *C.EXCHANGE_PATHS.values())
                got = C.choco_exchange(*args, **kw)
                ran = tuple(a - b for a, b in zip(
                    (C.LAUNCHES["choco_exchange"],
                     *C.EXCHANGE_PATHS.values()), before))
                if ran != want:
                    raise AssertionError(f"choco_exchange {case}: (launches, "
                                         f"vector, scalar) {ran}, want "
                                         f"{want}")
                _exchange_compare(case, got, ref.choco_exchange(*args, **kw),
                                  _node_order_exchange(*args, **kw),
                                  (roles[0], roles[1], roles[3], roles[4], w,
                                   eta, kw),
                                  worst)
    torch.cuda.synchronize(dev)
    log(f"kernel choco_exchange: {worst['cases']} leaves x (x_out, x_hat', "
        f"m_hat' as the form has them) bit-equal to the node-order "
        f"composition; against ref.choco_exchange x_hat' bit-equal, x_out "
        f"within {worst['ulp']:.2f} of {STEP_ULP} (the bound's share, in "
        f"ulp at sum|W||a|), max abs err {worst['abs']:.3e}, m_out max abs "
        f"err {worst['m_abs']:.3e}")
    return worst


def _exchange_compare(case, got, plain, node_order, inputs, worst) -> None:
    import torch
    halves, qs, x_pres, m_hats, w, eta, kw = inputs
    gamma, mu = kw["gamma"], kw.get("mu")
    for role, g, p, o in zip(("x_out", "x_hat'", "m_hat'"), got, plain,
                             node_order):
        if (g is None) != (p is None) or (g is None) != (o is None):
            raise AssertionError(f"choco_exchange {case}: {role} given by "
                                 f"{[v is not None for v in (g, p, o)]}")
        for i, (gl, pl, ol) in enumerate(zip(g or [], p or [], o or [])):
            what = f"choco_exchange {case} leaf {i} {role}"
            if gl.shape != pl.shape or not torch.isfinite(gl).all():
                raise AssertionError(f"{what}: shape {tuple(gl.shape)} vs "
                                     f"{tuple(pl.shape)} or non-finite")
            ulp = _ulp_diff(gl, ol)
            if ulp:
                raise AssertionError(f"{what}: differs from the node-order "
                                     f"composition by {ulp} ulp")
    x_tols = []
    for i, (gx, px) in enumerate(zip(got[0], plain[0])):
        what = f"choco_exchange {case} leaf {i}"
        if got[1] is not None and _ulp_diff(got[1][i], plain[1][i]):
            raise AssertionError(f"{what}: x_hat' differs from the plain "
                                 "version")
        a = plain[1][i] if plain[1] is not None else qs[i]
        n = a.shape[0]
        flat = a.reshape(n, -1)
        scale = (w.abs() @ flat.abs()).reshape(a.shape)
        mixed = (w @ flat).reshape(a.shape)
        x_tol = (gamma * STEP_ULP * _ulp_at(scale)
                 + 4 * _ulp_at(halves[i].abs() + gamma * (mixed - a).abs()))
        dx = (gx - px).abs()
        if (dx > x_tol).any():
            raise AssertionError(f"{what}: x_out off the plain version by "
                                 f"{float((dx / x_tol).max()) * STEP_ULP:.2f}"
                                 f" (allowed {STEP_ULP})")
        if gx.numel():
            worst["ulp"] = max(worst["ulp"],
                               float((dx / x_tol).max()) * STEP_ULP)
            worst["abs"] = max(worst["abs"], float(dx.max()))
        x_tols.append(x_tol)
        worst["cases"] += 1
    if mu is None:
        return
    for i, (gm, pm) in enumerate(zip(got[2], plain[2])):
        terms = (mu * m_hats[i].abs()
                 + (1.0 - mu) * (x_pres[i] - plain[0][i]).abs() / eta)
        m_tol = (1.0 - mu) / eta * x_tols[i] + 2 * _ulp_at(terms)
        dm = (gm - pm).abs()
        if (dm > m_tol).any():
            raise AssertionError(f"choco_exchange {case} leaf {i}: m_hat' "
                                 f"off the plain version by "
                                 f"{float(dm.max()):.3e} (allowed the x "
                                 "bound carried through the refresh)")
        if gm.numel():
            worst["m_abs"] = max(worst["m_abs"], float(dm.max()))


def _topk_threshold(x2d):
    """The k-th largest magnitude per row, as the top-1% compressor of the
    main path computes it for ``threshold_mask``."""
    from repro_torch.comm import TopK
    return TopK(frac=0.01)._threshold(x2d)


def _rowwise_inputs(shape, gen, dev, offset=0):
    """x, u (u just under 1 in every third column), thr (top-1%) and scale
    of one row-wise leaf; x and u views ``offset`` elements into larger
    buffers, where given; the last row of x zero where rows > 1 (a
    zero-scale row)."""
    import torch
    n = shape[0] * shape[1]
    x = torch.randn(n + offset, generator=gen, device=dev)[offset:]
    u = torch.rand(n + offset, generator=gen, device=dev)[offset:]
    x, u = x.view(shape), u.view(shape)
    u[:, ::3] = U_MAX
    if shape[0] > 1:
        x[-1] = 0.0
    return x, u, _topk_threshold(x), x.abs().amax(dim=1)


def _expect_paths(what, before, vector, scalar) -> None:
    """The row-wise kernels ran ``vector`` leaves on their float4 path and
    ``scalar`` on their scalar loop since ``before``."""
    from repro_torch.kernels import compress as C
    got = {k: C.ROW_PATHS[k] - before[k] for k in before}
    if got != {"vector": vector, "scalar": scalar}:
        raise AssertionError(f"{what}: leaves by path {got}, want "
                             f"vector {vector}, scalar {scalar}")


def _rowwise_checks(dev, gen, worst) -> None:
    """``threshold_mask`` and ``quantize_dequantize`` against their plain
    versions at every row shape, QSGD at L = 1 and 15 with a zero-scale row
    and u just under 1 in every third column; then the grouped calls
    against the plain groups over the quickstart's four leaves and over
    ROW_SHAPES, and with views 4 and 20 elements into a buffer (16-byte
    aligned, off a 128-byte line: the float4 path with a peeled head) and
    1-3 elements (the scalar loop: the outputs are fresh, so aligned).
    The groups run with heads peeled to 128 bytes and to 16.  Every leaf's
    path is checked: every row of an aligned leaf, odd widths too, runs on
    float4."""
    import torch
    from repro_torch.kernels import compress as C
    from repro_torch.kernels import ref

    def check(label, xs, us, thrs, scales, vector, scalar, peel=C.PEELS[0],
              launches=None):
        label = f"{label}, peel {peel}"
        before = dict(C.ROW_PATHS)
        calls = {k: C.LAUNCHES[k]
                 for k in ("threshold_mask", "quantize_dequantize")}
        _compare_groups("threshold_mask", label,
                        C.threshold_mask_group(xs, thrs, peel=peel),
                        ref.threshold_mask_group(xs, thrs), worst)
        for levels in (1, 15):
            got = C.quantize_dequantize_group(xs, scales, us, levels=levels,
                                              peel=peel)
            _compare_groups(
                "quantize_dequantize", f"L={levels} {label}", got,
                ref.quantize_dequantize_group(xs, scales, us, levels=levels),
                worst)
            for x, (q, _) in zip(xs, got):
                if x.shape[0] > 1 and bool(q[-1].any()):
                    raise AssertionError("quantize_dequantize: a zero-scale "
                                         f"row did not quantize to zero "
                                         f"({label})")
        _expect_paths(label, before, 3 * vector, 3 * scalar)
        ran = {k: C.LAUNCHES[k] - v for k, v in calls.items()}
        if launches is not None and ran != {"threshold_mask": launches,
                                            "quantize_dequantize":
                                                2 * launches}:
            raise AssertionError(f"{label}: launches {ran}, want "
                                 f"{launches} a call")

    for shape in ROW_SHAPES:  # one leaf a call
        x, u, thr, scale = _rowwise_inputs(shape, gen, dev)
        check(f"shape={shape}", [x], [u], [thr], [scale], 1, 0)
        del x, u, thr, scale
    for peel in C.PEELS:
        for label, shapes in (("quickstart group", LEAF_SHAPES),
                              ("ROW_SHAPES group", ROW_SHAPES)):
            cols = list(zip(*(_rowwise_inputs(s, gen, dev) for s in shapes)))
            check(label, *cols, len(shapes), 0, peel)
            del cols
        # the CHOCO top-k ResNet-20 run's message: 80 leaves, each [16, -1],
        # in two launches (compress.group_plan)
        cols = list(zip(*(_rowwise_inputs((s[0], math.prod(s[1:])), gen, dev)
                          for s in _resnet20_shapes())))
        check("ResNet-20 group (80 leaves)", *cols, 80, 0, peel, launches=2)
        del cols
        for offset in (4, 20):  # unaligned views in a group, on float4
            leaves = [_rowwise_inputs(s, gen, dev) for s in LEAF_SHAPES]
            views = [_rowwise_inputs(s, gen, dev, offset)
                     for s in VIEW_SHAPES]
            for x, *_ in views:  # each starts off a 128-byte line
                if C.row_split(x.data_ptr(), x.shape[1])[0] == 0:
                    raise AssertionError(f"a view at offset {offset} starts "
                                         "on a 128-byte line")
            check(f"group with views at offset {offset} (float4, peeled "
                  "head)", *zip(*(leaves + views)),
                  len(LEAF_SHAPES) + len(VIEW_SHAPES), 0, peel)
            del leaves, views
    for offset in (1, 2, 3):
        leaves = [_rowwise_inputs(s, gen, dev, offset) for s in VIEW_SHAPES]
        check(f"views at offset {offset} (scalar loop)", *zip(*leaves), 0,
              len(VIEW_SHAPES))
        del leaves
    torch.cuda.empty_cache()


def _compare_groups(name, case, got, want, worst) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{name} {case}: {len(got)} leaves out, plain "
                             f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        _compare(name, f"{case} leaf {i}", g, w, worst)


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


def _time_rowwise(timed, key, xs, us, thrs, scales, iters) -> None:
    """Kernel, plain and bound ms of both row-wise kernels over the leaves
    ``xs`` in one (grouped) call, QSGD at L = 15, into ``timed``."""
    from repro_torch.kernels import compress as C
    from repro_torch.kernels import ref

    n = sum(x.numel() for x in xs)
    rows = sum(x.shape[0] for x in xs)
    timed[("threshold_mask", key)] = _time_row(
        "threshold_mask", key, lambda: C.threshold_mask_group(xs, thrs),
        lambda: ref.threshold_mask_group(xs, thrs), 12 * n + 4 * rows, n,
        iters)
    timed[("quantize_dequantize", key)] = _time_row(
        "quantize_dequantize", key,
        lambda: C.quantize_dequantize_group(xs, scales, us, levels=15),
        lambda: ref.quantize_dequantize_group(xs, scales, us, levels=15),
        16 * n + 4 * rows, n, iters)


def phase_timing(dev) -> dict:
    """Kernel, plain and bound ms of each kernel at the main path's size
    (the quickstart's packed length; for the row-wise kernels each of the
    MLP's four leaves and the four as one grouped call) and at about 2**27
    elements, in the configuration the main path uses."""
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
    # the row-wise kernels: each quickstart leaf alone; the four as one
    # grouped call (the main path's message) beside four single launches;
    # [16, 2**23+5] (rows peeled) beside [16, 2**23+8] (rows 32 bytes
    # apart), each with heads peeled to 128 bytes (the wrapper's) and to 16
    gen = torch.Generator(device=dev).manual_seed(2)
    leaves = [_rowwise_inputs(s, gen, dev) for s in LEAF_SHAPES]
    for shape, leaf in zip(LEAF_SHAPES, leaves):
        _time_rowwise(timed, shape, *([t] for t in leaf), 20)
    xs, us, thrs, scales = (list(c) for c in zip(*leaves))
    _time_rowwise(timed, "group", xs, us, thrs, scales, 20)
    singles = {
        "threshold_mask": lambda: [C.threshold_mask(x, t)
                                   for x, t in zip(xs, thrs)],
        "quantize_dequantize": lambda: [
            C.quantize_dequantize(x, s, u, levels=15)
            for x, s, u in zip(xs, scales, us)]}
    for name, fn in singles.items():
        row = timed[(name, "group")]
        row["singles_sum_ms"] = sum(timed[(name, s)]["ms"]
                                    for s in LEAF_SHAPES)
        row["singles_seq_ms"] = _time_ms(fn, 20)
        log(f"time {name} quickstart message: one grouped launch "
            f"{row['ms']:.6f} ms; the four leaves alone sum to "
            f"{row['singles_sum_ms']:.6f} ms, four single launches in a row "
            f"{row['singles_seq_ms']:.6f} ms (CUDA graph of 20); bound "
            f"{row['bound_ms']:.6f} ms")
    del leaves, xs, us, thrs, scales
    for shape in (ROW_SHAPES[-1], ALIGNED_LARGE):
        x, u, thr, scale = _rowwise_inputs(shape, gen, dev)
        _time_rowwise(timed, shape, [x], [u], [thr], [scale], 4)
        timed[("threshold_mask", shape)]["peel16_ms"] = _time_ms(
            lambda: C.threshold_mask_group([x], [thr], peel=16), 4)
        timed[("quantize_dequantize", shape)]["peel16_ms"] = _time_ms(
            lambda: C.quantize_dequantize_group([x], [scale], [u], levels=15,
                                                peel=16), 4)
        del x, u, thr, scale
        torch.cuda.empty_cache()
    for name in ("threshold_mask", "quantize_dequantize"):
        for shape in (ROW_SHAPES[-1], ALIGNED_LARGE):
            t = timed[(name, shape)]
            log(f"time {name} peel {shape}: to 128 bytes {t['ms']:.6f} ms "
                f"({t['ms'] / t['bound_ms']:.3f}x bound), to 16 bytes "
                f"{t['peel16_ms']:.6f} ms "
                f"({t['peel16_ms'] / t['bound_ms']:.3f}x bound)")
    _time_step(dev, timed)
    _time_exchange(dev, timed)
    return timed


def _device_activities(dev, fn, reps: int = 10) -> float:
    """Device activities (kernels, copies, fills) per eager call of ``fn``,
    counted by ``torch.profiler`` over ``reps`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps


def _replaced_sequence(stages, x, m, g, w, eta):
    """The segment ``qg_step`` replaces, as the chain ran it before: pack
    x, m, g, ``fused_halfstep``, ``mix_dense`` (one product a leaf), pack
    x, x_new, m_hat, ``fused_qg_buffer`` (QG form)."""
    import torch
    from repro_torch.core import gossip
    from repro_torch.core import transforms as T

    wd, hb = stages[0].meta["wd"], stages[1]
    qg = stages[3] if len(stages) > 3 else None
    ctx = T.StepCtx(w=w, lr=eta, t=torch.zeros((), dtype=torch.int32,
                                                device=eta.device),
                    mix_fn=gossip.mix_dense)
    sv = T.StepVars(grads=g, update=g, params=x, params_pre_mix=x)
    states = {qg.name: {"m_hat": m}} if qg else {hb.name: {"m": m}}

    def run():
        sv2, st2 = T._apply_fused_halfstep(ctx, sv, states, wd, hb, m)
        if qg is not None:
            T._apply_fused_qg_buffer(ctx, sv2, st2, qg)
    return run


def _time_step(dev, timed) -> None:
    """``qg_step`` beside ``ref.qg_step``, the sequence it replaces (one
    CUDA graph each) and its bound (5 streams over the memory rate), QG
    (QG-DSGDm-N) and DSGDm (DSGDm-N) forms, wd 1e-4, at the quickstart's
    tree, at ResNet-20's (80 leaves, two launches; its outputs held as
    ``_step_compare`` holds them) and at STEP_LARGE; the device activities
    of one eager call of each at the quickstart's tree."""
    import torch
    from repro_torch.core import optim
    from repro_torch.kernels import qg_update as K
    from repro_torch.kernels import ref

    eta = _full(0.1, torch.empty(0, device=dev))
    one = _full(1.0, eta)
    gen = torch.Generator(device=dev).manual_seed(3)
    stages = {"qg": optim.make_optimizer("qg_dsgdm_n",
                                         weight_decay=1e-4)._stages(),
              "dsgdm": optim.make_optimizer("dsgdm_n",
                                            weight_decay=1e-4)._stages()}
    trees = [("quickstart", LEAF_SHAPES, 20),
             ("resnet20", _resnet20_shapes(), 20)] + [
        (shape, [shape], 4) for shape in STEP_LARGE]
    for key, shapes, iters in trees:
        n = shapes[0][0]
        w = _step_mixing(n, dev)
        roles = [{f"l{i}": torch.randn(s, generator=gen, device=dev)
                  for i, s in enumerate(shapes)} for _ in range(3)]
        x, m, g = roles
        xs, ms, gs = (list(r.values()) for r in roles)
        elems = sum(t.numel() for t in xs)
        for form, mu in (("qg", 0.9), ("dsgdm", None)):
            kw = dict(beta=0.9, wd=1e-4, nesterov=True, mu=mu)
            kfn = lambda: K.qg_step(xs, ms, gs, w, eta, one, **kw)
            pfn = lambda: ref.qg_step(xs, ms, gs, w, eta, one, **kw)
            if key == "resnet20":  # the timed call's outputs, held too
                worst = {"ulp": 0.0, "abs": 0.0, "m_abs": 0.0, "cases": 0}
                _step_compare(f"timed {form} at ResNet-20's tree", kfn(),
                              pfn(), _node_order_step(xs, ms, gs, w, eta,
                                                      one, **kw),
                              (xs, ms, gs, w, eta, kw), worst)
                log(f"qg_step {form} at ResNet-20's tree: {worst['cases']} "
                    f"leaves bit-equal to the node-order composition, x_new "
                    f"within {worst['ulp']:.2f} ulp of ref.qg_step (allowed "
                    f"{STEP_ULP}), max abs err {worst['abs']:.3e}")
            seq = _replaced_sequence(stages[form], x, m, g, w, eta)
            kms, pms = _time_ms(kfn, iters), _time_ms(pfn, iters)
            sms = _time_ms(seq, iters)
            # x, m, g in; x_new and m_out out; W and the scalars once
            nbytes = 5 * elems * 4 + 4 * n * n + 8
            flops = (8 + 2 * n - 1 + (5 if mu else 0)) * elems
            bound, by = _bound(nbytes, flops)
            row = {"size": key, "ms": kms, "plain_ms": pms,
                   "replaced_ms": sms, "bound_ms": bound, "bound_by": by,
                   "bytes": nbytes, "dispatch_ms": _dispatch_ms(kfn)}
            if key == "quickstart":
                row["activities"] = _device_activities(dev, kfn)
                row["replaced_activities"] = _device_activities(dev, seq)
                row["replaced_dispatch_ms"] = _dispatch_ms(seq)
            timed[(f"qg_step[{form}]", key)] = row
            log(f"time qg_step {form} size={key}: kernel {kms:.6f} ms "
                f"({kms / bound:.3f}x bound), plain {pms:.6f} ms, replaced "
                f"sequence {sms:.6f} ms (CUDA graphs of {iters} calls), "
                f"bound {bound:.6f} ms ({by}, {nbytes} B), "
                f"{nbytes / kms / 1e6:.1f} GB/s, library: none; eager "
                f"dispatch {row['dispatch_ms']:.6f} ms"
                + (f" vs {row['replaced_dispatch_ms']:.6f} ms replaced; "
                   f"device activities a call {row['activities']:.1f} vs "
                   f"{row['replaced_activities']:.1f} replaced"
                   if key == "quickstart" else ""))
        del x, m, g, xs, ms, gs, roles
        torch.cuda.empty_cache()


def _replaced_exchange(choco, mu, trees, w, eta, gamma):
    """The sequence ``choco_exchange`` replaces, as the chain ran it
    before: the replica advance (CHOCO), ``mix_dense`` (one product a
    leaf), ``_decompress`` (pack half, mixed and the anchors,
    ``gamma_correct``), then (QG form) ``_apply_fused_qg_buffer`` (the
    refresh gate, pack x_pre, x_out and m_hat, ``fused_qg_buffer``)."""
    import torch
    from repro_torch.comm import CompressedGossip, make_compressor
    from repro_torch.core import gossip
    from repro_torch.core import transforms as T
    from repro_torch.tree import tree_map

    half, q, x_hat, x_pre, m_hat = trees
    comm = CompressedGossip(
        compressor=make_compressor("topk:0.01", backend="pallas"),
        error_feedback=not choco)
    stage = T.qg_buffer(mu if mu is not None else 0.9)
    ctx = T.StepCtx(w=w, lr=eta, t=torch.zeros((), dtype=torch.int32,
                                                device=eta.device),
                    mix_fn=gossip.mix_dense)

    def run():
        anchor = tree_map(torch.add, x_hat, q) if choco else q
        out = comm._decompress(half, gossip.mix_dense(w, anchor), anchor,
                               gamma)
        if mu is not None:
            sv = T.StepVars(grads=None, update=None, params=x_pre,
                            params_pre_mix=x_pre, params_post_mix=out)
            T._apply_fused_qg_buffer(ctx, sv, {stage.name: {"m_hat": m_hat}},
                                     stage)
    return run


def _time_exchange(dev, timed) -> None:
    """``choco_exchange`` beside ``ref.choco_exchange``, the sequence it
    replaces (one CUDA graph each; the sequence also fills the refresh
    gate, which the kernel's caller fills too) and its bound (its streams
    over the memory rate): CHOCO/QG, EF/QG and CHOCO/DSGDm forms at the
    quickstart's tree, with the device activities and the eager dispatch
    of one call of each, and the CHOCO/QG form at EXCHANGE_LARGE."""
    import torch
    from repro_torch.kernels import compress as C
    from repro_torch.kernels import ref

    eta = _full(0.1, torch.empty(0, device=dev))
    gen = torch.Generator(device=dev).manual_seed(4)
    forms = {"choco_qg": (True, 0.9), "ef_qg": (False, 0.9),
             "choco_dsgdm": (True, None)}
    trees = [("quickstart", LEAF_SHAPES, 20, forms)] + [
        (shape, [shape], 4, {"choco_qg": forms["choco_qg"]})
        for shape in EXCHANGE_LARGE]
    for key, shapes, iters, which in trees:
        n = shapes[0][0]
        w = _step_mixing(n, dev)
        dicts = [{f"l{i}": torch.randn(s, generator=gen, device=dev)
                  for i, s in enumerate(shapes)} for _ in range(5)]
        roles = [list(d.values()) for d in dicts]
        elems = sum(t.numel() for t in roles[0])
        for form, (choco, mu) in which.items():
            gamma = 0.02002 if choco else 0.3
            args, kw = _exchange_args(roles, w, eta, choco, mu, 1.0, gamma)
            kfn = lambda: C.choco_exchange(*args, **kw)
            pfn = lambda: ref.choco_exchange(*args, **kw)
            seq = _replaced_exchange(choco, mu, dicts, w, eta, gamma)
            kms, pms = _time_ms(kfn, iters), _time_ms(pfn, iters)
            sms = _time_ms(seq, iters)
            qg = mu is not None
            # half, q (, x_hat) (, x_pre, m_hat) in; x_out (, x_hat')
            # (, m_hat') out; W and the scalars once
            streams = 3 + 2 * choco + 3 * qg
            nbytes = streams * elems * 4 + 4 * n * n + (8 if qg else 0)
            flops = (choco + 2 * n - 1 + 3 + 5 * qg) * elems
            bound, by = _bound(nbytes, flops)
            row = {"size": key, "ms": kms, "plain_ms": pms,
                   "replaced_ms": sms, "bound_ms": bound, "bound_by": by,
                   "bytes": nbytes, "dispatch_ms": _dispatch_ms(kfn)}
            if key == "quickstart":
                row["activities"] = _device_activities(dev, kfn)
                row["replaced_activities"] = _device_activities(dev, seq)
                row["replaced_dispatch_ms"] = _dispatch_ms(seq)
            timed[(f"choco_exchange[{form}]", key)] = row
            log(f"time choco_exchange {form} size={key}: kernel {kms:.6f} ms "
                f"({kms / bound:.3f}x bound), plain {pms:.6f} ms, replaced "
                f"sequence {sms:.6f} ms ({sms / kms:.2f}x the kernel; CUDA "
                f"graphs of {iters} calls), bound {bound:.6f} ms ({by}, "
                f"{nbytes} B), {nbytes / kms / 1e6:.1f} GB/s, library: none; "
                f"eager dispatch {row['dispatch_ms']:.6f} ms"
                + (f" vs {row['replaced_dispatch_ms']:.6f} ms replaced; "
                   f"device activities a call {row['activities']:.1f} vs "
                   f"{row['replaced_activities']:.1f} replaced"
                   if key == "quickstart" else ""))
        del dicts, roles
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def _history_gap(h_a, h_b, what) -> float:
    """The largest relative difference of loss, consensus and grad_norm
    between two histories of one length."""
    if len(h_a) != len(h_b):
        raise AssertionError(f"{what}: {len(h_a)} vs {len(h_b)} history rows")
    return max((abs(ra[k] - rb[k]) / max(abs(rb[k]), 1e-30)
                for ra, rb in zip(h_a, h_b)
                for k in ("loss", "consensus", "grad_norm")), default=0.0)


def _history_close(h_a, h_b, rtol, atol, what):
    import numpy as np
    worst = _history_gap(h_a, h_b, what)
    for ra, rb in zip(h_a, h_b):
        for k in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(ra[k], rb[k], rtol=rtol, atol=atol,
                                       err_msg=f"{what}: step {ra['step']} "
                                               f"{k}")
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
        # the dense-gossip step: one qg_step launch a step, in both forms
        _expect_launches(preset, counts, {"qg_step": 150})
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
#: step of the run's own chain through its capturing hook, which on the card
#: is one fused_halfstep and one fused_qg_buffer launch for QG-DSGDm-N (the
#: exchange kernel takes only a compressed round)
CAPTURE_LAUNCHES = {"fused_halfstep": 1, "fused_qg_buffer": 1}


def _run_built(spec, dev, node_order_hook=False, steps=150):
    """``(final state, history)`` of ``steps`` steps of ``spec`` built by
    ``api.build`` and trained as ``api.run`` trains it; with
    ``node_order_hook`` the trainer's compressed rounds mix by
    ``_node_order_mix``, which keeps them off the exchange kernel (the
    two-kernel path: ``fused_halfstep``, the round with ``gamma_correct``,
    ``fused_qg_buffer``)."""
    import dataclasses
    from repro_torch import api
    from repro_torch.comm import CompressedGossip
    from repro_torch.train import run_training_scanned

    @dataclasses.dataclass(frozen=True)
    class NodeOrderGossip(CompressedGossip):
        def make_mix_fn(self, sites_in, sites_out, gen, gamma, mix_impl=None):
            return super().make_mix_fn(sites_in, sites_out, gen, gamma,
                                       mix_impl=_node_order_mix)

    ex = api.build(spec, device=dev)
    if node_order_hook:
        c = ex.trainer.comm
        ex.trainer.comm = NodeOrderGossip(
            compressor=c.compressor, gamma=c.gamma,
            error_feedback=c.error_feedback, warm_start=c.warm_start)
    return run_training_scanned(ex.trainer, ex.state, ex.task.make_iter(),
                                steps, chunk=spec.loop.chunk, log_every=1,
                                log_fn=lambda *_: None)


def _states_equal(what, a, b) -> int:
    """Raise unless the TrainStates ``a`` and ``b`` hold equal tensors;
    returns how many were compared."""
    import torch
    from repro_torch.tree import tree_leaves

    def tensors(s):  # comm_state is a list of per-site trees
        return [*tree_leaves(s.params), *tree_leaves(s.opt_state),
                *(t for site in s.comm_state for t in tree_leaves(site))]

    pairs = list(zip(tensors(a), tensors(b), strict=True))
    for x, y in pairs:
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: final states differ by "
                                 f"{float((x - y).abs().max()):.3e}")
    return len(pairs)


def phase_compressed(dev) -> dict:
    """The three compressed-gossip runs through the kernels
    (``comm.backend=auto``), each with exact launch counts; top-k and EF
    against the same runs through the two-kernel path with a node-order
    mix hook (bit for bit) and rerun with ``comm.backend=jnp`` on the card,
    top-k rerun on the CPU."""
    import numpy as np
    from repro_torch import api
    from repro_torch.kernels import ops

    quiet = lambda *_: None
    api.run(api.presets.get("choco_topk0.01_ring16_qg").override(
        "loop.steps=25", "comm.backend=auto"), device=dev, log_fn=quiet)
    per_step = {  # launches per step of each run, by kernel
        "topk": {"fused_halfstep": 1, "threshold_mask": 1,
                 "choco_exchange": 1},
        "ef_signnorm": {"fused_halfstep": 1, "choco_exchange": 1},
        "qsgd": {"fused_halfstep": 1, "quantize_dequantize": 1,
                 "choco_exchange": 1}}
    specs, results, launches = {}, {}, {}
    for label, (preset, overrides, ref_acc, ref_cons, ref_ratio) in \
            COMPRESSED.items():
        spec = api.presets.get(preset).override(
            *overrides, "comm.backend=auto", "loop.log_every=1")
        ops.reset_launch_counts()
        res = api.run(spec, device=dev, log_fn=quiet)
        counts = ops.launch_counts()
        want = {k: 150 * v for k, v in per_step[label].items()}
        for k, v in CAPTURE_LAUNCHES.items():
            want[k] = want.get(k, 0) + v
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

    # the exchange kernel against the two-kernel path with the mix summed
    # in node order, as the kernel sums it: the same arithmetic in the same
    # order, so bit for bit
    for label in ("topk", "ef_signnorm"):
        ops.reset_launch_counts()
        fused, h_fused = _run_built(specs[label], dev)
        counts = ops.launch_counts()
        ops.reset_launch_counts()
        two, h_two = _run_built(specs[label], dev, node_order_hook=True)
        two_counts = ops.launch_counts()
        if counts["choco_exchange"] != 150 or two_counts["choco_exchange"] \
                or two_counts["gamma_correct"] != 150:
            raise AssertionError(f"{label} exchange vs two-kernel path: "
                                 f"launches {counts} and {two_counts}")
        rel = _history_close(h_fused, h_two, 0.0, 0.0,
                             f"{label} exchange vs two-kernel path")
        tensors = _states_equal(f"{label} exchange vs two-kernel path",
                                fused, two)
        log(f"main {label} exchange kernel vs the two-kernel path with a "
            f"node-order mix hook on the card: 150 steps bit-equal (max rel "
            f"diff {rel:.3e}), {tensors} tensors of the final state equal")

    # the same runs on the leaf-by-leaf path: the same arithmetic, with
    # the mix summed in node order bit for bit; with it summed by cuBLAS
    # (the presets' own path) within JNP_RTOL
    for label in ("topk", "ef_signnorm"):
        spec = specs[label].override("comm.backend=jnp")
        ops.reset_launch_counts()
        _, h_jnp = _run_built(spec, dev, node_order_hook=True)
        _expect_launches(f"{label} comm.backend=jnp", ops.launch_counts(), {
            "fused_halfstep": 151, "fused_qg_buffer": 151})
        _history_close(results[label].history, h_jnp, 0.0, 0.0,
                       f"{label} kernels vs jnp, node-order mix")
        ops.reset_launch_counts()
        jnp = api.run(spec, device=dev, log_fn=quiet)
        _expect_launches(f"{label} comm.backend=jnp", ops.launch_counts(), {
            "fused_halfstep": 151, "fused_qg_buffer": 151})
        steps, rtol = JNP_RTOL[label]
        gap = _history_gap(results[label].history, jnp.history, label)
        log(f"main {label} kernels vs comm.backend=jnp on the card: with the "
            f"node-order mix 150 steps bit-equal; with cuBLAS's max rel diff "
            f"{gap:.3e} over 150 steps, held to rtol {rtol} over {steps}; "
            f"jnp {jnp.wall_time_s / 150 * 1e3:.4f} ms/step, test acc "
            f"{jnp.final['acc']:.4f}")
        _history_close(results[label].history[:steps], jnp.history[:steps],
                       rtol, HIST_ATOL, f"{label} kernels vs jnp")

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


#: the device kernels of a cuDNN (or cuDNN-chosen) convolution, by name
CONV_KERNEL = re.compile(r"conv|cudnn|xmma|wgrad|dgrad|fprop|implicit",
                         re.IGNORECASE)


#: the depth of a training loop run under the profiler (a measurement:
#: per-step figures; the trace's aggregation on the host grows with the
#: loop, so a deeper loop costs the run's time budget and shows no more)
PROFILE_STEPS = 20


def phase_profile(dev, label: str, spec, steps: int = PROFILE_STEPS,
                  task=None, mesh=None) -> dict | None:
    """Device time by kernel and host time by op over the ``steps``-step
    training loop of one run of ``spec`` (a measurement: printed, and
    written to build/chip_smoke/profile_<label>.json); returns wall and
    device ms, the convolutions' device ms and ``qg_step``'s (ms,
    launches).  ``task``: the spec's data, built already; ``mesh``: the
    node mesh of a sharded or hybrid run."""
    import torch
    from repro_torch import api
    from repro_torch.train import run_training_scanned
    from torch.profiler import ProfilerActivity, profile

    ex = api.build(spec, device=dev, task=task, mesh=mesh)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_training_scanned(ex.trainer, ex.state, ex.task.make_iter(),
                             steps, chunk=spec.loop.chunk,
                             log_fn=lambda *_: None)
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
        return None
    dev_rows.sort(key=lambda r: -r[1])
    host_rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in dev_rows)
    launches = sum(r[2] for r in dev_rows)
    log(f"profile {label} training loop, {steps} steps (profiler on): wall "
        f"{wall_ms:.3f} ms, device kernel time {busy:.3f} ms "
        f"({100 * busy / wall_ms:.2f}% busy), {launches} device "
        f"activities ({launches / steps:.1f} per step)")
    # the kernels of csrc/ (templates of csrc/elementwise.cuh)
    ours = [r for r in dev_rows
            if any(k in r[0] for k in ("stream3", "rowwise", "qg_step",
                                       "choco_exchange"))]
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
    step = [(m, c) for k, m, c in dev_rows if "qg_step" in k]
    return {"wall_ms": wall_ms, "device_ms": busy,
            "conv_ms": sum(m for k, m, _ in dev_rows if CONV_KERNEL.search(k)),
            "qg_step": (sum(m for m, _ in step), sum(c for _, c in step))}


# ---------------------------------------------------------------------------
# the zoo (slice 2): the other optimizers, topologies and consensus
# ---------------------------------------------------------------------------

#: the registry entries slice 2 brings, each run on the quickstart task
ZOO_NEW = ("dsgdm_sync", "dsgdm_n_sync", "dsgdm_n_sync_global", "qhm",
           "dadam", "qg_dadam", "slowmo", "dmsgd", "d2", "d2_plus", "gt",
           "gt_dsgdm_n", "mt_dsgdm", "gut")
#: the entries whose chain holds ``[weight_decay?] heavyball gossip_mix`` at
#: its end (at stage 2 here, after weight_decay and grad_track ran
#: unfused): one ``qg_step`` a step on the dense mix; every other new entry
#: runs stage by stage, as the reference's dispatcher runs it
#: (tests/test_torch_zoo.py derives this from the reference)
ZOO_STEP = ("gt_dsgdm_n", "mt_dsgdm")
#: entries whose history is chaotic, held to CPU_RTOL over their first
#: steps only: on the CPU a 1e-7 change of the init moves the port's own
#: DAdam history by more than 1e-4 relative from step 16 (more than 1e-3
#: from 25) and QG-DAdam's from step 13 (1e-3 from 18);
#: tests/test_torch_zoo.py asserts both ends
ZOO_CHAOTIC = {"dadam": 12, "qg_dadam": 10}
#: the JAX package's test accuracy for the two presets (repro.api.run on
#: the CPU, JAX 0.9.0, 150 steps; the port's init is a torch draw, so the
#: card's run is held to the band ACC_ATOL around it)
ZOO_PRESETS = {"social32_alpha0.1_qg": 0.97509765625,
               "exp16_alpha0.1_qg": 0.974365234375}
#: the paper's comparison: QG-DSGDm-N against DSGDm-N, D^2_+ and
#: GT-DSGDm-N, QG-DAdam against DAdam
ZOO_COMPARE = ("qg_dsgdm_n", "dsgdm_n", "d2_plus", "gt_dsgdm_n", "qg_dadam",
               "dadam")
#: the tracking chains under CHOCO top-k with ``comm.backend=auto``, two
#: mix sites each (the tracker's, then the params'), launches per step and
#: in the warm-start capture, predicted before the first run (PERF.md):
#: MT's tracker site is a plain compressed round (``gamma_correct``), its
#: params site takes ``fused_halfstep``, the compress half and one
#: ``choco_exchange`` as site 1; GUT's chain matches no kernel segment, so
#: both of its sites are plain rounds, and its capture launches nothing
ZOO_TRACKING = {
    "mt_dsgdm": ({"fused_halfstep": 1, "threshold_mask": 2,
                  "gamma_correct": 1, "choco_exchange": 1},
                 {"fused_halfstep": 1}),
    "gut": ({"threshold_mask": 2, "gamma_correct": 2}, {}),
}
#: the reference's wire.ratio_vs_dense of both tracking chains under
#: choco_topk0.01_ring16_qg (JAX 0.9.0 on the CPU): a count, equal
ZOO_WIRE_RATIO = 49.46376811594203
#: consensus: rounds, dimension, and the JAX package's CPU histories
#: (repro.core.consensus, JAX 0.9.0) at rounds CONSENSUS_ROUNDS with
#: steps_to_distance(., 1e-2); the card is held to rtol 1e-4 with atol 1e-6
#: times the round-0 distance (rounds at fp32's floor), and its whole
#: history to the port's CPU run the same way
CONSENSUS_STEPS, CONSENSUS_DIM = 200, 128
CONSENSUS_ROUNDS = list(range(0, 200, 10)) + [199]
CONSENSUS_RTOL, CONSENSUS_ATOL = 1e-4, 1e-6
CONSENSUS_REF = {
    ("ring", 16, "gossip"): (81, [
        5.994057655334473, 2.433166980743408, 1.4315029382705688,
        0.850073516368866, 0.5049760341644287, 0.29997873306274414,
        0.17820113897323608, 0.10585964471101761, 0.06288546323776245,
        0.03735684975981712, 0.02219167724251747, 0.01318286918103695,
        0.007831227965652943, 0.004652108531445265, 0.0027635726146399975,
        0.0016416971338912845, 0.0009752397309057415, 0.0005793371237814426,
        0.0003441591397859156, 0.0002044455468421802, 0.0001279348653042689
    ]),
    ("ring", 16, "qg"): (66, [
        5.994057655334473, 1.780677080154419, 0.4983194172382355,
        1.1432578563690186, 1.2221943140029907, 0.8125300407409668,
        0.28899434208869934, 0.10017763823270798, 0.27182790637016296,
        0.2625499367713928, 0.15953271090984344, 0.044619880616664886,
        0.033776868134737015, 0.06328322738409042, 0.055506207048892975,
        0.03060275688767433, 0.005796855315566063, 0.00969445239752531,
        0.014397288672626019, 0.011548109352588654, 0.006308907642960548
    ]),
    ("ring", 32, "gossip"): (-1, [
        6.1884541511535645, 2.911515474319458, 2.209583282470703,
        1.8191853761672974, 1.5504379272460938, 1.3432306051254272,
        1.1728087663650513, 1.0277442932128906, 0.9021403193473816,
        0.7924996614456177, 0.6964306235313416, 0.6121065020561218,
        0.5380324721336365, 0.47293832898139954, 0.4157261252403259,
        0.36543744802474976, 0.3212330639362335, 0.2823762595653534,
        0.24821977317333221, 0.21819494664669037, 0.19429083168506622
    ]),
    ("ring", 32, "qg"): (135, [
        6.1884541511535645, 2.4533956050872803, 1.65280282497406,
        1.2460764646530151, 0.8997160196304321, 0.6349698305130005,
        0.682391345500946, 0.8748987913131714, 0.9679163694381714,
        0.9203331470489502, 0.7690146565437317, 0.5625412464141846,
        0.3398604989051819, 0.13098856806755066, 0.07367212325334549,
        0.20409345626831055, 0.29140427708625793, 0.32836106419563293,
        0.32019054889678955, 0.2769230008125305, 0.21805614233016968
    ]),
    ("social", 32, "gossip"): (41, [
        5.635720252990723, 0.950836181640625, 0.3425566256046295,
        0.13759499788284302, 0.05739838629961014, 0.02423941344022751,
        0.010274962522089481, 0.00436045415699482, 0.001851111650466919,
        0.0007859133183956146, 0.0003336808003950864, 0.00014167153858579695,
        6.015214239596389e-05, 2.554248203523457e-05, 1.0854687388928141e-05,
        4.6320487854245584e-06, 2.057358187812497e-06, 1.0535217143115005e-06,
        7.809023259142123e-07, 7.381241289294849e-07, 7.334887186516426e-07
    ]),
    ("social", 32, "qg"): (51, [
        5.635720252990723, 0.7223691344261169, 0.727898120880127,
        0.5422820448875427, 0.2569226026535034, 0.05796563997864723,
        0.06475598365068436, 0.06808916479349136, 0.0364333912730217,
        0.0062000323086977005, 0.00915251113474369, 0.010048319585621357,
        0.005233230069279671, 0.0006900569424033165, 0.0014191637746989727,
        0.0014918994856998324, 0.0007496264879591763, 7.758662104606628e-05,
        0.000220598274609074, 0.0002211555402027443, 0.00011931071639992297
    ]),
    ("exp", 16, "gossip"): (3, [
        7.585473537445068, 3.2588258136456716e-07, 3.2588258136456716e-07,
        3.2588258136456716e-07, 3.2588258136456716e-07, 3.2588258136456716e-07,
        3.2588258136456716e-07, 3.2588258136456716e-07, 3.2588258136456716e-07,
        3.2588258136456716e-07, 3.2588258136456716e-07, 3.2588258136456716e-07,
        3.2588258136456716e-07, 3.2588258136456716e-07, 3.2588258136456716e-07,
        3.2588258136456716e-07, 3.2588258136456716e-07, 3.2588258136456716e-07,
        3.2588258136456716e-07, 3.2588258136456716e-07, 3.2588258136456716e-07
    ]),
    ("exp", 16, "qg"): (27, [
        7.585473537445068, 0.5636687278747559, 0.15741311013698578,
        0.056559912860393524, 0.015260828658938408, 0.005748056340962648,
        0.00149219436571002, 0.0005905373254790902, 0.00014727743109688163,
        6.123813363956288e-05, 1.4688106602989137e-05, 6.402175586117664e-06,
        1.496673348810873e-06, 7.18187322945596e-07, 3.759112132684095e-07,
        3.587101389257441e-07, 3.524183398440073e-07, 3.5382333862798987e-07,
        3.5377777862777293e-07, 3.537896304806054e-07, 3.5379059681872604e-07
    ]),
}


@functools.cache
def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _finite_run(what, res, steps=150):
    import numpy as np
    losses = [r["loss"] for r in res.history]
    if res.steps_run != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{what}: {res.steps_run} steps, finite "
                             f"losses: {np.all(np.isfinite(losses))}")


def _add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _card_and_cpu(what, spec, dev, want, zoo_launches, steps_held=150):
    """Run ``spec`` on the card with exact launches ``want`` and on the CPU;
    hold the card's history to the CPU's (CPU_RTOL over ``steps_held``
    steps).  Returns the card's result and the gap over the whole run."""
    from repro_torch import api
    from repro_torch.kernels import ops

    quiet = lambda *_: None
    ops.reset_launch_counts()
    res = api.run(spec, device=dev, log_fn=quiet)
    counts = ops.launch_counts()
    _expect_launches(what, counts, want)
    _add_counts(zoo_launches, counts)
    _finite_run(what, res)
    cpu = api.run(spec, device="cpu", log_fn=quiet)
    _history_close(res.history[:steps_held], cpu.history[:steps_held],
                   CPU_RTOL, CPU_ATOL, f"{what} card vs CPU")
    return res, cpu, _history_gap(res.history, cpu.history, what)


def _exp16_w_on_device(dev) -> int:
    """8 steps of exp16 through the trainer with every ``qg_step`` call's W
    recorded, under CUDA sync debugging: each step's W is the stack's
    phase t % 4, picked on the card by the device step counter, and no
    step synchronizes with the host.  Returns the steps checked."""
    import warnings
    import torch
    from repro_torch import api
    from repro_torch.kernels import ops

    spec = api.presets.get("exp16_alpha0.1_qg")
    ex = api.build(spec, device=dev)
    it = ex.task.make_iter()
    batches = [ex.trainer.put_batch(next(it)) for _ in range(8)]
    seen, real = [], ops.qg_step

    def spy(xs, ms, gs, w, *a, **kw):
        seen.append(w)
        return real(xs, ms, gs, w, *a, **kw)

    state = ex.state
    torch.cuda.synchronize(dev)
    ops.qg_step = spy
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for b in batches:
                    state, _ = ex.trainer.step(state, b)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        ops.qg_step = real
    torch.cuda.synchronize(dev)
    # the mode's own notice ("... is a prototype feature ...") is not a sync
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    if syncs:
        raise AssertionError(f"exp16 steps synchronized with the host: "
                             f"{syncs[:3]}")
    mixing = ex.trainer._mixing
    if len(seen) != 8 or any(not w.is_cuda or not torch.equal(
            w, mixing[t % mixing.shape[0]]) for t, w in enumerate(seen)):
        raise AssertionError(f"exp16: {len(seen)} qg_step calls, W not "
                             f"the stack's phase t % 4 on the card")
    if any(torch.equal(a, b) for a, b in zip(seen, seen[1:])):
        raise AssertionError("exp16: two consecutive steps had one W")
    return len(seen)


def phase_zoo(dev, main_out) -> dict:
    """Slice 2 on the card: the social32 and exp16 presets, the 14 new
    registry entries on the quickstart task, the paper's comparison on
    ring16 and social32, the two tracking chains under compressed gossip
    and the consensus experiments, each checked as PERF.md states."""
    import numpy as np
    from repro_torch import api
    from repro_torch.comm.choco import CompressedMix
    from repro_torch.core import consensus, topology
    from repro_torch.kernels import ops

    card = _card()
    zoo_launches: dict = {}
    accs = {"ring16": {}, "social32": {}}

    # 1. the two presets: one qg_step a step, on 32 nodes and on a W that
    # changes every step
    for preset, ref_acc in ZOO_PRESETS.items():
        spec = api.presets.get(preset).override("loop.log_every=1")
        res, cpu, gap = _card_and_cpu(preset, spec, dev, {"qg_step": 150},
                                      zoo_launches)
        acc = res.final["acc"]
        if abs(acc - ref_acc) > ACC_ATOL:
            raise AssertionError(f"{preset}: test acc {acc:.4f} is not "
                                 f"within {ACC_ATOL} of the reference's "
                                 f"{ref_acc}")
        prof = phase_profile(dev, preset.split("_")[0],
                             api.presets.get(preset))
        busy = ("not measured" if prof is None else
                f"{100 * prof['device_ms'] / prof['wall_ms']:.2f}% busy, "
                f"{prof['wall_ms'] / PROFILE_STEPS:.4f} ms/step unlogged "
                f"over {PROFILE_STEPS} steps")
        log(f"zoo {preset}: 150 steps in {res.wall_time_s:.4f} s "
            f"({res.wall_time_s / 150 * 1e3:.4f} ms/step logged every "
            f"step), profiled {busy} [{card}]; test acc {acc:.4f} "
            f"(reference {ref_acc}), card vs CPU max rel diff {gap:.3e}, "
            f"consensus {res.final['consensus']:.3e}, launches qg_step 150")
        if preset.startswith("social32"):
            accs["social32"]["qg_dsgdm_n"] = acc
    steps = _exp16_w_on_device(dev)
    log(f"zoo exp16: {steps} steps, each step's W the stack's phase t % 4 "
        f"picked on the card and passed to qg_step, no host sync")

    # 2. the 14 new entries on the quickstart task
    quick = api.presets.get("quickstart_ring16_alpha0.1_qg")
    for name in ZOO_NEW:
        spec = quick.override(f"optim.name={name}", "loop.log_every=1")
        want = {"qg_step": 150} if name in ZOO_STEP else {}
        held = ZOO_CHAOTIC.get(name, 150)
        res, cpu, gap = _card_and_cpu(name, spec, dev, want, zoo_launches,
                                      held)
        accs["ring16"][name] = res.final["acc"]
        log(f"zoo {name} (quickstart task): 150 steps, "
            f"{res.wall_time_s / 150 * 1e3:.4f} ms/step [{card}], test acc "
            f"{res.final['acc']:.4f} (CPU {cpu.final['acc']:.4f}), card vs "
            f"CPU max rel diff {gap:.3e} over 150 steps, held to "
            f"{CPU_RTOL} over {held}; launches {want or 'none'}")
    for preset, name in (("quickstart_ring16_alpha0.1_qg", "qg_dsgdm_n"),
                         ("quickstart_ring16_alpha0.1_dsgdm", "dsgdm_n")):
        accs["ring16"][name] = main_out["results"][preset].final["acc"]

    # 3. the paper's comparison on social32 (ring16's runs are above)
    social = api.presets.get("social32_alpha0.1_qg")
    for name in ZOO_COMPARE[1:]:
        spec = social.override(f"optim.name={name}")
        ops.reset_launch_counts()
        res = api.run(spec, device=dev, log_fn=lambda *_: None)
        counts = ops.launch_counts()
        _expect_launches(f"social32 {name}", counts, {"qg_step": 150} if name
                         in ("dsgdm_n", "gt_dsgdm_n") else {})
        _add_counts(zoo_launches, counts)
        _finite_run(f"social32 {name}", res)
        accs["social32"][name] = res.final["acc"]
    for topo, row in accs.items():
        log(f"zoo comparison {topo} (test acc, 150 steps) [{card}]: " + ", "
            .join(f"{n} {row[n]:.4f}" for n in ZOO_COMPARE))

    # 4. the tracking chains under compressed gossip
    sites, real = [], CompressedMix.compress

    def spy(self, tree):
        i, q = real(self, tree)
        sites.append(i)
        return i, q

    for name, (per_step, capture) in ZOO_TRACKING.items():
        spec = api.presets.get("choco_topk0.01_ring16_qg").override(
            f"optim.name={name}", "comm.backend=auto", "loop.log_every=1")
        want = {k: 150 * v for k, v in per_step.items()}
        _add_counts(want, capture)
        sites.clear()
        ops.reset_launch_counts()
        CompressedMix.compress = spy
        try:
            res = api.run(spec, device=dev, log_fn=lambda *_: None)
        finally:
            CompressedMix.compress = real
        counts = ops.launch_counts()
        _expect_launches(f"{name} top-k", counts, want)
        _add_counts(zoo_launches, counts)
        _finite_run(f"{name} top-k", res)
        exchanges = 150 * per_step.get("choco_exchange", 0)
        if sites != [1] * exchanges:
            raise AssertionError(f"{name} top-k: exchange sites "
                                 f"{sorted(set(sites))} x {len(sites)}, "
                                 f"want site 1 x {exchanges}")
        wire = res.wire
        if wire["mix_sites"] != 2 or wire["ratio_vs_dense"] != \
                ZOO_WIRE_RATIO:
            raise AssertionError(f"{name} top-k: wire {wire}")
        log(f"zoo {name} choco_topk0.01 comm.backend=auto: 2 sites, "
            f"wire.ratio_vs_dense {wire['ratio_vs_dense']} (reference "
            f"{ZOO_WIRE_RATIO}), {res.wall_time_s / 150 * 1e3:.4f} ms/step "
            f"[{card}], test acc {res.final['acc']:.4f}, launches {want}"
            + (f", choco_exchange at site 1 x {exchanges}" if exchanges
               else ""))

    # 5. consensus: plain gossip against the QG iteration
    for (name, n, kind), (ref_steps, ref_h) in CONSENSUS_REF.items():
        topo = topology.get_topology(name, n)
        fn = (consensus.run_gossip if kind == "gossip"
              else consensus.run_qg_consensus)
        kw = dict(dim=CONSENSUS_DIM, steps=CONSENSUS_STEPS)
        fn(topo, device=dev, **kw)  # warm-up
        t0 = time.perf_counter()
        h = fn(topo, device=dev, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        h_cpu = fn(topo, device="cpu", **kw)
        atol = CONSENSUS_ATOL * ref_h[0]
        np.testing.assert_allclose(
            h[CONSENSUS_ROUNDS], np.asarray(ref_h, np.float32),
            rtol=CONSENSUS_RTOL, atol=atol,
            err_msg=f"consensus {name}{n} {kind} vs the JAX package")
        np.testing.assert_allclose(
            h, h_cpu, rtol=CONSENSUS_RTOL, atol=atol,
            err_msg=f"consensus {name}{n} {kind} card vs CPU")
        got = consensus.steps_to_distance(h, 1e-2)
        if got != ref_steps:
            raise AssertionError(f"consensus {name}{n} {kind}: "
                                 f"steps_to_distance {got}, reference "
                                 f"{ref_steps}")
        log(f"zoo consensus {name}{n} {kind}: {CONSENSUS_STEPS} rounds at "
            f"dim {CONSENSUS_DIM} in {ms:.3f} ms [{card}], distance "
            f"{h[-1] / h[0]:.3e} of round 0's, steps to 1e-2 {got} "
            f"(reference {ref_steps})")
    for (name, n, kind), (ref_steps, _) in CONSENSUS_REF.items():
        if kind == "qg":
            sg = CONSENSUS_REF[(name, n, "gossip")][0]
            speed = (f"{sg / ref_steps:.3f}x" if sg > 0 else
                     f"gossip does not reach 1e-2 in {CONSENSUS_STEPS} "
                     f"rounds")
            log(f"zoo consensus {name}{n}: QG reaches 1e-2 in {ref_steps} "
                f"rounds, gossip in {sg}: speed-up {speed}")
    log(f"zoo launches {json.dumps({k: v for k, v in zoo_launches.items() if v}, sort_keys=True)}")
    return {"launches": zoo_launches}


# ---------------------------------------------------------------------------
# slices 4 and 5: the paper's CV protocol, telemetry and checkpoints
# ---------------------------------------------------------------------------

#: the JAX package's test accuracy on ``cifar_ring16_alpha0.1_qg`` (60
#: steps, JAX 0.9.0 on the CPU) by (optimizer, seed), with ``seed=<s>``
#: overriding the spec (init, data and partition);
#: tests/test_torch_cifar.py holds each against the JAX package
CIFAR_REF = {("qg_dsgdm_n", 0): 0.79638671875,
             ("qg_dsgdm_n", 1): 0.759765625,
             ("qg_dsgdm_n", 2): 0.765625,
             ("dsgdm_n", 0): 0.607177734375}
#: the band the card's QG-DSGDm-N accuracy must land in: the reference's
#: seed range widened by ACC_ATOL.  The port's init is a torch draw (ROADMAP
#: C3), and the reference's own spread over three seeds (0.037) is wider
#: than ACC_ATOL, so a band around seed 0 alone would not hold an honest
#: run
CIFAR_QG_BAND = (min(v for (m, _), v in CIFAR_REF.items()
                     if m == "qg_dsgdm_n") - ACC_ATOL,
                 max(v for (m, _), v in CIFAR_REF.items()
                     if m == "qg_dsgdm_n") + ACC_ATOL)
#: ``qg_step``'s leaves a launch on ResNet-20's tree (48 a launch at most):
#: EvoNorm has 80 param leaves, GN and BN 61; ``head_b`` (10 columns) is
#: the one leaf on the scalar loop
CIFAR_STEP_LEAVES = {"evonorm": (48, 32), "gn": (48, 13), "bn": (48, 13)}
#: the CHOCO top-k ResNet-20 run (``comm.compressor=topk:0.01``,
#: ``comm.backend=auto``, 20 steps), predicted before the first run
#: (PERF.md §6) from the plans: one packed ``fused_halfstep`` a step
#: and one in the warm-start capture with its one ``fused_qg_buffer``; the
#: message's 80 leaves in ceil(80 / 48) = 2 grouped ``threshold_mask``
#: launches (``compress.group_plan``) and 2 ``choco_exchange`` launches
#: (``compress.exchange_plan``) a step
CIFAR_TOPK = {"fused_halfstep": 21, "fused_qg_buffer": 1,
              "threshold_mask": 40, "choco_exchange": 40}
#: card vs CPU on the CIFAR preset: CIFAR_CPU_RTOL (atol 0) over every
#: step.  The run is not chaotic: on the CPU a 1e-7 change of the init
#: moved the port's 60-step history by at most 1.7e-6 relative, and on an
#: H100 the card's history stayed within 1.482e-06 of the CPU's over all
#: 60 steps (PERF.md §6).  The same run with TF32 convs
#: (``cudnn.allow_tf32``, which ``device.resolve_device`` turns off) must
#: fail it: the phase runs that control too
CIFAR_CPU_STEPS, CIFAR_CPU_RTOL = 60, 1e-5
#: the CHOCO top-k ResNet-20 run through the kernels against the same run
#: with ``comm.backend=jnp`` (the anchors' mix by cuBLAS) and against the
#: port's CPU run, (steps, rtol), atol 0.  On an H100 (PERF.md §6) no
#: entry crossed the k-th magnitude in these 20 steps (top-k's jump on a
#: rounding difference, CPU_TOPK_RTOL): the histories stayed within
#: 1.726e-06 (jnp) and 3.861e-06 (CPU) relative over all 20, and the
#: bounds give each about 5x that
CIFAR_TOPK_TOL = {"jnp": (20, 1e-5), "cpu": (20, 2e-5)}
#: the telemetry cadences run on the card, and the steps of the no-sync
#: check (every CIFAR_SYNC_EVERY-th of them collecting)
CIFAR_EVERY = (1, 10)
CIFAR_SYNC_STEPS, CIFAR_SYNC_EVERY = 8, 4
#: ResNet-20's EvoNorm tree (16 nodes): qg_step's timed shape
RESNET20_ELEMS = 272_970


def _resnet20_shapes(norm="evonorm", n=16):
    """The node-stacked shapes of ResNet-20's param leaves, tree order."""
    import torch
    from repro_torch.models import resnet
    from repro_torch.tree import tree_leaves
    params, _ = resnet.init_resnet20(torch.Generator().manual_seed(0),
                                     norm=norm)
    return [(n, *leaf.shape) for leaf in tree_leaves(params)]


def _cifar_spec(*overrides):
    from repro_torch import api
    return api.presets.get("cifar_ring16_alpha0.1_qg").override(
        "loop.log_every=1", *overrides)


def _run_counted(what, spec, dev, want, steps, **kw):
    """``api.run`` of ``spec`` on the card with the launch counters zeroed
    just before and read just after; exact launches ``want``; returns the
    result and the float4/scalar leaves ``qg_step`` ran."""
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.kernels import qg_update as K

    before = dict(K.STEP_PATHS)
    ops.reset_launch_counts()
    res = api.run(spec, device=dev, log_fn=lambda *_: None, **kw)
    counts = ops.launch_counts()
    paths = {k: K.STEP_PATHS[k] - before[k] for k in before}
    _expect_launches(what, counts, want)
    _finite_run(what, res, steps)
    return res, counts, paths


def _expect_step_plan(what, norm, paths, steps) -> None:
    """``qg_step`` ran CIFAR_STEP_LEAVES[norm] leaves a launch, every leaf
    on float4 but ``head_b`` on the scalar loop, checked on the plan of the
    tree's leaves and on the paths the wrapper counted."""
    from repro_torch.kernels import qg_update as K
    from repro_torch.models import resnet
    import torch
    from repro_torch.tree import tree_leaves, tree_paths

    params, _ = resnet.init_resnet20(torch.Generator().manual_seed(0),
                                     norm=norm)
    names, leaves = tree_paths(params), tree_leaves(params)
    plan = K.qg_step_plan([(leaf.numel(), [0] * 5) for leaf in leaves])
    sizes = tuple(len(entries) for entries, _ in plan)
    scalar = [names[i] for entries, _ in plan for i, _, vec in entries
              if not vec]
    want = {"vector": steps * (len(leaves) - 1), "scalar": steps}
    if sizes != CIFAR_STEP_LEAVES[norm] or scalar != [("head_b",)] \
            or paths != want:
        raise AssertionError(f"{what}: qg_step plan {sizes}, scalar leaves "
                             f"{scalar}, paths {paths} (want "
                             f"{CIFAR_STEP_LEAVES[norm]}, head_b, {want})")


def _bn_stats_local(ckpt) -> str:
    """BN's running statistics in the checkpoint ``ckpt`` (an open npz of
    a 16-node ring run) differ across nodes and equal no node's mix
    (W @ stats): they were never gossiped."""
    import numpy as np
    from repro_torch.core import topology

    w = np.asarray(topology.ring(16).mixing[0], np.float32)
    keys = [k for k in ckpt.files if "x:.model_state" in k]
    for k in keys:
        leaf = ckpt[k].reshape(16, -1)
        mixed = w @ leaf
        if np.array_equal(leaf, np.broadcast_to(
                leaf[:1], leaf.shape)) or any(
                np.array_equal(leaf[i], mixed[i]) for i in range(16)):
            raise AssertionError(f"BN running statistics look gossiped "
                                 f"({k})")
    if not keys:
        raise AssertionError("the BN checkpoint holds no model state")
    return (f"; {len(keys)} running-statistics leaves differ across nodes "
            f"and equal no node's mix")


def _sync_free_steps(dev) -> tuple[int, int]:
    """CIFAR_SYNC_STEPS steps of the CIFAR QG spec with telemetry through
    the trainer, every CIFAR_SYNC_EVERY-th collecting, under CUDA sync
    debugging: no step synchronizes with the host (the off-cadence steps
    are the telemetry-free step).  Returns (steps, collecting steps)."""
    import warnings
    import torch
    from repro_torch import api

    spec = _cifar_spec("telemetry.enabled=true",
                       f"telemetry.every={CIFAR_SYNC_EVERY}")
    ex = api.build(spec, device=dev)
    it = ex.task.make_iter()
    batches = [ex.trainer.put_batch(next(it))
               for _ in range(CIFAR_SYNC_STEPS + 2)]
    state = ex.state
    for b in batches[:2]:  # warm-up: the convs' first calls, the handles
        state, _ = ex.trainer.step(state, b, True)
    torch.cuda.synchronize(dev)
    found, collected = {}, 0
    for i, b in enumerate(batches[2:]):
        collect = i % CIFAR_SYNC_EVERY == 0
        collected += collect
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, metrics = ex.trainer.step(state, b, collect)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]
        if syncs:
            found[i] = syncs[:2]
        if collect != any(k.startswith("tm.") for k in metrics):
            raise AssertionError(f"sync check: step {i} collect={collect}, "
                                 f"metrics {sorted(metrics)}")
    torch.cuda.synchronize(dev)
    if found:
        raise AssertionError(f"CIFAR steps synchronized with the host: "
                             f"{found}")
    return CIFAR_SYNC_STEPS, collected


class _Cut(Exception):
    """Interrupts a run from its ``log_fn``, as a kill would."""


def _cut_at(step):
    """A ``log_fn`` that interrupts the run when it logs step ``step``
    (0-based), that is after the periodic checkpoint of its first ``step``
    steps; the spec must log every step."""
    def log_fn(line):
        if line.startswith("step") and int(line.split()[1]) >= step:
            raise _Cut
    return log_fn


def _resume_pair(what, spec, dev, cut_at, check_full=None,
                 mesh=None) -> str:
    """``spec`` run whole with a final checkpoint, and run with
    ``loop.checkpoint_every=cut_at`` and interrupted after that checkpoint,
    then resumed from it, all through ``api.run`` as the CLI's
    ``--checkpoint``/``--resume`` run it; the two final checkpoints
    (params, opt, model and comm state, counter, generator state) compared
    key by key.  ``check_full(npz)`` adds its own reading of the whole
    run's checkpoint; ``mesh``: the node mesh of a sharded or hybrid run.
    Returns a description of the comparison."""
    import json as _json
    import numpy as np
    from repro_torch import api

    OUT.mkdir(parents=True, exist_ok=True)
    full, cut, resumed = (str(OUT / f"ckpt_{what}_{p}.npz")
                          for p in ("full", "cut", "resumed"))
    quiet = lambda *_: None
    api.run(spec, device=dev, checkpoint_path=full, log_fn=quiet, mesh=mesh)
    try:
        api.run(spec.override(f"loop.checkpoint_every={cut_at}"),
                device=dev, checkpoint_path=cut, log_fn=_cut_at(cut_at),
                mesh=mesh)
    except _Cut:
        pass
    else:
        raise AssertionError(f"{what} resume: the run was not interrupted")
    with np.load(cut) as c:
        step = _json.loads(str(c["__meta__"]))["step"]
    if step != cut_at:
        raise AssertionError(f"{what} resume: cut checkpoint at step {step}, "
                             f"want {cut_at}")
    api.run(spec, device=dev, resume=cut, checkpoint_path=resumed,
            log_fn=quiet, mesh=mesh)
    with np.load(full) as a, np.load(resumed) as b:
        same = _same_checkpoints(what, a, b)
        if check_full is not None:
            same += check_full(a)
    # the checkpoints hold every node's state (tens of MB): not kept
    for p in (full, cut, resumed):
        Path(p).unlink()
    return same


def _same_checkpoints(what, a, b) -> str:
    """Raise unless the npz files ``a`` and ``b`` hold the same arrays, bit
    for bit; returns what was compared."""
    import numpy as np
    if set(a.files) != set(b.files):
        raise AssertionError(f"{what} resume: keys "
                             f"{sorted(set(a.files) ^ set(b.files))}")
    differ = [k for k in a.files if not np.array_equal(a[k], b[k])]
    if differ:
        gaps = {k: float(np.max(np.abs(a[k].astype(np.float64) - b[k])))
                for k in differ if a[k].dtype.kind == "f"}
        raise AssertionError(f"{what} resume: {len(differ)} of "
                             f"{len(a.files)} arrays differ, max abs "
                             f"{max(gaps.values(), default=0.0):.3e} "
                             f"(first {differ[:3]})")
    groups = {g: sum(f"x:.{g}" in k for k in a.files)
              for g in ("params", "opt_state", "model_state", "comm_state")}
    return f"{len(a.files)} arrays bit-equal (" + ", ".join(
        f"{g} {c}" for g, c in groups.items() if c) + ")"


def _telemetry_pair(what, spec, base, dev, want, steps) -> list:
    """``spec`` with telemetry at each cadence of CIFAR_EVERY against
    ``base`` (the same spec without): history bit-equal, launches
    unchanged, rows as the cadence says.  Returns log fragments."""
    from repro_torch.telemetry import read_jsonl

    out = []
    for every in CIFAR_EVERY:
        path = OUT / f"metrics_{what}_{every}.jsonl"
        res, _, _ = _run_counted(
            f"{what} telemetry every {every}",
            spec.override("telemetry.enabled=true",
                          f"telemetry.every={every}"), dev, want, steps,
            telemetry_path=str(path))
        if res.history != base.history:
            raise AssertionError(f"{what} telemetry every {every}: history "
                                 f"differs from the run without")
        rows = read_jsonl(str(path))
        if [r["step"] for r in rows] != list(range(0, steps, every)):
            raise AssertionError(f"{what} telemetry every {every}: rows at "
                                 f"{[r['step'] for r in rows]}")
        out.append(f"every {every}: {len(rows)} rows, "
                   f"{res.wall_time_s / steps * 1e3:.4f} ms/step")
        last = {k: v for k, v in rows[-1].items() if k != "step"}
    out.append("last row " + ", ".join(f"{k} {v:.4g}"
                                       for k, v in sorted(last.items())))
    return out


def _topk_checks(spec, dev) -> None:
    """The CHOCO top-k ResNet-20 run through the kernels (two grouped
    ``threshold_mask`` and two ``choco_exchange`` launches a step over its
    80 leaves) against the same run with ``comm.backend=jnp`` and a
    node-order mix hook, history and final state bit for bit; against
    ``comm.backend=jnp`` as the preset runs it (cuBLAS's mix) and against
    the port's CPU run within CIFAR_TOPK_TOL.  The caller sets
    ``cudnn.deterministic``: two card runs are compared bit for bit."""
    from repro_torch import api
    from repro_torch.kernels import ops

    quiet = lambda *_: None
    ops.reset_launch_counts()
    fused, h_fused = _run_built(spec, dev, steps=20)
    _expect_launches("cifar top-k kernels", ops.launch_counts(), CIFAR_TOPK)
    jspec = spec.override("comm.backend=jnp")
    ops.reset_launch_counts()
    two, h_two = _run_built(jspec, dev, node_order_hook=True, steps=20)
    _expect_launches("cifar top-k comm.backend=jnp", ops.launch_counts(),
                     {"fused_halfstep": 21, "fused_qg_buffer": 21})
    what = "cifar top-k kernels vs jnp with the node-order mix"
    _history_close(h_fused, h_two, 0.0, 0.0, what)
    tensors = _states_equal(what, fused, two)
    del fused, two
    jnp = api.run(jspec, device=dev, log_fn=quiet)
    t0 = time.perf_counter()
    cpu = api.run(spec, device="cpu", log_fn=quiet)
    cpu_s = time.perf_counter() - t0
    parts = []
    for key, other in (("jnp", jnp.history), ("cpu", cpu.history)):
        steps, rtol = CIFAR_TOPK_TOL[key]
        by_step = [_history_gap([a], [b], key)
                   for a, b in zip(h_fused, other, strict=True)]
        _history_close(h_fused[:steps], other[:steps], rtol, 0.0,
                       f"cifar top-k kernels vs {key}")
        parts.append(f"vs {key}: max rel diff {max(by_step):.3e} (by step "
                     + " ".join(f"{g:.1e}" for g in by_step)
                     + f"), held to rtol {rtol} atol 0 over {steps}")
    log(f"cifar top-k kernels vs comm.backend=jnp with the node-order mix: "
        f"20 steps bit-equal, {tensors} tensors of the final state equal; "
        + "; ".join(parts) + f" (CPU run {cpu_s:.1f} s)")


def phase_cifar(dev, main_out) -> dict:
    """Slices 4 and 5 on the card: the CIFAR preset (ResNet-20, EvoNorm) and
    its DSGDm-N twin for 60 steps, GN and BN and CHOCO top-k for 20, each
    with exact launches; card against CPU (with the TF32 control), fused
    against unfused, against the JAX package's accuracies (CIFAR_REF);
    telemetry on against off and without host syncs; checkpoint and
    resume; top-k against the jnp path and the CPU; the loop profiled."""
    import torch
    from repro_torch import api
    from repro_torch.train import run_training_scanned

    card = _card()
    quiet = lambda *_: None
    launches: dict = {}
    api.run(_cifar_spec("loop.steps=5"), device=dev, log_fn=quiet)  # warm-up

    # 1. the preset and its DSGDm-N twin: two qg_step launches a step
    results = {}
    for method in ("qg_dsgdm_n", "dsgdm_n"):
        spec = _cifar_spec(f"optim.name={method}")
        res, counts, paths = _run_counted(f"cifar {method}", spec, dev,
                                          {"qg_step": 120}, 60)
        _expect_step_plan(f"cifar {method}", "evonorm", paths, 60)
        _add_counts(launches, counts)
        results[method] = res
        log(f"cifar {method} (ResNet-20 EvoNorm, 16 nodes, 60 steps): "
            f"{res.wall_time_s / 60 * 1e3:.4f} ms/step logged every step "
            f"[{card}], test acc {res.final['acc']:.4f} (JAX package, seed 0: "
            f"{CIFAR_REF[(method, 0)]}), consensus "
            f"{res.final['consensus']:.3e}, launches qg_step 120 "
            f"({'+'.join(map(str, CIFAR_STEP_LEAVES['evonorm']))} leaves, "
            f"head_b on the scalar loop: paths {paths})")
    qg, ds = results["qg_dsgdm_n"], results["dsgdm_n"]
    lo, hi = CIFAR_QG_BAND
    if not lo <= qg.final["acc"] <= hi or \
            qg.final["acc"] <= ds.final["acc"]:
        raise AssertionError(
            f"cifar: QG-DSGDm-N acc {qg.final['acc']:.4f} (band "
            f"{lo:.4f}-{hi:.4f}), DSGDm-N {ds.final['acc']:.4f}")
    log(f"cifar against the JAX package: QG-DSGDm-N {qg.final['acc']:.4f} in "
        f"{lo:.4f}-{hi:.4f} (seeds 0-2: "
        + ", ".join(f"{v}" for (m, _), v in CIFAR_REF.items()
                    if m == "qg_dsgdm_n")
        + f"), beats DSGDm-N {ds.final['acc']:.4f} (seed 0: "
          f"{CIFAR_REF[('dsgdm_n', 0)]}) by "
          f"{qg.final['acc'] - ds.final['acc']:.4f}")

    # card against the port's CPU run, and against the unfused chain
    t0 = time.perf_counter()
    cpu = api.run(_cifar_spec("optim.fused=kernel"), device="cpu",
                  log_fn=quiet)
    cpu_s = time.perf_counter() - t0
    rel = _history_close(qg.history[:CIFAR_CPU_STEPS],
                         cpu.history[:CIFAR_CPU_STEPS], CIFAR_CPU_RTOL, 0.0,
                         "cifar card vs CPU")
    if abs(qg.final["acc"] - cpu.final["acc"]) > ACC_ATOL:
        raise AssertionError(f"cifar card vs CPU: test acc "
                             f"{qg.final['acc']} vs {cpu.final['acc']}")
    # the control: the same run with TF32 convs must fail that check
    ex = api.build(_cifar_spec(), device=dev)
    torch.backends.cudnn.allow_tf32 = True
    try:
        _, h_tf32 = run_training_scanned(
            ex.trainer, ex.state, ex.task.make_iter(), 60,
            chunk=ex.spec.loop.chunk, log_every=1, log_fn=quiet)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    del ex
    rel_tf32 = _history_gap(h_tf32[:CIFAR_CPU_STEPS],
                            cpu.history[:CIFAR_CPU_STEPS], "cifar TF32")
    try:
        _history_close(h_tf32[:CIFAR_CPU_STEPS],
                       cpu.history[:CIFAR_CPU_STEPS], CIFAR_CPU_RTOL, 0.0,
                       "cifar TF32 convs vs CPU")
    except AssertionError:
        pass
    else:
        raise AssertionError(f"cifar: the run with TF32 convs passes the "
                             f"card-vs-CPU check (max rel diff "
                             f"{rel_tf32:.3e})")
    off, _, _ = _run_counted("cifar fused=off", _cifar_spec("optim.fused=off"),
                             dev, {}, 60)
    rel_off = _history_close(qg.history, off.history, HIST_RTOL, HIST_ATOL,
                             "cifar fused vs unfused")
    log(f"cifar card vs CPU: max rel diff {rel:.3e} over {CIFAR_CPU_STEPS} "
        f"steps (rtol {CIFAR_CPU_RTOL}, atol 0; CPU run {cpu_s:.1f} s), test "
        f"acc {qg.final['acc']:.4f} vs {cpu.final['acc']:.4f}; with TF32 "
        f"convs (the control) max rel diff {rel_tf32:.3e}, which fails it; "
        f"fused vs unfused on the card: max rel "
        f"diff {rel_off:.3e} (rtol {HIST_RTOL}, atol {HIST_ATOL}), unfused "
        f"{off.wall_time_s / 60 * 1e3:.4f} ms/step, test acc "
        f"{off.final['acc']:.4f}")

    # 2. GN and BN: 48 + 13 leaves a launch; BN's statistics stay local
    for norm in ("gn", "bn"):
        spec = _cifar_spec(f"model.kwargs.norm={norm}", "loop.steps=20")
        res, counts, paths = _run_counted(f"cifar {norm}", spec, dev,
                                          {"qg_step": 40}, 20)
        _expect_step_plan(f"cifar {norm}", norm, paths, 20)
        _add_counts(launches, counts)
        log(f"cifar {norm}: 20 steps, {res.wall_time_s / 20 * 1e3:.4f} "
            f"ms/step [{card}], test acc {res.final['acc']:.4f}, launches "
            f"qg_step 40 ({'+'.join(map(str, CIFAR_STEP_LEAVES[norm]))} "
            f"leaves)")

    # 3. CHOCO top-k on the kernels: launches as CIFAR_TOPK predicts
    topk_spec = _cifar_spec("comm.compressor=topk:0.01", "comm.backend=auto",
                            "loop.steps=20")
    res, counts, _ = _run_counted("cifar top-k", topk_spec, dev, CIFAR_TOPK,
                                  20)
    _add_counts(launches, counts)
    log(f"cifar top-k comm.backend=auto: 20 steps, "
        f"{res.wall_time_s / 20 * 1e3:.4f} ms/step [{card}], test acc "
        f"{res.final['acc']:.4f}, wire.ratio_vs_dense "
        f"{res.wire['ratio_vs_dense']:.4f}, launches {CIFAR_TOPK} as "
        f"predicted")

    # 4. telemetry: histories bit-equal with it off, launches unchanged,
    # rows on cadence, no host sync; 5. checkpoint and resume.  Both
    # compare runs bit for bit, so the convs take cuDNN's deterministic
    # algorithms here (its backward-weight algorithms may otherwise sum in
    # any order from run to run); the MLP has no conv
    torch.backends.cudnn.deterministic = True
    try:
        quick = api.presets.get("quickstart_ring16_alpha0.1_qg").override(
            "loop.log_every=1")
        base, _, _ = _run_counted("cifar deterministic", _cifar_spec(), dev,
                                  {"qg_step": 120}, 60)
        for what, spec, base, want, steps in (
                ("quickstart", quick,
                 main_out["results"]["quickstart_ring16_alpha0.1_qg"],
                 {"qg_step": 150}, 150),
                ("cifar", _cifar_spec(), base, {"qg_step": 120}, 60)):
            parts = _telemetry_pair(what, spec, base, dev, want, steps)
            log(f"cifar telemetry {what}: history bit-equal to telemetry "
                f"off ({base.wall_time_s / steps * 1e3:.4f} ms/step), "
                f"launches {want} unchanged; " + "; ".join(parts)
                + f" [{card}]")
        steps, collected = _sync_free_steps(dev)
        log(f"cifar telemetry: {steps} steps ({collected} collecting, every "
            f"{CIFAR_SYNC_EVERY}) under CUDA sync debugging, no host sync")
        for what, spec, check in (
                ("bn", _cifar_spec("model.kwargs.norm=bn", "loop.steps=20"),
                 _bn_stats_local),
                ("topk", topk_spec, None)):
            log(f"cifar checkpoint {what}: 20 steps whole vs interrupted "
                f"after a checkpoint at 10 and resumed: "
                f"{_resume_pair(what, spec, dev, 10, check)}")
        _topk_checks(topk_spec, dev)
    finally:
        torch.backends.cudnn.deterministic = False

    # 6. where the time goes
    prof = phase_profile(dev, "cifar", _cifar_spec())
    if prof is not None:
        step_ms, step_n = prof["qg_step"]
        # x, m, g in, x_new, m_out out, fp32, over every node's params
        bound_us = RESNET20_ELEMS * 16 * 20 / PEAK_BYTES_S * 1e6
        log(f"cifar profile: {prof['wall_ms'] / PROFILE_STEPS:.4f} ms/step, "
            f"{100 * prof['device_ms'] / prof['wall_ms']:.2f}% busy, convs "
            f"(cuDNN's kernels) {prof['conv_ms']:.4f} ms, "
            f"{100 * prof['conv_ms'] / prof['device_ms']:.2f}% of device "
            f"time; qg_step {step_n} launches, "
            f"{step_ms / PROFILE_STEPS * 1e3:.3f} us "
            f"a step ({step_ms / max(step_n, 1) * 1e3:.3f} us each) against "
            f"the step's bytes bound {bound_us:.3f} us [{card}]")
    shown = {k: v for k, v in launches.items() if v}
    log(f"cifar launches {json.dumps(shown, sort_keys=True)}")
    return {"launches": launches}


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
#: shape), a Gemma-2 27B local layer past its window, one query, S = 1000,
#: and the LM preset's 12 query heads over 4 KV heads (GQA 3:1): the
#: exported model's [2, 512] prefill and a training sequence of 128
FLASH_CASES = [
    (1, 128, 128, 4, 4, 32, {}), (2, 256, 256, 8, 2, 64, {}),
    (1, 200, 200, 4, 2, 32, {}), (1, 256, 256, 4, 4, 32, {"window": 64}),
    (1, 256, 256, 4, 4, 32, {"softcap": 30.0}),
    (1, 128, 192, 4, 4, 32, {"causal": False}),
    (2, 1024, 1024, 32, 4, 64, {}),
    (1, 4608, 4608, 32, 16, 128, {"window": 4096, "softcap": 50.0}),
    (1, 1, 1, 32, 4, 64, {}), (1, 1000, 1000, 32, 4, 64, {}),
    (2, 512, 512, 12, 4, 64, {}), (16, 128, 128, 12, 4, 64, {}),
    (1, 4608, 4608, 32, 32, 112, {"window": 4096}),
    (1, 1, 1, 32, 32, 112, {"window": 4096}),
    (1, 1000, 1000, 32, 32, 112, {"window": 4096}),
    (2, 300, 300, 8, 2, 112, {}), (1, 200, 333, 8, 2, 112, {"causal": False}),
    (2, 1024, 1024, 24, 8, 64, {}), (2, 512, 512, 32, 8, 128, {}),
]
FLASH_MAIN, FLASH_LONG, FLASH_LM = FLASH_CASES[6], FLASH_CASES[7], \
    FLASH_CASES[10]
#: slice 6b-iii's flash shapes: zamba2-7b's shared block (head_dim 112,
#: window 4096) over a [1, 4608] prefill, then head_dim 112 at S = 1 and
#: 1000, with GQA 4:1 and non-causal; granite-moe-3b's [2, 1024] prefill
#: (24 over 8 heads of 64) and the VLM's [2, 512] (32 over 8 of 128)
FLASH_ZAMBA2 = FLASH_CASES[12]

#: (B, H, K, D, ps, P, NP, window, softcap, lengths): the reference's four
#: cases (tests/test_serve.py:234, lengths drawn in [1, P*ps]), the
#: engine's shape at the serving CLI's defaults with two inactive slots
#: (length 0, block-table rows all -1), 8 slots x 4096 tokens, the same
#: with ragged lengths (splits past a slot's length, a length-0 slot) and
#: with window 1000 (splits wholly outside the window), which split over
#: pages and merge; and the engine's shape for the LM preset's export (12
#: query heads over 4 KV heads) and for granite-moe-3b (24 over 8, G = 3)
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
    (8, 12, 4, 64, 16, 16, 128, 0, 0.0, (0, 24, 33, 48, 16, 0, 40, 31)),
    (8, 24, 8, 64, 16, 16, 128, 0, 0.0, (0, 24, 33, 48, 16, 0, 40, 31)),
]
PAGED_MAIN, PAGED_LONG, PAGED_LM = PAGED_CASES[4], PAGED_CASES[5], \
    PAGED_CASES[8]


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
                               ("long", FLASH_LONG, 2),
                               ("lm", FLASH_LM, 10),
                               ("zamba2", FLASH_ZAMBA2, 2),
                               ("d112_s1", FLASH_CASES[13], 20),
                               ("d112_s1000", FLASH_CASES[14], 5),
                               ("d112_gqa", FLASH_CASES[15], 10),
                               ("d112_noncausal", FLASH_CASES[16], 10),
                               ("granite", FLASH_CASES[17], 10),
                               ("vlm", FLASH_CASES[18], 10)):
        q, k, v, kw = _flash_inputs(case, torch.float32, dev, 30)
        b, s, t, h, kh, d, _ = case
        causal, window = kw.get("causal", True), kw.get("window", 0)
        pairs = _band_pairs(s, t, causal, window) * b * h
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
        bound, by = _bound(nbytes, 4 * d * pairs, PEAK_3XTF32_FLOPS)
        lib_ms = None
        if not kw.get("softcap"):
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            mask = None
            if window:   # the band as an explicit boolean mask
                i = torch.arange(s, device=dev)[:, None]
                j = torch.arange(t, device=dev)[None, :]
                mask = (i >= j) & (i - j < window)
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and not window,
                enable_gqa=True), iters)
            del qt, kt, vt, mask
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
                               ("long", PAGED_LONG, 10),
                               ("lm", PAGED_LM, 20),
                               ("granite", PAGED_CASES[9], 20)):
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


def phase_serve(dev, cfg, params, reqs, sequential: bool = True) -> dict:
    """The engine through the paged-decode kernel with exact launch counts,
    held against the engine without the kernels and (``sequential``)
    against ``sequential_generate``, request by request."""
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
    for r in reqs if sequential else ():
        prompt = torch.tensor([r.prompt], dtype=torch.int32, device=dev)
        toks = sequential_generate(params, cfg, prompt, gen_len=r.max_new,
                                   cache_len=len(r.prompt) + r.max_new)
        seq.append(tuple(toks[0, len(r.prompt):].tolist()))
    if sequential:
        ties += _compare_tokens("kernel engine vs sequential_generate",
                                params, cfg, reqs, got, seq, dev)
    log(f"main serve tokens: kernel engine == use_pallas=False engine"
        + (" == sequential_generate" if sequential else "")
        + f" for {len(reqs)} requests"
        + (f" up to {len(ties)} near-tie(s)" if ties else " (all equal)"))
    return {"launches": counts, "tokens_per_s": n_tok / wall, "steps": steps,
            "stats": st, "wall_s": wall, "ties": ties, "tokens": got}


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


def phase_prefill(dev, cfg, params, shape=PREFILL_SHAPE) -> dict:
    """``prefill(tokens shape, use_pallas=True)`` at full width (TinyLlama:
    [2, 1024]): a flash launch a layer, logits and every layer's K/V within
    PREFILL_TOL of the chunked path, which is timed on its first call and again (the
    allocator's state logged around the first); then one kernel-path call
    under the profiler: its wall time beside its device time."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    rng = np.random.default_rng(SERVE_SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           size=shape)).to(dev)
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
    log(f"main prefill {cfg.name} tokens {list(shape)}: flash "
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
    log(f"main prefill {cfg.name} tokens {list(shape)} under the "
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
#: zamba2-7b's scan in its [1, 4608] prefill (112 heads, P 64, N 64),
#: timed beside the main shape
SSD_ZAMBA2 = (1, 4608, 112, 64, 64, 128, 1.0)

#: (case, views, P tiles, N padded): shapes that reach the kernels'
#: indexing paths which SSD_CASES do not -- P in several column tiles with
#: a partial last one (128 = 64 + 64, 80 = 48 + 32, 96 = 64 + 32), N
#: padded to a multiple of 16 (20 -> 32, 12 -> 16) with a short last
#: chunk, and x, b and c as views of one buffer one element into it, with
#: an odd token stride, so rows are not 16-byte aligned and the kernels
#: stage them element by element (views False: contiguous, staged by
#: 16-byte cp.async / 8-byte loads)
SSD_PATH_CASES = [
    ((1, 256, 2, 128, 64, 128, 1.0), False, (64, 64), 64),
    ((2, 256, 3, 80, 64, 128, 1.0), False, (48, 32), 64),
    ((1, 136, 3, 32, 20, 8, 1.0), False, (32,), 32),
    ((2, 192, 3, 96, 12, 64, 1.0), True, (64, 32), 16),
]

#: the Mamba path: mamba2-130m (configs/mamba2_130m.py) at its published
#: widths and depth, a seeded init, fp32 with TF32 off
MAMBA_ARCH, MAMBA_SEED = "mamba2-130m", 0
MAMBA_PREFILL, MAMBA_TRAIN, MAMBA_DECODE = (2, 2048), (1, 512), 32

#: kernel path vs plain path of a whole forward: max |diff| / max |plain|
#: of the last logits and of every layer's conv and SSM state.  Both are
#: fp32; the scan sums in other orders (1e-6 relative per layer seen on
#: reduced configs), carried through 24 layers: 1e-4
MAMBA_TOL = 1e-4

#: the scan's kernels, each launched once per ``ssd_scan`` call: the chunk
#: pass (counted under the scan's own name), the state pass and the output
#: pass; the two that carry products must issue HMMA
SSD_KERNELS = ("ssd_scan", "ssd_scan_passing", "ssd_scan_outputs")
SSD_PRODUCT_KERNELS = ("ssd_chunk_states", "ssd_chunk_outputs")
SSD_DEVICE_NAMES = ("ssd_chunk_states", "ssd_state_pass",
                    "ssd_chunk_outputs")


def _ssd_launches(calls: int) -> dict:
    """The launch counts of ``calls`` scans."""
    return {k: calls for k in SSD_KERNELS} if calls else {}


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


def _unaligned_views(x, bm, cm):
    """x [B,S,H,P], b and c [B,S,N] copied into one [B,S,1+H*P+2N] buffer
    from its second element on, and returned as views of it: an odd token
    stride and rows not 16-byte aligned, as slices of a conv output can
    be."""
    import torch
    bsz, s, h, p = x.shape
    n = bm.shape[-1]
    buf = torch.zeros((bsz, s, 1 + h * p + 2 * n), dtype=x.dtype,
                      device=x.device)
    buf[..., 1:1 + h * p] = x.reshape(bsz, s, h * p)
    buf[..., 1 + h * p:1 + h * p + n] = bm
    buf[..., 1 + h * p + n:] = cm
    return (buf[..., 1:1 + h * p].unflatten(-1, (h, p)),
            buf[..., 1 + h * p:1 + h * p + n], buf[..., 1 + h * p + n:])


def phase_ssd_kernels(dev) -> dict:
    """The SSD scan against its plain version at every case in fp32 and
    bf16 (y and the final state); returns the worst max abs error per
    dtype."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as K

    worst = {}

    def check(label, dtype, got, want, names=("y", "state")):
        atol, rtol = SSD_TOL[str(dtype).replace("torch.", "")]
        errs = []
        for g, w, what in zip(got, want, names):
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

    def check_passes(label, dtype, x, dt, a, bm, cm, d):
        """Each pass's kernel against its plain pass, on the plain pass's
        own inputs."""
        ds, dec = ref.ssd_chunk_states(x, dt, a, bm)
        s_in, fin = ref.ssd_state_passing(ds, dec)
        got = K.chunk_states(x, dt, a, bm)
        e1 = check(f"chunk pass {label} {dtype}", dtype, got, (ds, dec),
                   ("dS", "decay"))
        got = K.state_passing(ds.clone(), dec)
        e2 = check(f"state pass {label} {dtype}", dtype, got, (s_in, fin),
                   ("S_in", "state"))
        y = ref.ssd_chunk_outputs(x, dt, a, bm, cm, d, s_in)
        got = K.chunk_outputs(x, dt, a, bm, cm, d, s_in)
        e3 = check(f"output pass {label} {dtype}", dtype, (got, fin),
                   (y, fin))
        log(f"kernel ssd_scan passes {dtype} {label} against their plain "
            f"passes: chunk pass max abs err dS {e1[0]:.3e}, decay "
            f"{e1[1]:.3e}; state pass S_in {e2[0]:.3e}, final {e2[1]:.3e}; "
            f"output pass y {e3[0]:.3e}")

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
        # the indexing paths: P tiles, N padding, rows staged one by one;
        # the wrapper's geometry says each case reaches its path
        for i, (case, views, tiles, npad) in enumerate(SSD_PATH_CASES):
            x, dt, a, bm, cm, d = _ssd_inputs(case, dtype, dev, 90 + i)
            if views:
                x, bm, cm = _unaligned_views(x, bm, cm)
            p, n = case[3], case[4]
            pw = min(p, 64 if p % 32 == 0 else 48)
            geom = K._check(x, dt, a, bm, cm, d, case[5])
            if (tuple(min(pw, p - p0) for p0 in range(0, p, pw)) != tiles
                    or -(-n // 16) * 16 != npad or geom["vec"] != (not views)):
                raise AssertionError(
                    f"ssd_scan path case {case}: P tiles, padded N or row "
                    f"staging ({geom['vec']}) not the path it was chosen for")
            label = (f"B,S,H,P,N,chunk={case[:6]} P tiles {tiles}, N padded "
                     f"to {npad}, rows {'unaligned views' if views else 'aligned'}")
            got = K.ssd_scan(x, dt, a, bm, cm, d, chunk=case[5])
            want = ref.ssd_scan(x, dt, a, bm, cm, d)
            ey, es = check(f"path {case} {dtype}", dtype, got, want)
            log(f"kernel ssd_scan {dtype} {label}: max abs err y {ey:.3e}, "
                f"state {es:.3e}")
            check_passes(label, dtype, x, dt, a, bm, cm, d)
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
    # each pass's kernel against its plain pass at the main shape
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, a, bm, cm, d = _ssd_inputs(SSD_MAIN, dtype, dev, 71)
        check_passes(f"B,S,H,P,N={SSD_MAIN[:5]}", dtype, x, dt, a, bm, cm, d)
        del x, bm, cm
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
    combine).  Their rate is that of fp32-accurate products on the tensor
    cores, ``PEAK_3XTF32_FLOPS``, as for flash.  Bytes: fp32 x and y, b and
    c read once, dt, a, d_skip and the final state."""
    b, s, h, p, n, _, _ = case
    flops = b * s * h * (5 * n * p + 3 * p + 2)
    nbytes = 4 * (2 * b * s * h * p + 2 * b * s * n + b * s * h + 2 * h
                  + b * h * n * p)
    return flops, nbytes


def phase_ssd_timing(dev) -> dict:
    """Kernel and plain ms (CUDA graphs) and bound of the SSD scan at the
    main shape, at [8, 4096] with the same widths and at zamba2-7b's
    shape, fp32, and each pass's device time under the profiler.  No single PyTorch call computes the
    scan: the library column is none."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as K

    timed = {}
    for label, case, iters in (("main", SSD_MAIN, 10),
                               ("large", SSD_LARGE, 4),
                               ("zamba2", SSD_ZAMBA2, 4)):
        x, dt, a, bm, cm, d = _ssd_inputs(case, torch.float32, dev, 80)
        flops, nbytes = _ssd_cost(case)
        bound, by = _bound(nbytes, flops, PEAK_3XTF32_FLOPS)
        row = {"shape": case[:6],
               "ms": _time_ms(lambda: K.ssd_scan(x, dt, a, bm, cm, d),
                              iters),
               "plain_ms": _time_ms(lambda: ref.ssd_scan(x, dt, a, bm, cm,
                                                         d), 1, reps=3),
               "bound_ms": bound, "bound_by": by, "library_ms": None,
               "flops": flops, "bytes": nbytes,
               "dispatch_ms": _dispatch_ms(lambda: K.ssd_scan(
                   x, dt, a, bm, cm, d))}
        before = dict(K.LAUNCHES)
        K.ssd_scan(x, dt, a, bm, cm, d)
        row["launches_per_call"] = {k: K.LAUNCHES[k] - before[k]
                                    for k in before}
        _, row["passes"] = _profile_kernels(
            dev, lambda: K.ssd_scan(x, dt, a, bm, cm, d), reps=5)
        timed[label] = row
        log(f"time ssd_scan {label} B,S,H,P,N,chunk={case[:6]} fp32: kernel "
            f"{row['ms']:.6f} ms (CUDA graph of {iters} calls), plain "
            f"{row['plain_ms']:.6f} ms (sequential over S, CUDA graph of 1 "
            f"call), library: none, bound {bound:.6f} ms ({by}: "
            f"{flops} flop at 165 TFLOP/s, {nbytes} B), "
            f"{flops / row['ms'] / 1e9:.2f} "
            f"TFLOP/s; kernel with eager dispatch {row['dispatch_ms']:.6f} "
            f"ms; launches per call {row['launches_per_call']}; by pass "
            f"(profiler, eager) "
            + ", ".join(f"{k} {v:.6f} ms" for k, v in row["passes"].items()))
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
    _expect_launches("mamba prefill", counts, _ssd_launches(cfg.n_layers))
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
                     _ssd_launches(cfg.n_layers))
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
                         ops.launch_counts(), _ssd_launches(want_n))
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
    ours = [r for r in rows if any(k in r[0] for k in SSD_DEVICE_NAMES)]
    ssd_ms = sum(r[1] for r in ours)
    log(f"profile mamba prefill {cfg.name} tokens {list(tokens.shape)} "
        f"(profiler on): wall {wall_ms:.3f} ms, device kernel time "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.2f}% busy), "
        f"{sum(r[2] for r in rows)} device activities; ssd_scan (all "
        f"three kernels) {ssd_ms:.4f} ms ({100 * ssd_ms / busy:.2f}% of "
        f"device time)")
    for key, ms, count in rows[:12] + [r for r in ours if r not in rows[:12]]:
        log(f"profile mamba device {ms:10.4f} ms {count:6d}x "
            f"{ms / count * 1e3:9.3f} us each  {key[:80]}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "profile_mamba.json").write_text(json.dumps(
        {"wall_ms": wall_ms, "device_ms": busy,
         "device": [{"name": k, "ms": m, "count": c} for k, m, c in rows]},
        indent=1))


# ---------------------------------------------------------------------------
# lm (slice 6b-ii): decentralized LM training, its consensus export, served
# ---------------------------------------------------------------------------

LM_PRESET = "lm100m_ring8_alpha0.1_qg"
#: the hold against the JAX package: the preset cut in depth only to
#: LM_REF_LAYERS layers (widths, vocab, data, nodes and optimizer as
#: published), LM_REF_STEPS steps from one node's init drawn with numpy
#: (``lm_numpy_init``, seed LM_INIT_SEED) on every node, in both packages.
#: The losses of its steps and the L2 norm of each node-stacked param leaf
#: after the last step, from ``python scripts/lm_ref.py`` (the JAX package
#: on the CPU, JAX 0.9.0; PERF.md §6 names the run)
LM_REF_LAYERS, LM_REF_STEPS, LM_INIT_SEED = 2, 3, 0
LM_REF = {
    "loss": [9.500361442565918, 9.520804405212402, 9.550020217895508],
    "norms": {
        "blocks/0/attn/wk": 64.0906687385301,
        "blocks/0/attn/wo": 110.76231648000923,
        "blocks/0/attn/wq": 110.84583571082473,
        "blocks/0/attn/wv": 63.93617249284141,
        "blocks/0/ln1": 0.007976513688287588,
        "blocks/0/ln2": 0.0052864870453360425,
        "blocks/0/mlp/down": 110.82854475888728,
        "blocks/0/mlp/gate": 180.8043918337183,
        "blocks/0/mlp/up": 181.13025930909242,
        "embed": 141.87314761951438,
        "final_norm": 0.005275827790312906,
        "lm_head": 255.9796229614576}}
#: card (cuBLAS, fp32, TF32 off) against the JAX package's CPU run: the
#: same arithmetic summed in other orders by two BLAS libraries over three
#: steps, on losses of order 9 and norms of 0.005 to 256
LM_REF_RTOL = 1e-5
#: the preset's run: its steps, and the window of its last steps whose mean
#: training loss QG-DSGDm-N must bring below the uniform predictor's ln V
#: and below its first step's loss
LM_STEPS, LM_TAIL = 200, 20
#: the exported model's prefill, kernel path against the chunked path
LM_PREFILL_SHAPE = (2, 512)


def lm_numpy_init(leaves, seed: int = LM_INIT_SEED) -> list:
    """One node's LM init at ``init_lm``'s scales, drawn with numpy so that
    both packages can start from it: ``leaves`` is ``[(path, shape)]`` in
    ``jax.tree`` order (dict keys sorted, tuple entries in order), each
    path a tuple ending in the leaf's name.  Norm weights and biases are
    zeros, ``embed`` is N(0, 1) x 0.02, every other weight ``[..., d_in,
    d_out]`` is N(0, 1) / sqrt(d_in); fp32."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for path, shape in leaves:
        name = str(path[-1])
        if name.startswith(("ln", "b")) or name == "final_norm":
            out.append(np.zeros(shape, np.float32))
            continue
        scale = 0.02 if name == "embed" else 1.0 / math.sqrt(shape[-2])
        out.append((rng.standard_normal(shape) * scale).astype(np.float32))
    return out


def lm_ref_spec(spec):
    """``spec`` cut to the hold's depth and steps, every step logged."""
    kw = dict(spec.model.kwargs)
    kw["overrides"] = {**kw["overrides"], "n_layers": LM_REF_LAYERS}
    return spec.override("model.kwargs=" + json.dumps(kw),
                         f"loop.steps={LM_REF_STEPS}", "loop.log_every=1")


def _lm_numpy_state(ex):
    """``ex``'s initial state with every node at ``lm_numpy_init``."""
    import torch
    from repro_torch.tree import tree_flatten, tree_paths, tree_unflatten

    leaves, treedef = tree_flatten(ex.state.params)
    arrays = lm_numpy_init([(p, tuple(x.shape[1:])) for p, x in
                            zip(tree_paths(ex.state.params), leaves)])
    one = tree_unflatten(treedef, [torch.from_numpy(a) for a in arrays])
    return ex.trainer.init(lambda _gen: (one, {}), None)


def _leaf_norms(params) -> dict:
    """Each leaf's L2 norm, summed in fp64: an fp32 sum over a leaf of 50M
    entries is off by 0.4% on the CPU."""
    import torch
    from repro_torch.tree import tree_leaves, tree_paths
    return {"/".join(map(str, p)): float(torch.linalg.vector_norm(
        x.double())) for p, x in zip(tree_paths(params), tree_leaves(params))}


def _lm_step_checks(dev, cfg, n: int) -> tuple[dict, dict]:
    """``qg_step`` on the LM's tree (12 leaves, 503,420,928 fp32 elements
    node-stacked): one launch, every leaf on float4, bit-equal to the
    node-order composition and within STEP_ULP of ``ref.qg_step`` (QG with
    the refresh gate on and off, DSGDm; wd 1e-4, Nesterov, the preset's
    lr); then timed beside its plain version, the sequence it replaces and
    its bound (5 streams of the tree over the memory rate)."""
    import torch
    from repro_torch.core import optim
    from repro_torch.kernels import qg_update as K
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    shapes = [(n, *x.shape) for x in
              tree_leaves(tf.init_lm(None, cfg, device="meta"))]
    gen = torch.Generator(device=dev).manual_seed(22)
    roles = [{f"l{i:02d}": torch.randn(s, generator=gen, device=dev)
              for i, s in enumerate(shapes)} for _ in range(3)]
    xs, ms, gs = (list(r.values()) for r in roles)
    elems = sum(t.numel() for t in xs)
    w = _step_mixing(n, dev)
    eta = _full(0.02, torch.empty(0, device=dev))
    worst = {"ulp": 0.0, "abs": 0.0, "m_abs": 0.0, "cases": 0}
    for mu, rf in ((0.9, 1.0), (0.9, 0.0), (None, 1.0)):
        kw = dict(beta=0.9, wd=1e-4, nesterov=True, mu=mu)
        refresh = _full(rf, eta)
        before = (K.LAUNCHES["qg_step"], *K.STEP_PATHS.values())
        got = K.qg_step(xs, ms, gs, w, eta, refresh, **kw)
        ran = tuple(a - b for a, b in zip(
            (K.LAUNCHES["qg_step"], *K.STEP_PATHS.values()), before))
        if ran != (1, len(shapes), 0):
            raise AssertionError(f"qg_step at the LM's tree: (launches, "
                                 f"vector, scalar) {ran}, want "
                                 f"(1, {len(shapes)}, 0)")
        _step_compare(f"LM tree mu={mu} refresh={rf}", got,
                      ref.qg_step(xs, ms, gs, w, eta, refresh, **kw),
                      _node_order_step(xs, ms, gs, w, eta, refresh, **kw),
                      (xs, ms, gs, w, eta, kw), worst)
        del got
        torch.cuda.empty_cache()
    log(f"kernel qg_step at the LM's tree ({len(shapes)} leaves, {elems} "
        f"elements, {n} nodes): one launch, every leaf on float4, "
        f"{worst['cases']} leaves x 2 outputs bit-equal to the node-order "
        f"composition; x_new within {worst['ulp']:.2f} ulp of ref.qg_step "
        f"at sum|W||half| (allowed {STEP_ULP}), max abs err "
        f"{worst['abs']:.3e}, m_out {worst['m_abs']:.3e}")

    one = _full(1.0, eta)
    timed = {}
    for form, mu in (("qg", 0.9), ("dsgdm", None)):
        kw = dict(beta=0.9, wd=1e-4, nesterov=True, mu=mu)
        stages = optim.make_optimizer(
            "qg_dsgdm_n" if mu else "dsgdm_n", weight_decay=1e-4)._stages()
        kfn = lambda: K.qg_step(xs, ms, gs, w, eta, one, **kw)
        pfn = lambda: ref.qg_step(xs, ms, gs, w, eta, one, **kw)
        seq = _replaced_sequence(stages, *roles, w, eta)
        kms, pms, sms = (_time_ms(f, 2, reps=5) for f in (kfn, pfn, seq))
        torch.cuda.empty_cache()
        nbytes = 5 * elems * 4 + 4 * n * n + 8
        bound, by = _bound(nbytes, (8 + 2 * n - 1 + (5 if mu else 0))
                           * elems)
        timed[form] = {"size": "lm", "ms": kms, "plain_ms": pms,
                       "replaced_ms": sms, "bound_ms": bound,
                       "bound_by": by, "bytes": nbytes}
        log(f"time qg_step {form} at the LM's tree: kernel {kms:.6f} ms "
            f"({kms / bound:.3f}x bound), plain {pms:.6f} ms, replaced "
            f"sequence {sms:.6f} ms (CUDA graphs of 2 calls), bound "
            f"{bound:.6f} ms ({by}, {nbytes} B), "
            f"{nbytes / kms / 1e6:.1f} GB/s, library: none")
    del roles, xs, ms, gs
    torch.cuda.empty_cache()
    return worst, timed


def _lm_hold(dev, spec, task) -> dict:
    """The preset cut to LM_REF_LAYERS layers, LM_REF_STEPS steps from the
    numpy init, against the JAX package's LM_REF (LM_REF_RTOL); ``task``
    is the preset's data (the cut leaves the data as it is)."""
    import numpy as np
    from repro_torch import api
    from repro_torch.kernels import ops

    ref_spec = lm_ref_spec(spec)
    state = _lm_numpy_state(api.build(ref_spec, device=dev, task=task))
    ops.reset_launch_counts()
    res, final = api.run(ref_spec, device=dev, state=state,
                         with_state=True, log_fn=lambda *_: None, task=task)
    counts = ops.launch_counts()
    _expect_launches("lm hold", counts, {"qg_step": LM_REF_STEPS})
    got = {"loss": [r["loss"] for r in res.history],
           "norms": _leaf_norms(final.params)}
    if LM_REF is None:
        raise AssertionError(f"LM_REF is not pinned; this run gives {got}")
    if sorted(got["norms"]) != sorted(LM_REF["norms"]):
        raise AssertionError(f"lm hold: leaves {sorted(got['norms'])} vs "
                             f"LM_REF's {sorted(LM_REF['norms'])}")
    np.testing.assert_allclose(got["loss"], LM_REF["loss"],
                               rtol=LM_REF_RTOL, err_msg="lm hold losses")
    keys = sorted(LM_REF["norms"])
    np.testing.assert_allclose([got["norms"][k] for k in keys],
                               [LM_REF["norms"][k] for k in keys],
                               rtol=LM_REF_RTOL, err_msg="lm hold norms")
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(got["loss"] + [got["norms"][k] for k in keys],
                  LM_REF["loss"] + [LM_REF["norms"][k] for k in keys]))
    log(f"lm hold ({LM_REF_LAYERS} layers at the preset's widths, "
        f"{LM_REF_STEPS} steps from the numpy init): losses {got['loss']} "
        f"and {len(keys)} leaf norms within {rel:.3e} relative of the JAX "
        f"package's (allowed {LM_REF_RTOL}); launches {counts}")
    return {"launches": counts, "rel": rel}


def _lm_cli_run(path: Path, ckpt: Path):
    """``python -m repro_torch.api lm100m_ring8_alpha0.1_qg
    --export-consensus <path> --checkpoint <ckpt> --out <json>`` in this
    process (every step logged; its output to build/chip_smoke/
    lm_train.log): returns the run's Result, read back from the JSON.  The
    checkpoint holds the final TrainState, against which the export is
    held."""
    import contextlib
    from repro_torch import api
    from repro_torch.api.__main__ import main as api_main

    out = OUT / "lm_train.json"
    with open(OUT / "lm_train.log", "w") as f, contextlib.redirect_stdout(f):
        api_main([LM_PRESET, "--set", "loop.log_every=1",
                  "--export-consensus", str(path), "--checkpoint", str(ckpt),
                  "--out", str(out)])
    res = api.Result(**json.loads(out.read_text()))
    out.unlink()
    return res


def phase_lm(dev) -> dict:
    """Slice 6b-ii's main path on the preset at its published widths (8
    nodes x 62,927,616 parameters): the data generator's host time;
    ``qg_step`` on the LM's tree; the hold against the JAX package
    (LM_REF); QG-DSGDm-N for LM_STEPS steps through ``python -m
    repro_torch.api ... --export-consensus ... --checkpoint ...`` and
    DSGDm-N through ``api.run``, one ``qg_step`` a step and no other
    kernel; the export bit-equal to the node mean of the final state that
    the checkpoint holds; the training loop under
    the profiler; the export served through ``python -m repro_torch.serve
    --checkpoint ... --use-pallas --requests 16`` and held as the serving
    phase holds TinyLlama, and its [2, 512] prefill through the flash
    kernel against the chunked path.  The data is drawn twice: once here,
    timed and shared by the runs through ``api.run``, and once by the
    CLI."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.api import data as D
    from repro_torch.api.models import resolve_transformer_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.serve import (consensus_params, load_serving_checkpoint,
                                   params_from_train_checkpoint,
                                   resolve_config)
    from repro_torch.serve.__main__ import main as serve_main
    from repro_torch.serve.__main__ import make_requests
    from repro_torch.tree import tree_flatten, tree_leaves, tree_paths

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("lm: TF32 is on")
    spec = api.presets.get(LM_PRESET)
    cfg = resolve_transformer_config(spec.model)
    n = spec.topology.n
    out = {"launches": {}}
    t0 = time.perf_counter()
    task = D.build_task(spec, n)
    gen_s = time.perf_counter() - t0
    log(f"lm data: make_lm_domains ({task.meta['n_domains']} domains x "
        f"{task.meta['n_seq_per_domain']} sequences, vocab "
        f"{task.meta['vocab']}) and the Dirichlet split took {gen_s:.3f} s "
        f"of host time; heterogeneity {task.meta['heterogeneity']}")
    out["step_worst"], out["step_timed"] = _lm_step_checks(dev, cfg, n)

    OUT.mkdir(parents=True, exist_ok=True)
    path, ckpt = OUT / "lm.npz", OUT / "lm_state.npz"
    out["hold"] = _lm_hold(dev, spec, task)
    _add_counts(out["launches"], out["hold"]["launches"])
    runs = {}
    for name in ("qg_dsgdm_n", "dsgdm_n"):
        ops.reset_launch_counts()
        if name == "qg_dsgdm_n":
            res = _lm_cli_run(path, ckpt)
        else:
            res = api.run(spec.override(f"optim.name={name}",
                                        "loop.log_every=1"),
                          device=dev, log_fn=lambda *_: None, task=task)
        counts = ops.launch_counts()
        _expect_launches(f"lm {name}", counts, {"qg_step": LM_STEPS})
        _add_counts(out["launches"], counts)
        _finite_run(f"lm {name}", res, LM_STEPS)
        runs[name] = res
        losses = [r["loss"] for r in res.history]
        log(f"lm {name}: {LM_STEPS} steps in {res.wall_time_s:.4f} s "
            f"({res.wall_time_s / LM_STEPS * 1e3:.4f} ms/step), first "
            f"loss {losses[0]:.6f}, mean of the last {LM_TAIL} "
            f"{np.mean(losses[-LM_TAIL:]):.6f}, final loss "
            f"{losses[-1]:.6f}, consensus {res.final['consensus']:.6e}, "
            f"launches {counts}")
    losses = [r["loss"] for r in runs["qg_dsgdm_n"].history]
    tail = float(np.mean(losses[-LM_TAIL:]))
    if not tail < min(math.log(cfg.vocab_size), losses[0]):
        raise AssertionError(
            f"lm QG-DSGDm-N: mean loss of the last {LM_TAIL} steps "
            f"{tail} is not below ln V = {math.log(cfg.vocab_size)} and "
            f"the first step's {losses[0]}")
    out["runs"] = runs
    out["profile"] = phase_profile(
        dev, "lm", spec.override(f"loop.steps={PROFILE_STEPS // 2}"),
        steps=PROFILE_STEPS // 2, task=task)
    del task

    # the export: the node mean of the final state (from the CLI run's
    # checkpoint, which keeps no container without a leaf: the empty
    # `tail`), bit for bit, in the model's own tree, with the config
    got, got_cfg = load_serving_checkpoint(str(path), device=dev)
    want = consensus_params(params_from_train_checkpoint(str(ckpt),
                                                         device=dev))
    got_leaves, got_def = tree_flatten(got)
    if got_def != tree_flatten(tf.init_lm(None, cfg, device="meta"))[1] \
            or tree_paths(got) != tree_paths(want) \
            or got_cfg != resolve_config(spec) or not all(
                torch.equal(a, b) for a, b in zip(got_leaves,
                                                  tree_leaves(want))):
        raise AssertionError("lm export: the serving checkpoint differs "
                             "from consensus_params of the final state")
    log(f"lm export: {path.name} ({path.stat().st_size} B) = consensus "
        f"params of the final state ({ckpt.name}, {ckpt.stat().st_size} "
        f"B) bit for bit, {len(got_leaves)} leaves, config {got_cfg.name}")
    ckpt.unlink()
    del want
    torch.cuda.empty_cache()

    # serving the export, through the CLI, then held
    row = serve_main(["--checkpoint", str(path), "--use-pallas",
                      "--requests", str(SERVE_REQUESTS)])
    log(f"lm serve CLI: {row}")
    reqs = make_requests(SERVE_REQUESTS, got_cfg.vocab_size, seed=SERVE_SEED,
                         max_new=SERVE_MAX_NEW)
    out["serve"] = phase_serve(dev, got_cfg, got, reqs)
    out["prefill"] = phase_prefill(dev, got_cfg, got, LM_PREFILL_SHAPE)
    out["serve_cli"] = row
    path.unlink()
    del got
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the scenario engine (slice 8a): 1024 nodes, generated graphs, churn
# ---------------------------------------------------------------------------

N1024_PRESETS = ("n1024_ring", "n1024_powerlaw", "n1024_churn")
N1024_STEPS = 40
#: the JAX package's final test accuracy of each preset at seed 0, 1 and 2
#: (``PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/n1024_ref.py``, JAX
#: 0.9.0 on the CPU); the card's run is held to the seed range widened by
#: ACC_ATOL, as CIFAR_QG_BAND is (the port's init comes from a
#: torch.Generator, ROADMAP C4)
N1024_ACC = {
    "n1024_ring": (0.3004636764526367, 0.3342738151550293,
                   0.3458743095397949),
    "n1024_powerlaw": (0.859400749206543, 0.892737865447998,
                       0.8979334831237793),
    "n1024_churn": (0.534548282623291, 0.5799393653869629,
                    0.6151485443115234)}
N1024_BAND = {p: (min(v) - ACC_ATOL, max(v) + ACC_ATOL)
              for p, v in N1024_ACC.items()}
#: (alive_frac, mix_frac) of each of n1024_churn's 40 steps in the JAX
#: package's runs (scripts/n1024_ref.py; they depend on scenario.seed only):
#: the masks are threefry draws the port reproduces bit for bit, so the
#: card's history is held to them exactly
N1024_CHURN_FRACS = (
    (0.7109375, 0.6640625), (0.7421875, 0.69921875),
    (0.724609375, 0.69140625), (0.7373046875, 0.6982421875),
    (0.7158203125, 0.68359375), (0.7041015625, 0.673828125),
    (0.7265625, 0.6962890625), (0.7236328125, 0.689453125),
    (0.7158203125, 0.677734375), (0.7138671875, 0.681640625),
    (0.703125, 0.67578125), (0.7119140625, 0.6796875),
    (0.71875, 0.685546875), (0.7109375, 0.6591796875),
    (0.6943359375, 0.6611328125), (0.7392578125, 0.7060546875),
    (0.7109375, 0.6796875), (0.708984375, 0.671875),
    (0.728515625, 0.693359375), (0.724609375, 0.6865234375),
    (0.73828125, 0.6982421875), (0.7353515625, 0.7109375),
    (0.75390625, 0.720703125), (0.7294921875, 0.6953125),
    (0.73046875, 0.6875), (0.7236328125, 0.69140625),
    (0.7138671875, 0.677734375), (0.7138671875, 0.681640625),
    (0.7314453125, 0.705078125), (0.7255859375, 0.6875),
    (0.7158203125, 0.673828125), (0.7216796875, 0.6845703125),
    (0.72265625, 0.689453125), (0.728515625, 0.697265625),
    (0.7255859375, 0.6904296875), (0.7216796875, 0.689453125),
    (0.7275390625, 0.6826171875), (0.7197265625, 0.6875),
    (0.7060546875, 0.6787109375), (0.7060546875, 0.6669921875))
#: more than qg_update.STEP_MAX_NODES nodes, and under a scenario a masked
#: mix hook: the QG-DSGDm-N chain takes the two-kernel path, one
#: fused_halfstep and one fused_qg_buffer a step, and no qg_step
N1024_LAUNCHES = {"fused_halfstep": N1024_STEPS,
                  "fused_qg_buffer": N1024_STEPS}
#: card against the port on the CPU: n1024_churn's first steps, TF32 off,
#: final params within this relative distance
N1024_CPU_STEPS, N1024_CPU_RTOL = 5, 1e-5


def _n1024_cli_run(preset: str, dev):
    """``python -m repro_torch.api <preset> --device <dev> --out <json>`` in
    this process (its output to build/chip_smoke/<preset>.log); returns
    the Result read back from the JSON."""
    import contextlib
    from repro_torch import api
    from repro_torch.api.__main__ import main as api_main

    OUT.mkdir(parents=True, exist_ok=True)
    out = OUT / f"{preset}.json"
    args = [preset, "--device", str(dev), "--out", str(out)]
    with open(OUT / f"{preset}.log", "w") as f, contextlib.redirect_stdout(f):
        api_main(args)
    res = api.Result(**json.loads(out.read_text()))
    out.unlink()
    return res


def _max_rel(a_tree, b_tree) -> float:
    """Largest leaf-wise max |a - b| / max |b| of two trees of tensors."""
    from repro_torch.tree import tree_leaves
    return max(float((a.cpu() - b.cpu()).abs().max() / b.abs().max())
               for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree),
                               strict=True))


def _n1024_kernels(dev) -> tuple[dict, dict]:
    """B1 and B2 at the n1024 presets' packed shape (1024 nodes x 13,652
    parameters) against their plain versions (0 ulp) and timed beside
    their bound; the dense [1024, 1024] mix of the MLP's tree, the masked
    one and ``mask_renormalize`` timed beside the mix's bound.  Returns
    (worst errors, timings)."""
    import torch
    from repro_torch import api
    from repro_torch.core import gossip
    from repro_torch.kernels import pack as P
    from repro_torch.kernels import qg_update as K
    from repro_torch.kernels import ref
    from repro_torch.tree import tree_leaves

    ex = api.build(api.presets.get("n1024_churn"), device=dev)
    params = ex.state.params
    n = ex.trainer.topology.n
    per_node = sum(l[0].numel() for l in tree_leaves(params))
    size = P.plan_pack(params).padded
    gen = torch.Generator(device=dev).manual_seed(23)
    a, b, c = (torch.randn(size, generator=gen, device=dev)
               for _ in range(3))
    eta, one = _full(0.1, a), _full(1.0, a)
    worst, timed = {}, {}
    for name, case, k, p in _cases():
        if name in ("fused_halfstep", "fused_qg_buffer"):
            _compare(name, f"{case} n1024 size={size}", k(a, b, c, eta),
                     p(a, b, c, eta), worst)
    for name, w in worst.items():
        log(f"scenario kernel {name} at the n1024 shape ({n} x {per_node} "
            f"packed to {size}): {w['cases']} outputs, max {w['ulp']} ulp, "
            f"max abs err {w['abs']:.3e}")
    timed["fused_halfstep"] = _time_row(
        "fused_halfstep[n1024]", size,
        lambda: K.fused_halfstep(a, b, c, eta, beta=0.9, wd=1e-4,
                                 nesterov=True, emit_m=False),
        lambda: ref.fused_halfstep(a, b, c, eta, beta=0.9, wd=1e-4,
                                   nesterov=True)[0], 4 * size * 4 + 4,
        size, 20)
    timed["fused_qg_buffer"] = _time_row(
        "fused_qg_buffer[n1024]", size,
        lambda: K.fused_qg_buffer(a, b, c, eta, one, mu=0.9),
        lambda: ref.fused_qg_buffer(a, b, c, eta, one, mu=0.9),
        4 * size * 4 + 8, size, 20)
    del a, b, c
    # the mix: 2 n^2 P fp32 operations; W, x and the output once each
    w = ex.trainer._mixing[0]
    m = torch.from_numpy(ex.trainer.scenario.masks(12)[1]).to(dev)
    flops, nbytes = 2 * n * n * per_node, 4 * (n * n + 2 * n * per_node)
    bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S) * 1e3
    for label, fn in (
            ("dense mix", lambda: gossip.mix_dense(w, params)),
            ("masked mix", lambda: gossip.mix_dense(
                gossip.mask_renormalize(w, m), params)),
            ("mask_renormalize", lambda: gossip.mask_renormalize(w, m))):
        timed[label] = _time_ms(fn, 10)
        log(f"time scenario {label} at n={n} ({per_node} parameters a "
            f"node): {timed[label]:.6f} ms (CUDA graph of 10 calls); the "
            f"mix's bound {bound:.6f} ms (operations, {flops} fp32 "
            f"operations; bytes {nbytes / PEAK_BYTES_S * 1e3:.6f} ms)")
    timed["mix_bound_ms"] = bound
    del ex, params
    torch.cuda.empty_cache()
    return worst, timed


def phase_scenario(dev) -> dict:
    """Slice 8a's main path: the three n1024 presets (1024 nodes, the MLP at
    its preset widths, 40 steps) through ``python -m repro_torch.api``,
    each with exactly N1024_LAUNCHES; final accuracy in N1024_BAND and
    powerlaw > churn > ring; n1024_churn's alive/mix fractions equal to the
    JAX package's (N1024_CHURN_FRACS), all 40 steps through the chunked
    loop; B1/B2 at the presets' shape against their plain versions and
    timed, with the dense and the masked mix; card against the port on the
    CPU (N1024_CPU_STEPS, N1024_CPU_RTOL); DSGDm-N on n1024_churn beside
    QG-DSGDm-N; each preset's loop under the profiler (ms/step, busy
    share); the host time of the presets' data (built once, and a batch
    for 1024 nodes)."""
    import torch
    from repro_torch import api
    from repro_torch.api.data import build_task
    from repro_torch.kernels import ops

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("scenario: TF32 is on")
    quiet = lambda *_: None
    out = {"launches": {}, "results": {}}
    # warm-up (cuBLAS at the [1024, 1024] mix); not the main path's
    api.run(api.presets.get("n1024_ring").override("loop.steps=3",
                                                   "eval.enabled=false"),
            device=dev, log_fn=quiet)
    worst, timed = _n1024_kernels(dev)
    out["worst"], out["timed"] = worst, timed
    t0 = time.perf_counter()
    task = build_task(api.presets.get("n1024_churn"), 1024)
    build_s = time.perf_counter() - t0
    it = task.make_iter()
    t0 = time.perf_counter()
    for _ in range(N1024_STEPS):
        next(it)
    out["batch_ms"] = (time.perf_counter() - t0) / N1024_STEPS * 1e3
    log(f"scenario data: the n1024 task built in {build_s:.4f} s of host "
        f"time (heterogeneity {task.meta['heterogeneity']}); a batch for "
        f"1024 nodes {out['batch_ms']:.4f} ms of host time (mean of "
        f"{N1024_STEPS})")
    del task, it

    for preset in N1024_PRESETS:
        ops.reset_launch_counts()
        res = _n1024_cli_run(preset, dev)
        counts = ops.launch_counts()
        _expect_launches(preset, counts, N1024_LAUNCHES)
        _add_counts(out["launches"], counts)
        _finite_run(preset, res, N1024_STEPS)
        out["results"][preset] = res
        acc = res.final["acc"]
        lo, hi = N1024_BAND[preset]
        if not lo <= acc <= hi:
            raise AssertionError(f"{preset}: test acc {acc:.4f} outside the "
                                 f"JAX package's seed range widened by "
                                 f"{ACC_ATOL}, [{lo:.4f}, {hi:.4f}]")
        masks = ("none" if res.scenario is None else
                 f"{res.scenario['mask_host_ms_per_step']:.4f} ms/step")
        log(f"scenario {preset}: device {res.device}, {N1024_STEPS} steps "
            f"in {res.wall_time_s:.4f} s ({res.wall_time_s / N1024_STEPS
                                          * 1e3:.4f} ms/step), final loss "
            f"{res.final['loss']:.6f}, test acc {acc:.4f} (JAX package "
            f"{N1024_ACC[preset]}), consensus {res.final['consensus']:.3e}, "
            f"masks' host time {masks}, launches {counts}")
    acc = {p: r.final["acc"] for p, r in out["results"].items()}
    if not acc["n1024_powerlaw"] > acc["n1024_churn"] > acc["n1024_ring"]:
        raise AssertionError(f"scenario: accuracies {acc} are not ordered "
                             "powerlaw > churn > ring")

    # the churn run's masks: every step's fractions, through the chunked
    # loop (a chunk's masks in one copy), against the JAX package's
    churn = api.presets.get("n1024_churn")
    ops.reset_launch_counts()
    chunked = api.run(churn.override("loop.chunk=10", "loop.log_every=1",
                                     "eval.enabled=false"),
                      device=dev, log_fn=quiet)
    _expect_launches("n1024_churn chunked", ops.launch_counts(),
                     N1024_LAUNCHES)
    fracs = tuple((r["alive_frac"], r["mix_frac"]) for r in chunked.history)
    if fracs != N1024_CHURN_FRACS:
        bad = next(i for i, (a, b) in enumerate(zip(fracs,
                                                    N1024_CHURN_FRACS))
                   if a != b)
        raise AssertionError(f"n1024_churn: step {bad} fractions "
                             f"{fracs[bad]}, JAX package "
                             f"{N1024_CHURN_FRACS[bad]}")
    main = out["results"]["n1024_churn"].history
    rows = {r["step"]: r for r in chunked.history}
    for r in main:
        for k in ("alive_frac", "mix_frac"):
            if r[k] != rows[r["step"]][k]:
                raise AssertionError(f"n1024_churn step {r['step']}: {k} "
                                     "differs between the loops")
    gap = _history_close(main, [rows[r["step"]] for r in main], HIST_RTOL,
                         HIST_ATOL, "n1024_churn chunk 1 vs 10")
    log(f"scenario n1024_churn masks: all {N1024_STEPS} steps' alive/mix "
        f"fractions equal the JAX package's exactly (chunks of 10, "
        f"{chunked.scenario['mask_host_ms_per_step']:.4f} ms/step of host "
        f"time); the preset's loop at its logged steps within {gap:.3e}")

    # card against the port on the CPU
    spec = churn.override(f"loop.steps={N1024_CPU_STEPS}",
                          "loop.log_every=1", "eval.enabled=false")
    card, card_state = api.run(spec, device=dev, log_fn=quiet,
                               with_state=True)
    cpu, cpu_state = api.run(spec.override("optim.fused=kernel"),
                             device="cpu", log_fn=quiet, with_state=True)
    rel = _max_rel(card_state.params, cpu_state.params)
    hist = _history_close(card.history, cpu.history, CPU_RTOL, CPU_ATOL,
                          "n1024_churn card vs CPU")
    if rel > N1024_CPU_RTOL:
        raise AssertionError(f"n1024_churn card vs CPU: final params "
                             f"{rel:.3e} apart (relative), allowed "
                             f"{N1024_CPU_RTOL}")
    log(f"scenario n1024_churn card vs CPU, {N1024_CPU_STEPS} steps, TF32 "
        f"off: final params {rel:.3e} apart (relative, allowed "
        f"{N1024_CPU_RTOL}), history {hist:.3e}")
    out["cpu_rel"] = rel

    # DSGDm-N on n1024_churn beside QG-DSGDm-N (reported, not held)
    ops.reset_launch_counts()
    ds = api.run(churn.override("optim.name=dsgdm_n"), device=dev,
                 log_fn=quiet)
    counts = ops.launch_counts()
    _expect_launches("n1024_churn dsgdm_n", counts,
                     {"fused_halfstep": N1024_STEPS})
    _finite_run("n1024_churn dsgdm_n", ds, N1024_STEPS)
    log(f"scenario n1024_churn DSGDm-N: test acc {ds.final['acc']:.4f} "
        f"(QG-DSGDm-N {acc['n1024_churn']:.4f}), "
        f"{ds.wall_time_s / N1024_STEPS * 1e3:.4f} ms/step, launches "
        f"{counts}")
    out["dsgdm_acc"] = ds.final["acc"]
    out["profile"] = {p: phase_profile(dev, p, api.presets.get(p),
                                       steps=N1024_STEPS)
                      for p in N1024_PRESETS}
    return out


# ---------------------------------------------------------------------------
# lmstack (slice 6b-iii): granite-moe-3b, zamba2-7b and the VLM served
# ---------------------------------------------------------------------------

#: the three models at their published widths and depths, fresh seeded
#: inits, served through the entry points a user calls
LMSTACK_SEED = 0
MOE_ARCH, ZAMBA2_ARCH, VLM_ARCH = ("granite-moe-3b-a800m", "zamba2-7b",
                                   "llama-3.2-vision-11b")
#: zamba2's prefill: past the shared block's 4096-token window, so its
#: caches become ring buffers; then greedy decode steps from them
ZAMBA2_PREFILL, ZAMBA2_DECODE = (1, 4608), 32
#: zamba2's kernel path vs plain path, max |diff| / max |plain| of the
#: last logits and of every state and cache: MAMBA_TOL's reasoning (1e-6
#: relative a layer, carried) over 81 Mamba layers and 13 attention blocks
#: at d_model 3584, four times mamba2-130m's 24 layers: 4e-4
ZAMBA2_TOL = 4e-4
#: zamba2's serving CLI (each request's prompt and decode through the
#: baseline; 4 requests of 8 tokens, not phase 8's 16 of 16: a request is
#: 81 Mamba and 13 attention layers a token at these widths)
ZAMBA2_CLI = ("--requests", "4", "--max-new", "8")
#: ``python -m repro_torch.launch.serve --arch llama-3.2-vision-11b --full
#: --use-pallas --batch 2 --prompt-len 512 --gen-len 16``
VLM_ARGV = ("--arch", VLM_ARCH, "--full", "--batch", "2", "--prompt-len",
            "512", "--gen-len", "16")
#: the cross blocks' gates for the prefill that makes them work (0 at a
#: fresh init: a cross block is then the identity)
VLM_GATE = 0.5
#: the MoE's capacity factor at which nothing drops whatever the batch:
#: E / k, so a queue holds every token.  The engine (chunks of 32, decode
#: batches of 8 slots) and ``sequential_generate`` (the whole prompt, then
#: one token) call the layer on different token counts, so at the
#: published 1.25 their capacities, and so the pairs they drop, differ by
#: design (as in the reference); they are compared at this factor
MOE_NODROP = 40 / 8
#: a token's routing is at a near-tie when two neighbours among its first
#: k+1 router probabilities, sorted, lie within this of each other.  Two
#: fp32 paths whose hidden states are ~1e-6 relative apart move a
#: probability of ~1/40 by ~1e-8, so only such a token can be routed
#: differently by them (a margin of 1000)
ROUTE_TIE = 1e-5

#: the hold against the JAX package at the published widths, cut in depth:
#: granite at 2 layers; zamba2 at one period of 6 Mamba layers, the shared
#: block and 1 tail layer; the VLM at one period (4 dense + 1 cross) with
#: its gates at VLM_GATE and a numpy image.  A [1, LMSTACK_PROMPT] prompt's
#: prefill logits and LMSTACK_STEPS decode steps fed the reference's own
#: greedy tokens, each summarised (``_logit_summary``)
LMSTACK_CUTS = {
    MOE_ARCH: {"n_layers": 2},
    ZAMBA2_ARCH: {"n_layers": 7, "tail_layers": 1},
    VLM_ARCH: {"n_layers": 5},
}
LMSTACK_PROMPT, LMSTACK_STEPS, LMSTACK_INIT_SEED = 64, 4, 0
#: vocab ids whose logits the summaries keep (those below the vocab)
LMSTACK_IDS = (0, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377, 610, 987,
               1597, 2584, 4181, 6765, 10946, 17711, 28657)
#: the kernel path on the card against the JAX package's plain path on the
#: CPU: every kept logit and each step's max within this fraction of the
#: step's max |logit|, each L2 norm within it relatively.  The JAX
#: package's summaries (``logit_summary``) of the prefill and of each
#: decode step, from ``python3 scripts/lmstack_ref.py`` (JAX 0.9.0, CPU)
LMSTACK_REF_RTOL = 1e-4
LMSTACK_REF = {
    "granite-moe-3b-a800m": {"steps": [
        {"argmax": 7941, "max": 4.042235851287842, "gap": 0.13009381294250488,
         "norm": 222.75414918671936, "ids": [0.4338168501853943,
         1.1677639484405518, 0.6085978746414185, -0.4426231384277344,
         -2.2413907051086426, -0.6740031242370605, 1.6853935718536377,
         -0.5444608926773071, -0.9031731486320496, 0.7189224362373352,
         -1.7633683681488037, -0.47495752573013306, -0.6938111782073975,
         1.4334933757781982, -0.27820008993148804, 0.6806487441062927,
         -1.0267434120178223, -1.197601318359375, 0.01666616089642048,
         -0.3858315646648407, 0.8927720189094543, 0.5535333752632141,
         -0.07570365816354752]},
        {"argmax": 21536, "max": 4.111282825469971, "gap": 0.15941452980041504,
         "norm": 222.5485191192789, "ids": [0.563388466835022,
         0.9443179368972778, 1.5122703313827515, -0.03770468011498451,
         -2.615079164505005, -0.5171949863433838, 1.6739048957824707,
         -0.43386486172676086, -0.9560986161231995, 0.529414176940918,
         -1.8325875997543335, 1.4987035989761353, -0.47524869441986084,
         0.6217191815376282, 0.08918178826570511, 1.5002306699752808,
         -0.5252648591995239, -1.22169029712677, -0.004886351991444826,
         -1.25397789478302, 1.0552159547805786, -0.39153164625167847,
         0.525525689125061]},
        {"argmax": 10330, "max": 4.282423496246338, "gap": 0.10616016387939453,
         "norm": 222.89806338464916, "ids": [0.04779990762472153,
         1.475676417350769, 0.7887775897979736, -0.1208818331360817,
         -1.7625148296356201, -0.8257974982261658, 1.2608399391174316,
         -1.2388527393341064, -1.227564811706543, 0.03704047203063965,
         -1.5725007057189941, 1.0461065769195557, 0.08713459968566895,
         0.41130274534225464, 0.008975081145763397, 1.1079437732696533,
         -0.434017539024353, -1.4352123737335205, 0.6211256980895996,
         -0.8573053479194641, 1.6816514730453491, 0.9375139474868774,
         0.2516264319419861]},
        {"argmax": 28206, "max": 4.20757532119751, "gap": 0.2433300018310547,
         "norm": 222.81604507273158, "ids": [0.5609161257743835,
         0.571884274482727, 0.6888453960418701, 0.024080539122223854,
         -1.958909273147583, -1.2517547607421875, 1.379525065422058,
         -1.2475478649139404, -1.287090539932251, -0.45293551683425903,
         -2.181828022003174, 0.3641662001609802, -1.7883331775665283,
         1.3013733625411987, 0.9389112591743469, 1.245737075805664,
         -0.13179926574230194, -0.9463503360748291, -0.45880141854286194,
         -0.7919745445251465, -0.29829537868499756, -0.44352662563323975,
         0.6242026686668396]},
        {"argmax": 23166, "max": 4.534141540527344, "gap": 0.5990579128265381,
         "norm": 221.8579534422981, "ids": [-0.27624937891960144,
         0.8925999999046326, 1.8422437906265259, -0.3300141394138336,
         -2.486124038696289, -1.1194442510604858, 1.1690725088119507,
         -1.397897481918335, -1.3560222387313843, -0.699786901473999,
         -2.6749203205108643, 1.3577057123184204, -1.8836919069290161,
         0.9193515181541443, 2.0278007984161377, 0.1156373918056488,
         -0.2287083864212036, -1.605528712272644, 0.0708184689283371,
         -0.3949587345123291, 0.23516589403152466, -0.6682312488555908,
         0.22297890484333038]},
    ]},
    "zamba2-7b": {"steps": [
        {"argmax": 27375, "max": 3.8639209270477295, "gap":
         0.041521310806274414, "norm": 180.25599501420757, "ids":
         [0.02373177744448185, -0.15684448182582855, -1.1796035766601562,
         0.11407560855150223, -0.8958643674850464, 0.7159150242805481,
         0.6198077201843262, -0.8314208984375, 0.4668976962566376,
         0.7234764099121094, -0.5891366004943848, -0.6227280497550964,
         1.8946826457977295, -0.8198806047439575, -0.28267258405685425,
         -0.23657464981079102, -0.17752502858638763, -0.8444255590438843,
         -1.5794354677200317, 1.3275474309921265, 0.5216608047485352,
         0.1800132542848587, 0.22203312814235687]},
        {"argmax": 3493, "max": 4.266878604888916, "gap": 0.09894037246704102,
         "norm": 178.69639859218628, "ids": [-0.3529205024242401,
         -0.8769307136535645, -0.7413107752799988, -0.5608378052711487,
         -1.199480414390564, 0.6099365949630737, -0.10528995841741562,
         -0.19065912067890167, 0.6912882924079895, -0.33682501316070557,
         0.8988797068595886, 0.393993616104126, 1.9058483839035034,
         0.5493656396865845, -0.5118830800056458, -1.2549502849578857,
         0.5859304070472717, -0.6515659689903259, -0.6781728267669678,
         0.24317678809165955, -0.7341904640197754, -1.166408658027649,
         -0.0969700887799263]},
        {"argmax": 15792, "max": 4.066781520843506, "gap":
         0.002846240997314453, "norm": 178.46440092945315, "ids":
         [0.39775779843330383, 0.8721861243247986, 1.0925925970077515,
         -0.16913607716560364, 2.1103732585906982, -1.0811176300048828,
         -0.8292067050933838, 0.12555235624313354, 0.2191084623336792,
         0.7395487427711487, 0.2156975120306015, -1.8930299282073975,
         -0.8235856294631958, -0.804237425327301, 0.9003240466117859,
         1.6673731803894043, 0.6743721961975098, -0.23284021019935608,
         -1.3740555047988892, 2.374398946762085, 1.2178655862808228,
         -0.23499266803264618, 0.5198113918304443]},
        {"argmax": 25710, "max": 4.069038391113281, "gap": 0.05536985397338867,
         "norm": 177.36329995389292, "ids": [0.4102071225643158,
         -0.9769973754882812, -1.1005010604858398, 1.6707570552825928,
         0.6990869641304016, 0.4889041483402252, -0.5294325947761536,
         0.5966285467147827, 0.8559327721595764, 0.14730411767959595,
         -0.259381502866745, -1.7008799314498901, -0.17716403305530548,
         -0.9383240938186646, -1.2749216556549072, -0.5853092074394226,
         -1.7907845973968506, 1.0956653356552124, 1.116344690322876,
         2.881056785583496, -0.578610897064209, -0.0724346861243248,
         -0.692703366279602]},
        {"argmax": 15563, "max": 4.041348457336426, "gap":
         0.029593944549560547, "norm": 178.11520611674317, "ids":
         [0.5822663307189941, -0.9504144787788391, -2.0368218421936035,
         0.6875362396240234, 1.5609132051467896, -0.46436095237731934,
         -0.6094430088996887, -1.4506293535232544, 0.08573298156261444,
         0.4449988901615143, 2.450972557067871, -1.2767716646194458,
         0.27473533153533936, -0.5613285303115845, -1.3431013822555542,
         0.6359423995018005, 0.9176895022392273, -1.045824646949768,
         -0.06758055090904236, -0.8322902917861938, 1.6517211198806763,
         -0.3161458671092987, -0.4554425776004791]},
    ]},
    "llama-3.2-vision-11b": {"steps": [
        {"argmax": 94083, "max": 4.337123394012451, "gap": 0.17180538177490234,
         "norm": 357.8723608764825, "ids": [-0.6479260921478271,
         -2.663121461868286, 0.958908200263977, -1.5316293239593506,
         1.1643402576446533, 0.9789964556694031, 0.9028947353363037,
         -1.094961404800415, -1.1275949478149414, 0.9606682658195496,
         -0.8673987984657288, -0.48234298825263977, -1.2119853496551514,
         -0.7676910161972046, 1.1793009042739868, 0.16673330962657928,
         0.894627571105957, 0.6635720729827881, 0.043511006981134415,
         0.40194645524024963, -1.1070334911346436, 0.6572872400283813,
         0.3620244562625885]},
        {"argmax": 52491, "max": 4.46672248840332, "gap": 0.2407517433166504,
         "norm": 358.0825839882025, "ids": [-0.08048862963914871,
         -1.7727569341659546, 0.41525810956954956, -2.6322851181030273,
         2.16693115234375, 0.049020104110240936, 1.903626561164856,
         -0.25551462173461914, -1.7730257511138916, 0.7279111742973328,
         -0.856531023979187, -0.22427721321582794, -0.8394899368286133,
         -1.5648601055145264, 1.26499605178833, 0.08464999496936798,
         0.4023982286453247, -0.40223613381385803, -0.08305267244577408,
         0.6281812191009521, 0.459412544965744, 2.6770694255828857,
         -1.8947770595550537]},
        {"argmax": 93577, "max": 4.632907867431641, "gap": 0.21152782440185547,
         "norm": 357.5374699704258, "ids": [0.13815660774707794,
         -2.371467113494873, 1.7980060577392578, -1.582902431488037,
         1.5747712850570679, -0.8300033807754517, 0.3970271646976471,
         0.07163260877132416, -2.6401073932647705, 0.44459062814712524,
         -0.6193920969963074, 1.160721778869629, -1.3470590114593506,
         -1.2624009847640991, 0.5559188723564148, 0.29455873370170593,
         -0.3602457046508789, -0.3266570270061493, 0.8440657258033752,
         1.8725603818893433, -0.392213374376297, 2.0313539505004883,
         -2.0592081546783447]},
        {"argmax": 101954, "max": 4.220168590545654, "gap":
         0.23365497589111328, "norm": 357.2668030595092, "ids":
         [1.0461851358413696, -1.954432487487793, 1.8384865522384644,
         -1.3115732669830322, 1.9279415607452393, -0.3209068775177002,
         0.9028401374816895, 1.144805908203125, -1.2629566192626953,
         1.0796737670898438, -1.719508409500122, -1.7541084289550781,
         0.07212135195732117, -0.8292679786682129, -0.1972687989473343,
         1.3294308185577393, -0.6737215518951416, -0.23074065148830414,
         -0.1605897694826126, 0.5629621744155884, 0.6795561909675598,
         0.4217986762523651, -1.8769172430038452]},
        {"argmax": 81383, "max": 4.028499126434326, "gap":
         0.023155689239501953, "norm": 358.2102555424151, "ids":
         [1.7080953121185303, -2.8010449409484863, 1.3112622499465942,
         -1.88988196849823, 0.1831468641757965, -0.38064536452293396,
         0.7185935974121094, -0.8168721795082092, -1.8865416049957275,
         0.33726415038108826, -1.4257787466049194, -0.3875897228717804,
         0.29516541957855225, -2.2845304012298584, 1.2841018438339233,
         -1.1311711072921753, 0.9025591611862183, -1.0197110176086426,
         0.6106358766555786, -1.3352477550506592, -0.8857035636901855,
         0.8568865656852722, -0.873667299747467]},
    ]},
}

#: MoE training: the LM preset on reduced granite-moe-3b, LMSTACK_TRAIN
#: steps through ``api.run``, one ``qg_step`` a step; the card's losses
#: against the port's CPU run: (steps held, rtol).  All 20 steps: no
#: route flips between the two in them (the largest gap read on an H100
#: is 1.42e-07); a route that flips at a near-tie would part the runs
#: from that step on, as the chaotic Adam pair's do (ZOO_CHAOTIC)
LMSTACK_TRAIN = 20
LMSTACK_TRAIN_HELD = (LMSTACK_TRAIN, 1e-5)


def lmstack_cut(arch: str):
    """``arch`` at its published widths, cut in depth to LMSTACK_CUTS."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **LMSTACK_CUTS[arch])


#: elements a numpy generator draws in one piece of a leaf
LMSTACK_INIT_PIECE = 1 << 22


def lmstack_numpy_init(leaves, seed: int = LMSTACK_INIT_SEED):
    """One model's init at ``init_lm``'s scales, drawn leaf by leaf with
    numpy so that both packages can start from it: ``leaves`` is ``[(path,
    shape)]`` in ``jax.tree`` order, each path ending in the leaf's name;
    yields fp32 arrays.  Norm weights, biases, ``a_log`` and ``dt_bias``
    are zeros, ``d_skip`` ones, the cross gates VLM_GATE, ``embed`` N(0, 1)
    x 0.02, ``conv_w`` x 0.1, every other weight ``[..., d_in, d_out]``
    N(0, 1) / sqrt(d_in).  Piece ``j`` of leaf ``i`` (LMSTACK_INIT_PIECE
    elements) is ``Generator.standard_normal`` of its own PCG64 stream,
    seeded ``SeedSequence(seed, spawn_key=(i, j))``, so the pieces are
    drawn on every core at once and the values do not depend on how many
    there are."""
    import concurrent.futures
    import os

    import numpy as np

    def piece(flat, i, j, scale):
        gen = np.random.Generator(np.random.PCG64(
            np.random.SeedSequence(seed, spawn_key=(i, j))))
        view = flat[j * LMSTACK_INIT_PIECE:(j + 1) * LMSTACK_INIT_PIECE]
        gen.standard_normal(out=view, dtype=np.float32)
        view *= np.float32(scale)

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        for i, (path, shape) in enumerate(leaves):
            name = str(path[-1])
            if name.startswith(("ln", "b")) or name in (
                    "final_norm", "a_log", "dt_bias"):
                yield np.zeros(shape, np.float32)
                continue
            if name == "d_skip":
                yield np.ones(shape, np.float32)
                continue
            if name.startswith("gate_"):
                yield np.full(shape, VLM_GATE, np.float32)
                continue
            scale = {"embed": 0.02, "conv_w": 0.1}.get(
                name, 1.0 / math.sqrt(shape[-2]))
            out = np.empty(shape, np.float32)
            flat = out.reshape(-1)
            n = -(-flat.size // LMSTACK_INIT_PIECE)
            for f in [pool.submit(piece, flat, i, j, scale)
                      for j in range(n)]:
                f.result()
            yield out


def lmstack_inputs(cfg):
    """The hold's prompt [1, LMSTACK_PROMPT] and, for the VLM, its image
    [1, n_image_tokens, d_model], drawn with numpy."""
    import numpy as np
    rng = np.random.default_rng(LMSTACK_INIT_SEED + 1)
    prompt = rng.integers(0, cfg.vocab_size, size=(1, LMSTACK_PROMPT),
                          dtype=np.int32)
    img = None
    if cfg.n_image_tokens:
        img = rng.standard_normal((1, cfg.n_image_tokens, cfg.d_model),
                                  dtype=np.float32)
    return prompt, img


def logit_summary(logits) -> dict:
    """One step's logits [Vp] (numpy, fp32), summarised: argmax, max, L2
    norm (summed in fp64) and the values at LMSTACK_IDS."""
    import numpy as np
    x = np.asarray(logits, np.float64)
    top = np.sort(x)[-2:]
    return {"argmax": int(np.argmax(x)), "max": float(x.max()),
            "gap": float(top[1] - top[0]),
            "norm": float(np.linalg.norm(x)),
            "ids": [float(x[i]) for i in LMSTACK_IDS if i < len(x)]}


def _lmstack_params(cfg, dev):
    """The numpy init of ``cfg`` as tensors on ``dev``, copied leaf by leaf
    (the host never holds the whole model)."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_flatten, tree_paths, tree_unflatten

    like = tf.init_lm(None, cfg, device="meta")
    leaves, treedef = tree_flatten(like)
    drawn = lmstack_numpy_init([(p, tuple(x.shape)) for p, x in
                                zip(tree_paths(like), leaves)])
    return tree_unflatten(treedef, [torch.from_numpy(a).to(dev)
                                    for a in drawn])


def _lmstack_hold(dev) -> dict:
    """The three cut models on the card, prefill through the kernels, then
    LMSTACK_STEPS decode steps fed LMSTACK_REF's tokens, held to the JAX
    package's summaries (LMSTACK_REF_RTOL)."""
    import torch
    from repro_torch.models import transformer as tf

    if LMSTACK_REF is None:
        raise AssertionError("LMSTACK_REF is not pinned; run "
                             "scripts/lmstack_ref.py")
    worst = {}
    for arch in LMSTACK_CUTS:
        cfg = lmstack_cut(arch)
        t0 = time.perf_counter()
        params = _lmstack_params(cfg, dev)
        draw_s = time.perf_counter() - t0
        prompt, img = lmstack_inputs(cfg)
        ref = LMSTACK_REF[arch]
        toks = torch.from_numpy(prompt).to(dev)
        image = None if img is None else torch.from_numpy(img).to(dev)
        logits, cache = tf.prefill(params, toks, cfg, img=image,
                                   cache_len=LMSTACK_PROMPT + LMSTACK_STEPS,
                                   use_pallas=True)
        got = [logit_summary(logits[0].cpu().numpy())]
        for i, want in enumerate(ref["steps"][:-1]):
            tok = torch.full((1, 1), want["argmax"], dtype=torch.long,
                             device=dev)
            logits, cache = tf.decode_step(params, tok, LMSTACK_PROMPT + i,
                                           cache, cfg)
            got.append(logit_summary(logits[0].cpu().numpy()))
        rel = 0.0
        for i, (g, w) in enumerate(zip(got, ref["steps"], strict=True)):
            scale = max(abs(w["max"]), max(abs(v) for v in w["ids"]))
            diffs = [abs(a - b) for a, b in zip(g["ids"], w["ids"])]
            diffs.append(abs(g["max"] - w["max"]))
            step_rel = max(max(diffs) / scale,
                           abs(g["norm"] - w["norm"]) / w["norm"])
            rel = max(rel, step_rel)
            if g["argmax"] != w["argmax"] and w["gap"] >= LOGIT_TOL:
                raise AssertionError(f"lmstack hold {arch} step {i}: argmax "
                                     f"{g['argmax']} vs the JAX package's "
                                     f"{w['argmax']} (top-2 gap "
                                     f"{w['gap']:.3e})")
        if not rel <= LMSTACK_REF_RTOL:
            raise AssertionError(f"lmstack hold {arch}: {rel:.3e} of max "
                                 f"|logit| from the JAX package's; allowed "
                                 f"{LMSTACK_REF_RTOL}")
        worst[arch] = rel
        log(f"lmstack hold {arch} ({cfg.n_params()} params: "
            f"{LMSTACK_CUTS[arch]} at the published widths; numpy init drawn "
            f"and copied in {draw_s:.3f} s): prefill [1, {LMSTACK_PROMPT}] "
            f"through the kernels and {LMSTACK_STEPS} decode steps within "
            f"{rel:.3e} of max |logit| of the JAX package's (allowed "
            f"{LMSTACK_REF_RTOL}); argmax "
            f"{[g['argmax'] for g in got]}")
        del params, cache, logits
        torch.cuda.empty_cache()
    return worst


def _moe_serve(dev) -> dict:
    """granite-moe-3b through ``python -m repro_torch.serve --arch
    granite-moe-3b-a800m --full --use-pallas --requests 16`` in code: a
    paged launch a layer a decode step and no merge; the run twice, token
    for token; the plain engine; the capacity drops; at MOE_NODROP the
    engine against ``sequential_generate``; then the [2, 1024] prefill
    through a flash launch a layer against the chunked path."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ServeEngine, sequential_generate
    from repro_torch.serve.__main__ import make_requests

    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(LMSTACK_SEED)
    params = tf.init_lm(gen, cfg)
    reqs = make_requests(SERVE_REQUESTS, cfg.vocab_size, seed=LMSTACK_SEED,
                         max_new=SERVE_MAX_NEW)
    out = phase_serve(dev, cfg, params, reqs, sequential=False)
    if out["launches"].get("paged_decode_merge"):
        raise AssertionError(f"granite serve: merges {out['launches']}")
    with moe.recording() as drops:
        again = ServeEngine(params, cfg, use_pallas=True,
                            **SERVE_KW).run(reqs)
    if [o.tokens for o in again] != out["tokens"]:
        raise AssertionError("granite serve: a second kernel run gave "
                             "other tokens")
    routed, dropped = int(drops["routed"]), int(drops["dropped"])
    log(f"lmstack granite serve: a second kernel run gave the same tokens "
        f"for all {len(reqs)} requests; {dropped} of its {routed} routed "
        f"(token, slot) pairs dropped for capacity (factor "
        f"{cfg.moe.capacity_factor}; {dropped / routed:.4%})")
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_NODROP))
    with moe.recording() as nd:
        eng = [o.tokens for o in ServeEngine(
            params, nodrop, use_pallas=True, **SERVE_KW).run(reqs)]
        seq = []
        for r in reqs:
            prompt = torch.tensor([r.prompt], dtype=torch.int32, device=dev)
            toks = sequential_generate(params, nodrop, prompt,
                                       gen_len=r.max_new,
                                       cache_len=len(r.prompt) + r.max_new)
            seq.append(tuple(toks[0, len(r.prompt):].tolist()))
    if int(nd["dropped"]):
        raise AssertionError(f"granite at factor {MOE_NODROP}: "
                             f"{int(nd['dropped'])} pairs dropped")
    ties = _compare_tokens("granite kernel engine vs sequential_generate "
                           f"(factor {MOE_NODROP})", params, nodrop, reqs,
                           eng, seq, dev)
    log(f"lmstack granite: at capacity factor {MOE_NODROP} (0 pairs "
        f"dropped) the kernel engine == sequential_generate for "
        f"{len(reqs)} requests"
        + (f" up to {len(ties)} near-tie(s)" if ties else " (all equal)"))
    pre = _moe_prefill(dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    return {"serve": out, "prefill": pre, "dropped": dropped,
            "routed": routed, "nodrop_ties": ties}


def _moe_prefill(dev, cfg, params, shape=PREFILL_SHAPE) -> dict:
    """granite's [2, 1024] prefill through a flash launch a layer against
    the chunked path, the MoE's routes recorded in both.  The MoE is
    discontinuous where a token's ranked top-k ties: there two paths 1e-6
    apart in the hidden state may route it differently, and the model
    parts from that layer on.  So: where every route agrees, logits and
    every layer's K/V within PREFILL_TOL; where one parts, every rerouted
    token at a near-tie (ROUTE_TIE) and the K/V of the layers up to it
    (computed before its MoE) within PREFILL_TOL, the rest reported."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    rng = np.random.default_rng(SERVE_SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           size=shape)).to(dev)
    tf.prefill(params, tokens, cfg, use_pallas=True)        # warm-up
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    with moe.recording(routes=True) as rk:
        t0 = time.perf_counter()
        logits, cache = tf.prefill(params, tokens, cfg, use_pallas=True)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    _expect_launches("granite prefill", counts,
                     {"flash_attention": cfg.n_layers})
    with moe.recording(routes=True) as rp:
        t0 = time.perf_counter()
        want, want_cache = tf.prefill(params, tokens, cfg)
        torch.cuda.synchronize(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
    c, w = cache["blocks"][0], want_cache["blocks"][0]
    kv = [max(float((c["k"][i] - w["k"][i]).abs().max()),
              float((c["v"][i] - w["v"][i]).abs().max()))
          for i in range(cfg.n_layers)]
    logit_err = float((logits - want).abs().max())
    flip = next((i for i, (a, b) in enumerate(zip(rk["routes"],
                                                   rp["routes"]))
                 if not (torch.equal(a["expert_idx"], b["expert_idx"])
                         and torch.equal(a["valid"], b["valid"]))), None)
    held = kv if flip is None else kv[:flip + 1]
    if not torch.isfinite(logits).all() or max(held) > PREFILL_TOL or (
            flip is None and logit_err > PREFILL_TOL):
        raise AssertionError(f"granite prefill: flash vs chunked K/V "
                             f"{held}, logits {logit_err} (first parted "
                             f"route: layer {flip}); allowed {PREFILL_TOL}")
    tie = None
    if flip is not None:
        a, b = rk["routes"][flip], rp["routes"][flip]
        moved = (a["expert_idx"] != b["expert_idx"]).any(dim=-1)
        gaps = torch.maximum(a["gap"], b["gap"])[moved]
        tie = (int(moved.sum()), float(gaps.max()) if len(gaps) else None)
        if not len(gaps) or tie[1] >= ROUTE_TIE:
            raise AssertionError(f"granite prefill: layer {flip}'s MoE "
                                 f"routes {tie[0]} token(s) differently, "
                                 f"top-k gap up to {tie[1]} (a near-tie is "
                                 f"< {ROUTE_TIE})")
    log(f"lmstack granite prefill tokens {list(shape)}: flash {ms:.4f} ms, "
        f"chunked {plain_ms:.4f} ms (host clock); "
        + ("every route of the 32 MoE layers equal in both paths; max abs "
           f"diff logits {logit_err:.3e}, K/V {max(kv):.3e}"
           if flip is None else
           f"routes equal up to layer {flip}, where {tie[0]} token(s) sit "
           f"at a near-tie (ranked top-k gap up to {tie[1]:.3e} < "
           f"{ROUTE_TIE}) and take other experts; K/V of layers 0..{flip} "
           f"within {max(held):.3e}; after it (reported, not held) K/V "
           f"{max(kv):.3e}, logits {logit_err:.3e}")
        + f" (allowed {PREFILL_TOL}); launches {counts}")
    del want, want_cache, cache
    wall, parts = _profile_kernels(
        dev, lambda: tf.prefill(params, tokens, cfg, use_pallas=True), 1)
    busy = sum(parts.values())
    flash = sum(v for k, v in parts.items() if k.startswith("flash_tc"))
    log(f"lmstack granite prefill under the profiler: wall {wall:.4f} ms, "
        f"device kernel time {busy:.4f} ms ({100 * busy / wall:.2f}% busy), "
        f"flash_attention {flash:.4f} ms")
    return {"launches": counts, "kv": kv, "logits": logit_err, "flip": flip,
            "tie": tie, "ms": ms, "plain_ms": plain_ms, "busy_ms": busy,
            "wall_ms": wall}


def _zamba2(dev) -> dict:
    """zamba2-7b: the [1, 4608] prefill through 81 launches of each scan
    kernel and 13 flash launches against the plain path (logits, every
    Mamba state, the shared block's ring-buffer caches); ZAMBA2_DECODE
    greedy steps from the kernel prefill's caches, no launch, against
    ``sequential_generate``; the serving CLI's baseline with and without
    ``--use-pallas``; the engine's refusal."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ServeEngine, sequential_generate
    from repro_torch.serve.__main__ import main as serve_main
    from repro_torch.tree import tree_leaves, tree_paths

    cfg = get_config(ZAMBA2_ARCH)
    gen = torch.Generator(device=dev).manual_seed(LMSTACK_SEED)
    params = tf.init_lm(gen, cfg)
    rng = np.random.default_rng(LMSTACK_SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           size=ZAMBA2_PREFILL)).to(dev)
    tf.prefill(params, tokens[:, :256], cfg, use_pallas=True)   # warm-up
    tf.prefill(params, tokens[:, :256], cfg, use_pallas=False)
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = tf.prefill(params, tokens, cfg, use_pallas=True)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    n_shared = cfg.n_periods
    _expect_launches("zamba2 prefill", counts,
                     {**_ssd_launches(cfg.n_layers),
                      "flash_attention": n_shared})
    t0 = time.perf_counter()
    want, want_cache = tf.prefill(params, tokens, cfg, use_pallas=False)
    torch.cuda.synchronize(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = {"logits": _rel_err(logits, want)}
    for path, g, w in zip(tree_paths(cache), tree_leaves(cache),
                          tree_leaves(want_cache)):
        name = "/".join(map(str, path))
        if g.dtype == torch.int32:
            if not torch.equal(g, w):
                raise AssertionError(f"zamba2 prefill: {name} differs")
            continue
        kind = name.split("/")[0] + "." + str(path[-1])
        errs[kind] = max(errs.get(kind, 0.0), _rel_err(g, w))
    ring = cache["shared_attn"]["k"].shape
    if ring[2] != cfg.window or not torch.equal(
            cache["shared_attn"]["slot_pos"][0].sort().values.cpu(),
            torch.arange(ZAMBA2_PREFILL[1] - cfg.window, ZAMBA2_PREFILL[1],
                         dtype=torch.int32)):
        raise AssertionError(f"zamba2 prefill: shared caches {tuple(ring)} "
                             "are not the last window's ring buffer")
    if not torch.isfinite(logits).all() or max(errs.values()) > ZAMBA2_TOL:
        raise AssertionError(f"zamba2 prefill: kernel vs plain path {errs}; "
                             f"allowed {ZAMBA2_TOL}")
    log(f"lmstack zamba2 prefill {cfg.name} ({cfg.n_params()} params) "
        f"tokens {list(ZAMBA2_PREFILL)}: kernel path {ms:.4f} ms, plain path "
        f"{plain_ms:.4f} ms (host clock, one call each); relative error "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (allowed {ZAMBA2_TOL}); shared caches {tuple(ring)}, ring "
        f"buffers of the last {cfg.window} positions; launches {counts}")
    del want, want_cache

    ops.reset_launch_counts()
    tok = torch.argmax(logits, dim=-1)[:, None]
    out, step_logits = [tok], [logits]
    s = ZAMBA2_PREFILL[1]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(ZAMBA2_DECODE):
        lg, cache = tf.decode_step(params, tok, s + i, cache, cfg)
        tok = torch.argmax(lg, dim=-1)[:, None]
        out.append(tok)
        step_logits.append(lg)
    torch.cuda.synchronize(dev)
    dec_ms = (time.perf_counter() - t0) * 1e3 / ZAMBA2_DECODE
    _expect_launches("zamba2 decode", ops.launch_counts(), {})
    got = torch.cat(out, dim=1)[0]
    del cache
    seq = sequential_generate(params, cfg, tokens, gen_len=ZAMBA2_DECODE + 1,
                              cache_len=s + ZAMBA2_DECODE + 1)[0, s:]
    ties = []
    diff = (got != seq).nonzero().flatten()
    if len(diff):
        i = int(diff[0])
        top = step_logits[i][0].float().topk(2).values
        gap = float(top[0] - top[1])
        if gap >= LOGIT_TOL:
            raise AssertionError(f"zamba2 decode: parts from "
                                 f"sequential_generate at token {i} with "
                                 f"top-2 gap {gap:.3e} >= {LOGIT_TOL}")
        ties.append((0, i, gap))
    log(f"lmstack zamba2 decode: {ZAMBA2_DECODE} greedy steps from the "
        f"kernel prefill's caches, {dec_ms:.4f} ms a step (host clock), 0 "
        f"launches; tokens == sequential_generate's"
        + (f" up to a near-tie at {ties[0][1]} (gap {ties[0][2]:.3e})"
           if ties else " (all equal)"))
    try:
        ServeEngine(params, cfg)
    except NotImplementedError as e:
        log(f"lmstack zamba2 engine: refused as the reference's is ({e})")
    else:
        raise AssertionError("zamba2: the paged engine accepted it")
    del params, logits, step_logits
    torch.cuda.empty_cache()

    rows = {}
    n_req = int(ZAMBA2_CLI[1])
    for extra, calls in (((), 0), (("--use-pallas",), n_req)):
        ops.reset_launch_counts()
        rows[extra] = serve_main(["--arch", ZAMBA2_ARCH, "--full",
                                  "--baseline", *ZAMBA2_CLI, *extra])
        want_counts = _ssd_launches(calls * cfg.n_layers)
        if calls:
            want_counts["flash_attention"] = calls * n_shared
        _expect_launches(f"zamba2 serve --baseline {' '.join(extra)}",
                         ops.launch_counts(), want_counts)
        log(f"lmstack zamba2 serve --full --baseline {' '.join(ZAMBA2_CLI)} "
            f"{' '.join(extra)}: {rows[extra]['tokens_per_s']:.2f} tokens/s, "
            f"{rows[extra]['wall_s']:.4f} s; launches {ops.launch_counts()}")
        torch.cuda.empty_cache()
    return {"launches": counts, "errs": errs, "ms": ms, "plain_ms": plain_ms,
            "decode_ms": dec_ms, "ties": ties, "serve": rows}


def _vlm(dev) -> dict:
    """The VLM through ``python -m repro_torch.launch.serve ... --full
    --use-pallas --batch 2 --prompt-len 512 --gen-len 16`` in code (the
    sequential path with a [2, 1601, 4096] image stub: a flash launch a
    dense layer in the prefill), tokens equal to the run without
    ``--use-pallas``; then a prefill with every gate at VLM_GATE, kernel
    path against plain path, so that the cross blocks do work."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves, tree_paths

    cfg = get_config(VLM_ARCH)
    n_dense = cfg.n_periods * cfg.period.count("dense")
    runs, launches = {}, {}
    for extra in (("--use-pallas",), ()):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        runs[extra] = launch_serve.main([*VLM_ARGV, *extra])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches[extra] = ops.launch_counts()
        _expect_launches(f"vlm launch.serve {' '.join(extra)}",
                         launches[extra],
                         {"flash_attention": n_dense} if extra else {})
        log(f"lmstack vlm launch.serve {' '.join(VLM_ARGV)} "
            f"{' '.join(extra)}: {wall:.4f} s with the init (host clock); "
            f"launches {launches[extra]}")
        torch.cuda.empty_cache()
    kernel_toks, plain_toks = runs[("--use-pallas",)], runs[()]
    del runs
    # the launcher's model and image, drawn again from its seed (0)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_lm(gen, cfg)
    ties = []
    for r in range(kernel_toks.shape[0]):
        diff = (kernel_toks[r] != plain_toks[r]).nonzero().flatten()
        if not len(diff):
            continue
        i = int(diff[0])
        img = launch_serve.image_stub(cfg, 2, 0, dev)[r:r + 1]
        lg, _ = tf.prefill(params, plain_toks[r:r + 1, :i], cfg, img=img)
        top = lg[0].topk(2).values
        gap = float(top[0] - top[1])
        if gap >= LOGIT_TOL:
            raise AssertionError(f"vlm: row {r} parts at position {i} with "
                                 f"top-2 gap {gap:.3e} >= {LOGIT_TOL}")
        ties.append((r, i, gap))
    log(f"lmstack vlm tokens: --use-pallas == without for both rows of "
        f"{tuple(kernel_toks.shape)} (512 prompt + 16 greedy tokens)"
        + (f" up to near-ties {ties}" if ties else " (all equal)"))
    launches = launches[("--use-pallas",)]
    for blk, kind in zip(params["blocks"], cfg.period):
        if kind == "cross":
            blk["gate_attn"].fill_(VLM_GATE)
            blk["gate_mlp"].fill_(VLM_GATE)
    tokens = kernel_toks[:, :512]
    img = launch_serve.image_stub(cfg, 2, LMSTACK_SEED + 1, dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = tf.prefill(params, tokens, cfg, img=img, use_pallas=True)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    _expect_launches("vlm gated prefill", counts,
                     {"flash_attention": n_dense})
    t0 = time.perf_counter()
    want, want_cache = tf.prefill(params, tokens, cfg, img=img)
    torch.cuda.synchronize(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = {"logits": float((logits - want).abs().max())}
    for path, g, w in zip(tree_paths(cache), tree_leaves(cache),
                          tree_leaves(want_cache)):
        if g.dtype == torch.int32:
            continue
        key = f"blocks[{path[1]}].{path[-1]}"
        errs[key] = max(errs.get(key, 0.0), float((g - w).abs().max()))
    worst = max(errs.values())
    off, _, _ = tf.forward(params, tokens[:1, :64], cfg, mode="train",
                           img=img[:1])
    for blk in params["blocks"]:
        if "gate_attn" in blk:
            blk["gate_attn"].zero_()
            blk["gate_mlp"].zero_()
    shut, _, _ = tf.forward(params, tokens[:1, :64], cfg, mode="train",
                            img=img[:1])
    moved = float((off - shut).abs().max())
    if not torch.isfinite(logits).all() or worst > PREFILL_TOL or \
            not moved > 0:
        raise AssertionError(f"vlm gated prefill: flash vs chunked {errs} "
                             f"(allowed {PREFILL_TOL}); gates 0.5 vs 0 "
                             f"moved the logits by {moved}")
    log(f"lmstack vlm prefill [2, 512] with every gate at {VLM_GATE} and a "
        f"[2, {cfg.n_image_tokens}, {cfg.d_model}] image: flash {ms:.4f} ms, "
        f"chunked {plain_ms:.4f} ms (host clock); max abs diff logits "
        f"{errs['logits']:.3e}, K/V and image K/V "
        f"{max(v for k, v in errs.items() if k != 'logits'):.3e} (allowed "
        f"{PREFILL_TOL}); the gates move the logits by {moved:.3e}; "
        f"launches {counts}")
    del params, cache, want, want_cache, logits
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_launches": counts, "errs": errs,
            "ms": ms, "plain_ms": plain_ms, "ties": ties}


def _moe_train(dev) -> dict:
    """The LM preset on reduced granite-moe-3b, LMSTACK_TRAIN steps through
    ``api.run`` on the card (one ``qg_step`` a step, no other kernel,
    finite losses ending below the first) and on the CPU, held over
    LMSTACK_TRAIN_HELD."""
    import numpy as np
    from repro_torch import api
    from repro_torch.kernels import ops

    spec = api.presets.get(LM_PRESET).override(
        "model.kwargs=" + json.dumps({"arch": MOE_ARCH, "reduced": True}),
        f"loop.steps={LMSTACK_TRAIN}", "loop.log_every=1")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = api.run(spec, device=dev, log_fn=lambda *_: None)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    _expect_launches("lmstack moe train", counts,
                     {"qg_step": LMSTACK_TRAIN})
    losses = [r["loss"] for r in res.history]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"lmstack moe train: losses {losses}")
    cpu = api.run(spec, device="cpu", log_fn=lambda *_: None)
    cpu_losses = [r["loss"] for r in cpu.history]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)]
    steps, rtol = LMSTACK_TRAIN_HELD
    if max(gaps[:steps]) > rtol:
        raise AssertionError(f"lmstack moe train: card vs CPU {gaps} over "
                             f"the first {steps} steps; allowed {rtol}")
    log(f"lmstack moe train {LM_PRESET} on reduced {MOE_ARCH}: "
        f"{LMSTACK_TRAIN} steps in {wall:.3f} s, loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; card vs CPU relative gap by step "
        f"{[f'{g:.2e}' for g in gaps]} (held {rtol} over {steps}); "
        f"launches {counts}")
    return {"launches": counts, "losses": losses, "gaps": gaps}


def phase_lmstack(dev) -> dict:
    """Slice 6b-iii: the hold against the JAX package at the published
    widths (LMSTACK_REF); granite-moe-3b served and prefilled; zamba2-7b
    prefilled, decoded and served; the VLM served and prefilled; MoE
    training.  One model resident at a time."""
    out = {"hold": _lmstack_hold(dev), "moe": _moe_serve(dev),
           "zamba2": _zamba2(dev), "vlm": _vlm(dev),
           "train": _moe_train(dev)}
    launches = {}
    for counts in (out["moe"]["serve"]["launches"],
                   out["moe"]["prefill"]["launches"],
                   out["zamba2"]["launches"], out["vlm"]["launches"]):
        _add_counts(launches, counts)
    out["launches"] = launches
    log(f"lmstack launches (granite's serving run and prefill, zamba2's "
        f"prefill, the VLM's launch.serve): {launches}")
    return out


# ---------------------------------------------------------------------------
# runtimes (slice 8b): the hybrid backend over a one-rank NCCL group, and
# the delayed gossip
# ---------------------------------------------------------------------------

#: the quickstart pair with overlap=delayed_1: the JAX package's final test
#: accuracy at seed 0, 1 and 2 (``PYTHONPATH=src JAX_PLATFORMS=cpu python3
#: scripts/delayed_ref.py``, JAX 0.9.0 on the CPU); the card's runs are held
#: within ACC_ATOL of seed 0's (the port's init is a torch draw)
DELAYED_ACC = {
    "quickstart_ring16_alpha0.1_qg": (0.983612060546875, 0.98712158203125,
                                      0.98931884765625),
    "quickstart_ring16_alpha0.1_dsgdm": (0.93194580078125,
                                         0.934173583984375,
                                         0.9395751953125)}
DELAYED_STEPS = 150
#: point-to-point messages a step of the n1024 presets' compiled node
#: schedules (the JAX package's compiler gives the same,
#: tests/test_torch_gossip_schedule.py)
N1024_MESSAGES = {"n1024_ring": 2048, "n1024_powerlaw": 6118}
#: hybrid (d = 1) against vmap: the sparse schedule sums a node's
#: neighbours round by round, the vmap mix is a cuBLAS product of the
#: [n, n] matrix, so the two part by rounding, which training then carries
#: (the same cause as card vs CPU, and the same bounds): the delayed
#: quickstart pair over its 150 steps within CPU_RTOL / CPU_ATOL; the
#: n1024 presets over their first N1024_CPU_STEPS steps within
#: N1024_CPU_RTOL, the whole run reported (on n1024_powerlaw the final
#: loss, 0.026, read 1.83e-03 apart after 40 steps, on an H100)
HYBRID_RTOL, HYBRID_ATOL = CPU_RTOL, CPU_ATOL
#: exp16 on the hybrid backend, steps under CUDA sync debugging "error"
#: after two warm-up steps (the NCCL communicator's set-up)
EXP16_SYNC_STEPS = 8
#: the compressed run on the hybrid backend (item 12): CHOCO top-k with the
#: kernel compressors, held to the JAX package's COMPRESSED["topk"] band
TOPK_HYBRID_STEPS = 150


def _one_rank_nccl():
    """A one-rank NCCL group (a ``file://`` store under build/) and its node
    mesh: the sharded and hybrid code paths on the one card."""
    from repro_torch.launch import distributed, mesh
    store = OUT / "nccl_store"
    OUT.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    dev = distributed.initialize(f"file://{store}", 1, 0, backend="nccl",
                                 timeout_s=120)
    return dev, mesh.make_node_mesh(1)


def _hybrid_mix_ms(dev, node_mesh, preset) -> dict:
    """The hybrid mix of one step of ``preset`` at its full size (the
    compiled rounds as local gathers at d = 1): device ms a call (a CUDA
    graph of 10 calls) and the device activities of one eager call (the
    profiler)."""
    import torch
    from repro_torch import api
    from torch.profiler import ProfilerActivity, profile

    ex = api.build(api.presets.get(preset).override("runtime=hybrid"),
                   device=dev, mesh=node_mesh)
    rt = ex.trainer._runtime
    w = ex.trainer._mixing[0]
    mix = rt._mix_impl(w, 0)
    params = ex.state.params
    ms = _time_ms(lambda: mix(w, params), 10)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mix(w, params)
        torch.cuda.synchronize(dev)
    acts = sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    rounds = ex.trainer._resolved.schedule.max_rounds
    del ex, params
    return {"ms": ms, "activities": acts, "rounds": rounds}


def _n1024_hybrid(dev, node_mesh, scen_out, out) -> None:
    """The three n1024 presets on the hybrid backend at d = 1, 40 steps
    each through ``api.run(spec, mesh=)``: the launches, N1024_BAND and
    its order, the churn fractions at every step (chunks of 10), the
    history against a vmap run of the same spec (N1024_CPU_RTOL over the
    first N1024_CPU_STEPS steps, the rest reported), the wire messages;
    the mix timed beside the dense one (the scenario phase's)."""
    from repro_torch import api
    from repro_torch.kernels import ops

    quiet = lambda *_: None
    res = {}
    for preset in N1024_PRESETS:
        spec = api.presets.get(preset).override("loop.log_every=1")
        if preset == "n1024_churn":
            spec = spec.override("loop.chunk=10")
        vm = api.run(spec.override("runtime=vmap"), device=dev,
                     log_fn=quiet).history
        spec = spec.override("runtime=hybrid")
        ops.reset_launch_counts()
        r = api.run(spec, device=dev, mesh=node_mesh, log_fn=quiet)
        counts = ops.launch_counts()
        _expect_launches(f"{preset} hybrid", counts, N1024_LAUNCHES)
        _add_counts(out["launches"], counts)
        _finite_run(f"{preset} hybrid", r, N1024_STEPS)
        res[preset] = r
        acc = r.final["acc"]
        lo, hi = N1024_BAND[preset]
        if not lo <= acc <= hi:
            raise AssertionError(f"{preset} hybrid: test acc {acc:.4f} "
                                 f"outside [{lo:.4f}, {hi:.4f}]")
        held = _history_close(r.history[:N1024_CPU_STEPS],
                              vm[:N1024_CPU_STEPS], N1024_CPU_RTOL,
                              CPU_ATOL, f"{preset} hybrid vs vmap")
        gap = _history_gap(r.history, vm, f"{preset} hybrid vs vmap")
        msgs = r.wire.get("messages_per_step")
        want = N1024_MESSAGES["n1024_ring" if spec.topology.name == "ring"
                              else "n1024_powerlaw"]
        if msgs != want:
            raise AssertionError(f"{preset} hybrid: {msgs} wire messages a "
                                 f"step, want {want}")
        log(f"runtimes {preset} hybrid d=1: {N1024_STEPS} steps in "
            f"{r.wall_time_s:.4f} s ({r.wall_time_s / N1024_STEPS * 1e3:.4f}"
            f" ms/step), test acc {acc:.4f} (vmap "
            f"{scen_out['results'][preset].final['acc']:.4f}, band "
            f"[{lo:.4f}, {hi:.4f}]), history vs vmap {held:.3e} over the "
            f"first {N1024_CPU_STEPS} steps, {gap:.3e} over all "
            f"{N1024_STEPS} (relative), {msgs:.0f} wire messages a step, "
            f"launches {counts}")
        out["results"][f"{preset}_hybrid"] = r
    acc = {p: r.final["acc"] for p, r in res.items()}
    if not acc["n1024_powerlaw"] > acc["n1024_churn"] > acc["n1024_ring"]:
        raise AssertionError(f"runtimes: hybrid accuracies {acc} are not "
                             "ordered powerlaw > churn > ring")
    fracs = tuple((h["alive_frac"], h["mix_frac"])
                  for h in res["n1024_churn"].history)
    if fracs != N1024_CHURN_FRACS:
        bad = next(i for i, (a, b) in enumerate(zip(fracs,
                                                    N1024_CHURN_FRACS))
                   if a != b)
        raise AssertionError(f"n1024_churn hybrid: step {bad} fractions "
                             f"{fracs[bad]}, JAX package "
                             f"{N1024_CHURN_FRACS[bad]}")
    log(f"runtimes n1024_churn hybrid: all {N1024_STEPS} steps' alive/mix "
        "fractions equal the JAX package's exactly (chunks of 10, "
        f"{res['n1024_churn'].scenario['mask_host_ms_per_step']:.4f} "
        "ms/step of host time for the masks)")
    dense = scen_out["timed"]["dense mix"]
    for preset in ("n1024_ring", "n1024_powerlaw"):
        m = _hybrid_mix_ms(dev, node_mesh, preset)
        out["mix"][preset] = m
        log(f"time runtimes hybrid mix {preset} (d=1, {m['rounds']} rounds,"
            f" 1024 x 13652): {m['ms']:.6f} ms (CUDA graph of 10 calls), "
            f"{m['activities']} device activities an eager call; the dense "
            f"[1024, 1024] mix {dense:.6f} ms (scenario phase)")


def _delayed_pair(dev, node_mesh, out) -> None:
    """The quickstart pair with overlap=delayed_1 for 150 steps on vmap and
    on hybrid (d = 1): the launches (the init capture runs the chain once),
    DELAYED_ACC, the card against the port on the CPU, hybrid against
    vmap, telemetry (staleness_gap, gossip_wait_ms; the history bit-equal
    to the run without) and a checkpoint cut at step 10 of 20 and resumed
    bit-equal, ``mix_buf`` included, on both runtimes."""
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.telemetry import read_jsonl

    quiet = lambda *_: None
    for preset, ref in DELAYED_ACC.items():
        base = api.presets.get(preset).override("overlap=delayed_1",
                                                "loop.log_every=1")
        qg = "qg" in base.optim.name
        want = {"fused_halfstep": DELAYED_STEPS + 1}
        if qg:
            want["fused_qg_buffer"] = DELAYED_STEPS + 1
        runs = {}
        for rt, m in (("vmap", None), ("hybrid", node_mesh)):
            spec = base.override(f"runtime={rt}")
            ops.reset_launch_counts()
            r = api.run(spec, device=dev, mesh=m, log_fn=quiet)
            counts = ops.launch_counts()
            _expect_launches(f"{preset} delayed {rt}", counts, want)
            _add_counts(out["launches"], counts)
            _finite_run(f"{preset} delayed {rt}", r, DELAYED_STEPS)
            if abs(r.final["acc"] - ref[0]) > ACC_ATOL:
                raise AssertionError(
                    f"{preset} delayed {rt}: test acc {r.final['acc']:.4f} "
                    f"not within {ACC_ATOL} of the JAX package's {ref[0]}")
            runs[rt] = r
            out["results"][f"{preset}_delayed_{rt}"] = r
            log(f"runtimes {preset} delayed_1 {rt}: {DELAYED_STEPS} steps "
                f"in {r.wall_time_s:.4f} s ({r.wall_time_s / DELAYED_STEPS * 1e3:.4f}"
                f" ms/step), test acc {r.final['acc']:.4f} (JAX package "
                f"{ref}), launches {counts}")
        gap = _history_close(runs["hybrid"].history, runs["vmap"].history,
                             HYBRID_RTOL, HYBRID_ATOL,
                             f"{preset} delayed hybrid vs vmap")
        cpu = api.run(base.override("runtime=vmap", "optim.fused=kernel"),
                      device="cpu", log_fn=quiet)
        cgap = _history_close(runs["vmap"].history, cpu.history, CPU_RTOL,
                              CPU_ATOL, f"{preset} delayed card vs CPU")
        log(f"runtimes {preset} delayed_1: hybrid d=1 vs vmap within "
            f"{gap:.3e} (relative; not bit-equal: the vmap mix is a cuBLAS "
            f"product, the hybrid one the rounds' sums), card vs CPU "
            f"within {cgap:.3e}")
        # telemetry: the overlap's two metrics, the history unchanged
        for rt, m in (("vmap", None), ("hybrid", node_mesh)):
            path = OUT / f"metrics_delayed_{rt}.jsonl"
            spec = base.override(f"runtime={rt}", "telemetry.enabled=true",
                                 "telemetry.every=10")
            r = api.run(spec, device=dev, mesh=m, log_fn=quiet,
                        telemetry_path=str(path))
            if r.history != runs[rt].history:
                raise AssertionError(f"{preset} delayed {rt}: telemetry "
                                     "changed the history")
            rows = read_jsonl(str(path))
            if [row["step"] for row in rows] != list(range(0, DELAYED_STEPS,
                                                         10)) or any(
                    "staleness_gap" not in row or "gossip_wait_ms" not in row
                    for row in rows):
                raise AssertionError(f"{preset} delayed {rt}: telemetry "
                                     f"rows {rows[:2]}")
            waits = [row["gossip_wait_ms"] for row in rows]
            log(f"runtimes {preset} delayed_1 {rt} telemetry every 10: "
                f"history bit-equal to the run without, staleness_gap "
                f"{rows[-1]['staleness_gap']:.4e} at step "
                f"{rows[-1]['step']}, gossip_wait_ms median "
                f"{statistics.median(waits):.4f} (max {max(waits):.4f})")
            path.unlink()
            # checkpoint cut and resumed, mix_buf included
            short = base.override(f"runtime={rt}", "loop.steps=20",
                                  "loop.chunk=5")
            same = _resume_pair(f"delayed_{rt}", short, dev, 10, mesh=m,
                                check_full=_has_mix_buf)
            log(f"runtimes {preset} delayed_1 {rt} resume at 10 of 20: "
                f"{same}")


def _has_mix_buf(npz) -> str:
    n = sum("x:.mix_buf" in k for k in npz.files)
    if not n:
        raise AssertionError("delayed checkpoint holds no mix_buf")
    return f", mix_buf {n}"


def _exp16_hybrid_sync_free(dev, node_mesh) -> tuple[int, dict]:
    """exp16 on the hybrid backend at d = 1: EXP16_SYNC_STEPS steps under
    CUDA sync debugging 'error' (any host sync raises) after two warm-up
    steps, each step's phase picked from the host step index; then the
    run's launches."""
    import torch
    from repro_torch import api
    from repro_torch.kernels import ops

    spec = api.presets.get("exp16_alpha0.1_qg").override("runtime=hybrid")
    ex = api.build(spec, device=dev, mesh=node_mesh)
    it = ex.task.make_iter()
    batches = [ex.trainer.put_batch(next(it))
               for _ in range(EXP16_SYNC_STEPS + 2)]
    state = ex.state
    ops.reset_launch_counts()
    for t, b in enumerate(batches[:2]):
        state, _ = ex.trainer.step(state, b, t=t)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t, b in enumerate(batches[2:], start=2):
            state, metrics = ex.trainer.step(state, b, t=t)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    counts = ops.launch_counts()
    n = EXP16_SYNC_STEPS + 2
    _expect_launches("exp16 hybrid", counts,
                     {"fused_halfstep": n, "fused_qg_buffer": n})
    if int(state.t) != n or not bool(torch.isfinite(metrics["loss"])):
        raise AssertionError(f"exp16 hybrid: t={int(state.t)}, loss "
                             f"{float(metrics['loss'])}")
    return EXP16_SYNC_STEPS, counts


def _topk_hybrid(dev, node_mesh, out) -> None:
    """CHOCO top-k on the hybrid backend at d = 1 with the kernel
    compressors: the anchors gossiped through the hybrid mix, so the
    two-kernel path (no choco_exchange), accuracy within ACC_ATOL of the
    JAX package's."""
    from repro_torch import api
    from repro_torch.kernels import ops

    name, _, acc_ref, _, _ = COMPRESSED["topk"]
    spec = api.presets.get(name).override("comm.backend=auto",
                                          "runtime=hybrid")
    ops.reset_launch_counts()
    r = api.run(spec, device=dev, mesh=node_mesh, log_fn=lambda *_: None)
    counts = ops.launch_counts()
    _finite_run("topk hybrid", r, TOPK_HYBRID_STEPS)
    if counts.get("qg_step") or counts.get("choco_exchange"):
        raise AssertionError(f"topk hybrid: launches {counts}")
    if abs(r.final["acc"] - acc_ref) > ACC_ATOL:
        raise AssertionError(f"topk hybrid: test acc {r.final['acc']:.4f} "
                             f"not within {ACC_ATOL} of {acc_ref}")
    _add_counts(out["launches"], counts)
    out["results"]["topk_hybrid"] = r
    log(f"runtimes {name} comm.backend=auto hybrid d=1: "
        f"{r.wall_time_s / TOPK_HYBRID_STEPS * 1e3:.4f} ms/step, test acc "
        f"{r.final['acc']:.4f} (JAX package {acc_ref}), wire "
        f"{r.wire['bits_per_node_per_step']:.0f} bits a node a step "
        f"({r.wire.get('messages_per_step', 0):.0f} messages), launches "
        f"{counts}")


def phase_runtimes(dev, scen_out) -> dict:
    """Slice 8b's main paths on the card: the sharded/hybrid code over a
    one-rank NCCL group (d = 1: every sparse phase local gathers; NCCL
    across ranks waits for a four-card run) and the delayed gossip: the
    n1024 presets on hybrid, the delayed quickstart pair on vmap and
    hybrid, exp16 on hybrid with no host sync, CHOCO top-k on hybrid;
    each loop's ms/step and busy share under the profiler."""
    from repro_torch import api
    from repro_torch.launch import distributed

    out = {"launches": {}, "results": {}, "mix": {}, "profile": {}}
    t0 = time.perf_counter()
    dev, node_mesh = _one_rank_nccl()
    try:
        log(f"runtimes: one-rank NCCL group on {dev} "
            f"({time.perf_counter() - t0:.3f} s to set up)")
        _n1024_hybrid(dev, node_mesh, scen_out, out)
        _delayed_pair(dev, node_mesh, out)
        steps, counts = _exp16_hybrid_sync_free(dev, node_mesh)
        _add_counts(out["launches"], counts)
        log(f"runtimes exp16 hybrid d=1: {steps} steps under CUDA sync "
            "debugging 'error' (after 2 warm-up steps), no host sync, the "
            f"phase from the host step index; launches {counts}")
        _topk_hybrid(dev, node_mesh, out)
        for label, preset, over in (
                ("n1024_ring_hybrid", "n1024_ring", ()),
                ("n1024_powerlaw_hybrid", "n1024_powerlaw", ()),
                ("n1024_churn_hybrid", "n1024_churn", ()),
                ("delayed_qg_hybrid", "quickstart_ring16_alpha0.1_qg",
                 ("overlap=delayed_1",))):
            spec = api.presets.get(preset).override("runtime=hybrid", *over)
            out["profile"][label] = phase_profile(dev, label, spec,
                                                  mesh=node_mesh)
    finally:
        distributed.shutdown()
    if out["launches"].get("qg_step"):
        raise AssertionError(f"runtimes: qg_step launched "
                             f"{out['launches']['qg_step']} times")
    log(f"runtimes launches {json.dumps(out['launches'])} "
        f"({time.perf_counter() - t0:.1f} s for the phase)")
    return out


# ---------------------------------------------------------------------------
# 13. launch: slice 9's step builders on TinyLlama-1.1B at its published size

#: the launch phase's StepConfig: TinyLlama-1.1B at its published widths
#: and depth (1.100e9 parameters, d_model 2048, 22 layers), LAUNCH_NODES
#: nodes of a ring on the card, LAUNCH_SEQ tokens a sequence and
#: LAUNCH_BATCH sequences in all, fp32 (the kernel route of the dtype rule)
LAUNCH_ARCH = "tinyllama-1.1b"
#: its published size: (parameters, d_model, layers)
LAUNCH_SIZE = (1_100_046_336, 2048, 22)
LAUNCH_SEQ, LAUNCH_BATCH, LAUNCH_NODES, LAUNCH_STEPS = 1024, 2, 2, 3
LAUNCH_SEED = 0
#: the prefill and decode builders: a [1, LAUNCH_PROMPT] prompt, then
#: LAUNCH_DECODE greedy tokens
LAUNCH_PROMPT, LAUNCH_DECODE = 2048, 8


def _timed(fn, *args):
    """``(fn(*args), ms)``: wall time between two device syncs."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _launch_inputs(dev, sc):
    """``sc.n_nodes`` seeded node inits, stacked, and a numpy batch of
    next-token pairs (int32, as ``steps.train_batch_specs``)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map

    gen = torch.Generator(device=dev).manual_seed(LAUNCH_SEED)
    nodes = [tf.init_lm(gen, sc.cfg) for _ in range(sc.n_nodes)]
    params = tree_map(lambda *ls: torch.stack(ls), *nodes)
    del nodes
    rng = np.random.default_rng(LAUNCH_SEED)
    toks = rng.integers(0, sc.cfg.vocab_size, dtype=np.int32, size=(
        sc.n_nodes, sc.shape.global_batch // sc.n_nodes,
        sc.shape.seq_len + 1))
    batch = {"tokens": torch.from_numpy(toks[..., :-1].copy()).to(dev),
             "labels": torch.from_numpy(toks[..., 1:].copy()).to(dev)}
    return params, batch


def _nbytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _launch_hold_unfused(dev, sc, params, batch, host1) -> float:
    """Step 1 of the kernel route against the same step through the
    unfused chain (``fused='off'``), held within HIST_RTOL / HIST_ATOL.
    The chain acts leaf by leaf (weight decay, the heavyball, the dense mix
    of the leaf's rows, the QG refresh), so it runs one leaf at a time here:
    the whole fp32 chain at this width holds ~66 GB of temporaries (the dry
    run's count), beyond the card beside the step's arguments.  The
    gradients are the step's own half (``steps.node_grads``), whose mean
    loss must be the step's bit for bit.  Returns the largest abs error."""
    import dataclasses
    import torch
    from repro_torch.launch import steps
    from repro_torch.tree import tree_leaves

    xs1, ms1, loss1 = host1
    losses, grads = steps.node_grads(sc, params, batch)
    if not torch.equal(torch.mean(losses), loss1):
        raise AssertionError(f"launch: node_grads' mean loss "
                             f"{torch.mean(losses).item()} is not the "
                             f"step's {loss1.item()}")
    opt = dataclasses.replace(steps.make_opt(sc), fused="off")
    w = torch.as_tensor(steps.step_topology(sc).w(0), dtype=torch.float32,
                        device=dev)
    worst = 0.0
    with torch.no_grad():
        for i, (x, g) in enumerate(zip(tree_leaves(params),
                                       tree_leaves(grads))):
            tree = {"x": x}
            new_p, new_o = opt.step(tree, {"x": g}, opt.init(tree), w=w,
                                    lr=sc.lr, t=0)
            for what, got, want in (("x", new_p["x"], xs1[i]),
                                    ("m_hat", tree_leaves(new_o)[0],
                                     ms1[i])):
                want = want.to(dev)
                err = (got - want).abs()
                worst = max(worst, err.max().item())
                bad = err > HIST_ATOL + HIST_RTOL * want.abs()
                if bool(bad.any()):
                    raise AssertionError(
                        f"launch: leaf {i} {what}, kernel step vs unfused "
                        f"chain: {int(bad.sum())} entries beyond HIST_RTOL "
                        f"/ HIST_ATOL, max abs {err.max().item():.3e}")
    return worst


def _launch_remat(dev, sc, params, batch, host1, base) -> dict:
    """One step with ``remat='none'`` from the same inputs: params,
    optimizer state and loss bit-equal to the ``'full'`` step 1
    (``host1``); its peak over the arguments."""
    import dataclasses
    import torch
    from repro_torch.launch import steps
    from repro_torch.tree import tree_leaves

    sc_none = dataclasses.replace(sc, remat="none")
    opt0 = steps.make_opt(sc_none).init(params)
    torch.cuda.reset_peak_memory_stats(dev)
    (p, o, loss), ms = _timed(steps.build_train_step(sc_none), params, opt0,
                              batch)
    peak = torch.cuda.max_memory_allocated(dev) - base
    xs1, ms1, loss1 = host1
    same = torch.equal(loss, loss1) and all(
        torch.equal(a, b.to(dev)) for a, b in zip(
            tree_leaves(p) + tree_leaves(o), xs1 + ms1))
    if not same:
        raise AssertionError("launch: remat='none' step is not bit-equal "
                             "to remat='full' step 1")
    return {"peak_over_args": peak, "ms": ms}


def _launch_serve(dev, cfg, params) -> dict:
    """``build_prefill_step`` at [1, LAUNCH_PROMPT], then LAUNCH_DECODE
    ``build_decode_step`` calls, greedy, against the direct ``tf.prefill``
    / ``tf.decode_step`` calls: the same tokens."""
    import numpy as np
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map

    one = tree_map(lambda t: t[0], params)
    sp = steps.StepConfig(cfg, InputShape(
        "smoke_prefill", LAUNCH_PROMPT + LAUNCH_DECODE, 1, "prefill"),
        n_nodes=1, param_dtype=torch.float32)
    rng = np.random.default_rng(LAUNCH_SEED + 1)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, LAUNCH_PROMPT), dtype=np.int32)).to(dev)
    direct = (
        lambda p, t: tf.prefill(p, t, cfg, chunk=sp.chunk,
                                ssd_chunk=sp.ssd_chunk,
                                cache_len=sp.shape.seq_len),
        lambda p, t, pos, c: tf.decode_step(p, t, pos, c, cfg))
    runs = {}
    for label, (prefill, decode) in (
            ("builders", (steps.build_prefill_step(sp),
                          steps.build_decode_step(sp))),
            ("direct", direct)):
        (logits, cache), prefill_ms = _timed(prefill, one, prompt)
        toks, decode_ms = [], []
        for j in range(LAUNCH_DECODE):
            tok = torch.argmax(logits, -1, keepdim=True)
            toks.append(int(tok[0, 0]))
            (logits, cache), dt = _timed(decode, one, tok,
                                         LAUNCH_PROMPT + j, cache)
            decode_ms.append(dt)
        runs[label] = {"tokens": toks, "prefill_ms": prefill_ms,
                       "decode_ms": statistics.median(decode_ms)}
        del cache
    if runs["builders"]["tokens"] != runs["direct"]["tokens"]:
        raise AssertionError(f"launch: builder tokens {runs['builders']} "
                             f"vs direct {runs['direct']}")
    return runs


def phase_launch(dev) -> dict:
    """Slice 9's main path on the card: the launch tooling's step builders
    on TinyLlama-1.1B at its published size.  The fp32 train step
    (``steps.build_train_step``, 2 nodes of a ring, remat 'full') for
    LAUNCH_STEPS steps from a seeded init, with exactly one ``qg_step``
    launch a plan slice a step and no ``fused_halfstep`` /
    ``fused_qg_buffer``; step 1 held against the unfused chain; ms/step and
    the peak memory beside the roofline bound of the same StepConfig under
    ``roofline.H100``; the dry run's bytes and flop count against the
    card's; remat 'none' bit-equal; a bf16 step (no kernel, the dtype
    rule); the prefill and decode builders against the direct calls."""
    import dataclasses
    import math as _math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops, qg_update as K
    from repro_torch.launch import dryrun, roofline, sharding, steps
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.tree import tree_leaves, tree_map

    smi = _card()
    t_phase = time.perf_counter()
    cfg = get_config(LAUNCH_ARCH)
    if (cfg.n_params(), cfg.d_model, cfg.n_layers) != LAUNCH_SIZE:
        raise AssertionError(f"launch: {LAUNCH_ARCH} is not at its "
                             f"published size: {cfg}")
    sc = steps.StepConfig(cfg, InputShape(
        "smoke_train", seq_len=LAUNCH_SEQ, global_batch=LAUNCH_BATCH,
        kind="train"), n_nodes=LAUNCH_NODES, param_dtype=torch.float32)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    log(f"launch [{smi}]: before the phase {torch.cuda.memory_allocated(dev)}"
        f" B allocated, device free {free} of {total} B")
    params, batch = _launch_inputs(dev, sc)
    opt0 = steps.make_opt(sc).init(params)
    plan = K.qg_step_plan([(leaf[0].numel(), [0] * 5)
                           for leaf in tree_leaves(params)])
    step = steps.build_train_step(sc)
    out = {"card": smi}

    # 1. the fp32 kernel path, counted
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    state, ms, losses, host1, peak1 = (params, opt0), [], [], None, None
    for i in range(LAUNCH_STEPS):
        (p, o, loss), dt = _timed(step, *state, batch)
        ms.append(dt)
        losses.append(loss.item())
        if i == 0:
            peak1 = torch.cuda.max_memory_allocated(dev)
            host1 = ([t.cpu() for t in tree_leaves(p)],
                     [t.cpu() for t in tree_leaves(o)], loss.clone())
            del opt0
        state = (p, o)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    _expect_launches("launch fp32", counts,
                     {"qg_step": LAUNCH_STEPS * len(plan)})
    out["launches"] = counts
    if not all(_math.isfinite(v) for v in losses):
        raise AssertionError(f"launch: losses {losses}")

    # 2. the dry run against the card: bytes, flops, memory
    meta = dryrun.trace_step(sc, sharding.make_plan(
        MeshShape((("data", 1),)), n_nodes=1))
    terms = roofline.roofline_terms(
        {"flops": meta["flops"], "bytes_accessed": meta["bytes_accessed"],
         "collective_bytes": 0.0}, hw=roofline.H100, dtype=sc.param_dtype)
    whole = steps.Layout.make(sc, MeshShape((("data", 1),)), kind="train")
    two = steps.Layout.make(sc, MeshShape((("data", LAUNCH_NODES),)),
                            kind="train")
    card = {"params": _nbytes(params), "opt_state": _nbytes(state[1]),
            "batch": _nbytes(batch)}
    for k in card:
        got = sharding.bytes_per_rank(whole.plan, whole.shapes[k],
                                      whole.specs[k])
        per_node = sharding.bytes_per_rank(two.plan, two.shapes[k],
                                           two.specs[k])
        if got != card[k] or LAUNCH_NODES * per_node != card[k]:
            raise AssertionError(f"launch: bytes_per_rank({k}) {got} (one "
                                 f"node a rank: {per_node}) vs {card[k]} B "
                                 "on the card")
    # the final state on the host: the shard phase holds its own to it
    out["host3"] = ([t.cpu() for t in tree_leaves(state[0])],
                    [t.cpu() for t in tree_leaves(state[1])])
    out["losses"] = losses
    del state, p, o
    opt0 = steps.make_opt(sc).init(params)
    (_, card_flops, card_bytes) = roofline.trace_cost(step, params, opt0,
                                                      batch)
    mix = roofline.mix_flops(LAUNCH_NODES, sum(
        leaf[0].numel() for leaf in tree_leaves(params)))
    if card_flops + mix != meta["flops"]:
        raise AssertionError(f"launch: flop count on meta {meta['flops']} "
                             f"vs the card's {card_flops} + the kernel's "
                             f"mix {mix}")
    del opt0
    warm = statistics.mean(ms[1:])
    out.update(ms=ms, warm_ms=warm, peak=peak, peak1=peak1, base=base,
               bound_s=terms["step_s_lower_bound"], terms=terms,
               ratio=warm / 1e3 / terms["step_s_lower_bound"],
               meta=meta, card_flops=card_flops, card_bytes=card_bytes,
               bytes=card)
    log(f"launch [{smi}] fp32 {LAUNCH_ARCH} {LAUNCH_NODES} nodes x "
        f"[{LAUNCH_BATCH // LAUNCH_NODES}, {LAUNCH_SEQ}], remat full: "
        f"{LAUNCH_STEPS} steps, ms/step {[round(v, 3) for v in ms]} (warm "
        f"{warm:.3f}), losses {losses}; launches {counts} (qg_step plan "
        f"{len(plan)} launch a step)")
    log(f"launch [{smi}] roofline (H100, fp32 at 67 TFLOP/s, TF32 off): "
        f"compute {terms['compute_s']:.6f} s, memory "
        f"{terms['memory_s']:.6f} s, bound {terms['step_s_lower_bound']:.6f}"
        f" s ({terms['bottleneck']}); measured/bound {out['ratio']:.3f}")
    log(f"launch [{smi}] memory: max_memory_allocated {peak} B over "
        f"{LAUNCH_STEPS} steps, {peak1} B in step 1, {base} B allocated "
        f"before; the dry run's argument {meta['argument']} B, its "
        f"MemTracker temp {meta['temp']} B on meta (the unfused chain: "
        f"meta takes no kernel) vs the card's step-1 peak over its "
        f"arguments {peak1 - base} B")
    log(f"launch [{smi}] bytes_per_rank = card nbytes {card}; flops meta "
        f"{meta['flops']:.0f} = card {card_flops:.0f} + qg_step's mix "
        f"{mix:.0f}; bytes accessed meta {meta['bytes_accessed']:.0f}, "
        f"card (kernel route) {card_bytes:.0f}")

    # 3. step 1 against the unfused chain, leaf by leaf
    out["unfused_max_abs"] = _launch_hold_unfused(dev, sc, params, batch,
                                                  host1)
    log(f"launch [{smi}] step 1 vs the unfused chain: max abs "
        f"{out['unfused_max_abs']:.3e} (HIST_RTOL {HIST_RTOL}, HIST_ATOL "
        f"{HIST_ATOL})")

    # 4. remat 'none' bit-equal, its peak beside 'full''s
    out["remat"] = _launch_remat(dev, sc, params, batch, host1, base)
    out["remat"]["full_peak_over_args"] = peak1 - base
    log(f"launch [{smi}] remat: 'none' bit-equal to 'full'; step peak over "
        f"the arguments none {out['remat']['peak_over_args']} B vs full "
        f"{peak1 - base} B; none {out['remat']['ms']:.3f} ms vs full step 1 "
        f"{ms[0]:.3f} ms")
    out["host1"] = host1

    # 5. the prefill and decode builders
    out["serve"] = _launch_serve(dev, cfg, params)
    for label, r in out["serve"].items():
        log(f"launch [{smi}] {label}: prefill [1, {LAUNCH_PROMPT}] "
            f"{r['prefill_ms']:.3f} ms, decode median {r['decode_ms']:.3f} "
            f"ms, tokens {r['tokens']}")

    # 6. bf16: the dtype rule builds the chain unfused: no kernel launch
    # (the fp32 params go first: the bf16 chain's temporaries are large)
    sc16 = dataclasses.replace(sc, param_dtype=torch.bfloat16)
    p16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    opt16 = steps.make_opt(sc16)
    if opt16.fused != "off":
        raise AssertionError(f"launch: bf16 optimizer fused={opt16.fused}")
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    (_, _, loss16), ms16 = _timed(steps.build_train_step(sc16), p16,
                                  opt16.init(p16), batch)
    _expect_launches("launch bf16", ops.launch_counts(), {})
    if not _math.isfinite(loss16.item()):
        raise AssertionError(f"launch: bf16 loss {loss16.item()}")
    out["bf16"] = {"ms": ms16, "loss": loss16.item(),
                   "peak": torch.cuda.max_memory_allocated(dev)}
    del p16
    log(f"launch [{smi}] bf16 step: 0 launches, loss {loss16.item():.6f}, "
        f"{ms16:.3f} ms (first call), peak {out['bf16']['peak']} B")
    del batch
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"launch launches {json.dumps({k: v for k, v in counts.items() if v})}"
        f" ({out['seconds']:.1f} s for the phase)")
    return out


# ---------------------------------------------------------------------------
# 14. shard: slice 10's sharded launch state and the attention chunk knobs

#: zamba2-7b (window 4096) at its published widths: a [1, SHARD_PREFILL]
#: prefill through ``build_prefill_step`` with ``skip_masked_chunks`` off
#: and on (four windows long: the query-chunked path skips 3/4 of the
#: key chunks of its attention)
SHARD_ARCH, SHARD_WINDOW, SHARD_PREFILL = "zamba2-7b", 4096, 16384
#: skip_masked_chunks on vs off: max |logit difference| over max |logit|,
#: the plain path's tolerance (PERF.md section 2); the two sum each softmax
#: over other key spans
SHARD_LOGIT_RTOL = 1e-4


def _held_bitwise(what, tree, host) -> None:
    """``tree``'s leaves (on the card) equal the host copies ``host`` bit
    for bit."""
    import torch
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(tree)
    if len(leaves) != len(host):
        raise AssertionError(f"{what}: {len(leaves)} leaves vs {len(host)}")
    for i, (a, b) in enumerate(zip(leaves, host)):
        a = a.cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: leaf {i} is not bit-equal, max "
                                 f"abs {(a - b).abs().max().item()}")


def _shard_train(dev, sc, launch_out, smi) -> dict:
    """TinyLlama-1.1B's fp32 train step on a ('data', 'model') mesh of
    (1, 1) over the one-rank NCCL group: every weight and buffer stored as
    the rank's block and gathered (one NCCL all-gather a leaf) on use,
    LAUNCH_STEPS steps bit-equal to the launch phase's mesh=None steps
    (losses and the final state), with its ``qg_step`` launches; the
    ``remat_attention`` step bit-equal to step 1; times, peaks and the
    roofline bound of the same layout's ``meta`` trace."""
    import dataclasses
    import statistics as st
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline, sharding, steps
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh((1, 1), ("data", "model"))
    step = steps.build_train_step(sc, mesh=mesh)
    lay = step.layout
    if lay.placement is None or lay.plan.node_axis is not None:
        raise AssertionError(f"shard: the (1, 1) mesh's plan {lay.plan} has "
                             "no placement, or puts the nodes on an axis")
    params, batch = _launch_inputs(dev, sc)
    opt0 = steps.make_opt(sc).init(params)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    state, ms, losses, peak1 = (params, opt0), [], [], None
    del opt0
    for i in range(LAUNCH_STEPS):
        (p, o, loss), dt = _timed(step, *state, batch)
        ms.append(dt)
        losses.append(loss.item())
        if i == 0:
            peak1 = torch.cuda.max_memory_allocated(dev)
        state = (p, o)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    _expect_launches("shard fp32", counts,
                     {"qg_step": launch_out["launches"]["qg_step"]})
    if losses != launch_out["losses"]:
        raise AssertionError(f"shard: losses {losses} vs the mesh=None "
                             f"steps' {launch_out['losses']}")
    host3 = launch_out.pop("host3")
    _held_bitwise("shard: params after the last step", state[0], host3[0])
    _held_bitwise("shard: optimizer state after the last step", state[1],
                  host3[1])
    card = _nbytes(state[0]) + _nbytes(state[1]) + _nbytes(batch)
    del host3, state, p, o

    meta = dryrun.trace_step(sc, sharding.make_plan(
        make_debug_mesh((1, 1), ("data", "model"), device="meta"),
        n_nodes=sc.n_nodes))
    if meta["argument"] != card:
        raise AssertionError(f"shard: the dry run's per-rank argument "
                             f"{meta['argument']} vs the card's {card} B")
    terms = roofline.roofline_terms(
        {"flops": meta["flops"], "bytes_accessed": meta["bytes_accessed"],
         "collective_bytes": 0.0}, hw=roofline.H100, dtype=sc.param_dtype)
    warm = st.mean(ms[1:])
    out = {"launches": counts, "ms": ms, "warm_ms": warm, "peak": peak,
           "peak1": peak1, "base": base, "bound_s":
           terms["step_s_lower_bound"], "bound_by": terms["bottleneck"],
           "ratio": warm / 1e3 / terms["step_s_lower_bound"],
           "gathered_bytes": lay.placement.tally.bytes,
           "meta_wire": meta["wire"], "losses": losses}
    log(f"shard [{smi}] fp32 {LAUNCH_ARCH} on a ('data', 'model') mesh of "
        f"(1, 1), one-rank NCCL group, {LAUNCH_NODES} nodes x "
        f"[{LAUNCH_BATCH // LAUNCH_NODES}, {LAUNCH_SEQ}], remat full: ms/step "
        f"{[round(v, 3) for v in ms]} (warm {warm:.3f}) vs bound "
        f"{terms['step_s_lower_bound'] * 1e3:.3f} ms ({terms['bottleneck']}"
        f"; measured/bound {out['ratio']:.3f}); losses {losses} bit-equal to "
        f"mesh=None; the final params and m_hat bit-equal; launches {counts}")
    log(f"shard [{smi}] memory: max_memory_allocated {peak} B over "
        f"{LAUNCH_STEPS} steps, {peak1} B in step 1 ({peak1 - base} B over "
        f"its arguments); {base} B allocated before; gathered "
        f"{lay.placement.tally.bytes} B in {LAUNCH_STEPS} steps (all-gathers "
        "of one rank: copies)")

    # remat_attention: the same step 1, bit for bit
    host1 = launch_out.pop("host1")
    step_ra = steps.build_train_step(
        dataclasses.replace(sc, remat_attention=True), mesh=mesh)
    opt0 = steps.make_opt(sc).init(params)
    torch.cuda.reset_peak_memory_stats(dev)
    (p, o, loss), ms_ra = _timed(step_ra, params, opt0, batch)
    peak_ra = torch.cuda.max_memory_allocated(dev)
    if loss.item() != losses[0]:
        raise AssertionError(f"shard: remat_attention loss {loss.item()} vs "
                             f"{losses[0]}")
    _held_bitwise("shard: remat_attention params", p, host1[0])
    _held_bitwise("shard: remat_attention m_hat", o, host1[1])
    del host1, opt0
    # a second step, warm, for its time beside the warm steps above
    _, ms_ra2 = _timed(step_ra, p, o, batch)
    out["remat_attention"] = {"ms": ms_ra, "warm_ms": ms_ra2,
                              "peak": peak_ra, "peak_off": peak1}
    log(f"shard [{smi}] remat_attention: step 1 bit-equal to off; "
        f"{ms_ra:.3f} ms (step 1) and {ms_ra2:.3f} ms (step 2) vs "
        f"{ms[0]:.3f} / {ms[1]:.3f} ms off; step-1 peak {peak_ra} B vs "
        f"{peak1} B off")
    del p, o, params, batch
    torch.cuda.empty_cache()
    return out


def _shard_prefill(dev, smi) -> dict:
    """zamba2-7b at its published widths, fp32: ``build_prefill_step`` at
    [1, SHARD_PREFILL] with ``skip_masked_chunks`` off and on (the plain
    attention and SSD paths: no kernel), last logits within
    SHARD_LOGIT_RTOL of max |logit| and the same argmax; host-clock times
    and peaks."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf

    cfg = get_config(SHARD_ARCH)
    if cfg.window != SHARD_WINDOW or SHARD_PREFILL < 2 * cfg.window:
        raise AssertionError(f"shard: {SHARD_ARCH} window {cfg.window}, "
                             f"prefill {SHARD_PREFILL}")
    gen = torch.Generator(device=dev).manual_seed(LAUNCH_SEED)
    params = tf.init_lm(gen, cfg)
    rng = np.random.default_rng(LAUNCH_SEED + 2)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, SHARD_PREFILL), dtype=np.int32)).to(dev)
    sp = steps.StepConfig(cfg, InputShape("shard_prefill", SHARD_PREFILL, 1,
                                          "prefill"),
                          n_nodes=1, param_dtype=torch.float32)
    runs = {}
    ops.reset_launch_counts()
    for skip in (False, True):
        fn = steps.build_prefill_step(dataclasses.replace(
            sp, skip_masked_chunks=skip))
        torch.cuda.reset_peak_memory_stats(dev)
        (logits, cache), dt = _timed(fn, params, tokens)
        runs[skip] = {"ms": dt, "peak": torch.cuda.max_memory_allocated(dev),
                      "logits": logits.float()}
        del cache
    _expect_launches("shard prefill", ops.launch_counts(), {})
    a, b = runs[False].pop("logits"), runs[True].pop("logits")
    if not bool(torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("shard: zamba2 logits are not finite")
    err = ((a - b).abs().max() / a.abs().max()).item()
    same_argmax = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
    out = {"runs": runs, "rel_err": err, "argmax_equal": same_argmax,
           "params_bytes": _nbytes(params)}
    log(f"shard [{smi}] {SHARD_ARCH} fp32 prefill [1, {SHARD_PREFILL}] "
        f"(window {cfg.window}): skip_masked_chunks off "
        f"{runs[False]['ms']:.1f} ms (peak {runs[False]['peak']} B), on "
        f"{runs[True]['ms']:.1f} ms (peak {runs[True]['peak']} B); logits "
        f"max |diff| / max |logit| {err:.3e} (SHARD_LOGIT_RTOL "
        f"{SHARD_LOGIT_RTOL}), argmax equal {same_argmax}; params "
        f"{out['params_bytes']} B")
    if err > SHARD_LOGIT_RTOL or not same_argmax:
        raise AssertionError(f"shard: skip_masked_chunks moved the logits "
                             f"by {err:.3e} of max |logit| (argmax equal "
                             f"{same_argmax})")
    del params, a, b
    torch.cuda.empty_cache()
    return out


#: slice 11's knobs: the heads, the residual's features (with the MLP, the
#: embedding, the head and the loss) and the experts split over 'model'
SPLIT_KNOBS = dict(megatron_attn=True, shard_activations=True,
                   pin_moe_dispatch=True)
#: granite-moe-3b at its published widths: a [1, SPLIT_MOE_PREFILL] prefill
#: with the heads and the experts split, against mesh=None
SPLIT_MOE_ARCH, SPLIT_MOE_PREFILL = "granite-moe-3b-a800m", 2048


def _split_train(dev, sc, mesh, gather_out, launch_out, smi) -> dict:
    """TinyLlama-1.1B's fp32 step with SPLIT_KNOBS on the (1, 1) mesh: the
    heads, the features and (no experts in a dense model) the vocabulary
    split over a 'model' axis of one NCCL rank, every collective run.
    LAUNCH_STEPS steps bit-equal to ``mesh=None``'s with the same knobs
    (``repeat_kv`` changes K/V's gradient's sum order, so the launch
    phase's steps are not the comparison), one ``qg_step`` a step; the warm
    ms/step beside ``mesh=None``'s and the gather-on-use step's
    (``gather_out``), the step-1 peaks."""
    import dataclasses
    import gc
    import statistics as st
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.tree import tree_leaves

    ssc = dataclasses.replace(sc, **SPLIT_KNOBS)
    params, batch = _launch_inputs(dev, ssc)
    runs = {}
    pauses = []       # the host's garbage-collection pauses, in seconds

    def gc_pause(phase, info, start=[0.0]):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            pauses.append(time.perf_counter() - start[0])

    for label, mesh_ in (("mesh=None", None), ("split", mesh)):
        step = steps.build_train_step(ssc, mesh=mesh_)
        if label == "split" and (step.split is None or not (
                step.split.heads and step.split.features
                and step.split.vocab)):
            raise AssertionError(f"split: the (1, 1) mesh's split is "
                                 f"{step.split}")
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        state, ms, losses, peak1 = (params, steps.make_opt(ssc).init(
            params)), [], [], None
        pauses.clear()
        gc.callbacks.append(gc_pause)
        try:
            for i in range(LAUNCH_STEPS):
                (p, o, loss), dt = _timed(step, *state, batch)
                ms.append(dt)
                losses.append(loss.item())
                if i == 0:
                    peak1 = torch.cuda.max_memory_allocated(dev)
                state = (p, o)
        finally:
            gc.callbacks.remove(gc_pause)
        counts = ops.launch_counts()
        _expect_launches(f"split {label}", counts,
                         {"qg_step": launch_out["launches"]["qg_step"]})
        runs[label] = {"ms": ms, "warm_ms": st.mean(ms[1:]),
                       "losses": losses, "launches": counts,
                       "peak1_over_args": peak1 - base,
                       "gc_ms": 1e3 * sum(pauses), "gc_pauses": len(pauses)}
        if label == "mesh=None":
            host = ([t.cpu() for t in tree_leaves(state[0])],
                    [t.cpu() for t in tree_leaves(state[1])])
        else:
            if losses != runs["mesh=None"]["losses"]:
                raise AssertionError(f"split: losses {losses} vs mesh=None's "
                                     f"{runs['mesh=None']['losses']}")
            _held_bitwise("split: params after the last step", state[0],
                          host[0])
            _held_bitwise("split: m_hat after the last step", state[1],
                          host[1])
            runs[label]["wire"] = dict(step.split.tally.wire)
            runs[label]["gathered"] = step.layout.placement.tally.bytes
        del state, p, o
    del params, batch, host
    torch.cuda.empty_cache()
    out = {"runs": runs, "launches": runs["split"]["launches"],
           "gather_warm_ms": gather_out["warm_ms"],
           "launch_warm_ms": launch_out["warm_ms"]}
    log(f"shard [{smi}] split {LAUNCH_ARCH} fp32 with {SPLIT_KNOBS} on the "
        f"(1, 1) mesh: {LAUNCH_STEPS} steps bit-equal to mesh=None's (losses "
        f"{runs['split']['losses']}, the final params and m_hat); launches "
        f"{runs['split']['launches']}")
    log(f"shard [{smi}] split warm ms/step {runs['split']['warm_ms']:.3f} "
        f"({[round(v, 3) for v in runs['split']['ms']]}) vs mesh=None with "
        f"the knobs {runs['mesh=None']['warm_ms']:.3f} "
        f"({[round(v, 3) for v in runs['mesh=None']['ms']]}), the "
        f"gather-on-use step {gather_out['warm_ms']:.3f}, the launch phase's "
        f"mesh=None step {launch_out['warm_ms']:.3f}; step-1 peak over the "
        f"arguments split {runs['split']['peak1_over_args']} B vs mesh=None "
        f"{runs['mesh=None']['peak1_over_args']} B vs gather-on-use "
        f"{gather_out['peak1'] - gather_out['base']} B; the split's "
        f"collectives {runs['split']['wire']} B received (one rank: 0), "
        f"weights gathered {runs['split']['gathered']} B; the host's "
        f"garbage collection over the {LAUNCH_STEPS} steps: split "
        f"{runs['split']['gc_ms']:.1f} ms in {runs['split']['gc_pauses']} "
        f"pauses, mesh=None {runs['mesh=None']['gc_ms']:.1f} ms in "
        f"{runs['mesh=None']['gc_pauses']}")
    return out


def _split_moe_prefill(dev, mesh, smi) -> dict:
    """granite-moe-3b fp32 at its published widths: ``build_prefill_step``
    at [1, SPLIT_MOE_PREFILL] with the heads and the experts split over the
    (1, 1) mesh against ``mesh=None`` with the same knobs: last logits
    within SHARD_LOGIT_RTOL of max |logit|, argmax equal, every MoE call's
    routes equal (``moe.recording``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    cfg = get_config(SPLIT_MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(LAUNCH_SEED)
    params = tf.init_lm(gen, cfg)
    rng = np.random.default_rng(LAUNCH_SEED + 3)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, SPLIT_MOE_PREFILL),
        dtype=np.int32)).to(dev)
    sp = steps.StepConfig(cfg, InputShape("split_prefill", SPLIT_MOE_PREFILL,
                                          1, "prefill"),
                          n_nodes=1, param_dtype=torch.float32,
                          megatron_attn=True, pin_moe_dispatch=True)
    runs = {}
    ops.reset_launch_counts()
    for label, mesh_ in (("mesh=None", None), ("split", mesh)):
        fn = steps.build_prefill_step(sp, mesh=mesh_)
        if label == "split" and (fn.split is None or not (
                fn.split.heads and fn.split.experts)):
            raise AssertionError(f"split: {SPLIT_MOE_ARCH}'s split is "
                                 f"{fn.split}")
        torch.cuda.reset_peak_memory_stats(dev)
        with moe.recording(routes=True) as rec:
            (logits, cache), dt = _timed(fn, params, tokens)
        runs[label] = {"ms": dt, "peak": torch.cuda.max_memory_allocated(dev),
                       "logits": logits.float(), "routes": [
                           (r["expert_idx"], r["valid"])
                           for r in rec["routes"]]}
        del cache
    _expect_launches("split prefill", ops.launch_counts(), {})
    a, b = runs["mesh=None"].pop("logits"), runs["split"].pop("logits")
    ra, rb = runs["mesh=None"].pop("routes"), runs["split"].pop("routes")
    if not bool(torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("split: granite logits are not finite")
    err = ((a - b).abs().max() / a.abs().max()).item()
    same_argmax = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
    same_routes = len(ra) == len(rb) == cfg.n_layers and all(
        torch.equal(e1, e2) and torch.equal(v1, v2)
        for (e1, v1), (e2, v2) in zip(ra, rb))
    out = {"runs": runs, "rel_err": err, "argmax_equal": same_argmax,
           "routes_equal": same_routes, "moe_calls": len(rb)}
    log(f"shard [{smi}] split {SPLIT_MOE_ARCH} fp32 prefill [1, "
        f"{SPLIT_MOE_PREFILL}] with the heads and the experts split: "
        f"{runs['split']['ms']:.1f} ms (peak {runs['split']['peak']} B) vs "
        f"mesh=None {runs['mesh=None']['ms']:.1f} ms (peak "
        f"{runs['mesh=None']['peak']} B); logits max |diff| / max |logit| "
        f"{err:.3e} (SHARD_LOGIT_RTOL {SHARD_LOGIT_RTOL}), argmax equal "
        f"{same_argmax}, routes of {len(rb)} MoE calls equal {same_routes}")
    if err > SHARD_LOGIT_RTOL or not same_argmax or not same_routes:
        raise AssertionError(f"split: {SPLIT_MOE_ARCH}'s split prefill moved "
                             f"the logits by {err:.3e} of max |logit| (argmax "
                             f"equal {same_argmax}, routes equal "
                             f"{same_routes})")
    del params, a, b
    torch.cuda.empty_cache()
    return out


#: slice 12's pinned decode (``pin_decode_cache``): TinyLlama-1.1B fp32 at
#: full width and depth, one node, a [PIN_BATCH, PIN_PROMPT] prompt through
#: the prefill builder, then PIN_STEPS greedy decode steps, three ways
PIN_BATCH, PIN_PROMPT, PIN_STEPS = 8, 1024, 32
#: the published widths, cut in depth as the lmstack phase cuts them (gemma2
#: at one period: a local and a global layer; mamba2-130m whole, 24
#: layers): a [PIN_CUT_BATCH, PIN_CUT_PROMPT] prefill and PIN_CUT_STEPS
#: pinned decode steps
PIN_CUTS = {"gemma2-27b": {"n_layers": 2},
            ZAMBA2_ARCH: LMSTACK_CUTS[ZAMBA2_ARCH],
            VLM_ARCH: LMSTACK_CUTS[VLM_ARCH],
            MAMBA_ARCH: {}}
PIN_CUT_BATCH, PIN_CUT_PROMPT, PIN_CUT_STEPS = 2, 64, 4
#: the leaves a decode split computes with on the rank's 'model' block
#: (slice 14): (the parent's name, the leaves' names, the block kinds)
PIN_KEPT = (("mixer", ("in_proj", "out_proj", "conv_w"), ("mamba",)),
            ("xattn", ("wq", "wo"), ("cross",)),
            ("mlp", ("gate", "up", "down"), ("cross",)))
#: the collectives a mesh's process group runs, counted a decode step
COLLECTIVES = ("all_gather_into_tensor", "all_reduce",
               "reduce_scatter_tensor", "all_to_all_single")


class _CountCollectives:
    """Counts the calls to each of ``torch.distributed``'s COLLECTIVES
    while it is entered (``launch/mesh.py`` reaches them through the
    module's attributes), and restores them on exit."""

    def __enter__(self):
        import torch.distributed as dist
        self.counts = dict.fromkeys(COLLECTIVES, 0)
        self.saved = {name: getattr(dist, name) for name in COLLECTIVES}

        def wrap(name, fn):
            def call(*args, **kwargs):
                self.counts[name] += 1
                return fn(*args, **kwargs)
            return call

        for name, fn in self.saved.items():
            setattr(dist, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self.saved.items():
            setattr(dist, name, fn)
        return False


def _decode_way(dev, sc, mesh, params, tokens, img, n_steps) -> dict:
    """A prefill of ``tokens`` through ``build_prefill_step`` and
    ``n_steps`` greedy decode steps through ``build_decode_step`` (both on
    ``mesh``): every step's logits (stacked, on the card), the final cache
    (the rank's blocks), the decode step, its ms a step (host clock
    between two syncs), the collectives a decode step by kind
    (:class:`_CountCollectives`) and the peak allocated over the run."""
    import torch
    from repro_torch.launch import steps

    prefill = steps.build_prefill_step(sc, mesh=mesh)
    decode = steps.build_decode_step(sc, mesh=mesh)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    logits, cache = prefill(params, tokens, img)
    out, ms = [logits], []
    with _CountCollectives() as calls:
        for i in range(n_steps):
            token = torch.argmax(logits, -1, keepdim=True)
            (logits, cache), dt = _timed(decode, params, token,
                                         tokens.shape[1] + i, cache)
            out.append(logits)
            ms.append(dt)
    return {"logits": torch.stack(out), "cache": cache, "fn": decode,
            "ms": ms, "peak": torch.cuda.max_memory_allocated(dev),
            "base": base, "collectives": {
                k: v / n_steps for k, v in calls.counts.items() if v}}


def _held_decode(what, got: dict, want: dict) -> None:
    """Every step's logits and the final cache of ``got`` equal
    ``want``'s bit for bit (at one rank a block is the whole leaf)."""
    import torch
    from repro_torch.tree import tree_leaves
    if not torch.equal(got["logits"], want["logits"]):
        err = (got["logits"] - want["logits"]).abs().max().item()
        raise AssertionError(f"{what}: logits not bit-equal (max abs {err})")
    a, b = tree_leaves(got["cache"]), tree_leaves(want["cache"])
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: the final cache is not bit-equal")


def _pinned_decode(dev, mesh, smi) -> dict:
    """Slice 12 on the (1, 1) mesh: TinyLlama-1.1B fp32 decoded three ways
    (mesh=None; gathering each layer's cache, pin off; on the rank's cache
    blocks, pin on, with SPLIT_KNOBS), every step's logits and the final
    cache bit-equal across the three, no cache leaf gathered with the pin,
    no kernel launched (the builders' decode is the plain attention); then
    gemma2-27b, zamba2-7b and the VLM at published widths and mamba2-130m
    whole (PIN_CUTS), the pinned decode with SPLIT_KNOBS bit-equal to
    mesh=None, the mamba mixers' projections and ``conv_w`` and the cross
    blocks' ``wq`` / ``wo`` and MLP on the rank's 'model' blocks
    (PIN_KEPT, slice 14); the collectives a decode step of each."""
    import dataclasses
    import numpy as np
    import statistics as st
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_paths

    t0 = time.perf_counter()
    cfg = get_config(LAUNCH_ARCH)
    rng = np.random.default_rng(LAUNCH_SEED + 4)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(PIN_BATCH, PIN_PROMPT),
        dtype=np.int32)).to(dev)
    sc = steps.StepConfig(cfg, InputShape(
        "pin_decode", PIN_PROMPT + PIN_STEPS, PIN_BATCH, "decode"),
        n_nodes=1, param_dtype=torch.float32)
    params = tf.init_lm(torch.Generator(device=dev).manual_seed(LAUNCH_SEED),
                        cfg)
    ways = {"mesh=None": (sc, None),
            "pin off": (sc, mesh),
            "pinned": (dataclasses.replace(sc, pin_decode_cache=True,
                                           **SPLIT_KNOBS), mesh)}
    ops.reset_launch_counts()
    runs = {}
    for label, (sc_, mesh_) in ways.items():
        runs[label] = _decode_way(dev, sc_, mesh_, params, tokens, None,
                                  PIN_STEPS)
    counts = ops.launch_counts()
    _expect_launches("decode", counts, {})
    want = runs["mesh=None"]
    for label in ("pin off", "pinned"):
        _held_decode(f"decode {label}", runs[label], want)
    pinned, off = runs["pinned"]["fn"], runs["pin off"]["fn"]
    tally = pinned.layout.placement.tally
    if not pinned.pinned or pinned.split is None or off.pinned:
        raise AssertionError(f"decode: pinned {pinned.pinned}, split "
                             f"{pinned.split}, pin off {off.pinned}")
    if tally.caches or not off.layout.placement.tally.caches:
        raise AssertionError(f"decode: cache leaves gathered with the pin "
                             f"{tally.caches}, without "
                             f"{len(off.layout.placement.tally.caches)}")
    out = {"launches": counts, "runs": {
        label: {"ms": r["ms"], "warm_ms": st.mean(r["ms"][1:]),
                "peak": r["peak"], "peak_over_args": r["peak"] - r["base"],
                "collectives": r["collectives"]}
        for label, r in runs.items()},
        "cache_leaves_gathered": {
            "pinned": len(tally.caches),
            "pin off": len(off.layout.placement.tally.caches)},
        "weights_gathered": sorted("/".join(map(str, p)) for p in
                                   tally.leaves)}
    tokens_equal = bool(torch.equal(runs["pinned"]["logits"].argmax(-1),
                                    want["logits"].argmax(-1)))
    del runs, want, params
    torch.cuda.empty_cache()
    r = out["runs"]
    log(f"shard [{smi}] decode {LAUNCH_ARCH} fp32, one node, prefill "
        f"[{PIN_BATCH}, {PIN_PROMPT}] then {PIN_STEPS} greedy steps on the "
        f"(1, 1) mesh: mesh=None, pin off and pinned with {SPLIT_KNOBS} "
        f"give every step's logits and the final cache bit for bit (tokens "
        f"equal {tokens_equal}); cache leaves gathered: pinned "
        f"{out['cache_leaves_gathered']['pinned']} (0 bytes), pin off "
        f"{out['cache_leaves_gathered']['pin off']} gathers; weights "
        f"gathered with the pin (their 'data' blocks: the split keeps "
        f"'model') {out['weights_gathered']}; launches {counts}")
    log(f"shard [{smi}] decode warm ms/step: mesh=None "
        f"{r['mesh=None']['warm_ms']:.3f}, pin off {r['pin off']['warm_ms']:.3f}"
        f", pinned {r['pinned']['warm_ms']:.3f}; max_memory_allocated "
        + ", ".join(f"{k} {v['peak']} B ({v['peak_over_args']} B over the "
                    "params)" for k, v in r.items())
        + "; collectives a step: " + ", ".join(
            f"{k} {sum(v['collectives'].values()):g} {v['collectives']}"
            for k, v in r.items() if v["collectives"]))

    out["cuts"] = {}
    for arch, cut in PIN_CUTS.items():
        cfg = dataclasses.replace(get_config(arch), **cut)
        params = tf.init_lm(torch.Generator(device=dev).manual_seed(
            LAUNCH_SEED), cfg)
        for j, kind in enumerate(cfg.period):
            if kind == "cross":
                params["blocks"][j]["gate_attn"].fill_(VLM_GATE)
                params["blocks"][j]["gate_mlp"].fill_(VLM_GATE)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(PIN_CUT_BATCH, PIN_CUT_PROMPT),
            dtype=np.int32)).to(dev)
        img = None
        if cfg.n_image_tokens:
            img = torch.from_numpy(rng.standard_normal(
                (PIN_CUT_BATCH, cfg.n_image_tokens, cfg.d_model)).astype(
                    np.float32)).to(dev)
        sc = steps.StepConfig(cfg, InputShape(
            "pin_cut", PIN_CUT_PROMPT + PIN_CUT_STEPS, PIN_CUT_BATCH,
            "decode"), n_nodes=1, param_dtype=torch.float32)
        ops.reset_launch_counts()
        want = _decode_way(dev, sc, None, params, toks, img, PIN_CUT_STEPS)
        got = _decode_way(dev, dataclasses.replace(
            sc, pin_decode_cache=True, **SPLIT_KNOBS), mesh, params, toks,
            img, PIN_CUT_STEPS)
        _expect_launches(f"decode {arch}", ops.launch_counts(), {})
        _held_decode(f"decode {arch}", got, want)
        fn = got["fn"]
        if fn.layout.placement.tally.caches:
            raise AssertionError(f"decode {arch}: cache leaves gathered")
        kept = [path for path in tree_paths(params) if len(path) > 1 and any(
            path[-2] == parent and path[-1] in names and cfg.period[
                path[1] if path[0] == "blocks" else 0] in kinds
            for parent, names, kinds in PIN_KEPT)]
        whole = [p for p in kept if not fn.split.keep(p)]
        if whole or (("mamba" in cfg.period or "cross" in cfg.period)
                     and not kept):
            raise AssertionError(f"decode {arch}: the split gathers "
                                 f"{whole} whole along 'model'")
        warm = st.mean(got["ms"][1:]) / st.mean(want["ms"][1:])
        calls = sum(got["collectives"].values())
        out["cuts"][arch] = {"ms": got["ms"], "mesh_none_ms": want["ms"],
                             "peak": got["peak"], "split_over_none": warm,
                             "collectives": got["collectives"],
                             "kept": len(kept)}
        log(f"shard [{smi}] decode {arch} {cut} at published widths, fp32: "
            f"prefill [{PIN_CUT_BATCH}, {PIN_CUT_PROMPT}] and "
            f"{PIN_CUT_STEPS} pinned steps with {SPLIT_KNOBS} bit-equal to "
            f"mesh=None (logits, final cache), no cache leaf gathered, "
            f"{len(kept)} mixer / cross leaves on their 'model' blocks; ms a "
            f"step pinned {[round(v, 3) for v in got['ms']]} vs mesh=None "
            f"{[round(v, 3) for v in want['ms']]} (warm {warm:.3f}x); "
            f"collectives a step {calls:g} {got['collectives']}")
        del params, want, got, fn
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


#: slice 13 (the mamba and cross blocks under the split): zamba2-7b and
#: the VLM at their published widths, cut in depth as LMSTACK_CUTS cuts
#: them, fp32, SPLIT_KNOBS on the (1, 1) mesh: zamba2 a [1,
#: SSM_SPLIT_PREFILL] prefill with ``use_pallas`` and a train step of
#: SSM_SPLIT_TRAIN tokens a node (2 nodes), the VLM a [1, SSM_SPLIT_TRAIN]
#: prefill and a train step of one node (two nodes of its fp32 state, the
#: new state and the gradients pass 80 GB)
SSM_SPLIT_PREFILL, SSM_SPLIT_TRAIN = 4096, 1024
SSM_SPLIT_NODES = {ZAMBA2_ARCH: 2, VLM_ARCH: 1}
#: the SSM heads a rank holds of zamba2's 112 on the reference's meshes,
#: 'model' 2, 4 and 16: the scan at [1, SSM_SPLIT_PREFILL, H, 64, 64]
SSM_SPLIT_HEADS = (56, 28, 7)


def _split_ssm_scan(dev, smi) -> dict:
    """``ssd_scan`` at zamba2's shape on a rank's heads (SSM_SPLIT_HEADS),
    x, B and C views of one ``[x of the heads | B | C]`` buffer as the
    split's conv output lays them out: y and the final state within
    SSD_TOL of the plain version, the kernel's ms (CUDA graph) beside the
    plain one's and the bound (operations over 165 TFLOP/s).  These calls
    are not the main path's (their launches are not counted there)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as K

    atol, rtol = SSD_TOL["float32"]
    out = {}
    for h in SSM_SPLIT_HEADS:
        case = (1, SSM_SPLIT_PREFILL, h, 64, 64, 128, 1.0)
        x, dt, a, bm, cm, d = _ssd_inputs(case, torch.float32, dev, 90 + h)
        n, hp = bm.shape[-1], h * x.shape[-1]
        buf = torch.cat([x.flatten(2), bm, cm], dim=-1)
        x, bm, cm = (buf[..., :hp].unflatten(-1, (h, x.shape[-1])),
                     buf[..., hp:hp + n], buf[..., hp + n:])
        got, want = K.ssd_scan(x, dt, a, bm, cm, d), ref.ssd_scan(
            x, dt, a, bm, cm, d)
        errs = []
        for g, w, what in zip(got, want, ("y", "state")):
            diff = (g - w).abs()
            excess = float((diff - rtol * w.abs()).max())
            if not torch.isfinite(g).all() or excess > atol:
                raise AssertionError(
                    f"split ssd_scan at {h} heads: {what} off its plain "
                    f"version by {excess:.3e} beyond rtol {rtol}")
            errs.append(float(diff.max()))
        flops, nbytes = _ssd_cost(case)
        bound, by = _bound(nbytes, flops, PEAK_3XTF32_FLOPS)
        out[h] = {"shape": case[:6], "max_abs_err": max(errs),
                  "ms": _time_ms(lambda: K.ssd_scan(x, dt, a, bm, cm, d), 4),
                  "plain_ms": _time_ms(lambda: ref.ssd_scan(
                      x, dt, a, bm, cm, d), 1, reps=3),
                  "bound_ms": bound, "bound_by": by, "library_ms": None}
        log(f"shard [{smi}] split ssd_scan B,S,H,P,N,chunk={case[:6]} fp32, "
            f"x/B/C views of [x | B | C] (token stride {buf.stride(1)}): "
            f"max abs err y {errs[0]:.3e}, state {errs[1]:.3e} (atol "
            f"{atol}, rtol {rtol}); kernel {out[h]['ms']:.6f} ms, plain "
            f"{out[h]['plain_ms']:.6f} ms, bound {bound:.6f} ms ({by})")
        del x, dt, a, bm, cm, d, buf, got, want
    torch.cuda.empty_cache()
    return out


def _held_equal(what, got, want) -> None:
    """Two trees (or tensors) on the card equal bit for bit."""
    import torch
    from repro_torch.tree import tree_leaves
    a, b = tree_leaves(got), tree_leaves(want)
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: not bit-equal to mesh=None's")


def _split_ssm_cross(dev, mesh, smi) -> dict:
    """Slice 13 on the (1, 1) mesh with SPLIT_KNOBS: zamba2-7b's mamba
    blocks on the rank's SSM heads and the VLM's cross block on its heads
    and features, each against mesh=None with the same knobs, bit for bit
    (at one rank every collective returns its input's values).  zamba2: a
    [1, SSM_SPLIT_PREFILL] prefill through ``tf.prefill`` with
    ``use_pallas`` (logits and every state and cache), each scan kernel
    launched once a mamba layer, and a train step of ``build_train_step``
    (loss, params and m_hat; ``qg_step`` once a step for every
    ``qg_update.MAX_LEAVES`` leaves); the VLM: a [1, SSM_SPLIT_TRAIN]
    prefill and a train step of one node (QHM: no kernel).  No ``in_proj`` /
    ``out_proj`` / ``xattn`` / cross MLP block gathered along 'model' (at
    one rank the prefill's FSDP gathers of their 'data' blocks receive 0
    bytes); ms and ``max_memory_allocated`` of each run; the scan at a
    rank's head counts (:func:`_split_ssm_scan`)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops, qg_update
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    rng = np.random.default_rng(LAUNCH_SEED + 5)
    out = {"launches": {}, "runs": {}}
    split_keys = ("in_proj", "out_proj", "xattn", "mlp")

    def count(label, want):
        """The launches since ``run`` reset them; the split runs' are the
        part's main path's (the ``ssm_split launches``)."""
        counts = ops.launch_counts()
        _expect_launches(label, counts, want)
        if "mesh=None" not in label:
            for k, v in counts.items():
                out["launches"][k] = out["launches"].get(k, 0) + v

    def run(label, fn):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        res, ms = _timed(fn)
        peak = torch.cuda.max_memory_allocated(dev)
        out["runs"][label] = {"ms": ms, "peak": peak,
                              "peak_over_args": peak - base}
        return res

    for arch in (ZAMBA2_ARCH, VLM_ARCH):
        cfg = dataclasses.replace(get_config(arch), **LMSTACK_CUTS[arch])
        mambas = sum(k == "mamba" for k in cfg.period) * cfg.n_periods \
            + (cfg.tail_layers if cfg.period[0] == "mamba" else 0)
        attns = sum(k in tf.ATTN_KINDS for k in cfg.period) * cfg.n_periods \
            + (cfg.n_periods if cfg.shared_attn_every else 0)
        seq = SSM_SPLIT_PREFILL if arch == ZAMBA2_ARCH else SSM_SPLIT_TRAIN
        params = tf.init_lm(torch.Generator(device=dev).manual_seed(
            LAUNCH_SEED), cfg)
        for j, kind in enumerate(cfg.period):
            if kind == "cross":
                params["blocks"][j]["gate_attn"].fill_(VLM_GATE)
                params["blocks"][j]["gate_mlp"].fill_(VLM_GATE)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(1, seq), dtype=np.int32)).to(dev)
        img = None
        if cfg.n_image_tokens:
            img = torch.from_numpy(rng.standard_normal(
                (1, cfg.n_image_tokens, cfg.d_model)).astype(
                    np.float32)).to(dev)
        psc = steps.StepConfig(cfg, InputShape("split_prefill", seq, 1,
                                               "prefill"),
                               n_nodes=1, param_dtype=torch.float32,
                               **SPLIT_KNOBS)
        fn = steps.build_prefill_step(psc, mesh=mesh)
        sp, lay = fn.split, fn.layout
        if sp is None or not (sp.heads and sp.features and sp.ssm == (
                "mamba" in cfg.period)):
            raise AssertionError(f"split: {arch}'s split is {sp}")
        kw = dict(img=img, ssd_chunk=128, cache_len=seq, repeat_kv=True,
                  use_pallas=True)
        # warm-up (cuBLAS, the allocator, each kernel's first launch), so
        # that the first timed run is not charged for them
        tf.prefill(params, tokens[:, :256], cfg, **dict(kw, cache_len=256))
        want = run(f"{arch} prefill mesh=None", lambda: tf.prefill(
            params, tokens, cfg, **kw))
        want_launches = {k: mambas for k in SSD_KERNELS}
        want_launches["flash_attention"] = attns
        count(f"split {arch} prefill mesh=None", want_launches)
        got = run(f"{arch} prefill split", lambda: tf.prefill(
            lay.local("params", params), tokens, cfg, placement=lay.placement,
            split=sp, **kw))
        count(f"split {arch} prefill", want_launches)
        _held_equal(f"split {arch} prefill logits and caches", got, want)
        if not torch.isfinite(got[0]).all():
            raise AssertionError(f"split {arch}: the logits are not finite")
        moved = sorted("/".join(map(str, p)) for p in
                       lay.placement.tally.leaves
                       if any(k in p for k in split_keys) and not sp.keep(p))
        if moved:
            raise AssertionError(f"split {arch}: gathered whole {moved}")
        del got, want

        tsc = steps.StepConfig(cfg, InputShape(
            "split_train", SSM_SPLIT_TRAIN, SSM_SPLIT_NODES[arch], "train"),
            n_nodes=SSM_SPLIT_NODES[arch], param_dtype=torch.float32,
            **SPLIT_KNOBS)
        del params
        torch.cuda.empty_cache()
        stacked, batch = _launch_inputs(dev, tsc)
        for j, kind in enumerate(cfg.period):
            if kind == "cross":
                stacked["blocks"][j]["gate_attn"].fill_(VLM_GATE)
                stacked["blocks"][j]["gate_mlp"].fill_(VLM_GATE)
        if img is not None:
            batch["image_embeds"] = img.expand(tsc.n_nodes, *img.shape)
        # one qg_step launch a step for every MAX_LEAVES leaves; one node
        # trains with QHM (``steps.make_opt``'s n_nodes=1 reduction),
        # whose chain takes no kernel
        qg_launches = -(-len(tree_leaves(stacked)) // qg_update.MAX_LEAVES) \
            if tsc.n_nodes > 1 else 0
        for label, mesh_ in (("mesh=None", None), ("split", mesh)):
            step = steps.build_train_step(tsc, mesh=mesh_)
            opt = steps.make_opt(tsc).init(stacked)
            res = run(f"{arch} train {label}",
                      lambda: step(stacked, opt, batch))
            count(f"split {arch} train {label}",
                  {"qg_step": qg_launches} if qg_launches else {})
            if label == "mesh=None":
                # m_hat to the host where the split step's working set (its
                # m_hat and the mesh=None step's peak over its arguments)
                # would not fit beside it (the VLM's fp32 state)
                want, want_m = res, None
                need = _nbytes(opt) + out["runs"][f"{arch} train {label}"][
                    "peak_over_args"] + (4 << 30)
                del opt, res
                torch.cuda.empty_cache()
                if torch.cuda.mem_get_info(dev)[0] < need:
                    want_m = [t.cpu() for t in tree_leaves(want[1])]
                    want = (want[0], None, want[2])
                    torch.cuda.empty_cache()
            else:
                del opt
                tally, tsp = step.layout.placement.tally, step.split
                moved = [path for path in tally.leaves if any(
                    k in path for k in split_keys) and not tsp.keep(path)]
                if tsp is None or moved:
                    raise AssertionError(f"split {arch} train: gathered "
                                         f"whole {sorted(moved)}")
                out["runs"][f"{arch} train split"]["gathered"] = sorted(
                    "/".join(map(str, path)) for path in tally.leaves
                    if not tsp.keep(path))
        _held_equal(f"split {arch} train loss and params",
                    (res[0], res[2]), (want[0], want[2]))
        if want_m is None:
            _held_equal(f"split {arch} train m_hat", res[1], want[1])
        else:
            _held_bitwise(f"split {arch} train m_hat", res[1], want_m)
        r = out["runs"]
        r[f"{arch} train split"]["m_hat_to_host"] = want_m is not None
        log(f"shard [{smi}] split {arch} max_memory_allocated: " + ", ".join(
            f"{k.split(' ', 1)[1]} {v['peak']} B" for k, v in r.items()
            if k.startswith(arch)) + f"; mesh=None's m_hat held on the host "
            f"for the comparison: {want_m is not None}")
        log(f"shard [{smi}] split {arch} {LMSTACK_CUTS[arch]} fp32 with "
            f"{SPLIT_KNOBS}: prefill [1, {seq}] (use_pallas) bit-equal to "
            f"mesh=None (logits, every state and cache), "
            f"{r[f'{arch} prefill split']['ms']:.1f} ms (peak over the "
            f"params {r[f'{arch} prefill split']['peak_over_args']} B) vs "
            f"{r[f'{arch} prefill mesh=None']['ms']:.1f} ms "
            f"({r[f'{arch} prefill mesh=None']['peak_over_args']} B); train "
            f"{tsc.n_nodes} node(s) x [1, {SSM_SPLIT_TRAIN}] bit-equal (loss "
            f"{res[2].item()}, params, m_hat), "
            f"{r[f'{arch} train split']['ms']:.1f} ms "
            f"({r[f'{arch} train split']['peak_over_args']} B) vs "
            f"{r[f'{arch} train mesh=None']['ms']:.1f} ms "
            f"({r[f'{arch} train mesh=None']['peak_over_args']} B); weights "
            f"the split step gathers whole "
            f"{r[f'{arch} train split']['gathered']} (the rest: their 'data' "
            f"blocks where 'data' stores them, 0 bytes at one rank); "
            f"launches "
            f"{want_launches} a prefill, qg_step {qg_launches} a step")
        del stacked, batch, res, want, want_m
        torch.cuda.empty_cache()
    out["scan"] = _split_ssm_scan(dev, smi)
    out["seconds"] = time.perf_counter() - t0
    return out


#: slice 15: musicgen-medium at its published widths (d_model 1536, 24
#: heads MHA, ff 6144, vocab 2048), cut to UNEVEN_LAYERS layers, fp32, one
#: node: UNEVEN_STEPS train steps of [1, UNEVEN_SEQ] and a [1, UNEVEN_SEQ]
#: prefill with SPLIT_KNOBS on the (1, 1) mesh
UNEVEN_ARCH, UNEVEN_LAYERS, UNEVEN_SEQ, UNEVEN_STEPS = \
    "musicgen-medium", 4, 4096, 3
#: the configs whose attention heads the production mesh's 'model' (16)
#: does not divide: the split takes them as GSPMD pads them
UNEVEN_ARCHS = ("granite-moe-3b-a800m", "musicgen-medium", "arctic-480b")


def _uneven_rule() -> dict:
    """``Split.make`` on the production mesh (a ``MeshShape``: no card) for
    each of UNEVEN_ARCHS, train and prefill, with SPLIT_KNOBS: the heads
    on, no block left whole, rank 0 (the dry run's trace) with ``ceil(H /
    16)`` heads and the last ranks with none."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(device="meta")
    out = {}
    for arch in UNEVEN_ARCHS:
        cfg = get_config(arch)
        for kind in ("train", "prefill"):
            sc = steps.StepConfig(cfg, InputShape(f"rule_{kind}", 4096, 16,
                                                  kind),
                                  n_nodes=16 if kind == "train" else 1,
                                  param_dtype=torch.bfloat16, **SPLIT_KNOBS)
            sp = steps.make_split(sc, steps.Layout.make(sc, mesh, kind=kind))
            c = -(-cfg.n_heads // 16)
            counts = [sp.head_range(rank=r)[1] for r in range(16)] \
                if sp is not None else None
            if sp is None or not sp.heads or sp.whole or cfg.n_heads % 16 \
                    == 0 or sp.head_range() != (0, c) or counts[-1] != 0:
                raise AssertionError(
                    f"uneven: {arch} {kind} on the production mesh: split "
                    f"{sp and (sp.heads, sp.whole)}, heads a rank {counts}")
            out[f"{arch} {kind}"] = counts
    return out


def _split_uneven(dev, mesh, smi) -> dict:
    """Slice 15: musicgen-medium, whose 24 heads the production mesh's
    'model' 16 does not divide, at its published widths cut to
    UNEVEN_LAYERS layers, fp32, one node (QHM: no kernel), with SPLIT_KNOBS
    on the (1, 1) mesh against mesh=None with the same knobs, bit for bit
    (at one rank every collective returns its input's values and the
    padded split is the whole): UNEVEN_STEPS train steps (losses, params,
    m_hat) and a [1, UNEVEN_SEQ] prefill through the builders (logits and
    every cache leaf); ``heads`` on, no attention weight gathered along
    'model', no kernel launched; ms and ``max_memory_allocated`` of each;
    the rule on the production mesh (:func:`_uneven_rule`)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    out = {"rule": _uneven_rule(), "runs": {}, "launches": {}}
    cfg = dataclasses.replace(get_config(UNEVEN_ARCH), n_layers=UNEVEN_LAYERS)
    attn = ("wq", "wk", "wv", "wo")

    def run(label, fn):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        res, ms = _timed(fn)
        counts = ops.launch_counts()
        _expect_launches(f"uneven {label}", counts, {})
        if "mesh=None" not in label:
            _add_counts(out["launches"], counts)
        out["runs"][label] = {
            "ms": ms, "peak": torch.cuda.max_memory_allocated(dev)}
        return res

    def split_of(fn, label):
        sp = fn.split
        if sp is None or not sp.heads:
            raise AssertionError(f"uneven {label}: the split is {sp}")
        moved = sorted("/".join(map(str, p))
                       for p in fn.layout.placement.tally.leaves
                       if p[-1] in attn and not sp.keep(p))
        if moved:
            raise AssertionError(f"uneven {label}: attention weights "
                                 f"gathered whole {moved}")

    tsc = steps.StepConfig(cfg, InputShape("uneven_train", UNEVEN_SEQ, 1,
                                           "train"),
                           n_nodes=1, param_dtype=torch.float32,
                           **SPLIT_KNOBS)
    params, batch = _launch_inputs(dev, tsc)
    res = {}
    for label, mesh_ in (("mesh=None", None), ("split", mesh)):
        step = steps.build_train_step(tsc, mesh=mesh_)
        state, losses, ms = (params, steps.make_opt(tsc).init(params)), [], []
        for i in range(UNEVEN_STEPS):
            p, o, loss = run(f"train {label} {i}",
                             lambda: step(*state, batch))
            state = (p, o)
            losses.append(loss.item())
        res[label] = (losses, state)
        if mesh_ is not None:
            split_of(step, "train")
        del state, p, o
    (want_l, want), (got_l, got) = res["mesh=None"], res["split"]
    if got_l != want_l:
        raise AssertionError(f"uneven train: losses {got_l} vs mesh=None's "
                             f"{want_l}")
    _held_equal("uneven train params and m_hat", got, want)
    del res, got, want, params, batch
    torch.cuda.empty_cache()

    psc = dataclasses.replace(tsc, shape=InputShape(
        "uneven_prefill", UNEVEN_SEQ, 1, "prefill"))
    params = tf.init_lm(torch.Generator(device=dev).manual_seed(
        LAUNCH_SEED), cfg)
    tokens = torch.from_numpy(np.random.default_rng(LAUNCH_SEED + 7).integers(
        0, cfg.vocab_size, size=(1, UNEVEN_SEQ), dtype=np.int32)).to(dev)
    got = {}
    for label, mesh_ in (("mesh=None", None), ("split", mesh)):
        fn = steps.build_prefill_step(psc, mesh=mesh_)
        got[label] = run(f"prefill {label}", lambda: fn(params, tokens))
        if mesh_ is not None:
            split_of(fn, "prefill")
    _held_equal("uneven prefill logits and cache", got["split"],
                got["mesh=None"])
    if not torch.isfinite(got["split"][0]).all():
        raise AssertionError("uneven prefill: the logits are not finite")
    del got, params
    torch.cuda.empty_cache()
    r = out["runs"]
    warm = {label: [r[f"train {label} {i}"]["ms"]
                    for i in range(UNEVEN_STEPS)]
            for label in ("mesh=None", "split")}
    log(f"shard [{smi}] uneven heads: Split.make on the production mesh "
        f"(16, 16) with {SPLIT_KNOBS}: heads on, none whole, heads a rank "
        f"{out['rule']}")
    log(f"shard [{smi}] uneven {UNEVEN_ARCH} ({cfg.n_heads} heads, d_model "
        f"{cfg.d_model}, ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{UNEVEN_LAYERS} layers) fp32 with {SPLIT_KNOBS} on the (1, 1) "
        f"mesh: {UNEVEN_STEPS} train steps of [1, {UNEVEN_SEQ}] bit-equal to "
        f"mesh=None (losses {got_l}, params, m_hat), ms/step split "
        f"{[round(v, 3) for v in warm['split']]} vs mesh=None "
        f"{[round(v, 3) for v in warm['mesh=None']]}, max_memory_allocated "
        f"split {[r[f'train split {i}']['peak'] for i in range(UNEVEN_STEPS)]}"
        f" B vs mesh=None "
        f"{[r[f'train mesh=None {i}']['peak'] for i in range(UNEVEN_STEPS)]}"
        f" B; prefill [1, {UNEVEN_SEQ}] bit-equal (logits, cache), "
        f"{r['prefill split']['ms']:.1f} ms (max_memory_allocated "
        f"{r['prefill split']['peak']} B) vs mesh=None "
        f"{r['prefill mesh=None']['ms']:.1f} ms "
        f"({r['prefill mesh=None']['peak']} B); launches "
        f"{ {k: v for k, v in out['launches'].items() if v} }")
    out["seconds"] = time.perf_counter() - t0
    return out


#: slice 16's rows (``launch/sharding.Rows``: a node's batch rows over the
#: data axes, each rank computing its own): TinyLlama-1.1B at its published
#: widths cut to ROWS_LAYERS layers, fp32, on the (1, 1) mesh, where the row
#: path runs with R = 1 (its collectives called on the one-rank 'data'
#: group); ROWS_STEPS train steps of 2 nodes x 2 sequences and of one node
#: (QHM) x 2, ROWS_SEQ tokens; a [ROWS_BATCH, ROWS_PROMPT] prefill and
#: ROWS_DECODE unpinned decode steps; granite-moe-3b cut to
#: ROWS_MOE_LAYERS layers at ROWS_MOE_CAPACITY (pairs drop), a
#: [ROWS_BATCH, ROWS_MOE_PREFILL] prefill
ROWS_LAYERS, ROWS_SEQ, ROWS_STEPS = 4, 1024, 3
ROWS_BATCH, ROWS_PROMPT, ROWS_DECODE = 4, 4096, 8
ROWS_MOE_LAYERS, ROWS_MOE_PREFILL, ROWS_MOE_CAPACITY = 2, 1024, 0.5


def _rows_part(dev, mesh, smi) -> dict:
    """Slice 16 on the (1, 1) mesh: the builders with a node's rows over
    'data' (``Layout.rows``), against mesh=None bit for bit (at one rank
    every collective returns its input and R = 1 divides exactly): the
    train steps (losses, params, m_hat; ``qg_step`` a step with 2 nodes,
    none with one), the prefill and the decode steps (every step's
    logits, the final cache), granite's prefill (logits, cache, every MoE
    call's routes, the pairs dropped); each run's row collectives called
    (``Rows.calls``); ms and ``max_memory_allocated`` beside mesh=None's."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    out = {"runs": {}, "launches": {}, "calls": {}}
    cfg = dataclasses.replace(get_config(LAUNCH_ARCH), n_layers=ROWS_LAYERS)

    def rows_of(fn, label, want_calls):
        rows = fn.layout.rows
        if rows is None or rows.axes != ("data",):
            raise AssertionError(f"rows {label}: the layout's rows are "
                                 f"{rows}")
        if not all(rows.calls.get(k) for k in want_calls):
            raise AssertionError(f"rows {label}: collectives called "
                                 f"{rows.calls}, want {want_calls}")
        out["calls"][label] = dict(rows.calls)

    # train: 2 nodes (qg_step a step) and one node (QHM: FSDP over 'data',
    # so the gathers' backward reduce-scatters)
    for name, n, want, calls in (
            ("2 nodes", 2, {"qg_step": 1}, ("all-reduce",)),
            ("QHM", 1, {}, ("all-reduce", "reduce-scatter"))):
        sc = steps.StepConfig(cfg, InputShape("rows_train", ROWS_SEQ, 2 * n,
                                              "train"),
                              n_nodes=n, param_dtype=torch.float32)
        params, batch = _launch_inputs(dev, sc)
        res = {}
        for label, mesh_ in (("mesh=None", None), ("rows", mesh)):
            step = steps.build_train_step(sc, mesh=mesh_)
            state, losses = (params, steps.make_opt(sc).init(params)), []
            for i in range(ROWS_STEPS):
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                ops.reset_launch_counts()
                (p, o, loss), ms = _timed(step, *state, batch)
                counts = ops.launch_counts()
                _expect_launches(f"rows train {name} {label}", counts, want)
                if label == "rows":
                    _add_counts(out["launches"], counts)
                out["runs"][f"train {name} {label} {i}"] = {
                    "ms": ms, "peak": torch.cuda.max_memory_allocated(dev)}
                state = (p, o)
                losses.append(loss.item())
            res[label] = (losses, state)
            if mesh_ is not None:
                rows_of(step, f"train {name}", calls)
            del state, p, o
        (want_l, want_s), (got_l, got_s) = res["mesh=None"], res["rows"]
        if got_l != want_l:
            raise AssertionError(f"rows train {name}: losses {got_l} vs "
                                 f"mesh=None's {want_l}")
        _held_equal(f"rows train {name} params and m_hat", got_s, want_s)
        if not np.all(np.isfinite(got_l)):
            raise AssertionError(f"rows train {name}: losses {got_l}")
        out[f"losses {name}"] = got_l
        del res, got_s, want_s, params, batch
        torch.cuda.empty_cache()

    # a prefill and the unpinned decode steps
    sc = steps.StepConfig(cfg, InputShape(
        "rows_decode", ROWS_PROMPT + ROWS_DECODE, ROWS_BATCH, "decode"),
        n_nodes=1, param_dtype=torch.float32)
    params = tf.init_lm(torch.Generator(device=dev).manual_seed(LAUNCH_SEED),
                        cfg)
    tokens = torch.from_numpy(np.random.default_rng(LAUNCH_SEED + 9).integers(
        0, cfg.vocab_size, size=(ROWS_BATCH, ROWS_PROMPT),
        dtype=np.int32)).to(dev)
    ops.reset_launch_counts()
    ways = {}
    for label, mesh_ in (("mesh=None", None), ("rows", mesh)):
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        ways[label] = _decode_way(dev, sc, mesh_, params, tokens, None,
                                  ROWS_DECODE)
        ways[label]["s"] = time.perf_counter() - t1
    _expect_launches("rows decode", ops.launch_counts(), {})
    if ways["rows"]["fn"].pinned:
        raise AssertionError("rows decode: the decode is pinned")
    rows_of(ways["rows"]["fn"], "decode", ("all-gather",))
    _held_decode("rows decode", ways["rows"], ways["mesh=None"])
    if not torch.isfinite(ways["rows"]["logits"]).all():
        raise AssertionError("rows decode: the logits are not finite")
    for label, w in ways.items():
        out["runs"][f"decode {label}"] = {
            "ms": w["ms"], "peak": w["peak"], "s": w["s"]}
    del ways, params, tokens
    torch.cuda.empty_cache()

    # granite's prefill at a capacity where pairs drop: the node's queue
    gcfg = get_config(SPLIT_MOE_ARCH)
    gcfg = dataclasses.replace(gcfg, n_layers=ROWS_MOE_LAYERS,
                               moe=dataclasses.replace(
                                   gcfg.moe,
                                   capacity_factor=ROWS_MOE_CAPACITY))
    gsc = steps.StepConfig(gcfg, InputShape(
        "rows_moe", ROWS_MOE_PREFILL, ROWS_BATCH, "prefill"), n_nodes=1,
        param_dtype=torch.float32)
    params = tf.init_lm(torch.Generator(device=dev).manual_seed(LAUNCH_SEED),
                        gcfg)
    tokens = torch.from_numpy(np.random.default_rng(LAUNCH_SEED + 10).integers(
        0, gcfg.vocab_size, size=(ROWS_BATCH, ROWS_MOE_PREFILL),
        dtype=np.int32)).to(dev)
    got = {}
    ops.reset_launch_counts()
    for label, mesh_ in (("mesh=None", None), ("rows", mesh)):
        fn = steps.build_prefill_step(gsc, mesh=mesh_)
        torch.cuda.reset_peak_memory_stats(dev)
        with moe.recording(routes=True) as rec:
            (logits, cache), ms = _timed(fn, params, tokens)
        got[label] = {"out": (logits, cache), "routes": [
            (r["expert_idx"], r["valid"]) for r in rec["routes"]],
            "dropped": int(rec["dropped"]), "routed": int(rec["routed"])}
        out["runs"][f"moe prefill {label}"] = {
            "ms": ms, "peak": torch.cuda.max_memory_allocated(dev)}
        if mesh_ is not None:
            rows_of(fn, "moe prefill", ("all-gather", "all-reduce"))
    _expect_launches("rows moe prefill", ops.launch_counts(), {})
    a, b = got["mesh=None"], got["rows"]
    _held_equal("rows moe prefill logits and cache", b["out"], a["out"])
    same_routes = len(a["routes"]) == len(b["routes"]) == ROWS_MOE_LAYERS \
        and all(torch.equal(e1, e2) and torch.equal(v1, v2)
                for (e1, v1), (e2, v2) in zip(a["routes"], b["routes"]))
    if not same_routes or a["dropped"] != b["dropped"] or not a["dropped"]:
        raise AssertionError(
            f"rows moe prefill: routes equal {same_routes}, dropped "
            f"{b['dropped']} vs mesh=None's {a['dropped']} (of "
            f"{a['routed']})")
    out["moe"] = {"dropped": b["dropped"], "routed": b["routed"]}
    del got, a, b, params, tokens, logits, cache
    torch.cuda.empty_cache()

    r = out["runs"]

    def col(name, label):
        return [round(r[f"train {name} {label} {i}"]["ms"], 3)
                for i in range(ROWS_STEPS)], \
            [r[f"train {name} {label} {i}"]["peak"]
             for i in range(ROWS_STEPS)]

    for name in ("2 nodes", "QHM"):
        (ms_r, pk_r), (ms_n, pk_n) = col(name, "rows"), col(name,
                                                           "mesh=None")
        log(f"shard [{smi}] rows {LAUNCH_ARCH} ({ROWS_LAYERS} layers, fp32) "
            f"train {name} x [2, {ROWS_SEQ}] a node on the (1, 1) mesh, the "
            f"rows over 'data': {ROWS_STEPS} steps "
            f"bit-equal to mesh=None (losses {out[f'losses {name}']}, "
            f"params, m_hat); ms/step rows {ms_r} vs mesh=None {ms_n}; "
            f"max_memory_allocated rows {pk_r} B vs mesh=None {pk_n} B; "
            f"row collectives called {out['calls'][f'train {name}']}")
    d_r, d_n = r["decode rows"], r["decode mesh=None"]
    log(f"shard [{smi}] rows {LAUNCH_ARCH} ({ROWS_LAYERS} layers, fp32) "
        f"prefill [{ROWS_BATCH}, {ROWS_PROMPT}] and {ROWS_DECODE} unpinned "
        f"decode steps, the rows over 'data': every step's logits and the "
        f"final cache bit-equal to mesh=None; decode ms/step rows "
        f"{[round(v, 3) for v in d_r['ms']]} vs mesh=None "
        f"{[round(v, 3) for v in d_n['ms']]}; prefill + decode "
        f"{d_r['s']:.2f} s vs {d_n['s']:.2f} s; max_memory_allocated rows "
        f"{d_r['peak']} B vs mesh=None {d_n['peak']} B; row collectives "
        f"called {out['calls']['decode']}")
    m_r, m_n = r["moe prefill rows"], r["moe prefill mesh=None"]
    log(f"shard [{smi}] rows {SPLIT_MOE_ARCH} ({ROWS_MOE_LAYERS} layers, "
        f"fp32, capacity factor {ROWS_MOE_CAPACITY}) prefill [{ROWS_BATCH}, "
        f"{ROWS_MOE_PREFILL}], the node's queue: logits, cache and the "
        f"routes of {ROWS_MOE_LAYERS} MoE calls bit-equal to mesh=None, "
        f"{out['moe']['dropped']} of {out['moe']['routed']} pairs dropped in "
        f"both; {m_r['ms']:.1f} ms (peak {m_r['peak']} B) vs mesh=None "
        f"{m_n['ms']:.1f} ms (peak {m_n['peak']} B); row collectives called "
        f"{out['calls']['moe prefill']}")
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_shard(dev, launch_out) -> dict:
    """Slice 10's main path on the card: the launch tooling's step on a
    ('data', 'model') mesh with the sharded state (``sharding.Placement``:
    each weight stored as the rank's block and gathered on use), over a
    one-rank NCCL group (the cross-rank gathers are held on the CPU under
    gloo), bit-equal to the launch phase's mesh=None step; the same step
    with ``remat_attention``; zamba2-7b's prefill with ``skip_masked_chunks``
    off and on.  A failed gather or a refused shape raises."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import distributed, steps
    from repro_torch.launch.mesh import make_debug_mesh

    smi = _card()
    t_phase = time.perf_counter()
    sc = steps.StepConfig(get_config(LAUNCH_ARCH), InputShape(
        "smoke_train", seq_len=LAUNCH_SEQ, global_batch=LAUNCH_BATCH,
        kind="train"), n_nodes=LAUNCH_NODES, param_dtype=torch.float32)
    dev, _ = _one_rank_nccl()
    try:
        out = _shard_train(dev, sc, launch_out, smi)
        out["zamba2"] = _shard_prefill(dev, smi)
        t_split = time.perf_counter()
        mesh = make_debug_mesh((1, 1), ("data", "model"))
        out["split"] = _split_train(dev, sc, mesh, out, launch_out, smi)
        out["split"]["granite"] = _split_moe_prefill(dev, mesh, smi)
        out["split"]["seconds"] = time.perf_counter() - t_split
        out["decode"] = _pinned_decode(dev, mesh, smi)
        out["ssm_split"] = _split_ssm_cross(dev, mesh, smi)
        out["uneven"] = _split_uneven(dev, mesh, smi)
        out["rows"] = _rows_part(dev, mesh, smi)
    finally:
        distributed.shutdown()
    out["seconds"] = time.perf_counter() - t_phase
    used = {what: json.dumps({k: v for k, v in counts.items() if v})
            for what, counts in (("shard", out["launches"]),
                                 ("split", out["split"]["launches"]),
                                 ("decode", out["decode"]["launches"]),
                                 ("ssm_split",
                                  out["ssm_split"]["launches"]),
                                 ("uneven", out["uneven"]["launches"]),
                                 ("rows", out["rows"]["launches"]))}
    log(f"shard launches {used['shard']}; split launches {used['split']}; "
        f"decode launches {used['decode']}; ssm/cross split launches "
        f"{used['ssm_split']}; uneven heads split launches {used['uneven']}; "
        f"rows launches {used['rows']} "
        f"({out['seconds']:.1f} s for the phase, "
        f"{out['split']['seconds']:.1f} s of it the split's, "
        f"{out['decode']['seconds']:.1f} s the pinned decode's, "
        f"{out['ssm_split']['seconds']:.1f} s the ssm/cross split's, "
        f"{out['uneven']['seconds']:.1f} s the uneven heads split's, "
        f"{out['rows']['seconds']:.1f} s the rows')")
    return out


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


def check_on_tensor_cores(lib: str, kernels: tuple,
                          want: int | None = None) -> None:
    """Fail unless every instance in ``lib`` of the kernels named in
    ``kernels`` (``want`` of them, where given; at least one) issues
    tensor-core products, and log the count of every kernel's."""
    from repro_torch.kernels import build
    counts = sass_mma_counts(build._library_path(lib))
    ours = {k: v[0] for k, v in counts.items()
            if any(name in k for name in kernels)}
    for fn, (n, total) in sorted(counts.items()):
        log(f"build   {lib} SASS: {n:5d} HMMA of {total:6d} "
            f"instructions in {fn}")
    if not ours or (want is not None and len(ours) != want) \
            or not all(ours.values()):
        raise AssertionError(f"{lib}: want {want} instances of {kernels}, "
                             f"each with HMMA: {ours}")


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
    t_mark = [t_start]

    def mark(what: str) -> None:
        """Log the seconds since the last mark: where the run's time goes."""
        now = time.perf_counter()
        log(f"seconds {what}: {now - t_mark[0]:.1f}")
        t_mark[0] = now

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
    # the scan's chunk and output passes: fp32/bf16 x 16/32 columns a warp
    # flash: fp32/bf16 x head_dim 32/64/112/128
    check_on_tensor_cores("attention", ("flash_tc",), 8)
    check_on_tensor_cores("ssd_scan", SSD_PRODUCT_KERNELS, 8)
    mark("build")

    # 2. kernels against their plain versions, then their times
    worst = phase_kernels(dev)
    att_worst = phase_attention_kernels(dev)
    ssd_worst = phase_ssd_kernels(dev)
    mark("kernels held")
    timed = phase_timing(dev)
    att_timed = phase_attention_timing(dev)
    ssd_timed = phase_ssd_timing(dev)
    log(f"allocator after the kernel timings: {_allocator(dev)}")
    mark("kernels timed")

    # 3. the main path: the quickstart pair, then the compressed runs
    main_out = phase_main(dev)
    comp_out = phase_compressed(dev)
    mark("main, compressed")

    # 4. where the device time goes
    from repro_torch import api
    phase_profile(dev, "qg", api.presets.get("quickstart_ring16_alpha0.1_qg"))
    phase_profile(dev, "topk", api.presets.get(
        "choco_topk0.01_ring16_qg").override("comm.backend=auto"))
    mark("profile")

    # 5. slice 2: the other optimizers, the social and exponential graphs
    # and the consensus experiments
    phase_zoo(dev, main_out)
    mark("zoo")

    # 6. slices 4 and 5: the CIFAR protocol on ResNet-20, telemetry and
    # checkpoints
    cifar_out = phase_cifar(dev, main_out)
    mark("cifar")

    # 7. slice 7's main path: TinyLlama-1.1B served through the
    # paged-decode kernel, its full-width prefill through the flash kernel,
    # and the serving run under the profiler
    cfg, params, reqs = _serve_setup(dev)
    serve_out = phase_serve(dev, cfg, params, reqs)
    prefill_out = phase_prefill(dev, cfg, params)
    phase_serve_profile(dev, cfg, params, reqs)
    del params
    torch.cuda.empty_cache()
    mark("serve, prefill")

    # 8. slice 6b-i's main path: mamba2-130m prefilled through the SSD scan
    # kernel, decoded from the state it leaves, and profiled
    mamba_out = phase_mamba(dev)
    phase_mamba_profile(dev, mamba_out.pop("cfg"), mamba_out.pop("params"),
                        mamba_out.pop("tokens"))
    torch.cuda.empty_cache()
    mark("mamba")

    # 9. slice 6b-ii's main path: the LM preset trained on 8 nodes, its
    # consensus export, and the export served through the paged kernels
    lm_out = phase_lm(dev)
    torch.cuda.empty_cache()
    mark("lm")

    # 10. slice 8a's main path: the three 1024-node presets through the
    # two-kernel path, the churn scenario's masks against the JAX package's
    scen_out = phase_scenario(dev)
    torch.cuda.empty_cache()
    mark("scenario")

    # 11. slice 6b-iii's main paths: granite-moe-3b served through the
    # paged kernels, zamba2-7b prefilled through the scan and flash at
    # head_dim 112, the VLM served, each held against the JAX package
    lmstack_out = phase_lmstack(dev)
    torch.cuda.empty_cache()
    mark("lmstack")

    # 12. slice 8b's main paths: the hybrid backend over a one-rank NCCL
    # group (the n1024 presets, exp16, CHOCO top-k) and the delayed gossip
    runtimes_out = phase_runtimes(dev, scen_out)
    torch.cuda.empty_cache()
    mark("runtimes")

    # 13. slice 9's main path: the launch tooling's step builders on
    # TinyLlama-1.1B at its published size, held against the dry run
    launch_out = phase_launch(dev)
    torch.cuda.empty_cache()
    mark("launch")

    # 14. slice 10's main path: the same step with the sharded state on a
    # ('data', 'model') mesh, remat_attention, and zamba2's prefill with
    # skip_masked_chunks; slice 11's: the compute split over 'model'
    shard_out = phase_shard(dev, launch_out)
    mark("shard")

    smi = _card()
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
                           "compress.cu", "group"),
        "quantize_dequantize": ("src/repro/kernels/compress.py:101",
                                "compress.cu", "group")}
    runs = {**main_out["launches"], **comp_out["launches"]}
    main_launches = {k: sum(c[k] for c in runs.values())
                     for k in (*sources, "qg_step", "choco_exchange")}
    kernels = []
    for name, (replaces, src, size) in sources.items():
        t = timed[(name, size)]
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": worst[name]["abs"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    t = timed[("qg_step[qg]", "quickstart")]
    r = timed[("qg_step[qg]", "resnet20")]
    kernels.append({
        "name": "qg_step", "route": "cuda", "source": csrc + "qg_update.cu",
        "replaces": "src/repro/kernels/qg_update.py:116 fused_halfstep + "
                    "src/repro/kernels/qg_update.py:133 fused_qg_buffer",
        "launches": main_launches["qg_step"],
        "max_abs_err": worst["qg_step"]["abs"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "replaced_ms": t["replaced_ms"],
        "resnet20": {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "replaced_ms")},
        "lm": {k: lm_out["step_timed"]["qg"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "replaced_ms")},
        "lm_max_abs_err": lm_out["step_worst"]["abs"]})
    t = timed[("choco_exchange[choco_qg]", "quickstart")]
    kernels.append({
        "name": "choco_exchange", "route": "cuda",
        "source": csrc + "compress.cu",
        "replaces": "src/repro/kernels/compress.py:115 gamma_correct + "
                    "src/repro/kernels/qg_update.py:133 fused_qg_buffer",
        "launches": main_launches["choco_exchange"],
        "max_abs_err": worst["choco_exchange"]["abs"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "replaced_ms": t["replaced_ms"]})
    for row in kernels:  # slice 4's runs (the `cifar launches` line)
        if cifar_out["launches"].get(row["name"]):
            row["cifar_launches"] = cifar_out["launches"][row["name"]]
    for row in kernels:  # slice 8a's runs: the three n1024 presets
        if row["name"] in scen_out["timed"]:
            row["n1024_launches"] = scen_out["launches"].get(row["name"], 0)
            row["n1024"] = {k: scen_out["timed"][row["name"]][k]
                            for k in ("size", "ms", "plain_ms", "bound_ms",
                                      "bound_by")}
            row["n1024_max_abs_err"] = scen_out["worst"][row["name"]]["abs"]
    lm_launches = dict(lm_out["launches"])   # slice 6b-ii's runs
    _add_counts(lm_launches, lm_out["serve"]["launches"])
    _add_counts(lm_launches, lm_out["prefill"]["launches"])
    for row in kernels:  # one message a step: the top-k and QSGD runs
        run = {"threshold_mask": "topk", "quantize_dequantize": "qsgd"}.get(
            row["name"])
        if run:
            row["launches_per_message"] = \
                comp_out["launches"][run][row["name"]] / \
                comp_out["results"][run].steps_run
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
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "lm": {k: att_timed[(name, "lm")][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")}})
    for row in kernels:
        if lm_launches.get(row["name"]):
            row["lm_launches"] = lm_launches[row["name"]]
    for row in kernels:  # slice 8b's runs (the `runtimes launches` line)
        if runtimes_out["launches"].get(row["name"]):
            row["runtimes_launches"] = runtimes_out["launches"][row["name"]]
    for row in kernels:  # slice 6b-iii's main paths
        if lmstack_out["launches"].get(row["name"]):
            row["lmstack_launches"] = lmstack_out["launches"][row["name"]]
        for label in {"flash_attention": ("zamba2", "granite", "vlm"),
                      "paged_decode_attention": ("granite",)}.get(
                          row["name"], ()):
            row[label] = {k: att_timed[(row["name"], label)][k]
                          for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}
    for row in kernels:  # slice 9's launch phase (the fp32 train steps)
        row["launch_launches"] = launch_out["launches"].get(row["name"], 0)
    for row in kernels:  # slice 10's shard phase (the sharded train steps)
        row["shard_launches"] = shard_out["launches"].get(row["name"], 0)
    for row in kernels:  # slice 11's split train steps
        row["split_launches"] = shard_out["split"]["launches"].get(
            row["name"], 0)
    for row in kernels:  # slice 12's decode runs (the plain attention)
        row["decode_launches"] = shard_out["decode"]["launches"].get(
            row["name"], 0)
    for row in kernels:  # slice 13's mamba and cross blocks split
        row["ssm_split_launches"] = shard_out["ssm_split"]["launches"].get(
            row["name"], 0)
    for row in kernels:  # slice 15's uneven heads split (no kernel)
        row["uneven_launches"] = shard_out["uneven"]["launches"].get(
            row["name"], 0)
    for row in kernels:  # slice 16's rows (qg_step in the 2-node steps)
        row["rows_launches"] = shard_out["rows"]["launches"].get(
            row["name"], 0)
    t = ssd_timed["main"]
    kernels.append({
        "name": "ssd_scan", "route": "cuda", "source": csrc + "ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:77",
        "launches": mamba_out["launches"]["ssd_scan"],
        "pass_launches": {k: mamba_out["launches"][k] for k in SSD_KERNELS},
        "max_abs_err": ssd_worst["float32"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "launch_launches": launch_out["launches"].get("ssd_scan", 0),
        "shard_launches": shard_out["launches"].get("ssd_scan", 0),
        "split_launches": shard_out["split"]["launches"].get("ssd_scan", 0),
        "decode_launches": shard_out["decode"]["launches"].get("ssd_scan",
                                                               0),
        "ssm_split_launches": shard_out["ssm_split"]["launches"].get(
            "ssd_scan", 0),
        "uneven_launches": shard_out["uneven"]["launches"].get("ssd_scan",
                                                               0),
        "rows_launches": shard_out["rows"]["launches"].get("ssd_scan", 0),
        "split_heads": {str(h): {k: v for k, v in row.items()
                                 if k != "shape"}
                        for h, row in shard_out["ssm_split"]["scan"].items()},
        "lmstack_launches": lmstack_out["launches"]["ssd_scan"],
        "zamba2": {k: ssd_timed["zamba2"][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")}})
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
