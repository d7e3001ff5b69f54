"""Serve a consensus model from the command line.

    # serve an exported consensus checkpoint on the GPU, through the
    # paged-decode kernel
    PYTHONPATH=src python -m repro_torch.serve --checkpoint model.npz \
        --requests 30 --n-slots 8 --max-new 16 --use-pallas

    # or a freshly initialized arch (reduced by default; --full for the
    # published widths), on the CPU
    PYTHONPATH=src python -m repro_torch.serve --arch tinyllama-1.1b \
        --requests 8 --device cpu

    # sequential dense-cache baseline for the same request set
    PYTHONPATH=src python -m repro_torch.serve --baseline

    # Mamba-2 (no paged engine: O(1)-state decode through the baseline),
    # its prefill through the SSD scan kernel
    PYTHONPATH=src python -m repro_torch.serve --arch mamba2-130m --full \
        --baseline --use-pallas

Port of ``python -m repro.serve``, with the same flags plus ``--device``
(default ``cuda``).  Requests are synthetic mixed-length prompts drawn with
numpy from ``--seed``, the reference's own; a fresh init draws from a
``torch.Generator`` seeded with ``--seed`` on the device, so its weights
are not the reference's.  Output is one JSON line with tokens/s, per-phase
latency percentiles and peak cache bytes.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import describe_device, resolve_device
from ..models import transformer as tf
from .engine import Request, ServeEngine, sequential_generate
from .export import load_serving_checkpoint


def make_requests(n: int, vocab: int, *, seed: int = 0,
                  lens=(8, 17, 32), max_new: int = 16) -> list[Request]:
    """Seeded mixed-length synthetic request set (the reference's draws)."""
    rng = np.random.default_rng(seed)
    return [Request(id=i,
                    prompt=tuple(int(t) for t in
                                 rng.integers(0, vocab,
                                              size=lens[i % len(lens)])),
                    max_new=max_new)
            for i in range(n)]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Continuous-batching inference over a paged KV cache")
    ap.add_argument("--checkpoint", default="",
                    help="serving checkpoint (.npz) from export_consensus; "
                         "omit to init a fresh --arch")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full", action="store_true",
                    help="full-size arch (default: reduced) when no "
                         "checkpoint is given")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--n-slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--use-pallas", action="store_true",
                    help="the attention kernels, and with --baseline the "
                         "prefill kernels (flash attention, the SSD scan); "
                         "on CUDA tensors (CPU tensors take their plain "
                         "versions)")
    ap.add_argument("--baseline", action="store_true",
                    help="sequential dense-cache generate instead of the "
                         "engine")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.checkpoint:
        params, cfg = load_serving_checkpoint(args.checkpoint, device=dev)
    else:
        cfg = get_config(args.arch, reduced=not args.full)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = tf.init_lm(gen, cfg)

    reqs = make_requests(args.requests, cfg.vocab_size, seed=args.seed,
                         max_new=args.max_new)
    row = {"arch": cfg.name, "requests": len(reqs),
           "max_new": args.max_new, "device": describe_device(dev)}
    if args.baseline:
        t0 = time.time()
        for r in reqs:
            prompt = torch.tensor([r.prompt], dtype=torch.int32, device=dev)
            sequential_generate(params, cfg, prompt, gen_len=r.max_new,
                                cache_len=len(r.prompt) + r.max_new,
                                use_pallas=args.use_pallas)
        _sync(dev)
        wall = time.time() - t0
        row.update(mode="sequential", wall_s=wall,
                   tokens_per_s=len(reqs) * args.max_new / wall)
    else:
        eng = ServeEngine(params, cfg, n_slots=args.n_slots,
                          page_size=args.page_size, max_len=args.max_len,
                          prefill_chunk=args.prefill_chunk,
                          use_pallas=args.use_pallas)
        t0 = time.time()
        outs = eng.run(reqs)
        _sync(dev)
        wall = time.time() - t0
        n_tok = sum(len(o.tokens) for o in outs)
        row.update(mode="engine", wall_s=wall, tokens_per_s=n_tok / wall,
                   **eng.stats())
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
