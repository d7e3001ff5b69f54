"""Serving launcher.

Port of ``repro/launch/serve.py``.  Routes through the continuous-batching
engine (``repro_torch.serve``) by default: requests are admitted into
in-flight decode slots over a paged KV cache.  ``--sequential`` (or a
temperature above 0) runs the one-batch dense-cache path (prefill +
decode_step), which is also the engine's parity baseline.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
      --batch 4 --prompt-len 48 --gen-len 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --checkpoint model.npz \
      --batch 8 --gen-len 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --full --use-pallas

The prompts are drawn with numpy from ``--seed`` (the reference draws them
with ``jax.random``, so the two launchers' prompts differ); the default
device is ``cuda``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import transformer as tf
from ..serve import (Request, ServeEngine, load_serving_checkpoint,
                     sequential_generate)


def generate(params, cfg, prompts, *, gen_len: int, cache_len: int,
             img=None, temperature: float = 0.0, seed: int = 0,
             chunk: int = 256):
    """prompts [B, S] -> tokens [B, S+gen_len]; the loop lives in
    ``repro_torch.serve.sequential_generate``."""
    return sequential_generate(params, cfg, prompts, gen_len=gen_len,
                               cache_len=cache_len, img=img,
                               temperature=temperature, seed=seed,
                               chunk=chunk)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced (smoke-size) config; --no-reduced or "
                         "--full for the real architecture")
    ap.add_argument("--full", action="store_true",
                    help="alias for --no-reduced")
    ap.add_argument("--checkpoint", default="",
                    help="serving checkpoint (.npz) from export_consensus; "
                         "overrides --arch/--reduced")
    ap.add_argument("--batch", type=int, default=4,
                    help="requests (engine) / prompt rows (sequential)")
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sequential path only; the engine decodes greedily")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sequential", action="store_true",
                    help="one-batch dense-cache path instead of the "
                         "continuous-batching engine")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--use-pallas", action="store_true",
                    help="the attention kernels (on CUDA tensors)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.checkpoint:
        params, cfg = load_serving_checkpoint(args.checkpoint, device=dev)
    else:
        cfg = get_config(args.arch, reduced=args.reduced and not args.full)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = tf.init_lm(gen, cfg)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len),
        dtype=np.int32)).to(dev)

    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen_len} device={dev}")
    if args.sequential or args.temperature > 0:
        # the engine is greedy; temperature rides the sequential path
        t0 = time.time()
        toks = generate(params, cfg, prompts, gen_len=args.gen_len,
                        cache_len=args.prompt_len + args.gen_len,
                        temperature=args.temperature, seed=args.seed)
        dt = time.time() - t0
        n_new = args.batch * args.gen_len
        print(f"[sequential] {n_new} tokens in {dt:.2f}s "
              f"({n_new / dt:.1f} tok/s)")
        print("sample row:", toks[0, -args.gen_len:].tolist())
        return toks

    eng = ServeEngine(params, cfg, n_slots=min(args.batch, 8),
                      page_size=args.page_size,
                      max_len=args.prompt_len + args.gen_len,
                      prefill_chunk=args.prefill_chunk,
                      use_pallas=args.use_pallas)
    reqs = [Request(id=i, prompt=tuple(int(t) for t in p.tolist()),
                    max_new=args.gen_len)
            for i, p in enumerate(prompts)]
    t0 = time.time()
    outs = eng.run(reqs)
    dt = time.time() - t0
    n_new = sum(len(o.tokens) for o in outs)
    print(f"[engine] {n_new} tokens in {dt:.2f}s ({n_new / dt:.1f} tok/s) "
          f"peak_cache_bytes={eng.stats()['peak_cache_bytes']}")
    print("sample row:", list(outs[0].tokens))
    return torch.cat([prompts, torch.tensor([o.tokens for o in outs],
                                            dtype=prompts.dtype,
                                            device=dev)], dim=1)


if __name__ == "__main__":
    main()
