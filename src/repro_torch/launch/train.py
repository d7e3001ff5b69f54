"""Decentralized LM training launcher -- spec-first.

Port of ``repro/launch/train.py``.  The CLI flags assemble one declarative
``ExperimentSpec`` (or start from a preset with ``--preset``), and the one
``repro_torch.api.run`` assembly path wires partition, topology, optimizer,
gossip and loop from it.  Any spec field is reachable with ``--set
section.key=value``.  It trains the reduced variant of any configured
architecture (dense, local/global, MoE, Mamba-2, the zamba2 hybrid, the
VLM with its stub image) on synthetic non-i.i.d. LM data with the full
decentralized stack.  A multi-rank run over ``torch.distributed`` goes
through ``api.run(spec, mesh=)`` (``launch/distributed.py``,
``launch/mesh.py``).  This launcher has no ``--mesh`` flag, as the
reference's has none: the full-size steps over a mesh of ranks are traced
by ``python -m repro_torch.launch.dryrun --mesh single|multi|both``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --optimizer qg_dsgdm_n --topology ring --nodes 8 --alpha 0.1 \
      --steps 200 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \
      --preset lm100m_ring8_alpha0.1_qg --set loop.steps=50
  PYTHONPATH=src python -m repro_torch.launch.train --steps 200 \
      --checkpoint run.npz --checkpoint-every 50     # periodic full state
  PYTHONPATH=src python -m repro_torch.launch.train --steps 200 \
      --checkpoint run.npz --resume run.npz          # continue after a kill
  PYTHONPATH=src python -m repro_torch.launch.train --steps 200 \
      --telemetry metrics.jsonl                      # telemetry rows

Nothing is written unless ``--checkpoint`` or ``--telemetry`` names a
path.  The run goes to the CUDA device unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import api
from repro_torch.api import presets
from repro_torch.api.models import resolve_transformer_config
from repro_torch.core import topology as topo_lib


def build_spec(args) -> api.ExperimentSpec:
    """CLI flags -> ExperimentSpec (the reference launcher's wiring)."""
    topo_n = topo_lib.get_topology(args.topology, args.nodes).n
    return api.ExperimentSpec(
        name=f"{args.arch}-{args.optimizer}-{args.topology}{topo_n}",
        seed=args.seed,
        data=api.DataSpec(dataset="lm_domains", alpha=args.alpha,
                          batch=args.batch, seq_len=args.seq_len,
                          n_domains=max(4, topo_n)),
        topology=api.TopologySpec(name=args.topology, n=args.nodes),
        optim=api.OptimSpec(name=args.optimizer, lr=args.lr,
                            weight_decay=1e-4),
        loop=api.LoopSpec(steps=args.steps, warmup=args.warmup,
                          decay_at=(0.5, 0.75), log_every=args.log_every,
                          rng_seed=args.seed + 1),
        eval=api.EvalSpec(enabled=False),
        model=api.ModelSpec(name="transformer",
                            kwargs={"arch": args.arch,
                                    "reduced": bool(args.reduced),
                                    "chunk": 256, "ssd_chunk": 64}),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--optimizer", default="qg_dsgdm_n")
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="",
                    help="save the full TrainState here every "
                         "loop.checkpoint_every steps and at the end")
    ap.add_argument("--resume", default="", metavar="PATH",
                    help="restore a --checkpoint save and continue training "
                         "to loop.steps")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="shorthand for --set loop.checkpoint_every=N")
    ap.add_argument("--telemetry", default="", metavar="PATH",
                    help="enable telemetry and write its rows to PATH "
                         "(.jsonl); shorthand for --set "
                         "telemetry.enabled=true and a sink path")
    ap.add_argument("--preset", default="",
                    help="start from a repro_torch.api preset instead of the "
                         "flags")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE", help="dotted spec override")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    spec = presets.get(args.preset) if args.preset else build_spec(args)
    if args.overrides:
        spec = spec.override(*args.overrides)
    if args.checkpoint_every:
        spec = spec.override(
            f"loop.checkpoint_every={args.checkpoint_every}")
    if args.telemetry:
        spec = spec.override("telemetry.enabled=true")
    spec.validate()

    cfg = resolve_transformer_config(spec.model)
    print(f"arch={cfg.name} params={cfg.n_params():,} "
          f"nodes={spec.topology.n} topology={spec.topology.name} "
          f"optimizer={spec.optim.name} alpha={spec.data.alpha}")
    t0 = time.time()
    result = api.run(spec, device=args.device,
                     checkpoint_path=args.checkpoint, resume=args.resume,
                     telemetry_path=args.telemetry)
    history = result.history
    print(f"done in {time.time()-t0:.1f}s on {result.device}; final loss "
          f"{history[-1]['loss']:.4f} consensus "
          f"{history[-1]['consensus']:.2e}")

    if args.checkpoint:
        print("checkpoint ->", args.checkpoint)
    if result.telemetry and result.telemetry.get("path"):
        print(f"telemetry -> {result.telemetry['path']} "
              f"({result.telemetry['rows_emitted']} rows); render with "
              f"python -m repro_torch.telemetry.report "
              f"{result.telemetry['path']}")
    return history


if __name__ == "__main__":
    main()
