#!/usr/bin/env python3
"""The JAX package's numbers for chip_smoke's ``scenario`` phase.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/n1024_ref.py

Runs ``repro.api.run`` (the JAX package, on the CPU, under JAX's default
``jax_threefry_partitionable``) on the presets ``n1024_ring``,
``n1024_powerlaw`` and ``n1024_churn`` at ``seed`` 0, 1 and 2 (40 steps
each, about 11 s a run), and prints one JSON object: the final test
accuracy of each run (chip_smoke's ``N1024_ACC``) and the ``alive_frac`` /
``mix_frac`` of each of ``n1024_churn``'s 40 steps (chip_smoke's
``N1024_CHURN_FRACS``; they depend on ``scenario.seed`` only, and the
script checks that the three seeds give one history).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PRESETS = ("n1024_ring", "n1024_powerlaw", "n1024_churn")
SEEDS = (0, 1, 2)


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    from repro import api

    acc, fracs = {}, []
    for preset in PRESETS:
        acc[preset] = []
        for seed in SEEDS:
            spec = api.presets.get(preset).override(f"seed={seed}",
                                                    "loop.log_every=1")
            res = api.run(spec, log_fn=lambda *_: None)
            acc[preset].append(res.final["acc"])
            if spec.scenario.enabled:
                run = [[r["alive_frac"], r["mix_frac"]] for r in res.history]
                if fracs and run != fracs:
                    raise SystemExit(f"{preset}: seed {seed} gives another "
                                     "mask history")
                fracs = run
    print(json.dumps({"acc": acc, "churn_fracs": fracs,
                      "jax": jax.__version__,
                      "threefry_partitionable":
                          bool(jax.config.jax_threefry_partitionable)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
