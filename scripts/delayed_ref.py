#!/usr/bin/env python3
"""The JAX package's numbers for chip_smoke's ``runtimes`` phase.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/delayed_ref.py

Runs ``repro.api.run`` (the JAX package, on the CPU) on the quickstart
pair, ``quickstart_ring16_alpha0.1_qg`` and ``..._dsgdm``, with
``overlap=delayed_1`` (the one-step-stale gossip) at ``seed`` 0, 1 and 2
(150 steps each), and prints one JSON object: the final test accuracy of
each run (chip_smoke's ``DELAYED_ACC``).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PRESETS = ("quickstart_ring16_alpha0.1_qg",
           "quickstart_ring16_alpha0.1_dsgdm")
SEEDS = (0, 1, 2)


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    from repro import api

    acc = {}
    for preset in PRESETS:
        acc[preset] = []
        for seed in SEEDS:
            spec = api.presets.get(preset).override(f"seed={seed}",
                                                    "overlap=delayed_1")
            res = api.run(spec, log_fn=lambda *_: None)
            acc[preset].append(res.final["acc"])
    print(json.dumps({"acc": acc, "jax": jax.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
