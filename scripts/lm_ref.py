#!/usr/bin/env python3
"""The JAX package's numbers for chip_smoke's ``lm`` hold (``LM_REF``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/lm_ref.py

Runs ``repro.api.run`` (the JAX package, on the CPU) on the preset
``lm100m_ring8_alpha0.1_qg`` cut in depth only to ``chip_smoke.LM_REF_LAYERS``
layers and ``chip_smoke.LM_REF_STEPS`` steps, every node starting from
``chip_smoke.lm_numpy_init`` (one node's init drawn with numpy at the
scales of ``init_lm``), and prints one JSON object: the loss of every step
and the L2 norm of each node-stacked param leaf after the last step, keyed
as chip_smoke keys them.  chip_smoke pins it as ``LM_REF`` and holds the
port's run on the card to it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro import api
    from repro.api import models

    cs = _chip_smoke()
    spec = cs.lm_ref_spec(api.presets.get(cs.LM_PRESET))
    real = models.MODELS["transformer"]

    def numpy_init(spec_, task):
        bundle = real(spec_, task)
        shapes = jax.eval_shape(bundle.init_fn, jax.random.PRNGKey(0))[0]
        flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
        paths = [tuple(getattr(k, "key", getattr(k, "idx", None))
                       for k in path) for path, _ in flat]
        arrays = cs.lm_numpy_init([(p, leaf.shape) for p, (_, leaf) in
                                   zip(paths, flat)])
        params = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(a) for a in arrays])
        return dataclasses.replace(bundle,
                                   init_fn=lambda _key: (params, {}))

    models.MODELS["transformer"] = numpy_init
    try:
        result, state = api.run(spec, with_state=True,
                                log_fn=lambda *_: None)
    finally:
        models.MODELS["transformer"] = real
    flat, _ = jax.tree_util.tree_flatten_with_path(state.params)
    norms = {"/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                      for k in path): float(np.linalg.norm(
                          np.asarray(leaf, np.float64)))
             for path, leaf in flat}
    print(json.dumps({"loss": [r["loss"] for r in result.history],
                      "norms": norms, "jax": jax.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
