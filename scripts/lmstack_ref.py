#!/usr/bin/env python3
"""The JAX package's numbers for chip_smoke's ``lmstack`` hold
(``LMSTACK_REF``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/lmstack_ref.py [arch ...]

For each arch of ``chip_smoke.LMSTACK_CUTS`` (granite-moe-3b-a800m,
zamba2-7b, llama-3.2-vision-11b; all three by default), runs the JAX
package on the CPU (``use_pallas=False``) at the published widths, cut in
depth as ``LMSTACK_CUTS`` says, from ``chip_smoke.lmstack_numpy_init`` (the
VLM's gates at ``VLM_GATE``): the prefill of ``lmstack_inputs``' prompt
(and image), then ``LMSTACK_STEPS`` decode steps, each fed the previous
step's greedy token.  Prints one JSON line an arch, ``{arch: {"steps":
[summary, ...]}}``, each summary ``chip_smoke.logit_summary`` of one
step's logits; chip_smoke pins their union as ``LMSTACK_REF`` and holds the
port's kernel path on the card to it.  One arch a process keeps the host's
peak near one model (the VLM's cut is about 2.1 B parameters, 8.6 GB).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(arch: str) -> dict:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config
    from repro.models import transformer as tf

    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config(arch), **cs.LMSTACK_CUTS[arch])
    shapes = jax.eval_shape(lambda: tf.init_lm(jax.random.PRNGKey(0), cfg))
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    paths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
             for path, _ in flat]
    arrays = []
    for a in cs.lmstack_numpy_init([(p, leaf.shape) for p, (_, leaf) in
                                    zip(paths, flat)]):
        arrays.append(jnp.asarray(a))
        del a
    params = jax.tree_util.tree_unflatten(treedef, arrays)
    del arrays
    gc.collect()
    prompt, img = cs.lmstack_inputs(cfg)
    logits, cache = tf.prefill(
        params, jnp.asarray(prompt), cfg,
        img=None if img is None else jnp.asarray(img),
        cache_len=cs.LMSTACK_PROMPT + cs.LMSTACK_STEPS)
    steps = [cs.logit_summary(np.asarray(logits[0], np.float32))]
    for i in range(cs.LMSTACK_STEPS):
        tok = jnp.full((1, 1), steps[-1]["argmax"], jnp.int32)
        logits, cache = tf.decode_step(
            params, tok, jnp.asarray(cs.LMSTACK_PROMPT + i, jnp.int32),
            cache, cfg)
        steps.append(cs.logit_summary(np.asarray(logits[0], np.float32)))
    return {"steps": steps, "n_params": cfg.n_params(),
            "jax": jax.__version__}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, str(ROOT / "src"))
    archs = argv or list(_chip_smoke().LMSTACK_CUTS)
    if len(archs) > 1:   # one process an arch
        for arch in archs:
            subprocess.run([sys.executable, __file__, arch], check=True)
        return 0
    print(json.dumps({archs[0]: run(archs[0])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
