"""chip_smoke's ``lmstack`` hold against the JAX package, at reduced size
on the CPU: the numpy init (``lmstack_numpy_init``) gives both packages
the same leaves, and the hold's prefill and decode steps, fed the
reference's greedy tokens and summarised by ``logit_summary``, agree
within ``LMSTACK_REF_RTOL`` (chip_smoke holds the card to
``scripts/lmstack_ref.py``'s full-width summaries the same way); and
``forward(decode_lowp=True)`` against the reference's.  Logits and caches
at ``tests/test_torch_lm.py``'s 1e-4 / 2e-5 abs.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import attention as tatt
from repro_torch.models import transformer as ttf
from repro_torch.tree import tree_leaves
from test_torch_lmstack import LOGIT_TOL, _assert_trees_close, _img, _t, \
    _tokens


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("arch,over", [
    ("zamba2-7b", {"n_layers": 3, "tail_layers": 1}),
    ("llama-3.2-vision-11b", {}),
])
def test_chip_smoke_lmstack_hold_machinery_at_reduced_size(arch, over,
                                                           monkeypatch):
    """The hold's numpy init gives both packages the same leaves (pieces
    drawn from their own streams, so the values do not depend on the
    thread count), and the hold's prefill and decode steps fed the
    reference's greedy tokens agree within LMSTACK_REF_RTOL, as chip_smoke
    holds the card to ``scripts/lmstack_ref.py`` at full width."""
    cs = _chip_smoke()
    assert set(cs.LMSTACK_REF) == set(cs.LMSTACK_CUTS)
    assert all(len(r["steps"]) == cs.LMSTACK_STEPS + 1
               for r in cs.LMSTACK_REF.values())
    monkeypatch.setattr(cs, "LMSTACK_INIT_PIECE", 1000)
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), **over)
    tcfg = dataclasses.replace(get_config(arch, reduced=True), **over)
    shapes = jax.eval_shape(lambda: jtf.init_lm(jax.random.PRNGKey(0), jcfg))
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    paths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
             for p, _ in flat]
    drawn = list(cs.lmstack_numpy_init([(p, x.shape) for p, (_, x) in
                                        zip(paths, flat)]))
    tp = cs._lmstack_params(tcfg, torch.device("cpu"))
    for a, t in zip(drawn, tree_leaves(tp), strict=True):
        assert np.array_equal(a, t.numpy())
    big = next(i for i, a in enumerate(drawn) if a.size > 1000)
    name = str(paths[big][-1])
    gen = np.random.Generator(np.random.PCG64(np.random.SeedSequence(
        cs.LMSTACK_INIT_SEED, spawn_key=(big, 1))))
    scale = {"embed": 0.02, "conv_w": 0.1}.get(
        name, 1.0 / np.sqrt(drawn[big].shape[-2]))
    np.testing.assert_array_equal(
        drawn[big].reshape(-1)[1000:2000],
        gen.standard_normal(1000, dtype=np.float32) * np.float32(scale))
    jp = jax.tree_util.tree_unflatten(treedef,
                                      [jnp.asarray(a) for a in drawn])
    prompt, img = cs.lmstack_inputs(tcfg)
    cache_len = cs.LMSTACK_PROMPT + cs.LMSTACK_STEPS
    jl, jc = jtf.prefill(jp, jnp.asarray(prompt), jcfg,
                         img=None if img is None else jnp.asarray(img),
                         cache_len=cache_len)
    tl, tc = ttf.prefill(tp, _t(prompt), tcfg, img=_img(img, "torch"),
                         cache_len=cache_len)
    for i in range(cs.LMSTACK_STEPS + 1):
        want = cs.logit_summary(np.asarray(jl[0]))
        got = cs.logit_summary(tl[0].numpy())
        scale = max(abs(want["max"]), max(abs(v) for v in want["ids"]))
        np.testing.assert_allclose(got["ids"] + [got["max"]],
                                   want["ids"] + [want["max"]], rtol=0,
                                   atol=cs.LMSTACK_REF_RTOL * scale)
        assert got["argmax"] == want["argmax"]
        if i == cs.LMSTACK_STEPS:
            break
        tok = np.full((1, 1), want["argmax"], np.int32)
        jl, jc = jtf.decode_step(jp, jnp.asarray(tok), jnp.asarray(
            cs.LMSTACK_PROMPT + i, jnp.int32), jc, jcfg)
        tl, tc = ttf.decode_step(tp, _t(tok), cs.LMSTACK_PROMPT + i, tc,
                                 tcfg)


def test_forward_passes_decode_lowp_to_the_decode_attention(monkeypatch):
    """``forward(decode_lowp=True)`` reaches every self-attention decode
    (the reference's ``RunCtx.decode_lowp``; the function's bf16 form is
    held in ``tests/test_torch_lmstack.py``): 3 greedy decode steps of
    reduced granite from ``init_cache``, logits and caches as the
    reference's with ``decode_lowp=True`` (the reference takes a bf16 cache
    only with bf16 params, so the caches here are fp32)."""
    jcfg = jget_config("granite-moe-3b-a800m", reduced=True)
    tcfg = get_config("granite-moe-3b-a800m", reduced=True)
    npp = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(2), jcfg))
    jp, tp = jax.tree.map(jnp.asarray, npp), interop.params_from_numpy(
        npp, "cpu")
    jc = jtf.init_cache(jcfg, 2, 8)
    tc = ttf.init_cache(tcfg, 2, 8, device="cpu")
    seen = []
    real = tatt.decode_attention

    def spy(*a, **kw):
        seen.append(kw.get("lowp"))
        return real(*a, **kw)

    monkeypatch.setattr(tatt, "decode_attention", spy)
    tok = _tokens(tcfg, 2, 1, seed=3)
    for i in range(3):
        jl, jc = jtf.decode_step(jp, jnp.asarray(tok), jnp.asarray(
            i, jnp.int32), jc, jcfg, decode_lowp=True)
        tl, tc = ttf.decode_step(tp, _t(tok), i, tc, tcfg, decode_lowp=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
    assert seen == [True] * (3 * tcfg.n_layers)
    _assert_trees_close(tc, jc)
