"""The rest of the LM stack in the port on the CPU against the JAX package:
the MoE block (granite-moe-3b, arctic-480b with its dense residual), the
VLM's gated cross blocks (llama-3.2-vision-11b, gates set to 0.5 so that
they do work) and zamba2-7b's shared attention block, on reduced configs,
in the four modes of ``transformer.forward``; ``cross_attention``,
``decode_attention(lowp=True)`` and flash's plain version at head_dim 112.
Both packages get the same numpy inputs and the reference's own init
(``interop.params_from_numpy``).

Tolerances are ``tests/test_torch_lm.py``'s, for its reasons: 2e-6 abs on
attention functions (bf16 caches: 1e-5, the fp32 sums of exact products in
another order), 1e-4 abs on logits, 2e-5 abs on caches and page pools.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import attention as jatt
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tatt
from repro_torch.models import transformer as ttf
from repro_torch.tree import tree_leaves

FN_TOL = dict(atol=2e-6, rtol=0)
LOGIT_TOL = dict(atol=1e-4, rtol=0)
CACHE_TOL = dict(atol=2e-5, rtol=0)
#: the cross blocks' gates in the injected params (0 at init: a fresh
#: cross block is the identity)
GATE = 0.5


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# attention functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [16, 40])
def test_cross_attention_matches_reference(t):
    """Non-causal over every image key; at T = 40 with chunk
    ``min(1024, T)`` one chunk, and through ``chunked_attention`` a
    ragged last chunk below."""
    p = {"wq": _np(0, 64, 4 * 16, scale=0.125),
         "wk": _np(1, 64, 2 * 16, scale=0.125),
         "wv": _np(2, 64, 2 * 16, scale=0.125),
         "wo": _np(3, 4 * 16, 64, scale=0.125)}
    x, img = _np(4, 2, 9, 64), _np(5, 2, t, 64)
    got = tatt.cross_attention({k: _t(v) for k, v in p.items()}, _t(x),
                               _t(img), 4, 2, 16)
    want = jatt.cross_attention({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), jnp.asarray(img), 4, 2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    q, k, v = _np(6, 2, 9, 4, 16), _np(7, 2, t, 2, 16), _np(8, 2, t, 2, 16)
    got = tatt.chunked_attention(_t(q), _t(k), _t(v), causal=False, chunk=12)
    want = jatt.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False, chunk=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


@pytest.mark.parametrize("dtype,ring,window", [
    ("bfloat16", False, 0), ("bfloat16", True, 8), ("float32", False, 0)])
def test_decode_attention_lowp_matches_reference(dtype, ring, window):
    """``lowp``: q * scale and p rounded to the cache's dtype before their
    products, which accumulate in fp32."""
    q, kc, vc = _np(0, 2, 1, 4, 16), _np(1, 2, 24, 2, 16), _np(2, 2, 24, 2,
                                                               16)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kj, vj = jnp.asarray(kc, jd), jnp.asarray(vc, jd)
    kt, vt = (_t(np.asarray(a.astype(jnp.float32))).to(td) for a in (kj, vj))
    pos = 30 if ring else 17
    k_pos = np.roll(np.arange(7, 31), 7).astype(np.int32) if ring else None
    got = tatt.decode_attention(
        _t(q), kt, vt, torch.tensor(pos, dtype=torch.int32), window=window,
        k_pos=None if k_pos is None else _t(k_pos), lowp=True)
    want = jatt.decode_attention(
        jnp.asarray(q), kj, vj, jnp.asarray(pos, jnp.int32), window=window,
        k_pos=None if k_pos is None else jnp.asarray(k_pos), lowp=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    if dtype == "bfloat16":   # lowp differs from the fp32 path there
        full = tatt.decode_attention(
            _t(q), kt, vt, torch.tensor(pos, dtype=torch.int32),
            window=window, k_pos=None if k_pos is None else _t(k_pos))
        assert not torch.equal(full, got)


@pytest.mark.parametrize("kw", [{"window": 64}, {"causal": False}])
def test_flash_plain_at_head_dim_112_matches_reference_pallas(kw):
    """zamba2's shared block has head_dim 112: the port's plain flash (the
    CPU side of ``ops.flash_attention``) against the reference's Pallas
    kernel in interpret mode at [1, 80, 2/2, 112]."""
    q, k, v = _np(0, 1, 80, 2, 112), _np(1, 1, 80, 2, 112), _np(2, 1, 80, 2,
                                                                112)
    got = tops.flash_attention(_t(q), _t(k), _t(v), **kw)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), block_q=64, block_k=128,
                                interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# the LM forward on reduced configs, from the reference's init
# ---------------------------------------------------------------------------

#: name -> (arch, overrides of the reduced config): granite (MoE), arctic
#: (MoE + dense residual), the VLM (dense + cross), zamba2 reduced (the
#: shared block after every period; reduced() drops the tail) and with one
#: tail layer, the only CPU check that the shared block skips the tail
CASES = {
    "granite": ("granite-moe-3b-a800m", {}),
    "arctic": ("arctic-480b", {}),
    "vlm": ("llama-3.2-vision-11b", {}),
    "zamba2": ("zamba2-7b", {}),
    "zamba2_tail": ("zamba2-7b", {"n_layers": 3, "tail_layers": 1}),
}


def gated(params: dict, cfg, value: float = GATE) -> dict:
    """``params`` (numpy) with every cross block's two gates at ``value``."""
    for blk, kind in zip(params["blocks"], cfg.period):
        if kind == "cross":
            blk["gate_attn"] = np.full(blk["gate_attn"].shape, value,
                                       np.float32)
            blk["gate_mlp"] = np.full(blk["gate_mlp"].shape, value,
                                      np.float32)
    return params


@pytest.fixture(scope="module", params=sorted(CASES))
def lm(request):
    """(name, cfg of both packages, reference params, port params, image
    stub or None)."""
    arch, over = CASES[request.param]
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), **over)
    tcfg = dataclasses.replace(get_config(arch, reduced=True), **over)
    npp = gated(jax.tree.map(np.asarray,
                             jtf.init_lm(jax.random.PRNGKey(3), jcfg)), jcfg)
    img = (_np(9, 2, jcfg.n_image_tokens, jcfg.d_model)
           if jcfg.n_image_tokens else None)
    return (request.param, jcfg, tcfg, jax.tree.map(jnp.asarray, npp),
            interop.params_from_numpy(npp, "cpu"), img)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _img(img, lib):
    if img is None:
        return None
    return jnp.asarray(img) if lib == "jax" else _t(img)


def _assert_trees_close(got, want):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got = tree_leaves(got)
    assert len(got) == len(flat)
    for (path, w), g in zip(flat, got):
        assert tuple(g.shape) == tuple(w.shape), path
        if w.dtype == jnp.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **CACHE_TOL,
                                       err_msg=str(path))


def test_init_lm_and_init_cache_match_reference(lm):
    """Leaf by leaf the reference's shapes and dtypes (the cross gates are
    0-d fp32, the shared block one dense-shaped set), a draw at the
    reference's scales, and ``init_cache`` equal to the reference's."""
    name, jcfg, tcfg, jp, _, _ = lm
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = ttf.init_lm(torch.Generator().manual_seed(0), tcfg)
    assert [(tuple(x.shape), str(x.dtype).split(".")[1])
            for x in tree_leaves(got)] == \
        [(tuple(x.shape), str(x.dtype)) for _, x in want]
    meta = ttf.init_lm(None, tcfg, device="meta")
    assert [x.shape for x in tree_leaves(meta)] == [x.shape for x in
                                                   tree_leaves(got)]
    assert ("shared_attn" in got) == bool(tcfg.shared_attn_every)
    assert len(got["tail"]) == tcfg.tail_layers
    if name == "vlm":
        cross = got["blocks"][tcfg.period.index("cross")]
        assert cross["gate_attn"].shape == (tcfg.n_periods,)
        assert not cross["gate_attn"].any() and not cross["gate_mlp"].any()
    jc = jtf.init_cache(jcfg, 2, 100)
    tc = ttf.init_cache(tcfg, 2, 100, device="cpu")
    _assert_trees_close(tc, jc)
    assert ttf.supports_paged(tcfg) == jtf.supports_paged(jcfg)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_train_and_prefill_match_reference(lm, use_pallas):
    """train and prefill logits, the auxiliary loss and every prefill cache
    (the shared block's caches ring buffers: S = 80 > window 64); with
    ``use_pallas`` the port's plain flash and SSD scan against the
    reference's Pallas kernels in interpret mode."""
    name, jcfg, tcfg, jp, tp, img = lm
    toks = _tokens(tcfg, 2, 80)
    for mode in ("train", "prefill"):
        jl, jaux, jc = jtf.forward(jp, jnp.asarray(toks), jcfg, mode=mode,
                                   img=_img(img, "jax"), chunk=32,
                                   ssd_chunk=16, cache_len=96,
                                   use_pallas=use_pallas)
        tl, taux, tc = ttf.forward(tp, _t(toks), tcfg, mode=mode,
                                   img=_img(img, "torch"), chunk=32,
                                   ssd_chunk=16, cache_len=96,
                                   use_pallas=use_pallas)
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        assert taux.shape == () and taux.dtype == torch.float32
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6,
                                   atol=1e-9)
        assert (float(taux) > 0) == (tcfg.moe is not None)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        if mode == "prefill":
            _assert_trees_close(tc, jc)
            if tcfg.shared_attn_every:
                assert tc["shared_attn"]["k"].shape[:3] == (
                    tcfg.n_periods, 2, tcfg.window)


def test_every_config_builds_and_runs_reduced():
    """All ten configs: the reduced ``init_lm`` has the reference's leaves,
    ``supports_paged`` agrees, and one train forward gives finite logits
    (a VLM with its image)."""
    assert len(ARCHS) == 10
    for arch in sorted(ARCHS):
        cfg, jcfg = get_config(arch, reduced=True), jget_config(
            arch, reduced=True)
        want = jax.eval_shape(lambda c=jcfg: jtf.init_lm(
            jax.random.PRNGKey(0), c))
        params = ttf.init_lm(torch.Generator().manual_seed(0), cfg)
        assert [tuple(x.shape) for x in tree_leaves(params)] == \
            [tuple(x.shape) for x in jax.tree.leaves(want)], arch
        assert ttf.supports_paged(cfg) == jtf.supports_paged(jcfg)
        img = (torch.randn(1, cfg.n_image_tokens, cfg.d_model)
               if cfg.n_image_tokens else None)
        logits, aux, _ = ttf.forward(params, torch.zeros(1, 8,
                                                         dtype=torch.long),
                                     cfg, mode="train", img=img)
        assert logits.shape == (1, 8, cfg.vocab_padded)
        assert torch.isfinite(logits).all() and torch.isfinite(aux)


def test_cross_block_without_an_image_raises():
    cfg = get_config("llama-3.2-vision-11b", reduced=True)
    params = ttf.init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="image embeddings"):
        ttf.forward(params, torch.zeros(1, 4, dtype=torch.long), cfg,
                    mode="train")
