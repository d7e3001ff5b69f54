"""The port's language-model stack on the CPU against the JAX package:
configs, ``models/layers.py``, ``models/attention.py`` and
``models/transformer.py`` (``forward`` in its four modes, ``prefill``,
``decode_step``, ``paged_step``) on reduced configs, fed the same numpy
inputs and the reference's own init (``interop.params_from_numpy``).

Tolerances, each with its reason:
* layers and attention functions: 2e-6 abs on values of order 1; the same
  fp32 operations, summed in another order by torch's and XLA's CPU
  kernels (a few ulps);
* logits of a whole forward: 1e-4 abs on logits of order 5 (the largest
  seen is about 5e-6): the matrix products of two layers of two BLAS
  libraries sum in other orders, and the difference is carried through
  the residual stream and the final norm;
* KV caches and page pools: 2e-5 abs on values of order 3 (a K/V row is
  one projection of a layer input that already differs by rounding).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.models import attention as jatt
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.tree import tree_leaves

FN_TOL = dict(atol=2e-6, rtol=0)
LOGIT_TOL = dict(atol=1e-4, rtol=0)
CACHE_TOL = dict(atol=2e-5, rtol=0)


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(JARCHS))
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_reference(arch, reduced):
    got, want = get_config(arch, reduced=reduced), jget_config(
        arch, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_params() == want.n_params()
    assert got.n_active_params() == want.n_active_params()
    assert got.pattern == want.pattern


def test_config_registry_and_tinyllama_widths():
    assert set(ARCHS) == set(JARCHS)
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("nope")
    cfg = get_config("tinyllama-1.1b")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.n_layers) == (2048, 32, 4, 64,
                                                        5632, 32000, 22)
    assert cfg.n_params() == 1_100_046_336


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_softcap_swiglu_match_reference():
    x, w = _np(0, 3, 5, 64), _np(1, 64, scale=0.1)
    np.testing.assert_allclose(
        tlayers.rms_norm(_t(x), _t(w), 1e-6).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        **FN_TOL)
    s = _np(2, 4, 33, scale=40.0)
    np.testing.assert_allclose(tlayers.softcap(_t(s), 30.0).numpy(),
                               np.asarray(jlayers.softcap(jnp.asarray(s),
                                                          30.0)), atol=1e-5)
    np.testing.assert_array_equal(tlayers.softcap(_t(s), 0.0).numpy(), s)
    wg, wu, wd = _np(3, 64, 96, scale=0.1), _np(4, 64, 96, scale=0.1), \
        _np(5, 96, 64, scale=0.1)
    np.testing.assert_allclose(
        tlayers.swiglu(_t(x), _t(wg), _t(wu), _t(wd)).numpy(),
        np.asarray(jlayers.swiglu(*(jnp.asarray(a)
                                    for a in (x, wg, wu, wd)))), **FN_TOL)


@pytest.mark.parametrize("d,theta", [(32, 10000.0), (64, 10000.0),
                                     (128, 1_000_000.0)])
def test_rope_matches_reference(d, theta):
    np.testing.assert_allclose(
        tlayers.rope_frequencies(d, theta).numpy(),
        np.asarray(jlayers.rope_frequencies(d, theta)), rtol=1e-6)
    x = _np(6, 2, 40, 4, d)
    pos = np.random.default_rng(7).integers(0, 300, size=(2, 40)).astype(
        np.int32)
    np.testing.assert_allclose(
        tlayers.apply_rope(_t(x), _t(pos), theta).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      theta)), atol=2e-5)


def test_init_helpers_draw_at_the_reference_scales():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(gen, 256, 512, device="cpu")
    e = tlayers.embed_init(gen, 512, 128, device="cpu")
    assert abs(float(w.std()) - 1 / 16) < 2e-3 and abs(float(e.std()) -
                                                      0.02) < 1e-3
    stacked = tlayers.stack_layers(3, lambda: tlayers.init_mlp(
        gen, 8, 16, device="cpu"))
    assert stacked["gate"].shape == (3, 8, 16)
    assert not torch.equal(stacked["gate"][0], stacked["gate"][1])


# ---------------------------------------------------------------------------
# attention functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True])
def test_qkv_matches_reference(bias):
    p = {"wq": _np(0, 32, 4 * 8), "wk": _np(1, 32, 2 * 8),
         "wv": _np(2, 32, 2 * 8)}
    if bias:
        p.update(bq=_np(3, 32), bk=_np(4, 16), bv=_np(5, 16))
    x = _np(6, 2, 5, 32)
    got = tatt.qkv({k: _t(v) for k, v in p.items()}, _t(x), 4, 2, 8)
    want = jatt.qkv({k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x), 4, 2, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("s,t,kw,chunk", [
    (64, 64, {}, 16),
    (50, 50, {}, 16),                                # ragged last chunk
    (64, 64, {"window": 20}, 32),
    (64, 64, {"softcap": 30.0}, 64),
    (40, 72, {"causal": False}, 32),
])
def test_chunked_attention_matches_reference(s, t, kw, chunk):
    q, k, v = _np(0, 2, s, 4, 16), _np(1, 2, t, 2, 16), _np(2, 2, t, 2, 16)
    got = tatt.chunked_attention(_t(q), _t(k), _t(v), chunk=chunk, **kw)
    want = jatt.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), chunk=chunk, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


@pytest.mark.parametrize("window,softcap,ring", [(0, 0.0, False),
                                                 (8, 50.0, False),
                                                 (0, 0.0, True)])
def test_decode_attention_matches_reference(window, softcap, ring):
    q, kc, vc = _np(0, 2, 1, 4, 16), _np(1, 2, 24, 2, 16), _np(2, 2, 24, 2,
                                                               16)
    pos = 30 if ring else 17
    k_pos = (np.roll(np.arange(7, 31), 7).astype(np.int32) if ring
             else None)
    got = tatt.decode_attention(
        _t(q), _t(kc), _t(vc), torch.tensor(pos, dtype=torch.int32),
        window=window, softcap=softcap,
        k_pos=None if k_pos is None else _t(k_pos))
    want = jatt.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(pos, jnp.int32), window=window, softcap=softcap,
        k_pos=None if k_pos is None else jnp.asarray(k_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (10, 30.0)])
def test_paged_attention_matches_reference(window, softcap):
    q, k, v = _np(0, 3, 4, 4, 16), _np(1, 3, 32, 2, 16), _np(2, 3, 32, 2, 16)
    q_pos = (np.array([0, 9, 25])[:, None] + np.arange(4)).astype(np.int32)
    got = tatt.paged_attention(_t(q), _t(k), _t(v), _t(q_pos),
                               window=window, softcap=softcap)
    want = jatt.paged_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(q_pos),
                                window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


# ---------------------------------------------------------------------------
# the LM forward on reduced configs, from the reference's init
# ---------------------------------------------------------------------------

def _mha(cfg):
    """musicgen-medium is MHA (kv == heads); its reduced form is not, so
    the reduced widths get kv == heads back."""
    return dataclasses.replace(cfg, n_kv_heads=cfg.n_heads)


#: name -> (arch, transform of the reduced config): TinyLlama (GQA),
#: Gemma-2 (local/global, window 64, both softcaps), Qwen2 (qkv bias),
#: MusicGen (MHA)
ARCH_CASES = {
    "tinyllama": ("tinyllama-1.1b", None),
    "gemma2": ("gemma2-27b", None),
    "qwen2": ("qwen2-72b", None),
    "musicgen_mha": ("musicgen-medium", _mha),
}


@pytest.fixture(scope="module", params=sorted(ARCH_CASES))
def lm(request):
    """(cfg of both packages, reference params, port params).  Qwen2's qkv
    biases are drawn nonzero in both (the reference inits them to 0)."""
    arch, fix = ARCH_CASES[request.param]
    jcfg, tcfg = jget_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    if fix is not None:
        jcfg, tcfg = fix(jcfg), fix(tcfg)
    jp = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(3), jcfg))
    if jcfg.qkv_bias:
        for blk in jp["blocks"]:
            for i, name in enumerate(("bq", "bk", "bv")):
                blk["attn"][name] = _np(10 + i, *blk["attn"][name].shape,
                                        scale=0.5)
    jp = jax.tree.map(jnp.asarray, jp)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return request.param, jcfg, tcfg, jp, tp


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_init_lm_structure_matches_reference(lm):
    _, jcfg, tcfg, jp, _ = lm
    gen = torch.Generator().manual_seed(0)
    mine = ttf.init_lm(gen, tcfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [tuple(x.shape) for _, x in flat_j]
    meta = ttf.init_lm(None, tcfg, device="meta")
    assert [x.shape for x in tree_leaves(meta)] == [x.shape for x in
                                                tree_leaves(mine)]
    assert isinstance(mine["blocks"], tuple) and mine["tail"] == ()
    n = sum(x.numel() for x in tree_leaves(mine))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_train_and_prefill_match_reference(lm, use_pallas):
    """train and prefill logits and every prefill cache (padded, and for
    Gemma-2's local layers a ring buffer: S = 80 > window 64); with
    ``use_pallas`` the port's flash plain version against the reference's
    Pallas flash kernel in interpret mode."""
    name, jcfg, tcfg, jp, tp = lm
    toks = _tokens(tcfg, 2, 80)
    for mode in ("train", "prefill"):
        jl, _, jc = jtf.forward(jp, jnp.asarray(toks), jcfg, mode=mode,
                                chunk=32, cache_len=96,
                                use_pallas=use_pallas)
        tl, aux, tc = ttf.forward(tp, _t(toks), tcfg, mode=mode, chunk=32,
                                  cache_len=96, use_pallas=use_pallas)
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        assert float(aux) == 0.0
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        if mode == "prefill":
            for (path, jleaf), tleaf in zip(
                    jax.tree_util.tree_flatten_with_path(jc)[0],
                    tree_leaves(tc)):
                assert tuple(tleaf.shape) == tuple(jleaf.shape), path
                if jleaf.dtype == jnp.int32:
                    np.testing.assert_array_equal(tleaf.numpy(),
                                                  np.asarray(jleaf))
                else:
                    np.testing.assert_allclose(tleaf.numpy(),
                                               np.asarray(jleaf), **CACHE_TOL)


def test_decode_steps_match_reference(lm):
    """prefill + 6 greedy decode steps through the dense cache (Gemma-2's
    local ring buffer wraps past its window)."""
    name, jcfg, tcfg, jp, tp = lm
    s = 70 if name == "gemma2" else 20
    toks = _tokens(tcfg, 2, s, seed=1)
    cache_len = s + 6
    jl, jc = jtf.prefill(jp, jnp.asarray(toks), jcfg, cache_len=cache_len)
    tl, tc = ttf.prefill(tp, _t(toks), tcfg, cache_len=cache_len)
    for i in range(6):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
        assert np.array_equal(tok[:, 0], tl.argmax(-1).numpy())
        jl, jc = jtf.decode_step(jp, jnp.asarray(tok),
                                 jnp.asarray(s + i, jnp.int32), jc, jcfg)
        tl, tc2 = ttf.decode_step(tp, _t(tok), s + i, tc, tcfg)
        assert tc2 is tc                    # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for jleaf, tleaf in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        if jleaf.dtype == jnp.int32:
            np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
        else:
            np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf),
                                       **CACHE_TOL)


def test_init_cache_matches_reference(lm):
    _, jcfg, tcfg, _, _ = lm
    jc = jtf.init_cache(jcfg, 2, 100)
    tc = ttf.init_cache(tcfg, 2, 100, device="cpu")
    for jleaf, tleaf in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        assert tuple(tleaf.shape) == tuple(jleaf.shape)
        np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_paged_step_matches_reference(lm, use_pallas):
    """A chunked prefill of two slots (one chunk each, one slot with
    overhang past its prompt), then three batched decode steps with an
    inactive slot and a -1 block-table row: logits of the live slots and
    the whole page pools equal the reference's (dropped rows included: the
    port's dump-row scatter leaves the pool as ``mode="drop"`` does)."""
    name, jcfg, tcfg, jp, tp = lm
    ps, n_pages, p_max = 8, 12, 4
    jpages = jtf.init_paged_cache(jcfg, n_pages, ps)
    tpages = ttf.init_paged_cache(tcfg, n_pages, ps, device="cpu")
    bt = np.full((3, p_max), -1, np.int32)
    bt[0, :3] = [5, 2, 9]
    bt[1, :2] = [0, 7]
    lens = [13, 6]
    rng = np.random.default_rng(4)

    def both(tokens, pos, nv, tables, use):
        jl, jpg = jtf.paged_step(jp, jnp.asarray(tokens), jnp.asarray(pos),
                                 jnp.asarray(nv), jnp.asarray(tables),
                                 jpages_box[0], jcfg, page_size=ps,
                                 use_pallas=use)
        jpages_box[0] = jpg
        tl, tpg = ttf.paged_step(tp, _t(tokens), _t(pos), _t(nv),
                                 _t(tables), tpages, tcfg, page_size=ps,
                                 use_pallas=use)
        assert tpg is tpages                 # written in place
        return np.asarray(jl), tl.numpy()

    jpages_box = [jpages]
    for slot, n in enumerate(lens):
        chunk = np.zeros((1, 16), np.int32)
        chunk[0, :n] = rng.integers(0, tcfg.vocab_size, size=n)
        jl, tl = both(chunk, np.array([0], np.int32),
                      np.array([n], np.int32), bt[slot:slot + 1], False)
        np.testing.assert_allclose(tl, jl, **LOGIT_TOL)
    pos = np.array([13, 6, 0], np.int32)
    for step in range(3):
        toks = rng.integers(0, tcfg.vocab_size, size=(3, 1)).astype(np.int32)
        nv = np.array([1, 1, 0], np.int32)
        jl, tl = both(toks, pos, nv, bt, use_pallas)
        np.testing.assert_allclose(tl[:2], jl[:2], **LOGIT_TOL)
        pos = pos + nv
    for jleaf, tleaf in zip(jax.tree.leaves(jpages_box[0]),
                            tree_leaves(tpages)):
        np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf),
                                   **CACHE_TOL)


def test_paged_step_with_no_kept_row_leaves_the_pool_unchanged():
    cfg = get_config("tinyllama-1.1b", reduced=True)
    params = ttf.init_lm(torch.Generator().manual_seed(0), cfg)
    pages = ttf.init_paged_cache(cfg, 4, 8, device="cpu")
    for leaf in tree_leaves(pages):
        leaf.normal_(generator=torch.Generator().manual_seed(1))
    before = [x.clone() for x in tree_leaves(pages)]
    logits, _ = ttf.paged_step(
        params, torch.zeros(2, 1, dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
        torch.full((2, 2), -1, dtype=torch.int32), pages, cfg, page_size=8,
        use_pallas=True)
    assert torch.isfinite(logits).all()
    for a, b in zip(before, tree_leaves(pages)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,what", [
    ("granite-moe-3b-a800m", "moe"), ("llama-3.2-vision-11b", "cross"),
    ("zamba2-7b", "shared_attn"),
])
def test_unported_kinds_raise_naming_their_slice(arch, what):
    """The kinds the port once refused (the MoE layer, the VLM's cross
    blocks, zamba2's shared block) now build and run: the reduced
    ``init_lm`` holds the part, ``supports_paged`` agrees with the
    reference, and a train forward gives finite logits."""
    cfg = get_config(arch, reduced=True)
    params = ttf.init_lm(torch.Generator().manual_seed(0), cfg)
    if what == "shared_attn":
        assert set(params["shared_attn"]) == {"ln1", "attn", "ln2", "mlp"}
    else:
        assert what in cfg.period
        blk = params["blocks"][cfg.period.index(what)]
        assert ("moe" in blk) if what == "moe" else ("xattn" in blk)
    assert ttf.supports_paged(cfg) == jtf.supports_paged(
        jget_config(arch, reduced=True))
    img = (torch.randn(1, cfg.n_image_tokens, cfg.d_model)
           if cfg.n_image_tokens else None)
    logits, aux, _ = ttf.forward(params, torch.zeros(1, 4, dtype=torch.long),
                                 cfg, mode="train", img=img)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_supports_paged_and_init_lm_match_reference(arch):
    """Every config: ``supports_paged`` as the reference's, and the reduced
    ``init_lm`` the reference's shapes and dtypes (the MoE, cross and
    shared-block configs included)."""
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch,
                                                            reduced=True)
    assert ttf.supports_paged(cfg) == jtf.supports_paged(jcfg)
    want = jax.eval_shape(lambda: jtf.init_lm(jax.random.PRNGKey(0), jcfg))
    got = ttf.init_lm(None, cfg, device="meta")
    assert [(tuple(x.shape), str(x.dtype).split(".")[1])
            for x in tree_leaves(got)] == \
        [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(want)]
