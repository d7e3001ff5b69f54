"""Decoding the rest of the LM stack in the port on the CPU against the
JAX package: decode steps of the reduced MoE, VLM and zamba2 models
through their dense caches, and the MoE's paged steps (its
``token_mask`` keeping a chunk's padded rows out of the capacity queues).

Tolerances are ``tests/test_torch_lm.py``'s: 1e-4 abs on logits, 2e-5 abs
on caches and page pools.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import transformer as ttf
from repro_torch.tree import tree_leaves
from test_torch_lmstack import (CACHE_TOL, LOGIT_TOL, _assert_trees_close,
                                _img, _t, _tokens, lm)  # noqa: F401


def test_decode_steps_match_reference(lm):
    """prefill + 4 greedy decode steps through the dense caches (the
    shared block's ring buffers wrap; the cross blocks attend every image
    key of their cache)."""
    name, jcfg, tcfg, jp, tp, img = lm
    s = 70 if tcfg.shared_attn_every else 20
    toks = _tokens(tcfg, 2, s, seed=1)
    cache_len = s + 4
    jl, jc = jtf.prefill(jp, jnp.asarray(toks), jcfg, img=_img(img, "jax"),
                         cache_len=cache_len, ssd_chunk=s)
    tl, tc = ttf.prefill(tp, _t(toks), tcfg, img=_img(img, "torch"),
                         cache_len=cache_len, ssd_chunk=s)
    for i in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
        assert np.array_equal(tok[:, 0], tl.argmax(-1).numpy())
        jl, jc = jtf.decode_step(jp, jnp.asarray(tok),
                                 jnp.asarray(s + i, jnp.int32), jc, jcfg)
        tl, tc2 = ttf.decode_step(tp, _t(tok), s + i, tc, tcfg)
        assert tc2 is tc                    # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_trees_close(tc, jc)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "arctic-480b"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_moe_paged_step_matches_reference(arch, use_pallas):
    """A chunked prefill of two slots with padded rows (the MoE's
    ``token_mask``: junk rows take no capacity), then three batched decode
    steps with an inactive slot: logits of the live slots and the whole
    page pools equal the reference's."""
    jcfg, tcfg = jget_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    npp = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(5), jcfg))
    jp, tp = jax.tree.map(jnp.asarray, npp), interop.params_from_numpy(
        npp, "cpu")
    ps, n_pages, p_max = 8, 12, 4
    box = [jtf.init_paged_cache(jcfg, n_pages, ps)]
    tpages = ttf.init_paged_cache(tcfg, n_pages, ps, device="cpu")
    bt = np.full((3, p_max), -1, np.int32)
    bt[0, :3] = [5, 2, 9]
    bt[1, :2] = [0, 7]
    rng = np.random.default_rng(4)

    def both(tokens, pos, nv, tables, use):
        jl, box[0] = jtf.paged_step(jp, jnp.asarray(tokens),
                                    jnp.asarray(pos), jnp.asarray(nv),
                                    jnp.asarray(tables), box[0], jcfg,
                                    page_size=ps, use_pallas=use)
        tl, tpg = ttf.paged_step(tp, _t(tokens), _t(pos), _t(nv),
                                 _t(tables), tpages, tcfg, page_size=ps,
                                 use_pallas=use)
        assert tpg is tpages
        return np.asarray(jl), tl.numpy()

    for slot, n in enumerate([13, 6]):
        chunk = rng.integers(0, tcfg.vocab_size, size=(1, 16)).astype(
            np.int32)                        # junk past n: masked
        jl, tl = both(chunk, np.array([0], np.int32),
                      np.array([n], np.int32), bt[slot:slot + 1], False)
        np.testing.assert_allclose(tl, jl, **LOGIT_TOL)
    pos = np.array([13, 6, 0], np.int32)
    for _ in range(3):
        toks = rng.integers(0, tcfg.vocab_size, size=(3, 1)).astype(np.int32)
        nv = np.array([1, 1, 0], np.int32)
        jl, tl = both(toks, pos, nv, bt, use_pallas)
        np.testing.assert_allclose(tl[:2], jl[:2], **LOGIT_TOL)
        pos = pos + nv
    for jleaf, tleaf in zip(jax.tree.leaves(box[0]), tree_leaves(tpages)):
        np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf),
                                   **CACHE_TOL)
