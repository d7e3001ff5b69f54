"""The port's Mamba-2 path on the CPU against the JAX package: the SSD scan
(``kernels/ref.py``, ``kernels/ops.py``; the reference's Pallas kernel in
interpret mode), ``models/ssm.py``, the mamba kind of
``models/transformer.py`` in train, prefill and decode modes,
``sequential_generate``, the serving CLI, the engine's refusal, serving
checkpoints and the full-size shapes of mamba2-130m.  Inputs are numpy
draws from a seed; the reference's params are carried across with
``interop.params_from_numpy``.

Tolerances, each with its reason:
* the sequential oracle against the reference's: 1e-5 abs on values of
  order 1 (the same fp32 recurrence, per-step products rounded by two
  libraries);
* the port's SSD scan, and the composition of the scan kernels' plain
  passes, against the reference's kernel: atol 5e-4, rtol 1e-3, the
  reference's own bound between its kernel and its oracle
  (tests/test_kernels.py:221); the chunked path at two chunk sizes: 1e-4,
  the reference's chunk-invariance bound (tests/test_kernels.py:240);
* mixer functions: 1e-5 abs (a few fp32 ulps through two BLAS libraries);
* logits and Mamba states of a whole forward: 1e-4 abs (tests/test_torch_
  lm.py's bound for a forward; the largest seen here is about 2e-6).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import interop, serve
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
ORACLE_TOL = dict(atol=1e-5, rtol=0)
SCAN_TOL = dict(atol=5e-4, rtol=1e-3)
FN_TOL = dict(atol=1e-5, rtol=0)
LOGIT_TOL = dict(atol=1e-4, rtol=0)

#: (B, S, H, P, N, chunk): the reference's SSD_CASES
#: (tests/test_kernels.py:199), one token, 17 tokens (chunk = S)
SSD_CASES = [(1, 128, 2, 32, 16, 64), (2, 256, 3, 64, 32, 64),
             (1, 256, 1, 16, 128, 128), (2, 512, 4, 32, 64, 256),
             (1, 1, 2, 32, 16, 128), (1, 17, 2, 32, 16, 128)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssd_inputs(b, s, h, p, n, seed, dt_scale=1.0, d_skip=None):
    """x, dt, a, b, c, d_skip as numpy fp32, the reference test's scales;
    ``dt_scale`` 1e-2 keeps exp(a dt) near 1, so the state carries across
    every chunk."""
    rng = np.random.default_rng(seed)
    f32 = lambda v: np.asarray(v, np.float32)
    x = f32(rng.normal(size=(b, s, h, p)) * 0.5)
    dt = f32(np.logaddexp(rng.normal(size=(b, s, h)), 0.0) * dt_scale)
    a = f32(-np.exp(rng.normal(size=h) * 0.3))
    bb = f32(rng.normal(size=(b, s, n)) * 0.3)
    cc = f32(rng.normal(size=(b, s, n)) * 0.3)
    d = f32(np.ones(h) if d_skip is None else d_skip)
    return x, dt, a, bb, cc, d


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_plain_ssd_scan_matches_reference_oracle(with_state):
    x, dt, a, bb, cc, d = _ssd_inputs(2, 40, 3, 16, 8, 1,
                                      d_skip=[0.5, 1.0, -1.5])
    h0 = (np.random.default_rng(2).normal(size=(2, 3, 8, 16)).astype(
        np.float32) if with_state else None)
    y, fin = ref.ssd_scan(*map(_t, (x, dt, a, bb, cc, d)),
                          initial_state=None if h0 is None else _t(h0))
    jy, jfin = jref.ssd_scan_ref(*map(jnp.asarray, (x, dt, a, bb, cc)),
                                 initial_state=None if h0 is None
                                 else jnp.asarray(h0))
    jy = np.asarray(jy) + x * d[None, None, :, None]
    assert y.dtype == torch.float32 and fin.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), jy, **ORACLE_TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), **ORACLE_TOL)


@pytest.mark.parametrize("case,dt_scale", [(c, 1.0) for c in SSD_CASES]
                         + [(SSD_CASES[3], 1e-2)])
def test_ops_ssd_scan_matches_reference_kernel(case, dt_scale):
    """The port's ``ops.ssd_scan`` on CPU tensors (the plain version)
    against the reference's ``ops.ssd_scan`` (its Pallas kernel in
    interpret mode), y and the final state."""
    b, s, h, p, n, chunk = case
    args = _ssd_inputs(b, s, h, p, n, 3, dt_scale)
    y, fin = ops.ssd_scan(*map(_t, args), chunk=chunk)
    jy, jfin = jops.ssd_scan(*map(jnp.asarray, args), chunk=chunk)
    assert tuple(y.shape) == (b, s, h, p) and tuple(fin.shape) == (b, h, n, p)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), **SCAN_TOL)
    if dt_scale < 1:   # the state reaches the last chunk
        assert float(np.abs(np.asarray(jfin)).max()) > 1e-2


def test_ssd_chunk_invariance_against_reference():
    """Chunk 64 against chunk 256 across the packages, and the port's
    chunked path at the two chunk sizes (the reference's own check,
    tests/test_kernels.py:226, with the state carried in)."""
    args = _ssd_inputs(1, 256, 2, 32, 16, 4, 1e-2)
    y64, f64 = ops.ssd_scan(*map(_t, args), chunk=64)
    jy256, jf256 = jops.ssd_scan(*map(jnp.asarray, args), chunk=256)
    np.testing.assert_allclose(y64.numpy(), np.asarray(jy256), **SCAN_TOL)
    np.testing.assert_allclose(f64.numpy(), np.asarray(jf256), **SCAN_TOL)
    jy64, _ = jops.ssd_scan(*map(jnp.asarray, args), chunk=64)
    y256, _ = ops.ssd_scan(*map(_t, args), chunk=256)
    np.testing.assert_allclose(y256.numpy(), np.asarray(jy64), **SCAN_TOL)
    c64, s64 = tssm.ssd_chunked(*map(_t, args), chunk=64)
    c256, s256 = tssm.ssd_chunked(*map(_t, args), chunk=256)
    np.testing.assert_allclose(c64.numpy(), c256.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(s64.numpy(), s256.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_s_not_a_multiple_of_the_chunk_raises_in_both_packages():
    args = _ssd_inputs(1, 150, 2, 16, 8, 5)
    with pytest.raises(AssertionError):
        jops.ssd_scan(*map(jnp.asarray, args), chunk=128)
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*map(jnp.asarray, args), chunk=128)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ops.ssd_scan(*map(_t, args), chunk=128)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        tssm.ssd_chunked(*map(_t, args), chunk=128)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        kssd.ssd_scan(*map(_t, args), chunk=128)


def test_kernel_wrapper_checks_before_launching():
    """What the CUDA wrappers refuse, checked on CPU tensors before any
    device is touched: dtypes, shapes, P and N, the shared memory a block
    needs, the alignment of the scratch states, then the device itself --
    for the whole scan and for each of its passes."""
    x, dt, a, bb, cc, d = map(_t, _ssd_inputs(1, 32, 2, 16, 8, 6))
    with pytest.raises(TypeError, match="one dtype"):
        kssd.ssd_scan(x.double(), dt, a, bb, cc, d)
    with pytest.raises(TypeError, match="dt must be float32"):
        kssd.ssd_scan(x, dt.bfloat16(), a, bb, cc, d)
    with pytest.raises(ValueError, match="expected"):
        kssd.ssd_scan(x, dt[:, :, :1], a, bb, cc, d)
    with pytest.raises(ValueError, match="P % 16"):
        kssd.ssd_scan(x[..., :8], dt, a, bb, cc, d)
    with pytest.raises(ValueError, match="N % 4"):
        kssd.ssd_scan(x, dt, a, bb[..., :6], cc[..., :6], d)
    wide = torch.zeros(1, 32, 400)
    with pytest.raises(ValueError, match="shared memory"):
        kssd.ssd_scan(x, dt, a, wide, wide, d)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kssd.ssd_scan(x, dt, a, bb, cc, d)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kssd.chunk_states(x, dt, a, bb)
    with pytest.raises(ValueError, match="shared memory"):
        kssd.chunk_states(x, dt, a, wide)
    states = torch.zeros(1, 1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kssd.state_passing(states, torch.zeros(1, 1, 2))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kssd.chunk_outputs(x, dt, a, bb, cc, d, states)
    with pytest.raises(TypeError, match="d_skip must be float32"):
        kssd.chunk_outputs(x, dt, a, bb, cc, d.double(), states)
    # a contiguous view 4 bytes into its storage: the kernels read the
    # states by float4 and 16-byte cp.async
    shifted = torch.zeros(1 + states.numel())[1:].view(states.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kssd.state_passing(shifted, torch.zeros(1, 1, 2))


@pytest.mark.parametrize("n,p,ok", [(128, 64, True), (306, 64, True),
                                    (336, 64, True), (340, 64, False),
                                    (344, 48, True), (344, 80, True),
                                    (16, 16, True), (400, 16, False)])
def test_kernel_shared_memory_covers_the_shapes_it_took(n, p, ok):
    """The passes hold a block's tiles in shared memory (at most 232,448
    bytes on the H100): every (N, P) that the sequential kernel took before
    the chunk-parallel one (N up to 306 where 32 divides P, else 344) still
    fits; mamba2-130m's N 128, P 64 takes 72 KB and 110 KB."""
    assert (max(kssd.smem_bytes(n, p)) <= 232448) == ok
    if (n, p) == (128, 64):
        assert kssd.smem_bytes(n, p) == (73728, 112640)


@pytest.mark.parametrize("shape,want", [((2, 32, 24), 6), ((8, 64, 24), 8),
                                        ((1, 1, 2), 1), ((1, 4, 1), 1),
                                        ((2, 1, 3), 1)])
def test_kernel_head_group_rule(shape, want):
    """Heads a block of the chunk and output passes: at mamba2-130m's
    prefill [2, 2048] (32 chunks, 24 heads) six, one wave of 256 blocks on
    132 SMs at two an SM; small shapes take one head a block."""
    bsz, nc, h = shape
    hg = kssd.head_group(bsz, nc, h, 132)
    assert hg == want and 1 <= hg <= min(8, h)


@pytest.mark.parametrize("oracle", ["reference_kernel", "sequential"])
@pytest.mark.parametrize("case,dt_scale", [(c, 1.0) for c in SSD_CASES]
                         + [(SSD_CASES[3], 1e-2)])
def test_ssd_passes_compose_to_the_scan(case, dt_scale, oracle):
    """The plain versions of the scan kernel's three passes
    (``ref.ssd_chunk_states``, ``ssd_state_passing``, ``ssd_chunk_outputs``
    over 64-token chunks, composed by ``ref.ssd_scan_passes``) against the
    reference's ``ops.ssd_scan`` (its Pallas kernel in interpret mode) and
    against the port's sequential oracle, y and the final state; S = 1 and
    17 pad one short chunk."""
    b, s, h, p, n, chunk = case
    args = _ssd_inputs(b, s, h, p, n, 3, dt_scale,
                       d_skip=np.linspace(0.5, 1.5, h))
    y, fin = ref.ssd_scan_passes(*map(_t, args))
    if oracle == "sequential":
        wy, wfin = ref.ssd_scan(*map(_t, args))
    else:
        wy, wfin = jops.ssd_scan(*map(jnp.asarray, args), chunk=chunk)
    assert tuple(y.shape) == (b, s, h, p) and tuple(fin.shape) == (b, h, n, p)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **SCAN_TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(wfin), **SCAN_TOL)
    # each pass's shapes, and the state pass's recurrence over the chunks
    ds, decay = ref.ssd_chunk_states(*map(_t, args[:4]))
    nc = -(-s // ref.SSD_BLOCK)
    assert tuple(ds.shape) == (b, nc, h, n, p)
    assert tuple(decay.shape) == (b, nc, h)
    s_in, fin2 = ref.ssd_state_passing(ds, decay)
    assert not s_in[:, 0].any()
    torch.testing.assert_close(fin2, fin, rtol=0, atol=0)
    if nc > 1:
        torch.testing.assert_close(
            s_in[:, 1], decay[:, 0, :, None, None] * s_in[:, 0] + ds[:, 0],
            rtol=0, atol=0)


def test_kernel_reads_rows_of_the_conv_output_in_place():
    """The layouts the mixer hands the kernel: slices of the last axis of
    one [B,S,C] tensor are taken with their token stride; anything else
    is refused."""
    xbc = torch.zeros(2, 5, 3 * 16 + 2 * 8)
    xi = xbc[..., :48].reshape(2, 5, 3, 16)
    assert kssd._token_stride("x", xi, (3, 16)) == 64
    assert kssd._token_stride("b", xbc[..., 48:56], (8,)) == 64
    assert kssd._token_stride("x", torch.zeros(2, 5, 3, 16), (3, 16)) == 48
    # one token per sequence: the batch stride is the token stride
    assert kssd._token_stride("b", xbc[:, :1, 48:56], (8,)) == 5 * 64
    with pytest.raises(ValueError, match="contiguous"):
        kssd._token_stride("x", torch.zeros(2, 3, 5, 16).transpose(1, 2),
                           (3, 16))
    with pytest.raises(ValueError, match="contiguous"):
        kssd._token_stride("b", xbc[:, ::2, 48:56], (8,))


# ---------------------------------------------------------------------------
# the mixer on reduced mamba2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    """(cfg of both packages, reference params, port params), reduced
    mamba2-130m; a_log, dt_bias and d_skip drawn away from the init's
    0 / 0 / 1 in both."""
    jcfg = jget_config("mamba2-130m", reduced=True)
    tcfg = get_config("mamba2-130m", reduced=True)
    jp = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(11)
    for blk in jp["blocks"]:
        mix = blk["mixer"]
        for name, loc, scale in (("a_log", 0.0, 0.5), ("dt_bias", -1.0, 0.5),
                                 ("d_skip", 1.0, 0.3)):
            mix[name] = (loc + scale * rng.normal(size=mix[name].shape)
                         ).astype(np.float32)
        blk["ln"] = (0.1 * rng.normal(size=blk["ln"].shape)).astype(
            np.float32)
    tp = interop.params_from_numpy(jp, "cpu")
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp


def _mixer_params(jp, tp, layer=0):
    jm = jax.tree.map(lambda v: v[layer], jp["blocks"][0]["mixer"])
    tm = {k: v[layer] for k, v in tp["blocks"][0]["mixer"].items()}
    return jm, tm


def _hidden(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def test_init_mamba_matches_reference_structure(mamba):
    jcfg, tcfg, jp, tp = mamba
    mine = tssm.init_mamba(torch.Generator().manual_seed(0), tcfg.d_model,
                           tcfg.ssm, device="cpu", dtype=torch.bfloat16)
    want = jssm.init_mamba(jax.random.PRNGKey(0), jcfg.d_model, jcfg.ssm,
                           jnp.bfloat16)
    assert sorted(mine) == sorted(want)
    for k in want:
        assert tuple(mine[k].shape) == want[k].shape, k
        assert str(mine[k].dtype).split(".")[1] == str(want[k].dtype), k
    assert torch.equal(mine["a_log"], torch.zeros(16))
    assert torch.equal(mine["d_skip"], torch.ones(16))
    assert float(mine["conv_w"].float().std()) == pytest.approx(0.1, rel=0.2)


def test_causal_conv_and_ssd_cores_match_reference(mamba):
    jcfg, tcfg, jp, tp = mamba
    jm, tm = _mixer_params(jp, tp)
    xbc = np.random.default_rng(7).normal(size=(2, 24, 288)).astype(
        np.float32)
    np.testing.assert_allclose(
        tssm._causal_conv(_t(xbc), tm["conv_w"]).numpy(),
        np.asarray(jssm._causal_conv(jnp.asarray(xbc), jm["conv_w"])),
        **FN_TOL)
    args = _ssd_inputs(2, 64, 4, 16, 16, 8, 0.1, d_skip=[1.0, 0.5, 0.0, 2.0])
    h0 = np.random.default_rng(9).normal(size=(2, 4, 16, 16)).astype(
        np.float32)
    for got, want in (
            (tssm.ssd_reference(*map(_t, args)),
             jssm.ssd_reference(*map(jnp.asarray, args))),
            (tssm.ssd_chunked(*map(_t, args), chunk=16),
             jssm.ssd_chunked(*map(jnp.asarray, args), chunk=16)),
            (tssm.ssd_chunked(*map(_t, args), chunk=32,
                              initial_state=_t(h0)),
             jssm.ssd_chunked(*map(jnp.asarray, args), chunk=32,
                              initial_state=jnp.asarray(h0)))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **FN_TOL)
    x, dt, a, bb, cc, d = args
    got = tssm.ssd_decode_step(_t(h0), _t(x[:, 0]), _t(dt[:, 0]), _t(a),
                               _t(bb[:, 0]), _t(cc[:, 0]), _t(d))
    want = jssm.ssd_decode_step(jnp.asarray(h0), x[:, 0], dt[:, 0], a,
                                bb[:, 0], cc[:, 0], d)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FN_TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mamba_mixer_matches_reference(mamba, use_pallas):
    """Both values of ``use_pallas`` in both packages: the port's plain
    scan against the reference's Pallas kernel in interpret mode."""
    jcfg, tcfg, jp, tp = mamba
    jm, tm = _mixer_params(jp, tp, layer=1)
    h = _hidden(tcfg, 2, 64, 12)
    got = tssm.mamba_mixer(tm, _t(h), tcfg.ssm, chunk=32,
                           use_pallas=use_pallas)
    want = jssm.mamba_mixer(jm, jnp.asarray(h), jcfg.ssm, chunk=32,
                            use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


def test_mamba_prefill_state_equals_the_recomputed_one(mamba):
    """The state :func:`ssm.mamba_prefill` takes from its own scan equals
    the reference's second pass (``transformer._mamba_prefill_state``),
    for the kernel's plain version and for the chunked path."""
    jcfg, tcfg, jp, tp = mamba
    jm, tm = _mixer_params(jp, tp)
    h = _hidden(tcfg, 2, 32, 13)
    want = jtf._mamba_prefill_state(jm, jnp.asarray(h), jcfg.ssm, 16)
    for use_pallas in (False, True):
        out, st = tssm.mamba_prefill(tm, _t(h), tcfg.ssm, chunk=16,
                                     use_pallas=use_pallas)
        np.testing.assert_allclose(
            out.numpy(), np.asarray(jssm.mamba_mixer(
                jm, jnp.asarray(h), jcfg.ssm, chunk=16)), **FN_TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(want[k]),
                                       **FN_TOL)


def test_mamba_decode_matches_reference_in_place(mamba):
    jcfg, tcfg, jp, tp = mamba
    jm, tm = _mixer_params(jp, tp)
    rng = np.random.default_rng(14)
    st = {"conv": rng.normal(size=(2, 3, 288)).astype(np.float32),
          "ssm": rng.normal(size=(2, 16, 16, 16)).astype(np.float32)}
    h = _hidden(tcfg, 2, 1, 15)
    mine = {k: _t(v) for k, v in st.items()}
    keep = dict(mine)
    for _ in range(3):
        out, new = tssm.mamba_decode(tm, _t(h), mine, tcfg.ssm)
        jout, st = jssm.mamba_decode(jm, jnp.asarray(h), st, jcfg.ssm)
        assert new is mine and all(new[k] is keep[k] for k in keep)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FN_TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(new[k].numpy(), np.asarray(st[k]),
                                       **FN_TOL)
        h = np.asarray(out)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _close_trees(got, want, tol):
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        assert tuple(g.shape) == tuple(w.shape), path
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol,
                                   err_msg=str(path))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_train_and_prefill_match_reference(mamba, use_pallas):
    """Logits of train and prefill, and every layer's conv and SSM state,
    with ``use_pallas`` in both packages (the reference's Pallas kernel in
    interpret mode; the port's state from its own scan)."""
    jcfg, tcfg, jp, tp = mamba
    toks = _tokens(tcfg, 2, 64)
    for mode in ("train", "prefill"):
        jl, _, jc = jtf.forward(jp, jnp.asarray(toks), jcfg, mode=mode,
                                ssd_chunk=32, use_pallas=use_pallas)
        tl, aux, tc = ttf.forward(tp, _t(toks), tcfg, mode=mode,
                                  ssd_chunk=32, use_pallas=use_pallas)
        assert tl.shape == jl.shape and float(aux) == 0.0
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        if mode == "prefill":
            _close_trees(tc, jc, LOGIT_TOL)
        else:
            assert tc is None


def test_prefill_with_a_17_token_prompt_and_decode_match_reference(mamba):
    """A 17-token prompt (chunk = S) and 5 greedy decode steps from the
    O(1) state, written in place."""
    jcfg, tcfg, jp, tp = mamba
    toks = _tokens(tcfg, 2, 17, seed=1)
    jl, jc = jtf.prefill(jp, jnp.asarray(toks), jcfg, use_pallas=True)
    tl, tc = ttf.prefill(tp, _t(toks), tcfg, use_pallas=True)
    for i in range(5):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
        assert np.array_equal(tok[:, 0], tl.argmax(-1).numpy())
        jl, jc = jtf.decode_step(jp, jnp.asarray(tok),
                                 jnp.asarray(17 + i, jnp.int32), jc, jcfg)
        tl, tc2 = ttf.decode_step(tp, _t(tok), 17 + i, tc, tcfg)
        assert tc2 is tc
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _close_trees(tc, jc, LOGIT_TOL)


def test_prefill_raises_when_s_is_not_a_multiple_of_the_chunk(mamba):
    jcfg, tcfg, jp, tp = mamba
    toks = _tokens(tcfg, 1, 150, seed=2)
    with pytest.raises(AssertionError):
        jtf.prefill(jp, jnp.asarray(toks), jcfg, use_pallas=True)
    for use_pallas in (False, True):
        with pytest.raises(ValueError, match="not a multiple of the chunk"):
            ttf.prefill(tp, _t(toks), tcfg, use_pallas=use_pallas)


def test_init_cache_and_paged_refusal_match_reference(mamba):
    jcfg, tcfg, _, tp = mamba
    jc = jtf.init_cache(jcfg, 2, 50)
    tc = ttf.init_cache(tcfg, 2, 50, device="cpu")
    _close_trees(tc, jc, dict(atol=0, rtol=0))
    assert ttf.supports_paged(tcfg) is jtf.supports_paged(jcfg) is False
    with pytest.raises(NotImplementedError, match="attention-only"):
        serve.ServeEngine(tp, tcfg)
    with pytest.raises(NotImplementedError, match="attention-only"):
        jserve.ServeEngine(jtf.init_lm(jax.random.PRNGKey(0), jcfg), jcfg)
    pi = ttf.PageInfo(q_pos=None, scatter_idx=None, scatter_src=None,
                      gather_idx=None, last_idx=None, block_tables=None,
                      lengths=None)
    with pytest.raises(NotImplementedError, match="per-slot, not paged"):
        ttf.forward(tp, torch.zeros(1, 1, dtype=torch.long), tcfg,
                    mode="paged", cache={"blocks": ({},), "tail": ()},
                    pages=pi)


def test_full_size_shapes_match_reference():
    jcfg, tcfg = jget_config("mamba2-130m"), get_config("mamba2-130m")
    want = jax.eval_shape(lambda: jtf.init_lm(jax.random.PRNGKey(0), jcfg))
    got = ttf.init_lm(None, tcfg, device="meta")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [tuple(x.shape) for x in tree_leaves(got)] == \
        [tuple(x.shape) for _, x in flat]
    assert [str(x.dtype).split(".")[1] for x in tree_leaves(got)] == \
        [str(x.dtype) for _, x in flat]
    assert tcfg.n_params() == 167_751_360
    assert (tcfg.ssm.n_heads(tcfg.d_model), tcfg.ssm.d_state,
            tcfg.ssm.head_dim, tcfg.vocab_padded) == (24, 128, 64, 50432)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_sequential_generate_matches_reference(mamba):
    jcfg, tcfg, jp, tp = mamba
    prompts = _tokens(tcfg, 2, 12, seed=9)
    want = jserve.sequential_generate(jp, jcfg, jnp.asarray(prompts),
                                      gen_len=6, cache_len=20)
    for use_pallas in (False, True):
        got = serve.sequential_generate(tp, tcfg, _t(prompts), gen_len=6,
                                        cache_len=20, use_pallas=use_pallas)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serving_checkpoint_round_trips_both_ways(mamba, tmp_path):
    jcfg, tcfg, jp, tp = mamba
    path = str(tmp_path / "ref.npz")
    jserve.save_serving_checkpoint(path, jp, jcfg)
    params, cfg = serve.load_serving_checkpoint(path, device="cpu")
    assert cfg == tcfg
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                          tree_leaves(params)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=kp)
    path = str(tmp_path / "port.npz")
    serve.save_serving_checkpoint(path, tp, tcfg)
    jparams, got_cfg = jserve.load_serving_checkpoint(path)
    assert got_cfg == jcfg
    for a, b in zip(jax.tree.leaves(jparams), tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_serve_cli_baseline_runs_mamba_on_the_cpu(use_pallas):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--arch", "mamba2-130m",
         "--baseline", "--device", "cpu", "--requests", "3", "--max-new",
         "4"] + (["--use-pallas"] if use_pallas else []),
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src"})
    assert res.returncode == 0, res.stderr[-3000:]
    row = json.loads(res.stdout.strip().splitlines()[-1])
    assert row["mode"] == "sequential" and row["device"] == "cpu"
    assert row["arch"] == "mamba2-130m-reduced" and row["tokens_per_s"] > 0
