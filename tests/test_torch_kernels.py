"""The port's kernel modules on the CPU: the plain versions of the four
``qg_update``, the three ``compress`` and the two attention kernels against
the JAX package's Pallas kernels (interpret mode) and its ``kernels/ref.py``;
``pack``/``unpack``; the bytes-moved model; and the device dispatch of
``kernels/ops.py``.

Tolerances: against the reference's eager ``ref.py`` the plain versions are
exact -- the same fp32 operations in the same order, each rounded once --
except ``qg_buffer_update``, whose reference divides by eta where the
kernel multiplies by a folded 1/eta (a few ulps, 1e-5 of values of order
10).  Against the interpret-mode Pallas kernels, whose jit may contract
a*b + c into one FMA, they agree to about one ulp (1e-6 for values of
order 1, the bound tests/test_kernels.py uses).

The attention versions sum in another order than the reference's (one
softmax over the row, against its online blocks or its dense softmax), so
they are held at the reference's own bounds for its flash kernel
(tests/test_kernels.py:182): 2e-5 abs in fp32 on outputs of order 1, and
2e-2 in bf16, one bf16 ulp at |x| in [2, 4) where both round the same fp32
value on either side of a rounding boundary.  On a paged slot of length 0
the plain version gives 0, as the Pallas kernel does, where ``ref.py``'s
dense-gather oracle gives the mean of the gathered values; it is held to
the kernel there and to ``ref.py`` on the other rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optim as joptim
from repro.core import transforms as jT
from repro.kernels import compress as jcmp
from repro.kernels import ops as jops
from repro.kernels import pack as jpack
from repro.kernels import ref as jref
from repro_torch.core import optim as toptim
from repro_torch.core import transforms as tT
from repro_torch.kernels import attention as tA
from repro_torch.kernels import compress as tC
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pack as tpack
from repro_torch.kernels import qg_update as tK
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ref import attn_scale as tref_attn_scale

SHAPES = [(), (1,), (7,), (8191,), (8193,), (13, 17), (3, 5, 11)]
PALLAS_TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(shape, k=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(k)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("emit_m", [True, False])
@pytest.mark.parametrize("wd,nesterov", [(0.0, False), (0.0, True),
                                         (1e-4, False), (1e-4, True)])
def test_fused_halfstep_plain_matches_reference(shape, emit_m, wd, nesterov):
    x, m, g = _inputs(shape, seed=1)
    eta = np.float32(0.1)
    out = tops.fused_halfstep(_t(x), _t(m), _t(g),
                              torch.tensor([0.1], dtype=torch.float32),
                              beta=0.9, wd=wd, nesterov=nesterov,
                              emit_m=emit_m)
    outs = out if emit_m else (out,)
    half_r, m_r = jref.fused_halfstep_ref(jnp.asarray(x), jnp.asarray(m),
                                          jnp.asarray(g), 0.1, beta=0.9,
                                          wd=wd, nesterov=nesterov)
    pal = jops.fused_halfstep(jnp.asarray(x), jnp.asarray(m), jnp.asarray(g),
                              eta, beta=0.9, wd=wd, nesterov=nesterov,
                              emit_m=emit_m, interpret=True)
    pal = pal if emit_m else (pal,)
    for got, want_ref, want_pal in zip(outs, (half_r, m_r), pal):
        assert tuple(got.shape) == shape and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
        np.testing.assert_allclose(got.numpy(), np.asarray(want_pal),
                                   **PALLAS_TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("refresh", [0.0, 1.0])
def test_fused_qg_buffer_plain_matches_reference(shape, refresh):
    xo, xn, mh = _inputs(shape, seed=2)
    out = tops.fused_qg_buffer(_t(xo), _t(xn), _t(mh),
                               torch.tensor([0.05]), torch.tensor([refresh]),
                               mu=0.9)
    want_ref = jref.fused_qg_buffer_ref(jnp.asarray(xo), jnp.asarray(xn),
                                        jnp.asarray(mh), jnp.float32(0.05),
                                        refresh, mu=0.9)
    want_pal = jops.fused_qg_buffer(jnp.asarray(xo), jnp.asarray(xn),
                                    jnp.asarray(mh), jnp.float32(0.05),
                                    jnp.float32(refresh), mu=0.9,
                                    interpret=True)
    assert tuple(out.shape) == shape
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_ref))
    # (x_pre - x_post)/eta reaches ~60 here: 1e-6 relative is ~1 ulp
    np.testing.assert_allclose(out.numpy(), np.asarray(want_pal), rtol=1e-6,
                               atol=1e-5)
    if refresh == 0.0:      # an off-cadence tau step carries m_hat through
        np.testing.assert_array_equal(out.numpy(), mh)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("nesterov", [False, True])
def test_qg_local_step_plain_matches_reference(shape, nesterov):
    x, m, g = _inputs(shape, seed=3)
    out = tops.qg_local_step(_t(x), _t(m), _t(g), eta=0.1, beta=0.9,
                             nesterov=nesterov)
    want_ref = jref.qg_local_step_ref(jnp.asarray(x), jnp.asarray(m),
                                      jnp.asarray(g), eta=0.1, beta=0.9,
                                      nesterov=nesterov)
    want_pal = jops.qg_local_step(jnp.asarray(x), jnp.asarray(m),
                                  jnp.asarray(g), eta=0.1, beta=0.9,
                                  nesterov=nesterov, interpret=True)
    assert tuple(out.shape) == shape
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_ref))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_pal),
                               **PALLAS_TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mu", [0.0, 0.5, 0.9])
def test_qg_buffer_update_plain_matches_reference(shape, mu):
    xo, xn, mh = _inputs(shape, seed=4)
    out = tops.qg_buffer_update(_t(xo), _t(xn), _t(mh), eta=0.05, mu=mu)
    want_ref = jref.qg_buffer_update_ref(jnp.asarray(xo), jnp.asarray(xn),
                                         jnp.asarray(mh), eta=0.05, mu=mu)
    want_pal = jops.qg_buffer_update(jnp.asarray(xo), jnp.asarray(xn),
                                     jnp.asarray(mh), eta=0.05, mu=mu,
                                     interpret=True)
    assert tuple(out.shape) == shape
    np.testing.assert_allclose(out.numpy(), np.asarray(want_ref), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_pal), rtol=1e-6,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# compress kernels
# ---------------------------------------------------------------------------

def _bits_equal(got, want):
    """Equal to the bit, except that +0 and -0 count as equal (the sign of a
    zero from sign(x)*xi is not part of the contract)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)   # -0 == +0 here
    same = (got.view(np.int32) == want.view(np.int32)) | (got == 0)
    assert same.all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("gamma", [0.3, 0.0123])
def test_gamma_correct_plain_matches_reference(shape, gamma):
    x, mx, h = _inputs(shape, seed=6)
    out = tops.gamma_correct(_t(x), _t(mx), _t(h), gamma=gamma)
    want_ref = jref.gamma_correct_ref(jnp.asarray(x), jnp.asarray(mx),
                                      jnp.asarray(h), gamma=gamma)
    want_pal = jops.gamma_correct(jnp.asarray(x).reshape(-1),
                                  jnp.asarray(mx).reshape(-1),
                                  jnp.asarray(h).reshape(-1), gamma=gamma,
                                  interpret=True)
    assert tuple(out.shape) == shape and out.dtype == torch.float32
    _bits_equal(out.numpy(), want_ref)
    np.testing.assert_allclose(out.numpy().reshape(-1), np.asarray(want_pal),
                               **PALLAS_TOL)


#: the reference's parity shapes (tests/test_comm.py), the quickstart MLP's
#: four node-stacked leaves, and odd ones
ROW_SHAPES = [(1, 1), (1, 64), (3, 517), (5, 2048), (2, 130001), (16, 20),
              (16, 64), (16, 1280), (16, 12288)]


def _rows(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_threshold_mask_plain_matches_reference(shape):
    x = _rows(shape, 7)
    # ties at the threshold: the row's first entry repeats its k-th
    # magnitude with the other sign, and both must be kept
    k = max(1, shape[1] // 10)
    thr = -np.sort(-np.abs(x), axis=1)[:, k - 1].astype(np.float32)
    if shape[1] > 1:
        x[:, 0] = -thr
    q, r = tops.threshold_mask(_t(x), _t(thr))
    qr, rr = jref.threshold_mask_ref(jnp.asarray(x), jnp.asarray(thr))
    qp, rp = jcmp.threshold_mask(jnp.asarray(x), jnp.asarray(thr),
                                 interpret=True)
    for got, want_ref, want_pal in ((q, qr, qp), (r, rr, rp)):
        _bits_equal(got.numpy(), want_ref)
        _bits_equal(got.numpy(), want_pal)
    assert ((q.numpy() != 0) == (np.abs(x) >= thr[:, None])).all()
    np.testing.assert_array_equal(q.numpy()[:, 0], x[:, 0])  # the tie kept
    np.testing.assert_array_equal((q + r).numpy(), x)


@pytest.mark.parametrize("shape", ROW_SHAPES)
@pytest.mark.parametrize("levels", [1, 3, 15])
def test_quantize_dequantize_plain_matches_reference(shape, levels):
    rng = np.random.default_rng(8)
    x = _rows(shape, 9)
    u = rng.random(size=shape, dtype=np.float32)
    u[:, ::3] = np.float32(1) - np.float32(2 ** -24)  # u just under 1
    scale = np.abs(x).max(axis=1)
    if shape[0] > 1:                  # a zero row: scale clamps to 1e-12
        x[-1] = 0.0
        scale[-1] = 0.0
    q, r = tops.quantize_dequantize(_t(x), _t(scale), _t(u), levels=levels)
    qr, rr = jref.quantize_dequantize_ref(jnp.asarray(x), jnp.asarray(scale),
                                          jnp.asarray(u), levels=levels)
    qp, rp = jcmp.quantize_dequantize(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(u), levels=levels,
                                      interpret=True)
    for got, want_ref, want_pal in ((q, qr, qp), (r, rr, rp)):
        assert np.isfinite(got.numpy()).all()
        _bits_equal(got.numpy(), want_ref)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_pal),
                                   **PALLAS_TOL)
    # no level past L: |q| <= scale, and the zero row stays zero
    assert (np.abs(q.numpy()) <= scale[:, None] * (1 + 1e-6)).all()
    if shape[0] > 1:
        assert not q.numpy()[-1].any()


# ---------------------------------------------------------------------------
# packed layout
# ---------------------------------------------------------------------------

def _np_tree(seed=5):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(37, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "s": np.float32(rng.normal()),
            "inner": {"h": rng.normal(size=(2, 3, 4)).astype(np.float32)}}


def test_plan_pack_matches_reference_offsets():
    tree = _np_tree()
    js = jpack.plan_pack(jax.tree.map(jnp.asarray, tree))
    ts = tpack.plan_pack({k: (_t(v) if not isinstance(v, dict)
                              else {kk: _t(vv) for kk, vv in v.items()})
                          for k, v in tree.items()})
    assert (ts.offsets, ts.sizes, ts.shapes, ts.total, ts.padded, ts.tile) \
        == (js.offsets, js.sizes, js.shapes, js.total, js.padded, js.tile)
    assert ts.pad_waste == js.pad_waste


def test_pack_unpack_roundtrip_views():
    tree = {"w": torch.randn(37, 3), "b": torch.randn(5),
            "s": torch.randn(()), "h": torch.randn(2, 3, 4)}
    spec = tpack.plan_pack(tree)
    assert spec.total == 37 * 3 + 5 + 1 + 24
    buf = tpack.pack(spec, tree)
    assert buf.shape == (spec.total,) and buf.dtype == torch.float32
    out = tpack.unpack(spec, buf)
    assert set(out) == set(tree)
    for k in tree:
        assert out[k].shape == tree[k].shape and out[k].dtype == tree[k].dtype
        assert torch.equal(out[k], tree[k])
        # every leaf is a view into the buffer: unpacking copies nothing
        assert out[k].data_ptr() == buf.data_ptr() + 4 * spec.offsets[
            spec.paths.index((k,))]
    # the kernels stream fp32 only: other leaves are refused, not cast
    with pytest.raises(TypeError, match=r"\('h',\) is torch.bfloat16"):
        tpack.pack(spec, {**tree, "h": tree["h"].to(torch.bfloat16)})


def test_pack_leaf_count_mismatch_raises():
    spec = tpack.plan_pack({"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaves"):
        tpack.pack(spec, {"w": torch.zeros(4), "b": torch.zeros(2)})


# ---------------------------------------------------------------------------
# bytes-moved model
# ---------------------------------------------------------------------------

OPTS = ["dsgd", "dsgdm", "dsgdm_n", "qg_dsgdm", "qg_dsgdm_n", "qg_dsgdm_tau"]


@pytest.mark.parametrize("name", OPTS)
@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_chain_bytes_moved_matches_reference(name, wd):
    js = joptim.make_optimizer(name, lr=0.1, weight_decay=wd)._stages()
    ts = toptim.make_optimizer(name, lr=0.1, weight_decay=wd)._stages()
    for n_elems in (100, 13_652 * 16, 525_000):
        assert tT.chain_bytes_moved(ts, n_elems, fused="off") == \
            jT.chain_bytes_moved(js, n_elems, fused="off")
        for fused in ("kernel", "pallas"):
            assert tT.chain_bytes_moved(ts, n_elems, fused=fused) == \
                jT.chain_bytes_moved(js, n_elems, fused="pallas")
    # 'auto' follows the device: the fused count on CUDA, unfused on CPU
    assert tT.chain_bytes_moved(ts, 525_000, fused="auto", device="cuda") \
        == jT.chain_bytes_moved(js, 525_000, fused="pallas")
    assert tT.chain_bytes_moved(ts, 525_000, fused="auto") == \
        jT.chain_bytes_moved(js, 525_000, fused="off")


def test_fused_knob_resolution():
    assert tT._fused_enabled("off", "cuda") is False
    assert tT._fused_enabled("kernel", "cpu") is True
    assert tT._fused_enabled("pallas", "cpu") is True
    assert tT._fused_enabled("auto", "cpu") is False
    assert tT._fused_enabled("auto", "cuda") is True
    with pytest.raises(ValueError, match="fused"):
        tT._fused_enabled("bogus", "cpu")


# ---------------------------------------------------------------------------
# device dispatch and launch counters
# ---------------------------------------------------------------------------

def test_cpu_dispatch_leaves_launch_counters_at_zero():
    tops.reset_launch_counts()
    x, m, g = (torch.randn(100) for _ in range(3))
    eta, one = torch.tensor([0.1]), torch.tensor([1.0])
    tops.fused_halfstep(x, m, g, eta, beta=0.9, emit_m=True)
    tops.fused_qg_buffer(x, m, g, eta, one, mu=0.9)
    tops.qg_local_step(x, m, g, eta=0.1, beta=0.9)
    tops.qg_buffer_update(x, m, g, eta=0.1, mu=0.9)
    # and a whole fused chain step on CPU tensors
    opt = toptim.make_optimizer("qg_dsgdm_n", lr=0.1, weight_decay=1e-4,
                                fused="kernel")
    params = {"w": torch.randn(4, 6, 5), "b": torch.randn(4, 5)}
    w = torch.full((4, 4), 0.25)
    opt.step(params, params, opt.init(params), w=w, t=0)
    x2d = x.reshape(4, 25)
    tops.gamma_correct(x, m, g, gamma=0.3)
    tops.threshold_mask(x2d, x2d.abs().amax(dim=1))
    tops.quantize_dequantize(x2d, x2d.abs().amax(dim=1), torch.rand(4, 25),
                             levels=15)
    q = torch.randn(1, 8, 4, 32)
    tops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    tops.paged_decode_attention(q[:, :1], q.reshape(2, 4, 4, 32)[:, :, :2],
                                q.reshape(2, 4, 4, 32)[:, :, :2],
                                torch.tensor([[1, -1]], dtype=torch.int32),
                                torch.tensor([3], dtype=torch.int32))
    tops.ssd_scan(q, torch.rand(1, 8, 4), -torch.ones(4), q[:, :, 0, :16],
                  q[:, :, 1, :16], torch.ones(4), chunk=4)
    counts = tops.launch_counts()
    assert set(counts) == {"fused_halfstep", "fused_qg_buffer",
                           "qg_local_step", "qg_buffer_update",
                           "gamma_correct", "threshold_mask",
                           "quantize_dequantize", "flash_attention",
                           "paged_decode_attention", "paged_decode_merge",
                           "ssd_scan"}
    assert counts == {k: 0 for k in counts}


def test_dispatch_refuses_mixed_or_other_devices():
    x = torch.randn(8)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        tops.qg_local_step(x, x, torch.randn(8, device="meta"), eta=0.1,
                           beta=0.9)


def test_kernel_wrappers_refuse_cpu_tensors_before_building():
    """The CUDA wrappers take CUDA tensors only: a CPU tensor is refused by
    the argument checks, never silently computed on the host."""
    x = torch.randn(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tK.fused_halfstep(x, x, x, torch.tensor([0.1]), beta=0.9)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tK.fused_qg_buffer(x, x, x, torch.tensor([0.1]), torch.tensor([1.0]),
                           mu=0.9)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tK.qg_local_step(x, x, x, eta=0.1, beta=0.9)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tK.qg_buffer_update(x, x, x, eta=0.1, mu=0.9)
    x2d = x.reshape(2, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tC.gamma_correct(x, x, x, gamma=0.3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tC.threshold_mask(x2d, x2d[:, 0].contiguous())
    with pytest.raises(ValueError, match="CUDA tensor"):
        tC.quantize_dequantize(x2d, x2d[:, 0].contiguous(), x2d, levels=15)
    q = torch.randn(1, 4, 4, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tA.flash_attention(q, q, q)
    bt, ln = (torch.zeros(1, 1, dtype=torch.int32),
              torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tA.paged_decode_attention(q[:, :1], q, q, bt, ln)


def test_rowwise_wrappers_check_shapes_before_building():
    x2d = torch.randn(2, 4)
    with pytest.raises(ValueError, match=r"\[rows, f\]"):
        tC.threshold_mask(x2d.reshape(-1), x2d[:, 0])
    with pytest.raises(ValueError, match="u has shape"):
        tC.quantize_dequantize(x2d, x2d[:, 0], x2d.reshape(4, 2), levels=3)


# ---------------------------------------------------------------------------
# attention: flash and paged decode
# ---------------------------------------------------------------------------

#: the reference's ATTN_CASES (tests/test_kernels.py:162):
#: (B, S, T, H, KH, D, kwargs)
ATTN_CASES = [
    (1, 128, 128, 4, 4, 32, {}), (2, 256, 256, 8, 2, 64, {}),
    (1, 200, 200, 4, 2, 32, {}), (1, 256, 256, 4, 4, 32, {"window": 64}),
    (1, 256, 256, 4, 4, 32, {"softcap": 30.0}),
    (1, 128, 192, 4, 4, 32, {"causal": False}),
]
ATT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _attn_inputs(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":  # both packages start from the same bf16 values
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrs]
    return arrs


def _to_torch(a):
    if a.dtype == np.float32 or a.dtype.kind in "iu":
        return torch.from_numpy(np.array(a))
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_reference(case, dtype):
    b, s, t, h, kh, d, kw = case
    q, k, v = _attn_inputs([(b, s, h, d), (b, t, kh, d), (b, t, kh, d)],
                           dtype, seed=sum(case[:6]))
    got = tops.flash_attention(_to_torch(q), _to_torch(k), _to_torch(v),
                               **kw)
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    assert got.shape == (b, s, h, d)
    got = got.float().numpy()
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), block_q=64, block_k=128,
                                  interpret=True, **kw)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw)
    for exp in (pallas, want):
        np.testing.assert_allclose(got, np.asarray(exp, np.float32),
                                   atol=ATT_TOL[dtype], rtol=0)


def test_flash_attention_plain_matches_model_chunked_path():
    from repro_torch.models import attention as tAtt
    q, k, v = (_to_torch(a) for a in _attn_inputs(
        [(2, 256, 8, 64), (2, 256, 4, 64), (2, 256, 4, 64)], "float32", 5))
    a = tops.flash_attention(q, k, v, causal=True, window=64)
    b = tAtt.chunked_attention(q, k, v, causal=True, window=64, chunk=128)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5, rtol=0)


#: the reference's paged cases (tests/test_serve.py:234):
#: (b, h, kh, d, ps, pmax, np_, window, softcap)
PAGED_CASES = [
    (3, 8, 2, 32, 16, 8, 6, 0, 0.0),
    (2, 4, 4, 64, 8, 4, 8, 0, 30.0),
    (4, 8, 2, 32, 16, 8, 6, 20, 50.0),
    (1, 4, 2, 16, 1, 16, 16, 0, 0.0),
]


def _paged_inputs(case, seed, *, dead_slot: bool):
    b, h, kh, d, ps, pmax, np_, _, _ = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kp = rng.normal(size=(np_, ps, kh, d)).astype(np.float32)
    vp = rng.normal(size=(np_, ps, kh, d)).astype(np.float32)
    lengths = rng.integers(1, min(pmax, np_) * ps + 1, size=b).astype(
        np.int32)
    if dead_slot:
        lengths[-1] = 0
    bt = np.full((b, pmax), -1, np.int32)
    for i in range(b):
        need = -(-int(lengths[i]) // ps)
        bt[i, :need] = rng.choice(np_, size=need, replace=False)
    return q, kp, vp, bt, lengths


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dead_slot", [False, True])
def test_paged_decode_plain_matches_reference(case, dead_slot):
    """The plain version equals the reference's Pallas kernel (interpret
    mode) on every row, length-0 slots included (0 from both), and its
    dense-gather oracle on every row that sees a key."""
    window, softcap = case[7], case[8]
    arrs = _paged_inputs(case, seed=case[0] * 100 + case[4],
                         dead_slot=dead_slot)
    got = tops.paged_decode_attention(*(_to_torch(a) for a in arrs),
                                      window=window, softcap=softcap)
    got = got.numpy()
    jarrs = [jnp.asarray(a) for a in arrs]
    pallas = np.asarray(jops.paged_decode_attention(
        *jarrs, window=window, softcap=softcap, interpret=True))
    want = np.asarray(jref.paged_decode_attention_ref(
        *jarrs, window=window, softcap=softcap))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
    live = arrs[-1] > 0
    np.testing.assert_allclose(got[live], want[live], atol=1e-5, rtol=1e-5)
    if dead_slot:
        assert not got[~live].any() and not pallas[~live].any()
        # where the dense-gather oracle averages the gathered values
        assert np.abs(want[~live]).max() > 0


def test_paged_decode_plain_matches_reference_in_bf16():
    case = PAGED_CASES[0]
    q, kp, vp, bt, ln = _paged_inputs(case, seed=3, dead_slot=True)
    q, kp, vp = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, kp, vp))
    got = tops.paged_decode_attention(*(_to_torch(a) for a in
                                        (q, kp, vp, bt, ln)))
    assert got.dtype == torch.bfloat16
    pallas = jops.paged_decode_attention(*(jnp.asarray(a) for a in
                                           (q, kp, vp, bt, ln)),
                                         interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32),
                               atol=ATT_TOL["bfloat16"], rtol=0)


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("pps", [1, 2, 3, "P"])
@pytest.mark.parametrize("dead_slot", [False, True])
def test_paged_split_merge_matches_reference(case, pps, dead_slot):
    """The paged kernel's two passes written plainly (split over pages,
    then merged) equal the one-pass plain version and the reference's
    Pallas kernel (interpret mode), length-0 slots 0 from all three."""
    window, softcap = case[7], case[8]
    arrs = _paged_inputs(case, seed=case[0] * 100 + case[4],
                         dead_slot=dead_slot)
    ta = [_to_torch(a) for a in arrs]
    pps = case[5] if pps == "P" else pps
    m, l, acc = tref.paged_decode_partials(*ta, pages_per_split=pps,
                                           window=window, softcap=softcap)
    n_split = -(-case[5] // pps)
    assert m.shape == l.shape == (case[0], case[2], n_split,
                                  case[1] // case[2])
    assert acc.shape == m.shape + (case[3],)
    got = tref.paged_decode_merge(m, l, acc).numpy()
    plain = tops.paged_decode_attention(*ta, window=window,
                                        softcap=softcap).numpy()
    pallas = np.asarray(jops.paged_decode_attention(
        *(jnp.asarray(a) for a in arrs), window=window, softcap=softcap,
        interpret=True))
    for want in (plain, pallas):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if dead_slot:
        assert not got[-1].any()
        assert (m[-1] == tref.NEG_INF).all() and not l[-1].any()


def test_paged_split_merge_window_empties_splits():
    """A window that leaves whole splits outside it: those splits are
    empty partials (m = NEG_INF, l = 0, acc = 0) and the merge still equals
    the plain version and the reference's Pallas kernel."""
    b, h, kh, d, ps, pmax, np_ = 2, 8, 2, 32, 4, 16, 40
    rng = np.random.default_rng(11)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kp, vp = (rng.normal(size=(np_, ps, kh, d)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([61, 30], np.int32)
    bt = np.full((b, pmax), -1, np.int32)
    perm = rng.permutation(np_)
    bt[0, :16], bt[1, :8] = perm[:16], perm[16:24]
    arrs = (q, kp, vp, bt, lengths)
    m, l, acc = tref.paged_decode_partials(*(_to_torch(a) for a in arrs),
                                           pages_per_split=2, window=9)
    # slot 0 sees tokens 52..60 (split 6 and 7), slot 1 tokens 21..29
    # (splits 2 and 3): every other split is empty
    live = (l > 0).any(dim=(1, 3))
    assert live.tolist() == [[i in (6, 7) for i in range(8)],
                             [i in (2, 3) for i in range(8)]]
    dead = ~live[:, None, :, None]
    assert (m[dead.expand_as(m)] == tref.NEG_INF).all()
    assert not l[dead.expand_as(l)].any()
    assert not acc[dead[..., None].expand_as(acc)].any()
    got = tref.paged_decode_merge(m, l, acc).numpy()
    plain = tops.paged_decode_attention(*(_to_torch(a) for a in arrs),
                                        window=9).numpy()
    pallas = np.asarray(jops.paged_decode_attention(
        *(jnp.asarray(a) for a in arrs), window=9, interpret=True))
    for want in (plain, pallas):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,want", [
    ((8, 4, 16, 16), (1, 16)),       # the serving engine's: no merge
    ((8, 4, 256, 16), None),         # 8 slots x 4096 tokens
    ((1, 1, 1000, 1), None), ((3, 2, 8, 16), (1, 8)),
    ((64, 8, 512, 16), None), ((2, 16, 20, 16), None)])
def test_paged_splits_rule(shape, want):
    b, kh, p, ps = shape
    splits, pps = tA.paged_splits(b, kh, p, ps)
    if want is not None:
        assert (splits, pps) == want
    # the splits cover the pages exactly once, in order
    assert splits * pps >= p > (splits - 1) * pps
    if p * ps > tA.SPLIT_MIN_TOKENS:
        assert pps * ps >= tA.SPLIT_MIN_ROWS or splits == 1
        assert b * kh * splits >= tA.SPLIT_BLOCKS or pps * ps < 2 * \
            tA.SPLIT_MIN_ROWS or splits * 2 > p
    if shape == (8, 4, 256, 16):
        assert b * kh * splits >= 264


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits' unit to
    the magnitude bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a, b, eq, *, exact_a=False, exact_b=False):
    """einsum ``eq`` of fp32 a and b as the flash kernel forms it: each
    operand split hi = tf32(x), lo = tf32(x - hi) unless exact in TF32,
    and the product a_lo b_hi + a_hi b_lo + a_hi b_hi (products of TF32
    values are exact in fp32; sums in fp32)."""
    def split(x, exact):
        if exact:
            return x, torch.zeros_like(x)
        hi = _tf32_rna(x)
        return hi, _tf32_rna(x - hi)
    (ah, al), (bh, bl) = split(a, exact_a), split(b, exact_b)
    out = torch.einsum(eq, ah, bh)
    for x, y in ((al, bh), (ah, bl)):
        if x.any() and y.any():
            out = torch.einsum(eq, x, y) + out
    return out


def _flash_3xtf32(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The flash kernel's numerics on the CPU: scores and P V from TF32
    products (three per fp32 product; Q K^T one and P V two for bf16
    inputs, which TF32 holds exactly), softmax and the rest in fp32."""
    exact = q.dtype == torch.bfloat16
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = tref_attn_scale(d)
    qf = q.reshape(b, s, kh, g, d).float()
    if not exact:
        qf = qf * scale
    sc = _matmul_3xtf32(qf, k.float(), "bskgd,btkd->bskgt", exact_a=exact,
                        exact_b=exact)
    if exact:
        sc = sc * scale
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    q_pos = torch.arange(s)[:, None]
    k_pos = torch.arange(t)[None, :]
    mask = torch.ones(s, t, dtype=torch.bool)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    mask = mask[None, :, None, None, :]
    sc = torch.where(mask, sc, tref.NEG_INF)
    p = torch.where(mask, torch.exp(sc - sc.amax(dim=-1, keepdim=True)), 0.0)
    acc = _matmul_3xtf32(p, v.float(), "bskgt,btkd->bskgd", exact_b=exact)
    out = acc / torch.clamp_min(p.sum(dim=-1)[..., None], 1e-30)
    return out.reshape(b, s, h, d).to(q.dtype)


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0 + 2.0 ** -10             # a TF32 value
    half = 2.0 ** -11                  # half of TF32's unit at 1
    x = torch.tensor([1.0 + half, -(1.0 + half), one + half,
                      1.0 + half - 2.0 ** -23, 3.0, 0.0],
                     dtype=torch.float32)
    got = _tf32_rna(x).tolist()
    assert got == [one, -one, one + 2.0 ** -10, 1.0, 3.0, 0.0]
    y = torch.randn(1000)
    hi = _tf32_rna(y)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert ((y - hi).abs() <= hi.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_3xtf32_emulation_holds_att_tol(case, dtype):
    """The tensor-core flash kernel's numeric design holds ATT_TOL against
    the plain fp32 version (and plain TF32 would not, in fp32)."""
    b, s, t, h, kh, d, kw = case
    q, k, v = (_to_torch(a) for a in _attn_inputs(
        [(b, s, h, d), (b, t, kh, d), (b, t, kh, d)], dtype,
        seed=sum(case[:6])))
    got = _flash_3xtf32(q, k, v, **kw)
    want = tref.flash_attention(q, k, v, **kw)
    assert got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATT_TOL[dtype], err
    if dtype == "float32":  # one TF32 product per fp32 product is too coarse
        qt, kt, vt = (_tf32_rna(x) for x in (q, k, v))
        coarse = tref.flash_attention(qt, kt, vt, **kw)
        assert float((coarse - want).abs().max()) > ATT_TOL[dtype]


def test_attention_wrappers_check_dtype_and_shapes_before_building():
    """No fallback: a dtype or a head_dim the kernels do not take is
    refused, never sent to the plain path."""
    q16 = torch.randn(1, 4, 4, 32, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tA.flash_attention(q16, q16, q16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tA.paged_decode_attention(q16[:, :1], q16, q16,
                                  torch.zeros(1, 1, dtype=torch.int32),
                                  torch.ones(1, dtype=torch.int32))
    q48 = torch.randn(1, 4, 4, 48)
    with pytest.raises(ValueError, match="head_dim 48"):
        tA.flash_attention(q48, q48, q48)
    with pytest.raises(ValueError, match="head_dim 48"):
        tA.paged_decode_attention(q48[:, :1], q48, q48,
                                  torch.zeros(1, 1, dtype=torch.int32),
                                  torch.ones(1, dtype=torch.int32))
    q = torch.randn(1, 4, 4, 32)
    with pytest.raises(ValueError, match="do not fit"):
        tA.flash_attention(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(ValueError, match=r"block_tables \[B,P\]"):
        tA.paged_decode_attention(q[:, :1], q, q,
                                  torch.zeros(2, 1, dtype=torch.int32),
                                  torch.ones(1, dtype=torch.int32))
    assert tA.FLASH_HEAD_DIMS == (32, 64, 128)
    assert tA.PAGED_HEAD_DIMS == (16, 32, 64, 128)


def test_attention_scale_matches_reference():
    for d in (16, 32, 64, 112, 128):
        assert tref_attn_scale(d) == float(
            1.0 / jnp.sqrt(jnp.asarray(d, jnp.float32)))
