"""The port's kernel modules on the CPU: the plain versions of the four
``qg_update`` and the three ``compress`` kernels against the JAX package's
Pallas kernels (interpret mode) and its ``kernels/ref.py``;
``pack``/``unpack``; the bytes-moved model; and the device dispatch of
``kernels/ops.py``.

Tolerances: against the reference's eager ``ref.py`` the plain versions are
exact -- the same fp32 operations in the same order, each rounded once --
except ``qg_buffer_update``, whose reference divides by eta where the
kernel multiplies by a folded 1/eta (a few ulps, 1e-5 of values of order
10).  Against the interpret-mode Pallas kernels, whose jit may contract
a*b + c into one FMA, they agree to about one ulp (1e-6 for values of
order 1, the bound tests/test_kernels.py uses)."""
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
from repro_torch.kernels import compress as tC
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pack as tpack
from repro_torch.kernels import qg_update as tK

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
    counts = tops.launch_counts()
    assert set(counts) == {"fused_halfstep", "fused_qg_buffer",
                           "qg_local_step", "qg_buffer_update",
                           "gamma_correct", "threshold_mask",
                           "quantize_dequantize"}
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


def test_rowwise_wrappers_check_shapes_before_building():
    x2d = torch.randn(2, 4)
    with pytest.raises(ValueError, match=r"\[rows, f\]"):
        tC.threshold_mask(x2d.reshape(-1), x2d[:, 0])
    with pytest.raises(ValueError, match="u has shape"):
        tC.quantize_dequantize(x2d, x2d[:, 0], x2d.reshape(4, 2), levels=3)
