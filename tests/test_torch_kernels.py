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
the kernel there and to ``ref.py`` on the other rows.

The tensor-core kernels' numerics (flash, the SSD scan's chunk passes) are
emulated on the CPU, TF32 rounding bit for bit, and held to the fp32
tolerance of their plain versions: 2e-5 for flash, atol 5e-4 / rtol 1e-3
for the scan (the reference's own kernel-vs-oracle bound,
tests/test_kernels.py:221)."""
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
# the grouped row-wise calls: one launch per message
# ---------------------------------------------------------------------------

#: the quickstart MLP's four node-stacked leaves (b1, b2, w1, w2)
QUICKSTART_LEAVES = [(16, 64), (16, 20), (16, 12288), (16, 1280)]
#: groups of leaves: the quickstart message, odd widths, and both with a
#: leaf that is a view offset by 1-3 elements into a larger buffer
GROUPS = {"quickstart": (QUICKSTART_LEAVES, 0),
          "odd": ([(1, 1), (3, 517), (5, 8193)], 0),
          "quickstart+view1": (QUICKSTART_LEAVES + [(3, 517)], 1),
          "odd+view2": ([(1, 1), (5, 8193), (4, 38)], 2),
          "view3": ([(2, 11)], 3)}


def _group_leaves(name, seed):
    """numpy leaves of group ``name`` and the torch tensors the port gets:
    the last leaf of a group with an offset is a view that many elements
    into a buffer."""
    shapes, offset = GROUPS[name]
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ts = [_t(x) for x in xs]
    if offset:
        n = xs[-1].size
        buf = torch.zeros(n + offset)
        buf[offset:] = ts[-1].reshape(-1)
        ts[-1] = buf[offset:].view(shapes[-1])
        assert ts[-1].storage_offset() == offset
    return xs, ts


@pytest.mark.parametrize("group", list(GROUPS))
def test_threshold_mask_group_plain_matches_reference(group):
    """The plain group equals, bit for bit, the per-leaf plain version, the
    reference's ``threshold_mask_ref`` and its Pallas kernel (interpret
    mode) on every leaf; ties at the threshold are kept."""
    xs, ts = _group_leaves(group, 11)
    thrs = []
    for x, t in zip(xs, ts):
        k = max(1, x.shape[1] // 10)
        thr = -np.sort(-np.abs(x), axis=1)[:, k - 1].astype(np.float32)
        if x.shape[1] > 1:
            x[:, 0] = -thr
            t[:, 0] = _t(-thr)
        thrs.append(thr)
    got = tops.threshold_mask_group(ts, [_t(t) for t in thrs])
    assert len(got) == len(xs)
    for (q, r), x, t, thr in zip(got, xs, ts, thrs):
        single = tops.threshold_mask(t, _t(thr))
        want_ref = jref.threshold_mask_ref(jnp.asarray(x), jnp.asarray(thr))
        want_pal = jcmp.threshold_mask(jnp.asarray(x), jnp.asarray(thr),
                                       interpret=True)
        for j, out in enumerate((q, r)):
            assert tuple(out.shape) == x.shape
            _bits_equal(out.numpy(), single[j].numpy())
            _bits_equal(out.numpy(), want_ref[j])
            _bits_equal(out.numpy(), want_pal[j])


@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("levels", [1, 15])
def test_quantize_dequantize_group_plain_matches_reference(group, levels):
    """The plain QSGD group equals the per-leaf plain version and the
    reference's ``quantize_dequantize_ref`` bit for bit, and its Pallas
    kernel to PALLAS_TOL, with a zero-scale row and u = 1 - 2**-24 in
    every third column."""
    xs, ts = _group_leaves(group, 12)
    rng = np.random.default_rng(13)
    us, scales = [], []
    for x, t in zip(xs, ts):
        u = rng.random(size=x.shape, dtype=np.float32)
        u[:, ::3] = np.float32(1) - np.float32(2 ** -24)
        if x.shape[0] > 1:
            x[-1] = 0.0
            t[-1] = 0.0
        us.append(u)
        scales.append(np.abs(x).max(axis=1))
    got = tops.quantize_dequantize_group(ts, [_t(s) for s in scales],
                                         [_t(u) for u in us], levels=levels)
    for (q, r), x, t, u, scale in zip(got, xs, ts, us, scales):
        single = tops.quantize_dequantize(t, _t(scale), _t(u), levels=levels)
        want_ref = jref.quantize_dequantize_ref(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(u), levels=levels)
        want_pal = jcmp.quantize_dequantize(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(u),
            levels=levels, interpret=True)
        for j, out in enumerate((q, r)):
            assert np.isfinite(out.numpy()).all()
            _bits_equal(out.numpy(), single[j].numpy())
            _bits_equal(out.numpy(), want_ref[j])
            np.testing.assert_allclose(out.numpy(), np.asarray(want_pal[j]),
                                       **PALLAS_TOL)
        if x.shape[0] > 1:
            assert not q.numpy()[-1].any()


def _tile_cover(leaves, addrs, peel=tC.PEELS[0]):
    """Run the kernel's index arithmetic over every tile of
    ``compress.group_plan(leaves)``, with leaf i's x at byte address
    ``addrs[i]`` and vector rows peeled to ``peel`` bytes: how often each
    element of each leaf is written, and the byte address of every float4
    of the body."""
    hits = [np.zeros(rows * f, dtype=np.int64) for rows, f, _ in leaves]
    vec_addrs = []
    for entries, tiles in tC.group_plan(leaves):
        assert len(entries) <= tC.MAX_LEAVES
        first = [tile0 for _, tile0, _ in entries]
        assert first[0] == 0
        for tile in range(tiles):
            # the kernel's binary search: the last leaf whose first tile
            # is <= tile
            i, tile0, chunks = entries[int(np.searchsorted(first, tile,
                                                           "right")) - 1]
            rows, f, vec = leaves[i]
            row, chunk = divmod(tile - tile0, chunks)
            assert row < rows
            base = row * f
            if not vec:
                lo = chunk * tC.TILE
                hits[i][base + lo:base + min(lo + tC.TILE, f)] += 1
                continue
            head, body, tail = tC.row_split(addrs[i] + 4 * base, f, peel)
            if head < f:  # the body starts on a peel-byte boundary
                assert (addrs[i] + 4 * (base + head)) % peel == 0
            for j in range(chunk * tC.TILE_VECS,
                           min((chunk + 1) * tC.TILE_VECS, body)):
                start = base + head + 4 * j
                hits[i][start:start + 4] += 1
                vec_addrs.append(addrs[i] + 4 * start)
            if chunk == 0:
                hits[i][base:base + head] += 1
                hits[i][base + f - tail:base + f] += 1
    return hits, vec_addrs


PLAN_CASES = {
    "quickstart": ([(r, f, True) for r, f in QUICKSTART_LEAVES], 0),
    "odd": ([(1, 1, True), (3, 517, True), (5, 8193, True), (2, 3, True),
             (7, 4097, True)], 0),
    "large": ([(2, 2 ** 16 + 5, True), (3, 4096 * 3, True)], 0),
    "view4": ([(3, 517, True), (1, 2, True), (2, 4101, True)], 4),
    "view8": ([(3, 517, True), (2, 6, True)], 8),
    "view12": ([(4, 1027, True), (1, 1, True)], 12),
    "view68": ([(3, 517, True), (2, 40, True), (5, 30, True)], 68),
    # 16-byte aligned views off a 128-byte line: with fresh outputs, the
    # unaligned views that the wrapper runs on float4
    "view16": ([(3, 517, True), (16, 1280, True), (4, 2, True)], 16),
    "view80": ([(5, 8193, True), (16, 20, True)], 80),
    "scalar": ([(3, 517, False), (2, 9000, False), (16, 64, True)], 4),
}


@pytest.mark.parametrize("peel", tC.PEELS)
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_group_plan_covers_every_element_once(case, peel):
    """Every element of every leaf is written by exactly one tile, and
    every float4 of a row's body starts on a 16-byte boundary (the body on a
    ``peel``-byte one), with each leaf's streams at a 16-byte-aligned
    address plus the case's offset (the unaligned views of the ``view*``
    cases)."""
    leaves, offset = PLAN_CASES[case]
    addrs = [(1 << 24) * (i + 1) + offset for i in range(len(leaves))]
    hits, vec_addrs = _tile_cover(leaves, addrs, peel)
    for i, h in enumerate(hits):
        assert (h == 1).all(), (leaves[i], np.unique(h))
    assert all(a % 16 == 0 for a in vec_addrs)
    if any(vec for _, f, vec in leaves if f >= 8):
        assert vec_addrs, "no row reached the float4 body"


def test_row_split_peels_to_the_first_128_byte_boundary():
    assert tC.row_split(128, 517) == (0, 129, 1)
    assert tC.row_split(132, 517) == (31, 121, 2)
    assert tC.row_split(136, 517) == (30, 121, 3)
    assert tC.row_split(140, 517) == (29, 122, 0)
    assert tC.row_split(192, 517) == (16, 125, 1)
    assert tC.row_split(132, 2) == (2, 0, 0)      # all head
    assert tC.row_split(132, 33) == (31, 0, 2)    # no body
    assert tC.row_split(128, 3) == (0, 0, 3)      # all tail
    assert tC.TILE_VECS == 512 and tC.TILE == 2048
    assert tC.tiles_per_row(2048, True) == 1
    assert tC.tiles_per_row(2052, True) == 2
    assert tC.tiles_per_row(3, True) == 1
    assert tC.tiles_per_row(2049, False) == 2


def test_row_split_peels_to_16_bytes_on_request():
    assert tC.row_split(128, 517, 16) == (0, 129, 1)
    assert tC.row_split(132, 517, 16) == (3, 128, 2)
    assert tC.row_split(136, 517, 16) == (2, 128, 3)
    assert tC.row_split(140, 517, 16) == (1, 129, 0)
    assert tC.row_split(144, 517, 16) == (0, 129, 1)   # off a 128-byte line
    assert tC.row_split(132, 2, 16) == (2, 0, 0)       # all head
    assert tC.row_split(132, 6, 16) == (3, 0, 3)       # no body


@pytest.mark.parametrize("n_leaves", [1, tC.MAX_LEAVES, tC.MAX_LEAVES + 1,
                                      2 * tC.MAX_LEAVES + 5])
def test_group_longer_than_the_leaf_cap_splits(n_leaves):
    """ceil(n / MAX_LEAVES) launches, each of at most MAX_LEAVES leaves in
    order, with its own tile numbering from 0, covering each leaf once."""
    leaves = [(1 + i % 3, 5 + 7 * i, i % 4 != 0) for i in range(n_leaves)]
    plan = tC.group_plan(leaves)
    assert len(plan) == -(-n_leaves // tC.MAX_LEAVES)
    assert [i for entries, _ in plan for i, _, _ in entries] == \
        list(range(n_leaves))
    for entries, tiles in plan:
        want = 0
        for i, tile0, chunks in entries:
            assert tile0 == want
            want += leaves[i][0] * chunks
        assert tiles == want
    hits, _ = _tile_cover(leaves, [(1 << 24) * (i + 1) + 4 * (i % 4)
                                   for i in range(n_leaves)])
    assert all((h == 1).all() for h in hits)


def test_group_wrappers_refuse_before_building():
    """The CUDA group wrappers take CUDA tensors only, as many scalars (and
    noises) as leaves, and each leaf's shapes; all checked before any
    build (this machine has no nvcc)."""
    x2d = torch.randn(2, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tC.threshold_mask_group([x2d], [x2d[:, 0].contiguous()])
    with pytest.raises(ValueError, match="CUDA tensor"):
        tC.quantize_dequantize_group([x2d], [x2d[:, 0].contiguous()], [x2d],
                                     levels=15)
    with pytest.raises(ValueError, match="2 leaves, 1 thr"):
        tC.threshold_mask_group([x2d, x2d], [x2d[:, 0]])
    with pytest.raises(ValueError, match="1 leaves, 1 scale, 2 u"):
        tC.quantize_dequantize_group([x2d], [x2d[:, 0]], [x2d, x2d],
                                     levels=15)
    with pytest.raises(ValueError, match="u has shape"):
        tC.quantize_dequantize_group([x2d], [x2d[:, 0]], [x2d.reshape(4, 2)],
                                     levels=3)
    with pytest.raises(ValueError, match="peel must be one of"):
        tC.threshold_mask_group([x2d], [x2d[:, 0]], peel=32)
    assert tC.threshold_mask_group([], []) == []


def test_cpu_group_dispatch_launches_nothing():
    tops.reset_launch_counts()
    paths = dict(tC.ROW_PATHS)
    xs = [torch.randn(4, 25), torch.randn(4, 3)]
    got = tops.threshold_mask_group(xs, [x.abs().amax(dim=1) for x in xs])
    assert len(got) == 2
    tops.quantize_dequantize_group(xs, [x.abs().amax(dim=1) for x in xs],
                                   [torch.rand(x.shape) for x in xs],
                                   levels=15)
    assert tops.threshold_mask_group([], []) == []
    assert tops.launch_counts()["threshold_mask"] == 0
    assert tops.launch_counts()["quantize_dequantize"] == 0
    assert tC.ROW_PATHS == paths


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
    tops.choco_exchange([x2d], [x2d], torch.eye(4), gamma=0.3,
                        x_hats=[x2d], x_pres=[x2d], m_hats=[x2d], eta=eta,
                        refresh=one, mu=0.9)
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
                           "qg_local_step", "qg_buffer_update", "qg_step",
                           "gamma_correct", "threshold_mask",
                           "quantize_dequantize", "choco_exchange",
                           "flash_attention",
                           "paged_decode_attention", "paged_decode_merge",
                           "ssd_scan", "ssd_scan_passing",
                           "ssd_scan_outputs"}
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


def _matmul_tf32(a, b, eq, **_):
    """einsum ``eq`` with one TF32 product per fp32 product (both operands
    rounded to TF32, no lo terms)."""
    return torch.einsum(eq, _tf32_rna(a), _tf32_rna(b))


def _ssd_tf32(x, dt, a, b, c, d_skip, matmul=_matmul_3xtf32):
    """The SSD scan kernel's numerics on the CPU: its three passes over
    64-token chunks (``ref.ssd_chunk_states`` / ``_state_passing`` /
    ``_chunk_outputs``) with every product formed as the kernel forms it
    -- B^T (w x), C B^T, C S_in and (G o mask) x from TF32 products (bf16
    b, c and x exact in TF32, every weighted operand split) -- and the rest
    in fp32."""
    exact = x.dtype == torch.bfloat16
    bsz, s, h, p = x.shape
    xf, dtf, bf, cum = tref._ssd_blocks(x, dt, a, b)
    cf = tref._ssd_blocks(x, dt, a, c)[2]
    w_out = torch.exp(cum[:, :, -1:] - cum) * dtf
    ds = matmul(bf, w_out[..., None] * xf, "bcsn,bcshp->bchnp",
                exact_a=exact)
    s_in, fin = tref.ssd_state_passing(ds, torch.exp(cum[:, :, -1]))
    gram = matmul(cf, bf, "bctn,bcsn->bcts", exact_a=exact, exact_b=exact)
    causal = torch.tril(torch.ones(tref.SSD_BLOCK, tref.SSD_BLOCK,
                                   dtype=torch.bool))[:, :, None]
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    m = (gram[..., None] * torch.exp(torch.where(causal, dec, -torch.inf))
         * dtf[:, :, None])
    y = (matmul(cf, s_in, "bctn,bchnp->bcthp", exact_a=exact)
         * torch.exp(cum)[..., None])
    y = y + matmul(m, xf, "bctsh,bcshp->bcthp", exact_b=exact)
    y = y + xf * d_skip[None, None, None, :, None]
    return y.reshape(bsz, -1, h, p)[:, :s].to(x.dtype), fin


#: (B, S, H, P, N, dt scale, whether one TF32 product per fp32 product
#: would hold the fp32 tolerance): the reference's SSD_CASES
#: (tests/test_kernels.py:199) with S = 1 and 17, dt x 1e-2 and P 48; then
#: the widths of chip_smoke's SSD_PATH_CASES (P 128, 80 and 96 in several
#: column tiles, N 20 and 12 padded, a short last chunk)
SSD_EMU_CASES = [(1, 128, 2, 32, 16, 1.0, False), (2, 256, 3, 64, 32, 1.0,
                                                    False),
                 (1, 256, 1, 16, 128, 1.0, False),
                 (2, 512, 4, 32, 64, 1.0, False),
                 (1, 1, 2, 32, 16, 1.0, True), (1, 17, 2, 32, 16, 1.0, True),
                 (2, 512, 4, 32, 64, 1e-2, True),
                 (1, 256, 2, 48, 64, 1e-2, True),
                 (1, 256, 2, 128, 64, 1.0, False),
                 (2, 256, 3, 80, 64, 1.0, False),
                 (1, 136, 3, 32, 20, 1.0, False),
                 (2, 192, 3, 96, 12, 1.0, False)]
#: the scan kernel's tolerance against the sequential plain version: the
#: reference's own between its kernel and its oracle (tests/
#: test_kernels.py:221) in fp32; one bf16 ulp at |y| in [2, 4) in bf16
SSD_TOL = {"float32": (5e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}


def _ssd_excess(got, want, dtype):
    """max(|got - want| - rtol |want|) - atol over y and the final state
    (<= 0 holds the tolerance)."""
    atol, rtol = SSD_TOL[dtype]
    return max(float(((g.float() - w.float()).abs()
                      - rtol * w.float().abs()).max()) - atol
               for g, w in zip(got, want))


@pytest.mark.parametrize("case", SSD_EMU_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_3xtf32_emulation_holds_scan_tol(case, dtype):
    """The tensor-core scan kernel's numeric design (3xTF32 products inside
    the chunk passes) holds the scan tolerance against the sequential plain
    version, in y and the final state; and whether plain TF32 would (it
    breaks the fp32 tolerance wherever a chunk sums 64 tokens at dt of
    order 1)."""
    b, s, h, p, n, dt_scale, tf32_holds = case
    rng = np.random.default_rng(sum(case[:5]))
    f32 = lambda v: torch.from_numpy(np.asarray(v, np.float32))
    x = f32(rng.normal(size=(b, s, h, p)) * 0.5)
    dt = f32(np.logaddexp(rng.normal(size=(b, s, h)), 0.0) * dt_scale)
    a = f32(-np.exp(rng.normal(size=h) * 0.3))
    bm, cm = (f32(rng.normal(size=(b, s, n)) * 0.3) for _ in range(2))
    d = f32(1.0 + 0.5 * rng.normal(size=h))
    cast = getattr(torch, dtype)
    x, bm, cm = (t.to(cast) for t in (x, bm, cm))
    want = tref.ssd_scan(x, dt, a, bm, cm, d)
    got = _ssd_tf32(x, dt, a, bm, cm, d)
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    assert _ssd_excess(got, want, dtype) <= 0
    if dtype == "float32":
        coarse = _ssd_tf32(x, dt, a, bm, cm, d, matmul=_matmul_tf32)
        assert (_ssd_excess(coarse, want, dtype) <= 0) == tf32_holds


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
