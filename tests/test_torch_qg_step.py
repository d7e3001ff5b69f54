"""The port's ``qg_step`` on the CPU: the dense-gossip optimizer step of one
launch (``kernels/qg_update.py``, ``csrc/qg_update.cu``).

* Its plain version ``ref.qg_step`` against the JAX package's composition
  of the same step: ``repro.kernels.qg_update.fused_halfstep`` (Pallas,
  interpret mode), ``repro.core.gossip.mix_dense``, then
  ``fused_qg_buffer`` (interpret), on the same numpy inputs.  Tolerance:
  rtol 1e-6 / atol 1e-7 on x_new and DSGDm's m_new (the interpret-mode
  kernels may contract a*b + c into one FMA, and XLA's product sums in
  another order than torch's: about one ulp of values of order 1); on the
  QG m_hat the same bound scaled by (1 - mu) / eta, the factor by which
  the refresh magnifies an error in x_new.
* ``qg_step_plan``: every column of every leaf in exactly one tile of
  ``STEP_COLS`` columns, 48 leaves a launch, the float4 and scalar paths
  marked.
* The dispatcher: chains on the dense mix with at most 64 nodes take
  ``ops.qg_step``; every other mix hook, more nodes and ``fused='off'``
  keep the two-kernel path (a recording stub counts the calls).
* The wrapper refuses CPU tensors, more than 64 nodes, a W of another
  shape, non-fp32 operands and mixed devices before it builds anything.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as jgossip
from repro.kernels import qg_update as jqg
from repro_torch.comm import choco as tchoco
from repro_torch.core import gossip as tgossip
from repro_torch.core import optim as toptim
from repro_torch.core import topology as ttopo
from repro_torch.core import transforms as tT
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qg_update as tK
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-6, atol=1e-7)
ETA, BETA, MU = 0.1, 0.9, 0.9
#: leaf widths: the float4 widths of the quickstart MLP's biases, an odd
#: width, one narrower than a tile and one over several tiles
WIDTHS = [(64,), (20,), (7,), (3, 67)]


def _tree(n, seed):
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=(n, *w)).astype(np.float32) for w in WIDTHS]
            for _ in range(3)]


def _mixing(n):
    """A dense doubly-stochastic W (every node talks to every node), so
    that each output is a sum of n products."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.5, size=(n, n))
    for _ in range(50):  # Sinkhorn: rows and columns sum to 1
        a /= a.sum(1, keepdims=True)
        a /= a.sum(0, keepdims=True)
    return a.astype(np.float32)


def _jax_step(xs, ms, gs, w, *, wd, nesterov, mu, refresh):
    eta = jnp.float32(ETA)
    halves, m_news = [], []
    for x, m, g in zip(xs, ms, gs):
        half, mn = jqg.fused_halfstep(jnp.asarray(x), jnp.asarray(m),
                                      jnp.asarray(g), eta, beta=BETA, wd=wd,
                                      nesterov=nesterov, emit_m=True,
                                      interpret=True)
        halves.append(half)
        m_news.append(mn)
    mixed = jgossip.mix_dense(jnp.asarray(w),
                              {f"l{i}": h for i, h in enumerate(halves)})
    x_new = [mixed[f"l{i}"] for i in range(len(xs))]
    if mu is None:
        return x_new, m_news
    return x_new, [jqg.fused_qg_buffer(jnp.asarray(x), xn, jnp.asarray(m),
                                       eta, jnp.float32(refresh), mu=mu,
                                       interpret=True)
                   for x, xn, m in zip(xs, x_new, ms)]


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("form", ["qg_refresh1", "qg_refresh0", "dsgdm"])
@pytest.mark.parametrize("wd,nesterov", [(0.0, False), (1e-4, True)])
def test_plain_step_matches_reference_composition(n, form, wd, nesterov):
    xs, ms, gs = _tree(n, seed=n)
    w = _mixing(n)
    mu = None if form == "dsgdm" else MU
    refresh = 0.0 if form == "qg_refresh0" else 1.0
    got_x, got_m = tops.qg_step(
        [torch.from_numpy(a) for a in xs], [torch.from_numpy(a) for a in ms],
        [torch.from_numpy(a) for a in gs], torch.from_numpy(w),
        torch.tensor([ETA]), torch.tensor([refresh]), beta=BETA, wd=wd,
        nesterov=nesterov, mu=mu)
    want_x, want_m = _jax_step(xs, ms, gs, w, wd=wd, nesterov=nesterov,
                               mu=mu, refresh=refresh)
    for i, (gx, wx) in enumerate(zip(got_x, want_x)):
        assert gx.shape == xs[i].shape and gx.dtype == torch.float32
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), **TOL,
                                   err_msg=f"x_new leaf {i}")
    scale = 1.0 if mu is None else (1.0 - mu) / ETA
    for i, (gm, wm) in enumerate(zip(got_m, want_m)):
        np.testing.assert_allclose(
            gm.numpy(), np.asarray(wm), rtol=TOL["rtol"],
            atol=scale * TOL["atol"] + scale * TOL["rtol"]
            * float(np.abs(np.asarray(want_x[i])).max()),
            err_msg=f"m_out leaf {i}")
    if form == "qg_refresh0":  # the gate off carries m_hat through
        for gm, m in zip(got_m, ms):
            np.testing.assert_array_equal(gm.numpy(), m)


def test_plain_step_is_the_stages_composition_bit_for_bit():
    """``ref.qg_step`` is exactly ``ref.fused_halfstep``, the product of
    ``gossip.mix_leaf_dense`` and ``ref.fused_qg_buffer``."""
    xs, ms, gs = ([torch.from_numpy(a) for a in t] for t in _tree(16, 3))
    w = torch.from_numpy(_mixing(16))
    eta, one = torch.tensor([ETA]), torch.tensor([1.0])
    x_new, m_new = tref.qg_step(xs, ms, gs, w, eta, one, beta=BETA,
                                wd=1e-4, nesterov=True, mu=MU)
    for x, m, g, xn, mn in zip(xs, ms, gs, x_new, m_new):
        half, _ = tref.fused_halfstep(x, m, g, eta, beta=BETA, wd=1e-4,
                                      nesterov=True)
        mixed = tgossip.mix_leaf_dense(w, half)
        assert torch.equal(xn, mixed)
        assert torch.equal(mn, tref.fused_qg_buffer(x, mixed, m, eta, one,
                                                    mu=MU))


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def _leaf_of(entries, t):
    """The kernel's binary search: the last entry whose first tile <= t."""
    lo, hi = 0, len(entries) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if entries[mid][1] <= t:
            lo = mid
        else:
            hi = mid - 1
    return entries[lo]


@pytest.mark.parametrize("addrs", [[0, 16, 32, 48, 64],
                                   [0, 16, 36, 48, 64]])
@pytest.mark.parametrize("widths", [
    [64, 20, 12288, 1280],                 # the quickstart MLP's leaves
    [1, 63, 64, 65, 1001, 128, 4],
    [3] * 49,                              # two launches: 48 + 1
    [64 * 5 + 2] * 100 + [7],              # three launches
    [2 ** 16 + 5, 20],                     # more tiles than an H100 holds
])
def test_plan_covers_every_column_once(widths, addrs):
    cols = tK.STEP_COLS
    leaves = [(f, addrs) for f in widths]
    plan = tK.qg_step_plan(leaves)
    assert len(plan) == -(-len(widths) // tK.MAX_LEAVES)
    seen = [np.zeros(f, dtype=np.int64) for f in widths]
    launched = []
    for entries, tiles in plan:
        assert 1 <= len(entries) <= tK.MAX_LEAVES
        launched += [e[0] for e in entries]
        assert [e[2] for e in entries] == [tK.step_vec(widths[e[0]], addrs)
                                           for e in entries]
        for t in range(tiles):
            i, tile0, _ = _leaf_of(entries, t)
            j0 = (t - tile0) * cols
            assert 0 <= j0 < widths[i]
            seen[i][j0:j0 + cols] += 1
    assert launched == list(range(len(widths)))
    for i, s in enumerate(seen):
        assert (s == 1).all(), f"leaf {i}: columns covered {set(s)} times"


def test_plan_tiles_are_step_cols_wide():
    aligned = [0, 16, 32, 48, 64]
    # the quickstart MLP's tree: 214 tiles, one launch, a block an SM
    quick = [(f, aligned) for f in (64, 20, 12288, 1280)]
    assert [p[1] for p in tK.qg_step_plan(quick)] == [214]
    assert [e[1] for e in tK.qg_step_plan(quick)[0][0]] == [0, 1, 2, 194]
    big = [(2 ** 23 + 5, aligned)]
    assert tK.qg_step_plan(big)[0][1] == 131073
    assert tK.STEP_COLS == 64


def test_plan_marks_the_float4_and_scalar_paths():
    aligned = [1024, 2048, 4096, 8192, 16384]
    leaves = [(64, aligned), (1001, aligned), (64, [1028] + aligned[1:]),
              (64, aligned[:4] + [16388]), (20, aligned), (2, aligned)]
    (entries, tiles), = tK.qg_step_plan(leaves)
    assert [e[2] for e in entries] == [True, False, False, False, True,
                                       False]
    assert [e[1] for e in entries] == [0, 1, 17, 18, 19, 20]
    assert tiles == 21


def test_outputs_are_views_of_one_buffer_each_on_16_bytes():
    shapes = [torch.Size(s) for s in [(4, 5), (4, 3), (4, 1), (4, 8)]]
    views = tK._views(shapes, "cpu")
    base = views[0].untyped_storage().data_ptr()
    for v, s in zip(views, shapes):
        assert v.shape == s and v.is_contiguous()
        assert v.untyped_storage().data_ptr() == base
        assert v.data_ptr() % 16 == 0


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

@pytest.fixture
def recorded(monkeypatch):
    """Record which kernel entry points a chain step calls (by name),
    delegating to the real ones."""
    calls = []
    for name in ("qg_step", "fused_halfstep", "fused_qg_buffer"):
        real = getattr(tops, name)

        def stub(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(tops, name, stub)
    return calls


def _step(method, n, *, fused="kernel", mix_fn=None):
    rng = np.random.default_rng(7)
    params = {"w": torch.from_numpy(rng.normal(size=(n, 6, 5))
                                    .astype(np.float32)),
              "b": torch.from_numpy(rng.normal(size=(n, 5))
                                    .astype(np.float32))}
    kw = {} if mix_fn is None else {"mix_fn": mix_fn}
    opt = toptim.make_optimizer(method, lr=0.1, weight_decay=1e-4,
                                fused=fused, **kw)
    w = torch.from_numpy(ttopo.ring(n).mixing[0]).float()
    return opt.step(params, params, opt.init(params), w=w, t=3)


def _other_mix(w, tree):
    return tgossip.mix_dense(w, tree)


@pytest.mark.parametrize("method,want", [
    ("qg_dsgdm_n", ["qg_step"]), ("dsgdm_n", ["qg_step"]),
    ("qg_dsgdm_tau", ["qg_step"]), ("qg_dsgdm", ["qg_step"]),
    ("dsgdm", ["qg_step"]), ("dsgd", [])])
def test_dense_chains_take_the_step_kernel(recorded, method, want):
    _step(method, 16)
    assert recorded == want


@pytest.mark.parametrize("method,want", [
    ("qg_dsgdm_n", ["fused_halfstep", "fused_qg_buffer"]),
    ("dsgdm_n", ["fused_halfstep"]),
    ("qg_dsgdm_tau", ["fused_halfstep", "fused_qg_buffer"])])
@pytest.mark.parametrize("why", ["other_mix_fn", "n_65"])
def test_other_chains_keep_the_two_kernel_path(recorded, method, want, why):
    if why == "other_mix_fn":
        _step(method, 16, mix_fn=_other_mix)
    else:
        _step(method, tK.STEP_MAX_NODES + 1)
    assert recorded == want


@pytest.mark.parametrize("method", ["qg_dsgdm_n", "dsgdm_n", "qg_dsgdm_tau"])
def test_unfused_chains_launch_nothing(recorded, method):
    _step(method, 16, fused="off")
    assert recorded == []


def test_step_kernel_and_two_kernel_path_agree_bit_for_bit_on_cpu():
    for method in ("qg_dsgdm_n", "dsgdm_n", "qg_dsgdm_tau"):
        p_step, s_step = _step(method, 16)
        p_two, s_two = _step(method, 16, mix_fn=_other_mix)
        for k in p_step:
            assert torch.equal(p_step[k], p_two[k])
        assert s_step.keys() == s_two.keys()
        for name in s_step:
            for role in s_step[name]:
                for k in s_step[name][role]:
                    assert torch.equal(s_step[name][role][k],
                                       s_two[name][role][k])


def test_warm_start_capture_keeps_the_two_kernel_path(recorded):
    """CHOCO's warm start runs the chain with its own capturing mix hook."""
    n = 16
    opt = toptim.make_optimizer("qg_dsgdm_n", lr=0.1, fused="kernel")
    params = {"w": torch.zeros(n, 3, 2)}
    w = torch.from_numpy(ttopo.ring(n).mixing[0]).float()
    targets = tchoco.capture_mix_targets(opt, params, w)
    assert len(targets) == 1
    assert recorded == ["fused_halfstep", "fused_qg_buffer"]
    recorded.clear()
    assert tchoco.count_mix_sites(opt, params, w) == 1
    assert recorded == []


def test_match_step_decides_from_the_chain_and_n():
    mix = tgossip.mix_dense
    qg = toptim.make_optimizer("qg_dsgdm_n", weight_decay=1e-4)._stages()
    ds = toptim.make_optimizer("dsgdm_n")._stages()
    wd, hb, buf, used = tT._match_step(qg, 0, mix, 64)
    assert (wd, hb.name, buf.name, used) == (1e-4, "heavyball", "qg_buffer",
                                             4)
    wd, hb, buf, used = tT._match_step(ds, 0, mix, 16)
    assert (wd, hb.name, buf, used) == (0.0, "heavyball", None, 3)
    assert tT._match_step(ds, 1, mix, 16)[3] == 2   # no weight_decay stage
    assert tT._match_step(qg, 0, mix, 65) is None
    assert tT._match_step(qg, 0, _other_mix, 16) is None
    # a seeded heavyball whose qg_buffer is not its seed, a stateful one
    # followed by a qg_buffer, a seeded one with no buffer after it
    hb_seeded = tT.heavyball(0.9, seed_from="other")
    hb_local = tT.heavyball(0.9)
    for chain in [(hb_seeded, tT.gossip_mix(), tT.qg_buffer(0.9)),
                  (hb_local, tT.gossip_mix(), tT.qg_buffer(0.9)),
                  (tT.heavyball(0.9, seed_from="qg_buffer"),
                   tT.gossip_mix())]:
        assert tT._match_step(chain, 0, mix, 16) is None


# ---------------------------------------------------------------------------
# the wrapper's refusals
# ---------------------------------------------------------------------------

def _operands(n=4, f=8, dtype=torch.float32, device="cpu"):
    x = torch.zeros(n, f, dtype=dtype, device=device)
    return ([x], [x.clone()], [x.clone()], torch.eye(n, device=device),
            torch.tensor([0.1], device=device),
            torch.tensor([1.0], device=device))


@pytest.mark.parametrize("case,exc,match", [
    ("cpu", ValueError, "CUDA tensor"),
    ("nodes", ValueError, "1 to 64 nodes"),
    ("w_shape", ValueError, r"w must be \[4, 4\]"),
    ("bf16", TypeError, "float32"),
    ("mixed", ValueError, "several devices"),
    ("no_refresh", ValueError, "needs refresh"),
    ("leaf_shape", ValueError, "one shape with 4 nodes"),
])
def test_wrapper_refuses_before_building(case, exc, match):
    xs, ms, gs, w, eta, refresh = _operands(
        n=tK.STEP_MAX_NODES + 1 if case == "nodes" else 4)
    if case == "w_shape":
        w = torch.eye(5)
    elif case == "bf16":
        gs = [gs[0].to(torch.bfloat16)]
    elif case == "mixed":
        gs = [torch.zeros(4, 8, device="meta")]
    elif case == "no_refresh":
        refresh = None
    elif case == "leaf_shape":
        gs = [torch.zeros(4, 9)]
    with pytest.raises(exc, match=match):
        tK.qg_step(xs, ms, gs, w, eta, refresh, beta=0.9, mu=0.9)
    assert tK._lib.cache_info().currsize == 0  # nothing was built


def test_ops_routes_cpu_tensors_to_the_plain_version():
    tops.reset_launch_counts()
    xs, ms, gs, w, eta, refresh = _operands()
    got = tops.qg_step(xs, ms, gs, w, eta, refresh, beta=0.9, mu=0.9)
    want = tref.qg_step(xs, ms, gs, w, eta, refresh, beta=0.9, mu=0.9)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert tops.launch_counts()["qg_step"] == 0
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        tops.qg_step(xs, ms, gs, w.to("meta"), eta, refresh, beta=0.9,
                     mu=0.9)

