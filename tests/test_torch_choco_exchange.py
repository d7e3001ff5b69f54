"""The port's ``choco_exchange`` on the CPU: the exchange half of a
compressed gossip round and the QG refresh after it in one launch
(``kernels/compress.py``, ``csrc/compress.cu``).

* Its plain version ``ref.choco_exchange`` against the JAX package's
  composition of the same round on the same numpy inputs: the replica
  advance, ``repro.core.gossip.mix_dense``, ``CompressedGossip._decompress``
  with the kernel backend (``gamma_correct`` in Pallas interpret mode), then
  ``repro.kernels.qg_update.fused_qg_buffer`` (interpret).  Tolerance: rtol
  1e-6 / atol 1e-7 on x_out (XLA's product sums in another order than
  torch's, and the interpret-mode kernels may contract a*b + c into one
  FMA: about one ulp of values of order 1); on the QG m_hat the same bound
  scaled by (1 - mu) / eta, the factor by which the refresh magnifies an
  error in x_out; the new replicas (one addition) equal.
* ``CompressedMix``: ``exchange`` is the call split in two, bit for bit,
  and ``compress`` takes a site as a call does.
* ``exchange_plan``: the kernel's leaf table, every column of every leaf in
  exactly one tile, 48 leaves a launch, the float4 and scalar paths marked.
* The dispatcher: compressed rounds on the dense mix with the kernel
  compressors and at most 64 nodes take ``ops.choco_exchange``; the 'jnp'
  backend, another ``mix_impl``, 65 nodes and the warm-start capture keep
  the two-kernel path; on the CPU the two agree bit for bit over trainer
  steps of both compressed presets; a segment that cannot take the kernel
  raises off the CPU.
* The wrapper refuses CPU tensors, more than 64 nodes, a W of another
  shape, non-fp32 operands, mixed devices and malformed role lists before
  it builds anything.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import choco as jchoco
from repro.core import gossip as jgossip
from repro.kernels import qg_update as jqg
from repro_torch import api as tapi
from repro_torch.comm import choco as tchoco
from repro_torch.core import gossip as tgossip
from repro_torch.core import optim as toptim
from repro_torch.core import topology as ttopo
from repro_torch.core import transforms as tT
from repro_torch.kernels import compress as tC
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qg_update as tK
from repro_torch.kernels import ref as tref
from repro_torch.train import run_training_scanned
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-6, atol=1e-7)
ETA, MU = 0.1, 0.9
#: the gammas of the presets' rounds: top-k's resolved one and EF's
GAMMA = {"choco": 0.02002, "ef": 0.3}
#: leaf widths: the float4 widths of the quickstart MLP's biases, an odd
#: width, one narrower than a tile and one over several tiles
WIDTHS = [(64,), (20,), (7,), (3, 67)]
ROLES = ("half", "q", "x_hat", "x_pre", "m_hat")
FORMS = {"qg_refresh1": (MU, 1.0), "qg_refresh0": (MU, 0.0),
         "dsgdm": (None, 1.0)}


def _roles(n, seed):
    rng = np.random.default_rng(seed)
    return {r: [rng.normal(size=(n, *w)).astype(np.float32) for w in WIDTHS]
            for r in ROLES}


def _mixing(n):
    """A dense doubly-stochastic W (every node talks to every node), so
    that each output is a sum of n products."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.5, size=(n, n))
    for _ in range(50):  # Sinkhorn: rows and columns sum to 1
        a /= a.sum(1, keepdims=True)
        a /= a.sum(0, keepdims=True)
    return a.astype(np.float32)


def _exchange_kw(r, mode, form, gamma):
    """``choco_exchange``'s keywords from the role lists ``r``."""
    mu, refresh = FORMS[form]
    kw = dict(gamma=gamma, x_hats=r["x_hat"] if mode == "choco" else None)
    if mu is not None:
        kw.update(x_pres=r["x_pre"], m_hats=r["m_hat"],
                  eta=torch.tensor([ETA]), refresh=torch.tensor([refresh]),
                  mu=mu)
    return kw


def _tree(leaves):
    return {f"l{i}": leaf for i, leaf in enumerate(leaves)}


def _jax_exchange(r, w, mode, form, gamma):
    """The reference's composition: anchors, ``mix_dense``, the kernel
    backend's ``_decompress`` and ``fused_qg_buffer``."""
    jcg = jchoco.make_comm("topk:0.1", error_feedback=mode == "ef",
                           backend="pallas")
    q = _tree([jnp.asarray(a) for a in r["q"]])
    anchor = q if mode == "ef" else _tree(
        [jnp.asarray(h) + q[f"l{i}"] for i, h in enumerate(r["x_hat"])])
    half = _tree([jnp.asarray(a) for a in r["half"]])
    out = jcg._decompress(half, jgossip.mix_dense(jnp.asarray(w), anchor),
                          anchor, gamma)
    x_out = [out[f"l{i}"] for i in range(len(WIDTHS))]
    mu, refresh = FORMS[form]
    m_out = None if mu is None else [
        jqg.fused_qg_buffer(jnp.asarray(x), xo, jnp.asarray(m),
                            jnp.float32(ETA), jnp.float32(refresh), mu=mu,
                            interpret=True)
        for x, xo, m in zip(r["x_pre"], x_out, r["m_hat"])]
    return x_out, [anchor[f"l{i}"] for i in range(len(WIDTHS))], m_out


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("mode", ["choco", "ef"])
@pytest.mark.parametrize("form", list(FORMS))
def test_plain_exchange_matches_reference_composition(n, mode, form):
    r = _roles(n, seed=n)
    w = _mixing(n)
    t = {k: [torch.from_numpy(a) for a in v] for k, v in r.items()}
    got_x, got_h, got_m = tops.choco_exchange(
        t["half"], t["q"], torch.from_numpy(w),
        **_exchange_kw(t, mode, form, GAMMA[mode]))
    want_x, want_h, want_m = _jax_exchange(r, w, mode, form, GAMMA[mode])
    for i, (gx, wx) in enumerate(zip(got_x, want_x)):
        assert gx.shape == r["half"][i].shape and gx.dtype == torch.float32
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), **TOL,
                                   err_msg=f"x_out leaf {i}")
    if mode == "ef":
        assert got_h is None
    else:
        for gh, wh in zip(got_h, want_h):
            np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    mu, refresh = FORMS[form]
    if mu is None:
        assert got_m is None
        return
    scale = (1.0 - mu) / ETA
    for i, (gm, wm) in enumerate(zip(got_m, want_m)):
        np.testing.assert_allclose(
            gm.numpy(), np.asarray(wm), rtol=TOL["rtol"],
            atol=scale * TOL["atol"] + scale * TOL["rtol"]
            * float(np.abs(np.asarray(want_x[i])).max()),
            err_msg=f"m_out leaf {i}")
    if refresh == 0.0:  # the gate off carries m_hat through
        for gm, m in zip(got_m, r["m_hat"]):
            np.testing.assert_array_equal(gm.numpy(), m)


# ---------------------------------------------------------------------------
# CompressedMix: the round, whole and split
# ---------------------------------------------------------------------------

def _site_trees(n=16, seed=5):
    rng = np.random.default_rng(seed)
    return [{"b": torch.from_numpy(rng.normal(size=(n, 7)).astype(np.float32)),
             "w": torch.from_numpy(rng.normal(size=(n, 3, 9))
                                   .astype(np.float32))}
            for _ in range(4)]


def _hook(mode, site_tree, **kw):
    comm = tchoco.make_comm("topk:0.2", error_feedback=mode == "ef",
                            backend="pallas")
    sites_in = [comm.init_site(site_tree)]
    return comm.make_mix_fn(sites_in, list(sites_in), None, GAMMA[mode],
                            **kw)


@pytest.mark.parametrize("mode", ["choco", "ef"])
@pytest.mark.parametrize("qg", [True, False])
def test_exchange_is_the_call_split_in_two_bit_for_bit(mode, qg):
    """``exchange`` (compress half, then ``ops.choco_exchange``) gives the
    call's output and site, and then the refresh ``fused_qg_buffer`` would
    give, to the bit."""
    half, site, x_pre, m_hat = _site_trees()
    w = torch.from_numpy(ttopo.ring(16).mixing[0]).float()
    eta, one = torch.tensor([ETA]), torch.tensor([1.0])
    whole, split = _hook(mode, site), _hook(mode, site)
    want = whole(w, half)
    kw = dict(x_pre=x_pre, m_hat=m_hat, eta=eta, refresh=one, mu=MU) \
        if qg else {}
    got, m_new = split.exchange(w, half, **kw)
    for k in half:
        assert torch.equal(got[k], want[k])
        if qg:
            assert torch.equal(m_new[k], tref.fused_qg_buffer(
                x_pre[k], want[k], m_hat[k], eta, one, mu=MU))
    assert (m_new is None) == (not qg)
    assert split.sites_out[0].keys() == whole.sites_out[0].keys()
    for role in whole.sites_out[0]:
        for k in half:
            assert torch.equal(split.sites_out[0][role][k],
                               whole.sites_out[0][role][k])


@pytest.mark.parametrize("mode", ["choco", "ef"])
def test_compress_takes_the_site_as_a_call_would(mode):
    half, site, _, _ = _site_trees()
    mix = _hook(mode, site)
    i, q = mix.compress(half)
    assert i == 0 and q.keys() == half.keys()
    # EF's new residual is known once compressed; CHOCO's replicas advance
    # in the exchange
    assert (mix.sites_out[0] is not mix.sites_in[0]) == (mode == "ef")
    w = torch.from_numpy(ttopo.ring(16).mixing[0]).float()
    with pytest.raises(RuntimeError, match="2 mix calls but comm state has 1"):
        mix(w, half)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def _leaf_of(rows, t):
    """The kernel's binary search: the last row whose first tile <= t."""
    lo, hi = 0, len(rows) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if rows[mid][7] <= t:
            lo = mid
        else:
            hi = mid - 1
    return rows[lo]


@pytest.mark.parametrize("ins", [[0, 16, 32, 48, 64], [0, 16, 36, 0, 64]])
@pytest.mark.parametrize("widths", [
    [64, 20, 12288, 1280],                 # the quickstart MLP's leaves
    [1, 63, 64, 65, 1001, 128, 4],
    [3] * 49,                              # two launches: 48 + 1
    [64 * 5 + 2] * 100 + [7],              # three launches
    [2 ** 16 + 5, 20],                     # more tiles than an H100 holds
])
def test_exchange_plan_covers_every_column_once(widths, ins):
    ins = [a + 1024 for a in ins]
    outs = np.cumsum([0] + [-(-16 * f // 4) * 4 for f in widths])
    leaves = [(f, ins, int(o)) for f, o in zip(widths, outs)]
    plan = tC.exchange_plan(leaves)
    assert len(plan) == -(-len(widths) // tC.MAX_LEAVES)
    seen = [np.zeros(f, dtype=np.int64) for f in widths]
    start = 0
    for rows, tiles in plan:
        assert 1 <= len(rows) <= tC.MAX_LEAVES
        for k, row in enumerate(rows):
            f, _, out = leaves[start + k]
            assert len(row) == tC.EXCHANGE_FIELDS
            assert row[:7] == [*ins, out, f]
            assert row[8] == tK.step_vec(f, [a for a in ins if a] + [4 * out])
        for t in range(tiles):
            row = _leaf_of(rows, t)
            j0 = (t - row[7]) * tC.STEP_COLS
            assert 0 <= j0 < row[6]
            seen[start + rows.index(row)][j0:j0 + tC.STEP_COLS] += 1
        start += len(rows)
    assert start == len(widths)
    for k, s in enumerate(seen):
        assert (s == 1).all(), f"leaf {k}: columns covered {set(s)} times"


def test_exchange_plan_marks_the_float4_and_scalar_paths():
    aligned = [1024, 2048, 4096, 8192, 16384]
    leaves = [(64, aligned, 0), (1001, aligned, 64),
              (64, [1028] + aligned[1:], 1068),
              (64, aligned[:3] + [0, 0], 1132),       # DSGDm: 2 roles unread
              (64, [1024, 0, 2048, 4100, 8192], 1196),  # EF, x_pre off 16 B
              (20, aligned, 1258),                     # out off 16 bytes
              (8, aligned, 1280)]
    (rows, tiles), = tC.exchange_plan(leaves)
    assert [r[8] for r in rows] == [1, 0, 0, 1, 0, 0, 1]
    assert [r[7] for r in rows] == [0, 1, 17, 18, 19, 20, 21]
    assert tiles == 22


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

@pytest.fixture
def recorded(monkeypatch):
    """Record which kernel entry points a chain step calls (by name),
    delegating to the real ones."""
    calls = []
    for name in ("choco_exchange", "qg_step", "fused_halfstep",
                 "fused_qg_buffer", "gamma_correct"):
        real = getattr(tops, name)

        def stub(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(tops, name, stub)
    return calls


def _params(n, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(7)
    return {"w": torch.from_numpy(rng.normal(size=(n, 6, 5))).to(
                dtype=dtype, device=device),
            "b": torch.from_numpy(rng.normal(size=(n, 5))).to(
                dtype=dtype, device=device)}


def _step(method, n, *, mode="choco", backend="pallas", mix_impl=None,
          dtype=torch.float32, device="cpu"):
    params = _params(n, dtype, device)
    opt = toptim.make_optimizer(method, lr=0.1, weight_decay=1e-4,
                                fused="kernel")
    w = torch.from_numpy(ttopo.ring(n).mixing[0]).float().to(device)
    comm = tchoco.make_comm("topk:0.2", error_feedback=mode == "ef",
                            backend=backend)
    sites = [comm.init_site(params)]
    hook = comm.make_mix_fn(sites, list(sites), None, GAMMA[mode],
                            mix_impl=mix_impl)
    opt = dataclasses.replace(opt, mix_fn=hook)
    return opt.step(params, params, opt.init(params), w=w, t=3), hook


@pytest.mark.parametrize("method", ["qg_dsgdm_n", "dsgdm_n", "qg_dsgdm_tau"])
@pytest.mark.parametrize("mode", ["choco", "ef"])
def test_compressed_chains_take_the_exchange_kernel(recorded, method, mode):
    _step(method, 16, mode=mode)
    assert recorded == ["fused_halfstep", "choco_exchange"]


def _other_mix(w, tree):
    return tgossip.mix_dense(w, tree)


@pytest.mark.parametrize("why,want", [
    ("backend_jnp", ["fused_halfstep", "fused_qg_buffer"]),
    ("other_mix_impl", ["fused_halfstep", "gamma_correct",
                        "fused_qg_buffer"]),
    ("n_65", ["fused_halfstep", "gamma_correct", "fused_qg_buffer"]),
    ("capture", ["fused_halfstep", "fused_qg_buffer"])])
def test_other_rounds_keep_the_two_kernel_path(recorded, why, want):
    if why == "backend_jnp":
        _step("qg_dsgdm_n", 16, backend="jnp")
    elif why == "other_mix_impl":
        _step("qg_dsgdm_n", 16, mix_impl=_other_mix)
    elif why == "n_65":
        _step("qg_dsgdm_n", tK.STEP_MAX_NODES + 1)
    else:  # CHOCO's warm start runs the chain with its own capturing hook
        opt = toptim.make_optimizer("qg_dsgdm_n", lr=0.1, fused="kernel")
        w = torch.from_numpy(ttopo.ring(16).mixing[0]).float()
        comm = tchoco.make_comm("topk:0.2", backend="pallas")
        assert len(comm.init_state(opt, _params(16), w)) == 1
    assert recorded == want


def test_mix_dense_itself_as_mix_impl_takes_the_exchange_kernel(recorded):
    _step("qg_dsgdm_n", 16, mix_impl=tgossip.mix_dense)
    assert recorded == ["fused_halfstep", "choco_exchange"]


def test_match_exchange_decides_from_the_chain_hook_backend_and_n():
    qg = toptim.make_optimizer("qg_dsgdm_n", weight_decay=1e-4)._stages()
    ds = toptim.make_optimizer("dsgdm_n")._stages()
    comm = tchoco.make_comm("topk:0.2", backend="pallas")
    hook = comm.make_mix_fn([], [], None, 0.5)
    wd, hb, buf, used = tT._match_exchange(qg, 0, hook, 64)
    assert (wd, hb.name, buf.name, used) == (1e-4, "heavyball", "qg_buffer",
                                             4)
    wd, hb, buf, used = tT._match_exchange(ds, 0, hook, 16)
    assert (wd, hb.name, buf, used) == (0.0, "heavyball", None, 3)
    assert tT._match_exchange(qg, 0, hook, 65) is None
    assert tT._match_exchange(qg, 0, tgossip.mix_dense, 16) is None
    assert tT._match_exchange(qg, 0, _other_mix, 16) is None
    jnp_hook = tchoco.make_comm("topk:0.2").make_mix_fn([], [], None, 0.5)
    assert tT._match_exchange(qg, 0, jnp_hook, 16) is None
    other = comm.make_mix_fn([], [], None, 0.5, mix_impl=_other_mix)
    assert tT._match_exchange(qg, 0, other, 16) is None
    assert tT._match_step(qg, 0, hook, 16) is None
    # a seeded heavyball whose qg_buffer is not its seed, a stateful one
    # followed by a qg_buffer, a seeded one with no buffer after it
    for chain in [(tT.heavyball(0.9, seed_from="other"), tT.gossip_mix(),
                   tT.qg_buffer(0.9)),
                  (tT.heavyball(0.9), tT.gossip_mix(), tT.qg_buffer(0.9)),
                  (tT.heavyball(0.9, seed_from="qg_buffer"),
                   tT.gossip_mix())]:
        assert tT._match_exchange(chain, 0, hook, 16) is None


def test_segment_that_cannot_take_the_kernel_raises_off_the_cpu(recorded):
    """bf16 leaves: on a device (the meta device stands in for CUDA here)
    the matched segment raises rather than run its stages one by one; on
    CPU tensors it runs them (neither half of the segment's kernels is
    called)."""
    with pytest.raises(TypeError, match="matches a kernel but cannot take"):
        _step("qg_dsgdm_n", 16, dtype=torch.bfloat16, device="meta")
    assert recorded == []
    _step("qg_dsgdm_n", 16, dtype=torch.bfloat16)
    assert "fused_halfstep" not in recorded
    assert "choco_exchange" not in recorded


def _trained(preset, steps):
    spec = tapi.presets.get(preset).override(
        f"loop.steps={steps}", "comm.backend=auto", "optim.fused=kernel")
    ex = tapi.build(spec, device="cpu")
    return run_training_scanned(ex.trainer, ex.state, ex.task.make_iter(),
                                steps, chunk=steps, log_every=1,
                                log_fn=lambda *_: None)


@pytest.mark.parametrize("preset", ["choco_topk0.01_ring16_qg",
                                    "ef_signnorm_ring16_qg"])
def test_exchange_and_two_kernel_paths_agree_bit_for_bit_on_cpu(
        recorded, monkeypatch, preset):
    steps = 4
    state, hist = _trained(preset, steps)
    assert recorded.count("choco_exchange") == steps
    assert "gamma_correct" not in recorded
    recorded.clear()
    monkeypatch.setattr(tT, "_match_exchange", lambda *a: None)
    state_two, hist_two = _trained(preset, steps)
    assert "choco_exchange" not in recorded
    assert recorded.count("gamma_correct") == steps
    assert hist == hist_two
    for part in ("params", "opt_state", "comm_state"):
        # comm_state is a list of per-site trees
        a, b = ([t for tree in (v if part == "comm_state" else [v])
                 for t in tree_leaves(tree)]
                for v in (getattr(state, part), getattr(state_two, part)))
        assert len(a) == len(b) > 0
        assert all(torch.equal(x, y) for x, y in zip(a, b)), part


# ---------------------------------------------------------------------------
# the wrapper's refusals
# ---------------------------------------------------------------------------

def _operands(n=4, f=8, device="cpu"):
    x = torch.zeros(n, f, device=device)
    return ([x], [x.clone()], torch.eye(n, device=device),
            dict(gamma=0.5, x_hats=[x.clone()], x_pres=[x.clone()],
                 m_hats=[x.clone()], eta=torch.tensor([0.1], device=device),
                 refresh=torch.tensor([1.0], device=device), mu=0.9))


@pytest.mark.parametrize("case,exc,match", [
    ("cpu", ValueError, "CUDA tensor"),
    ("nodes", ValueError, "1 to 64 nodes"),
    ("w_shape", ValueError, r"w must be \[4, 4\]"),
    ("bf16", TypeError, "float32"),
    ("mixed", ValueError, "several devices"),
    ("no_eta", ValueError, "needs x_pres, m_hats, eta and refresh"),
    ("leaf_shape", ValueError, "one shape with 4 nodes"),
    ("roles", ValueError, "leaves by role"),
])
def test_wrapper_refuses_before_building(case, exc, match):
    halves, qs, w, kw = _operands(
        n=tK.STEP_MAX_NODES + 1 if case == "nodes" else 4)
    if case == "w_shape":
        w = torch.eye(5)
    elif case == "bf16":
        qs = [qs[0].to(torch.bfloat16)]
    elif case == "mixed":
        kw["x_hats"] = [torch.zeros(4, 8, device="meta")]
    elif case == "no_eta":
        kw["eta"] = None
    elif case == "leaf_shape":
        kw["m_hats"] = [torch.zeros(4, 9)]
    elif case == "roles":
        kw["x_pres"] = kw["x_pres"] * 2
    with pytest.raises(exc, match=match):
        tC.choco_exchange(halves, qs, w, **kw)
    assert tC._lib.cache_info().currsize == 0  # nothing was built


def test_ops_routes_cpu_tensors_to_the_plain_version():
    tops.reset_launch_counts()
    halves, qs, w, kw = _operands()
    got = tops.choco_exchange(halves, qs, w, **kw)
    want = tref.choco_exchange(halves, qs, w, **kw)
    for g, p in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, p))
    assert tops.launch_counts()["choco_exchange"] == 0
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        tops.choco_exchange(halves, qs, w.to("meta"), **kw)
