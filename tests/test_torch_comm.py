"""The port's compressed-communication modules on the CPU against the JAX
package's (``repro.comm``): compressors and their constants, the
error-feedback rounds, CHOCO's warm start, site count and one gossip round.

Inputs are numpy arrays fed to both packages.  The reference draws random-k's
mask and QSGD's ``u`` from ``jax.random`` keys split per leaf; the tests draw
the same numbers with those keys and hand them to the port as ``noise``.

Tolerances, each with its reason:
* top-k, random-k, QSGD, the identity, the damping of unbiased compressors
  and the EF rounds built on them: equal to the bit.  They select, divide
  by a constant, or round per element exactly as the reference's eager
  ``ref.py`` expressions do (both compute true fp32 divisions);
* sign+norm: rtol 1e-6, atol 1e-6.  Its scale is a mean, a sum taken in
  another order by torch than by XLA, so q may differ by an ulp of values
  of order 1, and the residual x - q inherits that absolute error;
* one CHOCO/EF round ``mix_site``: rtol 1e-6, atol 1e-7 on the output.
  The anchor gossip is a matrix product, summed in another order by torch
  than by XLA;
* the warm start (a zero-gradient half step): equal to the bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import choco as jchoco
from repro.comm import compressors as jcomp
from repro.comm import error_feedback as jef
from repro.core import optim as joptim
from repro.core import topology as jtopo
from repro_torch.comm import choco as tchoco
from repro_torch.comm import compressors as tcomp
from repro_torch.comm import error_feedback as tef
from repro_torch.core import optim as toptim
from repro_torch.core import topology as ttopo

KEY = jax.random.PRNGKey(3)
SPECS = ["dense", "topk:0.05", "topk:0.5", "randk:0.1", "signnorm", "qsgd:4",
         "qsgd:1"]
EXACT = dict(rtol=0, atol=0)
SIGNNORM_TOL = dict(rtol=1e-6, atol=1e-6)
ROUND_TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(n=4, seed=0):
    """A node-stacked tree with the MLP's key names, of small widths."""
    rng = np.random.default_rng(seed)
    return {"b1": rng.normal(size=(n, 9)).astype(np.float32),
            "b2": rng.normal(size=(n, 5)).astype(np.float32),
            "w1": rng.normal(size=(n, 12, 9)).astype(np.float32),
            "w2": rng.normal(size=(n, 9, 5)).astype(np.float32)}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _close(got[k], want[k], tol)
            continue
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _ref_noise(comp, key, tree):
    """The reference's per-leaf draws for ``comp.compress(key, tree)``, as
    the port's ``noise`` list (None for compressors that draw nothing)."""
    leaves = jax.tree.leaves(tree)
    keys = jax.random.split(key, max(len(leaves), 1))
    if isinstance(comp, jcomp.QSGD):
        draw = lambda k, x2d: jax.random.uniform(k, x2d.shape, jnp.float32)
    elif isinstance(comp, jcomp.RandomK):
        draw = lambda k, x2d: jax.random.bernoulli(k, comp.frac, x2d.shape)
    else:
        return None
    return [torch.from_numpy(np.array(draw(k, l.reshape(l.shape[0], -1))))
            for k, l in zip(keys, leaves)]


def _tol(spec):
    return SIGNNORM_TOL if spec == "signnorm" else EXACT


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("backend", ["jnp", "pallas", "auto"])
@pytest.mark.parametrize("method", ["compress", "compress_with_residual",
                                    "contractive_compress"])
def test_compressor_matches_reference(spec, backend, method):
    tree = _tree()
    jc = jcomp.make_compressor(spec)
    tc = tcomp.make_compressor(spec, backend=backend)
    assert tc.backend == ("jnp" if backend == "jnp" else "pallas")
    noise = _ref_noise(jc, KEY, _j(tree))
    want = getattr(jc, method)(KEY, _j(tree))
    got = getattr(tc, method)(None, _t(tree), noise=noise)
    if method == "compress_with_residual":
        for g, w in zip(got, want):
            _close(g, w, _tol(spec))
    else:
        _close(got, want, _tol(spec))


def test_compressors_draw_from_the_generator_and_stay_unbiased():
    """Without injected noise, random-k and QSGD draw from the generator:
    the same seed gives the same message, and the mean over draws tends to
    x (both are unbiased)."""
    x = {"w": torch.randn(2, 4000, generator=torch.Generator().manual_seed(1))}
    for spec in ("randk:0.25", "qsgd:2"):
        comp = tcomp.make_compressor(spec)
        a = comp.compress(torch.Generator().manual_seed(5), x)["w"]
        b = comp.compress(torch.Generator().manual_seed(5), x)["w"]
        assert torch.equal(a, b)
        gen = torch.Generator().manual_seed(6)
        mean = sum(comp.compress(gen, x)["w"] for _ in range(200)) / 200
        err = (mean - x["w"]).norm() / x["w"].norm()
        assert err < 0.15, (spec, float(err))


def _quickstart_tree(seed=1):
    """Node-stacked leaves of the quickstart MLP's shapes (16 nodes)."""
    rng = np.random.default_rng(seed)
    return {"b1": rng.normal(size=(16, 64)).astype(np.float32),
            "b2": rng.normal(size=(16, 20)).astype(np.float32),
            "w1": rng.normal(size=(16, 192, 64)).astype(np.float32),
            "w2": rng.normal(size=(16, 64, 20)).astype(np.float32)}


KERNEL_SPECS = ["topk:0.05", "topk:0.5", "topk:0.01", "qsgd:4", "qsgd:1"]


@pytest.mark.parametrize("spec", KERNEL_SPECS)
@pytest.mark.parametrize("method", ["compress", "compress_with_residual",
                                    "contractive_compress"])
@pytest.mark.parametrize("source", ["generator", "noise"])
@pytest.mark.parametrize("tree_fn", [_tree, _quickstart_tree],
                         ids=["small", "quickstart"])
def test_kernel_backend_trees_equal_jnp_backend(spec, method, source,
                                                tree_fn):
    """backend='pallas' compresses the whole tree in one grouped call;
    its trees equal the leaf-by-leaf jnp backend's bit for bit, from a
    seeded generator (the same draws, in leaf order) and from injected
    noise."""
    tree = _t(tree_fn())
    jc = jcomp.make_compressor(spec)
    noise = _ref_noise(jc, KEY, _j(tree_fn())) if source == "noise" \
        else None
    out = {}
    for backend in ("jnp", "pallas"):
        comp = tcomp.make_compressor(spec, backend=backend)
        gen = torch.Generator().manual_seed(7)
        out[backend] = getattr(comp, method)(gen, tree, noise=noise)
    if method == "compress_with_residual":
        for a, b in zip(out["pallas"], out["jnp"]):
            _close(a, b, EXACT)
    else:
        _close(out["pallas"], out["jnp"], EXACT)


@pytest.mark.parametrize("spec,group", [("topk:0.05", "threshold_mask_group"),
                                        ("qsgd:4",
                                         "quantize_dequantize_group")])
def test_kernel_backend_makes_one_group_call_per_message(spec, group,
                                                         monkeypatch):
    """Each tree method of the kernel-backed compressors hands every leaf
    of the message to one group call, and never to the one-leaf call; a
    single message matrix is a group of one."""
    from repro_torch.kernels import ops
    calls = []
    real = getattr(ops, group)

    def spy(x2ds, *args, **kw):
        calls.append(len(x2ds))
        return real(x2ds, *args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("a one-leaf call on the tree path")

    monkeypatch.setattr(ops, group, spy)
    monkeypatch.setattr(ops, group.replace("_group", ""), refuse)
    comp = tcomp.make_compressor(spec, backend="pallas")
    tree = _t(_tree())
    gen = torch.Generator().manual_seed(0)
    comp.compress(gen, tree)
    comp.compress_with_residual(gen, tree)
    comp.contractive_compress(gen, tree)
    x2d = tree["w1"].reshape(tree["w1"].shape[0], -1)
    comp.compress_2d_with_residual(x2d, comp.noise_2d(gen, x2d))
    assert calls == [4, 4, 4, 1]


def test_noise_must_cover_every_leaf():
    with pytest.raises(ValueError, match="noise has 1 entries for 4 leaves"):
        tcomp.make_compressor("qsgd:4").compress(
            None, _t(_tree()), noise=[torch.zeros(4, 9)])


@pytest.mark.parametrize("spec", SPECS)
def test_compressor_constants_match_reference(spec):
    jc, tc = jcomp.make_compressor(spec), tcomp.make_compressor(spec)
    assert (tc.name, tc.unbiased) == (jc.name, jc.unbiased)
    for d in (1, 7, 20, 64, 1280, 12288):
        assert tc.delta(d) == jc.delta(d)
        assert tc.default_gamma(d) == jc.default_gamma(d)
        assert tc.wire_bits(d) == jc.wire_bits(d)
        if jc.unbiased:
            assert tc.omega(d) == jc.omega(d)
    tree = _tree()
    assert tcomp.tree_wire_bits(tc, _t(tree)) == \
        jcomp.tree_wire_bits(jc, _j(tree))
    assert tcomp.VALID_COMPRESSOR_FORMS == jcomp.VALID_COMPRESSOR_FORMS


MALFORMED = ["topk:", "topk:abc", "topk:0", "topk:1.5", "randk:-0.1",
             "qsgd:0", "qsgd:17", "qsgd:2.5", "qsgd:x", "signnorm:1",
             "dense:3", "bogus", "", 7]


@pytest.mark.parametrize("spec", MALFORMED)
def test_malformed_compressor_specs_raise_like_the_reference(spec):
    with pytest.raises(ValueError) as want:
        jcomp.make_compressor(spec)
    with pytest.raises(ValueError) as got:
        tcomp.make_compressor(spec)
    assert str(got.value) == str(want.value)
    if spec and spec != 7:
        with pytest.raises(ValueError):
            tchoco.make_comm(spec)


@pytest.mark.parametrize("gamma", [0.0, -0.5, 1.5])
def test_make_comm_rejects_gamma_outside_unit_interval(gamma):
    with pytest.raises(ValueError, match="gamma must be in"):
        jchoco.make_comm("topk:0.1", gamma=gamma)
    with pytest.raises(ValueError, match="gamma must be in"):
        tchoco.make_comm("topk:0.1", gamma=gamma)


def test_make_comm_forms():
    for spec in ("", None, "dense", "none", "DENSE"):
        assert tchoco.make_comm(spec) is None
    comm = tchoco.make_comm("signnorm", gamma=0.3, error_feedback=True,
                            backend="auto")
    assert (comm.gamma, comm.error_feedback, comm.compressor.backend) == \
        (0.3, True, "pallas")
    with pytest.raises(ValueError, match="backend"):
        tchoco.make_comm("topk:0.1", backend="cuda")


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["topk:0.1", "signnorm", "qsgd:4",
                                  "randk:0.3"])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_error_feedback_rounds_match_reference(spec, backend):
    value, other = _tree(seed=1), _tree(seed=2)
    jc = jcomp.make_compressor(spec)
    tc = tcomp.make_compressor(spec, backend=backend)
    # EF14: compress (value + residual)
    corrected = jax.tree.map(jnp.add, _j(value), _j(other))
    noise = _ref_noise(jc, KEY, corrected)
    jq, jr = jef.ef_compress(jc, KEY, _j(value), _j(other))
    tq, tr = tef.ef_compress(tc, None, _t(value), _t(other), noise=noise)
    _close(tq, jq, _tol(spec))
    _close(tr, jr, _tol(spec))
    # telescoping: q + new residual == value + old residual, up to the
    # rounding of r = c - q (random-k's q = c/frac reaches ~20 here)
    for k in value:
        np.testing.assert_allclose((tq[k] + tr[k]).numpy(),
                                   value[k] + other[k], rtol=0, atol=4e-6)
    # EF21: advance the estimate by C(target - estimate)
    diff = jax.tree.map(jnp.subtract, _j(value), _j(other))
    noise = _ref_noise(jc, KEY, diff)
    jh, jq = jef.ef21_update(jc, KEY, _j(value), _j(other))
    th, tq = tef.ef21_update(tc, None, _t(value), _t(other), noise=noise)
    _close(tq, jq, _tol(spec))
    _close(th, jh, _tol(spec))
    _close(tef.init_residual(_t(value)), jef.init_residual(_j(value)), EXACT)


# ---------------------------------------------------------------------------
# CHOCO: warm start, site count, one round
# ---------------------------------------------------------------------------

OPTS = ["dsgd", "dsgdm_n", "qg_dsgdm_n"]


def _ring(n=4):
    return jtopo.get_topology("ring", n).w(0), ttopo.get_topology(
        "ring", n).w(0)


@pytest.mark.parametrize("name", OPTS)
@pytest.mark.parametrize("error_feedback", [False, True])
@pytest.mark.parametrize("fused", ["off", "kernel"])
def test_init_state_and_site_count_match_reference(name, error_feedback,
                                                   fused):
    params = _tree(seed=4)
    jw, tw = _ring()
    jopt = joptim.make_optimizer(name, lr=0.05, weight_decay=1e-4)
    topt = toptim.make_optimizer(name, lr=0.05, weight_decay=1e-4,
                                 fused=fused)
    jcg = jchoco.make_comm("topk:0.1", error_feedback=error_feedback)
    tcg = tchoco.make_comm("topk:0.1", error_feedback=error_feedback)
    want = jcg.init_state(jopt, _j(params), jw)
    got = tcg.init_state(topt, _t(params), torch.as_tensor(tw))
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        _close(g, w, EXACT)
    assert tchoco.count_mix_sites(topt, _t(params), torch.as_tensor(tw)) \
        == jchoco.count_mix_sites(jopt, _j(params), jw) == 1
    # the warm start is a copy, not a view of the caller's params
    if not error_feedback:
        assert got[0]["x_hat"]["w1"].data_ptr() != \
            _t(params)["w1"].data_ptr()


def test_count_mix_sites_runs_no_arithmetic():
    """The site count runs on meta tensors: even a kernel chain launches
    nothing and a CUDA-only path is never reached."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    opt = toptim.make_optimizer("qg_dsgdm_n", fused="kernel")
    assert tchoco.count_mix_sites(opt, _t(_tree()), None) == 1
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("spec,error_feedback,gamma", [
    ("topk:0.1", False, None), ("topk:0.1", True, 0.5),
    ("signnorm", True, 0.3), ("signnorm", False, 0.3),
    ("qsgd:4", False, None)])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_one_mix_site_round_matches_reference(spec, error_feedback, gamma,
                                              backend):
    tree, state = _tree(seed=5), _tree(seed=6)
    jw, tw = _ring()
    jcg = jchoco.make_comm(spec, gamma=gamma, error_feedback=error_feedback)
    tcg = tchoco.make_comm(spec, gamma=gamma, error_feedback=error_feedback,
                           backend=backend)
    g = jcg.resolved_gamma(_j(tree))
    assert tcg.resolved_gamma(_t(tree)) == g
    assert tcg.wire_bits_per_site(_t(tree)) == \
        jcg.wire_bits_per_site(_j(tree))
    field = "residual" if error_feedback else "x_hat"
    jsite, tsite = {field: _j(state)}, {field: _t(state)}
    if error_feedback:
        innov = jax.tree.map(jnp.add, _j(tree), _j(state))
    else:
        innov = jax.tree.map(jnp.subtract, _j(tree), _j(state))
    noise = _ref_noise(jcg.compressor, KEY, innov)
    want_out, want_site = jcg.mix_site(jw, _j(tree), jsite, key=KEY, gamma=g)
    got_out, got_site = tcg.mix_site(torch.as_tensor(tw), _t(tree), tsite,
                                     gen=None, gamma=g, noise=noise)
    _close(got_site, want_site,
           SIGNNORM_TOL if spec == "signnorm" else EXACT)
    _close(got_out, want_out, ROUND_TOL)


def test_mix_fn_threads_sites_and_refuses_extra_calls():
    tree = _t(_tree(seed=7))
    tcg = tchoco.make_comm("topk:0.2")
    sites_in = [tcg.init_site(tree)]
    sites_out = list(sites_in)
    w = torch.as_tensor(_ring()[1])
    mix = tcg.make_mix_fn(sites_in, sites_out, None, 0.5)
    mix(w, tree)
    assert sites_out[0] is not sites_in[0]
    with pytest.raises(RuntimeError, match="2 mix calls but comm state has 1"):
        mix(w, tree)


def _bf16_tree(device):
    tree = {"a": torch.ones(4, 3, device=device),
            "b": torch.ones(4, 2, dtype=torch.bfloat16, device=device)}
    return tree, dict(tree), dict(tree)


def test_decompress_kernel_path_refuses_non_fp32_off_the_cpu():
    """backend='pallas' cannot stream a bf16 leaf through the fp32 kernel:
    on a device (the meta device stands in for CUDA here) it raises rather
    than fall back to the leaf-by-leaf path; on CPU tensors it takes that
    path, as the reference does."""
    cg = tchoco.make_comm("topk:0.5", backend="pallas")
    with pytest.raises(TypeError, match=r"leaf \('b',\) is torch.bfloat16"):
        cg._decompress(*_bf16_tree("meta"), 0.5)
    out = cg._decompress(*_bf16_tree("cpu"), 0.5)
    assert out["b"].dtype == torch.bfloat16 and torch.equal(
        out["a"], torch.ones(4, 3))
    jnp_cg = dataclasses.replace(cg, compressor=tcomp.make_compressor(
        "topk:0.5"))
    jnp_cg._decompress(*_bf16_tree("meta"), 0.5)   # the jnp path takes any


def test_decompress_paths_agree_to_the_bit():
    tree, mixed, anchor = (_t(_tree(seed=s)) for s in (8, 9, 10))
    a = tchoco.make_comm("topk:0.5", backend="pallas")._decompress(
        tree, mixed, anchor, 0.3)
    b = tchoco.make_comm("topk:0.5", backend="jnp")._decompress(
        tree, mixed, anchor, 0.3)
    _close(a, b, EXACT)
