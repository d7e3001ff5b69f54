"""The port's scenario engine (slice 8a) against the JAX package on the CPU.

* ``powerlaw`` / ``smallworld``: mixing, names and neighbours bit-equal at
  n in {32, 96, 1024} (the same float64 numpy arithmetic).
* The masks: ``participation_mask``, ``churn_mask`` and ``straggler_mask``
  bit-equal for several (seed, t, p), an ``ids=`` subset equal to the full
  draw, and a chunk's masks drawn at once equal to step-by-step draws.  The
  reference draws through ``jax.random`` under JAX's default
  ``jax_threefry_partitionable`` (True in JAX 0.9.0), which these tests
  assert; its golden tests pin the other flag (ROADMAP C1).
* ``mask_renormalize`` in fp32 within 1e-6 of the reference's (row sums may
  round differently), ``effective_mixing`` doubly stochastic with dead rows
  equal to the identity.
* The trainer's three refusals and the spec's field checks with the
  reference's texts; a trivial scenario is the no-scenario run bit for
  bit; dropped nodes hold their state exactly.
* A reduced ``n1024_churn`` (96 nodes over ``powerlaw:2.5``, 5 steps) from
  the reference's init: losses, consensus and grad norms within 1e-5
  relative of ``repro.api.run``, ``alive_frac`` / ``mix_frac`` equal, the
  final params within 1e-5 relative, and the telemetry collectors
  (``alive_frac``, the masked ``grad_norm_*``) against the reference's.
* The dispatcher: at 96 nodes, and behind the masked hook at 16, the
  QG-DSGDm-N chain takes ``fused_halfstep`` + ``fused_qg_buffer``, not
  ``qg_step``.
* The n1024 presets' batches equal the reference's; chip_smoke's churn
  constants are the masks' own.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import scenario as jsc
from repro.core import gossip as jgossip
from repro.core import optim as joptim
from repro.core import topology as jtopo
from repro.train import DecentralizedTrainer as JTrainer
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch import scenario as tsc
from repro_torch.api.__main__ import main as tmain
from repro_torch.api.data import build_task as t_build_task
from repro_torch.core import gossip as tgossip
from repro_torch.core import optim as toptim
from repro_torch.core import topology as ttopo
from repro_torch.core import transforms as tT
from repro_torch.kernels import ops as tops
from repro_torch.runtime.base import _masked_mix
from repro_torch.scenario import sampling as tsamp
from repro_torch.telemetry import read_jsonl
from repro_torch.train import DecentralizedTrainer as TTrainer
from repro_torch.tree import tree_leaves
from test_torch_zoo import chip_smoke

RTOL = 1e-5
RENORM_ATOL = 1e-6
QUIET = dict(log_fn=lambda *_: None)
CHURN = dict(participation=0.8, dropout=0.1, churn_window=5, straggler=0.05)
#: the reduced n1024_churn: its graph and scenario at 96 nodes, 5 steps
REDUCED = ("topology.n=96", "loop.steps=5", "loop.log_every=1")


@pytest.fixture(autouse=True)
def _torch_on_one_thread():
    """The tier-1 run shares the machine's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_reference_draws_under_the_default_prng_flag():
    assert jax.config.jax_threefry_partitionable


# ---------------------------------------------------------------------------
# generated graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [32, 96, 1024])
@pytest.mark.parametrize("name", ["powerlaw", "powerlaw:2.5", "powerlaw:3",
                                  "smallworld", "smallworld:0.1",
                                  "smallworld:0.3"])
def test_generated_graph_is_bit_equal(name, n):
    a, b = ttopo.get_topology(name, n), jtopo.get_topology(name, n)
    assert (a.name, a.n) == (b.name, b.n)
    np.testing.assert_array_equal(a.mixing, b.mixing)
    assert a.neighbors == b.neighbors
    a.validate()


def test_graph_builders_match_reference_off_the_registry():
    for kw in (dict(seed=3), dict(seed=1, mean_degree=6.0)):
        np.testing.assert_array_equal(
            tsc.powerlaw(200, 2.2, **kw).mixing,
            jsc.powerlaw(200, 2.2, **kw).mixing)
    for kw in (dict(seed=5), dict(k=6, seed=2), dict(k=3)):
        np.testing.assert_array_equal(
            tsc.smallworld(120, 0.2, **kw).mixing,
            jsc.smallworld(120, 0.2, **kw).mixing)
    for n in (1, 2):
        assert tsc.powerlaw(n).name == jsc.powerlaw(n).name
        np.testing.assert_array_equal(tsc.smallworld(n).mixing,
                                      jsc.smallworld(n).mixing)
    for fn, arg in ((tsc.powerlaw, 1.0), (tsc.smallworld, 1.5)):
        with pytest.raises(ValueError) as et:
            fn(16, arg)
        with pytest.raises(ValueError) as ej:
            getattr(jsc, fn.__name__)(16, arg)
        assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def test_prng_primitives_match_jax():
    for seed in (0, 7, 2 ** 31 - 1):
        k = tsamp.prng_key(seed)
        np.testing.assert_array_equal(
            k, np.asarray(jax.random.PRNGKey(seed)))
        for d in (0, 1, 0x5A3B, -3, 2 ** 31 - 1):
            np.testing.assert_array_equal(
                tsamp.fold_in(k, d),
                np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                              jnp.int32(d))))


def _draw(kind, pkg, seed, t, p, ids=None):
    if pkg is jsc:
        key = jax.random.PRNGKey(seed)
        ids = None if ids is None else jnp.asarray(ids)
    else:
        key = tsamp.prng_key(seed)
    if kind == "participation":
        out = pkg.participation_mask(key, t, 1024, p, ids=ids)
    elif kind == "churn":
        out = pkg.churn_mask(key, t, 1024, p, 5, ids=ids)
    else:
        out = pkg.straggler_mask(key, t, 1024, p, ids=ids)
    return np.asarray(out)


@pytest.mark.parametrize("p", [0.05, 0.5])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", ["participation", "churn", "straggler"])
def test_mask_is_bit_equal(kind, seed, p):
    ids = np.array([1023, 0, 511, 77, 77, 5])
    for t in (0, 1, 5, 37):
        got = _draw(kind, tsc, seed, t, p)
        want = _draw(kind, jsc, seed, t, p)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        sub = _draw(kind, tsc, seed, t, p, ids=ids)
        np.testing.assert_array_equal(sub, got[ids])
        np.testing.assert_array_equal(sub, _draw(kind, jsc, seed, t, p,
                                                 ids=ids))


def test_context_masks_match_reference_and_vectorise():
    ref = jsc.ScenarioContext(n=1024, seed=7, **CHURN)
    ctx = tsc.ScenarioContext(n=1024, seed=7, **CHURN)
    steps = np.arange(3, 23)
    stacked = ctx.stacked_masks(steps)
    assert stacked.shape == (20, 2, 1024) and stacked.dtype == np.float32
    for j, t in enumerate(steps):
        u, m = (np.asarray(a) for a in ref.masks(int(t)))
        np.testing.assert_array_equal(stacked[j, 0], u)
        np.testing.assert_array_equal(stacked[j, 1], m)
        np.testing.assert_array_equal(ctx.masks(int(t))[1], m)
    ids = np.arange(100, 164)
    for a, b in zip(ctx.masks(12, ids=ids), ref.masks(12,
                                                      ids=jnp.asarray(ids))):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tsc.ScenarioContext(n=4).trivial and not ctx.trivial


def test_chip_smoke_churn_constants_are_the_masks():
    """chip_smoke's N1024_CHURN_FRACS (written by scripts/n1024_ref.py from
    the JAX package's training runs) are the masks' own fractions."""
    spec = japi.presets.get("n1024_churn")
    sc = spec.scenario
    ref = jsc.ScenarioContext(n=spec.topology.n, seed=sc.seed,
                              participation=sc.participation,
                              dropout=sc.dropout,
                              churn_window=sc.churn_window,
                              straggler=sc.straggler)
    steps = chip_smoke.N1024_STEPS
    assert steps == spec.loop.steps
    want = tuple((float(np.sum(u)) / 1024, float(np.sum(m)) / 1024)
                 for u, m in (ref.masks(t) for t in range(steps)))
    assert chip_smoke.N1024_CHURN_FRACS == want
    port = tsc.ScenarioContext(n=1024, seed=sc.seed, **CHURN)
    s = port.stacked_masks(np.arange(steps)).sum(axis=-1) / 1024
    assert tuple(map(tuple, s.tolist())) == want


# ---------------------------------------------------------------------------
# the masked mixing matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo", ["powerlaw:2.5", "ring", "smallworld"])
def test_mask_renormalize_matches_reference(topo):
    w = jtopo.get_topology(topo, 96).w(0).astype(np.float32)
    rng = np.random.default_rng(0)
    for alive in (0.0, 0.3, 0.8, 1.0):
        m = (rng.random(96) < alive).astype(np.float32)
        got = tgossip.mask_renormalize(torch.from_numpy(w),
                                       torch.from_numpy(m))
        want = np.asarray(jgossip.mask_renormalize(jnp.asarray(w),
                                                   jnp.asarray(m)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=RENORM_ATOL)
        eff = tsc.effective_mixing(w, m)
        assert eff.dtype == np.float64
        np.testing.assert_allclose(eff, np.asarray(
            jsc.effective_mixing(w, m)), rtol=0, atol=RENORM_ATOL)
        assert ttopo.is_doubly_stochastic(eff, atol=1e-12)
        np.testing.assert_array_equal(eff, eff.T)
        dead = m == 0
        np.testing.assert_array_equal(eff[dead], np.eye(96)[dead])
        np.testing.assert_array_equal(eff[:, dead], np.eye(96)[:, dead])


# ---------------------------------------------------------------------------
# trainer and spec checks
# ---------------------------------------------------------------------------

def _j_loss(p, ms, batch, rng):
    return jnp.sum(p["w"]), (ms, {})


def _t_loss(p, ms, batch):
    return torch.sum(p["w"], dim=-1), (ms, {})


@pytest.mark.parametrize("case", ["n", "comm", "asymmetric"])
def test_trainer_refusals_match_reference(case):
    from repro.comm import make_comm as j_make_comm
    from repro_torch.comm import make_comm as t_make_comm
    n, topo, comm = 16, "ring", None
    sc_n = 16
    if case == "n":
        sc_n = 8
    elif case == "comm":
        comm = "topk:0.01"
    else:
        topo = "exp"
    j_kw = dict(scenario=jsc.ScenarioContext(n=sc_n, seed=1, **CHURN))
    t_kw = dict(scenario=tsc.ScenarioContext(n=sc_n, seed=1, **CHURN),
                device="cpu")
    if comm:
        j_kw["comm"], t_kw["comm"] = j_make_comm(comm), t_make_comm(comm)
    with pytest.raises(ValueError) as ej:
        JTrainer(_j_loss, joptim.make_optimizer("qg_dsgdm_n"),
                 jtopo.get_topology(topo, n), **j_kw)
    with pytest.raises(ValueError) as et:
        TTrainer(_t_loss, toptim.make_optimizer("qg_dsgdm_n"),
                 ttopo.get_topology(topo, n), **t_kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("override", [
    ("scenario.participation=0",), ("scenario.participation=1.5",),
    ("scenario.dropout=1",), ("scenario.straggler=-0.1",),
    ("scenario.churn_window=0",),
    ("scenario.enabled=true", "scenario.dropout=0.1",
     "comm.compressor=topk:0.01")])
def test_spec_scenario_checks_match_reference(override):
    spec = japi.presets.get("quickstart_ring16_alpha0.1_qg").override(
        *override)
    with pytest.raises(ValueError) as ej:
        spec.validate()
    with pytest.raises(ValueError) as et:
        tapi.ExperimentSpec.from_json(spec.to_json()).validate()
    assert str(et.value) == str(ej.value)


def test_trivial_scenario_is_the_no_scenario_run():
    spec = tapi.presets.get("quickstart_ring16_alpha0.1_qg").override(
        "loop.steps=4", "loop.log_every=1")
    base, s0 = tapi.run(spec, device="cpu", with_state=True, **QUIET)
    triv, s1 = tapi.run(spec.override("scenario.enabled=true",
                                      "scenario.seed=3"),
                        device="cpu", with_state=True, **QUIET)
    assert triv.history == base.history and triv.scenario is None
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s0.params)):
        assert torch.equal(a, b)


def test_dropped_nodes_hold_their_state():
    """One step under churn: every node outside the update mask keeps its
    params and optimizer state bit for bit; the step read the masks drawn
    from ``state.t`` itself."""
    spec = tapi.presets.get("n1024_churn").override(*REDUCED)
    ex = tapi.build(spec, device="cpu")
    it = ex.task.make_iter()
    state, _ = ex.trainer.step(ex.state, ex.trainer.put_batch(next(it)))
    before = state
    u = ex.trainer.scenario.masks(1)[0]
    state, m = ex.trainer.step(state, ex.trainer.put_batch(next(it)))
    assert float(m["alive_frac"]) == float(u.sum() * np.float32(1 / 96))
    dead = torch.from_numpy(u == 0)
    assert 0 < int(dead.sum()) < 96
    for new, old in zip(tree_leaves((state.params, state.opt_state)),
                        tree_leaves((before.params, before.opt_state))):
        assert torch.equal(new[dead], old[dead])
        assert not torch.equal(new[~dead], old[~dead])


def test_resumed_run_draws_the_masks_of_its_steps(tmp_path):
    """A run resumed from a checkpoint at step 2 keys its masks by the
    absolute step, and ends as the whole run, bit for bit."""
    spec = tapi.presets.get("n1024_churn").override(*REDUCED,
                                                    "eval.enabled=false")
    whole, s_whole = tapi.run(spec, device="cpu", with_state=True, **QUIET)
    ckpt = str(tmp_path / "c.npz")
    tapi.run(spec.override("loop.steps=2"), device="cpu",
             checkpoint_path=ckpt, **QUIET)
    rest, s_rest = tapi.run(spec, device="cpu", resume=ckpt,
                            with_state=True, **QUIET)
    assert rest.history == whole.history[2:]
    for a, b in zip(tree_leaves(s_rest.params), tree_leaves(s_whole.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the reduced n1024_churn run against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def churn_runs(tmp_path_factory):
    """The reduced n1024_churn with telemetry, in both packages, the port
    from the reference's init; the port's run once more in chunks of 2."""
    tmp = tmp_path_factory.mktemp("churn")
    spec = japi.presets.get("n1024_churn").override(
        *REDUCED, "telemetry.enabled=true")
    ref, ref_state = japi.run(spec, with_state=True,
                              telemetry_path=str(tmp / "ref.jsonl"), **QUIET)
    init = jax.tree.map(np.asarray, japi.build(spec).state.params)
    tspec = tapi.ExperimentSpec.from_json(spec.to_json())

    def state():
        opt_state = tapi.build(tspec, device="cpu").trainer.optimizer.init(
            interop.params_from_numpy(init, "cpu"))
        return interop.train_state_from_numpy(init, opt_state, 0, "cpu")

    got, got_state = tapi.run(tspec, device="cpu", state=state(),
                              with_state=True,
                              telemetry_path=str(tmp / "port.jsonl"), **QUIET)
    chunked = tapi.run(tspec.override("loop.chunk=2",
                                      "telemetry.enabled=false"),
                       device="cpu", state=state(), **QUIET)
    return dict(ref=ref, got=got, chunked=chunked,
                ref_params=jax.tree.map(np.asarray, ref_state.params),
                got_params=got_state.params,
                ref_rows=read_jsonl(str(tmp / "ref.jsonl")),
                got_rows=read_jsonl(str(tmp / "port.jsonl")))


def test_reduced_churn_tracks_reference(churn_runs):
    ref, got = churn_runs["ref"], churn_runs["got"]
    assert got.steps_run == ref.steps_run == 5
    for a, b in zip(got.history, ref.history, strict=True):
        assert a["step"] == b["step"]
        assert (a["alive_frac"], a["mix_frac"]) == \
            (b["alive_frac"], b["mix_frac"])
        for k in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL,
                                       err_msg=f"step {a['step']} {k}")
    assert 0.6 < got.history[0]["alive_frac"] < 0.8
    for a, b in zip(tree_leaves(churn_runs["got_params"]),
                    jax.tree.leaves(churn_runs["ref_params"]), strict=True):
        a = a.numpy()
        assert np.max(np.abs(a - b)) <= RTOL * np.max(np.abs(b))
    np.testing.assert_allclose(got.final["acc"], ref.final["acc"],
                               atol=1e-3)
    assert got.scenario["mask_host_s"] > 0
    # the chunked loop copies a chunk's masks at once: the same run
    assert churn_runs["chunked"].history == got.history


def test_scenario_collectors_match_reference(churn_runs):
    """``alive_frac`` equal; the masked ``grad_norm_*`` (participating
    nodes only) within the run's bound."""
    want_rows, got_rows = churn_runs["ref_rows"], churn_runs["got_rows"]
    assert [r["step"] for r in got_rows] == [r["step"] for r in want_rows]
    for g, w in zip(got_rows, want_rows):
        assert set(g) == set(w)
        assert g["alive_frac"] == w["alive_frac"]
        for k in ("grad_norm_mean", "grad_norm_std", "grad_norm_max"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                       err_msg=f"step {g['step']} {k}")
    hist = churn_runs["got"].history
    assert [r["alive_frac"] for r in got_rows] == \
        [r["alive_frac"] for r in hist]


# ---------------------------------------------------------------------------
# the dispatcher's route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,hook,want", [
    (96, "dense", ["fused_halfstep", "fused_qg_buffer"]),
    (16, "masked", ["fused_halfstep", "fused_qg_buffer"]),
    (16, "dense", ["qg_step"])])
def test_dispatch_route(n, hook, want, monkeypatch):
    """Counted as tests/test_torch_zoo.py counts it: the QG-DSGDm-N chain on
    the CPU with ``fused='kernel'``."""
    calls = []
    for kernel in ("qg_step", "fused_halfstep", "fused_qg_buffer"):
        real = getattr(tops, kernel)

        def counting(*a, _real=real, _k=kernel, **kw):
            calls.append(_k)
            return _real(*a, **kw)
        monkeypatch.setattr(tops, kernel, counting)
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.standard_normal((n, 6, 5), np.float32)),
         "b": torch.from_numpy(rng.standard_normal((n, 5), np.float32))}
    w = torch.from_numpy(ttopo.get_topology("powerlaw", n).w(0).astype(
        np.float32))
    mix = tgossip.mix_dense
    if hook == "masked":
        mix = _masked_mix(torch.from_numpy(
            (rng.random(n) < 0.7).astype(np.float32)))
    opt = toptim.make_optimizer("qg_dsgdm_n", lr=0.1, weight_decay=1e-4,
                                fused="kernel")
    stages = opt._stages()
    ctx = tT.StepCtx(w=w, lr=torch.full((1,), 0.1),
                     t=torch.zeros((), dtype=torch.int32), mix_fn=mix)
    g = {k: torch.sin(v) for k, v in p.items()}
    sv = tT.StepVars(grads=g, update=g, params=p, params_pre_mix=p)
    tT.chain_apply(stages, ctx, sv, tT.chain_init(stages, p), fused="kernel")
    assert calls == want


# ---------------------------------------------------------------------------
# data, presets, CLI
# ---------------------------------------------------------------------------

def test_n1024_batches_equal_reference():
    from repro.api.data import build_task as j_build_task
    spec = japi.presets.get("n1024_churn")
    a = j_build_task(spec, 1024)
    b = t_build_task(tapi.ExperimentSpec.from_json(spec.to_json()), 1024)
    for _, ba, bb in zip(range(3), a.make_iter(), b.make_iter()):
        for x, y in zip(ba, bb, strict=True):
            np.testing.assert_array_equal(np.asarray(x), y)
    assert b.meta["heterogeneity"] == a.meta["heterogeneity"]
    for ea, eb in zip(a.eval_batches, b.eval_batches, strict=True):
        for x, y in zip(ea, eb, strict=True):
            np.testing.assert_array_equal(np.asarray(x), y)


def test_cli_runs_the_churn_preset_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "r.json"
    assert tmain(["n1024_churn", "--device", "cpu", "--set", "topology.n=64",
                  "--set", "loop.steps=3", "--set", "eval.batch=0",
                  "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "alive_frac" in text and "result ->" in text
    r = json.loads(out.read_text())
    assert r["steps_run"] == 3 and r["device"].startswith("cpu")
    assert r["scenario"]["mask_host_ms_per_step"] > 0
