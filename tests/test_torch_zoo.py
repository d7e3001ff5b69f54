"""The port's optimizer zoo (slice 2) against the JAX package.

* Per-step parity: the 14 registry entries slice 2 brings run the toy
  problem of tests/test_torch_transforms.py (4 nodes on a ring, 13 steps of
  seeded numpy batches) through the JAX trainer (``fused`` off and pallas)
  and the port's on the CPU (``fused`` kernel and off), from the JAX init,
  at that file's tolerances (rtol 1e-5 / atol 1e-6 on the history, 1e-5 on
  the params).  The Adam pair meets them too (worst 2.2e-7 relative).
* The 13-step ``GOLDEN`` fingerprints of tests/test_transforms.py (rtol
  1e-4, atol 2e-5), for every key, from toy params drawn under
  ``jax_threefry_partitionable=False``, the mode they were frozen in.
* The fused dispatcher launches a kernel at exactly the stage indices where
  the reference's does, derived from the reference by counting its kernel
  calls.
* ``make_stage`` and ``OptimSpec.stages``, the two-site compressed tracking
  chains, the bytes-moved model, and the device-side gates.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import gossip as jgossip
from repro.core import optim as joptim
from repro.core import topology as jtopo
from repro.core import transforms as jT
from repro.kernels import ops as jops
from repro_torch import api as tapi
from repro_torch.comm import CompressedGossip, count_mix_sites, \
    make_compressor
from repro_torch.comm.choco import CompressedMix
from repro_torch.core import gossip as tgossip
from repro_torch.core import optim as toptim
from repro_torch.core import topology as ttopo
from repro_torch.core import transforms as tT
from repro_torch.kernels import ops as tops
from repro_torch.train import run_training_scanned as t_run_scanned
from repro_torch.tree import tree_map
from test_torch_slice import CHUNK_RTOL, _injected_run
from test_torch_transforms import (HIST_TOL, PARAM_TOL, STEPS, _bf16_step,
                                   _jax_run, _port_run)
from test_transforms import GOLDEN, LR, WD

ROOT = Path(__file__).resolve().parent.parent


def _load_chip_smoke():
    """chip_smoke.py as a module (its import runs nothing): its zoo
    constants are held here against the reference."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load_chip_smoke()

#: the registry entries slice 2 brings
NEW = ["dsgdm_sync", "dsgdm_n_sync", "dsgdm_n_sync_global", "qhm", "dadam",
       "qg_dadam", "slowmo", "dmsgd", "d2", "d2_plus", "gt", "gt_dsgdm_n",
       "mt_dsgdm", "gut"]
ALL = sorted(joptim.OPTIMIZERS)
QUIET = dict(log_fn=lambda *_: None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (the worker's setting
    back after), as ``test_torch_slice`` runs: its models are small, and
    beside five other test workers, each with a pool of a thread a core,
    its runs waited on their pools longer than they computed (414 s of the
    suite's run before)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# per-step parity and the golden fingerprints
# ---------------------------------------------------------------------------

def test_zoo_is_the_reference_registry():
    assert sorted(NEW) == sorted(set(ALL) - {
        "dsgd", "dsgdm", "dsgdm_n", "qg_dsgdm", "qg_dsgdm_n",
        "qg_dsgdm_tau"})
    assert sorted(toptim.OPTIMIZERS) == ALL
    assert list(chip_smoke.ZOO_NEW) == NEW
    for name in ALL:
        a, b = toptim.make_optimizer(name), joptim.make_optimizer(name)
        assert [(s.name, s.meta) for s in a._stages()] == \
            [(s.name, s.meta) for s in b._stages()], name
        assert {f.name: getattr(a, f.name) for f in dataclasses.fields(a)
                if f.name != "mix_fn"} == \
            {f.name: getattr(b, f.name) for f in dataclasses.fields(b)
             if f.name != "mix_fn"}, name


@pytest.mark.parametrize("method", NEW)
@pytest.mark.parametrize("port_fused", ["kernel", "off"])
@pytest.mark.parametrize("jax_fused", ["off", "pallas"])
def test_zoo_entry_tracks_reference_per_step(method, port_fused, jax_fused):
    init, h_j, p_j = _jax_run(method, jax_fused)
    h_t, p_t = _port_run(method, port_fused, init)
    assert len(h_t) == len(h_j) == STEPS
    for a, b in zip(h_t, h_j):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **HIST_TOL,
                                       err_msg=f"{method} step {a['step']} "
                                               f"{k}")
    for k in p_j:
        np.testing.assert_allclose(p_t[k], p_j[k], **PARAM_TOL,
                                   err_msg=f"{method} {k}")


@pytest.mark.parametrize("method", NEW)
def test_zoo_fused_and_unfused_agree_bitwise_on_cpu(method):
    init = _jax_run(method, "off")[0]
    h_k, p_k = _port_run(method, "kernel", init)
    h_o, p_o = _port_run(method, "off", init)
    assert h_k == h_o
    for k in p_k:
        np.testing.assert_array_equal(p_k[k], p_o[k])


def _toy_params(n, seed=0):
    """tests/test_transforms.py's toy params, drawn in the PRNG mode the
    GOLDEN table was frozen in, as numpy."""
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(seed)
        return {"w": np.array(jax.random.normal(k, (n, 5, 3))),
                "b": np.array(jax.random.normal(jax.random.fold_in(k, 1),
                                                (n, 3)))}


def _fingerprint(p):
    leaves = [p[k] for k in sorted(p)]
    return (sum(float(torch.sum(l)) for l in leaves),
            sum(float(torch.sum(l ** 2)) for l in leaves) ** 0.5)


def _toy_traj(opt, n, steps=13, w_of=None):
    """The port's run of tests/test_transforms.py's ``_traj``: grads
    sin(x (t+1)), the ring's W (or ``w_of(t)``), lr LR."""
    p = {k: torch.from_numpy(v) for k, v in _toy_params(n).items()}
    s = opt.init(p)
    ring = (torch.from_numpy(jtopo.ring(n).w().astype(np.float32))
            if n > 1 else torch.eye(1))
    out = []
    for t in range(steps):
        w = ring if w_of is None else w_of(t)
        g = {k: torch.sin(v * (t + 1)) for k, v in p.items()}
        p, s = opt.step(p, g, s, w=w, lr=LR, t=t)
        out.append(_fingerprint(p))
    return out, p, s


def _golden_opt(name, fused):
    if name == "qg_dsgdm_tau4":
        return toptim.QGDSGDm(lr=LR, weight_decay=WD, tau=4, fused=fused)
    if name == "dmsgd_opt1":
        return toptim.DMSGD(lr=LR, weight_decay=WD, option=1, fused=fused)
    return toptim.make_optimizer(name, lr=LR, weight_decay=WD, fused=fused)


@pytest.mark.parametrize("fused", ["off", "kernel"])
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_port_matches_golden_fingerprints(name, fused):
    traj, _, s = _toy_traj(_golden_opt(name, fused),
                           1 if name == "qhm" else 4)
    ref = np.array(GOLDEN[name])
    got = np.array(traj)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5, err_msg=name)
    assert all(bool(torch.all(torch.isfinite(l)))
               for l in jax.tree.leaves(s) if l.dtype.is_floating_point)


def test_golden_toy_params_need_the_frozen_prng_mode():
    """Why the toy params are drawn under the flag: the other PRNG mode
    (this JAX's default, under which the reference's 20 golden tests fail,
    ROADMAP C1) draws other numbers."""
    with jax.threefry_partitionable(True):
        w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 5, 3)))
    assert not np.array_equal(w, _toy_params(4)["w"])


# ---------------------------------------------------------------------------
# the tracking family
# ---------------------------------------------------------------------------

def test_mt_dsgdm_is_grad_track_plus_heavyball():
    opt = toptim.make_optimizer("mt_dsgdm", lr=LR)
    assert [s.name for s in opt._stages()] == [
        "weight_decay", "grad_track", "heavyball", "gossip_mix"]
    traj, _, _ = _toy_traj(opt, 4)
    assert np.all(np.isfinite(traj))
    t_gt, _, _ = _toy_traj(toptim.make_optimizer("gt", lr=LR), 4)
    t_n, _, _ = _toy_traj(toptim.make_optimizer("gt_dsgdm_n", lr=LR), 4)
    assert abs(traj[-1][0] - t_gt[-1][0]) > 1e-6
    assert abs(traj[-1][0] - t_n[-1][0]) > 1e-6


def test_gut_tracks_momentum_update():
    opt = toptim.make_optimizer("gut", lr=LR)
    assert [s.name for s in opt._stages()] == [
        "weight_decay", "heavyball", "grad_track", "gossip_mix"]
    w = torch.from_numpy(jtopo.ring(4).w().astype(np.float32))
    p = {k: torch.from_numpy(v) for k, v in _toy_params(4).items()}
    s = opt.init(p)
    g = tree_map(torch.sin, p)
    p1, s1 = opt.step(p, g, s, w=w, lr=LR, t=0)
    np.testing.assert_allclose(s1["grad_track"]["y"]["w"], g["w"], atol=1e-6)
    g2 = tree_map(lambda x: torch.sin(2 * x), p1)
    _, s2 = opt.step(p1, g2, s1, w=w, lr=LR, t=1)
    expect_u = 0.9 * s1["heavyball"]["m"]["w"] + g2["w"]
    np.testing.assert_allclose(s2["grad_track"]["prev_u"]["w"], expect_u,
                               rtol=1e-5)
    assert int(s2["grad_track"]["t"]) == 2


@pytest.mark.parametrize("kind,n,commute", [("ring", 8, True),
                                             ("exp", 8, False),
                                             ("exp", 16, False)])
def test_mt_gut_commute_on_fixed_w_only(kind, n, commute):
    """On a fixed W, MT and GUT give one trajectory; on the time-varying
    exponential graph (W picked per step) they part, as in the reference."""
    t = ttopo.get_topology(kind, n)
    mixing = torch.from_numpy(t.mixing.astype(np.float32))

    def run(name):
        traj, _, _ = _toy_traj(toptim.make_optimizer(name, lr=LR), t.n,
                               steps=10, w_of=lambda s: mixing[s % len(mixing)])
        return np.array(traj[-1])

    a, b = run("mt_dsgdm"), run("gut")
    if commute:
        np.testing.assert_allclose(a, b, rtol=1e-5)
    else:
        assert abs(a[0] - b[0]) > 1e-4


# ---------------------------------------------------------------------------
# the dispatcher: kernels exactly where the reference launches them
# ---------------------------------------------------------------------------

#: what the reference's rules give (ISSUE table): entry -> the stage
#: indices its kernel segment covers; every other entry runs stage by stage
KERNEL_SEGMENTS = {
    "dsgdm": (0, 1, 2), "dsgdm_n": (0, 1, 2), "qg_dsgdm": (0, 1, 2, 3),
    "qg_dsgdm_n": (0, 1, 2, 3), "qg_dsgdm_tau": (0, 1, 2, 3),
    "gt_dsgdm_n": (2, 3), "mt_dsgdm": (2, 3)}


def _recording(stages, seen):
    """The stages with each apply recording its index in ``seen``."""
    def rec(i, fn):
        def apply(ctx, sv, states):
            seen.append(i)
            return fn(ctx, sv, states)
        return apply
    return tuple(dataclasses.replace(s, apply=rec(i, s.apply))
                 for i, s in enumerate(stages))


def _reference_dispatch(name, monkeypatch):
    """(stages run unfused, kernel calls with their wd) of one step of the
    reference's chain under ``fused='pallas'``, its kernels wrapped with
    counting functions."""
    calls = []
    for kernel in ("fused_halfstep", "fused_qg_buffer"):
        real = getattr(jops, kernel)

        def counting(*a, _real=real, _k=kernel, **kw):
            calls.append((_k, kw.get("wd")))
            return _real(*a, **kw)
        monkeypatch.setattr(jops, kernel, counting)
    n = 4
    p = jax.tree.map(jnp.asarray, _toy_params(n))
    opt = joptim.make_optimizer(name, lr=LR, weight_decay=WD)
    seen = []
    stages = _recording(opt._stages(), seen)
    ctx = jT.StepCtx(w=jnp.asarray(jtopo.ring(n).w(), jnp.float32),
                     lr=jnp.float32(LR), t=0, mix_fn=jgossip.mix_dense)
    g = jax.tree.map(jnp.sin, p)
    sv = jT.StepVars(grads=g, update=g, params=p, params_pre_mix=p)
    jT.chain_apply(stages, ctx, sv, jT.chain_init(stages, p), fused="pallas")
    return seen, calls


_PORT_KERNELS = {k: getattr(tops, k) for k in (
    "qg_step", "fused_halfstep", "fused_qg_buffer", "choco_exchange")}


def _port_dispatch(name, monkeypatch, mix_fn):
    calls = []
    for kernel, real in _PORT_KERNELS.items():

        def counting(*a, _real=real, _k=kernel, **kw):
            calls.append((_k, kw.get("wd")))
            return _real(*a, **kw)
        monkeypatch.setattr(tops, kernel, counting)
    n = 4
    p = {k: torch.from_numpy(v) for k, v in _toy_params(n).items()}
    opt = toptim.make_optimizer(name, lr=LR, weight_decay=WD)
    seen = []
    stages = _recording(opt._stages(), seen)
    ctx = tT.StepCtx(w=torch.from_numpy(jtopo.ring(n).w().astype(np.float32)),
                     lr=torch.full((1,), LR),
                     t=torch.zeros((), dtype=torch.int32), mix_fn=mix_fn)
    g = tree_map(torch.sin, p)
    sv = tT.StepVars(grads=g, update=g, params=p, params_pre_mix=p)
    tT.chain_apply(stages, ctx, sv, tT.chain_init(stages, p), fused="kernel")
    return seen, calls


@pytest.mark.parametrize("name", ALL)
def test_dispatcher_launches_where_the_reference_does(name, monkeypatch):
    """The stages the reference's ``_chain_apply_fused`` takes into a
    kernel, found by counting its ``fused_halfstep`` / ``fused_qg_buffer``
    calls and the stages it runs itself: the port takes exactly those into
    one ``qg_step`` on the dense mix, and into the same two kernels (with
    the same weight decay) behind any other mix hook."""
    seen_j, calls_j = _reference_dispatch(name, monkeypatch)
    n_stages = len(toptim.make_optimizer(name)._stages())
    fused = tuple(i for i in range(n_stages) if i not in seen_j)
    assert fused == KERNEL_SEGMENTS.get(name, ()), (name, calls_j)
    seen_d, calls_d = _port_dispatch(name, monkeypatch, tgossip.mix_dense)
    seen_h, calls_h = _port_dispatch(
        name, monkeypatch, lambda w, tree: tgossip.mix_dense(w, tree))
    assert seen_d == seen_h == seen_j
    assert calls_h == calls_j
    assert calls_d == ([("qg_step", calls_j[0][1])] if calls_j else [])
    if name in ("gt_dsgdm_n", "mt_dsgdm"):
        assert calls_j == [("fused_halfstep", 0.0)]


@pytest.mark.parametrize("method", ["gt_dsgdm_n", "mt_dsgdm"])
def test_fused_chain_refuses_unfusable_leaves_mid_chain_off_cpu(method):
    """The mid-chain segment that cannot take its kernel (bf16 leaves) runs
    stage by stage on CPU tensors and raises on any other device."""
    p_k, _ = _bf16_step(method, "cpu", "kernel")
    p_o, _ = _bf16_step(method, "cpu", "off")
    for k in p_k:
        assert torch.equal(p_k[k], p_o[k])
    with pytest.raises(TypeError, match="bfloat16, not float32"):
        _bf16_step(method, "meta", "kernel")


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("n_elems", [7, 218_432])
def test_chain_bytes_moved_matches_reference(name, n_elems):
    stages_t = toptim.make_optimizer(name, weight_decay=WD)._stages()
    stages_j = joptim.make_optimizer(name, weight_decay=WD)._stages()
    for ft, fj in (("off", "off"), ("kernel", "pallas")):
        assert tT.chain_bytes_moved(stages_t, n_elems, fused=ft) == \
            jT.chain_bytes_moved(stages_j, n_elems, fused=fj), (name, ft)


# ---------------------------------------------------------------------------
# gates on the device, and the cross-stage writes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALL)
def test_steps_never_read_t_or_lr_on_the_host(name):
    """Two steps on meta tensors (no data: any host read of ``t``, ``lr``
    or a gate raises), with every stage's gate and counter kept there."""
    opt = toptim.make_optimizer(name, fused="off")
    p = {"w": torch.empty(4, 5, 3, device="meta"),
         "b": torch.empty(4, 3, device="meta")}
    s = opt.init(p)
    w = torch.empty(4, 4, device="meta")
    lr = torch.empty(1, device="meta")
    for step in range(2):
        t = torch.full((), step, dtype=torch.int32, device="meta")
        p, s = opt.step(p, tree_map(torch.zeros_like, p), s, w=w, lr=lr,
                        t=t)
    assert all(l.device.type == "meta" for l in jax.tree.leaves(
        s, is_leaf=lambda x: isinstance(x, torch.Tensor)))


def test_slow_outer_anchor_is_a_copy_and_resets_the_base_buffer():
    opt = toptim.SlowMo(lr=LR, tau=2)
    p = {k: torch.from_numpy(v) for k, v in _toy_params(4).items()}
    s = opt.init(p)
    assert s["slow_outer"]["anchor"]["w"].data_ptr() != p["w"].data_ptr()
    w = torch.from_numpy(jtopo.ring(4).w().astype(np.float32))
    p1, s1 = opt.step(p, tree_map(torch.sin, p), s, w=w, lr=LR, t=0)
    assert float(s1["heavyball"]["m"]["w"].abs().max()) > 0
    p2, s2 = opt.step(p1, tree_map(torch.sin, p1), s1, w=w, lr=LR, t=1)
    assert float(s2["heavyball"]["m"]["w"].abs().max()) == 0.0
    # the outer step's iterate is both the params and the new anchor
    assert torch.equal(p2["w"], s2["slow_outer"]["anchor"]["w"])
    assert not torch.equal(p1["w"], s1["slow_outer"]["anchor"]["w"])


def test_dmsgd_option1_replays_the_weight_decayed_gradient():
    opt = toptim.DMSGD(lr=LR, weight_decay=WD, option=1)
    p = {k: torch.from_numpy(v) for k, v in _toy_params(4).items()}
    g = tree_map(torch.sin, p)
    w = torch.from_numpy(jtopo.ring(4).w().astype(np.float32))
    _, s = opt.step(p, g, opt.init(p), w=w, lr=LR, t=0)
    assert torch.equal(s["dmsgd_buffer"]["prev_g"]["w"],
                       g["w"] + WD * p["w"])


def test_d2_keeps_prev_lr_on_the_device():
    opt = toptim.make_optimizer("d2_plus", lr=LR)
    p = {k: torch.from_numpy(v) for k, v in _toy_params(4).items()}
    w = torch.from_numpy(jtopo.ring(4).w().astype(np.float32))
    s = opt.init(p)
    for t, lr in enumerate((0.1, 0.05)):
        p, s = opt.step(p, tree_map(torch.sin, p), s, w=w,
                        lr=torch.full((1,), lr), t=t)
        st = s["d2"]["prev_lr"]
        assert isinstance(st, torch.Tensor) and st.shape == () and \
            st.dtype == torch.float32 and float(st) == np.float32(lr)


# ---------------------------------------------------------------------------
# make_stage and OptimSpec.stages
# ---------------------------------------------------------------------------

def test_make_stage_registry_and_errors_match_reference():
    assert sorted(tT.STAGES) == sorted(jT.STAGES)
    for name in ("heavyball", "grad_track", "buffer_sync", "slow_outer"):
        kw = {"heavyball": {"beta": 0.9}, "slow_outer": {
            "slow_beta": 0.7, "slow_alpha": 1.0, "tau": 4}}.get(name, {})
        a, b = tT.make_stage(name, **kw), jT.make_stage(name, **kw)
        assert (a.name, a.meta) == (b.name, b.meta)
    for call in (lambda m: m.make_stage("bogus"),
                 lambda m: m.make_stage("heavyball", bogus=1)):
        with pytest.raises(ValueError) as et:
            call(tT)
        with pytest.raises(ValueError) as ej:
            call(jT)
        assert str(et.value) == str(ej.value)


STAGE_CHAINS = {
    "qg_as_stages": [
        ["weight_decay", {"wd": 1e-4}],
        ["heavyball", {"beta": 0.9, "nesterov": True,
                       "seed_from": "qg_buffer"}],
        ["gossip_mix", {}], ["qg_buffer", {"mu": 0.9}]],
    "mt_as_stages": [
        ["weight_decay", {"wd": 1e-4}], ["grad_track", {}],
        ["heavyball", {"beta": 0.9}], ["gossip_mix", {}]],
    "qhm_then_sync": [
        ["qhm_momentum", {"beta": 0.9, "mu": 0.7, "name": "heavyball"}],
        ["gossip_mix", {}], ["buffer_sync", {"mode": "complete"}]],
}


def _stage_spec(chain, steps=8):
    return japi.presets.get("quickstart_ring16_alpha0.1_qg").override(
        f"optim.stages={json.dumps(chain)}", f"loop.steps={steps}")


@pytest.mark.parametrize("chain", sorted(STAGE_CHAINS))
def test_stage_chain_spec_loads_and_builds_the_reference_chain(chain):
    """A spec JSON with ``optim.stages`` written by ``repro.api`` loads
    unchanged, builds the reference's chain as a ``ChainOptimizer`` and
    trains along the reference's run from its init."""
    from repro.api.build import _make_opt
    jspec = _stage_spec(STAGE_CHAINS[chain])
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    assert tspec.to_dict() == jspec.to_dict()
    tspec.validate()
    opt = tapi.build(tspec, device="cpu").trainer.optimizer
    assert isinstance(opt, toptim.ChainOptimizer)
    assert [(s.name, s.meta) for s in opt._stages()] == \
        [(s.name, s.meta) for s in _make_opt(jspec)._stages()]
    ref, got = _injected_run(jspec.name, 8, "optim.stages="
                             + json.dumps(STAGE_CHAINS[chain]))
    assert len(got.history) == len(ref.history) == 8
    for a, b in zip(got.history, ref.history):
        for k in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=CHUNK_RTOL,
                                       err_msg=f"{chain} step {a['step']}")


def test_qg_chain_as_stages_equals_the_registry_entry_on_cpu():
    base = tapi.presets.get("quickstart_ring16_alpha0.1_qg").override(
        "loop.steps=10", "loop.log_every=1")
    a = tapi.run(base, device="cpu", **QUIET)
    b = tapi.run(base.override(
        "optim.stages=" + json.dumps(STAGE_CHAINS["qg_as_stages"])),
        device="cpu", **QUIET)
    assert a.history == b.history


@pytest.mark.parametrize("bad", [
    '[["bogus", {}]]', '[["heavyball"]]', '[[1, {}]]'])
def test_stage_chain_spec_refusals_match_reference(bad):
    """A malformed or unknown stage is refused by both packages, with one
    error text (at load for an entry that is not a pair, at validation for
    an unknown stage)."""
    texts = []
    for api_ in (japi, tapi):
        with pytest.raises(ValueError) as e:
            api_.presets.get("quickstart_ring16_alpha0.1_qg").override(
                f"optim.stages={bad}").validate()
        texts.append(str(e.value))
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------------
# compressed gossip: the two-site tracking chains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mt_dsgdm", "gut"])
def test_new_entries_compose_with_compressed_gossip(name):
    """Two mix calls (the tracker's site first): two CHOCO replica sites,
    the tracker's warm-started at zero, the params' from the params."""
    p = {"w": torch.ones(4, 6, 2), "b": torch.ones(4, 2)}
    w = torch.from_numpy(jtopo.ring(4).w().astype(np.float32))
    opt = toptim.make_optimizer(name, lr=LR)
    assert count_mix_sites(opt, p, w) == 2
    comm = CompressedGossip(compressor=make_compressor("topk:0.25"))
    sites = comm.init_state(opt, p, w)
    assert len(sites) == 2
    assert float(sites[0]["x_hat"]["w"].abs().max()) == 0.0
    np.testing.assert_allclose(sites[1]["x_hat"]["w"], p["w"])


@pytest.mark.parametrize("name", ["mt_dsgdm", "gut"])
def test_tracking_chains_under_compression_track_reference(name):
    """From the reference's init and warm-started sites, 25 steps of CHOCO
    top-k: the first 12 within the quickstart's chunk bound (1e-4), the
    rest within 1e-3.  Both chains barely learn under 1% top-k (test acc
    0.24-0.26 after 150 steps, in both packages) and their step losses move
    in jumps: 2.1e-4 relative at most over the 25 steps, measured on this
    CPU.  The wire counts equal."""
    ref, got = _injected_run("choco_topk0.01_ring16_qg", 25,
                             f"optim.name={name}")
    for a, b in zip(got.history, ref.history):
        rtol = CHUNK_RTOL if a["step"] < 12 else 1e-3
        for k in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=rtol,
                                       err_msg=f"{name} step {a['step']}")
        assert a["comm_bits_per_node"] == np.float32(b["comm_bits_per_node"])
    assert got.wire == ref.wire and got.wire["mix_sites"] == 2
    assert got.wire["ratio_vs_dense"] == chip_smoke.ZOO_WIRE_RATIO


@pytest.mark.parametrize("name", ["mt_dsgdm", "gut"])
def test_tracking_chains_take_the_predicted_kernels(name, monkeypatch):
    """With the kernel compressors and the fused chain (CPU tensors: the
    plain versions), MT's params site goes to ``choco_exchange`` as site 1
    after its tracker's plain round; GUT's two sites are plain rounds.
    The counts are chip_smoke's ZOO_TRACKING prediction."""
    counts, sites = {}, []
    for kernel in ("qg_step", "fused_halfstep", "fused_qg_buffer",
                   "choco_exchange", "gamma_correct", "threshold_mask_group"):
        real = getattr(tops, kernel)

        def counting(*a, _real=real, _k=kernel, **kw):
            counts[_k] = counts.get(_k, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(tops, kernel, counting)
    real_compress = CompressedMix.compress

    def spy(self, tree):
        i, q = real_compress(self, tree)
        sites.append(i)
        return i, q
    monkeypatch.setattr(CompressedMix, "compress", spy)
    spec = tapi.presets.get("choco_topk0.01_ring16_qg").override(
        f"optim.name={name}", "comm.backend=auto", "optim.fused=kernel",
        "loop.steps=3", "loop.chunk=1")
    tapi.run(spec, device="cpu", **QUIET)
    per_step, capture = chip_smoke.ZOO_TRACKING[name]
    want = {k.replace("threshold_mask", "threshold_mask_group"): 3 * v
            for k, v in per_step.items()}
    for k, v in capture.items():
        want[k] = want.get(k, 0) + v
    assert counts == want
    assert sites == [1] * want.get("choco_exchange", 0)


@pytest.mark.parametrize("name", ["mt_dsgdm", "gut"])
def test_tracking_chain_kernel_and_plain_backends_agree_on_cpu(name):
    spec = tapi.presets.get("choco_topk0.01_ring16_qg").override(
        f"optim.name={name}", "loop.steps=20", "loop.log_every=1")
    a = tapi.run(spec, device="cpu", **QUIET)
    b = tapi.run(spec.override("comm.backend=pallas", "optim.fused=kernel"),
                 device="cpu", **QUIET)
    assert a.history == b.history


# ---------------------------------------------------------------------------
# chip_smoke's stated bounds for the chaotic entries
# ---------------------------------------------------------------------------

def _rel_gap(h_a, h_b, steps):
    return max((abs(a[k] - b[k]) - 1e-5) / abs(b[k])
               for a, b in zip(h_a, h_b) if a["step"] in steps
               for k in ("loss", "consensus", "grad_norm"))


@pytest.mark.parametrize("name", sorted(chip_smoke.ZOO_CHAOTIC))
def test_adam_runs_are_themselves_sensitive_to_rounding(name):
    """Why chip_smoke holds the Adam pair's card-vs-CPU history to CPU_RTOL
    over its first steps only: the port's own run, its init scaled by
    1 + 1e-7, stays within 1e-4 for those steps (atol 1e-5, as there) and
    leaves its own history by more than 1e-3 within 50."""
    spec = tapi.presets.get("quickstart_ring16_alpha0.1_qg").override(
        f"optim.name={name}", "loop.steps=50")
    hist = []
    for eps in (0.0, 1e-7):
        ex = tapi.build(spec, device="cpu")
        st = ex.state
        st.params = tree_map(lambda p: p * (1 + eps), st.params)
        _, h = t_run_scanned(ex.trainer, st, ex.task.make_iter(), 50,
                             chunk=25, log_every=1, **QUIET)
        hist.append(h)
    held = chip_smoke.ZOO_CHAOTIC[name]
    assert _rel_gap(hist[1], hist[0], range(held)) < 1e-4
    assert _rel_gap(hist[1], hist[0], range(50)) > 1e-3
