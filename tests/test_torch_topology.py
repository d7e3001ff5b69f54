"""The port's topologies, consensus experiments and the social32 / exp16
presets (slice 2) against the JAX package.

* Every registry topology's mixing stack is bit-equal to the reference's
  (the same float64 numpy arithmetic), as are its neighbours, spectral gap
  and ``get_topology``'s error texts.
* Consensus (``core/consensus.py``) on the CPU: distance histories within
  rtol 1e-5 with atol 1e-6 times the round-0 distance (the rounds that reach
  fp32's floor; the norm sums in another order in torch than in XLA, 1.6e-7
  of round 0's distance at most, measured here), and ``steps_to_distance``
  equal.  chip_smoke's consensus constants are the reference's.
* The presets, from the reference's init: the first 25 steps within the
  quickstart's chunk bound (rtol 1e-4), and the 150-step test accuracy
  within 1e-3 of the reference's.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import consensus as jcons
from repro.core import topology as jtopo
from repro_torch import api as tapi
from repro_torch.core import consensus as tcons
from repro_torch.core import topology as ttopo
from repro_torch.kernels import ops as tops
from test_torch_slice import CHUNK_RTOL, _injected_run
from test_torch_zoo import chip_smoke

ROOT = Path(__file__).resolve().parent.parent
PRESETS = ["social32_alpha0.1_qg", "exp16_alpha0.1_qg"]
CASES = [("ring", 16), ("ring", 32), ("complete", 8), ("complete", 16),
         ("star", 9), ("star", 16), ("social", 32), ("social", 0),
         ("exp", 8), ("exp", 16), ("exp", 32), ("torus", 16), ("torus", 12),
         ("torus", 9), ("torus", 7)]
CONSENSUS = [("ring", 16), ("ring", 32), ("social", 32), ("exp", 16),
             ("torus", 16), ("star", 8)]
RTOL, ATOL = 1e-5, 1e-6
QUIET = dict(log_fn=lambda *_: None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (the worker's setting
    back after), as ``test_torch_slice`` runs: its models are small, and
    beside five other test workers, each with a pool of a thread a core,
    its runs waited on their pools longer than they computed (358 s of the
    suite's run before)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,n", CASES)
def test_registry_topology_is_bit_equal(name, n):
    a, b = ttopo.get_topology(name, n), jtopo.get_topology(name, n)
    assert (a.name, a.n) == (b.name, b.n)
    assert a.mixing.dtype == np.float64
    np.testing.assert_array_equal(a.mixing, b.mixing)
    assert a.neighbors == b.neighbors
    assert a.time_varying == b.time_varying
    assert a.max_degree == b.max_degree
    assert a.spectral_gap() == b.spectral_gap()
    for t in range(3):
        np.testing.assert_array_equal(a.w(t), b.w(t))
    a.validate()


def test_builders_and_registry_match_reference():
    assert sorted(ttopo.TOPOLOGIES) == sorted(jtopo.TOPOLOGIES)
    assert {k: v[1] for k, v in ttopo.TOPOLOGIES.items()} == \
        {k: v[1] for k, v in jtopo.TOPOLOGIES.items()}
    np.testing.assert_array_equal(ttopo._DAVIS_ATTENDANCE,
                                  jtopo._DAVIS_ATTENDANCE)
    rng = np.random.default_rng(0)
    adj = np.triu(rng.integers(0, 2, (12, 12)), 1)
    adj = adj + adj.T
    np.testing.assert_array_equal(ttopo.metropolis_weights(adj),
                                  jtopo.metropolis_weights(adj))
    for a, b in ((ttopo.torus(3, 5), jtopo.torus(3, 5)),
                 (ttopo.star(5), jtopo.star(5)),
                 (ttopo.one_peer_exponential(4),
                  jtopo.one_peer_exponential(4))):
        np.testing.assert_array_equal(a.mixing, b.mixing)


@pytest.mark.parametrize("spec,n", [("bogus", 16), ("ring:3", 16),
                                    ("torus:2", 16), ("powerlaw:x", 16),
                                    ("social", 16), ("exp", 12),
                                    ("", 16)])
def test_get_topology_error_texts_match_reference(spec, n):
    with pytest.raises(ValueError) as et:
        ttopo.get_topology(spec, n)
    with pytest.raises(ValueError) as ej:
        jtopo.get_topology(spec, n)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("spec", ["powerlaw", "powerlaw:2.5", "smallworld",
                                  "smallworld:0.1"])
def test_generated_graphs_name_slice_8(spec):
    """Slice 8a ported the generated graphs: the registry builds them,
    bit-equal to the reference's (tests/test_torch_scenario.py holds them
    at more sizes and parameters)."""
    a, b = ttopo.get_topology(spec, 16), jtopo.get_topology(spec, 16)
    assert a.name == b.name
    np.testing.assert_array_equal(a.mixing, b.mixing)
    assert a.neighbors == b.neighbors


# ---------------------------------------------------------------------------
# consensus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n", CONSENSUS)
@pytest.mark.parametrize("kind", ["gossip", "qg"])
def test_consensus_history_tracks_reference(name, n, kind):
    fj = jcons.run_gossip if kind == "gossip" else jcons.run_qg_consensus
    ft = tcons.run_gossip if kind == "gossip" else tcons.run_qg_consensus
    hj = fj(jtopo.get_topology(name, n), dim=128, steps=200, seed=0)
    ht = ft(ttopo.get_topology(name, n), dim=128, steps=200, seed=0,
            device="cpu")
    assert ht.dtype == np.float32 and ht.shape == (200,)
    np.testing.assert_allclose(ht, hj, rtol=RTOL, atol=ATOL * hj[0])
    for target in (1e-1, 1e-2, 1e-3):
        assert tcons.steps_to_distance(ht, target) == \
            jcons.steps_to_distance(hj, target)


def test_qg_consensus_hyperparameters_track_reference():
    topo_t, topo_j = ttopo.social_network(), jtopo.social_network()
    ht = tcons.run_qg_consensus(topo_t, beta=0.5, mu=0.3, dim=64, steps=120,
                                seed=3, device="cpu")
    hj = jcons.run_qg_consensus(topo_j, beta=0.5, mu=0.3, dim=64, steps=120,
                                seed=3)
    np.testing.assert_allclose(ht, hj, rtol=RTOL, atol=ATOL * hj[0])


def test_qg_consensus_strictly_faster_on_ring16():
    """The paper's headline consensus figure, in the port."""
    topo = ttopo.ring(16)
    sg = tcons.steps_to_distance(
        tcons.run_gossip(topo, steps=400, device="cpu"), 1e-2)
    sq = tcons.steps_to_distance(
        tcons.run_qg_consensus(topo, steps=400, device="cpu"), 1e-2)
    assert sq < sg


def test_consensus_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcons.run_gossip(ttopo.ring(4), steps=2)


def test_steps_to_distance_matches_reference():
    h = np.array([4.0, 2.0, 0.5, 0.04, 0.05, 0.001], np.float32)
    for target in (1.0, 0.5, 0.1, 0.01, 1e-4):
        assert tcons.steps_to_distance(h, target) == \
            jcons.steps_to_distance(h, target)


def test_chip_smoke_consensus_constants_are_the_reference_s():
    refs = chip_smoke.CONSENSUS_REF
    assert len(refs) == 8
    for (name, n, kind), (steps, hist) in refs.items():
        fn = jcons.run_gossip if kind == "gossip" else jcons.run_qg_consensus
        h = fn(jtopo.get_topology(name, n), dim=chip_smoke.CONSENSUS_DIM,
               steps=chip_smoke.CONSENSUS_STEPS, seed=0)
        assert jcons.steps_to_distance(h, 1e-2) == steps
        np.testing.assert_allclose(h[chip_smoke.CONSENSUS_ROUNDS], hist,
                                   rtol=RTOL, atol=ATOL * h[0])


# ---------------------------------------------------------------------------
# the social32 and exp16 presets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_port_loads_reference_preset_json(preset):
    ref = japi.presets.get(preset)
    spec = tapi.ExperimentSpec.from_json(ref.to_json())
    assert spec.to_dict() == ref.to_dict()
    assert spec == tapi.presets.get(preset)
    assert tapi.ExperimentSpec.from_json(spec.to_json()) == spec


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_first_steps_track_reference(preset):
    ref, got = _injected_run(preset, 25)
    assert len(got.history) == len(ref.history) == 25
    for a, b in zip(got.history, ref.history):
        for k in ("loss", "consensus", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=CHUNK_RTOL,
                                       err_msg=f"step {a['step']} {k}")


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_full_run_from_reference_init(preset):
    """150 steps from the reference's init land within 1e-3 of its test
    accuracy, which is chip_smoke's ZOO_PRESETS constant (2 eval samples in
    2048 of slack for the constant, a count on this CPU)."""
    ref, got = _injected_run(preset, 150)
    assert abs(got.final["acc"] - ref.final["acc"]) <= 1e-3
    assert abs(chip_smoke.ZOO_PRESETS[preset] - ref.final["acc"]) <= 1e-3
    assert got.wire == {k: v for k, v in ref.wire.items()
                        if k in got.wire}


def test_exp16_picks_each_step_w_from_the_stack(monkeypatch):
    """The time-varying W reaches the fused step as the stack's phase
    t % 4, picked by the step counter on the tensors' device."""
    seen, real = [], tops.qg_step

    def spy(xs, ms, gs, w, *a, **kw):
        seen.append(w.clone())
        return real(xs, ms, gs, w, *a, **kw)

    monkeypatch.setattr(tops, "qg_step", spy)
    spec = tapi.presets.get("exp16_alpha0.1_qg").override(
        "loop.steps=6", "optim.fused=kernel")
    ex = tapi.build(spec, device="cpu")
    tapi.run(spec, device="cpu", **QUIET)
    mix = torch.from_numpy(ex.trainer.topology.mixing).float()
    assert len(seen) == 6
    for t, w in enumerate(seen):
        assert torch.equal(w, mix[t % 4])


def test_cli_runs_a_zoo_preset_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.api", PRESETS[0], "--device",
         "cpu", "--set", "loop.steps=3"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[social32_alpha0.1_qg] device=cpu steps=3" in res.stdout
