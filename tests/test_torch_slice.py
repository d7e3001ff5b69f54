"""The port's main path end to end on the CPU: the quickstart presets
through ``repro_torch.api`` against ``repro.api`` on the same spec JSON.

Tolerances, each with its reason:
* first chunk of 25 steps from the reference's init: rtol 1e-4 on loss,
  consensus and grad_norm.  The arithmetic is the same; the matrix products
  sum in another order in torch than in XLA, and the difference grows with
  training (about 1e-5 after 25 steps on this machine);
* full 150 steps from the reference's init: test accuracy within 1e-3 of
  the reference's (one eval sample in 2048 is 4.9e-4);
* full 150 steps standalone (torch init at the reference's scales, a
  different draw): within 0.03 of the reference's accuracies recorded in
  ROADMAP.md (0.9711 DSGDm-N, 0.9839 QG-DSGDm-N), with QG >= DSGDm.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi
from repro_torch import interop

PRESETS = ["quickstart_ring16_alpha0.1_qg", "quickstart_ring16_alpha0.1_dsgdm"]
REF_ACC = {"quickstart_ring16_alpha0.1_qg": 0.9839,
           "quickstart_ring16_alpha0.1_dsgdm": 0.9711}
CHUNK_RTOL = 1e-4
INJECTED_ACC_ATOL = 1e-3
STANDALONE_ACC_ATOL = 0.03
QUIET = dict(log_fn=lambda *_: None)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("preset", PRESETS)
def test_port_loads_reference_spec_json(preset):
    ref = japi.presets.get(preset)
    spec = tapi.ExperimentSpec.from_json(ref.to_json())
    assert spec.to_dict() == ref.to_dict()
    assert spec == tapi.presets.get(preset)
    spec.validate()
    assert tapi.ExperimentSpec.from_json(spec.to_json()) == spec


@pytest.mark.parametrize("override,match", [
    ("comm.compressor=topk:0.01", "slice 3"),
    ("runtime=sharded", "slice 8"),
    ("gossip.schedule=ring_ppermute", "slice 8"),
    ("telemetry.enabled=true", "slice 5"),
    ("scenario.enabled=true", "slice 8"),
    ("topology.name=exp", "slice 2"),
    ("optim.name=qg_dadam", "slice 2"),
    ("model.name=resnet20", "slice 4"),
])
def test_spec_outside_the_slice_names_its_slice(override, match):
    spec = tapi.presets.get(PRESETS[0])
    with pytest.raises(NotImplementedError, match=match):
        spec.override(override).validate()


def test_spec_rejects_invalid_values():
    spec = tapi.presets.get(PRESETS[0])
    for override in ("optim.fused=bogus", "optim.lr=0", "data.alpha=0",
                     "loop.steps=0", "model.name=bogus"):
        with pytest.raises(ValueError):
            spec.override(override).validate()
    assert spec.override("optim.fused=pallas").validate()


def test_unported_presets_name_their_slice():
    with pytest.raises(NotImplementedError, match="slice 4"):
        tapi.presets.get("cifar_ring16_alpha0.1_qg")
    with pytest.raises(ValueError, match="unknown preset"):
        tapi.presets.get("bogus")


def _injected_run(preset, steps):
    """The reference's run and the port's from the reference's init."""
    spec = japi.presets.get(preset).override(f"loop.steps={steps}",
                                             "loop.log_every=1")
    ref = japi.run(spec, **QUIET)
    init = jax.tree.map(np.asarray, japi.build(spec).state.params)
    tspec = tapi.ExperimentSpec.from_json(spec.to_json())
    opt_state = tapi.build(tspec, device="cpu").trainer.optimizer.init(
        interop.params_from_numpy(init, "cpu"))
    state = interop.train_state_from_numpy(init, opt_state, 0, "cpu")
    return ref, tapi.run(tspec, device="cpu", state=state, **QUIET)


@pytest.mark.parametrize("preset", PRESETS)
def test_first_chunk_tracks_reference(preset):
    ref, got = _injected_run(preset, 25)
    assert got.steps_run == ref.steps_run == 25
    assert len(got.history) == len(ref.history) == 25
    for a, b in zip(got.history, ref.history):
        assert a["step"] == b["step"]
        for k in ("loss", "consensus", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=CHUNK_RTOL,
                                       err_msg=f"step {a['step']} {k}")


@pytest.mark.parametrize("preset", PRESETS)
def test_full_run_from_reference_init_lands_on_reference_accuracy(preset):
    ref, got = _injected_run(preset, 150)
    assert abs(got.final["acc"] - ref.final["acc"]) <= INJECTED_ACC_ATOL
    assert got.heterogeneity == ref.heterogeneity
    assert got.wire["bits_per_node_per_step"] == \
        ref.wire["bits_per_node_per_step"]


def test_standalone_runs_reproduce_the_headline_comparison():
    acc = {}
    for preset in PRESETS:
        res = tapi.run(tapi.presets.get(preset), device="cpu", **QUIET)
        assert res.steps_run == 150 and res.device == "cpu"
        assert [h["step"] for h in res.history] == [0, 50, 100, 149]
        assert np.isfinite(res.final["loss"])
        acc[preset] = res.final["acc"]
        assert abs(acc[preset] - REF_ACC[preset]) <= STANDALONE_ACC_ATOL
    assert acc[PRESETS[0]] >= acc[PRESETS[1]]        # QG >= DSGDm


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.run(tapi.presets.get(PRESETS[0]).override("loop.steps=1"),
                 **QUIET)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.build(tapi.presets.get(PRESETS[0]))


def test_interop_keeps_dtypes_and_copies():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "n": {"b": np.ones(2, np.int32)}}
    out = interop.params_from_numpy(tree, "cpu")
    assert out["a"].dtype == torch.float32 and out["n"]["b"].dtype == \
        torch.int32
    tree["a"][0, 0] = 99.0
    assert float(out["a"][0, 0]) == 0.0


_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "repro") or k.startswith(("jax.", "repro.")))
print(len(names), "modules;", "leaked:", bad)
"""


def test_port_imports_neither_jax_nor_the_reference():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": "src"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("leaked: []"), res.stdout
    assert int(res.stdout.split()[0]) >= 20


def test_cli_runs_a_preset_on_the_cpu(tmp_path):
    out = tmp_path / "result.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.api", PRESETS[0], "--device",
         "cpu", "--set", "loop.steps=3", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert "device=cpu steps=3" in res.stdout
    assert '"steps_run": 3' in out.read_text()
