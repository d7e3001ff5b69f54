"""The port's telemetry (``repro_torch.telemetry``) on the CPU, against the
JAX package's on the same spec from the same init.

* Every collector against ``repro.telemetry.metrics`` on the same steps of
  the quickstart, CHOCO top-k and the reduced CIFAR spec (4 nodes, batch 4,
  256 samples, 3 steps; BN), run from the reference's init: rtol 1e-4 /
  atol 1e-7, the run's own bound (the products sum in other orders; see
  tests/test_torch_slice.py).  At step 0 every node holds x^0, and the
  consensus distance before the step is a rounding residue of the node
  mean (about 1e-9 in both packages, in neither exactly 0), so step 0's
  ``consensus_pre`` is held to atol 1e-7 and its ratios ``mix_contraction``
  / ``mix_progress`` are not compared.  The statics (wire bits, spectral
  gap, kernel bytes, data TV) are counts or host-side float64 values and
  must be equal.
* The history with telemetry on equals the history with it off, bit for
  bit, for every cadence tried; rows are emitted exactly on cadence.
* The JSONL and CSV sinks and ``python -m repro_torch.telemetry.report``.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import telemetry as jtel
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.api.__main__ import main as tmain
from repro_torch.telemetry import (METRICS, MemorySink, TelemetryRecorder,
                                   read_csv, read_jsonl, resolve_config)
from repro_torch.telemetry import report as treport
from repro_torch.train import run_training, run_training_scanned

RTOL, ATOL = 1e-4, 1e-7
STATICS = ("wire_bits_per_node", "spectral_gap", "kernel_bytes_moved",
           "data_mean_tv")
QUIET = dict(log_fn=lambda *_: None)


@pytest.fixture(autouse=True)
def _torch_on_one_thread():
    """The tier-1 run shares the machine's cores among its workers; the
    port's small CPU runs here gain nothing from torch's thread pool and
    would only crowd the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
SPECS = {
    "quickstart": ("quickstart_ring16_alpha0.1_qg", ("loop.steps=3",)),
    "choco": ("choco_topk0.01_ring16_qg", ("loop.steps=3",)),
    "cifar": ("cifar_ring16_alpha0.1_qg", (
        "topology.n=4", "data.batch=4", "data.n_data=256", "loop.steps=3",
        "model.kwargs.norm=bn")),
}


def _spec(name, *extra):
    preset, overrides = SPECS[name]
    return japi.presets.get(preset).override(*overrides, "loop.log_every=1",
                                             *extra)


def _injected_state(spec, tspec):
    """The reference's initial TrainState carried into the port."""
    ref_state = japi.build(spec).state
    init = jax.tree.map(np.asarray, ref_state.params)
    comm = (None if ref_state.comm_state is None else
            [jax.tree.map(np.asarray, s) for s in ref_state.comm_state])
    opt_state = tapi.build(tspec, device="cpu").trainer.optimizer.init(
        interop.params_from_numpy(init, "cpu"))
    return interop.train_state_from_numpy(
        init, opt_state, 0, "cpu", comm_state=comm,
        model_state=jax.tree.map(np.asarray, ref_state.model_state))


@pytest.mark.parametrize("name", list(SPECS))
def test_collectors_match_reference(name, tmp_path):
    spec = _spec(name, "telemetry.enabled=true")
    ref = japi.run(spec, telemetry_path=str(tmp_path / "ref.jsonl"), **QUIET)
    tspec = tapi.ExperimentSpec.from_json(spec.to_json())
    got = tapi.run(tspec, device="cpu", state=_injected_state(spec, tspec),
                   telemetry_path=str(tmp_path / "port.jsonl"), **QUIET)
    want_rows = read_jsonl(str(tmp_path / "ref.jsonl"))
    got_rows = read_jsonl(str(tmp_path / "port.jsonl"))
    assert [r["step"] for r in got_rows] == [r["step"] for r in want_rows] \
        == [0, 1, 2]
    assert got.telemetry["rows_emitted"] == 3
    for g, w in zip(got_rows, want_rows):
        assert set(g) == set(w), (name, sorted(set(g) ^ set(w)))
        for k, v in w.items():
            if k in STATICS:
                assert g[k] == v, (name, k)
            elif g["step"] == 0 and k in ("mix_contraction", "mix_progress"):
                continue
            elif g["step"] == 0 and k == "consensus_pre":
                assert abs(g[k] - v) <= 1e-7, (name, k, g[k], v)
            else:
                np.testing.assert_allclose(g[k], v, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{name} step "
                                                   f"{g['step']} {k}")
    if name == "choco":
        assert "choco_replica_norm_0" in got_rows[0]
    assert got.telemetry["static"].keys() == ref.telemetry["static"].keys()


@pytest.mark.parametrize("name,chunk,every", [
    ("quickstart", 1, 1), ("quickstart", 2, 2), ("quickstart", 3, 2),
    ("choco", 2, 3), ("cifar", 1, 2)])
def test_history_with_telemetry_equals_history_without(name, chunk, every):
    """Bit for bit: collecting reads the step's tensors and changes none of
    them, and an off-cadence step is the telemetry-free step."""
    spec = tapi.ExperimentSpec.from_json(_spec(
        name, f"loop.chunk={chunk}", "loop.steps=5").to_json())
    off = tapi.run(spec, device="cpu", **QUIET)
    on = tapi.run(spec.override("telemetry.enabled=true",
                                f"telemetry.every={every}",
                                "telemetry.sink=memory"), device="cpu",
                  **QUIET)
    assert on.history == off.history
    assert on.final == off.final
    assert on.telemetry["rows_emitted"] == len(range(0, 5, every))


@pytest.mark.parametrize("chunk,every,collecting", [
    (1, 3, [0, 3, 6]), (2, 3, [0, 1, 2, 3, 6]), (3, 4, [0, 1, 2, 3, 4, 5]),
    (2, 5, [0, 1, 4, 5])])
def test_cadence_rows_and_collecting_steps(chunk, every, collecting):
    """Rows only on cadence; a chunk with an on-cadence step collects on
    all its steps, any other step runs without the collectors (the
    reference's rules, ``repro/telemetry/recorder.py``)."""
    spec = tapi.ExperimentSpec.from_json(_spec(
        "quickstart", f"loop.chunk={chunk}", "loop.steps=7").to_json())
    ex = tapi.build(spec.override("telemetry.enabled=true",
                                  f"telemetry.every={every}"), device="cpu")
    ran, real = [], ex.trainer._runtime._step_math

    def spy(state, batch, collect=False, masks=None):
        ran.append(collect)
        return real(state, batch, collect, masks)

    ex.trainer._runtime._step_math = spy
    sink = MemorySink()
    rec = TelemetryRecorder(ex.trainer.telemetry, sink)
    if chunk > 1:
        run_training_scanned(ex.trainer, ex.state, ex.task.make_iter(), 7,
                             chunk=chunk, telemetry=rec, **QUIET)
    else:
        run_training(ex.trainer, ex.state, ex.task.make_iter(), 7,
                     telemetry=rec, **QUIET)
    rec.close()
    assert [i for i, c in enumerate(ran) if c] == collecting
    assert [r["step"] for r in sink.rows] == list(range(0, 7, every))
    assert all(set(r) == set(sink.rows[0]) for r in sink.rows)


def test_resolve_config_and_spec_validation():
    assert resolve_config().metrics.names == tuple(sorted(METRICS))
    assert set(METRICS) == set(jtel.METRICS)
    spec = tapi.presets.get("quickstart_ring16_alpha0.1_qg")
    assert spec.override("telemetry.enabled=true",
                         "telemetry.metrics=[\"consensus\"]").validate()
    for bad in ("telemetry.every=0", "telemetry.metrics=[\"bogus\"]",
                "telemetry.sink=bogus"):
        field = bad.split("=")[0]
        with pytest.raises(ValueError, match=f"\\]\\.{field}: "):
            spec.override(bad).validate()
    # one check of names and cadence: a hand-built config names the field
    with pytest.raises(ValueError, match="^telemetry.every: "):
        resolve_config(every=0)
    with pytest.raises(ValueError, match="^telemetry.metrics: "):
        resolve_config(names=("bogus",))


def test_selected_collectors_only():
    spec = tapi.ExperimentSpec.from_json(_spec("quickstart").to_json())
    res = tapi.run(spec.override(
        "telemetry.enabled=true", "telemetry.sink=memory",
        "telemetry.metrics=[\"consensus\", \"wire\"]"), device="cpu",
        **QUIET)
    assert res.telemetry["metrics"] == ["consensus", "wire"]
    assert res.telemetry["rows_emitted"] == 3


@pytest.mark.parametrize("sink", ["jsonl", "csv"])
def test_file_sinks_and_report(sink, tmp_path, capsys):
    """The CLI (``python -m repro_torch.api``, called in process) writes
    ``<out stem>.metrics.<ext>`` beside the Result; both sinks read back
    to the same rows, and the report renders them."""
    out = tmp_path / "r.json"
    assert tmain(["quickstart_ring16_alpha0.1_qg", "--device", "cpu",
                  "--set", "loop.steps=4", "--set", "telemetry.enabled=true",
                  "--set", f"telemetry.sink={sink}", "--out", str(out)]) == 0
    path = tmp_path / f"r.metrics.{sink}"
    assert f"telemetry -> {path} (4 rows)" in capsys.readouterr().out
    rows = (read_jsonl if sink == "jsonl" else read_csv)(str(path))
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    assert json.loads(out.read_text())["telemetry"]["path"] == str(path)
    text = treport.render(str(path))
    # the CSV sink reads every cell back as a float, steps too
    assert "4 rows, steps 0" in text and "`consensus_post`" in text
    treport.main([str(path), "--columns", "consensus_post,align_qg_buffer"])
    shown = capsys.readouterr().out
    assert "`align_qg_buffer`" in shown
    assert "`grad_norm_mean`" not in shown


def test_only_collecting_steps_carry_spans(monkeypatch):
    """A collecting step labels its stages (``tm/grad``, ``tm/finish_mix``,
    ``tm/collect``); a telemetry-free step opens no span at all."""
    import contextlib
    from repro_torch.runtime import base

    opened = []

    @contextlib.contextmanager
    def record(name):
        opened.append(name)
        yield

    monkeypatch.setattr(base, "graph_span", record)
    spec = tapi.ExperimentSpec.from_json(_spec("quickstart").to_json())
    ex = tapi.build(spec.override("telemetry.enabled=true"), device="cpu")
    batch = ex.trainer.put_batch(next(ex.task.make_iter()))
    state, metrics = ex.trainer.step(ex.state, batch, False)
    assert opened == [] and not any(k.startswith("tm.") for k in metrics)
    ex.trainer.step(state, batch, True)
    assert opened == ["tm/grad", "tm/finish_mix", "tm/collect"]
