"""Every cell, configuration, traffic mix, limit and metric of
``BENCHMARK.json`` is found by name and parsed, and a new one is added as
files alone."""
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = harness.resolve(name)
    assert cell.mix["nodes"] >= 1 and cell.chips == harness.CARDS
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap"}
    for fn in ("init_params", "node_loss", "flops_per_step"):
        assert callable(getattr(cell.family, fn))
    assert callable(cell.traffic.batches)
    assert callable(cell.optimizer.train_readings)
    assert callable(cell.gossip.mixer)
    w = cell.topology.mixing(cell.mix["nodes"])
    assert w.shape == (cell.mix["nodes"],) * 2
    assert abs(w.sum(axis=1) - 1).max() < 1e-12
    assert harness.make_spec(cell, 1).validate().runtime == \
        cell.mix["program"]["runtime"]
    names = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert {"step_ms", "setup_s"} <= names
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.module("metrics", m["name"]).read)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_matches_entry(entry):
    conf = json.loads((harness.ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"]
    assert conf["reduced"] == entry["reduced"]
    assert conf["source"] == entry["source"]


def test_new_cell_is_files_alone(tmp_path):
    """A dummy cell with its own configuration, mix, limits and metric,
    added in a copy as new files and entries, resolves and reads."""
    shutil.copytree(harness.ROOT / "perfbench", tmp_path / "perfbench")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "perfbench"
    conf = json.loads((pb / "configs" / "resnet20-cifar10.json").read_text())
    conf.update(name="resnet20-dummy", image_hw=16)
    (pb / "configs" / "resnet20-dummy.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "ring16_b32.json").read_text())
    mix.update(nodes=4, batch=8)
    (pb / "traffic" / "ring4_b8.json").write_text(json.dumps(mix))
    (pb / "limits" / "dummy_cell.json").write_text(json.dumps(
        {"loss_gap": 1, "grad_gap": 1, "change_gap": 1}))
    (pb / "metrics" / "dummy_steps.py").write_text(
        "def read(stats):\n    return float(stats.steps)\n")
    bench["configs"].append({**bench["configs"][0], "name": "resnet20-dummy",
                             "file": "perfbench/configs/resnet20-dummy.json"})
    bench["workloads"].append({"name": "dummy_cell",
                               "config": "resnet20-dummy",
                               "traffic": "ring4_b8", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "loop", "moves": "step_ms",
                               "workloads": ["dummy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.resolve("dummy_cell", root=tmp_path)
    assert cell.config["image_hw"] == 16 and cell.mix["nodes"] == 4
    assert "dummy_steps" in [m["name"] for m in cell.per_layer]
    stats = harness.RunStats(steps=7, window_s=1.0, dispatch_s=0.5,
                             setup_s=1.0,
                             peak_bytes=0, flops_per_step=0.0, elements=0)
    assert cell.module("metrics", "dummy_steps").read(stats) == 7.0
    assert harness.resolve(CELLS[0], root=tmp_path).per_layer == [
        m for m in bench["per_layer"] if CELLS[0] in
        m.get("workloads", [CELLS[0]])]


def test_new_topology_is_a_file_alone(tmp_path):
    """A mix on a graph that the benchmark had no module for runs once its
    ``topology/<name>.py`` is added: the reference takes W from it, and a
    tiny run on the CPU comes out correct."""
    shutil.copytree(harness.ROOT / "perfbench", tmp_path / "perfbench")
    (tmp_path / "perfbench" / "topology" / "complete.py").write_text(
        "import numpy as np\n\n\ndef mixing(n):\n"
        "    return np.full((n, n), 1.0 / n)\n")
    cell = tiny.resnet_cell()
    cell.root = tmp_path
    cell.mix["topology"] = "complete"
    assert cell.topology.mixing(4)[0, 3] == 0.25
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result, numbers = harness.run_cell(cell, 11, 0.1, False,
                                           time.perf_counter(), device="cpu")
    finally:
        torch.set_num_threads(old)
    assert result["correct"], numbers


def test_cell_of_more_cards_is_refused(tmp_path):
    """No run spans more than one card yet: a cell that asks for four is
    refused before anything runs, and prints no result."""
    shutil.copytree(harness.ROOT / "perfbench", tmp_path / "perfbench")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({**bench["workloads"][0], "name": "four",
                               "chips": 4})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(harness.ROOT / "perfbench" / "limits" /
                f"{CELLS[0]}.json",
                tmp_path / "perfbench" / "limits" / "four.json")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "four", "--seed",
         "1", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=600, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "asks for 4 cards" in out.stderr
