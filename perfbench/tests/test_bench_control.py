"""The control of every cell, on the card at the cell's own size: the
reference one precision below the configuration's (TF32), put in the
program's place, fails the cell's limits. Run on the card with
``python -m pytest -m chip perfbench/tests``."""
import json

import pytest

from perfbench import harness

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name):
    cell = harness.resolve(name)
    seed = 2**31 + 101
    host = cell.traffic.batches(cell.mix, cell.config, seed)
    ref = harness.reference_readings(cell, seed, host, card)
    control = harness.reference_readings(cell, seed, host, card, tf32=True)
    gaps = harness.compare(control, ref)
    assert any(gaps[k] > cell.limits[k] for k in gaps), gaps
