"""The reference against the port at a tiny size on the CPU: a whole run
of each family comes out ``correct``, and with the program broken
underneath it does not."""
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _run(cell, trace=False):
    return harness.run_cell(cell, 2**31 + 3, 0.2, trace,
                            time.perf_counter(), device="cpu")


@pytest.mark.parametrize("make", [tiny.resnet_cell, tiny.mamba_cell],
                         ids=["resnet20", "mamba2"])
def test_sound_run_is_correct(make):
    result, numbers = _run(make(), trace=True)
    assert result["correct"], numbers
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "check"
    for value, limit in numbers.values():
        assert value < limit / 10


def _frozen(monkeypatch):
    from repro_torch.train.trainer import DecentralizedTrainer
    step = DecentralizedTrainer.step

    def unchanged(self, state, batch, *a, **k):
        return state, step(self, state, batch, *a, **k)[1]

    monkeypatch.setattr(DecentralizedTrainer, "step", unchanged)


def _half(monkeypatch):
    from repro_torch.runtime.base import Runtime
    compute = Runtime._stage_compute

    def half(self, state, batch):
        return compute(self, state,
                       tuple(a[:, :a.shape[1] // 2] for a in batch))

    monkeypatch.setattr(Runtime, "_stage_compute", half)


def _nomix(monkeypatch):
    from repro_torch.runtime.base import Runtime

    def identity(self, t_dev, t=None):
        return torch.eye(self.trainer.topology.n,
                         device=self.trainer.device)

    monkeypatch.setattr(Runtime, "_mixing_at", identity)


@pytest.mark.parametrize("fault", [_frozen, _half, _nomix],
                         ids=["state_unchanged", "half_batch", "no_mix"])
def test_broken_program_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, numbers = _run(tiny.resnet_cell())
    assert not result["correct"], numbers
    assert result["failed"] >= 1


def test_a_reading_that_is_not_a_number_fails():
    ref = {"loss": [1.0, 2.0], "grad": {"a": 1.0, "b": 2.0},
           "grad_raw": {"a": 1.0, "b": 1.0}, "change": {"a": 1.0, "b": 1.0}}
    got = {"loss": [1.0, float("nan")], "grad": {"a": float("nan"), "b": 2.0},
           "change": {"a": 1.0, "b": float("inf")}}
    assert harness.compare(got, ref) == {
        "loss_gap": float("inf"), "grad_gap": float("inf"),
        "change_gap": float("inf")}
    assert harness.compare(ref, ref) == {
        "loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
