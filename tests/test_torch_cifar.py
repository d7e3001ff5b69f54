"""chip_smoke's CIFAR constants against the JAX package.

``CIFAR_REF``: the JAX package's test accuracy on
``cifar_ring16_alpha0.1_qg`` (60 steps, ResNet-20 EvoNorm, 16 nodes) for
QG-DSGDm-N at seeds 0, 1 and 2 and DSGDm-N at seed 0, each rerun here the
way ``repro.api.run`` runs it (``run_training`` from the built state, then
``_evaluate``), with one compiled step an optimizer for all its seeds
(the seed changes the data and the init, not the step): within 1e-3 (4
of the 4096 per-node eval decisions; a count on this CPU, which another
CPU's XLA may round differently), as chip_smoke's ZOO_PRESETS are held.
chip_smoke's QG band is that seed range widened by ACC_ATOL.
"""
import importlib.util
from pathlib import Path

import jax
import pytest

from repro import api as japi
from repro.api.build import _evaluate
from repro.train import run_training

ROOT = Path(__file__).resolve().parents[1]
PRESET = "cifar_ring16_alpha0.1_qg"


def _load_chip_smoke():
    """chip_smoke.py as a module (its import runs nothing)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load_chip_smoke()


@pytest.fixture(scope="module")
def trainers():
    """The reference's trainer of each optimizer, built once, so that its
    jitted step compiles once for every seed."""
    return {}


@pytest.mark.parametrize("method,seed", sorted(chip_smoke.CIFAR_REF))
def test_chip_smoke_cifar_constants_are_the_reference_s(method, seed,
                                                        trainers):
    spec = japi.presets.get(PRESET).override(f"optim.name={method}",
                                             f"seed={seed}")
    ex = japi.build(spec)
    trainer = trainers.setdefault(method, ex.trainer)
    state, _ = run_training(trainer, ex.state, ex.task.make_iter(),
                            spec.loop.steps, rng=jax.random.PRNGKey(0),
                            log_fn=lambda *_: None)
    acc = _evaluate(trainer, state, ex.bundle.eval_fn,
                    ex.task.eval_batches)["acc"]
    assert abs(acc - chip_smoke.CIFAR_REF[(method, seed)]) <= 1e-3


def test_chip_smoke_cifar_band_is_the_seed_range_widened():
    qg = [v for (m, _), v in chip_smoke.CIFAR_REF.items()
          if m == "qg_dsgdm_n"]
    assert len(qg) == 3
    lo, hi = chip_smoke.CIFAR_QG_BAND
    assert (lo, hi) == (min(qg) - chip_smoke.ACC_ATOL,
                        max(qg) + chip_smoke.ACC_ATOL)
    assert chip_smoke.CIFAR_REF[("dsgdm_n", 0)] < lo
