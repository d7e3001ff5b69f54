"""The pinned decode (``pin_decode_cache``) in one process: a decode step on
the rank's stored cache blocks, at one rank, is ``mesh=None``'s bits; how
the decode builder takes the pin, the split and a ``cache_constraint``;
and the pinned decode's ``meta`` trace in the dry run.

* at one rank (a ('data', 'model') mesh of (1, 1) over a one-rank gloo
  group in this process), TinyLlama, gemma2-27b (window and softcaps),
  granite-moe-3b (experts), zamba2-7b (Mamba states and the shared
  block), the VLM (cross cache) and mamba2-130m, with the three split
  knobs off and on, and TinyLlama in bf16 under ``decode_lowp``: a [B,
  12] prefill and 3 decode steps give ``mesh=None``'s logits, argmax and
  cache blocks bit for bit, and the placement's tally counts 0 bytes of
  any cache leaf gathered (the same steps unpinned gather every layer's
  cache);
* ``cache_constraint``: the stored layout (``steps.
  pinned_cache_constraint``, the reference's ``lower_decode`` pin) is
  taken and pins the step, with or without ``pin_decode_cache``; any
  other layout raises, naming both;
* the dry run on a ``MeshShape`` of (2, 2): a pinned decode gathers no
  cache byte, its activations' collectives reach the wire, and a rank's
  temporaries fall.

The cuts and the numpy inputs are ``test_torch_decode_gloo``'s.  Run
alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_decode_split.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import InputShape
from repro_torch.launch import distributed, dryrun, sharding, steps
from repro_torch.launch import mesh as tmesh

from test_torch_decode_gloo import CASES, _decode, _numpy_inputs, _sc
from test_torch_tp_gloo import _one_thread

#: (case of test_torch_decode_gloo.CASES, StepConfig overrides) of the
#: one-rank runs, each with the knobs off and on
ONE_RANK = [("dense", {}), ("window", {}), ("experts", {}), ("hybrid", {}),
            ("cross", {}), ("ssm", {}),
            ("dense", dict(param_dtype=torch.bfloat16, decode_lowp=True))]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process and its (1, 1) mesh."""
    path = tmp_path_factory.mktemp("decode_one_rank") / "store"
    distributed.initialize(f"file://{path}", 1, 0, backend="gloo",
                           timeout_s=120)
    yield tmesh.make_debug_mesh((1, 1), ("data", "model"))
    distributed.shutdown()


@pytest.mark.parametrize("knobs", ["off", "all"])
@pytest.mark.parametrize("name,extra", ONE_RANK,
                         ids=[n + ("_lowp" if e else "") for n, e in ONE_RANK])
def test_one_rank_pinned_decode_is_bit_equal(name, extra, knobs, one_rank):
    inputs = _numpy_inputs(name)
    with _one_thread():
        want_logits, want_cache, _ = _decode(name, knobs, inputs, **extra)
        # the blocks as the rank stores them (at one rank, whole)
        logits, cache, fn = _decode(name, knobs, inputs, one_rank,
                                    gather=False, **extra)
    assert fn.pinned and (fn.split is not None) == (knobs == "all")
    assert len(logits) == len(want_logits)
    for g, w in zip(logits, want_logits):
        assert np.array_equal(g, w)
        assert np.array_equal(g.argmax(-1), w.argmax(-1))
    assert len(cache) == len(want_cache)
    for g, w in zip(cache, want_cache):
        assert np.array_equal(g, w)
    assert not any(fn.layout.placement.tally.caches.values())


@pytest.mark.parametrize("knobs", ["off", "all"])
def test_unpinned_decode_gathers_every_cache_leaf(knobs, one_rank):
    """The same steps with the pin off: bit-equal too, each layer's cache
    gathered on use (one rank: copies) and its block put back; with the
    knobs, the mixers' conv on ``conv_w``'s 'model' block of the whole
    conv state's channels."""
    inputs = _numpy_inputs("hybrid")
    with _one_thread():
        want = _decode("hybrid", knobs, inputs)[:2]
        logits, cache, fn = _decode("hybrid", knobs, inputs, one_rank,
                                    pin_decode_cache=False)
    assert not fn.pinned and (fn.split is not None) == (knobs == "all")
    if knobs == "all":
        assert fn.split.keep(("blocks", 0, "mixer", "conv_w"))
    assert all(np.array_equal(g, w) for g, w in zip(logits, want[0]))
    assert all(np.array_equal(g, w) for g, w in zip(cache, want[1]))
    gathered = fn.layout.placement.tally.caches
    # every leaf of each mamba layer and of the shared block, every step
    # (one rank receives 0 bytes, but each gather is counted)
    leaves = {path[-1] for path in gathered}
    assert {path[0] for path in gathered} == {"blocks", "shared_attn"}
    assert leaves == {"conv", "ssm", "k", "v", "slot_pos"}


# ---------------------------------------------------------------------------
# the builder: the pin and the cache constraint
# ---------------------------------------------------------------------------

def test_cache_constraint_equal_to_the_stored_layout_pins(one_rank):
    sc = _sc("window", "off", pin_decode_cache=False)
    assert not steps.build_decode_step(sc, mesh=one_rank).pinned
    layout = steps.Layout.make(sc, one_rank, kind="decode")
    stored = steps.pinned_cache_constraint(layout)
    # a layer's K [B, T, K, D]: the rows over 'data', the features over
    # 'model' (the reference's lower_decode builds the same pin)
    assert stored.spec == ("data", None, None, "model")
    for constraint in (stored, stored.spec, ("data", None, None, ("model",))):
        fn = steps.build_decode_step(sc, mesh=one_rank,
                                     cache_constraint=constraint)
        assert fn.pinned
    # the mesh may come with the constraint
    assert steps.build_decode_step(sc, cache_constraint=stored).pinned
    # no block keeps a K cache: nothing to pin
    ssm = steps.Layout.make(_sc("ssm", "off"), one_rank, kind="decode")
    assert steps.pinned_cache_constraint(ssm) is None


@pytest.mark.parametrize("constraint", [
    (None, "data", None, "model"), ("data", None, None, None),
    sharding.NamedSharding(tmesh.MeshShape((("data", 2), ("model", 2))),
                           ("data", None, None, "model"))])
def test_other_cache_constraint_raises_naming_both(constraint, one_rank):
    sc = _sc("dense", "off")
    got = getattr(constraint, "spec", constraint)
    with pytest.raises(ValueError) as err:
        steps.build_decode_step(sc, mesh=one_rank,
                                cache_constraint=constraint)
    text = str(err.value)
    assert str(got) in text and "('data', None, None, 'model')" in text
    with pytest.raises(ValueError, match="is not the layout"):
        steps.build_decode_step(sc, cache_constraint=("data", None, None,
                                                      "model"))
    with pytest.raises(ValueError, match="None"):
        steps.build_decode_step(_sc("ssm", "off"), mesh=one_rank,
                                cache_constraint=got)


# ---------------------------------------------------------------------------
# the dry run on meta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dense", "long", "hybrid", "cross"])
def test_dry_run_traces_the_pinned_decode_on_meta(name):
    """A rank's trace on a ``MeshShape`` of (2, 2), a 4096-slot cache: the
    pinned decode gathers the weights but no cache byte, its collectives
    over the blocks' axes reach the wire, and its temporaries are below
    the gathering decode's."""
    plan = sharding.make_plan(tmesh.MeshShape((("data", 2), ("model", 2))),
                              n_nodes=1)
    sc = dataclasses.replace(_sc(name, "all", pin_decode_cache=False),
                             shape=InputShape("tiny_decode", 4096,
                                              CASES[name][1], "decode"))
    pinned = dryrun.trace_step(dataclasses.replace(
        sc, pin_decode_cache=True), plan)
    whole = dryrun.trace_step(sc, plan)
    # the unpinned decode holds its rows of the [B, 1] int32 token where
    # they divide (the reference's batch_specs over 'data' 2), the pinned
    # one all of it
    b = CASES[name][1]
    assert pinned["argument"] == whole["argument"] + (
        b * 4 // 2 if b % 2 == 0 else 0)
    if name == "hybrid":
        # zamba2's caches (the window's 8 slots, the Mamba states) are
        # smaller than a layer's gathered weights, which set both peaks;
        # they differ by the activations of the rows the gathering decode
        # leaves to the other 'data' rank (the pinned one computes all but
        # their attention)
        assert abs(pinned["temp"] - whole["temp"]) < 0.01 * whole["temp"]
    else:
        assert pinned["temp"] < whole["temp"]
    assert pinned["wire"]["all-gather"] < whole["wire"]["all-gather"]
    assert pinned["wire"]["all-reduce"] > 0
