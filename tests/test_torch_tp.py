"""The compute split over 'model' in one process: ``repeat_kv`` against the
JAX package, the split step at one 'model' rank bit-equal to the unsplit
one, how ``sharding.Split.make`` resolves the knobs, and the split's
``meta`` trace in the dry run.

* ``attention.chunked_attention(repeat_kv=True)``: the same values as the
  grouped product, bit for bit; K/V's gradient within 1e-6 of its largest
  entry (the G copies summed after the products); within 2e-6 of the JAX
  package's;
* at one rank (a ('data', 'model') mesh of (1, 1) over a one-rank gloo
  group in this process), ``megatron_attn``, ``shard_activations`` and
  ``pin_moe_dispatch`` alone and all three at once go through the split
  (each collective of one rank) and give the ``mesh=None`` step's 3 losses,
  final params and m_hat bit for bit, under ``remat`` full and none, and
  the prefill's logits and caches bit for bit; with the knobs off the step
  keeps the gathers on use (no split);
* the Mamba-2 and cross blocks under the split (``test_torch_tp_ssm_gloo``'s
  zamba2, mamba2-130m and VLM cuts): at one rank with the three knobs, 3
  train steps (losses, final params and m_hat) and the prefill (logits,
  the SSM and conv states, the shared block's and the image's K/V) bit for
  bit against ``mesh=None``, no leaf the split computes with gathered;
* ``Split.make`` on the production mesh: each knob on where the config's
  dims divide over 'model' (16), the attention heads wherever the config
  has some (GSPMD's padded split where they do not divide), the SSM heads
  where they divide (the blocks a knob leaves whole named), and which
  leaves the split keeps;
* the dry run on ``meta``: with the knobs on, a rank's temporaries and
  flops fall, the activations' collectives reach the wire, and the record's
  ``ignored`` list holds ``unroll`` alone; the decode builder takes the
  split, a paged step refuses one.

The model cut and the numpy inputs are ``test_torch_tp_gloo``'s (the same
cut across gloo ranks).  Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_tp.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro_torch.configs import ARCHS as TARCHS, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import distributed, dryrun, sharding, steps
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves, tree_paths

from test_torch_tp_gloo import (ALL, ARCHS, _cfg, _numpy_inputs, _one_thread,
                                _prefill, _prefill_knobs, _train)
from test_torch_tp_ssm_gloo import ARCHS as SSM_ARCHS
from test_torch_tp_ssm_gloo import _cfg as _ssm_cfg
from test_torch_tp_ssm_gloo import _numpy_inputs as _ssm_inputs
from test_torch_tp_ssm_gloo import _prefill as _ssm_prefill
from test_torch_tp_ssm_gloo import _train as _ssm_train

#: (arch, knobs, remat) of the one-rank train runs
ONE_RANK = [("tinyllama-1.1b", {}, "full"),
            ("tinyllama-1.1b", dict(megatron_attn=True), "full"),
            ("tinyllama-1.1b", dict(shard_activations=True), "full"),
            ("granite-moe-3b-a800m", dict(pin_moe_dispatch=True), "full"),
            ("tinyllama-1.1b", ALL, "full"),
            ("tinyllama-1.1b", ALL, "none"),
            ("granite-moe-3b-a800m", ALL, "full")]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process, its (1, 1) mesh and the
    numpy inputs."""
    path = tmp_path_factory.mktemp("tp_one_rank") / "store"
    distributed.initialize(f"file://{path}", 1, 0, backend="gloo",
                           timeout_s=120)
    mesh = tmesh.make_debug_mesh((1, 1), ("data", "model"))
    yield mesh, {arch: _numpy_inputs(arch) for arch in ARCHS}
    distributed.shutdown()


# ---------------------------------------------------------------------------
# repeat_kv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,skip", [(0, False), (12, True)])
def test_repeat_kv_keeps_the_values(window, skip):
    rng = np.random.default_rng(5)
    b, s, h, kh, d = 2, 32, 4, 2, 16
    q, k, v = (rng.standard_normal((b, s, n, d)).astype(np.float32)
               for n in (h, kh, kh))
    up = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kw = dict(causal=True, window=window, chunk=8, skip_masked_chunks=skip)

    def run(repeat):
        t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = attention.chunked_attention(*t, repeat_kv=repeat, **kw)
        (out * torch.from_numpy(up)).sum().backward()
        return out.detach(), [a.grad for a in t]

    (plain, g_plain), (rep, g_rep) = run(False), run(True)
    assert torch.equal(plain, rep)
    for a, b_ in zip(g_plain, g_rep):   # relative to the largest entry
        assert (b_ - a).abs().max() <= 1e-6 * a.abs().max()
    want = jattention.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), repeat_kv=True, **kw)
    np.testing.assert_allclose(rep.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)


# ---------------------------------------------------------------------------
# one 'model' rank: the split's bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,knobs,remat", ONE_RANK)
def test_one_rank_split_is_bit_equal(arch, knobs, remat, one_rank):
    mesh, inputs = one_rank
    knobs = dict(knobs, remat=remat)
    with _one_thread():
        want_l, want, _ = _train(arch, knobs, inputs)
        got_l, got, step = _train(arch, knobs, inputs, mesh)
    assert np.array_equal(got_l, want_l)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), i
    sp = step.split
    if not any(knobs.get(k) for k in ALL):
        assert sp is None and step.layout.placement is not None
        return
    assert (sp.heads, sp.features, sp.experts) == (
        knobs.get("megatron_attn", False),
        knobs.get("shard_activations", False),
        knobs.get("pin_moe_dispatch", False) and _cfg(arch).moe is not None)
    assert sp.size == 1 and sp.index == 0
    # one rank's collectives receive nothing, and no kept leaf is gathered
    assert all(b == 0 for b in sp.tally.wire.values()) and sp.tally.wire
    assert not any(sp.keep(p) for p in step.layout.placement.tally.leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_split_prefill_is_bit_equal(arch, one_rank):
    """The last logits, the routes and the caches."""
    mesh, inputs = one_rank
    knobs = _prefill_knobs(arch)
    with _one_thread():
        want, want_routes = _prefill(arch, knobs, inputs)
        got, routes = _prefill(arch, knobs, inputs, mesh)
        sc = steps.StepConfig(cfg=_cfg(arch), shape=InputShape(
            "tiny_prefill", 32, 2, "prefill"), n_nodes=1, chunk=8,
            param_dtype=torch.float32, **knobs)
        params = tf.init_lm(torch.Generator().manual_seed(3), sc.cfg)
        tokens = torch.from_numpy(inputs[arch]["batch"]["tokens"][0]).long()
        want_cache = steps.build_prefill_step(sc)(params, tokens)[1]
        fn = steps.build_prefill_step(sc, mesh=mesh)
        cache = fn(params, tokens)[1]
    assert np.array_equal(got, want)
    assert len(routes) == len(want_routes)
    assert all(np.array_equal(a, b) for a, b in zip(routes, want_routes))
    assert fn.split is not None and fn.split.heads
    lay = fn.layout
    cache = sharding.gather_tree(lay.plan, lay.specs["cache"], cache)
    for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_one_rank_ssm_cross_split_is_bit_equal(arch, one_rank):
    """The mamba and cross blocks on the rank's blocks, train and
    prefill."""
    mesh, _ = one_rank
    inputs = {arch: _ssm_inputs(arch)}
    with _one_thread():
        want_l, want, _ = _ssm_train(arch, inputs)
        got_l, got, step = _ssm_train(arch, inputs, mesh)
        want_logits, want_cache, _ = _ssm_prefill(arch, inputs)
        logits, cache, fn = _ssm_prefill(arch, inputs, mesh)
    assert np.array_equal(got_l, want_l)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), i
    assert np.array_equal(logits, want_logits)
    assert len(cache) == len(want_cache)
    for i, (g, w) in enumerate(zip(cache, want_cache)):
        assert np.array_equal(g, w), i
    cfg = _ssm_cfg(arch)
    for sp in (step.split, fn.split):
        assert sp.ssm == ("mamba" in cfg.period) and sp.features
        assert sp.heads == ("cross" in cfg.period
                            or bool(cfg.shared_attn_every))
        assert all(b == 0 for b in sp.tally.wire.values()) and sp.tally.wire
    # the train step's nodes take no axis: a kept leaf has no gather at all
    # (the prefill's gathers its blocks over the FSDP 'data' axis)
    assert not any(step.split.keep(p)
                   for p in step.layout.placement.tally.leaves)


def test_split_refuses_decode(one_rank):
    """The decode builder takes the split (its weight products split over
    'model' as the prefill's); a paged step still refuses one."""
    mesh, _ = one_rank
    sc = steps.StepConfig(cfg=_cfg("tinyllama-1.1b"), shape=InputShape(
        "tiny_decode", 8, 1, "decode"), n_nodes=1, chunk=8,
        param_dtype=torch.float32, **ALL)
    fn = steps.build_decode_step(sc, mesh=mesh)
    assert fn.split is not None and fn.split.heads and fn.split.features
    params = tf.init_lm(torch.Generator().manual_seed(3), sc.cfg)
    token = torch.zeros((1, 1), dtype=torch.long)
    want, _ = tf.decode_step(params, token, 0,
                             tf.init_cache(sc.cfg, 1, 8, device="cpu"),
                             sc.cfg)
    got, _ = fn(params, token, 0, tf.init_cache(sc.cfg, 1, 8, device="cpu"))
    assert torch.equal(got, want)
    pages = tf.init_paged_cache(sc.cfg, 2, 4, device="cpu")
    with pytest.raises(ValueError, match="not a 'paged' forward"):
        tf.forward(fn.layout.local("params", params), token, sc.cfg,
                   mode="paged", cache=pages,
                   placement=fn.layout.placement, split=fn.split)


# ---------------------------------------------------------------------------
# Split.make on the production mesh
# ---------------------------------------------------------------------------

def _production_split(arch, kind="prefill", **knobs):
    cfg = get_config(arch)
    sc = steps.StepConfig(cfg=cfg, shape=InputShape(f"p_{kind}", 4096, 16,
                                                    kind),
                          n_nodes=1, **knobs)
    lay = steps.Layout.make(sc, tmesh.make_production_mesh(device="meta"),
                            kind=kind)
    return steps.make_split(sc, lay), cfg


@pytest.mark.parametrize("arch", TARCHS)
def test_split_make_resolves_each_knob_by_divisibility(arch):
    sp, cfg = _production_split(arch, **ALL)
    m = 16
    # the attention heads wherever the config has some (mamba2-130m has
    # none), any head count: GSPMD's padded split where 'model' does not
    # divide them (granite and musicgen's 24, arctic's 56); the SSM heads
    # where they divide
    heads = cfg.n_heads > 0
    ssm = cfg.ssm is not None and cfg.ssm.n_heads(cfg.d_model) % m == 0
    assert sp.heads == heads
    assert sp.ssm == ssm
    assert sp.features == (cfg.d_model % m == 0)
    assert sp.vocab == sp.features            # every vocabulary divides
    assert sp.experts == (cfg.moe is not None and cfg.moe.n_experts % m == 0)
    assert sp.size == 16 and sp.index == 0 and sp.residual == "S"
    if heads:   # rank 0 (a dry run's trace) holds the most heads
        c = -(-cfg.n_heads // m)
        assert sp.head_range() == (0, c)
        assert [sp.head_range(rank=r)[1] for r in range(m)] == [
            min(c, max(0, cfg.n_heads - r * c)) for r in range(m)]
    # the blocks a knob leaves whole, by name: a mixer's alone
    assert [w.split(":")[0] for w in sp.whole] == (
        ["mamba"] if cfg.ssm is not None and not ssm else [])
    # which leaves it keeps: a self- or cross-attention's under heads, a
    # mixer's under ssm, the MLP's, the norms' and the vocabulary's under
    # features, the experts' under experts; never a conv, a gate or the
    # router
    pl = sp.placement
    for path in tree_paths(pl.params):
        d, name = pl.model_dim(path), path[-1]
        parent = path[-2] if len(path) > 1 else None
        if name in ("router", "conv_w", "gate_attn", "gate_mlp"):
            want = False
        elif parent in ("attn", "xattn"):
            want = heads and d is not None
        elif parent == "mixer":
            want = ssm and d is not None
        elif parent in ("mlp", "dense") or name in ("ln", "ln1", "ln2",
                                                    "final_norm"):
            want = sp.features and d is not None
        elif name in ("embed", "lm_head"):
            want = sp.vocab
        else:
            want = sp.experts and d == -3
        assert sp.keep(path) == want, path
    sc_off = steps.StepConfig(cfg=cfg, shape=InputShape("x", 8, 1,
                                                        "prefill"),
                              n_nodes=1)
    assert steps.make_split(sc_off, steps.Layout.make(
        sc_off, tmesh.make_production_mesh(device="meta"),
        kind="prefill")) is None


def test_ignored_knobs_are_the_scan_and_decode_pins():
    """``pin_decode_cache`` pins a decode to the cache blocks
    (``test_torch_decode_split``): the scan's ``unroll`` alone is left."""
    assert steps.IGNORED_KNOBS == ("unroll",)


# ---------------------------------------------------------------------------
# the dry run on meta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_traces_the_split_on_meta(arch):
    """A rank's trace on a ``MeshShape`` of 'model' 4: the collectives give
    the shapes alone, so the temporaries and the flops are the split's."""
    sc = steps.StepConfig(cfg=_cfg(arch), shape=InputShape(
        "tiny_train", 32, 4, "train"), n_nodes=2, chunk=8, ssd_chunk=8)
    plan = sharding.make_plan(tmesh.MeshShape((("data", 1), ("model", 4))),
                              n_nodes=2)
    split = dryrun.trace_step(dataclasses.replace(sc, **ALL), plan)
    whole = dryrun.trace_step(sc, plan)
    assert split["argument"] == whole["argument"]
    assert split["temp"] < whole["temp"]
    assert split["flops"] < whole["flops"]
    assert split["wire"]["all-reduce"] > 0
    assert split["wire"]["reduce-scatter"] > 0
    assert "all-reduce" not in whole["wire"]


def test_dry_run_record_takes_the_knobs(tmp_path):
    """``--set`` reaches the builders; the record's ``ignored`` list is the
    one knob with no counterpart."""
    shape = InputShape("tiny_prefill", 32, 2, "prefill")
    mesh = tmesh.MeshShape((("data", 1), ("model", 4)))
    rec = dryrun.run_combo(
        "tinyllama-1.1b", shape.name, "tiny", out_dir=str(tmp_path),
        cfg=_cfg("tinyllama-1.1b"), shape=shape, mesh=mesh, full_only=True,
        overrides=dict(ALL, chunk=8))
    assert rec["ignored"] == ["unroll"]
    assert rec["overrides"]["megatron_attn"] == "True"
    assert rec["fits"] is True
