"""Decentralized LM training in the port on the CPU against the JAX package:
``layers.cross_entropy``, ``transformer.train_loss``, ``make_lm_domains``
and the ``lm_domains`` task, the ``transformer`` plugin (one node's loss
mapped over the node axis with ``torch.func.vmap``), the preset
``lm100m_ring8_alpha0.1_qg`` at a reduced size through ``api.run``, the
consensus export from an ``api.Result`` and its serving, and the
``launch/train.py`` launcher.  Both packages get the same numpy inputs and
the reference's own init (``repro_torch.interop``).

The reduced model: 2 layers, d_model 64, 4 heads over 2 KV heads, head_dim
16, vocab 128, seq 16, batch 2, 4 nodes.

Tolerances, each with its reason:
* cross-entropy: 2e-6 abs on values of order 5 (the same fp32 ops, summed
  in another order);
* per-node losses: rtol 1e-5 (two layers of matrix products in two BLAS
  libraries, whose sums run in other orders); gradients: rtol 1e-5 and an
  atol of 1e-5 times the leaf's largest entry, since each entry is a sum
  over the batch of terms as large as that (the embedding's gradient,
  whose entries reach 2.7, is 2.5e-6 apart where two terms cancel);
* a 4-step run: the history's loss and grad norm within rtol 1e-5, its
  consensus distance (a small difference of large params) within rtol
  1e-4, the final params within atol 1e-6 (the gradient differences above,
  times lr 0.02);
* the reference's forward of the port's export against the port's: 1e-4
  abs on logits of order 5 (tests/test_torch_lm.py's bound).
"""
import argparse
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
from repro.api import data as jdata
from repro.api import models as jmodels
from repro.data import synthetic as jsyn
from repro.launch import train as jlaunch
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serve import export as jexport
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.api import data as tdata
from repro_torch.api import models as tmodels
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.serve import export as texport
from repro_torch.tree import tree_flatten, tree_leaves, tree_paths, \
    tree_unflatten

PRESET = "lm100m_ring8_alpha0.1_qg"
SMALL = {"name": "lm-small", "n_layers": 2, "d_model": 64, "n_heads": 4,
         "n_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 128,
         "mesh_divisor": 1}
SMALL_SET = ("model.kwargs.overrides=" + json.dumps(SMALL), "data.seq_len=16",
             "topology.n=4", "loop.log_every=1")
CE_TOL = dict(atol=2e-6, rtol=0)
LOSS_RTOL = GRAD_RTOL = 1e-5
LOGIT_TOL = dict(atol=1e-4, rtol=0)
QUIET = dict(log_fn=lambda *_: None)
ROOT = Path(__file__).resolve().parents[1]


def _small_spec(*overrides):
    return japi.presets.get(PRESET).override(*SMALL_SET, *overrides)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_grads_close(got, want):
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max())


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab_valid", [None, 128, 100])
def test_cross_entropy_matches_reference(vocab_valid):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 16, 128)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab_valid or 128, size=(2, 16)).astype(
        np.int32)
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 vocab_valid)
    got = tlayers.cross_entropy(_t(logits), _t(labels), vocab_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CE_TOL)


@pytest.mark.parametrize("arch,fwd_kw", [
    ("tinyllama-1.1b", {"chunk": 128}),
    ("tinyllama-1.1b", {"chunk": 8}),     # two KV chunks a sequence
    ("mamba2-130m", {"ssd_chunk": 8}),    # the plain SSD scan, 2 chunks
])
def test_train_loss_and_grads_match_reference_per_node(arch, fwd_kw):
    """Distinct params a node: each node's loss and gradient from the
    plugin equal ``jax.vmap(jax.value_and_grad(train_loss))``'s, so the
    plugin's vmap mixes no nodes; the attention's loop over KV chunks and
    the Mamba-2 mixer run under it too."""
    n = 4
    spec = _small_spec()
    if arch == "tinyllama-1.1b":
        spec = spec.override(f"model.kwargs.chunk={fwd_kw['chunk']}")
    else:
        spec = spec.override("model.kwargs=" + json.dumps(
            {"arch": arch, "reduced": True, **fwd_kw}))
    jcfg = jmodels.resolve_transformer_config(spec.model)
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    stacked = jax.jit(jax.vmap(lambda k: jtf.init_lm(k, jcfg)))(keys)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(n, 2, 17)).astype(np.int32)

    def one(p, t):
        return jtf.train_loss(p, {"tokens": t[:, :-1], "labels": t[:, 1:]},
                              jcfg, **fwd_kw)
    want_l, want_g = jax.jit(jax.vmap(jax.value_and_grad(one)))(
        stacked, jnp.asarray(toks))

    tspec = tapi.ExperimentSpec.from_json(spec.to_json())
    task = tdata.build_task(tspec, n)
    bundle = tmodels.MODELS["transformer"](tspec, task)
    params = interop.params_from_numpy(
        jax.tree.map(np.asarray, stacked), "cpu")
    leaves, treedef = tree_flatten(params)
    leaves = [x.requires_grad_(True) for x in leaves]
    loss, _ = bundle.loss_fn(tree_unflatten(treedef, leaves), {},
                             (_t(toks),))
    grads = torch.autograd.grad(loss.sum(), leaves)
    assert loss.shape == (n,)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_l),
                               rtol=LOSS_RTOL)
    assert len(grads) == len(tree_leaves(params))
    _assert_grads_close(grads, jax.tree.leaves(want_g))


def test_unported_block_kind_is_refused_at_validate():
    """The MoE arch, once refused at validate, now validates and builds the
    plugin: each node's loss is finite and carries the balance loss."""
    spec = tapi.presets.get(PRESET).override("model.kwargs=" + json.dumps(
        {"arch": "granite-moe-3b-a800m", "reduced": True}), *SMALL_SET[1:])
    assert spec.validate() is spec
    task = tdata.build_task(spec, 4)
    bundle = tmodels.MODELS["transformer"](spec, task)
    one, _ = bundle.init_fn(torch.Generator().manual_seed(0))
    assert "moe" in one["blocks"][0]
    leaves, treedef = tree_flatten(one)
    params = tree_unflatten(treedef, [torch.stack([x] * 4) for x in leaves])
    (toks,) = next(task.make_iter())
    loss, _ = bundle.loss_fn(params, {}, (_t(toks),))
    assert loss.shape == (4,) and torch.isfinite(loss).all()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_lm_domains_and_batches_bit_equal_reference():
    kw = dict(vocab=64, seq_len=12, n_seq_per_domain=9, seed=4)
    want = jsyn.make_lm_domains(3, **kw)
    got = tsyn.make_lm_domains(3, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    parts = [np.arange(0, 9), np.arange(9, 27)]
    jds = jsyn.ClientDataset((want[0],), parts, batch=4, seed=1)
    tds = tsyn.ClientDataset((got[0],), parts, batch=4, seed=1)
    for (w,), (g,) in zip(jsyn.iterate_client_batches(jds, 5),
                          tsyn.iterate_client_batches(tds, 5)):
        assert np.array_equal(g, w)


def test_lm_task_equals_reference():
    spec = _small_spec()
    want = jdata.build_task(spec, 4)
    got = tdata.build_task(tapi.ExperimentSpec.from_json(spec.to_json()), 4)
    assert got.meta == want.meta
    assert got.meta["vocab"] == 128
    assert got.eval_batches == want.eval_batches == ()
    wi, gi = want.make_iter(), got.make_iter()
    for _ in range(3):
        (w,), (g,) = next(wi), next(gi)
        assert g.shape == (4, 2, 17) and np.array_equal(g, w)


def test_full_preset_config_and_vocab_equal_reference():
    spec = japi.presets.get(PRESET)
    tspec = tapi.ExperimentSpec.from_json(spec.to_json())
    assert tspec == tapi.presets.get(PRESET)
    assert tspec.to_dict() == spec.to_dict()
    got = tmodels.resolve_transformer_config(tspec.model)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jmodels.resolve_transformer_config(spec.model))
    assert tmodels.model_vocab(tspec) == jmodels.model_vocab(spec) == 8192
    like = ttf.init_lm(None, got, device="meta")
    assert sum(x.numel() for x in tree_leaves(like)) == 62_927_616
    assert len(tree_leaves(like)) == 12 and like["tail"] == ()


# ---------------------------------------------------------------------------
# the run, its export and its serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def injected_run():
    """4 steps of the reduced preset in both packages from the
    reference's init; the port's final state beside its Result."""
    spec = _small_spec("loop.steps=4", "loop.chunk=2")
    ref, ref_state = japi.run(spec, with_state=True, **QUIET)
    init = jax.tree.map(np.asarray, japi.build(spec).state.params)
    tspec = tapi.ExperimentSpec.from_json(spec.to_json())
    params = interop.params_from_numpy(init, "cpu")
    opt_state = tapi.build(tspec, device="cpu").trainer.optimizer.init(params)
    state = interop.train_state_from_numpy(init, opt_state, 0, "cpu")
    got, got_state = tapi.run(tspec, device="cpu", state=state,
                              with_state=True, **QUIET)
    return spec, ref, ref_state, got, got_state


def test_reduced_run_matches_reference(injected_run):
    _, ref, ref_state, got, got_state = injected_run
    assert got.steps_run == ref.steps_run == 4
    for g, w in zip(got.history, ref.history, strict=True):
        assert g["step"] == w["step"]
        for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-5),
                        ("consensus", 1e-4), ("lr", 0)):
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)
    assert got.wire == ref.wire
    assert got.heterogeneity == ref.heterogeneity
    want = jax.tree.leaves(ref_state.params)
    assert len(want) == len(tree_leaves(got_state.params))
    for g, w in zip(tree_leaves(got_state.params), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    assert got_state.params["tail"] == ()
    assert sorted(got_state.opt_state) == sorted(ref_state.opt_state)


def test_export_from_result_is_node_mean_and_served_by_reference(
        injected_run, tmp_path):
    spec, _, _, got, got_state = injected_run
    with pytest.raises(ValueError, match="state="):
        texport.export_consensus(got)
    params, cfg = texport.export_consensus(got, state=got_state)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jmodels.resolve_transformer_config(spec.model))
    for g, x in zip(tree_leaves(params), tree_leaves(got_state.params)):
        assert torch.equal(g, torch.mean(x, dim=0))
    path = str(tmp_path / "lm.npz")
    texport.save_serving_checkpoint(path, params, cfg)
    jparams, jcfg = jexport.load_serving_checkpoint(path)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    toks = np.random.default_rng(6).integers(0, 128, size=(2, 16))
    want, _, _ = jtf.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg,
                             mode="train")
    got_logits, _, _ = ttf.forward(params, _t(toks), cfg, mode="train")
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want),
                               **LOGIT_TOL)


def test_export_cli_and_serve_checkpoint_in_process(tmp_path, capsys):
    from repro_torch.api.__main__ import main as api_main
    from repro_torch.serve.__main__ import main as serve_main

    path = str(tmp_path / "lm.npz")
    args = [PRESET, "--device", "cpu", "--export-consensus", path]
    for o in SMALL_SET + ("loop.steps=2", "loop.chunk=2"):
        args += ["--set", o]
    assert api_main(args) == 0
    assert "consensus serving checkpoint -> " + path in capsys.readouterr().out
    params, cfg = texport.load_serving_checkpoint(path, device="cpu")
    assert cfg.name == "lm-small" and params["tail"] == ()
    row = serve_main(["--checkpoint", path, "--device", "cpu",
                      "--requests", "3", "--max-new", "4"])
    assert row["arch"] == "lm-small" and row["mode"] == "engine"
    assert row["requests"] == 3 and row["tokens_per_s"] > 0
    with pytest.raises(SystemExit, match="only transformer models"):
        api_main(["quickstart_ring16_alpha0.1_qg", "--device", "cpu",
                  "--set", "loop.steps=1", "--export-consensus",
                  str(tmp_path / "mlp.npz")])


# ---------------------------------------------------------------------------
# the launcher and the trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    {},
    {"arch": "mamba2-130m", "optimizer": "dsgdm_n", "topology": "exp",
     "nodes": 16, "alpha": 1.0, "steps": 7, "seed": 3},
])
def test_launcher_spec_equals_reference(flags):
    ns = dict(arch="tinyllama-1.1b", reduced=True, optimizer="qg_dsgdm_n",
              topology="ring", nodes=8, alpha=0.1, steps=200, batch=8,
              seq_len=64, lr=0.1, warmup=10, seed=0, log_every=10)
    ns.update(flags)
    want = jlaunch.build_spec(argparse.Namespace(**ns))
    got = tlaunch.build_spec(argparse.Namespace(**ns))
    assert got.to_json() == want.to_json()
    got.validate()


def test_launcher_trains_reduced_arch_and_refuses_mesh(tmp_path):
    ckpt = str(tmp_path / "run.npz")
    history = tlaunch.main(["--nodes", "2", "--steps", "2", "--batch", "2",
                            "--seq-len", "8", "--device", "cpu",
                            "--log-every", "1", "--checkpoint", ckpt,
                            "--set", "model.kwargs=" + json.dumps({
                                "arch": "tinyllama-1.1b", "reduced": True,
                                "chunk": 256, "overrides": {
                                    "d_model": 32, "n_heads": 2,
                                    "n_kv_heads": 1, "head_dim": 16,
                                    "d_ff": 64, "vocab_size": 64}})])
    assert len(history) == 2 and np.isfinite(history[-1]["loss"])
    assert (tmp_path / "run.npz").exists()
    # no --mesh flag, as the reference launcher has none: argparse refuses
    # it (the mesh modes are the dry run's, launch/dryrun.py --mesh)
    with pytest.raises(SystemExit) as refused:
        tlaunch.main(["--mesh", "single", "--device", "cpu"])
    assert refused.value.code == 2
    history = tlaunch.main(["--arch", "granite-moe-3b-a800m", "--nodes", "2",
                            "--steps", "1", "--batch", "1", "--seq-len",
                            "8", "--device", "cpu"])
    assert len(history) == 1 and np.isfinite(history[-1]["loss"])


def test_reference_lm_state_carries_across_as_tuples():
    """The reference's node-stacked LM params and QG state (dicts, with
    tuples for ``blocks``/``tail``) carry across unchanged in structure,
    and the port's trees rebuild them, empty ``tail`` included."""
    spec = _small_spec()
    ex = japi.build(spec)
    params = jax.tree.map(np.asarray, ex.state.params)
    opt = jax.tree.map(np.asarray, ex.state.opt_state)
    state = interop.train_state_from_numpy(params, opt, 5, "cpu")
    assert isinstance(state.params["blocks"], tuple)
    assert state.params["tail"] == () and int(state.t) == 5
    for tree, want in ((state.params, params), (state.opt_state, opt)):
        got, treedef = tree_flatten(tree)
        assert [g.shape for g in got] == [w.shape for w in
                                          jax.tree.leaves(want)]
        for g, w in zip(got, jax.tree.leaves(want)):
            assert np.array_equal(g.numpy(), w)
        rebuilt = tree_unflatten(treedef, got)
        assert jax.tree.structure(jax.tree.map(lambda _: 0, rebuilt)) == \
            jax.tree.structure(jax.tree.map(lambda _: 0, want))


def test_chip_smoke_lm_hold_draws_one_init_for_both_packages():
    """chip_smoke's ``lm`` hold: ``lm_numpy_init`` sees the same leaves, in
    the same order and shapes, through the port's tree and the reference's
    (``scripts/lm_ref.py`` walks the latter), and ``LM_REF`` names every
    leaf of the cut model."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    jspec = cs.lm_ref_spec(japi.presets.get(PRESET))
    tspec = cs.lm_ref_spec(tapi.presets.get(PRESET))
    assert tspec.to_dict() == jspec.to_dict()
    jcfg = jmodels.resolve_transformer_config(jspec.model)
    assert jcfg.n_layers == cs.LM_REF_LAYERS and jcfg.d_model == 768
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda k: jtf.init_lm(k, jcfg), jax.random.PRNGKey(0)))
    want = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             tuple(x.shape)) for p, x in flat]
    like = ttf.init_lm(None, tmodels.resolve_transformer_config(tspec.model),
                       device="meta")
    got = [(p, tuple(x.shape)) for p, x in zip(tree_paths(like),
                                               tree_leaves(like))]
    assert got == want
    assert set(cs.LM_REF["norms"]) == {"/".join(map(str, p))
                                       for p, _ in got}
    assert len(cs.LM_REF["loss"]) == cs.LM_REF_STEPS
    small = [(("blocks", 0, "attn", "wq"), (2, 8, 4)), (("embed",), (16, 8)),
             (("final_norm",), (8,))]
    a, b = cs.lm_numpy_init(small), cs.lm_numpy_init(small)
    assert all(np.array_equal(x, y) and x.dtype == np.float32
               for x, y in zip(a, b))
    assert not a[2].any() and abs(a[1].std() - 0.02) < 0.01
