"""Serving and training the rest of the LM stack through the port's entry
points, on the CPU against the JAX package: the engine against the
sequential path for reduced granite (the reference's ``tests/test_serve.py``
case), the VLM and ``--use-pallas`` through ``launch/serve.py``, zamba2
through the serving CLI's baseline, serving checkpoints of the new trees
written by either package, and the ``transformer`` training plugin on
reduced granite, the VLM and zamba2 against the JAX package's losses.

Tolerances: 1e-4 abs on logits (``tests/test_torch_lm.py``'s); the
training losses and gradient norms within rtol 1e-5, the consensus
distance 1e-4 (``tests/test_torch_lm_train.py``'s, for its reasons).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import serve as jserve
from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro.serve import export as jexport
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch import serve as tserve
from repro_torch.configs import get_config
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import train as tlaunch_train
from repro_torch.models import transformer as ttf
from repro_torch.serve import export as texport
from repro_torch.serve.__main__ import main as serve_main
from repro_torch.tree import tree_leaves
from test_torch_lmstack import LOGIT_TOL, _img, _t, _tokens, gated


def _granite(seed=3):
    jcfg = jget_config("granite-moe-3b-a800m", reduced=True)
    tcfg = get_config("granite-moe-3b-a800m", reduced=True)
    npp = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(seed),
                                               jcfg))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npp), \
        interop.params_from_numpy(npp, "cpu")


def test_moe_engine_matches_sequential_and_reference_engine():
    """Reduced granite through the engine (one slot, a prefill chunk of
    the prompt's length, so that the MoE's capacity, a function of the
    physical token count, is the dense prefill's) equals
    ``sequential_generate`` and the reference's engine, token for token,
    and a second run gives the same tokens (the gather combine)."""
    jcfg, tcfg, jp, tp = _granite()
    rng = np.random.default_rng(7)
    reqs = [tserve.Request(id=i, prompt=tuple(int(t) for t in rng.integers(
        0, tcfg.vocab_size, size=16)), max_new=4) for i in range(3)]
    kw = dict(n_slots=1, page_size=16, max_len=32, prefill_chunk=16)
    got = [o.tokens for o in tserve.ServeEngine(tp, tcfg, **kw).run(reqs)]
    again = [o.tokens for o in tserve.ServeEngine(tp, tcfg,
                                                  use_pallas=True,
                                                  **kw).run(reqs)]
    assert again == got
    want = [o.tokens for o in jserve.ServeEngine(jp, jcfg, **kw).run(
        [jserve.Request(id=r.id, prompt=r.prompt, max_new=r.max_new)
         for r in reqs])]
    assert got == want
    for r, g in zip(reqs, got):
        seq = tserve.sequential_generate(tp, tcfg, _t([r.prompt]),
                                         gen_len=4, cache_len=20)
        assert tuple(seq[0, 16:].tolist()) == g


@pytest.mark.parametrize("argv,want_pallas,want_img", [
    (["--arch", "llama-3.2-vision-11b", "--use-pallas"], True, True),
    (["--arch", "llama-3.2-vision-11b"], False, True),
    (["--arch", "tinyllama-1.1b", "--sequential", "--use-pallas"], True,
     False),
])
def test_launch_serve_sends_the_vlm_and_use_pallas_to_the_sequential_path(
        argv, want_pallas, want_img, monkeypatch):
    """A VLM takes the sequential path with a numpy image stub from
    ``--seed``, and ``--use-pallas`` reaches its prefill; the tokens are
    ``sequential_generate``'s on the same inputs."""
    seen = []
    real = ttf.prefill

    def spy(params, tokens, cfg, **kw):
        seen.append((kw.get("use_pallas"), kw.get("img")))
        return real(params, tokens, cfg, **kw)

    monkeypatch.setattr(ttf, "prefill", spy)
    toks = tlaunch.main([*argv, "--batch", "2", "--prompt-len", "8",
                         "--gen-len", "3", "--device", "cpu"])
    assert toks.shape == (2, 11)
    assert len(seen) == 1 and seen[0][0] is want_pallas
    img = seen[0][1]
    cfg = get_config(argv[1], reduced=True)
    if not want_img:
        assert img is None
        return
    assert img.shape == (2, cfg.n_image_tokens, cfg.d_model)
    stub = tlaunch.image_stub(cfg, 2, 0, "cpu")
    assert torch.equal(img, stub)
    rng = np.random.default_rng(0)
    assert np.array_equal(stub.numpy(), rng.standard_normal(
        (2, cfg.n_image_tokens, cfg.d_model), dtype=np.float32))
    params = ttf.init_lm(torch.Generator().manual_seed(0), cfg)
    want = tserve.sequential_generate(params, cfg, toks[:, :8], gen_len=3,
                                      cache_len=11, img=stub)
    assert torch.equal(toks, want)


def test_zamba2_serve_cli_baseline_and_engine_refusal():
    row = serve_main(["--arch", "zamba2-7b", "--baseline", "--requests", "3",
                      "--max-new", "3", "--use-pallas", "--device", "cpu"])
    assert row["mode"] == "sequential" and row["tokens_per_s"] > 0
    cfg = get_config("zamba2-7b", reduced=True)
    params = ttf.init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match="attention-only"):
        tserve.ServeEngine(params, cfg)
    assert not ttf.supports_paged(cfg)


@pytest.mark.parametrize("arch,over", [
    ("granite-moe-3b-a800m", {}),
    ("llama-3.2-vision-11b", {}),
    ("zamba2-7b", {"n_layers": 3, "tail_layers": 1}),
])
def test_serving_checkpoints_of_the_new_trees_cross_packages(arch, over,
                                                             tmp_path):
    """A serving checkpoint written by the JAX package loads in the port
    and gives the reference's logits; the port's own checkpoint of the
    same params loads in the reference leaf for leaf; the consensus of a
    node-stacked tree (0-d gates included) is its node mean."""
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), **over)
    npp = gated(jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(1),
                                                     jcfg)), jcfg)
    jp = jax.tree.map(jnp.asarray, npp)
    path = str(tmp_path / "ref.npz")
    jexport.save_serving_checkpoint(path, jp, jcfg)
    tp, tcfg = texport.load_serving_checkpoint(path, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    toks = _tokens(tcfg, 2, 12, seed=2)
    img = (np.random.default_rng(3).normal(
        size=(2, jcfg.n_image_tokens, jcfg.d_model)).astype(np.float32)
        if jcfg.n_image_tokens else None)
    want, _, _ = jtf.forward(jp, jnp.asarray(toks), jcfg, mode="train",
                             img=_img(img, "jax"))
    got, _, _ = ttf.forward(tp, _t(toks), tcfg, mode="train",
                            img=_img(img, "torch"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)

    mine = str(tmp_path / "port.npz")
    texport.save_serving_checkpoint(mine, tp, tcfg)
    back, bcfg = jexport.load_serving_checkpoint(mine)
    assert dataclasses.asdict(bcfg) == dataclasses.asdict(jcfg)
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert len(flat) == len(tree_leaves(tp))
    for (p, w), g in zip(flat, tree_leaves(tp)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), str(p))

    stacked = jax.tree.map(lambda a: np.stack([a, 2 * a]), npp)
    params, _ = texport.export_consensus(interop.params_from_numpy(stacked,
                                                                   "cpu"))
    want_mean = jexport.consensus_params(jax.tree.map(jnp.asarray, stacked))
    for g, w in zip(tree_leaves(params), jax.tree.leaves(want_mean)):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# ---------------------------------------------------------------------------
# the transformer training plugin
# ---------------------------------------------------------------------------

PRESET = "lm100m_ring8_alpha0.1_qg"
QUIET = dict(log_fn=lambda *_: None)


def _arch_spec(arch, *overrides):
    """The LM preset on a reduced arch: 2 nodes, sequences of 16, every
    step logged."""
    return japi.presets.get(PRESET).override(
        "model.kwargs=" + json.dumps({"arch": arch, "reduced": True}),
        "data.seq_len=16", "topology.n=2", "loop.log_every=1", *overrides)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "llama-3.2-vision-11b", "zamba2-7b"])
def test_transformer_plugin_runs_new_archs_as_reference(arch):
    """Two steps of the preset on the reduced arch from the reference's
    init: the MoE's balance loss in each node's loss, the VLM's image stub
    drawn as the reference draws it (its gates, 0 at init, move at step 1,
    so step 2 runs the cross blocks), zamba2's shared block under the
    plugin's vmap."""
    spec = _arch_spec(arch, "loop.steps=2", "loop.chunk=1")
    ref, ref_state = japi.run(spec, with_state=True, **QUIET)
    init = jax.tree.map(np.asarray, japi.build(spec).state.params)
    tspec = tapi.ExperimentSpec.from_json(spec.to_json())
    tspec.validate()
    params = interop.params_from_numpy(init, "cpu")
    opt_state = tapi.build(tspec, device="cpu").trainer.optimizer.init(params)
    state = interop.train_state_from_numpy(init, opt_state, 0, "cpu")
    got, got_state = tapi.run(tspec, device="cpu", state=state,
                              with_state=True, **QUIET)
    assert got.steps_run == ref.steps_run == 2
    for g, w in zip(got.history, ref.history, strict=True):
        for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-5),
                        ("consensus", 1e-4)):
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)
    want = jax.tree.leaves(ref_state.params)
    assert len(want) == len(tree_leaves(got_state.params))
    for g, w in zip(tree_leaves(got_state.params), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    if arch.startswith("llama"):
        cfg = get_config(arch, reduced=True)
        gates = got_state.params["blocks"][cfg.period.index("cross")]
        assert gates["gate_attn"].shape == (2, cfg.n_periods)
        assert gates["gate_attn"].abs().min() > 0


def test_launch_train_runs_a_reduced_moe_arch():
    history = tlaunch_train.main([
        "--arch", "granite-moe-3b-a800m", "--nodes", "2", "--steps", "2",
        "--batch", "2", "--seq-len", "8", "--device", "cpu",
        "--log-every", "1"])
    assert len(history) == 2 and np.isfinite(history[-1]["loss"])
