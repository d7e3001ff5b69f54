"""The port's step builders (``repro_torch.launch.steps``) and its sharding
rules (``launch.sharding``) on the CPU against the JAX package's
``repro.launch.steps`` / ``sharding``.

* One vmap train step from the reference's own init (``repro_torch.interop``)
  and the same numpy batch, fp32, against the reference's
  ``build_train_step``: reduced TinyLlama on 4 nodes of a ring
  (QG-DSGDm-N), reduced granite-moe on one node (QHM).
* The ``runtime='sharded'`` builder in one spawn of 2 gloo ranks against
  the port's own vmap builder (the reference's sharded builder does not
  run under this JAX, ROADMAP C2).
* The spec trees of all ten archs at their published sizes (``meta``
  tensors against ``jax.eval_shape``), ``choose_n_nodes`` under both
  budgets, ``remat``, the dtype rule and every refusal.

Tolerances, each with its reason:
* loss: rtol 1e-5 (two layers of matrix products in two BLAS libraries,
  whose sums run in other orders; tests/test_torch_lm_train.py's bound);
* new params and the optimizer's buffer after one step: atol 2e-6 plus
  rtol 1e-5.  The gradients agree within rtol 1e-5 of each leaf's largest
  entry (tests/test_torch_lm_train.py); the step moves a param by lr 0.1
  times the momentum-corrected gradient, and the buffer is that difference
  over lr;
* sharded against vmap: rtol 1e-5, atol 1e-6 (the all-gather contraction
  sums a node's neighbours in another order than the matrix product, and
  each rank's gradients come from a one-node batch).

Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_launch_steps.py``.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, get_config as jget_config
from repro.configs.base import InputShape as JInputShape
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import transforms as T
from repro_torch.launch import distributed, sharding, steps
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves, tree_map, tree_paths

LOSS_RTOL = 1e-5
STEP_TOL = dict(rtol=1e-5, atol=2e-6)
SHARDED_TOL = dict(rtol=1e-5, atol=1e-6)
JOIN_S = 240

#: (arch, n_nodes, topology) of the held steps
HELD = [("tinyllama-1.1b", 4, "ring"), ("granite-moe-3b-a800m", 1, "ring")]


def _shape(n: int, kind: str = "train", seq: int = 16, batch: int | None =
           None):
    return InputShape(f"tiny_{kind}", seq, batch or 2 * n, kind)


def _reference_inputs(arch: str, n: int, seq: int = 16):
    """The reference's per-node init (one key a node) and a numpy batch,
    as numpy."""
    jcfg = jget_config(arch, reduced=True)
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    params = jax.jit(jax.vmap(
        lambda k: jtf.init_lm(k, jcfg, dtype=jnp.float32)))(keys)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, size=(n, 2, seq + 1),
                        dtype=np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    return jax.tree.map(np.asarray, params), batch


def _close(got, want, what, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               err_msg=what, **tol)


@pytest.mark.parametrize("arch,n,topology", HELD)
def test_vmap_train_step_matches_reference(arch, n, topology):
    """One fp32 step of the port's vmap builder against the reference's,
    from the reference's init: loss, params and the optimizer state."""
    params_np, batch_np = _reference_inputs(arch, n)
    jsc = jsteps.StepConfig(cfg=jget_config(arch, reduced=True),
                            shape=JInputShape("tiny_train", 16, 2 * n,
                                              "train"),
                            n_nodes=n, chunk=8, ssd_chunk=8,
                            param_dtype=jnp.float32, topology=topology)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jopt = jsteps.make_opt(jsc)
    want_p, want_o, want_l = jax.jit(jsteps.build_train_step(jsc))(
        jparams, jopt.init(jparams), jax.tree.map(jnp.asarray, batch_np))

    sc = steps.StepConfig(cfg=get_config(arch, reduced=True),
                          shape=_shape(n), n_nodes=n, chunk=8, ssd_chunk=8,
                          param_dtype=torch.float32, topology=topology)
    params = interop.params_from_numpy(params_np, "cpu")
    got_p, got_o, got_l = steps.build_train_step(sc)(
        params, steps.make_opt(sc).init(params),
        interop.params_from_numpy(batch_np, "cpu"))
    _close(got_l, want_l, "loss", rtol=LOSS_RTOL)
    for tree, want, what in ((got_p, want_p, "params"),
                             (got_o, want_o, "opt_state")):
        got_leaves, want_leaves = tree_leaves(tree), jax.tree.leaves(want)
        assert len(got_leaves) == len(want_leaves), what
        for path, g, w in zip(tree_paths(tree), got_leaves, want_leaves):
            assert tuple(g.shape) == w.shape, (what, path)
            _close(g, w, f"{what} {path}", **STEP_TOL)


def test_remat_full_is_bit_equal_to_none():
    """``remat='full'`` recomputes each period in the backward: the step's
    params, optimizer state and loss are the same bits as ``'none'``'s, on
    a period of two kinds with an MoE block (gemma2's local/global pair;
    granite's MoE with its auxiliary loss) and zamba2's shared block."""
    for arch in ("gemma2-27b", "granite-moe-3b-a800m", "zamba2-7b",
                 "llama-3.2-vision-11b"):
        cfg = get_config(arch, reduced=True)
        n = 2
        gen = torch.Generator().manual_seed(0)
        one = tf.init_lm(gen, cfg)
        params = tree_map(lambda t: torch.stack([t, 1.01 * t]), one)
        out = {}
        for remat in ("none", "full"):
            sc = steps.StepConfig(cfg=cfg, shape=_shape(n), n_nodes=n,
                                  chunk=8, ssd_chunk=8, remat=remat,
                                  param_dtype=torch.float32)
            specs = steps.train_batch_specs(sc)
            g = torch.Generator().manual_seed(1)
            batch = {k: (torch.randint(0, cfg.vocab_size, v.shape,
                                       generator=g, dtype=torch.int32)
                         if v.dtype == torch.int32 else
                         torch.randn(v.shape, generator=g))
                     for k, v in specs.items()}
            p, o, loss = steps.build_train_step(sc)(
                params, steps.make_opt(sc).init(params), batch)
            out[remat] = tree_leaves((p, o)) + [loss]
        assert all(torch.equal(a, b) for a, b in zip(out["none"],
                                                     out["full"])), arch


def test_dtype_rule_routes_fp32_to_qg_step(monkeypatch):
    """The dtype rule: an fp32 StepConfig keeps ``fused='auto'``, which on
    CUDA tensors sends the QG segment to one ``ops.qg_step`` call (shown
    here with ``'kernel'``, what ``'auto'`` resolves to on a card: the
    kernel's plain version on CPU tensors); a bf16 one builds the chain
    with ``fused='off'``, which never calls it.  On ``meta`` ``'auto'``
    runs the chain stage by stage."""
    calls = []
    real = T.ops.qg_step
    monkeypatch.setattr(T.ops, "qg_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = get_config("tinyllama-1.1b", reduced=True)
    for dtype, fused, want in ((torch.float32, "auto", 1),
                               (torch.bfloat16, "off", 0)):
        sc = steps.StepConfig(cfg=cfg, shape=_shape(2), n_nodes=2,
                              param_dtype=dtype)
        opt = steps.make_opt(sc)
        assert opt.fused == fused
        if fused == "auto":
            opt = dataclasses.replace(opt, fused="kernel")
        gen = torch.Generator().manual_seed(0)
        params = tree_map(lambda t: torch.stack([t, t]).to(dtype),
                          tf.init_lm(gen, cfg))
        calls.clear()
        opt.step(params, tree_map(torch.ones_like, params), opt.init(params),
                 w=torch.full((2, 2), 0.5), lr=0.1, t=0)
        assert len(calls) == want, dtype
    assert not T._fused_enabled("auto", "meta")
    assert T._fused_enabled("auto", "cuda")


def _jax_specs(tree) -> list:
    return [(tuple(l.shape), jnp.dtype(l.dtype).name)
            for l in jax.tree.leaves(tree)]


def _torch_specs(tree) -> list:
    leaves = tree_leaves(tree)
    assert all(l.device.type == "meta" for l in leaves)
    return [(tuple(l.shape), str(l.dtype).replace("torch.", ""))
            for l in leaves]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_trees_match_reference_at_full_size(arch):
    """params_shape, opt_state_shape, train_batch_specs, prefill_specs and
    decode_specs against the reference's ``eval_shape`` trees at the
    published sizes: the same leaves in the same order, shapes and dtypes;
    the port's are ``meta`` tensors."""
    assert set(ARCHS) == set(JARCHS)
    cfg, jcfg = get_config(arch), jget_config(arch)
    for kind, seq, batch, n in (("train", 4096, 32, 2),
                                ("prefill", 1024, 2, 1),
                                ("decode", 2048, 4, 1)):
        sc = steps.StepConfig(cfg=cfg, shape=InputShape("s", seq, batch,
                                                        kind), n_nodes=n)
        jsc = jsteps.StepConfig(cfg=jcfg, shape=JInputShape("s", seq, batch,
                                                             kind),
                                n_nodes=n)
        if kind == "train":
            p = steps.params_shape(sc, node_stacked=True)
            jp = jsteps.params_shape(jsc, node_stacked=True)
            pairs = [(p, jp),
                     (steps.opt_state_shape(sc, p),
                      jsteps.opt_state_shape(jsc, jp)),
                     (steps.train_batch_specs(sc),
                      jsteps.train_batch_specs(jsc)),
                     (steps.params_shape(sc, node_stacked=False),
                      jsteps.params_shape(jsc, node_stacked=False))]
        elif kind == "prefill":
            pairs = [(steps.prefill_specs(sc), jsteps.prefill_specs(jsc))]
        else:
            pairs = [(steps.decode_specs(sc), jsteps.decode_specs(jsc))]
        for got, want in pairs:
            assert _torch_specs(got) == _jax_specs(want), (arch, kind)


def _mesh_stand_in(**axes):
    """A shape-only mesh for the reference's ``choose_n_nodes`` (it reads
    ``mesh.shape``)."""
    return type("Mesh", (), {"shape": dict(axes)})()


#: n_nodes on 16 ranks under the card's budget (64 GB: a node's bf16
#: params, m_hat and grads, 6 bytes a parameter, fit below ~10.7e9
#: parameters)
H100_NODES = {"gemma2-27b": 1, "command-r-35b": 1, "mamba2-130m": 16,
              "llama-3.2-vision-11b": 16, "granite-moe-3b-a800m": 16,
              "qwen2-72b": 1, "tinyllama-1.1b": 16, "musicgen-medium": 16,
              "zamba2-7b": 16, "arctic-480b": 1}


def test_choose_n_nodes_both_budgets():
    mesh = tmesh.MeshShape((("data", 16),))
    assert set(H100_NODES) == set(ARCHS)
    for arch in ARCHS:
        cfg = get_config(arch)
        assert steps.choose_n_nodes(cfg, mesh) == jsteps.choose_n_nodes(
            jget_config(arch), _mesh_stand_in(data=16)), arch
        assert steps.choose_n_nodes(
            cfg, mesh, budget=steps.H100_NODE_BUDGET) == H100_NODES[arch], \
            arch
    with pytest.warns(UserWarning, match="no 'data' axis"):
        assert steps.choose_n_nodes(get_config("tinyllama-1.1b"),
                                    tmesh.MeshShape((("nodes", 4),))) == 1


def test_prefill_and_decode_builders_are_the_model_calls():
    cfg = get_config("tinyllama-1.1b", reduced=True)
    sc = steps.StepConfig(cfg=cfg, shape=_shape(1, "prefill", seq=24,
                                                batch=2), n_nodes=1,
                          chunk=8)
    gen = torch.Generator().manual_seed(0)
    params = tf.init_lm(gen, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    logits, cache = steps.build_prefill_step(sc)(params, toks)
    want, want_cache = tf.prefill(params, toks, cfg, chunk=8, cache_len=24)
    assert torch.equal(logits, want)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache),
                                                 tree_leaves(want_cache)))
    step = steps.build_decode_step(sc)
    tok = torch.argmax(logits, -1, keepdim=True)
    got, _ = step(params, tok, 12, cache)
    want, _ = tf.decode_step(params, tok, 12, want_cache, cfg)
    assert torch.equal(got, want)


def test_refusals_name_what_is_missing():
    """What still raises, naming the fix; the attention knobs, a 'model'
    or 'pod' axis, ``tie_break_last`` and ``shard_features`` build and
    plan as the reference's (``tests/test_torch_sharding.py``,
    ``test_torch_shard_gloo.py`` and ``test_torch_chunk_attention.py``
    hold what they compute)."""
    cfg = get_config("tinyllama-1.1b", reduced=True)
    sc = steps.StepConfig(cfg=cfg, shape=_shape(2), n_nodes=2)
    for knob in ("remat_attention", "skip_masked_chunks"):
        good = dataclasses.replace(sc, **{knob: True})
        for build in (steps.build_train_step, steps.build_prefill_step,
                      steps.build_decode_step):
            assert callable(build(good))
    with pytest.raises(ValueError, match="remat must be one of"):
        steps.build_train_step(dataclasses.replace(sc, remat="dots"))
    with pytest.raises(ValueError, match="cache_constraint"):
        steps.build_decode_step(sc, cache_constraint=object())
    pod = tmesh.MeshShape((("pod", 2), ("data", 16), ("model", 16)))
    model = tmesh.MeshShape((("data", 16), ("model", 16)))
    assert steps.choose_n_nodes(cfg, pod) == 2
    assert steps.choose_n_nodes(get_config("qwen2-72b"), model,
                                budget=steps.H100_NODE_BUDGET) == 16
    assert steps.choose_n_nodes(get_config("qwen2-72b"),
                                tmesh.MeshShape((("data", 16),)),
                                budget=steps.H100_NODE_BUDGET) == 1
    assert sharding.make_plan(pod, n_nodes=2).fsdp_axes == ("data",)
    assert sharding.make_plan(model, n_nodes=16).node_axis == "data"
    with pytest.raises(ValueError, match="does not match"):
        sharding.make_plan(tmesh.MeshShape((("data", 4),)), n_nodes=2)
    with pytest.raises(ValueError, match="needs mesh"):
        steps.build_train_step(dataclasses.replace(sc, runtime="sharded"))
    with pytest.raises(ValueError, match="ride the mesh's"):
        steps.build_train_step(dataclasses.replace(sc, runtime="sharded"),
                               mesh=tmesh.MeshShape((("data", 2),)),
                               node_axis="pod")


def test_plan_specs_and_bytes_per_rank():
    """The node axis on dim 0 of node-stacked leaves (the runtimes' rule),
    whole leaves elsewhere, and a rank's bytes: one row of each
    node-stacked leaf, all of any other, on ``meta`` and real tensors
    alike."""
    cfg = get_config("granite-moe-3b-a800m", reduced=True)
    mesh = tmesh.MeshShape((("data", 4),))
    plan = sharding.make_plan(mesh, n_nodes=4)
    assert plan.node_axis == "data" and plan.node_count == 4
    sc = steps.StepConfig(cfg=cfg, shape=_shape(4), n_nodes=4)
    p = steps.params_shape(sc, node_stacked=True)
    specs = sharding.param_specs(plan, p, node_stacked=True)
    assert specs["embed"] == ("data", None, None)
    assert specs["blocks"][0]["moe"]["w_up"] == ("data",) + (None,) * 4
    assert sharding.param_specs(plan, p)["embed"] == (None, None, None)
    batch = steps.train_batch_specs(sc)
    bspecs = sharding.batch_specs(plan, batch)
    assert bspecs["tokens"] == ("data", None, None)
    whole = sum(l.numel() * l.element_size() for l in tree_leaves(p))
    assert sharding.bytes_per_rank(plan, p, specs) * 4 == whole
    assert sharding.bytes_per_rank(plan, batch, bspecs) == 2 * 2 * 16 * 4
    real = tree_map(lambda l: torch.zeros(l.shape, dtype=l.dtype), p)
    assert sharding.bytes_per_rank(plan, real, specs) == \
        sharding.bytes_per_rank(plan, p, specs)
    # one node (QHM): the reference's FSDP over 'data', and its batch
    # rule: the data axes on the first dim they divide (a stack's leading
    # dim of 1 skipped), a rank's rows
    one = sharding.make_plan(mesh, n_nodes=1)
    assert one.node_axis is None and one.fsdp_axes == ("data",)
    ospecs = sharding.param_specs(one, p, node_stacked=True)
    assert ospecs["embed"] == (None, "data", None)
    assert sharding.bytes_per_rank(one, p, ospecs) * 4 == whole
    assert sharding.batch_specs(one, batch) == {
        "tokens": ("data", None, None), "labels": ("data", None, None)}
    qhm = steps.train_batch_specs(dataclasses.replace(sc, n_nodes=1))
    assert sharding.batch_specs(one, qhm) == {
        "tokens": (None, "data", None), "labels": (None, "data", None)}
    assert sharding.bytes_per_rank(one, qhm, sharding.batch_specs(
        one, qhm)) * 4 == 2 * 8 * 16 * 4
    assert sharding.cache_specs(one, {"k": p["embed"]}) == {
        "k": ("data", None, None)}


# -- the sharded builder under gloo -------------------------------------------

SHARDED_CASES = ("dense", "sparse_ppermute")


def _sharded_sc(schedule: str):
    return steps.StepConfig(cfg=get_config("tinyllama-1.1b", reduced=True),
                            shape=_shape(2), n_nodes=2, chunk=8,
                            param_dtype=torch.float32, runtime="sharded",
                            gossip_schedule=schedule)


def _sharded_inputs(sc):
    gen = torch.Generator().manual_seed(5)
    one = tf.init_lm(gen, sc.cfg)
    params = tree_map(lambda t: torch.stack([t, t + 0.01 * torch.randn(
        t.shape, generator=gen)]), one)
    toks = torch.randint(0, sc.cfg.vocab_size, (2, 2, 16), generator=gen,
                         dtype=torch.int32)
    return params, {"tokens": toks, "labels": toks.roll(1, -1)}


def _sharded_rank(rank: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        distributed.initialize(store, 2, rank, backend="gloo",
                               timeout_s=JOIN_S)
        mesh = tmesh.make_node_mesh(2)
        for schedule in SHARDED_CASES:
            sc = _sharded_sc(schedule)
            params, batch = _sharded_inputs(sc)
            step = steps.build_train_step(sc, mesh=mesh,
                                          node_axis=mesh.axis_name)
            p, o, loss = step(params, steps.make_opt(sc).init(params),
                              batch)
            full = [mesh.gather_nodes(a) for a in tree_leaves((p, o))]
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{schedule}.npz"),
                         loss=loss.numpy(),
                         **{f"leaf{i}": a.numpy()
                            for i, a in enumerate(full)})
        distributed.shutdown()
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def test_sharded_builder_matches_vmap_builder(tmp_path):
    """The sharded builder on 2 gloo ranks (one node each, global trees
    cut by the runtimes' layout rule, blocks gathered back) against the
    port's vmap builder, dense and compiled-schedule gossip."""
    ctx = mp.get_context("spawn")
    store = f"file://{tmp_path}/store"
    procs = [ctx.Process(target=_sharded_rank, args=(r, store,
                                                     str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(timeout=10)
    errors = sorted(tmp_path.glob("error*.txt"))
    assert not errors, errors[0].read_text()
    assert not alive and all(p.exitcode == 0 for p in procs)
    for schedule in SHARDED_CASES:
        sc = dataclasses.replace(_sharded_sc(schedule), runtime="vmap")
        params, batch = _sharded_inputs(sc)
        mesh = tmesh.MeshShape((("data", 2),))
        p, o, loss = steps.build_train_step(sc, mesh=mesh,
                                            node_axis="data")(
            params, steps.make_opt(sc).init(params), batch)
        got = np.load(tmp_path / f"{schedule}.npz")
        _close(loss, got["loss"], f"{schedule} loss", **SHARDED_TOL)
        for i, want in enumerate(tree_leaves((p, o))):
            _close(want, got[f"leaf{i}"], f"{schedule} leaf {i}",
                   **SHARDED_TOL)
