"""The sharded launch state (``launch/sharding.Placement``) across gloo ranks
on the CPU: ``launch/steps.build_train_step`` on a 2-layer, d-64
TinyLlama cut, 2 nodes, 2 steps, on meshes of ``launch/mesh.make_debug_mesh``:

* world 2, ``('data', 'model')`` of (1, 2): the vmap runtime, both nodes
  on each rank, every weight and buffer stored in halves over 'model';
  the prefill and decode builders on the same mesh (one node, weights
  over 'model', caches by ``cache_specs``);
* world 4, (2, 2): the sharded runtime, one node a 'data' rank, its
  weights in halves over 'model';
* world 8, ``('pod', 'data', 'model')`` of (2, 2, 2): a node a pod, its
  weights over 'data' (FSDP) and 'model', and its 2 sequences over
  'data' (the reference's ``batch_specs``): each rank computes one.

Each rank gathers each weight on use and keeps its slice of the gradient
(over 'data' in world 8, the sum of the two ranks' partial gradients);
the losses of both steps and the gathered params and optimizer state are
bit-equal to the ``mesh=None`` step in this process where a rank computes
its node's whole batch (worlds 2 and 4), and within rtol 1e-5 / atol 1e-6
of it where the rows split (world 8: the rows' sums meet in another
order); the prefill's logits, the decode steps' logits and the gathered
caches are bit-equal to the unsharded builders'.  Each rank's stored
bytes (its blocks of the params, the optimizer state and its rows of the
batch) equal the dry run's per-rank ``argument`` for the same mesh shape
(``dryrun.trace_step`` on ``meta``).

Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_shard_gloo.py``.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import traceback

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import distributed, sharding, steps
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves, tree_map

JOIN_S = 240
STEPS = 2
N_NODES = 2
SEQ = 16

#: world size: (mesh shape, axis names, runtime, node axis)
MESHES = {2: ((1, 2), ("data", "model"), "vmap", None),
          4: ((2, 2), ("data", "model"), "sharded", "data"),
          8: ((2, 2, 2), ("pod", "data", "model"), "sharded", "pod")}


def _cfg():
    return dataclasses.replace(get_config("tinyllama-1.1b", reduced=True),
                               d_model=64, d_ff=128)


def _sc(runtime: str, kind: str = "train", n: int = N_NODES):
    return steps.StepConfig(cfg=_cfg(), shape=InputShape(
        f"tiny_{kind}", SEQ, 2 * n if kind == "train" else 2, kind),
        n_nodes=n, chunk=8, param_dtype=torch.float32, runtime=runtime)


def _train_inputs(sc):
    gen = torch.Generator().manual_seed(11)
    nodes = [tf.init_lm(gen, sc.cfg) for _ in range(sc.n_nodes)]
    params = tree_map(lambda *ls: torch.stack(ls), *nodes)
    toks = torch.randint(0, sc.cfg.vocab_size, (sc.n_nodes, 2, SEQ + 1),
                         generator=gen, dtype=torch.int32)
    return params, {"tokens": toks[..., :-1].contiguous(),
                    "labels": toks[..., 1:].contiguous()}


def _train(sc, mesh=None, node_axis=None):
    """STEPS steps: ``(losses, params, opt_state, step)``."""
    params, batch = _train_inputs(sc)
    step = steps.build_train_step(sc, mesh=mesh, node_axis=node_axis)
    p, o, losses = params, steps.make_opt(sc).init(params), []
    for _ in range(STEPS):
        p, o, loss = step(p, o, batch)
        losses.append(loss)
    return losses, p, o, step, batch


def _serve(sc, mesh=None):
    """Prefill [2, 8] and two greedy decode steps: the three logits and
    the final caches (gathered with a mesh)."""
    gen = torch.Generator().manual_seed(12)
    params = tf.init_lm(gen, sc.cfg)
    toks = torch.randint(0, sc.cfg.vocab_size, (2, 8), generator=gen)
    prefill = steps.build_prefill_step(sc, mesh=mesh)
    decode = steps.build_decode_step(sc, mesh=mesh)
    logits, cache = prefill(params, toks)
    out = [logits]
    for pos in (8, 9):
        logits, cache = decode(params, torch.argmax(logits, -1,
                                                    keepdim=True), pos, cache)
        out.append(logits)
    if mesh is not None:
        lay = decode.layout
        cache = sharding.gather_tree(lay.plan, lay.specs["cache"], cache)
    return out, tree_leaves(cache)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _rank(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        distributed.initialize(store, world, rank, backend="gloo",
                               timeout_s=JOIN_S)
        shape, axes, runtime, node_axis = MESHES[world]
        mesh = tmesh.make_debug_mesh(shape, axes)
        losses, p, o, step, batch = _train(_sc(runtime), mesh, node_axis)
        lay = step.layout
        stored = _nbytes(p) + _nbytes(o) + _nbytes(lay.local("batch", batch))
        full = tuple(sharding.gather_tree(lay.plan, lay.specs[what], tree,
                                          skip=lay.keep)
                     for what, tree in (("params", p), ("opt_state", o)))
        out = {"stored": np.array(stored),
               "losses": torch.stack(losses).numpy()}
        out.update({f"leaf{i}": a.numpy()
                    for i, a in enumerate(tree_leaves(full))})
        if world == 2:
            logits, cache = _serve(_sc("vmap", "prefill", 1), mesh)
            out.update({f"logits{i}": a.numpy() for i, a in
                        enumerate(logits)})
            out.update({f"cache{i}": a.numpy() for i, a in enumerate(cache)})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        distributed.shutdown()
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn(world: int, tmp_path) -> list:
    ctx = mp.get_context("spawn")
    store = f"file://{tmp_path}/store"
    procs = [ctx.Process(target=_rank, args=(r, world, store,
                                             str(tmp_path)))
             for r in range(world)]
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
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]


@pytest.mark.parametrize("world", sorted(MESHES))
def test_sharded_state_is_bit_equal_to_unsharded(world, tmp_path):
    shape, axes, runtime, _ = MESHES[world]
    ranks = _spawn(world, tmp_path)
    losses, p, o, _, _ = _train(_sc("vmap"))
    want = tree_leaves((p, o))
    if world == 8:      # each 'data' rank computes one of a node's rows
        def same(a, b, what):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=str(what))
    else:
        def same(a, b, what):
            assert np.array_equal(a, b), what
    for r, got in enumerate(ranks):
        same(got["losses"], torch.stack(losses).numpy(), r)
        for i, w in enumerate(want):
            same(got[f"leaf{i}"], w.numpy(), (r, i))
    # stored bytes a rank = the dry run's per-rank argument (imported here:
    # the spawned ranks import this module, and the dry run's memory
    # tracker adds seconds to each start)
    from repro_torch.launch import dryrun
    plan = sharding.make_plan(tmesh.make_debug_mesh(shape, axes,
                                                    device="meta"),
                              n_nodes=N_NODES)
    arg = dryrun.trace_step(_sc("vmap"), plan)["argument"]
    assert {int(g["stored"]) for g in ranks} == {arg}
    whole = _nbytes((p, o)) + _nbytes(_train_inputs(_sc("vmap"))[1])
    assert arg < whole
    if world == 2:
        logits, cache = _serve(_sc("vmap", "prefill", 1))
        for got in ranks:
            for i, w in enumerate(logits):
                assert np.array_equal(got[f"logits{i}"], w.numpy()), i
            for i, w in enumerate(cache):
                assert np.array_equal(got[f"cache{i}"], w.numpy()), i
