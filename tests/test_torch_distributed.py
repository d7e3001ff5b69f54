"""The port's multi-rank runtimes under gloo on the CPU.

``repro_torch.launch.distributed`` / ``launch.mesh``'s actionable errors,
then one spawn per world size (4 and 2 ranks, a ``file://`` store in
``tmp_path``) that runs every case on the sharded and hybrid backends and
hands its histories and gathered final states back through a file.  Each
is held against the port's vmap runtime within the reference's own
tolerance (the sparse and dense mixes sum in other orders), and, where
every phase of the schedule is sparse, bit for bit against the hybrid
backend at d = 1 (a one-rank group in this process): a block round adds
exact zeros for the slots it does not feed, so the world size changes no
value.  The losses and the scenario fractions, gathered per node and
reduced as the vmap runtime reduces them, are bit-equal to the vmap
runtime's too.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_distributed.py``.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import traceback

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import optim as toptim, topology as ttopo
from repro_torch.launch import distributed, mesh as tmesh
from repro_torch.train import DecentralizedTrainer
from repro_torch.tree import tree_leaves

#: the reference's tolerance for the delayed/sharded parity runs
#: (tests/test_overlap.py): the sparse schedule sums a node's neighbours in
#: round order, the vmap runtime in a matrix product
RTOL, ATOL = 2e-4, 1e-5
#: consensus and grad_norm reduce their squared sums over the ranks, in
#: another order than one device does
REDUCED_RTOL = 1e-5
WAIT_S = 120          # each rank's store and collective timeout
JOIN_S = 240          # the spawn's join
QUIET = dict(log_fn=lambda *_: None)


def _spec(topology, n, *overrides, steps=3):
    """The reference's tier-1 task (tests/test_overlap.py) on ``n``
    nodes."""
    spec = api.ExperimentSpec(
        name="dist-test", seed=3,
        data=api.DataSpec(alpha=1.0, batch=8, n_data=512, n_classes=5,
                          hw=4),
        topology=api.TopologySpec(name=topology, n=n),
        optim=api.OptimSpec(name="qg_dsgdm_n", lr=0.05),
        loop=api.LoopSpec(steps=steps, log_every=1),
        eval=api.EvalSpec(enabled=False),
        model=api.ModelSpec(name="mlp"))
    return spec.override(*overrides)


_CHURN = ("scenario.enabled=true", "scenario.participation=0.9",
          "scenario.dropout=0.2", "scenario.churn_window=2",
          "scenario.straggler=0.1", "scenario.seed=5")

#: world size -> [(case, spec, every phase sparse at that world size)]; a
#: few steps each: every step's collectives wait for all ranks, which a
#: loaded machine stretches
CASES = {
    4: [
        ("sharded_ring4", _spec("ring", 4, "runtime=sharded"), True),
        ("sharded_ring4_delayed_chunk",
         _spec("ring", 4, "runtime=sharded", "overlap=delayed_1",
               "loop.chunk=2", steps=4), True),
        ("hybrid_ring8_delayed", _spec("ring", 8, "runtime=hybrid",
                                       "overlap=delayed_1"), True),
        ("hybrid_ring8_delayed_mt",
         _spec("ring", 8, "runtime=hybrid", "overlap=delayed_1",
               "optim.name=mt_dsgdm"), True),
        ("hybrid_ring16_chunk_eval",
         _spec("ring", 16, "runtime=hybrid", "loop.chunk=2",
               "eval.enabled=true", steps=4), True),
        ("hybrid_exp16", _spec("exp", 16, "runtime=hybrid", steps=4), True),
        ("hybrid_ring16_churn_chunk",
         _spec("ring", 16, "runtime=hybrid", "loop.chunk=2", *_CHURN,
               steps=4), True),
        ("hybrid_ring16_topk",
         _spec("ring", 16, "runtime=hybrid", "comm.compressor=topk:0.5",
               "comm.backend=auto"), True),
        ("hybrid_ring16_ef",
         _spec("ring", 16, "runtime=hybrid", "comm.compressor=signnorm",
               "comm.error_feedback=true", "comm.backend=auto"), True),
    ],
    2: [
        ("hybrid_ring8_dense", _spec("ring", 8, "runtime=hybrid"), False),
        ("hybrid_ring8_dense_delayed_chunk",
         _spec("ring", 8, "runtime=hybrid", "overlap=delayed_1",
               "loop.chunk=2", steps=4), False),
        ("hybrid_exp16_forced_dense",
         _spec("exp", 16, "runtime=hybrid", "gossip.schedule=dense",
               "eval.enabled=true", steps=4), False),
        ("hybrid_ring8_dense_churn",
         _spec("ring", 8, "runtime=hybrid", *_CHURN), False),
    ],
}


def _leaves(state) -> list:
    """Params, optimizer state and exchange buffers, in order."""
    out = tree_leaves(state.params) + tree_leaves(state.opt_state)
    if state.mix_buf is not None:
        out += tree_leaves(tuple(state.mix_buf))
    return [np.asarray(a.detach().cpu().numpy()) for a in out]


def _direct_executors(mesh) -> dict:
    """The node-granular executors on ring-4, one node a rank, against the
    dense mix: the largest absolute difference of each."""
    from repro_torch.core import gossip
    g = torch.Generator().manual_seed(11)
    x = torch.randn(4, 3, 5, generator=g)
    topo = ttopo.ring(4)
    want = gossip.mix_dense(torch.as_tensor(topo.w(0), dtype=torch.float32),
                            {"a": x})["a"][mesh.rank:mesh.rank + 1]
    mine = x[mesh.rank:mesh.rank + 1]
    sched = gossip.compile_gossip_schedule(topo)
    got = {
        "mix_ring_shardmap": gossip.mix_ring_shardmap({"a": mine},
                                                      mesh=mesh)["a"],
        "apply_schedule_local": gossip.apply_schedule_local(
            mine, sched, 0, mesh=mesh),
        "mix_leaf_dense_local": gossip.mix_leaf_dense_local(
            topo.w(0), mine, mesh=mesh)}
    return {k: float((v - want).abs().max()) for k, v in got.items()}


def _rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank: every case of its world size through ``api.run(spec,
    mesh=)``; rank 0 writes each history and gathered final state."""
    torch.set_num_threads(1)
    try:
        distributed.initialize(store, world, rank, backend="gloo",
                               timeout_s=WAIT_S)
        mesh = tmesh.make_node_mesh(world)
        for case, spec, _ in CASES[world]:
            res, state = api.run(spec, device="cpu", mesh=mesh,
                                 with_state=True, **QUIET)
            full = [mesh.gather_nodes(a) if a.dim() else a for a in
                    tree_leaves(state.params) + tree_leaves(state.opt_state)
                    + tree_leaves(tuple(state.mix_buf or ()))]
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{case}.npz"),
                         history=json.dumps(res.history),
                         final=json.dumps(res.final),
                         **{f"leaf{i}": a.numpy()
                            for i, a in enumerate(full)})
        if world == 4:
            direct = _direct_executors(mesh)
            if rank == 0:
                with open(os.path.join(out_dir, "direct.json"), "w") as f:
                    json.dump(direct, f)
        distributed.shutdown()
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn(world: int, tmp_path) -> None:
    ctx = mp.get_context("spawn")
    store = f"file://{tmp_path}/store"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, str(tmp_path)))
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
    assert not alive, f"{len(alive)} rank(s) still running after {JOIN_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process and its node mesh (the
    hybrid backend at d = 1)."""
    path = tmp_path_factory.mktemp("one_rank") / "store"
    distributed.initialize(f"file://{path}", 1, 0, backend="gloo",
                           timeout_s=WAIT_S)
    yield tmesh.make_node_mesh(1)
    distributed.shutdown()


def _close(a, b, rtol, atol, what):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def _hold(world, tmp_path, one_rank):
    _spawn(world, tmp_path)
    for case, spec, sparse in CASES[world]:
        got = np.load(tmp_path / f"{case}.npz")
        hist = json.loads(str(got["history"]))
        leaves = [got[f"leaf{i}"] for i in range(len(got.files) - 2)]
        vm, vm_state = api.run(spec.override("runtime=vmap"), device="cpu",
                               with_state=True, **QUIET)
        assert len(hist) == len(vm.history) == spec.loop.steps, case
        for h, v in zip(hist, vm.history):
            assert set(h) == set(v), case
            for k in h:
                what = f"{case} {k} @ step {h['step']}"
                if k in ("loss", "lr", "alive_frac", "mix_frac",
                         "comm_bits_per_node", "comm_ratio", "step"):
                    # per-node values gathered and reduced as on vmap
                    # (before the first mix, bit for bit)
                    if h["step"] == 0 or k != "loss":
                        assert h[k] == v[k], what
                _close(h[k], v[k], RTOL, ATOL, what)
        want = _leaves(vm_state)
        assert len(leaves) == len(want), case
        for a, b in zip(leaves, want):
            _close(a, b, RTOL, ATOL, f"{case} final state")
        if spec.eval.enabled:
            final = json.loads(str(got["final"]))
            for k in ("acc", "eval_loss"):
                _close(final[k], vm.final[k], RTOL, ATOL, f"{case} {k}")
        if not sparse:
            continue
        one, one_state = api.run(spec.override("runtime=hybrid"),
                                 device="cpu", mesh=one_rank,
                                 with_state=True, **QUIET)
        for h, o in zip(hist, one.history):
            for k in h:
                if k in ("consensus", "grad_norm"):
                    _close(h[k], o[k], REDUCED_RTOL, 0.0, f"{case} {k}")
                else:
                    assert h[k] == o[k], f"{case} {k} @ step {h['step']}"
        for a, b in zip(leaves, _leaves(one_state), strict=True):
            np.testing.assert_array_equal(a, b, err_msg=f"{case} vs d=1")


def test_world4_sharded_and_hybrid_reproduce_vmap(tmp_path, one_rank):
    """World 4: sharded (ring-4, loop and delayed chunk), hybrid at ring-8
    (b = 2, delayed, two topology sites), ring-16 (b = 4, chunked,
    per-node evaluation), exp16 (the phase from the host step), churn
    masks, top-k and EF; the node-granular executors against the dense
    mix."""
    _hold(4, tmp_path, one_rank)
    direct = json.loads((tmp_path / "direct.json").read_text())
    assert max(direct.values()) < 1e-6, direct


def test_world2_dense_phases_reproduce_vmap(tmp_path, one_rank):
    """World 2: the all-gather fallback (ring-8 at d = 2 compiles dense),
    delayed and chunked, under churn, and forced dense gossip on the
    time-varying exp16 with per-node evaluation."""
    _hold(2, tmp_path, one_rank)


# ---------------------------------------------------------------------------
# the launch surface's errors
# ---------------------------------------------------------------------------

def test_mesh_needs_a_process_group(monkeypatch):
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="initialize"):
        tmesh.make_node_mesh(2)


def test_mesh_shortfall_of_ranks_names_initialize(one_rank):
    with pytest.raises(RuntimeError, match=r"need 4 ranks.*num_processes=4"):
        tmesh.make_node_mesh(4)


def test_hybrid_world_size_must_divide_n():
    mesh = tmesh.NodeMesh(group=None, rank=0, size=3,
                          device=torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide the topology's n=16"):
        DecentralizedTrainer(lambda *a: None, toptim.make_optimizer("dsgd"),
                             ttopo.ring(16), device="cpu", mesh=mesh,
                             runtime="hybrid")
    with pytest.raises(ValueError, match="has size 3, topology has n=16"):
        DecentralizedTrainer(lambda *a: None, toptim.make_optimizer("dsgd"),
                             ttopo.ring(16), device="cpu", mesh=mesh,
                             runtime="sharded")


def test_two_ranks_on_one_card_raise_before_nccl(monkeypatch, tmp_path):
    """Rank 1 of two on a host with one card: a ValueError that says one
    rank per card, before any store or NCCL call."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(ValueError, match="one rank per card"):
        distributed.initialize(f"file://{tmp_path}/store", 2, 1,
                               backend="nccl")
    assert distributed._duplicates(
        ["h/cuda:0", "h/cuda:1", "g/cuda:0", "h/cuda:0"]) == [
            (0, 3, "h/cuda:0")]


def test_nccl_without_a_card_is_refused(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        distributed.initialize(f"file://{tmp_path}/store", 1, 0,
                               backend="nccl")
