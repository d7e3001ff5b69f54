"""The port's sparse and block gossip schedules against the JAX package.

* ``compile_gossip_schedule`` and ``compile_block_schedule`` equal the
  reference's field by field (rounds, pairs, ``recv_w``, ``self_weight``,
  the dense flags and matrices, the offset groups' tables) on every
  registry topology at small n and d in {1, 2, 4}; ``schedule_matrix``
  gives W exactly; the wire counts equal.
* The cases of ``tests/test_schedule.py`` that apply: one-peer phases in
  one full permutation, the round counts, the dense fallback's cost model,
  the rounds only along the graph's edges.
* ``resolve_gossip``'s rules and texts against the reference's.
* The executors at d = 1 (local gathers) against ``mix_dense`` and against
  the reference's ``apply_block_schedule_local`` inside a one-device
  ``shard_map``, every phase; the masked block mix against
  ``mask_renormalize`` with the dense mix, and against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import gossip as jg
from repro.core import topology as jtopo
from repro.launch.mesh import make_debug_mesh
from repro_torch.core import gossip as tg
from repro_torch.core import topology as ttopo

TOPOS = [(name, n) for n in (4, 8, 16)
         for name in ("ring", "star", "torus", "exp", "complete")] + [
    ("social", 32), ("powerlaw:2.5", 16), ("smallworld:0.1", 16)]
IDS = [f"{name}-{n}" for name, n in TOPOS]
#: the executors' fp32 sums against the reference's (XLA may fuse the
#: multiply-adds) and against the dense product
MIX_ATOL = 1e-6


def _both(name, n):
    return ttopo.get_topology(name, n), jtopo.get_topology(name, n)


def _same_phase(a, b, what):
    assert a.n == b.n and a.dense == b.dense, what
    np.testing.assert_array_equal(a.self_weight, b.self_weight, what)
    np.testing.assert_array_equal(a.w, b.w, what)
    assert len(a.rounds) == len(b.rounds), what
    for (pa, wa), (pb, wb) in zip(a.rounds, b.rounds):
        assert pa == pb, what
        np.testing.assert_array_equal(wa, wb, what)
    assert a.messages == b.messages, what


@pytest.mark.parametrize("name,n", TOPOS, ids=IDS)
def test_compilers_equal_the_reference(name, n):
    tt, jt = _both(name, n)
    np.testing.assert_array_equal(tt.mixing, jt.mixing)
    ts, js = tg.compile_gossip_schedule(tt), jg.compile_gossip_schedule(jt)
    assert (ts.name, ts.n, len(ts.phases)) == (js.name, js.n,
                                              len(js.phases))
    for k, (a, b) in enumerate(zip(ts.phases, js.phases)):
        _same_phase(a, b, f"{name} phase {k}")
        np.testing.assert_array_equal(tg.schedule_matrix(a), tt.mixing[k])
    assert ts.max_rounds == js.max_rounds
    assert ts.any_dense == js.any_dense
    assert ts.messages_per_step() == js.messages_per_step()
    assert ts.dense_messages_per_step() == js.dense_messages_per_step()
    for d in (1, 2, 4):
        tb, jb = tg.compile_block_schedule(ts, d), \
            jg.compile_block_schedule(js, d)
        assert (tb.n, tb.d, tb.b) == (jb.n, jb.d, jb.b)
        assert tb.max_ppermutes == jb.max_ppermutes, (name, d)
        for pa, pb in zip(tb.phases, jb.phases, strict=True):
            assert pa.dense == pb.dense, (name, d)
            np.testing.assert_array_equal(pa.self_weight, pb.self_weight)
            np.testing.assert_array_equal(pa.w, pb.w)
            for ra, rb in zip(pa.rounds, pb.rounds, strict=True):
                for ga, gb in zip(ra.groups, rb.groups, strict=True):
                    assert ga.offset == gb.offset
                    for f in ("src_local", "src_node", "recv_w"):
                        np.testing.assert_array_equal(
                            getattr(ga, f), getattr(gb, f), f"{name} {f}")


def test_block_schedule_needs_a_divisor():
    sched = tg.compile_gossip_schedule(ttopo.ring(8))
    with pytest.raises(ValueError, match="n_devices dividing n=8"):
        tg.compile_block_schedule(sched, 3)


def test_one_peer_phases_compile_to_single_permutation():
    sched = tg.compile_gossip_schedule(ttopo.one_peer_exponential(16))
    assert len(sched.phases) == 4
    for phase in sched.phases:
        assert not phase.dense and len(phase.rounds) == 1
        perm, recv_w = phase.rounds[0]
        assert len(perm) == 16
        np.testing.assert_array_equal(recv_w, 0.5)
        np.testing.assert_array_equal(phase.self_weight, 0.5)


def test_round_counts_and_dense_fallback():
    assert tg.compile_gossip_schedule(ttopo.ring(16)).max_rounds == 2
    social = tg.compile_gossip_schedule(ttopo.get_topology("social", 32))
    assert social.max_rounds == \
        social.phases[0].w.astype(bool).sum(1).max() - 1
    assert not social.any_dense
    assert social.dense_messages_per_step() >= \
        2 * social.messages_per_step()
    comp = tg.compile_gossip_schedule(ttopo.complete(16))
    assert comp.any_dense and comp.phases[0].rounds == ()
    star = tg.compile_gossip_schedule(ttopo.star(16))
    assert not star.any_dense


@pytest.mark.parametrize("name,n", [("ring", 16), ("torus", 16),
                                    ("social", 32), ("exp", 16),
                                    ("powerlaw:2.5", 16)],
                         ids=lambda v: str(v))
def test_schedule_edges_subset_of_neighbors(name, n):
    topo = ttopo.get_topology(name, n)
    for phase in tg.compile_gossip_schedule(topo).phases:
        for perm, _ in phase.rounds:
            for src, dst in perm:
                assert dst in topo.neighbors[src], (src, dst)


class _Mesh:
    """A mesh's shape, for the resolver's rules."""

    def __init__(self, size):
        self.shape = {"data": size}


@pytest.mark.parametrize("schedule,topo,size,axis", [
    ("bogus", "ring", 8, "data"), ("ring_ppermute", "ring", None, None),
    ("sparse_ppermute", "ring", 4, "data"),
    ("ring_ppermute", "exp", 8, "data"), ("sparse_ppermute", "ring", 8,
                                          "model")])
def test_resolve_gossip_refusals_match_the_reference(schedule, topo, size,
                                                     axis):
    tt, jt = _both(topo, 8)
    mesh = None if size is None else _Mesh(size)
    with pytest.raises(ValueError) as got:
        tg.resolve_gossip(tt, schedule=schedule, mesh=mesh, node_axis=axis)
    with pytest.raises(ValueError) as want:
        jg.resolve_gossip(jt, schedule=schedule, mesh=mesh, node_axis=axis)
    assert str(got.value) == str(want.value)


def test_resolve_gossip_kinds():
    topo = ttopo.ring(8)
    assert tg.resolve_gossip(topo).kind == "dense"
    assert tg.resolve_gossip(topo, mesh=_Mesh(8), node_axis="data",
                             schedule="dense").kind == "dense"
    r = tg.resolve_gossip(topo, mesh=_Mesh(8), node_axis="data")
    assert r.kind == "sparse" and r.schedule.max_rounds == 2
    assert tg.resolve_gossip(topo, mesh=_Mesh(8), node_axis="data",
                             schedule="ring_ppermute").kind == "ring"


# ---------------------------------------------------------------------------
# the executors at d = 1
# ---------------------------------------------------------------------------

def _tree(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 6, 4)).astype(np.float32),
            "b": rng.normal(size=(n, 3)).astype(np.float32)}


def _j_block_mix(bsched, t, tree, mask=None):
    """The reference's executor inside a one-device shard_map (``mask``:
    an ``[n]`` mix mask, or None)."""
    mesh = make_debug_mesh(shape=(1,), axes=("data",))
    m = None if mask is None else jnp.asarray(mask)
    fn = jax.jit(jg._shard_map(
        lambda x: jax.tree.map(lambda leaf: jg.apply_block_schedule_local(
            leaf, bsched, t, axis_name="data", mask=m), x),
        mesh=mesh, in_specs=(P("data"),), out_specs=P("data"),
        manual_axes=frozenset({"data"})))
    return jax.tree.map(np.asarray, fn(tree))


@pytest.mark.parametrize("name,n", [("ring", 16), ("exp", 16),
                                    ("social", 32), ("powerlaw:2.5", 16),
                                    ("complete", 8)],
                         ids=lambda v: str(v))
def test_block_executor_d1_matches_dense_and_reference(name, n):
    tt, jt = _both(name, n)
    plan = tg.compile_block_schedule(tg.compile_gossip_schedule(tt),
                                     1).on_rank(0, "cpu")
    jb = jg.compile_block_schedule(jg.compile_gossip_schedule(jt), 1)
    tree = _tree(n)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    for t in range(tt.mixing.shape[0]):
        w = torch.as_tensor(tt.mixing[t], dtype=torch.float32)
        got = tg.make_block_mix_fn(plan, mesh=None, w_ref=w, t=t)(w, ttree)
        dense = tg.mix_dense(w, ttree)
        ref = _j_block_mix(jb, t, tree)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), dense[k].numpy(),
                                       atol=MIX_ATOL, err_msg=f"{name} {t}")
            np.testing.assert_allclose(got[k].numpy(), ref[k],
                                       atol=MIX_ATOL, err_msg=f"{name} {t}")
        # another matrix than the topology's: the dense contraction
        other = torch.full((n, n), 1.0 / n)
        avg = tg.make_block_mix_fn(plan, mesh=None, w_ref=w, t=t)(
            other, ttree)
        np.testing.assert_allclose(avg["a"].numpy(),
                                   tg.mix_dense(other, ttree)["a"].numpy(),
                                   atol=MIX_ATOL)


def test_time_varying_schedule_needs_the_host_step():
    plan = tg.compile_block_schedule(tg.compile_gossip_schedule(
        ttopo.one_peer_exponential(8)), 1).on_rank(0, "cpu")
    x = torch.zeros(8, 3)
    with pytest.raises(TypeError, match="host step index"):
        tg.apply_block_schedule_local(x, plan, torch.tensor(1), mesh=None)


@pytest.mark.parametrize("name,n", [("ring", 16), ("powerlaw:2.5", 16),
                                    ("complete", 8)],
                         ids=lambda v: str(v))
def test_masked_block_mix_matches_mask_renormalize(name, n):
    """The edge-wise renormalization of the block executor (sparse, and
    the dense fallback of complete-8) against ``mask_renormalize`` with the
    dense mix and against the reference's masked block executor."""
    tt, jt = _both(name, n)
    plan = tg.compile_block_schedule(tg.compile_gossip_schedule(tt),
                                     1).on_rank(0, "cpu")
    jb = jg.compile_block_schedule(jg.compile_gossip_schedule(jt), 1)
    tree = _tree(n, 1)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    w = torch.as_tensor(tt.mixing[0], dtype=torch.float32)
    rng = np.random.default_rng(7)
    for _ in range(3):
        m = (rng.random(n) < 0.6).astype(np.float32)
        mt = torch.from_numpy(m)
        mask = tg.BlockMask(local=mt, of=lambda ids: mt[ids],
                            full=lambda: mt)
        got = tg.make_block_mix_fn(plan, mesh=None, w_ref=w, t=0,
                                   mask=mask)(w, ttree)
        want = tg.mix_dense(tg.mask_renormalize(w, mt), ttree)
        ref = _j_block_mix(jb, 0, tree, mask=m)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=MIX_ATOL)
            np.testing.assert_allclose(got[k].numpy(), ref[k],
                                       atol=MIX_ATOL)
        # a dead node keeps its value exactly
        dead = np.flatnonzero(m == 0)
        np.testing.assert_array_equal(got["b"].numpy()[dead],
                                      tree["b"][dead])
