"""The port's data, partition, batch stream, topology and dense gossip
against the JAX package's.  The data side is numpy in both packages, so it
must be bit-equal; gossip is an fp32 matrix product whose summation order
differs between XLA and torch, hence a tolerance of a few fp32 ulps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import data as jdata
from repro.api import presets as jpresets
from repro.core import gossip as jgossip
from repro.core import topology as jtopo
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro_torch.api import data as tdata
from repro_torch.api import presets as tpresets
from repro_torch.core import gossip as tgossip
from repro_torch.core import topology as ttopo
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn

PRESETS = ["quickstart_ring16_alpha0.1_qg", "quickstart_ring16_alpha0.1_dsgdm"]


def _qs_data():
    return jpresets.get(PRESETS[0]).data


def test_make_classification_bit_equal():
    d = _qs_data()
    kw = dict(n=d.n_data, hw=d.hw, n_classes=d.n_classes, noise=d.noise,
              seed=0)
    xj, yj = jsyn.make_classification(**kw)
    xt, yt = tsyn.make_classification(**kw)
    assert xt.dtype == xj.dtype and yt.dtype == yj.dtype
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)


@pytest.mark.parametrize("ensure_min", ["retry", "redistribute"])
def test_dirichlet_partition_and_stats_bit_equal(ensure_min):
    d = _qs_data()
    _, y = jsyn.make_classification(n=d.n_data, hw=d.hw,
                                    n_classes=d.n_classes, noise=d.noise)
    y = y[:int(d.n_data * d.train_frac)]
    pj = jpart.dirichlet_partition(y, 16, 0.1, seed=0, ensure_min=ensure_min)
    pt = tpart.dirichlet_partition(y, 16, 0.1, seed=0, ensure_min=ensure_min)
    assert len(pj) == len(pt) == 16
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(a, b)
    hj, ht = jpart.heterogeneity_stats(y, pj), tpart.heterogeneity_stats(y, pt)
    np.testing.assert_array_equal(hj["hists"], ht["hists"])
    assert hj["mean_tv"] == ht["mean_tv"] and hj["sizes"] == ht["sizes"]


def test_partition_unsatisfiable_raises_like_reference():
    y = np.arange(10) % 3
    with pytest.raises(ValueError, match="unsatisfiable"):
        tpart.dirichlet_partition(y, 8, 0.1, min_per_client=2)


@pytest.mark.parametrize("preset", PRESETS)
def test_task_batches_and_eval_split_bit_equal(preset):
    spec_j = jpresets.get(preset)
    spec_t = tpresets.get(preset)
    tj, tt = jdata.build_task(spec_j, 16), tdata.build_task(spec_t, 16)
    assert (tj.d_in, tj.n_classes, tj.meta) == (tt.d_in, tt.n_classes, tt.meta)
    assert len(tj.eval_batches) == len(tt.eval_batches) == 1
    for a, b in zip(tj.eval_batches[0], tt.eval_batches[0]):
        np.testing.assert_array_equal(a, b)
    ij, it = tj.make_iter(), tt.make_iter()
    for _ in range(30):     # past the first per-node reshuffle
        for a, b in zip(next(ij), next(it)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_eval_split_chunks():
    arrays = (np.arange(10), np.arange(10) * 2)
    assert tdata._eval_split(arrays, 0)[0][0] is arrays[0]
    chunks = tdata._eval_split(arrays, 4)
    assert [len(c[0]) for c in chunks] == [4, 4, 2]
    assert tdata._eval_split((np.arange(0),), 4) == ()


@pytest.mark.parametrize("n", [1, 2, 3, 16])
def test_ring_mixing_bit_equal(n):
    wj, wt = jtopo.ring(n), ttopo.get_topology("ring", n)
    np.testing.assert_array_equal(wj.mixing, wt.mixing)
    assert wj.neighbors == wt.neighbors
    assert wj.spectral_gap() == wt.spectral_gap()
    assert ttopo.is_doubly_stochastic(wt.w(0))
    wt.validate()


@pytest.mark.parametrize("name", ["powerlaw", "smallworld", "smallworld:0.1",
                                  "powerlaw:2.5"])
def test_unported_topologies_name_their_slice(name):
    """The generated graphs came with slice 8a: doubly stochastic and
    bit-equal to the reference's."""
    wt, wj = ttopo.get_topology(name, 16), jtopo.get_topology(name, 16)
    np.testing.assert_array_equal(wt.mixing, wj.mixing)
    assert ttopo.is_doubly_stochastic(wt.w(0))


def test_unknown_topology_raises_value_error():
    with pytest.raises(ValueError, match="unknown topology"):
        ttopo.get_topology("bogus", 16)


def _tree(rng, n, dtype=np.float32):
    return {"w": rng.normal(size=(n, 5, 3)).astype(dtype),
            "b": rng.normal(size=(n, 7)).astype(dtype)}


# fp32 contraction over 16 nodes: XLA and torch sum in different orders, so
# agreement is to a few ulps of values of order 1
GOSSIP_TOL = dict(rtol=1e-6, atol=1e-6)


def test_mix_dense_matches_reference():
    rng = np.random.default_rng(0)
    tree = _tree(rng, 16)
    w = jtopo.ring(16).w().astype(np.float32)
    out_j = jgossip.mix_dense(jnp.asarray(w), jax.tree.map(jnp.asarray, tree))
    out_t = tgossip.mix_dense(
        torch.from_numpy(w), {k: torch.from_numpy(v) for k, v in tree.items()})
    for k in tree:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   **GOSSIP_TOL)


def test_mix_dense_bf16_leaf_contracts_in_fp32():
    """A bf16 leaf mixes in fp32 and keeps its dtype (the reference's
    consensus-drift fix): a consensus tree stays exactly in place."""
    w = torch.as_tensor(jtopo.ring(16).w(), dtype=torch.float32)
    x = torch.full((16, 9), 1.5, dtype=torch.bfloat16)
    out = tgossip.mix_leaf_dense(w, x)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, x)


def test_node_mean_and_consensus_distance_match_reference():
    rng = np.random.default_rng(1)
    tree = _tree(rng, 16)
    jt = jax.tree.map(jnp.asarray, tree)
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    cj = float(jgossip.consensus_distance(jt))
    ct = float(tgossip.consensus_distance(tt))
    np.testing.assert_allclose(ct, cj, rtol=1e-6)
    mj, mt = jgossip.node_mean(jt), tgossip.node_mean(tt)
    for k in tree:
        assert mt[k].shape == (1,) + tree[k].shape[1:]
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]),
                                   **GOSSIP_TOL)
