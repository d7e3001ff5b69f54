"""The port's placement rules (``repro_torch.launch.sharding``) and meshes
(``launch.mesh``) against the JAX package's ``repro.launch.sharding`` /
``mesh``.

For every arch in ``configs/`` at its published size, on
``make_debug_mesh((2, 2))`` and ``make_debug_mesh((2, 2, 2), ('pod',
'data', 'model'))``, with one node (QHM: the weights over every axis) and
with two (on 'data', or on 'pod' with FSDP over 'data'): ``param_specs``
of the params and the optimizer state (node-stacked; and the one-node
params unstacked), with ``tie_break_last`` both ways, ``cache_specs``
of a decode cache with ``shard_features`` both ways, and ``batch_specs``
of every input shape's batch (a train batch at one and two nodes, a
prefill's tokens and image, a decode's token) equal the reference's leaf
by leaf.  The reference's side runs in one subprocess
with ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on
``ShapeDtypeStruct``s, as the reference's own mesh tests run.

Also: ``make_production_mesh`` / ``make_debug_mesh`` on ``meta`` (the
reference's shapes and axis order), the process-major rank layout,
``named``, a rank's blocks (``shard_tree``) and ``bytes_per_rank``.

Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_sharding.py``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding, steps
from repro_torch.tree import tree_leaves, tree_map

#: (name, shape, axes) of the debug meshes held against the reference
MESHES = [("2x2", (2, 2), ("data", "model")),
          ("2x2x2", (2, 2, 2), ("pod", "data", "model"))]
DECODE = ("decode", 256, 4, "decode")

_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
import jax.numpy as jnp
from repro.configs import ARCHS, INPUT_SHAPES, get_config
from repro.configs.base import InputShape
from repro.launch import sharding, steps
from repro.launch.mesh import make_debug_mesh

MESHES = json.loads(sys.argv[1])
DECODE = json.loads(sys.argv[2])

def flat(specs):
    return [[list(e) if isinstance(e, tuple) else e for e in s]
            for s in jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]

meshes = [(name, make_debug_mesh(tuple(shape), tuple(axes)))
          for name, shape, axes in MESHES]
out = {}
for arch in sorted(ARCHS):
    cfg = get_config(arch)
    trees = {}
    for n in (1, 2):
        sc = steps.StepConfig(cfg=cfg, shape=InputShape("t", 64, 2 * n,
                                                        "train"), n_nodes=n)
        p = steps.params_shape(sc, node_stacked=True)
        trees[n] = (p, steps.opt_state_shape(sc, p))
    dsc = steps.StepConfig(cfg=cfg, shape=InputShape(*DECODE), n_nodes=1)
    unstacked = steps.params_shape(dsc, node_stacked=False)
    cache = steps.decode_specs(dsc)["cache"]
    for name, mesh in meshes:
        for n, (p, o) in trees.items():
            plan = sharding.make_plan(mesh, n_nodes=n)
            for tie in (False, True):
                out[f"{name}/{arch}/{n}/params/{tie}"] = flat(
                    sharding.param_specs(plan, p, node_stacked=True,
                                         tie_break_last=tie))
                out[f"{name}/{arch}/{n}/opt/{tie}"] = flat(
                    sharding.param_specs(plan, o, node_stacked=True,
                                         tie_break_last=tie))
        plan = sharding.make_plan(mesh, n_nodes=1)
        for tie in (False, True):
            out[f"{name}/{arch}/1/unstacked/{tie}"] = flat(
                sharding.param_specs(plan, unstacked, tie_break_last=tie))
        for feat in (False, True):
            out[f"{name}/{arch}/1/cache/{feat}"] = flat(
                sharding.cache_specs(plan, cache, shard_features=feat))
    for sname, shape in sorted(INPUT_SHAPES.items()):
        for n in ((1, 2) if shape.kind == "train" else (1,)):
            sc = steps.StepConfig(cfg=cfg, shape=shape, n_nodes=n)
            if shape.kind == "train":
                batch = steps.train_batch_specs(sc)
            elif shape.kind == "prefill":
                batch = steps.prefill_specs(sc)
            else:
                batch = {"token": steps.decode_specs(sc)["token"]}
            for name, mesh in meshes:
                plan = sharding.make_plan(mesh, n_nodes=n)
                out[f"{name}/{arch}/{n}/batch/{sname}"] = flat(
                    sharding.batch_specs(plan, batch))
print(json.dumps(out))
"""


def _jsonable(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(specs, like) -> list:
    """Specs in leaf order, by the tensor tree ``like`` (a spec is a tuple,
    which a walk of the specs alone would enter)."""
    return [_jsonable(spec) for [spec] in tree_leaves(tree_map(
        lambda leaf, spec: [spec], like, specs))]


def _port_specs() -> dict:
    meshes = [(name, tmesh.make_debug_mesh(shape, axes, device="meta"))
              for name, shape, axes in MESHES]
    out = {}
    for arch in sorted(ARCHS):
        cfg = get_config(arch)
        trees = {}
        for n in (1, 2):
            sc = steps.StepConfig(cfg=cfg, shape=InputShape(
                "t", 64, 2 * n, "train"), n_nodes=n)
            p = steps.params_shape(sc, node_stacked=True)
            trees[n] = (p, steps.opt_state_shape(sc, p))
        dsc = steps.StepConfig(cfg=cfg, shape=InputShape(*DECODE),
                               n_nodes=1)
        unstacked = steps.params_shape(dsc, node_stacked=False)
        cache = steps.decode_specs(dsc)["cache"]
        for name, mesh in meshes:
            for n, (p, o) in trees.items():
                plan = sharding.make_plan(mesh, n_nodes=n)
                for tie in (False, True):
                    out[f"{name}/{arch}/{n}/params/{tie}"] = _flat(
                        sharding.param_specs(plan, p, node_stacked=True,
                                             tie_break_last=tie), p)
                    out[f"{name}/{arch}/{n}/opt/{tie}"] = _flat(
                        sharding.param_specs(plan, o, node_stacked=True,
                                             tie_break_last=tie), o)
            plan = sharding.make_plan(mesh, n_nodes=1)
            for tie in (False, True):
                out[f"{name}/{arch}/1/unstacked/{tie}"] = _flat(
                    sharding.param_specs(plan, unstacked,
                                         tie_break_last=tie), unstacked)
            for feat in (False, True):
                out[f"{name}/{arch}/1/cache/{feat}"] = _flat(
                    sharding.cache_specs(plan, cache, shard_features=feat),
                    cache)
        for sname, shape in sorted(INPUT_SHAPES.items()):
            for n in ((1, 2) if shape.kind == "train" else (1,)):
                sc = steps.StepConfig(cfg=cfg, shape=shape, n_nodes=n)
                if shape.kind == "train":
                    batch = steps.train_batch_specs(sc)
                elif shape.kind == "prefill":
                    batch = steps.prefill_specs(sc)
                else:
                    batch = {"token": _token(shape)}
                for name, mesh in meshes:
                    plan = sharding.make_plan(mesh, n_nodes=n)
                    out[f"{name}/{arch}/{n}/batch/{sname}"] = _flat(
                        sharding.batch_specs(plan, batch), batch)
    return out


def _token(shape):
    """A decode step's token, ``steps.decode_specs``'s without its cache."""
    return torch.empty((shape.global_batch, 1), dtype=torch.int32,
                       device="meta")


@pytest.fixture(scope="module")
def reference_specs() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, json.dumps(MESHES),
         json.dumps(DECODE)], capture_output=True, text=True, timeout=300,
        env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_specs_equal_reference_leaf_by_leaf(reference_specs):
    got = _port_specs()
    assert set(got) == set(reference_specs)
    for key in sorted(got):
        assert got[key] == reference_specs[key], key
    # the cases differ where they should: tie_break_last moves square
    # weights, shard_features puts caches on 'model', two nodes pin one axis
    for name, _, _ in MESHES:
        arch = "tinyllama-1.1b"
        assert got[f"{name}/{arch}/2/params/False"] != \
            got[f"{name}/{arch}/2/params/True"]
        assert got[f"{name}/{arch}/1/cache/False"] != \
            got[f"{name}/{arch}/1/cache/True"]
        assert got[f"{name}/{arch}/1/params/False"] != \
            got[f"{name}/{arch}/2/params/False"]
    # the batch: a node's rows over the data axes (every axis but the node
    # axis and 'model'), a tuple of them across pods
    assert got["2x2/tinyllama-1.1b/1/batch/prefill_32k"] == [["data", None]]
    assert got["2x2x2/tinyllama-1.1b/1/batch/prefill_32k"] == [
        [["pod", "data"], None]]
    assert got["2x2/tinyllama-1.1b/1/batch/train_4k"] == [
        [None, "data", None]] * 2
    assert got["2x2x2/tinyllama-1.1b/2/batch/train_4k"] == [
        ["pod", "data", None]] * 2
    assert got["2x2/tinyllama-1.1b/2/batch/train_4k"] == [
        ["data", None, None]] * 2
    assert got["2x2/tinyllama-1.1b/1/batch/long_500k"] == [[None, None]]


def test_meshes_are_the_reference_shapes():
    prod = tmesh.make_production_mesh(device="meta")
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    assert prod.axis_names == ("data", "model")
    multi = tmesh.make_production_mesh(multi_pod=True, device="meta")
    assert list(multi.shape.items()) == [("pod", 2), ("data", 16),
                                         ("model", 16)]
    assert multi.size == 512
    dbg = tmesh.make_debug_mesh(device="meta")
    assert dbg.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="one distinct name"):
        tmesh.make_debug_mesh((2, 2), ("data", "data"), device="meta")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_debug_mesh((2, 2))
    # plans on the production meshes: the reference's node axes and FSDP
    assert sharding.make_plan(prod, n_nodes=16).node_axis == "data"
    assert sharding.make_plan(prod, n_nodes=1).fsdp_axes == ("data",)
    assert sharding.make_plan(multi, n_nodes=2) == sharding.ShardingPlan(
        multi, "pod", ("data",))
    with pytest.raises(ValueError, match="does not match"):
        sharding.make_plan(prod, n_nodes=4)
    # the port's extension: no axis for the nodes on a mesh of ones
    one = tmesh.make_debug_mesh((1, 2), device="meta")
    assert sharding.make_plan(one, n_nodes=2) == sharding.ShardingPlan(
        one, None, ())


class _FakeRankMesh:
    """A :class:`~repro_torch.launch.mesh.RankMesh`'s layout at one rank,
    with no process group: what ``shard`` reads (``shape``, ``axis``)."""

    def __init__(self, shape, axes, rank):
        self.shape = dict(zip(axes, shape))
        self._coords = dict(zip(axes, np.unravel_index(rank, shape)))

    def axis(self, name):
        return type("Axis", (), {"rank": int(self._coords[name])})()


def test_blocks_cover_each_leaf_once_in_process_major_order():
    """The ranks' blocks of a leaf, laid back by their coordinates, are the
    leaf: rank ``r`` sits at ``unravel_index(r, shape)`` ('model'
    fastest), a dim over two axes splits row-major over them."""
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    x = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    spec = (("pod", "data"), None, "model")
    seen = torch.zeros_like(x)
    for rank in range(8):
        m = _FakeRankMesh(shape, axes, rank)
        block = sharding.NamedSharding(m, spec).shard(x)
        assert tuple(block.shape) == sharding.local_shape(m, spec, x.shape)
        p, d, mo = np.unravel_index(rank, shape)
        rows = slice((2 * p + d), (2 * p + d) + 1)
        cols = slice(3 * mo, 3 * mo + 3)
        assert torch.equal(block, x[rows, :, cols])
        seen[rows, :, cols] += 1
    assert torch.equal(seen, torch.ones_like(x))
    # a block that is all of the leaf is the leaf itself
    m = _FakeRankMesh((1, 1), ("data", "model"), 0)
    leaf = x[0]
    assert sharding.NamedSharding(m, ("data", "model")).shard(leaf) is leaf


def test_named_shard_tree_and_bytes_per_rank():
    mesh = tmesh.make_debug_mesh((2, 2), device="meta")
    plan = sharding.make_plan(mesh, n_nodes=2)
    sc = steps.StepConfig(cfg=get_config("granite-moe-3b-a800m",
                                         reduced=True),
                          shape=InputShape("t", 16, 4, "train"), n_nodes=2)
    p = steps.params_shape(sc, node_stacked=True)
    specs = sharding.param_specs(plan, p, node_stacked=True)
    assert specs["embed"] == ("data", "model", None)
    # the expert stack pinned on 'model'
    assert specs["blocks"][0]["moe"]["w_up"][:3] == ("data", None, "model")
    named = sharding.named(plan, specs)
    assert named["embed"] == sharding.NamedSharding(mesh, specs["embed"])
    blocks = sharding.shard_tree(plan, specs, p)
    for leaf, block, [spec] in zip(tree_leaves(p), tree_leaves(blocks),
                                   tree_leaves(tree_map(lambda l, s: [s], p,
                                                        specs))):
        assert tuple(block.shape) == sharding.local_shape(mesh, spec,
                                                          leaf.shape)
    total = sum(t.numel() * t.element_size() for t in tree_leaves(blocks))
    assert sharding.bytes_per_rank(plan, p, specs) == total
    # blocks pass through shard_tree as blocks; a wrong shape raises
    again = sharding.shard_tree(plan, specs, blocks, shapes=p)
    assert all(a is b for a, b in zip(tree_leaves(again),
                                      tree_leaves(blocks)))
    bad = dict(blocks, embed=torch.empty((3, 3), device="meta"))
    with pytest.raises(ValueError, match="neither the global"):
        sharding.shard_tree(plan, specs, bad, shapes=p)
    # batches: the node axis only (each rank computes its node's batch)
    batch = steps.train_batch_specs(sc)
    assert sharding.batch_specs(plan, batch)["tokens"] == ("data", None,
                                                           None)
