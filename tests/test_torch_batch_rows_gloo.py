"""A node's batch over the data axes (``launch/sharding.Rows``, FSDP's data
parallelism) across gloo ranks on the CPU: each rank computes its rows of
the node's batch where the reference's ``batch_specs`` puts them, held
against ``mesh=None`` and the JAX package.

The cuts: TinyLlama and granite-moe-3b (4 experts, top 2, at capacity
factor 0.5: a queue holds a quarter of the tokens, so the node's queue
drops pairs) at 2 layers, d 64, ff 128, V 256, fp32; for the serving
steps also zamba2-7b (mamba blocks, the shared block) and
llama-3.2-vision-11b (a cross block, 16 image tokens).  Every input is one
numpy draw that both packages take.  A node has 4 rows: one node (QHM)
takes [4, 16], two nodes [2, 16] each; a serving batch is 4 prompts of 8
tokens and 4 greedy decode steps (capacity 16).

World size 2: ``('data', 'model')`` of (2, 1), one node, 2 rows a rank.
World size 4: (2, 2), one node, 2 rows a 'data' rank; and ``('pod',
'data', 'model')`` of (2, 2, 1), a node a pod on the sharded runtime with
the fp32 QG chain, 1 row a 'data' rank (the serving steps there: one node,
1 row a rank over ``('pod', 'data')``).

* ``Rows``' collectives against the plain sums: ``sum`` and its backward,
  ``before``, ``reduce_grads``, and their ``torch.func.vmap`` rules;
* 2 train steps: the losses, the gathered params and optimizer state
  within rtol 1e-5 / atol 1e-6 of ``mesh=None`` (on (2, 2) also the MoE
  cut with ``pin_moe_dispatch``: its experts over 'model', its node's
  queue over 'data'), and of the JAX package's
  step jitted on its debug mesh of the same shape with its ``batch_specs``
  in-shardings (the MoE cut on every mesh, the dense one on (2, 1) and
  (2, 2, 1); the leaves normwise there: its GSPMD sums the rows in its own
  order); the rows' collectives on the wire;
* a prefill and 4 unpinned decode steps: every step's logits within 1e-5
  of max |logit| of ``mesh=None``'s, the argmax equal, and the final
  cache (gathered) within 1e-5 normwise, as the earlier slices hold a
  serving step (a row's products run on fewer rows, in another blocking);
  the prefill's last logits also of the JAX prefill on (2, 2);
* the MoE's node queue: each rank's routes and kept slots equal to its
  rows of the ``mesh=None`` prefill's, the ranks' drops summing to the
  node's, which differ from those of each rank's rows queued alone.

The JAX package runs in a subprocess a world size (4 forced host devices)
beside the ranks, which import nothing of it.  Run alone:
``PYTHONPATH=src python -m pytest -q tests/test_torch_batch_rows_gloo.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing as mp
import os
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import distributed, sharding, steps
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves, tree_map

JOIN_S = 240
STEPS = 2
SEQ = 16            # a train sequence; a serving cache's capacity
PROMPT = 8
DECODE = 4
ROWS = 4            # a node's batch rows (one node); two nodes take 2 each
CUT = dict(d_model=64, d_ff=128, vocab_size=256)
#: granite's capacity factor: int(T * 2 / 4 * 0.5) = T / 4 slots an expert
DROP = 0.5
TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_ARCHS = ("tinyllama-1.1b", "granite-moe-3b-a800m")
SERVE_ARCHS = TRAIN_ARCHS + ("zamba2-7b", "llama-3.2-vision-11b")
#: the JAX prefill on (2, 2): the dense and the MoE cut
JAX_SERVE_ARCHS = TRAIN_ARCHS
#: world size: {label: (mesh shape, axes, nodes, runtime, node axis)}
MESHES = {2: {"qhm_2x1": ((2, 1), ("data", "model"), 1, "vmap", None)},
          4: {"qhm_2x2": ((2, 2), ("data", "model"), 1, "vmap", None),
              "pods_2x2x1": ((2, 2, 1), ("pod", "data", "model"), 2,
                             "sharded", "pod")}}
#: the expert split (``pin_moe_dispatch``, experts over 'model') with the
#: node's queue over 'data': the MoE cut on (2, 2)
EXPERTS = dict(pin_moe_dispatch=True)
#: the train cuts the JAX package's step runs on each mesh (the MoE cut on
#: every mesh, the dense one where the node axis differs)
JAX_TRAIN = {"qhm_2x1": TRAIN_ARCHS, "qhm_2x2": TRAIN_ARCHS[1:],
             "pods_2x2x1": TRAIN_ARCHS}


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread while the tiny steps run in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _cfg(arch):
    cfg = dataclasses.replace(get_config(arch, reduced=True), **CUT)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=DROP))
    return cfg


def _sc(arch, n, kind="train", runtime="vmap", **knobs):
    return steps.StepConfig(
        cfg=_cfg(arch), shape=InputShape(f"tiny_{kind}", SEQ, ROWS, kind),
        n_nodes=n, chunk=8, ssd_chunk=8, param_dtype=torch.float32,
        runtime=runtime, **knobs)


def _node_batch(inputs, arch, n):
    """The train batch of ``n`` nodes: node i's ``ROWS / n`` rows."""
    toks = inputs[arch]["tokens"][:n, :ROWS // n]
    return {"tokens": torch.from_numpy(toks[..., :-1].copy()),
            "labels": torch.from_numpy(toks[..., 1:].copy())}


def _train(arch, n, inputs, mesh=None, runtime="vmap", node_axis=None,
           **knobs):
    """STEPS steps from the drawn init: ``(losses, leaves of the gathered
    params and optimizer state, step)``."""
    sc = _sc(arch, n, runtime=runtime, **knobs)
    params = tree_map(lambda t: t[:n], interop.params_from_numpy(
        inputs[arch]["params"], "cpu"))
    batch = _node_batch(inputs, arch, n)
    step = steps.build_train_step(sc, mesh=mesh, node_axis=node_axis)
    p, o, losses = params, steps.make_opt(sc).init(params), []
    for _ in range(STEPS):
        p, o, loss = step(p, o, batch)
        losses.append(loss.item())
    if mesh is not None:
        lay = step.layout
        p, o = (sharding.gather_tree(lay.plan, lay.specs[w], t, skip=lay.keep)
                for w, t in (("params", p), ("opt_state", o)))
    return np.array(losses), [t.numpy() for t in tree_leaves((p, o))], step


def _serve(arch, inputs, mesh=None, rows=None):
    """A prefill of the 4 prompts and DECODE greedy steps: every step's
    logits, the final cache's leaves (gathered), the prefill's MoE calls'
    routes (``expert_idx`` and ``valid`` of the rank's tokens) and the
    pairs the rank dropped there, and the rank's block of rows.
    ``rows``: the prompts' rows to prefill alone (``mesh=None``)."""
    sc = _sc(arch, 1, kind="prefill")
    params = tree_map(lambda t: t[0], interop.params_from_numpy(
        inputs[arch]["params"], "cpu"))
    tokens = torch.from_numpy(inputs[arch]["tokens"][0, :, :PROMPT]).long()
    img = inputs[arch].get("img")
    img = None if img is None else torch.from_numpy(img)
    if rows is not None:
        sc = dataclasses.replace(sc, shape=InputShape(
            "tiny_prefill", SEQ, len(rows), "prefill"))
        tokens = tokens[rows]
        img = None if img is None else img[rows]
    prefill = steps.build_prefill_step(sc, mesh=mesh)
    decode = steps.build_decode_step(dataclasses.replace(
        sc, shape=dataclasses.replace(sc.shape, kind="decode")), mesh=mesh)
    with moe.recording(routes=True) as rec:
        logits, cache = prefill(params, tokens, img)
        n_calls = len(rec["routes"])
        dropped = int(rec["dropped"]) if "dropped" in rec else 0
        out = [logits]
        for pos in range(PROMPT, PROMPT + DECODE if rows is None
                         else PROMPT):
            logits, cache = decode(params, torch.argmax(logits, -1,
                                                        keepdim=True),
                                   pos, cache)
            out.append(logits)
    if mesh is not None:
        lay = decode.layout
        cache = sharding.gather_tree(lay.plan, lay.specs["cache"], cache)
        assert not decode.pinned and lay.rows is not None
    routes = [np.concatenate([r["expert_idx"].numpy().ravel(),
                              r["valid"].numpy().ravel()])
              for r in rec["routes"][:n_calls]]
    lay = prefill.layout
    block = (0, 1) if lay is None else (lay.rows.index, lay.rows.size)
    return {"logits": [t.numpy() for t in out],
            "cache": [t.numpy() for t in tree_leaves(cache)],
            "routes": routes, "block": block, "dropped": dropped}


# ---------------------------------------------------------------------------
# Rows' collectives, against the plain sums
# ---------------------------------------------------------------------------

def _row_input(q, shape, dtype=np.float32):
    return torch.from_numpy(np.random.default_rng(100 + q).standard_normal(
        shape).astype(dtype))


def _check_rows(rows) -> None:
    """Each collective's value, gradient and vmap rule on this rank (raise
    on a mismatch): a rank's inputs are its block's, so the ranks of one
    block of rows give the same."""
    r, n = rows.index, rows.size
    xs = [_row_input(q, (3, 5)) for q in range(n)]
    ups = [_row_input(50 + q, (3, 5)) for q in range(n)]
    x = xs[r].clone().requires_grad_(True)
    y = rows.sum(x)
    (y * ups[r]).sum().backward()
    torch.testing.assert_close(y.detach(), sum(xs), rtol=0, atol=1e-6)
    torch.testing.assert_close(x.grad, sum(ups), rtol=0, atol=1e-6)
    counts = [torch.arange(4) * (q + 1) for q in range(n)]
    assert torch.equal(rows.before(counts[r]),
                       sum(counts[:r], torch.zeros(4, dtype=torch.long)))
    stack = torch.stack([counts[r], 2 * counts[r]])
    assert torch.equal(torch.func.vmap(rows.before)(stack), torch.stack(
        [rows.before(counts[r]), rows.before(2 * counts[r])]))
    torch.testing.assert_close(torch.func.vmap(rows.sum)(xs[r]),
                               torch.stack([rows.sum(t) for t in xs[r]]),
                               rtol=1e-6, atol=1e-6)
    # a leaf stored along the row axes is left as it is (its gather's
    # backward reduce-scattered it); any other is summed
    entry = rows.axes if len(rows.axes) > 1 else rows.axes[0]
    got = rows.reduce_grads({"a": xs[r], "b": xs[r][0]},
                            {"a": (entry, None), "b": (None,)})
    assert torch.equal(got["a"], xs[r])
    torch.testing.assert_close(got["b"], sum(xs)[0], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        with open(os.path.join(out_dir, "inputs.pkl"), "rb") as fh:
            inputs = pickle.load(fh)
        distributed.initialize(store, world, rank, backend="gloo",
                               timeout_s=JOIN_S)
        out = {}
        for label, (shape, axes, n, runtime, node_axis) in \
                MESHES[world].items():
            mesh = tmesh.make_debug_mesh(shape, axes)
            for arch in TRAIN_ARCHS:
                losses, leaves, step = _train(arch, n, inputs, mesh, runtime,
                                              node_axis)
                rows = step.layout.rows
                out[f"{label}/train/{arch}"] = {
                    "losses": losses, "leaves": leaves,
                    "rows": (rows.axes, rows.size, rows.index),
                    "wire": dict(rows.tally.wire)}
            if label == "qhm_2x2":
                losses, leaves, step = _train(TRAIN_ARCHS[1], n, inputs,
                                              mesh, **EXPERTS)
                assert step.split.experts and step.layout.rows.size == 2
                out[f"{label}/experts"] = (losses, leaves)
            _check_rows(steps.Layout.make(
                _sc(TRAIN_ARCHS[0], n, runtime=runtime), mesh,
                kind="train").rows)
            out[f"{label}/collectives"] = True
            for arch in SERVE_ARCHS:
                out[f"{label}/serve/{arch}"] = _serve(arch, inputs, mesh)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
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
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


# ---------------------------------------------------------------------------
# the JAX package (one subprocess)
# ---------------------------------------------------------------------------

def _numpy_inputs(arch) -> dict:
    """Both packages' inputs, drawn with numpy: two nodes' params in the
    LM's tree (weights at ``1/sqrt(fan_in)``, vectors and the router at
    0.1), [2, ROWS, SEQ + 1] tokens and, for a cut with cross blocks, the
    prompts' image embeddings [ROWS, T_img, d]."""
    rng = np.random.default_rng(11)
    cfg = _cfg(arch)
    shapes = tf.init_lm(None, cfg, device="meta")

    def draw(t):
        scale = 0.1 if t.dim() < 2 else t.shape[-2] ** -0.5
        return (rng.standard_normal((2,) + tuple(t.shape)) * scale).astype(
            np.float32)

    out = {"params": tree_map(draw, shapes),
           "tokens": rng.integers(0, CUT["vocab_size"], size=(2, ROWS,
                                                              SEQ + 1),
                                  dtype=np.int32)}
    if "cross" in cfg.period:
        out["img"] = rng.standard_normal(
            (ROWS, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _jax_cfg(arch):
    from repro.configs import get_config as jget_config
    cfg = dataclasses.replace(jget_config(arch, reduced=True), **CUT)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=DROP))
    return cfg


def _jax_sc(arch, n, kind="train"):
    import jax.numpy as jnp
    from repro.configs.base import InputShape as JInputShape
    from repro.launch import steps as jsteps
    return jsteps.StepConfig(
        cfg=_jax_cfg(arch), shape=JInputShape(f"tiny_{kind}", SEQ, ROWS,
                                              kind),
        n_nodes=n, chunk=8, ssd_chunk=8, param_dtype=jnp.float32)


def _jax_train(arch, n, inputs, mesh):
    """STEPS steps of the JAX package's train step jitted on ``mesh`` with
    the dry run's in-shardings (its ``batch_specs`` for the batch):
    ``(losses, leaves)``."""
    import jax
    from repro.launch import sharding as jsharding
    from repro.launch import steps as jsteps
    sc = _jax_sc(arch, n)
    params = jax.tree.map(lambda a: jax.numpy.asarray(a[:n]),
                          inputs[arch]["params"])
    toks = inputs[arch]["tokens"][:n, :ROWS // n]
    batch = {"tokens": jax.numpy.asarray(toks[..., :-1]),
             "labels": jax.numpy.asarray(toks[..., 1:])}
    o = jsteps.make_opt(sc).init(params)
    plan = jsharding.make_plan(mesh, n_nodes=n)

    def named(tree):
        return jsharding.named(plan, jsharding.param_specs(
            plan, tree, node_stacked=True))

    scalar = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    fn = jax.jit(jsteps.build_train_step(sc, mesh=mesh,
                                         node_axis=plan.node_axis),
                 in_shardings=(named(params), named(o), jsharding.named(
                     plan, jsharding.batch_specs(plan, batch))),
                 out_shardings=(named(params), named(o), scalar))
    p, losses = params, []
    for _ in range(STEPS):
        p, o, loss = fn(p, o, batch)
        losses.append(float(loss))
    return np.array(losses), [np.asarray(a) for a in jax.tree.leaves((p, o))]


def _jax_prefill(arch, inputs, mesh):
    """The JAX package's prefill of the 4 prompts jitted on ``mesh`` with
    its ``batch_specs`` for the tokens: the last logits."""
    import jax
    from repro.launch import sharding as jsharding
    from repro.launch import steps as jsteps
    sc = _jax_sc(arch, 1, "prefill")
    params = jax.tree.map(lambda a: jax.numpy.asarray(a[0]),
                          inputs[arch]["params"])
    tokens = jax.numpy.asarray(inputs[arch]["tokens"][0, :, :PROMPT])
    plan = jsharding.make_plan(mesh, n_nodes=1)
    fn = jax.jit(jsteps.build_prefill_step(sc, mesh=mesh), in_shardings=(
        jsharding.named(plan, jsharding.param_specs(plan, params)),
        jsharding.named(plan, jsharding.batch_specs(plan, tokens))))
    return np.asarray(fn(params, tokens)[0])


def _jax_main(out_dir: str, world: int) -> None:
    """A subprocess: the JAX train steps on the debug meshes of world size
    ``world`` and, at 4, the prefills on (2, 2), written whole under
    another name and renamed."""
    from repro.launch.mesh import make_debug_mesh
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    out = {}
    for label, (shape, axes, n, _, _) in MESHES[world].items():
        mesh = make_debug_mesh(shape, axes)
        with mesh:
            for arch in JAX_TRAIN[label]:
                out[f"{label}/train/{arch}"] = _jax_train(arch, n, inputs,
                                                          mesh)
            if label == "qhm_2x2":
                for arch in JAX_SERVE_ARCHS:
                    out[f"{label}/prefill/{arch}"] = _jax_prefill(
                        arch, inputs, mesh)
    path = os.path.join(out_dir, f"jax{world}.pkl")
    with open(path + ".part", "wb") as fh:
        pickle.dump(out, fh)
    os.replace(path + ".part", path)


class _Reference:
    """The numpy inputs, and the JAX package's steps in a subprocess a
    world size (4 forced host devices each), started at once and read when
    first needed, so that they run beside the ranks."""

    def __init__(self, d):
        self.dir = d
        self.inputs = {arch: _numpy_inputs(arch) for arch in SERVE_ARCHS}
        with open(d / "inputs.pkl", "wb") as fh:
            pickle.dump(self.inputs, fh)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        self.log = open(d / "jax.log", "w")
        self.procs = {world: subprocess.Popen(
            [sys.executable, __file__, str(d), str(world)], env=env,
            stdout=self.log, stderr=subprocess.STDOUT) for world in MESHES}
        self._jax = {}

    def jax(self, world: int) -> dict:
        """The JAX runs of world size ``world`` by ``label/kind/arch``."""
        if world not in self._jax:
            path = self.dir / f"jax{world}.pkl"
            deadline = time.monotonic() + JOIN_S
            while not path.exists():
                if self.procs[world].poll() is not None and \
                        not path.exists():
                    raise AssertionError(
                        f"the JAX package's steps failed:\n"
                        f"{(self.dir / 'jax.log').read_text()[-4000:]}")
                if time.monotonic() > deadline:
                    raise AssertionError(f"no {path.name} in {JOIN_S} s")
                time.sleep(0.2)
            with open(path, "rb") as fh:
                self._jax[world] = pickle.load(fh)
        return self._jax[world]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("rows_reference"))
    yield ref
    for proc in ref.procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    ref.log.close()


@pytest.fixture(scope="module")
def whole(reference):
    """The port's ``mesh=None`` runs: train by (arch, nodes), serve by
    arch, and each serving cut's prompts prefilled one block of rows at a
    time (blocks of 2 and of 1)."""
    inputs = reference.inputs
    with _one_thread():
        train = {(arch, n): _train(arch, n, inputs)[:2]
                 for arch in TRAIN_ARCHS for n in (1, 2)}
        train["experts"] = _train(TRAIN_ARCHS[1], 1, inputs, **EXPERTS)[:2]
        serve = {arch: _serve(arch, inputs) for arch in SERVE_ARCHS}
        alone = {(size, q): _serve(TRAIN_ARCHS[1], inputs, rows=list(range(
            q * (ROWS // size), (q + 1) * (ROWS // size))))["dropped"]
                 for size in (2, 4) for q in range(size)}
    return train, serve, alone


@pytest.fixture(scope="module", params=sorted(MESHES))
def ranks(request, reference, tmp_path_factory):
    world = request.param
    d = tmp_path_factory.mktemp(f"rows_world{world}")
    with open(d / "inputs.pkl", "wb") as fh:
        pickle.dump(reference.inputs, fh)
    return world, _spawn(world, d)


def _held(got, want, what, *, normwise=False):
    (got_losses, got_leaves), (losses, leaves) = got, want
    np.testing.assert_allclose(got_losses, losses, err_msg=what, **TOL)
    assert len(got_leaves) == len(leaves), what
    for i, (g, w) in enumerate(zip(got_leaves, leaves)):
        assert g.shape == w.shape, (what, i)
        if normwise:
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= TOL["rtol"], (what, i, err)
        else:
            np.testing.assert_allclose(g, w, err_msg=f"{what} leaf {i}",
                                       **TOL)


def test_rows_collectives(ranks):
    world, got = ranks
    for r, out in enumerate(got):
        for label in MESHES[world]:
            assert out[f"{label}/collectives"] is True, (r, label)


def test_train_rows_match_mesh_none(ranks, whole):
    world, got = ranks
    train, _, _ = whole
    for r, out in enumerate(got):
        for label, (shape, axes, n, _, _) in MESHES[world].items():
            for arch in TRAIN_ARCHS:
                res = out[f"{label}/train/{arch}"]
                what = f"rank {r} {label} {arch}"
                _held((res["losses"], res["leaves"]), train[(arch, n)], what)
                # a node's rows over 'data' (the node axis is 'pod'); the
                # gradients' collectives on the wire
                assert res["rows"][:2] == (("data",), 2), what
                assert res["rows"][2] == dict(zip(axes, np.unravel_index(
                    r, shape)))["data"], what
                wire = res["wire"]
                assert wire.get("all-reduce", 0) > 0, (what, wire)
                assert wire.get("reduce-scatter", 0) > 0, (what, wire)
            if f"{label}/experts" in out:
                _held(out[f"{label}/experts"], train["experts"],
                      f"rank {r} {label} experts split")


def test_train_rows_match_the_reference_mesh(ranks, reference):
    world, got = ranks
    jax_runs = reference.jax(world)
    for r, out in enumerate(got):
        for label in MESHES[world]:
            for arch in JAX_TRAIN[label]:
                res = out[f"{label}/train/{arch}"]
                _held((res["losses"], res["leaves"]),
                      jax_runs[f"{label}/train/{arch}"],
                      f"rank {r} {label} {arch} vs JAX", normwise=True)


def test_serve_rows_match_mesh_none(ranks, whole, reference):
    world, got = ranks
    _, serve, _ = whole
    jax_runs = reference.jax(world)
    for r, out in enumerate(got):
        for label in MESHES[world]:
            for arch in SERVE_ARCHS:
                res, want = out[f"{label}/serve/{arch}"], serve[arch]
                what = f"rank {r} {label} {arch}"
                assert len(res["logits"]) == 1 + DECODE, what
                for i, (g, w) in enumerate(zip(res["logits"],
                                               want["logits"])):
                    err = np.abs(g - w).max() / np.abs(w).max()
                    assert err <= TOL["rtol"], (what, i, err)
                    assert np.array_equal(g.argmax(-1), w.argmax(-1)), what
                for i, (g, w) in enumerate(zip(res["cache"], want["cache"])):
                    assert g.shape == w.shape, (what, i)
                    err = np.linalg.norm(g - w) / max(np.linalg.norm(w),
                                                      1e-30)
                    assert err <= TOL["rtol"], (what, i, err)
                key = f"{label}/prefill/{arch}"
                if key in jax_runs:
                    w = jax_runs[key]
                    err = np.abs(res["logits"][0] - w).max() / np.abs(w).max()
                    assert err <= TOL["rtol"], (what, err)


def test_moe_queues_are_the_nodes(ranks, whole):
    world, got = ranks
    _, serve, alone = whole
    arch = TRAIN_ARCHS[1]
    want = serve[arch]
    assert want["dropped"] > 0 and len(want["routes"]) == 2
    for label in MESHES[world]:
        dropped = {}
        for r, out in enumerate(got):
            res = out[f"{label}/serve/{arch}"]
            index, size = res["block"]
            dropped[index] = res["dropped"]
            k = _cfg(arch).moe.top_k
            t = ROWS * PROMPT // size          # the rank's tokens
            for g, w in zip(res["routes"], want["routes"]):
                idx, valid = w[:ROWS * PROMPT * k], w[ROWS * PROMPT * k:]
                block = slice(index * t * k, (index + 1) * t * k)
                assert np.array_equal(g, np.concatenate(
                    [idx[block], valid[block]])), (r, label)
        # the node's drops, which each block of rows alone would not make
        assert len(dropped) == size and sum(dropped.values()) == \
            want["dropped"], (label, dropped)
        assert sum(alone[(size, q)] for q in range(size)) != \
            want["dropped"], label


if __name__ == "__main__":
    _jax_main(sys.argv[1], int(sys.argv[2]))
