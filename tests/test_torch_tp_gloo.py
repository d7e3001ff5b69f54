"""The compute split over 'model' (``launch/sharding.Split``) across gloo
ranks on the CPU, held against the unsplit step and the JAX package.

The cut: TinyLlama, granite-moe-3b (4 experts), qwen2-72b (q/k/v biases)
and gemma2-27b (local/global layers at window 16, attention and logit
softcaps) at 2 layers, d 64, 4 heads / 2 KV heads, ff 128, V 256, fp32,
2 nodes x [2, 32], 3 steps; for the prefills also zamba2-7b (mamba blocks
and the shared block at window 16) and llama-3.2-vision-11b (cross blocks,
16 image tokens); from one numpy draw of the params, the batch and the
image that both packages take (``interop.params_from_numpy`` on the port's
side).
At world sizes 2 and 4 (``('data', 'model')`` meshes of (1, 2) and (1, 4),
the vmap runtime with both nodes on every rank; at 4 also (2, 2), the
sharded runtime with a node a 'data' rank):

* each collective's forward, backward and ``torch.func.vmap`` rule against
  the plain sum or concatenation of every rank's input;
* ``megatron_attn``, ``shard_activations`` and ``pin_moe_dispatch`` alone
  and all three at once: the 3 losses, the gathered final params and m_hat
  within rtol 1e-5 / atol 1e-6 of ``mesh=None`` (the partial sums run in
  another order); with all three (on every train cut), also of the JAX
  package's ``build_train_step`` with the same knobs at ``mesh=None``, and
  at (2, 2) of the JAX step jitted on ``make_debug_mesh((2, 2))`` with
  in-shardings, as the JAX package's dry run compiles it (GSPMD equals its
  unsplit step up to sum order; TinyLlama and granite);
* the MoE's routes: every token's experts and kept slots equal to the
  unsplit prefill's;
* a prefill's last logits within 1e-5 of max |logit|, on every cut with
  a self-attention, a mamba or a cross block (a mamba or cross block runs
  whole on every rank, the residual moved into and out of it);
* the placement's ``Tally``: no byte gathered of a leaf the split computes
  with (with all three knobs nothing is gathered on the dense cuts, and the
  router alone on the MoE cut).

The JAX package runs in this process (``mesh=None``) and in one
subprocess (the (2, 2) mesh, 4 forced host devices); the ranks import
nothing of it.  Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_tp_gloo.py``.
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
STEPS = 3
N_NODES = 2
SEQ = 32
#: the train cuts, all held against the JAX package's step (the first two
#: also on its (2, 2) mesh)
ARCHS = ("tinyllama-1.1b", "granite-moe-3b-a800m", "qwen2-72b",
         "gemma2-27b")
MESH_ARCHS = ARCHS[:2]
PREFILL_ARCHS = ("tinyllama-1.1b", "granite-moe-3b-a800m", "zamba2-7b",
                 "llama-3.2-vision-11b")
CUT = dict(d_model=64, d_ff=128, vocab_size=256)
#: a window shorter than SEQ, so the local layers mask
WINDOW_CUT = {"gemma2-27b": dict(window=16), "zamba2-7b": dict(window=16)}
TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_RTOL = 1e-5
ALL = dict(megatron_attn=True, shard_activations=True,
           pin_moe_dispatch=True)
#: (arch, knobs) of the train runs; the last two carry all three knobs
RUNS = {"heads": ("tinyllama-1.1b", dict(megatron_attn=True)),
        "features": ("tinyllama-1.1b", dict(shard_activations=True)),
        "experts": ("granite-moe-3b-a800m", dict(pin_moe_dispatch=True)),
        "all_dense": ("tinyllama-1.1b", ALL),
        "all_moe": ("granite-moe-3b-a800m", ALL),
        "all_bias": ("qwen2-72b", ALL),
        "all_window": ("gemma2-27b", ALL)}
#: world size: the meshes ((shape, runtime, node axis) by label)
MESHES = {2: {"1x2": ((1, 2), "vmap", None)},
          4: {"1x4": ((1, 4), "vmap", None),
              "2x2": ((2, 2), "sharded", "data")}}


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread while the tiny steps run in this process (a
    pool of threads spends more than the work on them, and more beside the
    ranks); the worker's setting back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _cfg(arch):
    return dataclasses.replace(get_config(arch, reduced=True), **CUT,
                               **WINDOW_CUT.get(arch, {}))


def _sc(arch, knobs, runtime="vmap", kind="train"):
    n = N_NODES if kind == "train" else 1
    return steps.StepConfig(
        cfg=_cfg(arch), shape=InputShape(f"tiny_{kind}", SEQ, 2 * n, kind),
        n_nodes=n, chunk=8, ssd_chunk=8, param_dtype=torch.float32,
        runtime=runtime, **knobs)


def _train(arch, knobs, inputs, mesh=None, runtime="vmap", node_axis=None):
    """STEPS steps from the reference's init: ``(losses, leaves of the
    gathered params and optimizer state, step)``."""
    sc = _sc(arch, knobs, runtime)
    params = interop.params_from_numpy(inputs[arch]["params"], "cpu")
    batch = interop.params_from_numpy(inputs[arch]["batch"], "cpu")
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


def _prefill_knobs(arch) -> dict:
    """All three knobs; the heads and the experts on the MoE cut (the
    split prefill the card runs on granite)."""
    return dict(ALL) if _cfg(arch).moe is None else dict(
        megatron_attn=True, pin_moe_dispatch=True)


def _prefill(arch, knobs, inputs, mesh=None):
    """The last logits of a [2, SEQ] prefill of node 0's params (with node
    0's image where the cut has cross blocks), and the MoE's routes."""
    sc = _sc(arch, knobs, kind="prefill")
    params = tree_map(lambda t: t[0], interop.params_from_numpy(
        inputs[arch]["params"], "cpu"))
    tokens = torch.from_numpy(inputs[arch]["batch"]["tokens"][0]).long()
    img = inputs[arch].get("img")
    img = None if img is None else torch.from_numpy(img[0])
    with moe.recording(routes=True) as rec:
        logits, _ = steps.build_prefill_step(sc, mesh=mesh)(params, tokens,
                                                            img)
    routes = [np.concatenate([r["expert_idx"].numpy().ravel(),
                              r["valid"].numpy().ravel()])
              for r in rec["routes"]]
    return logits.numpy(), routes


# ---------------------------------------------------------------------------
# the collectives, against the plain sum / concatenation
# ---------------------------------------------------------------------------

def _rank_input(r, shape):
    return torch.from_numpy(np.random.default_rng(100 + r).standard_normal(
        shape).astype(np.float32))


def _check_collectives(split, world) -> None:
    """Every collective's value, gradient and vmap rule on this rank (raise
    on a mismatch)."""
    r = split.index
    shape = (3, 2, 4 * world)
    xs = [_rank_input(q, shape) for q in range(world)]
    whole, up = sum(xs), _rank_input(50, shape)
    blk = 4

    def grad_of(fn, x, upstream):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        (y * upstream).sum().backward()
        return y.detach(), x.grad

    def blocks(t, q):
        return t[..., q * blk:(q + 1) * blk]

    # all-reduce: the sum; its gradient the upstream's
    y, g = grad_of(split.all_reduce, xs[r], up)
    torch.testing.assert_close(y, whole, rtol=0, atol=1e-6)
    assert torch.equal(g, up)
    # f: the identity; its gradient summed over the ranks' upstreams
    ups = [_rank_input(60 + q, shape) for q in range(world)]
    y, g = grad_of(split.copy, xs[r], ups[r])
    assert torch.equal(y, xs[r])
    torch.testing.assert_close(g, sum(ups), rtol=0, atol=1e-6)
    # reduce-scatter: the rank's block of the sum; the gradient the
    # all-gather of every rank's upstream block
    ups_b = [blocks(u, q) for q, u in enumerate(ups)]
    y, g = grad_of(split.reduce_scatter, xs[r], ups_b[r])
    torch.testing.assert_close(y, blocks(whole, r), rtol=0, atol=1e-6)
    assert torch.equal(g, torch.cat(ups_b, dim=-1))
    # all-gather for a rank's own part: the concatenation; the gradient the
    # reduce-scatter of the ranks' upstreams
    xb = [blocks(x, q) for q, x in enumerate(xs)]
    y, g = grad_of(lambda t: split.all_gather(t, local=True), xb[r], ups[r])
    assert torch.equal(y, torch.cat(xb, dim=-1))
    torch.testing.assert_close(g, blocks(sum(ups), r), rtol=0, atol=1e-6)
    # all-gather for a part every rank computes alike: the slice
    y, g = grad_of(split.all_gather, xb[r], up)
    assert torch.equal(y, torch.cat(xb, dim=-1)) and torch.equal(
        g, blocks(up, r))
    # vocabulary logsumexp: torch.logsumexp of the joined logits
    y, g = grad_of(split.logsumexp, xb[r], up[..., 0])
    full = torch.cat(xb, dim=-1)
    torch.testing.assert_close(y, torch.logsumexp(full, -1), rtol=1e-6,
                               atol=0)
    want = up[..., :1] * torch.softmax(full, -1)
    torch.testing.assert_close(g, blocks(want, r), rtol=1e-5, atol=1e-7)
    # each rule under torch.func.vmap over the leading dim: one collective
    # for the stack, the loop's values (gloo may chunk a longer buffer's
    # sum in another order)
    for fn, x in ((split.all_reduce, xs[r]), (split.copy, xs[r]),
                  (split.reduce_scatter, xs[r]),
                  (lambda t: split.all_gather(t, local=True), xb[r]),
                  (split.all_gather, xb[r]), (split.logsumexp, xb[r])):
        mapped = torch.func.vmap(fn)(x)
        looped = torch.stack([fn(x[i]) for i in range(x.shape[0])])
        torch.testing.assert_close(mapped, looped, rtol=1e-6, atol=1e-6)


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
        for label, (shape, runtime, node_axis) in MESHES[world].items():
            mesh = tmesh.make_debug_mesh(shape, ("data", "model"))
            runs = RUNS if runtime == "vmap" else {
                k: RUNS[k] for k in ("all_dense", "all_moe")}
            for name, (arch, knobs) in runs.items():
                losses, leaves, step = _train(arch, knobs, inputs, mesh,
                                              runtime, node_axis)
                out[f"{label}/{name}/losses"] = losses
                out.update({f"{label}/{name}/leaf{i}": a
                            for i, a in enumerate(leaves)})
                sp, pl = step.split, step.layout.placement
                kept = [p for p in pl.tally.leaves if sp.keep(p)]
                out[f"{label}/{name}/kept_gathered"] = np.array(
                    sum(pl.tally.leaves[p] for p in kept))
                out[f"{label}/{name}/gathered"] = np.array(sorted(
                    "/".join(map(str, p)) for p, b in pl.tally.leaves.items()
                    if b), dtype=object)
                out[f"{label}/{name}/flags"] = np.array(
                    [sp.heads, sp.features, sp.experts, sp.vocab])
            if runtime != "vmap":
                continue
            _check_collectives(sharding.Split(
                steps.Layout.make(_sc(*RUNS["all_dense"]), mesh,
                                  kind="train").placement,
                _cfg("tinyllama-1.1b")), world)
            for arch in PREFILL_ARCHS:
                logits, routes = _prefill(arch, _prefill_knobs(arch), inputs,
                                          mesh)
                out[f"{label}/prefill/{arch}/logits"] = logits
                out.update({f"{label}/prefill/{arch}/route{i}": a
                            for i, a in enumerate(routes)})
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
# the JAX package (this process and one subprocess)
# ---------------------------------------------------------------------------

def _numpy_inputs(arch) -> dict:
    """Both packages' inputs, drawn with numpy: each node's params in the
    LM's tree (the shapes of ``tf.init_lm`` on ``meta``; weights at
    ``1/sqrt(fan_in)``, vectors and the MoE router at 0.1), a batch of
    tokens and, for a cut with cross blocks, each node's image embeddings
    [2, T_img, d]."""
    rng = np.random.default_rng(7)
    cfg = _cfg(arch)
    shapes = tf.init_lm(None, cfg, device="meta")

    def draw(t):
        shape = (N_NODES,) + tuple(t.shape)
        scale = 0.1 if t.dim() < 2 else t.shape[-2] ** -0.5
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    toks = rng.integers(0, CUT["vocab_size"], size=(N_NODES, 2, SEQ + 1),
                        dtype=np.int32)
    out = {"params": tree_map(draw, shapes),
           "batch": {"tokens": toks[..., :-1].copy(),
                     "labels": toks[..., 1:].copy()}}
    if "cross" in cfg.period:
        out["img"] = rng.standard_normal(
            (N_NODES, 2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _jax_cfg(arch):
    from repro.configs import get_config as jget_config
    return dataclasses.replace(jget_config(arch, reduced=True), **CUT,
                               **WINDOW_CUT.get(arch, {}))


def _jax_sc(arch):
    import jax.numpy as jnp
    from repro.configs.base import InputShape as JInputShape
    from repro.launch import steps as jsteps
    return jsteps.StepConfig(
        cfg=_jax_cfg(arch), shape=JInputShape("tiny_train", SEQ,
                                              2 * N_NODES, "train"),
        n_nodes=N_NODES, chunk=8, ssd_chunk=8, param_dtype=jnp.float32,
        **ALL)


def _jax_run(arch, inputs, mesh=None):
    """STEPS steps of the JAX package's train step with all three knobs:
    ``(losses, leaves)``; on ``mesh`` jitted with the dry run's
    in-shardings."""
    import jax
    from repro.launch import sharding as jsharding
    from repro.launch import steps as jsteps
    sc = _jax_sc(arch)
    params = jax.tree.map(jax.numpy.asarray, inputs[arch]["params"])
    batch = jax.tree.map(jax.numpy.asarray, inputs[arch]["batch"])
    opt = jsteps.make_opt(sc)
    o = opt.init(params)
    if mesh is None:
        fn = jax.jit(jsteps.build_train_step(sc))
    else:
        plan = jsharding.make_plan(mesh, n_nodes=N_NODES)

        def named(tree):
            return jsharding.named(plan, jsharding.param_specs(
                plan, tree, node_stacked=True))

        scalar = jax.sharding.NamedSharding(mesh,
                                            jax.sharding.PartitionSpec())
        fn = jax.jit(jsteps.build_train_step(sc, mesh=mesh,
                                             node_axis=plan.node_axis),
                     in_shardings=(named(params), named(o),
                                   jsharding.named(plan, jsharding.
                                                   batch_specs(plan, batch))),
                     out_shardings=(named(params), named(o), scalar))
    p, losses = params, []
    for _ in range(STEPS):
        p, o, loss = fn(p, o, batch)
        losses.append(float(loss))
    return np.array(losses), [np.asarray(a) for a in jax.tree.leaves((p, o))]


def _jax_main(out_dir: str) -> None:
    """The subprocess: the train cuts' JAX steps at ``mesh=None``
    (``none.pkl``), then the first two's on ``make_debug_mesh((2, 2))``
    (``mesh.pkl``), each file written whole under another name and
    renamed."""
    from repro.launch.mesh import make_debug_mesh
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    mesh = make_debug_mesh((2, 2))
    for name in ("none", "mesh"):
        with contextlib.ExitStack() as stack:
            if name == "mesh":
                stack.enter_context(mesh)
            out = {arch: _jax_run(arch, inputs, mesh if name == "mesh"
                                  else None)
                   for arch in (MESH_ARCHS if name == "mesh" else ARCHS)}
        path = os.path.join(out_dir, name + ".pkl")
        with open(path + ".part", "wb") as fh:
            pickle.dump(out, fh)
        os.replace(path + ".part", path)


class _Reference:
    """The numpy inputs, and the JAX package's steps in one subprocess (4
    forced host devices), started at once and read when first needed, so
    that it runs beside the ranks."""

    def __init__(self, d):
        self.dir = d
        self.inputs = {arch: _numpy_inputs(arch)
                       for arch in dict.fromkeys(ARCHS + PREFILL_ARCHS)}
        with open(d / "inputs.pkl", "wb") as fh:
            pickle.dump(self.inputs, fh)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        self.log = open(d / "jax.log", "w")
        self.proc = subprocess.Popen([sys.executable, __file__, str(d)],
                                     env=env, stdout=self.log,
                                     stderr=subprocess.STDOUT)

    def jax(self, name: str) -> dict:
        """The JAX steps' ``(losses, leaves)`` by arch: ``name`` 'none' or
        'mesh'."""
        path = self.dir / f"{name}.pkl"
        deadline = time.monotonic() + JOIN_S
        while not path.exists():
            if self.proc.poll() is not None and not path.exists():
                raise AssertionError(
                    f"the JAX package's steps failed:\n"
                    f"{(self.dir / 'jax.log').read_text()[-4000:]}")
            if time.monotonic() > deadline:
                raise AssertionError(f"no {path.name} in {JOIN_S} s")
            time.sleep(0.2)
        with open(path, "rb") as fh:
            return pickle.load(fh)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("tp_reference"))
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
    ref.proc.wait()
    ref.log.close()


@pytest.fixture(scope="module")
def unsplit(reference):
    """The port's unsplit train runs (by RUNS name) and prefills (by arch),
    once for both world sizes."""
    inputs = reference.inputs
    with _one_thread():
        runs = {name: _train(arch, knobs, inputs)[:2]
                for name, (arch, knobs) in RUNS.items()}
        prefills = {arch: _prefill(arch, _prefill_knobs(arch), inputs)
                    for arch in PREFILL_ARCHS}
    return runs, prefills


def _held(got_losses, got_leaves, want, what):
    losses, leaves = want
    np.testing.assert_allclose(got_losses, losses, err_msg=what, **TOL)
    assert len(got_leaves) == len(leaves), what
    for i, (g, w) in enumerate(zip(got_leaves, leaves)):
        assert g.shape == w.shape, (what, i)
        np.testing.assert_allclose(g, w, err_msg=f"{what} leaf {i}", **TOL)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_split_matches_unsplit_and_reference(world, tmp_path, reference,
                                             unsplit):
    with open(tmp_path / "inputs.pkl", "wb") as fh:
        pickle.dump(reference.inputs, fh)
    ranks = _spawn(world, tmp_path)
    unsplit, prefills = unsplit
    jax_none = reference.jax("none")
    jax_mesh = reference.jax("mesh") if world == 4 else None
    for r, got in enumerate(ranks):
        for label in MESHES[world]:
            for name, (arch, knobs) in RUNS.items():
                key = f"{label}/{name}"
                if f"{key}/losses" not in got:
                    continue
                what = f"rank {r} {key}"
                leaves = [got[f"{key}/leaf{i}"]
                          for i in range(len(unsplit[name][1]))]
                _held(got[f"{key}/losses"], leaves, unsplit[name], what)
                heads, features, experts, vocab = got[f"{key}/flags"]
                assert heads == knobs.get("megatron_attn", False), what
                assert features == vocab == knobs.get("shard_activations",
                                                      False), what
                dense = _cfg(arch).moe is None
                assert experts == (knobs.get("pin_moe_dispatch", False)
                                   and not dense), what
                # a leaf the split computes with is never gathered
                assert got[f"{key}/kept_gathered"] == 0, what
                gathered = set(got[f"{key}/gathered"])
                if knobs == ALL and dense:
                    assert not gathered, (what, gathered)
                if knobs == ALL and not dense:
                    assert {g.rsplit("/", 1)[1] for g in gathered} == {
                        "router"}, (what, gathered)
                if knobs == ALL:
                    _held(got[f"{key}/losses"], leaves, jax_none[arch],
                          f"{what} vs JAX")
                    if label == "2x2":
                        _held(got[f"{key}/losses"], leaves, jax_mesh[arch],
                              f"{what} vs JAX on (2, 2)")
        label = next(iter(MESHES[world]))
        for arch in PREFILL_ARCHS:
            want, routes = prefills[arch]
            logits = got[f"{label}/prefill/{arch}/logits"]
            err = np.abs(logits - want).max() / np.abs(want).max()
            assert err <= LOGIT_RTOL, (r, arch, err)
            assert np.array_equal(logits.argmax(-1), want.argmax(-1))
            for i, w in enumerate(routes):
                assert np.array_equal(got[f"{label}/prefill/{arch}/route{i}"],
                                      w), (r, arch, i)
            assert len(routes) == (0 if _cfg(arch).moe is None else 2)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
