"""The compute split over 'model' (``launch/sharding.Split``) of the
Mamba-2 and cross-attention blocks across gloo ranks on the CPU, held
against the unsplit step and the JAX package.

The cuts (d 64, ff 128, V 256, fp32, 2 layers, SSM heads 8 of P 16, from
one numpy draw of the params, the batch and the image that both packages
take):

* zamba2-7b: mamba blocks and the shared block at window 16; ``in_proj``
  is 296 wide, so 'model' 2 and 4 store it by column blocks that do not
  line up with the heads (the all-to-all route);
* mamba2-130m at ``d_state`` 17: ``in_proj`` is 298 wide, a column block
  at 'model' 2; at 4 the block lies on d_model (the row-parallel route,
  its partial sums all-reduced whole), and ``conv_w`` is not stored by
  'model';
* llama-3.2-vision-11b: a dense and a cross block, 16 image tokens; its 2
  K/V heads divide 'model' 2 (each rank reads its own K/V heads) and are
  repeated to the 4 query heads at 'model' 4.

At world sizes 2 and 4 (``('data', 'model')`` meshes of (1, 2) and (1, 4),
the vmap runtime with both nodes on every rank; at 4 also (2, 2), the
sharded runtime with a node a 'data' rank), with ``megatron_attn``,
``shard_activations`` and ``pin_moe_dispatch``:

* 3 train steps, 2 nodes x [2, 32]: the losses, the gathered final params
  and m_hat within rtol 1e-5 / atol 1e-6 of ``mesh=None`` with the knobs,
  elementwise, and normwise (``max |got - want| <= 1e-6 + 1e-5 max
  |want|`` an array, as ``test_torch_decode_gloo`` holds) of the JAX
  package's ``build_train_step`` with them at ``mesh=None``; at (2, 2)
  also of the JAX step jitted on ``make_debug_mesh((2, 2))`` with
  in-shardings (the port's own ``mesh=None`` reaches 0.89 of the
  elementwise bound against the JAX package on zamba2's embedding after 3
  steps, so the split's sum order would cross it);
* a [2, 32] prefill (vmap meshes): the last logits (argmax equal) and
  every cache leaf (the SSM and conv states, the shared block's K/V, the
  image K/V) within the same tolerance, normwise, of ``mesh=None`` and of
  the JAX package's prefill (whose states the port's ``mesh=None`` meets
  only normwise: 4.85 times the elementwise bound on the small entries of
  zamba2's SSM state); the same prefill with ``use_pallas=True`` passes the
  scan kernel's operands
  as views it takes (``kernels/ssd_scan._token_stride``: x, B and C
  slices of one ``[x of the rank's heads | B | C]`` conv output);
* ``Split.regroup``, the all-to-all that moves ``in_proj``'s column
  blocks to the ranks' heads: its value, gradient and vmap rule against
  the plain cut of the whole tensor;
* the split's flags (the attention and SSM heads, the features) and its
  ``Tally``: no byte of a leaf the split computes with is gathered; what
  is gathered is ``conv_w`` alone; the column route's all-to-all is on
  the wire.

The JAX package runs in a subprocess an arch and a mesh (4 forced host
devices) beside the ranks; the ranks import nothing of it.  Run alone: ``PYTHONPATH=src python
-m pytest -q tests/test_torch_tp_ssm_gloo.py``.
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
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import distributed, sharding, steps
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves, tree_map, tree_paths

from test_torch_tp_gloo import (ALL, CUT, JOIN_S, MESHES, N_NODES, SEQ,
                                STEPS, TOL, WINDOW_CUT, _one_thread)

ARCHS = ("zamba2-7b", "mamba2-130m", "llama-3.2-vision-11b")
#: the SSM cut of each arch beyond the reduced config's
SSM_CUT = {"mamba2-130m": dict(d_state=17)}
#: the leaves a split may gather whole on use under the three knobs
GATHERED = {"conv_w"}


def _cfg(arch, cfgs=None):
    """The cut of ``arch`` (``cfgs``: the JAX package's configs module in
    its subprocess)."""
    base = (cfgs.get_config if cfgs else get_config)(arch, reduced=True)
    cfg = dataclasses.replace(base, **CUT, **WINDOW_CUT.get(arch, {}))
    if arch in SSM_CUT:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, **SSM_CUT[arch]))
    return cfg


def _sc(arch, kind="train", runtime="vmap"):
    n = N_NODES if kind == "train" else 1
    return steps.StepConfig(
        cfg=_cfg(arch), shape=InputShape(f"tiny_{kind}", SEQ, 2 * n, kind),
        n_nodes=n, chunk=8, ssd_chunk=8, param_dtype=torch.float32,
        runtime=runtime, **ALL)


def _numpy_inputs(arch) -> dict:
    """Each node's params in the LM's tree (weights at ``1/sqrt(fan_in)``,
    vectors at 0.1) and its batch of tokens, with its image embeddings [2,
    T_img, d] for a cut with cross blocks."""
    rng = np.random.default_rng(11)
    cfg = _cfg(arch)

    def draw(t):
        scale = 0.1 if t.dim() < 2 else t.shape[-2] ** -0.5
        return (rng.standard_normal((N_NODES,) + tuple(t.shape))
                * scale).astype(np.float32)

    params = tree_map(draw, tf.init_lm(None, cfg, device="meta"))
    toks = rng.integers(0, CUT["vocab_size"], size=(N_NODES, 2, SEQ + 1),
                        dtype=np.int32)
    batch = {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}
    if "cross" in cfg.period:
        batch["image_embeds"] = rng.standard_normal(
            (N_NODES, 2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return {"params": params, "batch": batch}


def _train(arch, inputs, mesh=None, runtime="vmap", node_axis=None):
    """STEPS steps from the numpy init: ``(losses, leaves of the gathered
    params and optimizer state, step)``."""
    sc = _sc(arch, runtime=runtime)
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


def _prefill(arch, inputs, mesh=None, use_pallas=False):
    """Node 0's [2, SEQ] prefill: ``(last logits, leaves of the whole
    cache, the prefill step)``; with ``use_pallas`` through ``tf.prefill``
    on the step's placement and split."""
    sc = _sc(arch, kind="prefill")
    params = tree_map(lambda t: t[0], interop.params_from_numpy(
        inputs[arch]["params"], "cpu"))
    batch = inputs[arch]["batch"]
    tokens = torch.from_numpy(batch["tokens"][0]).long()
    img = batch.get("image_embeds")
    img = None if img is None else torch.from_numpy(img[0])
    fn = steps.build_prefill_step(sc, mesh=mesh)
    if use_pallas:
        lay = fn.layout
        logits, cache = tf.prefill(
            lay.local("params", params), tokens, sc.cfg, img=img,
            chunk=sc.chunk, ssd_chunk=sc.ssd_chunk, cache_len=SEQ,
            repeat_kv=True, use_pallas=True, placement=lay.placement,
            split=fn.split)
    else:
        logits, cache = fn(params, tokens, img)
    if mesh is not None:
        cache = sharding.gather_tree(fn.layout.plan,
                                     fn.layout.specs["cache"], cache)
    return logits.numpy(), [t.numpy() for t in tree_leaves(cache)], fn


@contextlib.contextmanager
def _scan_views(seen: list):
    """``kops.ssd_scan`` recording the token strides of x, B and C by the
    kernel's own view check (``ValueError`` on a layout it refuses)."""
    scan = kops.ssd_scan

    def checked(x, dt, a, b, c, d_skip, *, chunk=128):
        heads, p, n = x.shape[2], x.shape[3], b.shape[-1]
        seen.append((kssd._token_stride("x", x, (heads, p)),
                     kssd._token_stride("b", b, (n,)),
                     kssd._token_stride("c", c, (n,)), heads,
                     x.data_ptr() + heads * p * 4 == b.data_ptr(),
                     b.data_ptr() + n * 4 == c.data_ptr()))
        return scan(x, dt, a, b, c, d_skip, chunk=chunk)

    kops.ssd_scan = checked
    try:
        yield seen
    finally:
        kops.ssd_scan = scan


def _check_regroup(split, world) -> None:
    """``Split.regroup`` (one all-to-all) against the plain cut of the
    whole tensor: its value, its gradient (each column's upstream back on
    the rank that holds it, zero where no rank took one) and its vmap rule
    (raise on a mismatch).  The ranges cross the blocks unevenly and leave
    columns untaken, as ``in_proj``'s z, x and dt do."""
    r, width = split.index, 7
    whole = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 2, width * world)).astype(np.float32))

    def ranges(t):
        return ((2 * t, 2), (2 * world + 3 * t, 3), (6 * world + t, 1))

    want = torch.cat([whole[..., a:a + n] for a, n in ranges(r)], dim=-1)
    ups = [torch.from_numpy(np.random.default_rng(20 + t).standard_normal(
        (3, 2, 6)).astype(np.float32)) for t in range(world)]
    full_up = torch.zeros_like(whole)
    for t in range(world):
        at = 0
        for a, n in ranges(t):
            full_up[..., a:a + n] = ups[t][..., at:at + n]
            at += n
    x = whole[..., r * width:(r + 1) * width].clone().requires_grad_(True)
    y = split.regroup(x, ranges)
    assert torch.equal(y, want), (y, want)
    (y * ups[r]).sum().backward()
    assert torch.equal(x.grad, full_up[..., r * width:(r + 1) * width])
    mapped = torch.func.vmap(lambda t: split.regroup(t, ranges))(x.detach())
    assert torch.equal(mapped, want)


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
            for arch in ARCHS:
                key = f"{label}/{arch}"
                losses, leaves, step = _train(arch, inputs, mesh, runtime,
                                              node_axis)
                out[f"{key}/losses"] = losses
                out[f"{key}/leaves"] = leaves
                sp, pl = step.split, step.layout.placement
                out[f"{key}/kept_gathered"] = sum(
                    b for p, b in pl.tally.leaves.items() if sp.keep(p))
                out[f"{key}/gathered"] = sorted(
                    p[-1] for p, b in pl.tally.leaves.items() if b)
                out[f"{key}/flags"] = (sp.heads, sp.ssm, sp.features)
                out[f"{key}/wire"] = dict(sp.tally.wire)
                out[f"{key}/model_dims"] = {
                    name: sp.model_dim(("blocks", 0, "mixer", name))
                    for name in ("in_proj", "out_proj")} \
                    if "mamba" in sp.cfg.period else {}
                if runtime != "vmap":
                    continue
                if arch == ARCHS[0]:
                    _check_regroup(step.split, shape[1])
                logits, cache, _ = _prefill(arch, inputs, mesh)
                out[f"{key}/prefill"] = (logits, cache)
                with _scan_views([]) as seen:
                    logits, cache, _ = _prefill(arch, inputs, mesh,
                                                use_pallas=True)
                out[f"{key}/pallas"] = (logits, cache, seen)
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

def _jax_sc(arch, kind="train"):
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.configs.base import InputShape as JInputShape
    from repro.launch import steps as jsteps
    n = N_NODES if kind == "train" else 1
    return jsteps.StepConfig(
        cfg=_cfg(arch, jconfigs), shape=JInputShape(
            f"tiny_{kind}", SEQ, 2 * n, kind),
        n_nodes=n, chunk=8, ssd_chunk=8, param_dtype=jnp.float32, **ALL)


def _jax_train(arch, inputs, mesh=None):
    """STEPS steps of the JAX package's train step with the three knobs:
    ``(losses, leaves)``; on ``mesh`` jitted with the dry run's
    in-shardings."""
    import jax
    from repro.launch import sharding as jsharding
    from repro.launch import steps as jsteps
    sc = _jax_sc(arch)
    params = jax.tree.map(jax.numpy.asarray, inputs[arch]["params"])
    batch = jax.tree.map(jax.numpy.asarray, inputs[arch]["batch"])
    o = jsteps.make_opt(sc).init(params)
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


def _jax_prefill(arch, inputs):
    """Node 0's prefill through the JAX package's ``build_prefill_step``
    with the knobs at ``mesh=None``: ``(last logits, cache leaves)``."""
    import jax
    from repro.launch import steps as jsteps
    params = jax.tree.map(lambda a: jax.numpy.asarray(a[0]),
                          inputs[arch]["params"])
    batch = inputs[arch]["batch"]
    img = batch.get("image_embeds")
    img = None if img is None else jax.numpy.asarray(img[0])
    logits, cache = jax.jit(jsteps.build_prefill_step(
        _jax_sc(arch, "prefill")))(params, jax.numpy.asarray(
            batch["tokens"][0]), img)
    return np.asarray(logits), [np.asarray(a) for a in jax.tree.leaves(cache)]


def _jax_main(out_dir: str, name: str, arch: str) -> None:
    """A subprocess: ``name`` 'none', the cut's JAX train step and prefill
    at ``mesh=None``, or 'mesh', its train step on
    ``make_debug_mesh((2, 2))`` (or the error where it does not compile);
    ``<name>_<arch>.pkl`` written whole under another name and renamed."""
    from repro.launch.mesh import make_debug_mesh
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    if name == "none":
        out = (_jax_train(arch, inputs), _jax_prefill(arch, inputs))
    else:
        mesh = make_debug_mesh((2, 2))
        with mesh:
            try:
                out = _jax_train(arch, inputs, mesh)
            except Exception as e:  # noqa: BLE001 -- reported by name
                out = f"{type(e).__name__}: {e}"
    path = os.path.join(out_dir, f"{name}_{arch}.pkl")
    with open(path + ".part", "wb") as fh:
        pickle.dump(out, fh)
    os.replace(path + ".part", path)


class _Reference:
    """The numpy inputs, and the JAX package's runs in a subprocess an arch
    and a mesh (4 forced host devices), all started at once beside the
    ranks and read when first needed."""

    def __init__(self, d):
        self.dir = d
        self.inputs = {arch: _numpy_inputs(arch) for arch in ARCHS}
        with open(d / "inputs.pkl", "wb") as fh:
            pickle.dump(self.inputs, fh)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        self.procs = {}
        for name in ("none", "mesh"):
            for arch in ARCHS:
                log = open(d / f"jax_{name}_{arch}.log", "w")
                self.procs[name, arch] = (subprocess.Popen(
                    [sys.executable, __file__, str(d), name, arch], env=env,
                    stdout=log, stderr=subprocess.STDOUT), log)

    def jax(self, name: str) -> dict:
        """The JAX runs by arch: ``name`` 'none' or 'mesh'."""
        out = {}
        for arch in ARCHS:
            path = self.dir / f"{name}_{arch}.pkl"
            proc = self.procs[name, arch][0]
            deadline = time.monotonic() + JOIN_S
            while not path.exists():
                if proc.poll() is not None and not path.exists():
                    log = self.dir / f"jax_{name}_{arch}.log"
                    raise AssertionError(
                        f"the JAX package's runs failed:\n"
                        f"{log.read_text()[-4000:]}")
                if time.monotonic() > deadline:
                    raise AssertionError(f"no {path.name} in {JOIN_S} s")
                time.sleep(0.2)
            with open(path, "rb") as fh:
                out[arch] = pickle.load(fh)
        return out

    def close(self) -> None:
        for proc, log in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("tp_ssm_reference"))
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def unsplit(reference):
    """The port's unsplit train runs and prefills by arch, once for both
    world sizes."""
    with _one_thread():
        return {arch: (_train(arch, reference.inputs)[:2],
                       _prefill(arch, reference.inputs)[:2])
                for arch in ARCHS}


def _held(got, want, what, *, normwise=False):
    """Two lists of arrays within TOL, elementwise or ``normwise``: ``max
    |got - want| <= atol + rtol max |want|`` for each array."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, i)
        if not normwise:
            np.testing.assert_allclose(g, w, err_msg=f"{what} #{i}", **TOL)
            continue
        err = float(np.abs(g - w).max(initial=0.0))
        bound = TOL["atol"] + TOL["rtol"] * float(np.abs(w).max(initial=0.0))
        assert err <= bound, (what, i, err, bound)


def _held_run(got, want, what, *, normwise=False):
    """``(losses, leaves)`` pairs."""
    _held(got[0], want[0], f"{what} losses", normwise=normwise)
    _held(got[1], want[1], f"{what} leaves", normwise=normwise)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_ssm_cross_split_matches_unsplit_and_reference(world, tmp_path,
                                                       reference, unsplit):
    with open(tmp_path / "inputs.pkl", "wb") as fh:
        pickle.dump(reference.inputs, fh)
    ranks = _spawn(world, tmp_path)
    jax_none = reference.jax("none")
    jax_mesh = reference.jax("mesh") if world == 4 else None
    for r, got in enumerate(ranks):
        for label, (shape, runtime, _) in MESHES[world].items():
            m = shape[1]
            for arch in ARCHS:
                key, what = f"{label}/{arch}", f"rank {r} {label} {arch}"
                run = (got[f"{key}/losses"], got[f"{key}/leaves"])
                (want_run, want_prefill), (jrun, jprefill) = \
                    unsplit[arch], jax_none[arch]
                _held_run(run, want_run, what)
                _held_run(run, jrun, f"{what} vs JAX", normwise=True)
                if label == "2x2":
                    assert not isinstance(jax_mesh[arch], str), \
                        jax_mesh[arch]
                    _held_run(run, jax_mesh[arch], f"{what} vs JAX (2, 2)",
                              normwise=True)
                heads, ssm, features = got[f"{key}/flags"]
                cfg = _cfg(arch)
                assert features, what
                assert heads == ("cross" in cfg.period
                                 or bool(cfg.shared_attn_every)), what
                assert ssm == ("mamba" in cfg.period), what
                # no byte of a leaf the split computes with is gathered
                assert got[f"{key}/kept_gathered"] == 0, what
                assert set(got[f"{key}/gathered"]) <= GATHERED, what
                dims, wire = got[f"{key}/model_dims"], got[f"{key}/wire"]
                if arch == "mamba2-130m" and m == 4:
                    assert dims == {"in_proj": -2, "out_proj": -2}, what
                    assert "all-to-all" not in wire, what
                elif "mamba" in cfg.period:
                    assert dims == {"in_proj": -1, "out_proj": -2}, what
                    assert wire["all-to-all"] > 0, what
                if runtime != "vmap":
                    continue
                logits, cache = got[f"{key}/prefill"]
                want = [want_prefill[0], *want_prefill[1]]
                _held([logits, *cache], want, f"{what} prefill",
                      normwise=True)
                _held([logits, *cache], [jprefill[0], *jprefill[1]],
                      f"{what} prefill vs JAX", normwise=True)
                assert np.array_equal(logits.argmax(-1),
                                      want[0].argmax(-1)), what
                logits, cache, seen = got[f"{key}/pallas"]
                _held([logits, *cache], want, f"{what} prefill use_pallas",
                      normwise=True)
                if "mamba" not in cfg.period:
                    assert not seen, what
                    continue
                # one launch a mamba layer, on the rank's heads, its x, B
                # and C views of one [x | B | C] row of di / M + 2N
                nh = cfg.ssm.n_heads(cfg.d_model)
                di, n = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.d_state
                assert len(seen) == cfg.n_layers, what
                for ts_x, ts_b, ts_c, heads_r, b_next, c_next in seen:
                    assert heads_r == nh // m, what
                    assert ts_x == ts_b == ts_c == di // m + 2 * n, what
                    assert b_next and c_next, what


def test_ssm_and_cross_leaves_the_split_keeps():
    """Which mixer, cross and norm leaves the split computes with on each
    cut's layout at 'model' 2 and 4 (``MeshShape``): the ones its knobs
    use where 'model' stores them, ``conv_w`` and the gates never; a
    decode's split the mixers' projections and ``conv_w`` (not mamba2-130m's
    at 'model' 4, where neither it nor the conv cache is stored by
    'model')."""
    for m in (2, 4):
        mesh = tmesh.MeshShape((("data", 1), ("model", m)))
        for arch in ARCHS:
            sc = _sc(arch, kind="prefill")
            lay = steps.Layout.make(sc, mesh, kind="prefill")
            sp = steps.make_split(sc, lay)
            assert sp.whole == ()
            for path in tree_paths(lay.shapes["params"]):
                name, parent = path[-1], path[-2] if len(path) > 1 else None
                kept = sp.keep(path)
                if name in ("conv_w", "gate_attn", "gate_mlp"):
                    assert not kept, (arch, m, path)
                elif parent == "mixer" or parent == "xattn" or (
                        parent == "mlp" or name in ("ln", "ln1", "ln2")):
                    want = lay.placement.model_dim(path) is not None
                    assert kept == want, (arch, m, path)
            # a decode's split: every config's mixers (no heads rule), the
            # projections where 'model' stores them, ``conv_w`` where it
            # stores the conv cache by the same channel block, the per-head
            # vectors gathered; the cross leaves as the prefill's
            dsp = steps.make_split(sc, lay, decode=True)
            cfg = sc.cfg
            assert dsp.decode and dsp.whole == ()
            assert dsp.ssm == ("mamba" in cfg.period)
            for path in tree_paths(lay.shapes["params"]):
                name, parent = path[-1], path[-2] if len(path) > 1 else None
                d = lay.placement.model_dim(path)
                if parent == "mixer" and name in ("in_proj", "out_proj"):
                    want = d is not None
                elif parent == "mixer" and name == "conv_w":
                    conv = sharding.Placement._at(lay.specs["cache"],
                                                  path[:-2] + ("conv",))
                    want = d == -1 and conv[-1] == "model"
                    if arch == "mamba2-130m":     # 162 channels
                        assert want == (m == 2), (arch, m, path)
                elif parent == "mixer":
                    want = False
                elif parent in ("xattn", "mlp") or name in ("ln", "ln1",
                                                            "ln2"):
                    want = sp.keep(path)
                else:
                    continue
                assert dsp.keep(path) == want, (arch, m, path)


if __name__ == "__main__":
    _jax_main(*sys.argv[1:4])
