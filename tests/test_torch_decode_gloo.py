"""The pinned decode (``pin_decode_cache``: a decode step on the rank's
stored cache blocks, ``sharding.CacheBlock``) across gloo ranks on the
CPU, held against ``mesh=None`` and the JAX package's decode.

The cuts: TinyLlama, gemma2-27b (local/global layers at window 8, both
softcaps), zamba2-7b (mamba blocks, the shared block at window 8),
llama-3.2-vision-11b (cross blocks, 16 image tokens), granite-moe-3b (4
experts) and mamba2-130m, at 2 layers, d 64, 4 heads / 2 KV heads, ff
128, V 256, fp32; on the (1, 4) mesh also TinyLlama at head_dim 6, with 2
KV heads ('model' goes to the cache's length: no other dim divides) and
with 8 / 4 heads ('model' on the K/V heads), and mamba2-130m at
``d_state`` 17 (``in_proj`` 298 wide: 'model' 4 stores it by its input
rows, as at full width, and stores neither ``conv_w`` nor the conv cache).
The decode split computes the mamba mixers' ``in_proj`` / ``out_proj``
(and ``conv_w`` where 'model' stores it by the conv cache's channel
block) and the cross blocks' ``wq`` / ``wo`` and MLP on the rank's
blocks.  Each case: a [B, 12] prefill through the split prefill builder,
then 3 decode steps of numpy tokens (positions 12
to 14, a 24-slot cache; the local layers' 8-slot ring buffers wrap), at B
2 and, for TinyLlama, B 1 (the cache's length then goes on 'data').

At world size 2 the ``('data', 'model')`` mesh of (1, 2) ('model' on the
features), and at 4 the meshes (2, 2) (the rows, or at B 1 the slots, on
'data'), (1, 4) (the head_dim-6 and ``d_state``-17 cuts) and ``('pod', 'data', 'model')`` of
(2, 1, 2) (rows and slots on two data axes), the three split knobs on
(and off for TinyLlama on (1, 2)):

* every step's logits and the gathered final caches within rtol 1e-5 /
  atol 1e-6 of ``mesh=None``, normwise: ``max |got - want| <= 1e-6 +
  1e-5 max |want|`` for each array (the partial sums meet in another
  order; the LM's residual stream is small at these draws, so its last
  norm scales a rounding of the attention by ~16, and an elementwise rtol
  fails on the logits near 0: the JAX package's own (2, 2) decode against
  the port's ``mesh=None`` reaches 2.6 times the elementwise bound, and
  1.25e-06 of the largest logit);
* on (2, 2), TinyLlama at B 1, gemma2, zamba2 and the VLM also of the JAX
  package's decode jitted on ``make_debug_mesh((2, 2))`` with the
  ``cache_specs`` in-shardings and the ``pin_decode_cache`` constraint
  (none where no block keeps a K cache: zamba2), as its dry run's
  ``lower_decode`` compiles it (after its own prefill);
* the placement's tally: 0 bytes gathered of any cache leaf; on the meshes
  whose 'data' axes are 1, 0 bytes of any mixer's ``in_proj`` /
  ``out_proj``, of ``conv_w`` where 'model' stores it and the conv cache
  by the same channel block, and of a cross block's ``xattn.wq`` / ``wo``
  and MLP leaves.

The JAX package runs in one subprocess (4 forced host devices) started
with the module's fixture, beside the ranks; the ranks import nothing of
it.  Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_decode_gloo.py``.
"""
from __future__ import annotations

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
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves, tree_map, tree_paths

JOIN_S = 240
PROMPT, CAP, STEPS = 12, 24, 3
CUT = dict(d_model=64, d_ff=128, vocab_size=256)
TOL = dict(rtol=1e-5, atol=1e-6)
ALL = dict(megatron_attn=True, shard_activations=True,
           pin_moe_dispatch=True)
#: name: (arch, batch, config overrides)
CASES = {"dense": ("tinyllama-1.1b", 2, {}),
         "long": ("tinyllama-1.1b", 1, {}),
         "window": ("gemma2-27b", 2, dict(window=8)),
         "hybrid": ("zamba2-7b", 2, dict(window=8)),
         "cross": ("llama-3.2-vision-11b", 2, {}),
         "experts": ("granite-moe-3b-a800m", 2, {}),
         "slots": ("tinyllama-1.1b", 2, dict(head_dim=6)),
         "heads": ("tinyllama-1.1b", 2, dict(head_dim=6, n_heads=8,
                                             n_kv_heads=4)),
         "ssm": ("mamba2-130m", 2, {}),
         "ssm17": ("mamba2-130m", 2, dict(ssm=dict(d_state=17)))}
#: the cases the ('data', 'model') meshes of (1, 2) and (2, 2) run with the
#: knobs on (and (1, 2) "dense" off too)
BASE = ("dense", "long", "window", "hybrid", "cross", "experts", "ssm")
DM = ("data", "model")
#: world size: {label: (mesh shape, axis names, cases with the knobs on)}
MESHES = {2: {"1x2": ((1, 2), DM, BASE)},
          4: {"2x2": ((2, 2), DM, BASE),
              "1x4": ((1, 4), DM, ("slots", "heads", "ssm17")),
              "2x1x2": ((2, 1, 2), ("pod", "data", "model"),
                        ("long", "hybrid"))}}
#: the cases the JAX package decodes on its (2, 2) mesh
JAX_CASES = ("long", "window", "hybrid", "cross")
#: the leaves a decode split computes with on the rank's 'model' block:
#: (the parent's name, the leaf's names)
KEPT = (("mixer", ("in_proj", "out_proj")), ("xattn", ("wq", "wo")),
        ("mlp", ("gate", "up", "down")))


def _runs(world, label):
    """(case, knobs) of one mesh's runs."""
    out = [(c, "all") for c in MESHES[world][label][2]]
    return out + [("dense", "off")] if label == "1x2" else out


def _cfg(name, get=get_config):
    """The case's cut (``get``: a package's ``get_config``)."""
    arch, _, over = CASES[name]
    over = dict(over)
    ssm = over.pop("ssm", None)
    cfg = dataclasses.replace(get(arch, reduced=True), **CUT, **over)
    if ssm:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               **ssm))
    return cfg


def _watched(fn, cfg) -> dict:
    """The bytes a decode step's placement gathered of each leaf that must
    gather nothing along 'model' (``KEPT``, the MLP's in cross blocks, and
    each mixer's ``conv_w`` where 'model' stores it by the conv cache's
    channel block), by path."""
    lay = fn.layout
    specs, cache = lay.specs["params"], lay.specs["cache"]
    out = {}
    for path in tree_paths(lay.shapes["params"]):
        if len(path) < 2:
            continue
        parent, name = path[-2:]
        kind = cfg.period[path[1] if path[0] == "blocks" else 0]
        watched = any(parent == p and name in names for p, names in KEPT) \
            and (parent != "mlp" or kind == "cross")
        if parent == "mixer" and name == "conv_w":
            spec = sharding.Placement._at(specs, path)
            conv = sharding.Placement._at(cache, path[:-2] + ("conv",))
            watched = spec[-1] == conv[-1] == "model"
        if watched:
            out["/".join(map(str, path))] = \
                lay.placement.tally.leaves.get(path, 0)
    return out


def _sc(name, knobs, **extra):
    """The case's StepConfig, pinned; ``extra`` overrides fields."""
    kw = dict(n_nodes=1, chunk=8, ssd_chunk=4, param_dtype=torch.float32,
              pin_decode_cache=True, **(ALL if knobs == "all" else {}))
    return steps.StepConfig(
        cfg=_cfg(name), shape=InputShape("tiny_decode", CAP, CASES[name][1],
                                         "decode"), **dict(kw, **extra))


def _numpy_inputs(name) -> dict:
    """Both packages' inputs: the params in the LM's tree (weights at
    ``1/sqrt(fan_in)``, vectors and the router at 0.1), the prompt, the
    decode tokens and, with cross blocks, the image embeddings."""
    rng = np.random.default_rng(11)
    cfg, b = _cfg(name), CASES[name][1]

    def draw(t):
        scale = 0.1 if t.dim() < 2 else t.shape[-2] ** -0.5
        return (rng.standard_normal(tuple(t.shape)) * scale).astype(
            np.float32)

    out = {"params": tree_map(draw, tf.init_lm(None, cfg, device="meta")),
           "tokens": rng.integers(0, CUT["vocab_size"],
                                  size=(b, PROMPT + STEPS), dtype=np.int32)}
    if cfg.n_image_tokens:
        out["img"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _decode(name, knobs, inputs, mesh=None, gather=True, **extra):
    """The prefill and STEPS decode steps: ``(logits of each, the final
    cache's leaves (gathered unless not ``gather``), the decode step)``;
    ``extra`` overrides StepConfig fields (a ``param_dtype`` casts the
    params and the image)."""
    sc = _sc(name, knobs, **extra)
    params = tree_map(lambda t: t.to(sc.param_dtype),
                      interop.params_from_numpy(inputs["params"], "cpu"))
    toks = torch.from_numpy(inputs["tokens"]).long()
    img = inputs.get("img")
    img = None if img is None else torch.from_numpy(img).to(sc.param_dtype)
    logits, cache = steps.build_prefill_step(sc, mesh=mesh)(
        params, toks[:, :PROMPT], img)
    fn = steps.build_decode_step(sc, mesh=mesh)
    out = [logits]
    for i in range(STEPS):
        logits, cache = fn(params, toks[:, PROMPT + i:PROMPT + i + 1],
                           PROMPT + i, cache)
        out.append(logits)
    if mesh is not None and gather:
        cache = sharding.gather_tree(fn.layout.plan,
                                     fn.layout.specs["cache"], cache)
    return [t.float().numpy() for t in out], [
        t.float().numpy() for t in tree_leaves(cache)], fn


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
        for label, (shape, axes, _) in MESHES[world].items():
            mesh = tmesh.make_debug_mesh(shape, axes)
            for name, knobs in _runs(world, label):
                logits, cache, fn = _decode(name, knobs, inputs[name], mesh)
                key = f"{label}/{name}/{knobs}"
                out[key] = (logits, cache, fn.pinned,
                            sum(fn.layout.placement.tally.caches.values()),
                            fn.split is not None,
                            _watched(fn, _cfg(name)))
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

def _jax_decode(name, inputs, mesh):
    """The JAX package's prefill (unsharded) and STEPS decode steps jitted
    on ``mesh`` as its ``lower_decode`` does (``cache_specs``
    in-shardings, the ``pin_decode_cache`` constraint): ``(logits,
    cache leaves)``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config as jget_config
    from repro.configs.base import InputShape as JInputShape
    from repro.launch import sharding as jsharding
    from repro.launch import steps as jsteps

    arch, b, _ = CASES[name]
    cfg = _cfg(name, jget_config)
    sc = jsteps.StepConfig(cfg=cfg, shape=JInputShape("tiny_decode", CAP, b,
                                                      "decode"),
                           n_nodes=1, chunk=8, ssd_chunk=4,
                           param_dtype=jnp.float32, pin_decode_cache=True)
    plan = jsharding.make_plan(mesh, n_nodes=1)
    params = jax.tree.map(jnp.asarray, inputs["params"])
    toks = jnp.asarray(inputs["tokens"])
    img = inputs.get("img")
    logits, cache = jax.jit(jsteps.build_prefill_step(sc))(
        params, toks[:, :PROMPT], None if img is None else jnp.asarray(img))
    specs = jsharding.cache_specs(plan, cache,
                                  shard_features=sc.cache_shard_features)
    flat, _ = jax.tree_util.tree_flatten_with_path(specs)
    constraint = None
    for kp, spec in flat:
        keys = [getattr(pp, "key", getattr(pp, "idx", None)) for pp in kp]
        if keys and keys[-1] == "k" and "blocks" in keys:
            constraint = NamedSharding(mesh, P(*spec[1:]))
            break
    pspec = jsharding.param_specs(plan, params, node_stacked=False)
    scalar = NamedSharding(mesh, P())
    shardings = (jsharding.named(plan, pspec),
                 jsharding.named(plan, jsharding.batch_specs(plan,
                                                             toks[:, :1])),
                 scalar, jsharding.named(plan, specs))
    with mesh:
        fn = jax.jit(jsteps.build_decode_step(sc,
                                              cache_constraint=constraint),
                     in_shardings=shardings)
        params, cache = (jax.device_put(t, s) for t, s in
                         ((params, shardings[0]), (cache, shardings[3])))
        out = [np.asarray(logits)]
        for i in range(STEPS):
            tok = jax.device_put(toks[:, PROMPT + i:PROMPT + i + 1],
                                 shardings[1])
            logits, cache = fn(params, tok, jax.device_put(
                jnp.int32(PROMPT + i), scalar), cache)
            out.append(np.asarray(logits))
    return out, [np.asarray(a) for a in jax.tree.leaves(cache)]


def _jax_main(out_dir: str) -> None:
    from repro.launch.mesh import make_debug_mesh
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    mesh = make_debug_mesh((2, 2))
    out = {name: _jax_decode(name, inputs[name], mesh) for name in JAX_CASES}
    path = os.path.join(out_dir, "jax.pkl")
    with open(path + ".part", "wb") as fh:
        pickle.dump(out, fh)
    os.replace(path + ".part", path)


class _Reference:
    """The numpy inputs, ``mesh=None``'s decodes, and the JAX package's on
    its (2, 2) mesh in a subprocess started at once, read when needed."""

    def __init__(self, d):
        self.dir = d
        names = BASE + ("slots", "heads", "ssm17")
        self.inputs = {name: _numpy_inputs(name) for name in names}
        with open(d / "inputs.pkl", "wb") as fh:
            pickle.dump(self.inputs, fh)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        self.log = open(d / "jax.log", "w")
        self.proc = subprocess.Popen([sys.executable, __file__, str(d)],
                                     env=env, stdout=self.log,
                                     stderr=subprocess.STDOUT)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            # at mesh=None the knobs split nothing (``repeat_kv`` keeps the
            # prefill's values): one run a case for both
            self.none = {name: _decode(name, "off", self.inputs[name])[:2]
                         for name in names}
        finally:
            torch.set_num_threads(n)

    def jax(self) -> dict:
        path = self.dir / "jax.pkl"
        deadline = time.monotonic() + JOIN_S
        while not path.exists():
            if self.proc.poll() is not None and not path.exists():
                raise AssertionError(
                    f"the JAX package's decode failed:\n"
                    f"{(self.dir / 'jax.log').read_text()[-4000:]}")
            if time.monotonic() > deadline:
                raise AssertionError(f"no {path.name} in {JOIN_S} s")
            time.sleep(0.2)
        with open(path, "rb") as fh:
            return pickle.load(fh)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("decode_reference"))
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
    ref.proc.wait()
    ref.log.close()


def _close(got, want, what):
    """``got`` within TOL of ``want``, normwise."""
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max(initial=0.0))
    bound = TOL["atol"] + TOL["rtol"] * float(np.abs(want).max(initial=0.0))
    assert err <= bound, (what, err, bound)


def _held(got, want, what):
    (g_logits, g_cache), (w_logits, w_cache) = got, want
    assert len(g_logits) == len(w_logits) == STEPS + 1, what
    for i, (g, w) in enumerate(zip(g_logits, w_logits)):
        _close(g, w, f"{what} logits {i}")
    assert len(g_cache) == len(w_cache), what
    for i, (g, w) in enumerate(zip(g_cache, w_cache)):
        _close(g, w, f"{what} cache {i}")


def _watched_leaves(name, label, knobs, watched, what) -> None:
    """The leaves :func:`_watched` found: every mixer's projections, and
    ``conv_w`` where 'model' 2 stores it with the conv cache (not at
    ``d_state`` 17 on 'model' 4, where neither divides), and the cross
    blocks' ``wq`` / ``wo`` and MLP."""
    if knobs != "all":
        return
    cfg = _cfg(name)
    names = {path.split("/")[-1] for path in watched}
    want = set()
    if "mamba" in cfg.period:
        want |= {"in_proj", "out_proj"} | (
            set() if name == "ssm17" else {"conv_w"})
    if "cross" in cfg.period:
        want |= {"wq", "wo", "gate", "up", "down"}
    assert names == want, (what, sorted(watched))


@pytest.mark.parametrize("world", sorted(MESHES))
def test_pinned_decode_matches_mesh_none_and_reference(world, tmp_path,
                                                       reference):
    with open(tmp_path / "inputs.pkl", "wb") as fh:
        pickle.dump(reference.inputs, fh)
    ranks = _spawn(world, tmp_path)
    jax_out = reference.jax() if world == 4 else None
    for r, got in enumerate(ranks):
        for label in MESHES[world]:
            for name, knobs in _runs(world, label):
                logits, cache, pinned, gathered, split, watched = got[
                    f"{label}/{name}/{knobs}"]
                what = f"rank {r} {label} {name} knobs {knobs}"
                assert pinned and gathered == 0, (what, gathered)
                assert split == (knobs == "all"), what
                shape, axes, _ = MESHES[world][label]
                data_one = all(n == 1 for a, n in zip(axes, shape)
                               if a != "model")
                if knobs == "all" and data_one:
                    assert not any(watched.values()), (what, watched)
                _watched_leaves(name, label, knobs, watched, what)
                _held((logits, cache), reference.none[name], what)
                if label == "2x2" and knobs == "all" and name in JAX_CASES:
                    _held((logits, cache), jax_out[name], f"{what} vs JAX")


if __name__ == "__main__":
    _jax_main(sys.argv[1])
