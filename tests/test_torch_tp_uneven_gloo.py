"""The attention heads split over 'model' where they do not divide it
(``launch/sharding.Split.head_range``: GSPMD's padded split, ``ceil(H /
M)`` heads a rank from rank 0 on) across gloo ranks on the CPU, held
against the unsplit step and the JAX package.

The cuts (2 layers, fp32, V 256, head_dim 16 unless said, from one numpy
draw of the params and the batch that both packages take):

* ``dense``: musicgen-medium at d 48, 3 heads (MHA), ff 96.  At 'model' 2
  the ranks take 2 and 1 heads; 'model' stores ``wq`` and ``wo`` by rows
  (a 24-row block is 1.5 heads): the row route, q's partial sums
  all-reduced and cut, the output moved to ``wo``'s rows by the inverse
  all-to-all.
* ``dense_tie``: the same with ``shard_tie_break_last``: ``wq`` and ``wo``
  by columns, q regrouped from ``wq``'s column blocks by one all-to-all
  and the output entering ``wo`` as partial sums zero outside the rank's
  heads.
* ``gqa``: TinyLlama at d 96, 6 heads / 2 KV heads, ff 192; at 'model' 4
  the ranks take 2, 2, 2 and 0 heads.
* ``moe``: granite-moe-3b (4 experts) as ``gqa``.
* ``bias``: qwen2-72b (q/k/v biases) at d 96, 6 heads / 3 KV heads of
  10: ``wq`` by rows (q's partial sums all-reduced and cut), the q bias
  by 'model' blocks (regrouped to the rank's heads by one all-to-all),
  the K/V biases (30 wide) gathered whole, ``wo`` by columns.

Meshes (``('data', 'model')``): world 2, ``dense`` and ``dense_tie`` on (1,
2); world 4, ``dense`` on (2, 2) with 2 nodes (the sharded runtime, a node
a 'data' rank: 2 + 1 heads) and the other cuts on (1, 4).  On (1, M) a run
has one node (QHM): the JAX package's plan puts no node count on an axis of
1.  With
``megatron_attn``, ``shard_activations`` and ``pin_moe_dispatch``:

* 2 train steps: the losses and the gathered final params within rtol
  1e-5 / atol 1e-6 of ``mesh=None`` with the knobs, elementwise, and m_hat
  normwise (``max |got - want| <= 1e-6 + 1e-5 max |want|`` an array: at
  one node a few small entries of the embedding's m_hat cross the
  elementwise bound under any split of the sums, the even one too: 1 of
  16384 on this dense cut at 4 heads over 'model' 2); everything normwise
  of the JAX package's ``build_train_step`` at ``mesh=None`` and jitted
  with in-shardings on the same debug mesh (GSPMD pads the heads);
* a [2, 32] prefill: the last logits within 1e-5 of max |logit| and every
  cache leaf within rtol 1e-5 / atol 1e-6 of ``mesh=None``'s, normwise (as
  ``test_torch_tp_ssm_gloo`` holds a prefill's caches: K is the sum of
  the ranks' partial products);
* the split's flags (the heads on, nothing left ``whole``) and its
  ``Tally``: no byte of ``wq`` / ``wk`` / ``wv`` / ``wo`` gathered (a
  prefill on (2, 2), one node, gathers their blocks over the FSDP axis
  'data' alone), and an all-to-all on the wire;
* ``Split.regroup`` / ``unregroup`` of the head ranges (rank 3 of (1, 4)
  takes none): value, gradient and vmap rule against the plain cut.

The JAX package runs in a subprocess a cut (4 forced host devices) beside
the ranks; the ranks import nothing of it.  Run alone: ``PYTHONPATH=src
python -m pytest -q tests/test_torch_tp_uneven_gloo.py``.
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
from repro_torch.tree import tree_leaves, tree_map

from test_torch_tp_gloo import ALL, JOIN_S, LOGIT_RTOL, SEQ, TOL, _one_thread

STEPS = 2
NARROW = dict(n_kv_heads=2, head_dim=16, d_model=96, d_ff=192, n_heads=6,
              vocab_size=256)
DENSE = dict(NARROW, d_model=48, n_heads=3, n_kv_heads=3, d_ff=96)
#: cut name: (arch, config fields, shard_tie_break_last, the dims (from the
#: end) that 'model' stores ``wq`` and ``wo`` by)
CUTS = {"dense": ("musicgen-medium", DENSE, False, (-2, -2)),
        "dense_tie": ("musicgen-medium", DENSE, True, (-1, -1)),
        "gqa": ("tinyllama-1.1b", NARROW, False, (-2, -2)),
        "moe": ("granite-moe-3b-a800m", NARROW, False, (-2, -2)),
        "bias": ("qwen2-72b", dict(NARROW, n_kv_heads=3, head_dim=10),
                 False, (-2, -1))}
#: world size: the runs, (label, mesh shape, runtime, node axis, cut, nodes)
RUNS = {2: (("1x2", (1, 2), "vmap", None, "dense", 1),
            ("1x2", (1, 2), "vmap", None, "dense_tie", 1)),
        4: (("2x2", (2, 2), "sharded", "data", "dense", 2),
            ("1x4", (1, 4), "vmap", None, "gqa", 1),
            ("1x4", (1, 4), "vmap", None, "moe", 1),
            ("1x4", (1, 4), "vmap", None, "bias", 1))}
ATTN = ("wq", "wk", "wv", "wo")


def _cfg(cut, cfgs=None):
    """The cut's config (``cfgs``: the JAX package's configs module in its
    subprocess)."""
    arch, fields = CUTS[cut][:2]
    base = (cfgs.get_config if cfgs else get_config)(arch, reduced=True)
    return dataclasses.replace(base, **fields)


def _sc(cut, n_nodes, kind="train", runtime="vmap"):
    n = n_nodes if kind == "train" else 1
    return steps.StepConfig(
        cfg=_cfg(cut), shape=InputShape(f"tiny_{kind}", SEQ, 2 * n, kind),
        n_nodes=n, chunk=8, param_dtype=torch.float32, runtime=runtime,
        shard_tie_break_last=CUTS[cut][2], **ALL)


def _numpy_inputs(cut, n_nodes) -> dict:
    """Each node's params in the LM's tree (weights at ``1/sqrt(fan_in)``,
    vectors at 0.1) and its batch of tokens."""
    rng = np.random.default_rng(17)
    cfg = _cfg(cut)

    def draw(t):
        scale = 0.1 if t.dim() < 2 else t.shape[-2] ** -0.5
        return (rng.standard_normal((n_nodes,) + tuple(t.shape))
                * scale).astype(np.float32)

    params = tree_map(draw, tf.init_lm(None, cfg, device="meta"))
    toks = rng.integers(0, cfg.vocab_size, size=(n_nodes, 2, SEQ + 1),
                        dtype=np.int32)
    return {"params": params, "batch": {"tokens": toks[..., :-1].copy(),
                                        "labels": toks[..., 1:].copy()}}


def _inputs_key(cut, n_nodes) -> str:
    return f"{cut}/{n_nodes}"


def _inputs_keys() -> dict:
    """Every (cut, node count) the runs take, by its inputs' key."""
    return {_inputs_key(cut, nodes): (cut, nodes)
            for world in RUNS for *_, cut, nodes in RUNS[world]}


def _train(cut, n_nodes, inputs, mesh=None, runtime="vmap",
           node_axis=None):
    """STEPS steps from the numpy init: ``(losses, leaves of the gathered
    params and optimizer state, step)``."""
    sc = _sc(cut, n_nodes, runtime=runtime)
    given = inputs[_inputs_key(cut, n_nodes)]
    params = interop.params_from_numpy(given["params"], "cpu")
    batch = interop.params_from_numpy(given["batch"], "cpu")
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


def _prefill(cut, n_nodes, inputs, mesh=None):
    """Node 0's [2, SEQ] prefill: ``(last logits, leaves of the whole
    cache, the prefill step)``."""
    sc = _sc(cut, n_nodes, kind="prefill")
    given = inputs[_inputs_key(cut, n_nodes)]
    params = tree_map(lambda t: t[0], interop.params_from_numpy(
        given["params"], "cpu"))
    tokens = torch.from_numpy(given["batch"]["tokens"][0]).long()
    fn = steps.build_prefill_step(sc, mesh=mesh)
    logits, cache = fn(params, tokens)
    if mesh is not None:
        cache = sharding.gather_tree(fn.layout.plan,
                                     fn.layout.specs["cache"], cache)
    return logits.numpy(), [t.numpy() for t in tree_leaves(cache)], fn


def _check_head_regroup(split, hd=16) -> None:
    """``Split.regroup`` of the query heads' column blocks and its inverse
    ``unregroup`` against the plain cut of the whole tensor: the values,
    the gradients (each column's upstream back on the rank that stores it)
    and the vmap rules (raise on a mismatch)."""
    m, r, n = split.size, split.index, split.cfg.n_heads
    width = n * hd // m
    whole = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 2, n * hd)).astype(np.float32))
    ranges = split._head_runs(hd)
    lo, count = split.head_range()
    want = whole[..., lo * hd:(lo + count) * hd]
    up = torch.from_numpy(np.random.default_rng(40).standard_normal(
        (3, 2, n * hd)).astype(np.float32))
    x = whole[..., r * width:(r + 1) * width].clone().requires_grad_(True)
    y = split.regroup(x, ranges)
    assert torch.equal(y, want), (y, want)
    (y * up[..., lo * hd:(lo + count) * hd]).sum().backward()
    assert torch.equal(x.grad, up[..., r * width:(r + 1) * width])
    mapped = torch.func.vmap(lambda t: split.regroup(t, ranges))(x.detach())
    assert torch.equal(mapped, want)
    h = want.clone().requires_grad_(True)
    back = split.unregroup(h, ranges, width)
    assert torch.equal(back, x.detach())
    (back * up[..., r * width:(r + 1) * width]).sum().backward()
    assert torch.equal(h.grad, up[..., lo * hd:(lo + count) * hd])
    mapped = torch.func.vmap(lambda t: split.unregroup(t, ranges, width))(
        want)
    assert torch.equal(mapped, x.detach())


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
        for label, shape, runtime, node_axis, cut, nodes in RUNS[world]:
            mesh = tmesh.make_debug_mesh(shape, ("data", "model"))
            key = f"{label}/{cut}"
            losses, leaves, step = _train(cut, nodes, inputs, mesh, runtime,
                                          node_axis)
            out[f"{key}/run"] = (losses, leaves)
            sp, pl = step.split, step.layout.placement
            out[f"{key}/split"] = (sp.heads, sp.whole, sp.head_range(),
                                   dict(sp.tally.wire))
            out[f"{key}/gathered"] = sorted(
                (p[-1], b) for p, b in pl.tally.leaves.items()
                if b and p[-1] in ATTN)
            out[f"{key}/model_dims"] = {
                name: sp.model_dim(("blocks", 0, "attn", name))
                for name in ("wq", "wo")}
            logits, cache, fn = _prefill(cut, nodes, inputs, mesh)
            out[f"{key}/prefill"] = (logits, cache)
            out[f"{key}/prefill_gathered"] = sorted(
                (p[-1], b) for p, b in fn.layout.placement.tally.leaves
                .items() if b and p[-1] in ATTN)
            if shape[0] == 1:
                _check_head_regroup(step.split)
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
# the JAX package (a subprocess a cut)
# ---------------------------------------------------------------------------

def _jax_train(cut, n_nodes, inputs, mesh=None):
    """STEPS steps of the JAX package's train step with the three knobs:
    ``(losses, leaves)``; on ``mesh`` jitted with the dry run's
    in-shardings."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.configs.base import InputShape as JInputShape
    from repro.launch import sharding as jsharding
    from repro.launch import steps as jsteps
    sc = jsteps.StepConfig(
        cfg=_cfg(cut, jconfigs), shape=JInputShape(
            "tiny_train", SEQ, 2 * n_nodes, "train"),
        n_nodes=n_nodes, chunk=8, param_dtype=jnp.float32,
        shard_tie_break_last=CUTS[cut][2], **ALL)
    given = inputs[_inputs_key(cut, n_nodes)]
    params = jax.tree.map(jnp.asarray, given["params"])
    batch = jax.tree.map(jnp.asarray, given["batch"])
    o = jsteps.make_opt(sc).init(params)
    if mesh is None:
        fn = jax.jit(jsteps.build_train_step(sc))
    else:
        plan = jsharding.make_plan(mesh, n_nodes=n_nodes)

        def named(tree):
            return jsharding.named(plan, jsharding.param_specs(
                plan, tree, node_stacked=True,
                tie_break_last=sc.shard_tie_break_last))

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


def _jax_main(out_dir: str, cut: str) -> None:
    """A subprocess: the cut's JAX train step at ``mesh=None`` and on each
    debug mesh its runs take; ``jax_<cut>.pkl`` written whole under another
    name and renamed."""
    from repro.launch.mesh import make_debug_mesh
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    out = {}
    for world in RUNS:
        for label, shape, _, _, name, nodes in RUNS[world]:
            if name != cut:
                continue
            if ("none", nodes) not in out:
                out["none", nodes] = _jax_train(cut, nodes, inputs)
            mesh = make_debug_mesh(shape)
            with mesh:
                out[label, nodes] = _jax_train(cut, nodes, inputs, mesh)
    path = os.path.join(out_dir, f"jax_{cut}.pkl")
    with open(path + ".part", "wb") as fh:
        pickle.dump(out, fh)
    os.replace(path + ".part", path)


class _Reference:
    """The numpy inputs, and the JAX package's runs in a subprocess a cut
    (4 forced host devices), all started at once beside the ranks and read
    when first needed."""

    def __init__(self, d):
        self.dir = d
        self.inputs = {key: _numpy_inputs(cut, nodes)
                       for key, (cut, nodes) in _inputs_keys().items()}
        with open(d / "inputs.pkl", "wb") as fh:
            pickle.dump(self.inputs, fh)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        self.procs = {}
        for cut in CUTS:
            log = open(d / f"jax_{cut}.log", "w")
            self.procs[cut] = (subprocess.Popen(
                [sys.executable, __file__, str(d), cut], env=env,
                stdout=log, stderr=subprocess.STDOUT), log)

    def jax(self, cut: str) -> dict:
        path = self.dir / f"jax_{cut}.pkl"
        proc = self.procs[cut][0]
        deadline = time.monotonic() + JOIN_S
        while not path.exists():
            if proc.poll() is not None and not path.exists():
                log = self.dir / f"jax_{cut}.log"
                raise AssertionError(f"the JAX package's runs failed:\n"
                                     f"{log.read_text()[-4000:]}")
            if time.monotonic() > deadline:
                raise AssertionError(f"no {path.name} in {JOIN_S} s")
            time.sleep(0.2)
        with open(path, "rb") as fh:
            return pickle.load(fh)

    def close(self) -> None:
        for proc, log in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("tp_uneven_reference"))
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def unsplit(reference):
    """The port's unsplit train runs and prefills by cut and node count."""
    with _one_thread():
        return {key: (_train(cut, nodes, reference.inputs)[:2],
                      _prefill(cut, nodes, reference.inputs)[:2])
                for key, (cut, nodes) in _inputs_keys().items()}


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


def _held_run(got, want, what, *, normwise=False, params=None):
    """``(losses, leaves)`` pairs; with ``params`` (the count of the
    params' leaves, which come first) the optimizer state's normwise."""
    _held(got[0], want[0], f"{what} losses", normwise=normwise)
    n = len(want[1]) if params is None else params
    _held(got[1][:n], want[1][:n], f"{what} params", normwise=normwise)
    _held(got[1][n:], want[1][n:], f"{what} optimizer state",
          normwise=normwise or params is not None)


def test_head_range_and_regroup_plan():
    """GSPMD's padded rule and the all-to-all's plan (no collective): the
    ranks' head ranges tile the heads in rank order, ``ceil(H / M)`` a rank
    and empty past the last head; every column of the stored blocks reaches
    exactly the rank whose heads hold it, and back (the plan's take / order
    and unorder / untake across the ranks, by hand)."""
    cfg = _cfg("gqa")
    for n, m, counts in ((24, 16, [2] * 12 + [0] * 4),
                         (56, 16, [4] * 14 + [0] * 2), (32, 16, [2] * 16),
                         (3, 2, [2, 1]), (6, 4, [2, 2, 2, 0]),
                         (3, 4, [1, 1, 1, 0]), (5, 4, [2, 2, 1, 0])):
        mesh = tmesh.MeshShape((("data", 1), ("model", m)))
        pl = sharding.Placement(mesh, params={})
        sp = sharding.Split(pl, dataclasses.replace(cfg, n_heads=n), True)
        got = [sp.head_range(rank=t) for t in range(m)]
        assert [c for _, c in got] == counts, (n, m)
        assert [lo for lo, _ in got] == list(
            np.minimum(np.cumsum([0] + counts[:-1]), n)), (n, m)
        for hd in (16, 64):
            if n * hd % m:
                continue
            width, ranges = n * hd // m, sp._head_runs(hd)
            plan = sharding._Regroup.make(width, m, ranges)
            whole = np.arange(n * hd, dtype=np.float32)
            blocks = [torch.from_numpy(whole[q * width:(q + 1) * width])
                      for q in range(m)]
            sent = [plan.take(blocks[q], q).split(
                [plan.rows(q, t) for t in range(m)]) for q in range(m)]
            mine = []
            for t in range(m):
                lo, count = got[t]
                assert (len(ranges(t)) == 0) == (count == 0)
                out = plan.order(torch.cat([sent[q][t] for q in range(m)]),
                                 t)
                assert np.array_equal(out.numpy(),
                                      whole[lo * hd:(lo + count) * hd])
                mine.append(plan.unorder(out, t).split(
                    [plan.rows(q, t) for q in range(m)]))
            # each column once: the runs tile every block
            assert sum(plan.rows(q, t) for q in range(m)
                       for t in range(m)) == n * hd
            for q in range(m):
                back = plan.untake(torch.cat([mine[t][q] for t in range(m)]),
                                   q)
                assert torch.equal(back, blocks[q])


@pytest.mark.parametrize("world", sorted(RUNS))
def test_uneven_heads_split_matches_unsplit_and_reference(world, tmp_path,
                                                          reference,
                                                          unsplit):
    with open(tmp_path / "inputs.pkl", "wb") as fh:
        pickle.dump(reference.inputs, fh)
    ranks = _spawn(world, tmp_path)
    for r, got in enumerate(ranks):
        for label, shape, _, _, cut, nodes in RUNS[world]:
            key, what = f"{label}/{cut}", f"rank {r} {label} {cut}"
            cfg, m = _cfg(cut), shape[1]
            assert cfg.n_heads % m, what          # the uneven case
            (want_run, want_prefill) = unsplit[_inputs_key(cut, nodes)]
            jax_runs = reference.jax(cut)
            run = got[f"{key}/run"]
            _held_run(run, want_run, what, params=len(tree_leaves(
                tf.init_lm(None, cfg, device="meta"))))
            _held_run(run, jax_runs["none", nodes], f"{what} vs JAX",
                      normwise=True)
            _held_run(run, jax_runs[label, nodes], f"{what} vs JAX {shape}",
                      normwise=True)
            heads, whole, (lo, count), wire = got[f"{key}/split"]
            c = -(-cfg.n_heads // m)
            assert heads and whole == (), what
            assert (lo, count) == (min(r % m * c, cfg.n_heads), max(
                0, min(c, cfg.n_heads - r % m * c))), what
            # no byte of an attention weight gathered whole
            assert got[f"{key}/gathered"] == [], what
            if shape[0] == 1:   # (2, 2)'s prefill gathers over FSDP 'data'
                assert got[f"{key}/prefill_gathered"] == [], what
            wq, wo = CUTS[cut][3]
            assert got[f"{key}/model_dims"] == {"wq": wq, "wo": wo}, what
            assert wire["all-to-all"] > 0, what
            logits, cache = got[f"{key}/prefill"]
            want_logits, want_cache = want_prefill
            scale = float(np.abs(want_logits).max())
            np.testing.assert_allclose(logits, want_logits, rtol=0,
                                       atol=LOGIT_RTOL * scale,
                                       err_msg=f"{what} prefill logits")
            _held(cache, want_cache, f"{what} prefill cache", normwise=True)


if __name__ == "__main__":
    _jax_main(*sys.argv[1:3])
