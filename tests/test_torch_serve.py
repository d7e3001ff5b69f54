"""The port's serving stack on the CPU against the JAX package: the paged
KV cache's accounting, the continuous-batching engine's greedy tokens
(against the reference's ``ServeEngine`` and ``sequential_generate`` at
temperature 0, from the reference's own init), the ``serve-v1`` and
``save_train_state`` checkpoints in both directions, and the CLIs with
``--device cpu``.

Tokens are compared exactly: both packages compute the same fp32 forward
(within 1e-4 on logits, tests/test_torch_lm.py), and on these seeds no
step of these runs has a top-2 logit gap near that.  Checkpoint leaves
are compared bit for bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro.serve.__main__ import make_requests as jmake_requests
from repro.train.checkpoint import save_train_state
from repro.train.trainer import TrainState
from repro_torch import interop, serve
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttf
from repro_torch.tree import tree_leaves
from repro_torch.serve.__main__ import make_requests

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", params=["tinyllama-1.1b", "gemma2-27b"])
def pair(request):
    """(reference params and cfg, port params and cfg), same weights."""
    jcfg = jget_config(request.param, reduced=True)
    cfg = get_config(request.param, reduced=True)
    jp = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jp, jcfg, tp, cfg


def test_make_requests_matches_reference():
    got = make_requests(7, 512, seed=3, max_new=5)
    want = jmake_requests(7, 512, seed=3, max_new=5)
    assert [(r.id, r.prompt, r.max_new) for r in got] == \
        [(r.id, r.prompt, r.max_new) for r in want]


# ---------------------------------------------------------------------------
# paged KV cache accounting
# ---------------------------------------------------------------------------

def test_kvcache_reservation_accounting_matches_reference():
    cfg, jcfg = get_config("tinyllama-1.1b", reduced=True), jget_config(
        "tinyllama-1.1b", reduced=True)
    kw = dict(n_slots=2, n_pages=6, page_size=8, max_len=32)
    kv, jkv = serve.PagedKVCache(cfg, device="cpu", **kw), \
        jserve.PagedKVCache(jcfg, **kw)
    for c in (kv, jkv):
        assert c.pages_needed(17) == 3
        c.admit(0, 24)
        assert c.outstanding() == 3 and c.can_admit(24)
        assert not c.can_admit(25)
        with pytest.raises(RuntimeError, match="already active"):
            c.admit(0, 8)
        c.ensure(0, 17)
        assert c.held(0) == 3 and c.outstanding() == 0
        with pytest.raises(RuntimeError, match="exceed max_len"):
            c.ensure(0, 33)
        c.admit(1, 16)
        c.ensure(1, 9)
    np.testing.assert_array_equal(kv.block_tables, jkv.block_tables)
    np.testing.assert_array_equal(kv.device_tables().numpy(),
                                  np.asarray(jkv.device_tables()))
    assert kv.pool_bytes() == jkv.pool_bytes()
    assert kv.used_bytes() == jkv.used_bytes()
    for c in (kv, jkv):
        c.release(0)
    assert kv.free_pages() == jkv.free_pages() == 4
    assert kv.peak_pages_used == jkv.peak_pages_used == 5
    assert kv.held(0) == 0
    for a, b in zip(tree_leaves(kv.pages), jax.tree.leaves(jkv.pages)):
        assert tuple(a.shape) == tuple(b.shape)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _sequential(jp, jcfg, reqs):
    out = []
    for r in reqs:
        base = jserve.sequential_generate(
            jp, jcfg, jnp.asarray([r.prompt], jnp.int32), gen_len=r.max_new,
            cache_len=len(r.prompt) + r.max_new)
        out.append(tuple(int(t) for t in np.asarray(
            base[0, len(r.prompt):])))
    return out


@pytest.mark.parametrize("use_pallas", [False, True])
def test_engine_tokens_match_reference(pair, use_pallas):
    """8 requests through 4 slots (a second admission wave), then the same
    requests again on the same engine (slot and page reuse, no zeroing):
    the port's tokens equal the reference engine's and its sequential
    baseline's, request by request."""
    jp, jcfg, tp, cfg = pair
    kw = dict(n_slots=4, page_size=8, max_len=64, prefill_chunk=16)
    reqs = make_requests(8, cfg.vocab_size, seed=0, max_new=8)
    jreqs = jmake_requests(8, cfg.vocab_size, seed=0, max_new=8)
    ops.reset_launch_counts()
    eng = serve.ServeEngine(tp, cfg, use_pallas=use_pallas, **kw)
    outs = eng.run(reqs)
    assert not any(ops.launch_counts().values())   # CPU: plain versions
    want = [o.tokens for o in jserve.ServeEngine(jp, jcfg, **kw).run(jreqs)]
    assert [o.id for o in outs] == list(range(8))
    assert [o.tokens for o in outs] == want
    assert [o.tokens for o in outs] == _sequential(jp, jcfg, jreqs)
    assert [o.tokens for o in eng.run(reqs)] == want
    st = eng.stats()
    assert st["peak_cache_bytes"] > 0 and st["pool_bytes"] == \
        eng.kv.pool_bytes()
    assert st["phases"]["decode"]["count"] > 0
    assert "p95_s" in st["phases"]["decode"]
    assert eng.kv.free_pages() == eng.kv.n_pages


def test_engine_queueing_under_page_pressure_matches_reference(pair):
    """A pool where only about two sequences fit: the rest queue (FCFS) and
    complete with the reference's tokens; the pool drains fully and the
    peak page use is the reference's."""
    jp, jcfg, tp, cfg = pair
    kw = dict(n_slots=4, page_size=8, max_len=32, n_pages=7,
              prefill_chunk=8)
    reqs = make_requests(6, cfg.vocab_size, seed=1, lens=(8, 17), max_new=6)
    jreqs = jmake_requests(6, cfg.vocab_size, seed=1, lens=(8, 17),
                           max_new=6)
    eng = serve.ServeEngine(tp, cfg, use_pallas=True, **kw)
    jeng = jserve.ServeEngine(jp, jcfg, **kw)
    got = [o.tokens for o in eng.run(reqs)]
    assert got == [o.tokens for o in jeng.run(jreqs)]
    assert got == _sequential(jp, jcfg, jreqs)
    assert eng.kv.free_pages() == 7
    assert eng.stats()["peak_cache_bytes"] == \
        jeng.stats()["peak_cache_bytes"]


def test_engine_rejects_oversized_request(pair):
    _, _, tp, cfg = pair
    eng = serve.ServeEngine(tp, cfg, n_slots=1, page_size=8, max_len=16)
    with pytest.raises(ValueError, match="exceed engine max_len"):
        eng.run([serve.Request(id=0, prompt=tuple(range(1, 15)),
                               max_new=8)])
    with pytest.raises(ValueError, match="non-empty prompt"):
        serve.Request(id=0, prompt=(), max_new=4)


def test_sequential_generate_matches_reference(pair):
    jp, jcfg, tp, cfg = pair
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    got = serve.sequential_generate(tp, cfg, torch.from_numpy(prompts),
                                    gen_len=6, cache_len=20)
    want = jserve.sequential_generate(jp, jcfg, jnp.asarray(prompts),
                                      gen_len=6, cache_len=20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sampled = serve.sequential_generate(tp, cfg, torch.from_numpy(prompts),
                                        gen_len=6, cache_len=20,
                                        temperature=0.7, seed=4)
    again = serve.sequential_generate(tp, cfg, torch.from_numpy(prompts),
                                      gen_len=6, cache_len=20,
                                      temperature=0.7, seed=4)
    assert sampled.shape == (2, 18) and torch.equal(sampled, again)
    assert torch.equal(sampled[:, :12], torch.from_numpy(prompts))


# ---------------------------------------------------------------------------
# checkpoints, both directions
# ---------------------------------------------------------------------------

def test_reference_serving_checkpoint_loads_bit_equal(pair, tmp_path):
    jp, jcfg, _, cfg = pair
    path = str(tmp_path / "model.npz")
    jserve.save_serving_checkpoint(path, jp, jcfg)
    params, got_cfg = serve.load_serving_checkpoint(path, device="cpu")
    assert got_cfg == cfg and isinstance(got_cfg.period, tuple)
    assert isinstance(params["blocks"], tuple) and params["tail"] == ()
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                          tree_leaves(params)):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=kp)


def test_port_serving_checkpoint_loads_in_reference(pair, tmp_path):
    _, jcfg, tp, cfg = pair
    path = str(tmp_path / "sub" / "model.npz")
    serve.save_serving_checkpoint(path, tp, cfg)
    jparams, got_cfg = jserve.load_serving_checkpoint(path)
    assert got_cfg == jcfg
    for a, b in zip(jax.tree.leaves(jparams), tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    back, _ = serve.load_serving_checkpoint(path, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(tp)):
        assert torch.equal(a, b)


def test_serving_checkpoint_refuses_other_npz(tmp_path):
    np.savez(tmp_path / "bad.npz", __meta__="{}")
    with pytest.raises(ValueError, match="not a serving checkpoint"):
        serve.load_serving_checkpoint(str(tmp_path / "bad.npz"),
                                      device="cpu")


def test_train_checkpoint_export_matches_reference(pair, tmp_path):
    """A reference ``save_train_state`` npz of a node-stacked LM state: the
    port reads its params bit-equal and averages them as the reference."""
    jp, jcfg, _, cfg = pair
    rng = np.random.default_rng(5)
    stacked = jax.tree.map(
        lambda x: jnp.asarray(np.stack([np.asarray(x) + rng.normal(
            size=x.shape).astype(np.float32) * 0.01 for _ in range(3)])), jp)
    state = TrainState(params=stacked, opt_state={}, model_state={},
                       t=jnp.asarray(7, jnp.int32))
    path = str(tmp_path / "train.npz")
    save_train_state(path, state, rng=jax.random.PRNGKey(0))
    got = serve.params_from_train_checkpoint(path)
    for a, b in zip(jax.tree.leaves(stacked), tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    spec = {"model": {"name": "transformer",
                      "kwargs": {"arch": jcfg.name.replace("-reduced", ""),
                                 "reduced": True}}}
    params, got_cfg = serve.export_consensus(path, spec=spec)
    want, _ = jserve.export_consensus(jax.tree.map(jnp.asarray, stacked))
    assert got_cfg == cfg
    for a, b in zip(jax.tree.leaves(want), tree_leaves(params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-7)
    state_like = type("S", (), {"params": got})()
    again, none_cfg = serve.export_consensus(state_like)
    assert none_cfg is None
    for a, b in zip(tree_leaves(params), tree_leaves(again)):
        assert torch.equal(a, b)
    result_like = type("R", (), {"spec": spec, "history": []})()
    with pytest.raises(ValueError, match="state="):
        serve.export_consensus(result_like)
    from_result, result_cfg = serve.export_consensus(result_like,
                                                     state=state_like)
    assert result_cfg == cfg
    for a, b in zip(tree_leaves(params), tree_leaves(from_result)):
        assert torch.equal(a, b)


def test_config_dict_roundtrip_matches_reference():
    for arch in ("granite-moe-3b-a800m", "zamba2-7b", "gemma2-27b"):
        cfg, jcfg = get_config(arch, reduced=True), jget_config(
            arch, reduced=True)
        d = serve.config_to_dict(cfg)
        assert json.loads(json.dumps(d)) == json.loads(json.dumps(
            jserve.config_to_dict(jcfg)))
        assert serve.config_from_dict(json.loads(json.dumps(d))) == cfg


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

def _run_cli(*args):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=300, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": "src"})


def test_serve_cli_runs_on_the_cpu(tmp_path):
    res = _run_cli("repro_torch.serve", "--device", "cpu", "--requests", "3",
                   "--max-new", "4", "--use-pallas")
    assert res.returncode == 0, res.stderr[-3000:]
    row = json.loads(res.stdout.strip().splitlines()[-1])
    assert row["mode"] == "engine" and row["device"] == "cpu"
    assert row["arch"] == "tinyllama-1.1b-reduced" and row["tokens_per_s"] > 0
    assert row["phases"]["decode"]["count"] > 0
    path = tmp_path / "m.npz"
    cfg = get_config("gemma2-27b", reduced=True)
    serve.save_serving_checkpoint(
        str(path), ttf.init_lm(torch.Generator().manual_seed(1), cfg), cfg)
    res = _run_cli("repro_torch.serve", "--device", "cpu", "--checkpoint",
                   str(path), "--requests", "2", "--max-new", "3",
                   "--baseline")
    assert res.returncode == 0, res.stderr[-3000:]
    row = json.loads(res.stdout.strip().splitlines()[-1])
    assert row["mode"] == "sequential" and row["arch"] == cfg.name


def test_launch_serve_runs_on_the_cpu():
    res = _run_cli("repro_torch.launch.serve", "--device", "cpu", "--batch",
                   "2", "--prompt-len", "10", "--gen-len", "3")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[engine] 6 tokens" in res.stdout
    res = _run_cli("repro_torch.launch.serve", "--device", "cpu", "--batch",
                   "2", "--prompt-len", "10", "--gen-len", "3",
                   "--temperature", "0.7")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[sequential] 6 tokens" in res.stdout


def test_serve_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = _run_cli("repro_torch.serve", "--requests", "1")
    assert res.returncode != 0 and "no CUDA device" in res.stderr
