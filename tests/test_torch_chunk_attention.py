"""The plain attention's two chunk knobs (``repro_torch.models.attention``)
on the CPU against the JAX package's ``repro.models.attention``:
``chunked_attention(skip_masked_chunks=True)`` (the query-chunked
sliding-window path, ``_windowed_attention_qchunked``) and
``remat_chunks=True`` (each KV chunk recomputed in the backward).

Both packages take the same numpy inputs from a seed.  Forward outputs and
the gradients of ``sum(out * w)`` (``w`` a fixed numpy draw) with respect
to q, k and v hold within rtol 1e-5 / atol 1e-6 (fp32; the two packages'
products sum in other orders).  In the port, ``remat_chunks`` is the same
computation as the plain chunk loop: outputs and gradients equal bit for
bit, alone and under ``torch.func.vmap`` as the training step maps a
node's loss.  Through the model, ``forward(skip_masked_chunks=,
remat_attention=)`` is held against the reference's on a reduced gemma2
(local and global layers) and zamba2 (the shared block's window).

Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_chunk_attention.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jatt
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import attention as att
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_flatten, tree_unflatten

TOL = dict(rtol=1e-5, atol=1e-6)

#: (batch, seq, heads, kv heads, head dim, window, chunk, softcap): windows
#: of 2 and 4 chunks (and one not a multiple of the chunk), GQA and MHA
SKIP_CASES = [
    (2, 32, 4, 2, 8, 8, 4, 0.0),      # window 2 chunks, GQA
    (1, 48, 4, 1, 16, 16, 4, 0.0),    # window 4 chunks, MQA
    (2, 32, 2, 2, 8, 16, 4, 50.0),    # window 4 chunks, softcap
    (1, 24, 6, 2, 8, 6, 4, 30.0),     # window 1.5 chunks, softcap, GQA
    (1, 16, 2, 1, 8, 8, 16, 0.0),     # one chunk covers the sequence
]

#: (batch, seq, kv len, heads, kv heads, head dim, causal, window, chunk,
#: softcap) of the remat path: a ragged last chunk, a window, cross-shaped
REMAT_CASES = [
    (2, 20, 20, 4, 2, 8, True, 0, 8, 0.0),
    (1, 24, 24, 4, 4, 8, True, 6, 8, 30.0),
    (2, 12, 28, 4, 1, 16, False, 0, 8, 0.0),
]


def _inputs(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q, dtype=np.float32)
    k = rng.standard_normal(shape_kv, dtype=np.float32)
    v = rng.standard_normal(shape_kv, dtype=np.float32)
    w = rng.standard_normal(shape_q, dtype=np.float32)
    return q, k, v, w


def _jax_out_and_grads(fn, q, k, v, w):
    def both(q, k, v):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(jnp.asarray(w))
    out, grads = jax.jit(both)(q, k, v)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _torch_out_and_grads(fn, q, k, v, w):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    return [out.detach()] + list(grads)


@pytest.mark.parametrize("case", SKIP_CASES)
def test_skip_masked_chunks_matches_reference(case):
    b, s, h, kh, d, window, chunk, softcap = case
    q, k, v, w = _inputs((b, s, h, d), (b, s, kh, d), seed=sum(case[:7]))
    kw = dict(causal=True, window=window, softcap=softcap, chunk=chunk,
              skip_masked_chunks=True)
    want = _jax_out_and_grads(
        lambda q, k, v: jatt.chunked_attention(q, k, v, **kw), q, k, v, w)
    got = _torch_out_and_grads(
        lambda q, k, v: att.chunked_attention(q, k, v, **kw), q, k, v, w)
    for name, g, x in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), x, err_msg=name, **TOL)
    # the query-chunked path is the windowed attention: the same values as
    # the full chunk loop within the fp32 tolerance
    full = _torch_out_and_grads(
        lambda q, k, v: att.chunked_attention(
            q, k, v, **{**kw, "skip_masked_chunks": False}), q, k, v, w)
    for name, g, x in zip(("out", "dq", "dk", "dv"), got, full):
        np.testing.assert_allclose(g.numpy(), x.numpy(), err_msg=name,
                                   **TOL)


def test_skip_masked_chunks_takes_the_reference_condition(monkeypatch):
    """Only causal windowed self-attention whose length is a multiple of
    the chunk goes by query chunks; anything else runs the chunk loop."""
    calls = []
    real = att._windowed_attention_qchunked
    monkeypatch.setattr(att, "_windowed_attention_qchunked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q, k, v, _ = _inputs((1, 16, 2, 8), (1, 16, 2, 8), seed=0)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    for kw, want in ((dict(window=4), 1), (dict(window=0), 0),
                     (dict(window=4, causal=False), 0),
                     (dict(window=4, chunk=6), 0)):
        calls.clear()
        att.chunked_attention(q, k, v, **{"chunk": 4, **kw},
                              skip_masked_chunks=True)
        assert len(calls) == want, kw
    calls.clear()
    att.chunked_attention(q[:, :8], k, v, window=4, chunk=4,
                          skip_masked_chunks=True)
    assert not calls   # s != t


@pytest.mark.parametrize("case", REMAT_CASES)
def test_remat_chunks_matches_reference_and_is_bit_equal(case):
    b, s, t, h, kh, d, causal, window, chunk, softcap = case
    q, k, v, w = _inputs((b, s, h, d), (b, t, kh, d), seed=sum(case[:6]))
    kw = dict(causal=causal, window=window, softcap=softcap, chunk=chunk)
    want = _jax_out_and_grads(
        lambda q, k, v: jatt.chunked_attention(q, k, v, remat_chunks=True,
                                               **kw), q, k, v, w)
    got = _torch_out_and_grads(
        lambda q, k, v: att.chunked_attention(q, k, v, remat_chunks=True,
                                              **kw), q, k, v, w)
    for name, g, x in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), x, err_msg=name, **TOL)
    plain = _torch_out_and_grads(
        lambda q, k, v: att.chunked_attention(q, k, v, **kw), q, k, v, w)
    assert all(torch.equal(a, c) for a, c in zip(got, plain))

    # under vmap over a leading node axis (the training step's form)
    def mapped(remat):
        ts = [torch.from_numpy(np.stack([a, 0.5 * a])).requires_grad_(True)
              for a in (q, k, v)]
        out = torch.func.vmap(lambda q, k, v: att.chunked_attention(
            q, k, v, remat_chunks=remat, **kw))(*ts)
        wt = torch.from_numpy(np.stack([w, w]))
        return [out.detach()] + list(torch.autograd.grad((out * wt).sum(),
                                                         ts))
    assert all(torch.equal(a, c) for a, c in zip(mapped(True),
                                                 mapped(False)))


def _model_inputs(arch, seq):
    jcfg = jget_config(arch, reduced=True)
    params = jax.tree.map(np.asarray, jtf.init_lm(jax.random.PRNGKey(3),
                                                  jcfg, dtype=jnp.float32))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, seq + 1),
                        dtype=np.int32)
    return jcfg, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", ["gemma2-27b", "zamba2-7b"])
def test_model_knobs_match_reference(arch):
    """``train_loss`` with both knobs and its gradients, and a prefill's
    last logits with ``skip_masked_chunks``, against the reference's on a
    reduced config whose window spans several chunks; ``remat_attention``
    bit-equal to off in the port, under remat 'none' and 'full'."""
    cfg = get_config(arch, reduced=True)
    assert cfg.window, arch
    seq = 2 * cfg.window
    jcfg, params_np, batch_np = _model_inputs(arch, seq)
    chunk = cfg.window // 2
    kw = dict(chunk=chunk, ssd_chunk=8, skip_masked_chunks=True)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jbatch = jax.tree.map(jnp.asarray, batch_np)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jtf.train_loss(
        p, jbatch, jcfg, remat_attention=True, **kw)))(jparams)
    jlogits = jax.jit(lambda p: jtf.prefill(p, jbatch["tokens"], jcfg,
                                            **kw)[0])(jparams)

    params = interop.params_from_numpy(params_np, "cpu")
    batch = interop.params_from_numpy(batch_np, "cpu")
    flat, treedef = tree_flatten(params)
    runs = {}
    for remat, remat_attention in (("none", False), ("none", True),
                                   ("full", True)):
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss = tf.train_loss(tree_unflatten(treedef, leaves), batch, cfg,
                             remat=remat, remat_attention=remat_attention,
                             **kw)
        grads = torch.autograd.grad(loss, leaves)
        runs[remat, remat_attention] = [loss.detach(), *grads]
    for key, run in runs.items():
        assert all(torch.equal(a, b) for a, b in zip(
            run, runs["none", False])), key
    loss, *grads = runs["full", True]
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        scale = float(np.max(np.abs(np.asarray(jg)))) or 1.0
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-5 * scale)
    logits, _ = tf.prefill(params, batch["tokens"], cfg, **kw)
    scale = float(np.max(np.abs(np.asarray(jlogits))))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-5 * scale)
