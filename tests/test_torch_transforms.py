"""Per-step parity of the port's optimizer chains with the JAX package's.

The toy problem of tests/test_fused.py (4 nodes on a ring, a linear
softmax classifier, 13 steps of seeded numpy batches) runs through the JAX
trainer (``fused='off'``, and ``'pallas'`` in interpret mode) and through
the port's trainer on the CPU (``fused='kernel'``, which takes the kernels'
plain versions on CPU tensors, and ``'off'``), from the JAX init carried
over as numpy.

Tolerance: rtol 1e-5 / atol 1e-6 on every history metric and 1e-5 on the
final params -- the bound the reference holds its own fused and unfused
chains to (tests/test_fused.py).  The optimizer arithmetic is the same
fp32 sequence in both packages; the gradients and the gossip product sum in
another order in XLA than in torch, about one ulp per step.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optim as joptim
from repro.core import topology as jtopo
from repro.train import DecentralizedTrainer as JTrainer
from repro.train import run_training as j_run_training
from repro_torch import interop
from repro_torch.core import optim as toptim
from repro_torch.core import topology as ttopo
from repro_torch.core import transforms as tT
from repro_torch.train import DecentralizedTrainer as TTrainer
from repro_torch.train import run_training as t_run_training

N, D, C, STEPS = 4, 6, 5, 13
METHODS = ["dsgd", "dsgdm", "dsgdm_n", "qg_dsgdm", "qg_dsgdm_n",
           "qg_dsgdm_tau"]
KW = {"weight_decay": 1e-4}
HIST_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)


def _batches(steps=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield (rng.normal(size=(N, 4, D)).astype(np.float32),
               rng.integers(0, C, size=(N, 4)).astype(np.int32))


def _j_init(key):
    k1, _ = jax.random.split(key)
    return ({"w": jax.random.normal(k1, (D, C)) * 0.3, "b": jnp.zeros(C)}, {})


def _j_loss(p, ms, batch, rng):
    xb, yb = batch
    logits = xb @ p["w"] + p["b"]
    ce = jnp.mean(jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
        logits, yb[:, None].astype(jnp.int32), -1)[:, 0])
    return ce, ({}, {})


def _t_loss(p, ms, batch):
    xb, yb = batch
    logits = torch.matmul(xb, p["w"]) + p["b"][:, None, :]
    picked = torch.gather(logits, -1, yb.long()[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, -1) - picked, dim=-1), ({}, {})


@functools.lru_cache(maxsize=None)
def _jax_run(method, fused):
    opt = joptim.make_optimizer(method, lr=0.1, fused=fused, **KW)
    tr = JTrainer(_j_loss, opt, jtopo.ring(N))
    st = tr.init(jax.random.PRNGKey(0), _j_init)
    init = jax.tree.map(np.asarray, st.params)
    st, hist = j_run_training(tr, st, _batches(), STEPS,
                              rng=jax.random.PRNGKey(1), log_every=1,
                              log_fn=lambda *_: None)
    return init, hist, jax.tree.map(np.asarray, st.params)


def _port_run(method, fused, init):
    opt = toptim.make_optimizer(method, lr=0.1, fused=fused, **KW)
    tr = TTrainer(_t_loss, opt, ttopo.ring(N), device="cpu")
    params = interop.params_from_numpy(init, "cpu")
    st = interop.train_state_from_numpy(init, opt.init(params), 0, "cpu")
    st, hist = t_run_training(tr, st, _batches(), STEPS, log_every=1,
                              log_fn=lambda *_: None)
    return hist, {k: v.numpy() for k, v in st.params.items()}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("port_fused", ["kernel", "off"])
@pytest.mark.parametrize("jax_fused", ["off", "pallas"])
def test_chain_tracks_reference_per_step(method, port_fused, jax_fused):
    init, h_j, p_j = _jax_run(method, jax_fused)
    h_t, p_t = _port_run(method, port_fused, init)
    assert len(h_t) == len(h_j) == STEPS
    for a, b in zip(h_t, h_j):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **HIST_TOL,
                                       err_msg=f"{method} step {a['step']} "
                                               f"{k}")
    for k in p_j:
        np.testing.assert_allclose(p_t[k], p_j[k], **PARAM_TOL,
                                   err_msg=f"{method} {k}")


@pytest.mark.parametrize("method", METHODS)
def test_fused_and_unfused_chains_agree_bitwise_on_cpu(method):
    """On CPU tensors the fused path runs the kernels' plain versions, which
    keep the stages' expression order: the two chains are bit-identical."""
    init = _jax_run(method, "off")[0]
    h_k, p_k = _port_run(method, "kernel", init)
    h_o, p_o = _port_run(method, "off", init)
    assert h_k == h_o
    for k in p_k:
        np.testing.assert_array_equal(p_k[k], p_o[k])


def _bf16_step(method, device, fused):
    """One optimizer step on bf16 params (a dtype the kernels refuse)."""
    rng = np.random.default_rng(3)
    params = {"w": torch.from_numpy(rng.normal(size=(N, D, C))),
              "b": torch.from_numpy(rng.normal(size=(N, C)))}
    params = {k: v.to(device=device, dtype=torch.bfloat16)
              for k, v in params.items()}
    opt = toptim.make_optimizer(method, lr=0.1, fused=fused, **KW)
    w = torch.from_numpy(ttopo.ring(N).mixing[0]).to(device, torch.float32)
    return opt.step(params, params, opt.init(params), w=w, t=0)


@pytest.mark.parametrize("method", METHODS[1:])
def test_fused_chain_refuses_unfusable_leaves_off_cpu(method):
    """A segment that matches a kernel but holds non-fp32 leaves runs stage
    by stage on CPU tensors (bit-equal to fused='off'); on any other device
    (the meta device stands in for CUDA here) it raises, naming the leaf,
    rather than hide the kernel behind its plain version."""
    p_k, s_k = _bf16_step(method, "cpu", "kernel")
    p_o, s_o = _bf16_step(method, "cpu", "off")
    for k in p_k:
        assert torch.equal(p_k[k], p_o[k])
    with pytest.raises(TypeError, match="bfloat16, not float32"):
        _bf16_step(method, "meta", "kernel")


def test_fused_qg_buffer_refuses_unfusable_stage_off_cpu():
    """The post-mix segment alone: a non-fp32 buffer, or no mix point
    before it, raises off the CPU."""
    x = torch.zeros(N, 3, device="meta")
    ctx = tT.StepCtx(w=None, lr=torch.full((1,), 0.1, device="meta"),
                     t=torch.zeros((), dtype=torch.int64, device="meta"),
                     mix_fn=None)
    sv = tT.StepVars(grads=x, update=x, params=x, params_pre_mix=x)
    stage = tT.qg_buffer(0.9)
    with pytest.raises(TypeError, match="no gossip_mix or descent"):
        tT.chain_apply((stage,), ctx, sv, {"qg_buffer": stage.init(x)},
                       fused="kernel")
    states = {"qg_buffer": {"m_hat": x.to(torch.float16)}}
    with pytest.raises(TypeError, match="m_hat leaf .* is torch.float16"):
        tT.chain_apply((tT.descent(), stage), ctx, sv, states,
                       fused="kernel")


def test_state_layout_matches_reference():
    """Optimizer state trees of every registry entry carry the reference's
    stage and key names, leaf shapes and dtypes."""
    params_j = {"w": jnp.zeros((N, D, C)), "b": jnp.zeros((N, C))}
    params_t = {"w": torch.zeros(N, D, C), "b": torch.zeros(N, C)}
    assert sorted(toptim.OPTIMIZERS) == sorted(joptim.OPTIMIZERS)
    for method in sorted(joptim.OPTIMIZERS):
        sj = joptim.make_optimizer(method, **KW).init(params_j)
        st = toptim.make_optimizer(method, **KW).init(params_t)
        assert jax.tree.structure(sj) == jax.tree.structure(
            jax.tree.map(lambda t: 0, st)), method
        for a, b in zip(jax.tree.leaves(sj), jax.tree.leaves(
                st, is_leaf=lambda x: isinstance(x, torch.Tensor))):
            assert tuple(a.shape) == tuple(b.shape), method
            assert str(a.dtype) == str(b.dtype).removeprefix("torch."), \
                method


def test_chain_validation():
    with pytest.raises(ValueError, match="duplicate"):
        tT.chain(tT.gossip_mix(), tT.gossip_mix())
    # every registry entry builds (slice 2 took away the refusals)
    assert toptim.make_optimizer("gt").name == "gt"
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.make_optimizer("bogus")
    with pytest.raises(ValueError, match="fused"):
        TTrainer(_t_loss, toptim.make_optimizer("dsgd", fused="bogus"),
                 ttopo.ring(N), device="cpu")


@pytest.mark.parametrize("option,value", [("mesh", object()),
                                          ("runtime", "hybrid"),
                                          ("overlap", "delayed_1"),
                                          ("runtime", "sharded")])
def test_trainer_refuses_unported_options(option, value):
    """Slice 8b ported these options (they raised ``NotImplementedError``);
    each now meets the reference's rule: a mesh must be a ``NodeMesh``,
    the sharded and hybrid runtimes need a mesh, and the delayed gossip
    builds but refuses compressed comm."""
    from repro_torch.comm import make_comm
    make = lambda **kw: TTrainer(_t_loss, toptim.make_optimizer("dsgd"),
                                 ttopo.ring(N), device="cpu", **kw)
    if option == "mesh":
        exc, match, extra = TypeError, "NodeMesh", {}
    elif option == "runtime":
        exc, match, extra = ValueError, "needs a mesh", {}
    else:
        assert make(overlap=value).overlap == value
        exc, match, extra = (ValueError, "compressed comm",
                             {"comm": make_comm("topk:0.5")})
    with pytest.raises(exc, match=match):
        make(**{option: value}, **extra)


def test_lr_schedule_matches_reference():
    from repro.train import lr_schedule as jsched
    from repro_torch.train import lr_schedule as tsched
    kw = dict(total_steps=100, warmup=5, decay_at=(0.5, 0.75), decay=0.1,
              warmup_from=0.01)
    fj, ft = jsched(0.1, **kw), tsched(0.1, **kw)
    for t in range(100):
        got = ft(torch.tensor(t, dtype=torch.int32))
        assert got.shape == (1,) and got.dtype == torch.float32
        assert float(got[0]) == float(fj(t))
