"""The port's CV models (``repro_torch.models.resnet``) and the CIFAR
protocol on the CPU, against the JAX package on the same numpy inputs.

Tolerances, each with its reason:
* forward (logits, BN's new running statistics): rtol 1e-4 / atol 1e-4
  times the output's largest magnitude.  The convs sum over k*k*cin
  products in another order in torch than in XLA; 20 layers of that leave
  a few ulp of fp32 (about 3e-6 of logits of order 5 measured here).  In
  eval mode on freshly initialized BN statistics (mean 0, var 1) the logits
  reach 1e3, hence the scale;
* per-node gradients: rtol 1e-3 / atol 1e-4 times the leaf's largest
  gradient: the backward sums in another order again, through the
  norms' divisions;
* the reduced CIFAR run (4 nodes, batch 4, 256 samples, 3 steps) from the
  reference's init and BN state: rtol 1e-4 on loss, consensus, grad_norm
  and lr; accuracy within one eval sample (1/64).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.models import resnet as jres
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.kernels import qg_update as tK
from repro_torch.models import resnet as tres
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_paths, tree_unflatten)

NORMS = ["bn", "gn", "evonorm"]
N, B = 2, 2
FWD_TOL, GRAD_TOL, RUN_RTOL = 1e-4, 1e-3, 1e-4
QUIET = dict(log_fn=lambda *_: None)


@pytest.fixture(autouse=True)
def _torch_on_one_thread():
    """The tier-1 run shares the machine's cores among its workers; the
    port's small CPU runs here gain nothing from torch's thread pool and
    would only crowd the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stacked(init, **kw):
    """The reference's init for N nodes (one key each), node-stacked, as
    numpy, with every param moved off its init by a seeded perturbation so
    that no node equals another and norms' affine params matter."""
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    ps, ss = zip(*[init(k, **kw) for k in keys])
    stack = lambda *a: np.stack([np.asarray(x) for x in a])
    params = jax.tree.map(stack, *ps)
    state = jax.tree.map(stack, *ss) if jax.tree.leaves(ss[0]) else ss[0]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        params)
    return params, state


def _tensors(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, rtol, atol_scale, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=rtol,
        atol=atol_scale * max(float(np.abs(want).max()), 1e-30),
        err_msg=what)


@functools.cache
def _reference_forward(norm, hw):
    """Inputs and the reference's outputs in both modes, from one compiled
    function: (params, state, x, {train: (logits, new state)}).  BN's
    running statistics are first moved off (0, 1) by a train-mode forward
    of other images."""
    params, state = _stacked(jres.init_resnet20, norm=norm)
    x = np.random.default_rng(hw).normal(
        size=(N, B, hw, hw, 3)).astype(np.float32)
    fwd = jax.jit(jax.vmap(lambda p, s, xx: tuple(
        jres.apply_resnet20(p, s, xx, norm=norm, train=t)
        for t in (True, False))))
    if norm == "bn":
        state = jax.tree.map(np.asarray,
                             fwd(params, state, x[::-1].copy())[0][1])
    train, evaluate = fwd(params, state, x)
    return params, state, x, {True: train, False: evaluate}


@pytest.mark.parametrize("hw", [8, 9])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("norm", NORMS)
def test_apply_resnet20_matches_reference(norm, train, hw):
    """hw 8: the stride-2 convs pad as SAME does on an even size, (0, 1);
    hw 9: symmetrically."""
    params, state, x, outs = _reference_forward(norm, hw)
    want, want_s = outs[train]
    got, got_s = tres.apply_resnet20(_tensors(params), _tensors(state),
                                     torch.from_numpy(x), norm=norm,
                                     train=train)
    assert got.shape == (N, B, 10)
    _close(got, want, FWD_TOL, FWD_TOL, f"{norm} train={train} logits")
    assert tree_paths(got_s) == [tuple(str(k.key) for k in p) for p, _ in
                                 jax.tree_util.tree_flatten_with_path(
                                     want_s)[0]]
    for g, w in zip(tree_leaves(got_s), jax.tree.leaves(want_s)):
        _close(g, w, FWD_TOL, FWD_TOL, f"{norm} train={train} state")


def test_even_size_pads_asymmetrically():
    """The trap the SAME padding avoids: padding (1, 1) at stride 2 on an
    even size gives the same shape and other values."""
    w = torch.randn(1, 3, 3, 3, 4, generator=torch.Generator().manual_seed(0))
    h = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(1))
    x = jnp.asarray(h.permute(0, 2, 3, 1).numpy())
    want = jax.lax.conv_general_dilated(
        x, jnp.asarray(w[0].numpy()), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tres._conv(h, w, 2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    symmetric = torch.nn.functional.conv2d(
        h, w[0].permute(3, 2, 0, 1), stride=2, padding=1).permute(0, 2, 3, 1)
    assert symmetric.shape == got.shape
    assert float((symmetric - got).abs().max()) > 0.1


def _ce(logits, y):
    return jnp.mean(jax.nn.logsumexp(logits, -1)
                    - jnp.take_along_axis(logits, y[:, None], -1)[:, 0])


@pytest.mark.parametrize("norm", NORMS)
def test_per_node_grads_match_reference(norm):
    params, state = _stacked(jres.init_resnet20, norm=norm)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, B, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(N, B)).astype(np.int32)

    def loss(p, s, xx, yy):
        logits, _ = jres.apply_resnet20(p, s, xx, norm=norm, train=True)
        return _ce(logits, yy)

    want = jax.jit(jax.vmap(jax.grad(loss)))(params, state, x, y)
    tparams = _tensors(params)
    paths = tree_paths(tparams)
    leaves, treedef = tree_flatten(tparams)
    leaves = [t.requires_grad_(True) for t in leaves]
    logits, _ = tres.apply_resnet20(tree_unflatten(treedef, leaves),
                                    _tensors(state), torch.from_numpy(x),
                                    norm=norm)
    picked = torch.gather(logits, -1, torch.from_numpy(y).long()[..., None])
    per_node = (torch.logsumexp(logits, -1) - picked[..., 0]).mean(-1)
    grads = torch.autograd.grad(per_node.sum(), leaves)
    assert len(grads) == len(jax.tree.leaves(want)) > 60
    for path, g, w in zip(paths, grads, jax.tree.leaves(want)):
        _close(g, w, GRAD_TOL, FWD_TOL, f"{norm} grad {path}")


def test_apply_vgg11_matches_reference():
    params, state = _stacked(jres.init_vgg11, width_factor=0.5)
    x = np.random.default_rng(3).normal(
        size=(N, B, 32, 32, 3)).astype(np.float32)
    want, _ = jax.jit(jax.vmap(lambda p, xx: jres.apply_vgg11(p, {}, xx)))(
        params, x)
    got, _ = tres.apply_vgg11(_tensors(params), {}, torch.from_numpy(x))
    _close(got, want, FWD_TOL, FWD_TOL, "vgg11 logits")


def _paths_and_shapes(tree):
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in p), tuple(np.shape(v)))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("model,kw", [
    ("resnet20", {"norm": "bn"}), ("resnet20", {"norm": "gn"}),
    ("resnet20", {"norm": "evonorm"}), ("resnet20", {"norm": "gn",
                                                     "width": 2}),
    ("vgg11", {"width_factor": 0.5})])
def test_init_tree_and_scales_match_reference(model, kw):
    """Same key paths and shapes as the reference's init (params and
    state); conv weights at He scale sqrt(2 / fan_in), the head at
    1/sqrt(cin), norms at ones/zeros (sample std within 10%)."""
    jinit = getattr(jres, f"init_{model}")
    tinit = getattr(tres, f"init_{model}")
    jp, js = jinit(jax.random.PRNGKey(0), **kw)
    tp, ts = tinit(torch.Generator().manual_seed(0), **kw)
    as_np = lambda t: tree_map(lambda a: a.numpy(), t)
    assert _paths_and_shapes(as_np(tp)) == _paths_and_shapes(jp)
    assert _paths_and_shapes(as_np(ts)) == _paths_and_shapes(js)
    for (path, _), leaf in zip(_paths_and_shapes(as_np(tp)), tree_leaves(tp)):
        if path[-1] in ("scale", "v"):
            assert torch.equal(leaf, torch.ones_like(leaf)), path
        elif path[-1] in ("bias", "head_b"):
            assert torch.equal(leaf, torch.zeros_like(leaf)), path
        else:
            fan_in = leaf.shape[0] if leaf.dim() == 2 else \
                leaf.shape[0] * leaf.shape[1] * leaf.shape[2]
            want = (1.0 if leaf.dim() == 2 else 2.0) / fan_in
            assert abs(float(leaf.std()) / np.sqrt(want) - 1) < 0.1, path


@pytest.mark.parametrize("norm,launches", [("evonorm", [48, 32]),
                                           ("gn", [48, 13]),
                                           ("bn", [48, 13])])
def test_qg_step_plan_over_resnet20_leaves(norm, launches):
    """ResNet-20's tree in ``qg_step``: two launches a step (48 leaves a
    launch), every leaf on the float4 path but ``head_b`` (10 columns),
    which takes the scalar loop."""
    params, _ = tres.init_resnet20(torch.Generator().manual_seed(0),
                                   norm=norm)
    paths, leaves = tree_paths(params), tree_leaves(params)
    plan = tK.qg_step_plan([(leaf.numel(), [0] * 5) for leaf in leaves])
    assert [len(entries) for entries, _ in plan] == launches
    scalar = [paths[i] for entries, _ in plan for i, _, vec in entries
              if not vec]
    assert scalar == [("head_b",)]
    assert sum(leaf.numel() for leaf in leaves) == \
        (272_970 if norm == "evonorm" else 272_282)


def _reduced(norm):
    return japi.presets.get("cifar_ring16_alpha0.1_qg").override(
        "topology.n=4", "data.batch=4", "data.n_data=256", "loop.steps=3",
        "loop.log_every=1", f"model.kwargs.norm={norm}")


@pytest.mark.parametrize("norm", NORMS)
def test_reduced_cifar_run_tracks_reference(norm):
    """The preset cut to 4 nodes through ``api.run(device="cpu")`` from the
    reference's init and BN state, against ``repro.api.run``."""
    spec = _reduced(norm)
    ref = japi.run(spec, **QUIET)
    ref_state = japi.build(spec).state
    init = jax.tree.map(np.asarray, ref_state.params)
    mstate = jax.tree.map(np.asarray, ref_state.model_state)
    tspec = tapi.ExperimentSpec.from_json(spec.to_json())
    opt_state = tapi.build(tspec, device="cpu").trainer.optimizer.init(
        interop.params_from_numpy(init, "cpu"))
    state = interop.train_state_from_numpy(init, opt_state, 0, "cpu",
                                           model_state=mstate)
    got = tapi.run(tspec, device="cpu", state=state, **QUIET)
    assert len(got.history) == len(ref.history) == 3
    for a, b in zip(got.history, ref.history):
        for k in ("loss", "consensus", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=RUN_RTOL,
                                       err_msg=f"{norm} step {a['step']} "
                                               f"{k}")
    assert abs(got.final["acc"] - ref.final["acc"]) <= 1 / 64 + 1e-9
    assert got.wire == ref.wire


def test_step_hands_the_optimizer_contiguous_grads_and_detached_state(
        monkeypatch):
    """``Runtime._stage_compute``'s two repairs: a conv weight permuted in
    the forward gets a permuted (non-contiguous) gradient from autograd,
    which the CUDA kernels refuse, so the step makes it contiguous; BN's
    new running statistics come back without a graph (the loss here
    returns them attached, as a plugin may)."""
    ex = tapi.build(tapi.ExperimentSpec.from_json(_reduced("bn").to_json()),
                    device="cpu")

    def attached_loss(p, s, batch):
        logits, ns = tres.apply_resnet20(p, s, batch[0], norm="bn")
        return logits.logsumexp(-1).mean(-1), (ns, {})

    ex.trainer.loss_fn = attached_loss
    seen = []
    real = type(ex.trainer.optimizer).step

    def spy(self, params, grads, *a, **kw):
        seen.extend(tree_leaves(grads))
        return real(self, params, grads, *a, **kw)

    monkeypatch.setattr(type(ex.trainer.optimizer), "step", spy)
    batch = ex.trainer.put_batch(next(ex.task.make_iter()))
    # autograd's own gradient of the permuted stem weight is not contiguous
    leaves, treedef = tree_flatten(ex.state.params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, (ns, _) = attached_loss(
            tree_unflatten(treedef, leaves),
            ex.state.model_state, batch)
        raw = torch.autograd.grad(loss.sum(), leaves, retain_graph=True)
    assert not all(g.is_contiguous() for g in raw)
    assert all(s.grad_fn is not None for s in tree_leaves(ns))
    state, _ = ex.trainer.step(ex.state, batch)
    assert len(seen) == len(leaves)
    assert all(g.is_contiguous() for g in seen)
    assert all(s.grad_fn is None and not s.requires_grad
               for s in tree_leaves(state.model_state))
    assert len(tree_leaves(state.model_state)) == 38
