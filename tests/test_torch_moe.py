"""The port's MoE layer (``repro_torch/models/moe.py``) on the CPU against
the JAX package's ``repro/models/moe.py``, fed the same numpy inputs and
the reference's own init.

Tolerance: 2e-6 abs on outputs of order 1 (``FN_TOL``).  The same fp32
operations; the expert products are summed in another order by torch's
and XLA's CPU kernels, and the port combines a token's k expert outputs
by a gather in rank order where the reference scatter-adds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe
from repro_torch.tree import tree_map

FN_TOL = dict(atol=2e-6, rtol=0)


def _cfgs(arch="granite-moe-3b-a800m", **kw):
    """(reference MoEConfig, port MoEConfig, d_model, d_ff) of the reduced
    arch, fields replaced by ``kw``."""
    jc, tc = jget_config(arch, reduced=True), get_config(arch, reduced=True)
    jm = jmoe.MoEConfig(**{**dataclasses.asdict(jc.moe), **kw})
    tm = dataclasses.replace(tc.moe, **kw)
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    return jm, tm, jc.d_model, jc.d_ff


def _params(jm, d, f, seed=1):
    jp = jax.tree.map(np.asarray,
                      jmoe.init_moe(jax.random.PRNGKey(seed), d, f, jm))
    return jp, interop.params_from_numpy(jp, "cpu")


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _both(jp, tp, x, jm, tm, mask=None):
    jy, jaux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                            jm, token_mask=None if mask is None
                            else jnp.asarray(mask))
    ty, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), tm,
                            token_mask=None if mask is None
                            else torch.from_numpy(mask))
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], **FN_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("arch,kw", [
    ("granite-moe-3b-a800m", {}),
    ("granite-moe-3b-a800m", {"capacity_factor": 0.5}),   # slots drop
    ("arctic-480b", {}),                                  # dense residual
    ("arctic-480b", {"capacity_factor": 0.3}),
])
def test_moe_ffn_matches_reference(arch, kw):
    jm, tm, d, f = _cfgs(arch, **kw)
    jp, tp = _params(jm, d, f)
    assert ("dense" in tp) == bool(tm.dense_ff)
    x = _x(2, 2, 24, d)
    want, got = _both(jp, tp, x, jm, tm)
    _assert_close(got, want)
    with tmoe.recording(routes=True) as drops:
        tmoe.moe_ffn(tp, torch.from_numpy(x), tm)
    (route,) = drops["routes"]
    assert route["expert_idx"].shape == route["valid"].shape == (48,
                                                                 tm.top_k)
    assert int(route["valid"].sum()) == 48 * tm.top_k - int(
        drops["dropped"])
    assert (route["gap"] >= 0).all()
    assert int(drops["routed"]) == 48 * tm.top_k
    cap = tmoe.capacity(48, tm)
    assert cap == max(1, int(48 * tm.top_k / tm.n_experts *
                             tm.capacity_factor))
    # every expert's queue holds at most `cap`: with a small factor the
    # E*cap slots cannot hold all T*k pairs
    if tm.n_experts * cap < 48 * tm.top_k:
        assert int(drops["dropped"]) >= 48 * tm.top_k - tm.n_experts * cap
    else:
        assert int(drops["dropped"]) >= 0


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_token_mask_matches_reference_and_isolates_padding(capacity_factor):
    jm, tm, d, f = _cfgs(capacity_factor=capacity_factor)
    jp, tp = _params(jm, d, f)
    x = _x(3, 2, 12, d)
    mask = np.zeros((2, 12), bool)
    mask[0, :9], mask[1, :4] = True, True
    want, got = _both(jp, tp, x, jm, tm, mask)
    _assert_close(got, want)
    # masked rows give exactly 0; junk in them changes nothing
    junk = x.copy()
    junk[~mask] = _x(4, int((~mask).sum()), d, scale=50.0)
    y_junk, aux_junk = tmoe.moe_ffn(tp, torch.from_numpy(junk), tm,
                                    token_mask=torch.from_numpy(mask))
    assert torch.equal(y_junk[torch.from_numpy(~mask)],
                       torch.zeros(int((~mask).sum()), d))
    np.testing.assert_array_equal(y_junk.numpy(), got[0])
    assert float(aux_junk) == got[1]
    # an all-True mask is bit-identical to no mask
    full = np.ones((2, 12), bool)
    y_all, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), tm,
                            token_mask=torch.from_numpy(full))
    y_none, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), tm)
    assert torch.equal(y_all, y_none)


def test_reference_isolation_property_with_generous_capacity():
    """The reference's own case (``tests/test_serve.py``
    ``test_moe_token_mask_isolates_padding``): with every valid token
    routed, the masked call's valid rows equal the unmasked call on the
    valid tokens alone."""
    jm, tm, d, f = _cfgs(capacity_factor=8.0)
    _, tp = _params(jm, d, f)
    x = _x(5, 1, 8, d)
    junk = np.concatenate([x, _x(6, 1, 4, d, scale=50.0)], axis=1)
    mask = (np.arange(12) < 8)[None, :]
    y_clean, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), tm)
    y_mask, _ = tmoe.moe_ffn(tp, torch.from_numpy(junk), tm,
                             token_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(y_mask[:, :8].numpy(), y_clean.numpy(),
                               atol=1e-6, rtol=1e-6)
    assert not y_mask[:, 8:].any()


def test_routing_tie_takes_the_lower_expert_first():
    """Two experts with identical router columns tie exactly for every
    token.  The port breaks the tie as XLA's TopK does (the lower index
    first: a stable descending sort), so rank 0, which feeds the balance
    loss, and the queue order match the reference's."""
    jm, tm, d, f = _cfgs()
    jp, _ = _params(jm, d, f)
    jp = dict(jp)
    router = jp["router"].copy()
    router[:, 1] += 10.0 * np.abs(router).mean()  # expert 1 leads (x > 0)
    router[:, 2] = router[:, 1]                   # and 2 ties with it
    jp["router"] = router
    tp = interop.params_from_numpy(jp, "cpu")
    x = np.abs(_x(7, 2, 16, d))
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, d)) @
                          torch.from_numpy(router), -1)
    assert torch.equal(probs[:, 1], probs[:, 2])
    idx = jax.lax.top_k(jnp.asarray(np.asarray(probs)), tm.top_k)[1]
    ours = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    np.testing.assert_array_equal(ours[:, :tm.top_k].numpy(),
                                  np.asarray(idx))
    both_top = (np.asarray(idx)[:, 0] == 1) & (np.asarray(idx)[:, 1] == 2)
    assert both_top.mean() > 0.5
    want, got = _both(jp, tp, x, jm, tm)
    _assert_close(got, want)


def test_moe_ffn_under_vmap_equals_two_calls():
    jm, tm, d, f = _cfgs(capacity_factor=0.75)
    _, tp0 = _params(jm, d, f, seed=1)
    _, tp1 = _params(jm, d, f, seed=2)
    stacked = tree_map(lambda a, b: torch.stack([a, b]), tp0, tp1)
    x = torch.from_numpy(_x(8, 2, 2, 10, d))
    mask = torch.from_numpy(np.random.default_rng(9).random((2, 2, 10)) <
                            0.7)
    y, aux = torch.func.vmap(lambda p, xx, m: tmoe.moe_ffn(
        p, xx, tm, token_mask=m))(stacked, x, mask)
    for i, p in enumerate((tp0, tp1)):
        yi, ai = tmoe.moe_ffn(p, x[i], tm, token_mask=mask[i])
        np.testing.assert_allclose(y[i].numpy(), yi.numpy(), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(float(aux[i]), float(ai), rtol=1e-6)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "arctic-480b"])
def test_moe_gradients_match_jax_grad(arch):
    """The training path: d(sum(y * w) + aux) / d(params, x) against
    ``jax.grad`` of the reference, slots dropping (factor 0.75)."""
    jm, tm, d, f = _cfgs(arch, capacity_factor=0.75)
    jp, tp = _params(jm, d, f)
    x = _x(10, 2, 12, d)
    w = _x(11, 2, 12, d)

    def jloss(p, xx):
        y, aux = jmoe.moe_ffn(p, xx, jm)
        return jnp.sum(y * jnp.asarray(w)) + aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    leaves = {k: v for k, v in tp.items() if k != "dense"}
    tpg = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    if "dense" in tp:
        tpg["dense"] = {k: v.clone().requires_grad_(True)
                        for k, v in tp["dense"].items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(tpg, xt, tm)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x),
                               atol=2e-5, rtol=0)
    for k in leaves:
        scale = max(1.0, float(np.abs(np.asarray(jg_p[k])).max()))
        np.testing.assert_allclose(tpg[k].grad.numpy(), np.asarray(jg_p[k]),
                                   atol=2e-5 * scale, rtol=0, err_msg=k)
    for k in tpg.get("dense", {}):
        np.testing.assert_allclose(tpg["dense"][k].grad.numpy(),
                                   np.asarray(jg_p["dense"][k]), atol=2e-5,
                                   rtol=0, err_msg=k)


def test_init_moe_shapes_and_scales_match_reference():
    jm, tm, d, f = _cfgs("arctic-480b")
    want = jax.eval_shape(lambda: jmoe.init_moe(jax.random.PRNGKey(0), d,
                                                f, jm))
    got = tmoe.init_moe(torch.Generator().manual_seed(0), d, f, tm,
                        device="cpu")
    assert sorted(got) == sorted(want)
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert got[k].dtype == torch.float32
    assert {k: tuple(v.shape) for k, v in got["dense"].items()} == \
        {k: tuple(v.shape) for k, v in want["dense"].items()}
    assert abs(float(got["w_gate"].std()) - d ** -0.5) < 0.01
    assert abs(float(got["w_down"].std()) - f ** -0.5) < 0.01
    meta = tmoe.init_moe(None, d, f, tm, device="meta")
    assert meta["w_up"].device.type == "meta"
