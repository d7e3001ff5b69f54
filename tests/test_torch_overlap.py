"""The port's delayed gossip (``overlap='delayed_1'``) against the JAX
package on the CPU.

Mirrors ``tests/test_overlap.py``: the registry and the spec's round trip,
the spec's and the trainer's refusals (with the reference's texts), the
capture of the t = 0 exchange buffers, the first delayed step equal to the
synchronous one and the later ones apart, stability on ring-4 (a negative
eigenvalue of W), ``mix_buf`` through a checkpoint bit for bit (loop and
chunk), and the telemetry (``staleness_gap``, ``gossip_wait_ms``; none
when synchronous).  Then the port held against the reference from the
reference's init on its tier-1 toy task: the vmap delayed run over 6 steps
(``qg_dsgdm_n`` with one topology site and ``mt_dsgdm`` with two) within
the reference's own rtol 2e-4 / atol 1e-5, and the hybrid backend at d = 1
(a one-rank gloo group) against the reference's hybrid runtime on a
one-device mesh, in this process, synchronous and delayed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import optim as joptim
from repro.core import topology as jtopo
from repro.launch.mesh import make_debug_mesh
from repro.runtime import OVERLAPS as J_OVERLAPS
from repro.runtime.overlap import DAMPING as J_DAMPING
from repro.train import DecentralizedTrainer as JTrainer
from repro.train import run_training as j_run_training
from repro.train import run_training_scanned as j_run_scanned
from repro_torch import api as tapi
from repro_torch.comm import make_comm
from repro_torch.core import optim as toptim
from repro_torch.core import topology as ttopo
from repro_torch.launch import distributed, mesh as tmesh
from repro_torch.runtime import OVERLAPS
from repro_torch.runtime.overlap import DAMPING, capture_topology_mix_sites
from repro_torch.telemetry import MemorySink, TelemetryRecorder
from repro_torch.train import DecentralizedTrainer as TTrainer
from repro_torch.train import run_training, run_training_scanned
from repro_torch.tree import tree_leaves

#: the reference's tolerance for the delayed parity runs
RTOL, ATOL = 2e-4, 1e-5
QUIET = dict(log_fn=lambda *_: None)
D, C, B = 6, 5, 4          # the toy task: features, classes, batch


def _spec(steps, chunk=1, ckpt_every=0, overlap="delayed_1", **telemetry):
    spec = tapi.ExperimentSpec(
        name="overlap-test", seed=3, overlap=overlap,
        data=tapi.DataSpec(alpha=1.0, batch=8, n_data=256, n_classes=5,
                           hw=4),
        topology=tapi.TopologySpec(name="ring", n=4),
        optim=tapi.OptimSpec(name="qg_dsgdm_n", lr=0.05),
        loop=tapi.LoopSpec(steps=steps, chunk=chunk, log_every=1,
                           checkpoint_every=ckpt_every),
        eval=tapi.EvalSpec(enabled=False),
        model=tapi.ModelSpec(name="mlp"))
    if telemetry:
        spec = spec.replace(telemetry={"enabled": True, "sink": "memory",
                                       **telemetry})
    return spec


# ---------------------------------------------------------------------------
# the toy task of the reference's tests, in both packages
# ---------------------------------------------------------------------------

def _j_init(key):
    k1, _ = jax.random.split(key)
    return ({"w": jax.random.normal(k1, (D, C)) * 0.3, "b": jnp.zeros(C)},
            {})


def _j_loss(p, ms, batch, rng):
    xb, yb = batch
    logits = xb @ p["w"] + p["b"]
    ce = jnp.mean(jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
        logits, yb[:, None].astype(jnp.int32), -1)[:, 0])
    return ce, ({}, {})


#: the reference's x^0, carried into the port's init
X0 = {k: np.asarray(v) for k, v in _j_init(jax.random.PRNGKey(0))[0].items()}


def _t_init(generator):
    return {k: torch.from_numpy(v.copy()) for k, v in X0.items()}, {}


def _t_loss(p, ms, batch):
    xb, yb = batch
    logits = torch.matmul(xb, p["w"]) + p["b"][:, None, :]
    ce = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, yb.long()[..., None])[..., 0]
    return torch.mean(ce, -1), ({}, {})


def _batches(n, steps, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, B, D)).astype(np.float32),
             rng.integers(0, C, size=(n, B)).astype(np.int32))
            for _ in range(steps)]


def _t_trainer(method, topo, overlap, **kw):
    return TTrainer(_t_loss, toptim.make_optimizer(method, lr=0.1), topo,
                    device="cpu", overlap=overlap, **kw)


def _t_run(tr, steps, chunk=1):
    st = tr.init(_t_init, torch.Generator())
    loop = (run_training if chunk == 1 else
            lambda *a, **k: run_training_scanned(*a, chunk=chunk, **k))
    return loop(tr, st, iter(_batches(tr.topology.n, steps)), steps,
                log_every=1, **QUIET)


def _j_run(method, n, overlap, steps, mesh=None, runtime="auto", chunk=1):
    tr = JTrainer(_j_loss, joptim.make_optimizer(method, lr=0.1),
                  jtopo.ring(n), mesh=mesh, node_axis="data",
                  runtime=runtime, overlap=overlap)
    st = tr.init(jax.random.PRNGKey(0), _j_init)
    batches = [(b[0], b[1]) for b in _batches(n, steps)]
    if chunk > 1:
        return j_run_scanned(tr, st, iter(batches), steps, chunk=chunk,
                             rng=jax.random.PRNGKey(1), log_every=1, **QUIET)
    return j_run_training(tr, st, iter(batches), steps,
                          rng=jax.random.PRNGKey(1), log_every=1, **QUIET)


def _hold(t_out, j_out, what):
    (t_st, t_hist), (j_st, j_hist) = t_out, j_out
    assert len(t_hist) == len(j_hist), what
    for th, jh in zip(t_hist, j_hist):
        for k in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(th[k], jh[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {k} @ {th['step']}")
    for a, b in zip(tree_leaves(t_st.params), jax.tree.leaves(j_st.params),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=f"{what} params")
    if j_st.mix_buf is not None:
        for a, b in zip(tree_leaves(tuple(t_st.mix_buf)),
                        jax.tree.leaves(j_st.mix_buf), strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       err_msg=f"{what} mix_buf")


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process: the hybrid backend at
    d = 1."""
    path = tmp_path_factory.mktemp("one_rank") / "store"
    distributed.initialize(f"file://{path}", 1, 0, backend="gloo")
    yield tmesh.make_node_mesh(1)
    distributed.shutdown()


# ---------------------------------------------------------------------------
# spec and trainer validation
# ---------------------------------------------------------------------------

def test_overlap_registry():
    assert OVERLAPS == J_OVERLAPS == ("none", "delayed_1")
    assert DAMPING == J_DAMPING == 0.5


def test_spec_overlap_field_validated_and_roundtrips():
    spec = _spec(4)
    assert spec.overlap == "delayed_1"
    assert spec.validate() is spec
    assert tapi.ExperimentSpec.from_json(spec.to_json()) == spec
    ref = japi.ExperimentSpec.from_json(spec.to_json())
    assert ref.to_dict() == spec.to_dict()
    assert spec.override("overlap=none").overlap == "none"
    for bad in (_spec(4, overlap="delayed_2"),
                _spec(4).replace(comm={"compressor": "topk:0.5"}),
                _spec(4).replace(scenario={"enabled": True,
                                           "participation": 0.5})):
        with pytest.raises(ValueError, match="overlap") as got:
            bad.validate()
        with pytest.raises(ValueError, match="overlap") as want:
            japi.ExperimentSpec.from_json(bad.to_json()).validate()
        assert str(got.value).split(": ", 1)[1] == \
            str(want.value).split(": ", 1)[1]


def test_trainer_overlap_validation():
    with pytest.raises(ValueError, match="overlap"):
        _t_trainer("dsgd", ttopo.ring(4), "delayed_2")
    with pytest.raises(ValueError, match="compressed comm"):
        _t_trainer("dsgd", ttopo.ring(4), "delayed_1",
                   comm=make_comm("topk:0.5"))


def test_capture_topology_mix_sites():
    """One exchange buffer a topology mix site (QG's gossip_mix), equal to
    the node-stacked params, so the first correction is zero; MT-DSGDm
    has two sites; another matrix's site is not captured."""
    tr = _t_trainer("qg_dsgdm_n", ttopo.ring(4), "delayed_1")
    st = tr.init(_t_init, torch.Generator())
    assert st.mix_buf is not None and len(st.mix_buf) == 1
    for a, b in zip(tree_leaves(st.mix_buf[0]), tree_leaves(st.params),
                    strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    mt = _t_trainer("mt_dsgdm", ttopo.ring(4), "delayed_1")
    assert len(mt.init(_t_init, torch.Generator()).mix_buf) == 2
    # buffer_sync('complete') mixes the 1/n matrix: that site stays
    # synchronous, only the params site is captured
    sync = toptim.make_optimizer("dsgdm_n_sync_global", lr=0.1)
    assert len(capture_topology_mix_sites(sync, st.params,
                                          tr._mixing[0])) == 1


def test_sync_trainer_has_no_mix_buf():
    tr = _t_trainer("dsgd", ttopo.ring(4), "none")
    assert tr.init(_t_init, torch.Generator()).mix_buf is None


# ---------------------------------------------------------------------------
# the delayed trajectory
# ---------------------------------------------------------------------------

def test_overlap_first_step_matches_sync_then_diverges():
    _, h_s = _t_run(_t_trainer("qg_dsgdm_n", ttopo.ring(4), "none"), 6)
    _, h_d = _t_run(_t_trainer("qg_dsgdm_n", ttopo.ring(4), "delayed_1"), 6)
    assert h_s[0]["loss"] == h_d[0]["loss"]
    assert not np.isclose(h_s[-1]["loss"], h_d[-1]["loss"], rtol=1e-5)


@pytest.mark.parametrize("method", ["dsgd", "qg_dsgdm_n"])
def test_overlap_delayed_trajectory_is_stable(method):
    """The lazy (I + W) / 2 damping: 40 delayed steps on ring-4 (a negative
    eigenvalue of W) train, they do not oscillate."""
    _, hist = _t_run(_t_trainer(method, ttopo.ring(4), "delayed_1"), 40)
    loss = np.array([h["loss"] for h in hist])
    assert np.isfinite(loss).all()
    assert loss.max() < 3.0 * loss[0]
    assert loss[-5:].mean() <= loss[:5].mean()


@pytest.mark.parametrize("chunk", [1, 4], ids=["python-loop", "scanned"])
def test_overlap_save_resume_mix_buf_parity(tmp_path, chunk):
    """A delayed run cut at step 6 of 12 and resumed equals the whole run
    bit for bit, ``mix_buf`` included (re-capturing the buffers from the
    restored params would split the trajectories)."""
    whole, st_whole = tapi.run(_spec(12, chunk), device="cpu",
                               with_state=True, **QUIET)
    path = str(tmp_path / "ckpt.npz")
    tapi.run(_spec(6, chunk, ckpt_every=3), device="cpu",
             checkpoint_path=path, **QUIET)
    resumed, st_res = tapi.run(_spec(12, chunk), device="cpu", resume=path,
                               with_state=True, **QUIET)
    assert int(st_res.t) == int(st_whole.t) == 12
    by_step = {h["step"]: h for h in whole.history}
    for h in resumed.history:
        assert h == by_step[h["step"]]
    for a, b in zip(tree_leaves((st_whole.params, tuple(st_whole.mix_buf))),
                    tree_leaves((st_res.params, tuple(st_res.mix_buf))),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [1, 4], ids=["python-loop", "scanned"])
def test_overlap_telemetry_probe_keys(chunk):
    """Collecting steps of a delayed run emit ``gossip_wait_ms`` (the host
    probe) and ``staleness_gap``; the history equals the one without
    telemetry bit for bit."""
    ex = tapi.build(_spec(8, chunk, every=1), device="cpu")
    rec = TelemetryRecorder(ex.trainer.telemetry, MemorySink())
    loop = run_training if chunk == 1 else (
        lambda *a, **k: run_training_scanned(*a, chunk=chunk, **k))
    _, hist = loop(ex.trainer, ex.state, ex.task.make_iter(), 8,
                   log_every=1, telemetry=rec, **QUIET)
    rec.flush()
    assert [r["step"] for r in rec.sink.rows] == list(range(8))
    for row in rec.sink.rows:
        assert np.isfinite(row["staleness_gap"]), row
        assert row["gossip_wait_ms"] >= 0.0, row
    assert rec.sink.rows[0]["staleness_gap"] == 0.0 or \
        rec.sink.rows[0]["staleness_gap"] < 1e-3
    plain = tapi.run(_spec(8, chunk), device="cpu", **QUIET)
    assert hist == plain.history


def test_sync_run_has_no_overlap_telemetry():
    ex = tapi.build(_spec(4, overlap="none", every=1), device="cpu")
    rec = TelemetryRecorder(ex.trainer.telemetry, MemorySink())
    run_training(ex.trainer, ex.state, ex.task.make_iter(), 4,
                 telemetry=rec, **QUIET)
    rec.flush()
    assert rec.sink.rows
    for row in rec.sink.rows:
        assert "gossip_wait_ms" not in row
        assert "staleness_gap" not in row


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["qg_dsgdm_n", "mt_dsgdm"])
def test_delayed_vmap_matches_reference(method):
    """6 delayed steps on ring-8 from the reference's init: one topology
    site (QG-DSGDm-N) and two (MT-DSGDm's tracker mix, in call order)."""
    _hold(_t_run(_t_trainer(method, ttopo.ring(8), "delayed_1"), 6),
          _j_run(method, 8, "delayed_1", 6), f"vmap/{method}")


@pytest.mark.parametrize("overlap,chunk", [("none", 1), ("delayed_1", 1),
                                           ("delayed_1", 3)],
                         ids=["sync", "delayed-loop", "delayed-chunk"])
def test_hybrid_d1_matches_reference_hybrid(one_rank, overlap, chunk):
    """The port's hybrid backend on a one-rank group against the
    reference's hybrid runtime on a one-device mesh, in this process."""
    mesh1 = make_debug_mesh(shape=(1,), axes=("data",))
    tr = _t_trainer("qg_dsgdm_n", ttopo.ring(8), overlap, mesh=one_rank,
                    runtime="hybrid")
    assert tr._runtime.name == "hybrid"
    _hold(_t_run(tr, 6, chunk),
          _j_run("qg_dsgdm_n", 8, overlap, 6, mesh=mesh1, runtime="hybrid",
                 chunk=chunk), f"hybrid/{overlap}/{chunk}")
