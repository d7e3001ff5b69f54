"""Checkpoints of the port (``repro_torch.train.checkpoint``) on the CPU:
the reference's npz key-path format, read and written by both packages,
and resume parity.

* Across the packages: a file the reference's ``run`` saved loads into the
  port leaf for leaf, bit for bit (params, opt state, BN's model state,
  CHOCO's comm state, the step counter and the rng key); the port writes
  it back with every key equal to the reference's, bit for bit, and the
  reference restores the port's file; a run of the reference resumed from
  a port checkpoint continues the port's run (rtol 1e-4, the runs' own
  bound: the products sum in other orders in the two packages).
* Resume parity in the port: a run saving every 2 steps, interrupted
  after its first save (step 2, or 3 in chunks of 3) and resumed to step 4,
  ends on the uninterrupted run's state bit for bit (same arithmetic, same
  batches, the compressor generator's state restored), BN's running
  statistics and CHOCO's replicas included, and its history rows after
  the cut are the uninterrupted run's.
* The CLI's ``--checkpoint`` / ``--resume``.
"""
import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.train import checkpoint as jckpt
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.api.__main__ import main as tmain
from repro_torch.train import checkpoint as tckpt

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
SPECS = {
    # BN: the first run with model state
    "cifar_bn": ("cifar_ring16_alpha0.1_qg", (
        "topology.n=4", "data.batch=4", "data.n_data=256",
        "model.kwargs.norm=bn")),
    # CHOCO top-k: comm state; QSGD: comm state and the generator's draws
    "choco": ("choco_topk0.01_ring16_qg", ()),
    "qsgd": ("choco_topk0.01_ring16_qg", ("comm.compressor=qsgd:4",
                                          "comm.backend=auto")),
}


def _spec(name, steps, *extra):
    preset, overrides = SPECS[name]
    return japi.presets.get(preset).override(
        *overrides, f"loop.steps={steps}", "loop.log_every=1", *extra)


def _tspec(spec):
    return tapi.ExperimentSpec.from_json(spec.to_json())


def _npz(path):
    data = np.load(path)
    return {k: data[k] for k in data.files}


@pytest.mark.parametrize("name", ["cifar_bn", "choco"])
def test_checkpoints_load_across_packages(name, tmp_path):
    spec = _spec(name, 2)
    jpath, tpath = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    japi.run(spec, checkpoint_path=jpath, **QUIET)
    ex = tapi.build(_tspec(spec), device="cpu")
    state, rng, meta = tckpt.restore_train_state(jpath, ex.state)
    assert meta["step"] == 2 and int(state.t) == 2
    assert rng.dtype == np.uint32 and rng.shape == (2,)
    saved = _npz(jpath)
    flat = tckpt.flatten_paths({"state": state})
    assert set(flat) | {"k:rng", "__meta__"} == set(saved)
    for key, leaf in flat.items():
        assert np.array_equal(leaf.numpy(), saved[key]), key
    if name == "cifar_bn":
        assert any("x:.model_state" in k and k.endswith("k:var")
                   for k in flat)
    else:
        assert any("x:.comm_state|i:0|k:x_hat" in k for k in flat)

    tckpt.save_train_state(tpath, state, rng=rng)
    written = _npz(tpath)
    for key, arr in saved.items():
        if key != "__meta__":
            assert np.array_equal(written[key], arr), key
            assert written[key].dtype == arr.dtype, key
    jstate, jrng, jmeta = jckpt.restore_train_state(
        tpath, japi.build(spec).state)
    assert jmeta["step"] == 2 and np.array_equal(np.asarray(jrng), rng)
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(
            jckpt.restore_train_state(jpath, japi.build(spec).state)[0])):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_reference_resumes_a_port_checkpoint(tmp_path):
    """The port runs 4 steps from the reference's init, saving at 2; the
    reference resumes that file for steps 2-3 and follows the port's run."""
    spec = _spec("choco", 4, "loop.checkpoint_every=2")
    tspec = _tspec(spec)
    ref_state = japi.build(spec).state
    init = jax.tree.map(np.asarray, ref_state.params)
    opt_state = tapi.build(tspec, device="cpu").trainer.optimizer.init(
        interop.params_from_numpy(init, "cpu"))
    state = interop.train_state_from_numpy(
        init, opt_state, 0, "cpu", comm_state=[
            jax.tree.map(np.asarray, s) for s in ref_state.comm_state])
    cut = str(tmp_path / "cut.npz")
    tapi.run(tspec.override("loop.steps=2"), device="cpu", state=state,
             checkpoint_path=cut, **QUIET)
    full = tapi.run(tspec, device="cpu", state=state, **QUIET)
    ref = japi.run(spec, resume=cut, **QUIET)
    assert [r["step"] for r in ref.history] == [2, 3]
    for a, b in zip(ref.history, full.history[2:]):
        for k in ("loss", "consensus", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4,
                                       err_msg=f"step {a['step']} {k}")


@pytest.mark.parametrize("name", ["cifar_bn", "choco", "qsgd"])
@pytest.mark.parametrize("chunk", [1, 3])
def test_resume_matches_the_uninterrupted_run_bit_for_bit(name, chunk,
                                                          tmp_path):
    """The cut is the run of the same spec (its lr schedule spans
    loop.steps) with ``loop.checkpoint_every=2``, interrupted from its
    ``log_fn`` after its first periodic save, as a killed run leaves it:
    step 2, or step 3 where the chunk of 3 carries the save to its end."""
    spec = _tspec(_spec(name, 4, f"loop.chunk={chunk}"))
    full_path, cut_path, resumed_path = (str(tmp_path / f"{p}.npz") for p in
                                         ("full", "cut", "resumed"))
    full = tapi.run(spec, device="cpu", checkpoint_path=full_path, **QUIET)
    cut_at = 2 if chunk == 1 else 3

    class Cut(Exception):
        pass

    def interrupt(line):
        if line.startswith("step") and int(line.split()[1]) >= cut_at:
            raise Cut

    with pytest.raises(Cut):
        tapi.run(spec.override("loop.checkpoint_every=2"), device="cpu",
                 checkpoint_path=cut_path, log_fn=interrupt)
    assert tckpt.restore_checkpoint(cut_path, {})[1]["step"] == cut_at
    resumed = tapi.run(spec, device="cpu", resume=cut_path,
                       checkpoint_path=resumed_path, **QUIET)
    assert [r["step"] for r in resumed.history] == list(range(cut_at, 4))
    assert resumed.history == full.history[cut_at:]
    assert resumed.final == full.final
    want, got = _npz(full_path), _npz(resumed_path)
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    if name == "cifar_bn":
        assert sum("x:.model_state" in k for k in want) == 38


def test_checkpoint_every_saves_on_cadence(tmp_path):
    """Periodic saves land on multiples of ``checkpoint_every`` (the first
    chunk boundary at or after one, in the chunked loop)."""
    from repro_torch.train import run_training, run_training_scanned
    ex = tapi.build(_tspec(_spec("choco", 7)), device="cpu")
    for loop, kw, want in ((run_training, {}, [2, 4, 6]),
                           (run_training_scanned, {"chunk": 3}, [3, 6])):
        saves = []
        loop(ex.trainer, ex.state, ex.task.make_iter(), 7,
             checkpoint_every=2,
             checkpoint_fn=lambda done, st: saves.append(
                 (done, int(st.t))), **kw, **QUIET)
        assert saves == [(d, d) for d in want]


def test_resume_past_the_end_raises(tmp_path):
    path = str(tmp_path / "c.npz")
    spec = _tspec(_spec("choco", 3))
    tapi.run(spec, device="cpu", checkpoint_path=path, **QUIET)
    with pytest.raises(ValueError, match="raise loop.steps"):
        tapi.run(spec.override("loop.steps=2"), device="cpu", resume=path,
                 **QUIET)


def test_cli_checkpoint_and_resume(tmp_path, capsys):
    """``python -m repro_torch.api --checkpoint`` / ``--resume``, called in
    process."""
    ckpt = tmp_path / "c.npz"
    base = ["choco_topk0.01_ring16_qg", "--device", "cpu", "--set",
            "loop.log_every=1", "--checkpoint", str(ckpt)]
    assert tmain(base + ["--set", "loop.steps=2"]) == 0
    assert np.load(ckpt)["k:state|x:.t"] == 2
    capsys.readouterr()
    assert tmain(base + ["--set", "loop.steps=3", "--resume",
                         str(ckpt)]) == 0
    shown = capsys.readouterr().out
    assert f"resumed from {ckpt} at step 2" in shown
    assert "steps=3" in shown
    assert np.load(ckpt)["k:state|x:.t"] == 3


def test_pytree_checkpoints_round_trip_across_packages(tmp_path):
    """``save_checkpoint`` / ``restore_checkpoint`` on a tree with a tuple
    (VGG-11's ``convs``) and a 0-d leaf, each package reading the other's
    file, bit for bit."""
    from repro.models import resnet as jres
    params, _ = jres.init_vgg11(jax.random.PRNGKey(0))
    tree = {"params": params, "t": np.int32(7)}
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_checkpoint(jpath, tree, step=3, extra={"a": 1})
    like = interop.params_from_numpy(jax.tree.map(np.asarray, tree),
                                        "cpu")
    got, meta = tckpt.restore_checkpoint(jpath, like)
    assert meta == {"step": 3, "extra": {"a": 1}}
    assert isinstance(got["params"]["convs"], tuple)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), got))):
        assert np.array_equal(np.asarray(a), b)
    tckpt.save_checkpoint(tpath, got, step=3, extra={"a": 1})
    back, meta = jckpt.restore_checkpoint(tpath, tree)
    assert meta == {"step": 3, "extra": {"a": 1}}
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
