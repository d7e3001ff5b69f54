"""``repro_torch.tree`` against ``jax.tree`` on the same trees, and the
task a run can share.

* a tree of dicts and tuples (with an empty tuple, as an LM's ``tail``)
  flattens to the leaves, in the order, and to the key paths that
  ``jax.tree_util`` gives, and ``tree_unflatten`` of its treedef rebuilds
  the same containers;
* a treedef is hashable and tells a tuple from a dict keyed by ints;
* ``tree_unflatten`` refuses too few and too many leaves;
* the trainer keeps the params' treedef from its first step;
* ``api.run(spec, task=...)`` with the task ``api.build`` made for the
  spec gives the run it would have built itself, bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch import api as tapi
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map, tree_paths,
                              tree_unflatten)


def _lm_like():
    rng = np.random.default_rng(0)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"embed": arr(4, 3), "final_norm": arr(3),
            "blocks": ({"attn": {"wq": arr(2, 3, 3), "wk": arr(2, 3, 1)},
                        "ln1": arr(2, 3)},
                       {"mlp": {"up": arr(2, 3, 5)}, "ln1": arr(2, 3)}),
            "tail": ()}


def test_flatten_matches_jax_and_round_trips():
    tree = _lm_like()
    leaves, treedef = tree_flatten(tree)
    want, want_def = jax.tree_util.tree_flatten_with_path(tree)
    assert [l is w for l, (_, w) in zip(leaves, want)] == [True] * len(want)
    assert tree_leaves(tree) == leaves
    assert tree_paths(tree) == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
        for p, _ in want]
    back = tree_unflatten(treedef, [torch.from_numpy(l) for l in leaves])
    assert isinstance(back["blocks"], tuple) and back["tail"] == ()
    assert jax.tree.structure(tree_map(lambda t: t.numpy(), back)) == \
        want_def
    assert tree_flatten(back)[1] == treedef


def test_treedef_is_hashable_and_tells_tuples_from_int_keyed_dicts():
    _, as_tuple = tree_flatten((1.0, 2.0))
    _, as_dict = tree_flatten({0: 1.0, 1: 2.0})
    assert as_tuple != as_dict
    assert len({as_tuple, as_dict, tree_flatten(_lm_like())[1]}) == 3
    assert tree_paths((1.0, 2.0)) == tree_paths({0: 1.0, 1: 2.0})


@pytest.mark.parametrize("n, word", [(1, "too few"), (3, "too many")])
def test_unflatten_refuses_a_wrong_number_of_leaves(n, word):
    _, treedef = tree_flatten({"a": 1.0, "b": (2.0,)})
    with pytest.raises(ValueError, match=word):
        tree_unflatten(treedef, [0.0] * n)


def test_trainer_keeps_the_params_treedef_from_its_first_step():
    spec = tapi.presets.get("quickstart_ring16_alpha0.1_qg")
    ex = tapi.build(spec, device="cpu")
    assert ex.trainer.params_treedef is None
    batch = ex.trainer.put_batch(next(ex.task.make_iter()))
    state, _ = ex.trainer.step(ex.state, batch)
    assert ex.trainer.params_treedef == tree_flatten(ex.state.params)[1]
    assert tree_flatten(state.params)[1] == ex.trainer.params_treedef


def test_run_with_a_shared_task_is_the_run():
    spec = tapi.presets.get("quickstart_ring16_alpha0.1_qg").override(
        "loop.steps=6", "loop.log_every=1")
    quiet = dict(device="cpu", log_fn=lambda *_: None)
    task = tapi.build(spec, device="cpu").task
    a = tapi.run(spec, **quiet)
    b = tapi.run(spec, task=task, **quiet)
    assert a.history == b.history and a.final == b.final
