"""Checkpoints as ``.npz`` of ``|``-joined key paths.

Port of ``repro/train/checkpoint.py``, in its file format: each leaf is
stored under its key path, ``k:<key>`` for a dict entry, ``i:<index>`` for
a tuple or list entry and ``x:.<field>`` for a dataclass field (the
reference's spelling of a pytree path), beside a ``__meta__`` JSON string
``{"step": ..., "extra": {...}}``.  A full-TrainState checkpoint holds
``{"state": TrainState, "rng": key}``: params, opt state, model state (BN's
running statistics), compressed-gossip state, the delayed gossip's
in-flight exchange buffers (``mix_buf``) and the step counter, and the
reference's loop rng key.  A file saved by either package loads in the
other.  It always holds the node-stacked ``[n, ...]`` state: a sharded or
hybrid run gathers its ranks' blocks to write it (``api.run``).

The port has no loop rng (``train/trainer.py``); it keeps the reference's
key as it read it (or the key of the loop seed, ``[0, seed]``) so that the
reference can resume from its files, and stores the state of the trainer's
own ``torch.Generator`` (the compressors' draws) under a key of its own,
``k:torch_rng|k:comm|k:<device type>``, which the reference ignores.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "save_train_state",
           "restore_train_state", "flatten_paths", "tree_from_paths",
           "npz_path", "SEP"]

SEP = "|"
_GEN_KEY = f"k:torch_rng{SEP}k:comm"


def npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _children(tree):
    """``(path part, child)`` of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"k:{k}", v) for k, v in tree.items()]
    if isinstance(tree, (tuple, list)):
        return [(f"i:{i}", v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f"x:.{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _join(prefix: str, part: str) -> str:
    return f"{prefix}{SEP}{part}" if prefix else part


def flatten_paths(tree, prefix: str = "") -> dict:
    """``{key path: leaf}`` of a tree of dicts, tuples, lists and
    dataclasses (None holds no leaf), in the reference's spelling."""
    if tree is None:
        return {}
    children = _children(tree)
    if children is None:
        return {prefix: tree}
    out = {}
    for part, child in children:
        out.update(flatten_paths(child, _join(prefix, part)))
    return out


def tree_from_paths(items: list):
    """Rebuild a dict/tuple tree from ``(path parts, leaf)`` pairs, the
    inverse of :func:`flatten_paths` for the containers model params use."""
    if len(items) == 1 and not items[0][0]:
        return items[0][1]
    first = items[0][0][0]
    groups: dict[str, list] = {}
    for parts, leaf in items:
        groups.setdefault(parts[0], []).append((parts[1:], leaf))
    if first.startswith("k:"):
        return {k[2:]: tree_from_paths(v) for k, v in sorted(groups.items())}
    if first.startswith("i:"):
        idx = sorted(groups.items(), key=lambda kv: int(kv[0][2:]))
        return tuple(tree_from_paths(v) for _, v in idx)
    raise ValueError(f"unsupported checkpoint path component {first!r}")


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree, *, step: int = 0,
                    extra: dict | None = None) -> None:
    """Every leaf of ``tree`` (tensors or arrays) under its key path."""
    flat = {k: _numpy(v) for k, v in flatten_paths(tree).items()}
    meta = {"step": step, "extra": extra or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __meta__=json.dumps(meta), **flat)


def _restore(like, prefix: str, data):
    """``like``'s structure with every leaf read from ``data``: tensors on
    ``like``'s device in its dtype, numpy arrays as stored."""
    if like is None:
        return None
    children = _children(like)
    if children is None:
        if prefix not in data:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        arr = data[prefix]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch at {prefix}: {arr.shape} vs "
                             f"{tuple(like.shape)}")
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                      dtype=like.dtype)
        return arr
    got = [_restore(child, _join(prefix, part), data)
           for part, child in children]
    if isinstance(like, dict):
        return dict(zip(like, got))
    if isinstance(like, (tuple, list)):
        return type(like)(got)
    return dataclasses.replace(like, **{
        f.name: v for f, v in zip(dataclasses.fields(like), got)})


def restore_checkpoint(path: str, like) -> tuple[object, dict]:
    """Restore into the structure of ``like`` (shapes must match)."""
    data = np.load(npz_path(path), allow_pickle=False)
    return _restore(like, "", data), json.loads(str(data["__meta__"]))


# ---------------------------------------------------------------------------
# full-TrainState checkpoints (the spec path's resume surface)
# ---------------------------------------------------------------------------

def save_train_state(path: str, state, *, rng=None, generator=None,
                     step: int | None = None,
                     extra: dict | None = None) -> None:
    """Save a full ``TrainState`` and the reference's loop rng key ``rng``
    (uint32 [2]; default the key of seed 0) as one resumable checkpoint,
    with the state of ``generator`` (the trainer's compressor generator)
    beside them.  ``step`` defaults to the state's own counter."""
    step = int(state.t) if step is None else int(step)
    rng = np.array([0, 0], np.uint32) if rng is None else np.asarray(rng)
    tree = {"state": state, "rng": rng}
    if generator is not None:
        tree["torch_rng"] = {"comm": {
            generator.device.type: generator.get_state()}}
    save_checkpoint(path, tree, step=step, extra=extra)


def restore_train_state(path: str, like_state, *, generator=None
                        ) -> tuple[object, np.ndarray, dict]:
    """``(state, rng, meta)`` saved by :func:`save_train_state` (by either
    package) in the structure of ``like_state``, a freshly built state of
    the same spec.  ``generator`` gets the saved generator state where the
    file has one for its device type; otherwise it keeps its own."""
    data = np.load(npz_path(path), allow_pickle=False)
    state = _restore(like_state, "k:state", data)
    rng = np.array(data["k:rng"])
    if generator is not None:
        key = f"{_GEN_KEY}{SEP}k:{generator.device.type}"
        if key in data:
            generator.set_state(torch.from_numpy(np.array(data[key])))
    return state, rng, json.loads(str(data["__meta__"]))
