"""Leaves of nested dicts, tuples and lists by path, so that the program's
trees and the reference's are compared leaf by leaf by name, and a leaf's
norm summed in float64."""
from __future__ import annotations

import torch


def flatten(tree, prefix: str = "") -> dict:
    """``{"a/b/0/c": leaf}``: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(flatten(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def rebuild(tree, leaves: dict, prefix: str = ""):
    """``tree`` with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rebuild(v, leaves, f"{prefix}/{i}" if prefix
                                  else str(i)) for i, v in enumerate(tree))
    return leaves[prefix]


def norm64(t: torch.Tensor) -> float:
    """The Euclidean norm of ``t``, its squares summed in float64, a slice
    of at most 2**26 elements at a time."""
    flat = t.reshape(-1)
    total = 0.0
    for i in range(0, flat.numel(), 1 << 26):
        total += float(flat[i:i + (1 << 26)].double().square().sum())
    return total ** 0.5
