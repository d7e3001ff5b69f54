"""Trees of tensors: the port's stand-in for ``jax.tree``.

Parameters and optimizer state are nested dicts of node-stacked tensors
with the JAX package's key names; a language model's trees also hold
tuples (one entry per period position in ``blocks``, one per tail layer in
``tail``), as the reference's do.  Leaves are visited in the order
``jax.tree`` gives: dict keys sorted, tuple entries in order, so packed
buffers and leaf lists line up with the reference's.

As in ``jax.tree_util``, :func:`tree_flatten` splits a tree into its leaves
and its ``treedef``, and :func:`tree_unflatten` puts leaves back into a
treedef.  A treedef is a hashable nested tuple: ``None`` for a leaf,
``(dict, ((key, treedef), ...))`` with the keys sorted, ``(tuple,
(treedef, ...))``; it keeps the containers that hold no leaf (an LM's
empty ``tail``).  A structure fixed for a run is flattened once and its
treedef kept.  :func:`tree_paths` gives the leaves' names only: a path
names a dict entry by its key and a tuple entry by its index.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_leaves", "tree_flatten", "tree_unflatten", "tree_paths",
           "tree_map"]

Tree = Any
TreeDef = Any

_END = object()


def _flatten(tree, out: list) -> TreeDef:
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(tree[k], out))
                            for k in sorted(tree)))
    if isinstance(tree, tuple):
        return (tuple, tuple(_flatten(v, out) for v in tree))
    out.append(tree)
    return None


def tree_flatten(tree: Tree) -> tuple[list, TreeDef]:
    """``(leaves, treedef)``: the leaves in ``jax.tree`` order and the
    tree's containers."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _build(treedef: TreeDef, leaves):
    if treedef is None:
        return next(leaves)
    kind, children = treedef
    if kind is dict:
        return {k: _build(d, leaves) for k, d in children}
    return tuple([_build(d, leaves) for d in children])


def tree_unflatten(treedef: TreeDef, leaves: list) -> Tree:
    """Inverse of :func:`tree_flatten`: ``leaves`` in ``treedef``'s
    containers."""
    it = iter(leaves)
    try:
        tree = _build(treedef, it)
    except StopIteration:
        raise ValueError(f"tree_unflatten: {len(leaves)} leaves are too few "
                         "for the treedef") from None
    if next(it, _END) is not _END:
        raise ValueError(f"tree_unflatten: {len(leaves)} leaves are too "
                         "many for the treedef")
    return tree


def _leaves(tree, out: list) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, tuple):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)


def tree_leaves(tree: Tree) -> list:
    out: list = []
    _leaves(tree, out)
    return out


def _paths(tree, prefix: tuple, out: list) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _paths(tree[k], prefix + (k,), out)
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            _paths(v, prefix + (i,), out)
    else:
        out.append(prefix)


def tree_paths(tree: Tree) -> list[tuple]:
    """Key paths of every leaf, in ``jax.tree`` order."""
    out: list = []
    _paths(tree, (), out)
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError("tree_map: trees differ in structure")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, tuple):
        for r in rest:
            if not isinstance(r, tuple) or len(r) != len(tree):
                raise ValueError("tree_map: trees differ in structure")
        return tuple(tree_map(fn, *items) for items in zip(tree, *rest))
    return fn(tree, *rest)
