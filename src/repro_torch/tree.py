"""Nested-dict trees of tensors: the port's stand-in for ``jax.tree``.

Parameters and optimizer state are plain (nested) dicts of node-stacked
tensors with the JAX package's key names.  Leaves are visited in sorted-key
order, the order ``jax.tree`` gives a dict, so packed buffers and leaf lists
line up with the reference's.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_leaves", "tree_paths", "tree_map", "tree_unflatten",
           "nest_map", "nest_leaves"]

Tree = Any


def _is_node(x) -> bool:
    return isinstance(x, dict)


def tree_paths(tree: Tree, prefix: tuple = ()) -> list[tuple]:
    """Key paths of every leaf, in sorted-key (``jax.tree``) order."""
    if not _is_node(tree):
        return [prefix]
    out = []
    for k in sorted(tree):
        out.extend(tree_paths(tree[k], prefix + (k,)))
    return out


def tree_leaves(tree: Tree) -> list:
    if not _is_node(tree):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over corresponding leaves of trees of one structure."""
    if not _is_node(tree):
        return fn(tree, *rest)
    for r in rest:
        if not _is_node(r) or set(r) != set(tree):
            raise ValueError("tree_map: trees differ in structure")
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}


def tree_unflatten(paths: list[tuple], leaves: list) -> Tree:
    """Inverse of (:func:`tree_paths`, :func:`tree_leaves`)."""
    if len(paths) == 1 and paths[0] == ():
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(paths, leaves, strict=True):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def nest_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over corresponding leaves of trees of dicts *and tuples* (the
    LM's params, caches and page pools keep a tuple per period position,
    as the reference's do); the structure is kept, tuples as tuples."""
    if isinstance(tree, dict):
        return {k: nest_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, tuple):
        return tuple(nest_map(fn, *items) for items in zip(tree, *rest,
                                                            strict=True))
    return fn(tree, *rest)


def nest_leaves(tree: Tree) -> list:
    """Leaves of a tree of dicts and tuples, dict keys in sorted order and
    tuple entries in order: the order ``jax.tree.leaves`` gives."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in nest_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in nest_leaves(v)]
    return [tree]
