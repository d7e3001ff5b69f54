"""Packed flat-param layout for the fused optimizer passes.

Port of the layout half of ``repro/kernels/pack.py``: :func:`plan_pack`
computes a static offset table from leaf shapes, :func:`pack` flattens a
node-stacked tree of fp32 leaves into one contiguous fp32 buffer
(``torch.cat`` gives a fresh, 16-byte-aligned allocation), and
:func:`unpack` restores the tree as views into that buffer, free of copies.

The reference pads the packed buffer to a multiple of ``PACK_TILE`` because
its Pallas grid takes whole tiles.  The CUDA kernels mask the ragged tail
instead, so :func:`pack` does not pad; ``PackSpec.padded`` is kept for the
bytes-moved accounting, which charges the fused side the padded length as
the reference does.  For the same reason the reference's pow2 launch
buckets (``bucket_size``) have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import (tree_flatten, tree_leaves, tree_paths,
                              tree_unflatten)

__all__ = ["PackSpec", "plan_pack", "pack", "unpack", "PACK_TILE"]

#: the reference's pad quantum for packed whole-tree buffers (8Ki fp32)
PACK_TILE = 8 * 1024


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static offset table for one tree role (params / momentum / grads);
    one spec packs every role of the same structure."""

    paths: tuple    # the leaves' names (tree_paths)
    treedef: tuple  # the tree's containers (tree_flatten)
    shapes: tuple
    offsets: tuple
    sizes: tuple
    total: int      # sum of leaf sizes: the packed buffer's length
    padded: int     # the reference's tile-padded length (accounting only)
    tile: int

    @property
    def pad_waste(self) -> float:
        return (self.padded - self.total) / max(self.padded, 1)


def plan_pack(tree, *, tile: int = PACK_TILE) -> PackSpec:
    """Offset table for ``tree`` (leaves in sorted-key order)."""
    leaves, treedef = tree_flatten(tree)
    shapes = tuple(tuple(l.shape) for l in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s
    return PackSpec(paths=tuple(tree_paths(tree)), treedef=treedef,
                    shapes=shapes, offsets=tuple(offsets), sizes=sizes,
                    total=off, padded=max(tile, -(-off // tile) * tile), tile=tile)


def pack(spec: PackSpec, tree) -> torch.Tensor:
    """Flatten ``tree`` (fp32 leaves only: the kernels stream fp32) into one
    contiguous ``[spec.total]`` buffer."""
    leaves = tree_leaves(tree)
    if len(leaves) != len(spec.shapes):
        raise ValueError(f"pack: tree has {len(leaves)} leaves, spec expects "
                         f"{len(spec.shapes)}")
    for path, l in zip(spec.paths, leaves):
        if l.dtype != torch.float32:
            raise TypeError(f"pack: leaf {path!r} is {l.dtype}, not float32")
    if not leaves:
        return torch.zeros(0, dtype=torch.float32)
    return torch.cat([l.reshape(-1) for l in leaves])


def unpack(spec: PackSpec, buf: torch.Tensor):
    """Inverse of :func:`pack`: the leaves are views into ``buf``."""
    leaves = [buf[o:o + n].view(shape)
              for o, n, shape in zip(spec.offsets, spec.sizes, spec.shapes)]
    return tree_unflatten(spec.treedef, leaves)
