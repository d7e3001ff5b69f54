"""VmapRuntime: the node-stacked execution backend.

Port of ``repro/runtime/vmap.py``.  Every tensor carries the node index as
its stacked leading axis ``[n, ...]`` on one device; per-node work is a
batch dimension written out, and the transform chain contracts the node
axis directly.  The base class already implements it; this subclass only
pins the name.
"""
from __future__ import annotations

import dataclasses

from .base import Runtime


@dataclasses.dataclass
class VmapRuntime(Runtime):
    name: str = "vmap"
