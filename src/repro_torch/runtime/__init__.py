"""Execution backends for the decentralized trainer.

Only the node-stacked ``'vmap'`` backend is ported; ``'auto'`` resolves to
it; it runs the scenario engine too (dense masked gossip).  The
reference's ``'sharded'`` and ``'hybrid'`` backends come with slice 8b of
the port.
"""
from __future__ import annotations

from .base import Runtime
from .vmap import VmapRuntime

__all__ = ["Runtime", "VmapRuntime", "RUNTIMES", "make_runtime"]

RUNTIMES = ("auto", "vmap", "sharded", "hybrid")


def make_runtime(trainer, name: str = "auto") -> Runtime:
    if name not in RUNTIMES:
        raise ValueError(f"unknown runtime {name!r}; valid: "
                         f"{' | '.join(RUNTIMES)}")
    if name in ("sharded", "hybrid"):
        raise NotImplementedError(
            f"runtime {name!r} is not ported yet: it comes with slice 8b "
            "of the port; repro_torch runs 'vmap'")
    return VmapRuntime(trainer)
