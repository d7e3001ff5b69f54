"""Compressed-communication subsystem.

Port of ``repro/comm/``: compressors (top-k / random-k / sign+norm / QSGD),
error-feedback residual buffers, and the CHOCO-gossip schedule that plugs
into the optimizers' ``mix_fn`` hook.
"""
from . import choco, compressors, error_feedback
from .choco import (CompressedGossip, capture_mix_targets, count_mix_sites,
                    make_comm)
from .compressors import (Compressor, Identity, QSGD, RandomK, SignNorm,
                          TopK, make_compressor, tree_wire_bits)
from .error_feedback import ef21_update, ef_compress, init_residual

__all__ = [
    "choco", "compressors", "error_feedback",
    "CompressedGossip", "capture_mix_targets", "count_mix_sites",
    "make_comm",
    "Compressor", "Identity", "QSGD", "RandomK", "SignNorm", "TopK",
    "make_compressor", "tree_wire_bits",
    "ef21_update", "ef_compress", "init_residual",
]
