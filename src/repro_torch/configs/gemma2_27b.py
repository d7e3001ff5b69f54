"""gemma2-27b [dense] — local+global alternating attention, logit softcaps,
GQA kv=16.  [arXiv:2408.00118]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        family="dense",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        d_ff=36864,
        vocab_size=256000,
        head_dim=128,                # gemma2-27b uses head_dim 128
        period=("local", "global"),
        window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
        rope_theta=10000.0,
        source="arXiv:2408.00118",
        # sliding-window *serving variant* makes 500k decode feasible:
        # local layers window the cache; the alternating global layers run in
        # windowed mode too for this shape (documented in DESIGN.md).
        supports_long_context=True,
    )
