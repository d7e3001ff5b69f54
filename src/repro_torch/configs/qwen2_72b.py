"""qwen2-72b [dense] — GQA kv=8, QKV bias.  [arXiv:2407.10671]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        period=("dense",),
        rope_theta=1_000_000.0,
        source="arXiv:2407.10671",
        supports_long_context=False,
    )
