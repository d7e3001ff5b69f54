"""tinyllama-1.1b [dense] — llama2-arch small, GQA kv=4.  [arXiv:2401.02385]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        n_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=5632,
        vocab_size=32000,
        period=("dense",),
        source="arXiv:2401.02385",
        supports_long_context=False,
    )
