"""command-r-35b [dense] — GQA kv=8, no biases.  [hf:CohereForAI/c4ai-command-r-v01]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22528,
        vocab_size=256000,
        period=("dense",),
        rope_theta=8_000_000.0,
        source="hf:CohereForAI/c4ai-command-r-v01",
        supports_long_context=False,  # full attention only -> skip long_500k
    )
