"""granite-moe-3b-a800m [moe] — 40 experts top-8 (config field 'MoE 40e
top-8'; HF card matches 40), GQA kv=8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from .base import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,   # padded to 49408
        period=("moe",),
        moe=MoEConfig(n_experts=40, top_k=8),
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        supports_long_context=False,
    )
