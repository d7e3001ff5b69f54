"""arctic-480b [moe] — 128 experts top-2 + dense residual FFN branch.
[hf:Snowflake/snowflake-arctic-base]"""
from .base import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        period=("moe",),
        moe=MoEConfig(n_experts=128, top_k=2, dense_ff=4864),
        source="hf:Snowflake/snowflake-arctic-base",
        supports_long_context=False,
    )
