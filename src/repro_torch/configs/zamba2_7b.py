"""zamba2-7b [hybrid] — Mamba2 backbone + ONE shared attention block applied
every 6 backbone layers (81 = 13x6 scanned + 3 tail).  [arXiv:2411.15242]"""
from .base import SSMConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        tail_layers=3,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        head_dim=112,
        period=("mamba",) * 6,
        shared_attn_every=6,
        window=4096,     # shared-attn KV is windowed -> 500k decode feasible
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
        source="arXiv:2411.15242",
        supports_long_context=True,
    )
