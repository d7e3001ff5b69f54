"""mamba2-130m [ssm] — attention-free SSD backbone.  [arXiv:2405.21060]"""
from .base import SSMConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=0,          # attention-free
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,   # padded to 50432 for the 16-way model axis
        head_dim=64,
        period=("mamba",),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
        source="arXiv:2405.21060",
        supports_long_context=True,  # O(1) state decode
    )
