"""llama-3.2-vision-11b [vlm] — cross-attention image layers every 5th layer;
vision encoder STUBBED: input_specs feeds [B, 1601, d_model] patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        period=("dense", "dense", "dense", "dense", "cross"),
        rope_theta=500_000.0,
        n_image_tokens=1601,   # 1 tile x (40x40 patches + cls)
        source="hf:meta-llama/Llama-3.2-11B-Vision",
        supports_long_context=False,
    )
