"""musicgen-medium [audio] — decoder-only over EnCodec tokens; the EnCodec
frontend is STUBBED (input_specs feeds codec token ids; the 4-codebook delay
pattern is flattened to a single 2048-vocab stream).  [arXiv:2306.05284]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,   # MHA (kv == heads per assignment)
        d_ff=6144,
        vocab_size=2048,
        period=("dense",),
        audio_frontend_stub=True,
        source="arXiv:2306.05284",
        supports_long_context=False,
    )
