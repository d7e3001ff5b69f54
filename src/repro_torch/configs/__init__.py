"""Architecture registry: ``--arch <id>`` resolves here (port of
``repro/configs/__init__.py``: the same ten configs under the same ids)."""
from __future__ import annotations

from .base import INPUT_SHAPES, InputShape, ModelConfig, MoEConfig, SSMConfig

from . import (
    arctic_480b,
    command_r_35b,
    gemma2_27b,
    granite_moe_3b,
    llama32_vision_11b,
    mamba2_130m,
    musicgen_medium,
    qwen2_72b,
    tinyllama_1b,
    zamba2_7b,
)

ARCHS = {
    "gemma2-27b": gemma2_27b.config,
    "command-r-35b": command_r_35b.config,
    "mamba2-130m": mamba2_130m.config,
    "llama-3.2-vision-11b": llama32_vision_11b.config,
    "granite-moe-3b-a800m": granite_moe_3b.config,
    "qwen2-72b": qwen2_72b.config,
    "tinyllama-1.1b": tinyllama_1b.config,
    "musicgen-medium": musicgen_medium.config,
    "zamba2-7b": zamba2_7b.config,
    "arctic-480b": arctic_480b.config,
}


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    cfg = ARCHS[arch]()
    return cfg.reduced() if reduced else cfg


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise ValueError(f"unknown shape {name!r}; have {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


__all__ = ["ARCHS", "INPUT_SHAPES", "ModelConfig", "MoEConfig", "SSMConfig",
           "InputShape",
           "get_config", "get_shape"]
