"""Model / run configuration schema.

Port of ``repro/configs/base.py``.  Every assigned architecture is a
``ModelConfig`` built in its own ``configs/<id>.py`` module, registered in
``configs/__init__``.  Reduced (smoke-test) variants come from
``ModelConfig.reduced()`` which preserves the *family* (block pattern,
MoE/SSM/VLM features) while shrinking widths.

The reference defines ``MoEConfig`` in ``models/moe.py`` and ``SSMConfig``
in ``models/ssm.py``; the port keeps both dataclasses here, with the same
fields, and its ``models/ssm.py`` imports ``SSMConfig`` from this module.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    dense_ff: int = 0          # arctic: parallel dense FFN width (0 = off)
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64          # P; n_heads = d_inner / head_dim

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


# block kinds understood by models/transformer.py
BLOCK_KINDS = ("dense", "local", "global", "moe", "mamba", "cross")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # layer pattern: a repeating *period* of block kinds; the full pattern is
    # period tiled to n_layers (n_layers % len(period) == 0).
    period: tuple[str, ...] = ("dense",)
    # extra layers of kind period[0] appended after the scanned main stack
    # (zamba2: 81 = 13 periods x 6 mamba + 3 tail)
    tail_layers: int = 0
    window: int = 0                   # sliding window for 'local' blocks
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # zamba2: a single shared attention(+mlp) block applied after every
    # 'shared_attn_every'-th backbone layer (0 = off)
    shared_attn_every: int = 0
    # vlm: number of image-embedding tokens the stub frontend provides
    n_image_tokens: int = 0
    # audio: input token stream is codec tokens (frontend stubbed)
    audio_frontend_stub: bool = False
    # citation for the config (paper / model card)
    source: str = ""
    # serving: does this arch support the 500k decode shape?
    supports_long_context: bool = False
    mesh_divisor: int = 16            # model-axis size the dims must divide by

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def main_layers(self) -> int:
        return self.n_layers - self.tail_layers

    @property
    def n_periods(self) -> int:
        p = len(self.period)
        assert self.main_layers % p == 0, (self.name, self.n_layers, self.period)
        return self.main_layers // p

    @property
    def pattern(self) -> tuple[str, ...]:
        return self.period * self.n_periods + (self.period[0],) * self.tail_layers

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks), used for roofline
        MODEL_FLOPS = 6*N*D."""
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim
        n_attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + \
            self.n_heads * hd * d
        n_mlp = 3 * d * f
        total = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        for kind in self.pattern:
            if kind in ("dense", "local", "global"):
                total += n_attn + n_mlp + 2 * d
            elif kind == "cross":
                total += 2 * n_attn + n_mlp + 3 * d
            elif kind == "moe":
                m = self.moe
                total += n_attn + 2 * d
                total += d * m.n_experts  # router
                total += m.n_experts * 3 * d * f
                if m.dense_ff:
                    total += 3 * d * m.dense_ff
            elif kind == "mamba":
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                total += d * (2 * di + 2 * s.d_state + nh)  # in_proj
                total += s.d_conv * (di + 2 * s.d_state)
                total += di * d + 3 * nh + d
        if self.shared_attn_every:
            total += n_attn + n_mlp + 2 * d
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        inactive = (m.n_experts - m.top_k) * 3 * self.d_model * self.d_ff
        n_moe_layers = sum(1 for k in self.pattern if k == "moe")
        return self.n_params() - n_moe_layers * inactive

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/features, tiny dims, CPU-runnable.

        2 layers (one period's worth of distinct kinds, capped), d_model<=256,
        <=4 experts."""
        period = self.period
        if len(period) > 2:
            # keep a representative 2-kind period covering the family
            kinds = list(dict.fromkeys(period))  # unique, ordered
            period = tuple(kinds[:2]) if len(kinds) > 1 else (kinds[0],)
        n_layers = 2  # divisible by any len(period) in {1, 2}
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(2, self.moe.top_k),
                dense_ff=64 if self.moe.dense_ff else 0)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=16)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            tail_layers=0,
            d_model=128,
            n_heads=4,
            n_kv_heads=2,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            window=self.window and 64,
            period=period,
            moe=moe,
            ssm=ssm,
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_image_tokens=16 if self.n_image_tokens else 0,
            mesh_divisor=1,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
