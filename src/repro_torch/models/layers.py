"""Shared neural-net building blocks (plain dict params, no ``nn.Module``).

Port of ``repro/models/layers.py``.  Parameters are nested dicts of
tensors; homogeneous layer groups are stacked on a leading axis, as the
reference stacks them for ``lax.scan`` (the port loops over that axis).
Norms, activations and rotary embeddings compute in fp32 and cast back to
the input's dtype, as the reference does.  The init helpers draw from a
``torch.Generator`` on the target device (the reference's ``jax.random``
streams cannot be reproduced; tests carry the reference's arrays across
through ``repro_torch.interop``).  ``device="meta"`` builds the shapes
only, with no draw.
"""
from __future__ import annotations

import math

import torch

from ..tree import tree_map

__all__ = ["normal_init", "dense_init", "embed_init", "stack_layers",
           "rms_norm", "softcap", "swiglu", "init_mlp", "rope_frequencies",
           "apply_rope", "cross_entropy"]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def _normal(shape, gen, device, dtype, scale: float) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        t.normal_(generator=gen).mul_(scale)
    return t.to(dtype)


def normal_init(gen, shape, scale: float, *, device,
                dtype=torch.float32) -> torch.Tensor:
    """``scale`` times a standard normal draw, in fp32, cast to ``dtype``."""
    return _normal(shape, gen, device, dtype, scale)


def dense_init(gen, d_in: int, d_out: int, *, device,
               dtype=torch.float32) -> torch.Tensor:
    return _normal((d_in, d_out), gen, device, dtype, 1.0 / math.sqrt(d_in))


def embed_init(gen, vocab: int, d: int, *, device,
               dtype=torch.float32) -> torch.Tensor:
    return _normal((vocab, d), gen, device, dtype, 0.02)


def stack_layers(n: int, init_fn):
    """``init_fn() -> dict`` called ``n`` times; each leaf stacked on a
    leading axis of length ``n``."""
    trees = [init_fn() for _ in range(n)]
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6, *, split=None) -> torch.Tensor:
    """``split`` (``launch/sharding.Split``): ``x`` and ``weight`` are the
    rank's block of the features, and the mean of squares is the ranks'
    means summed over 'model' over their count (one rank: the mean)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    if split is not None:
        var = split.all_reduce(var, local=True) / split.size
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (torch.nn.functional.silu(g) * u) @ w_down


def init_mlp(gen, d_model: int, d_ff: int, *, device,
             dtype=torch.float32) -> dict:
    return {"gate": dense_init(gen, d_model, d_ff, device=device, dtype=dtype),
            "up": dense_init(gen, d_model, d_ff, device=device, dtype=dtype),
            "down": dense_init(gen, d_ff, d_model, device=device, dtype=dtype)}


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] int."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)  # [D/2]
    ang = positions[..., None].float() * freqs            # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                    # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_valid: int | None = None, *,
                  split=None) -> torch.Tensor:
    """Mean token cross-entropy in fp32; padded vocab rows (>=
    ``vocab_valid``) are masked to the fp32 minimum before the
    logsumexp.  ``split`` (``launch/sharding.Split``): ``logits`` are the
    rank's block of the vocabulary; the logsumexp reduces its max and its
    sum of exps over 'model', and the gold logit is summed from the rank
    that holds it, so no rank holds a whole row of logits."""
    logits = logits.float()
    n = logits.shape[-1]
    first = 0 if split is None else split.index * n
    if vocab_valid is not None and vocab_valid < (
            n if split is None else n * split.size):
        pad = torch.arange(first, first + n, device=logits.device) \
            >= vocab_valid
        logits = torch.where(pad, torch.finfo(torch.float32).min, logits)
    if split is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.mean(lse - gold)
    lse = split.logsumexp(logits)
    local = labels.long() - first
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])
    gold = split.all_reduce(torch.where(inside, gold[..., 0], 0.0))
    return torch.mean(lse - gold)
