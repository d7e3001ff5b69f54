"""Mamba-2 language model: the benchmark's weights, its plain reference and
its model FLOPs.

The model (Dao and Gu, arXiv:2405.21060) as the port runs it: a tied
embedding, ``n_layer`` pre-norm residual blocks, a final norm and the tied
head. A block is ``x + out_proj(ssd(conv(in_proj(rms(x)))) * silu(z))``:

* ``rms(x) = x / sqrt(mean(x^2) + eps) * (1 + w)``, eps 1e-6;
* ``in_proj`` packs ``[z | x | B | C | dt]`` (one group of B and C);
* a depthwise causal conv of width ``d_conv`` over ``[x | B | C]``, no
  bias, then silu;
* ``dt = softplus(dt + dt_bias)``, ``a = -exp(a_log)`` a head;
* the SSD scan ``h_t = exp(a dt_t) h_{t-1} + dt_t B_t x_t^T``,
  ``y_t = C_t h_t + D x_t``.

Here the scan is computed in its quadratic (dual) form, ``y_t =
sum_{s <= t} (C_t . B_s) exp(sum_{s < r <= t} a dt_r) dt_s x_s``, the segment sums taken by a masked cumulative sum so that no
two large sums are subtracted. It shares no code and no order of sums
with the program's chunked scan. The loss is the mean token cross-entropy
over the published vocabulary, the padded rows of the head masked.

The parameter tree is the one the port's ``transformer`` model takes for
an attention-free stack (``embed``, ``final_norm``, ``blocks`` a one-entry
tuple of leaves stacked over the layers, ``tail`` empty), so that the same
weights are handed to the program and to this reference. It imports
nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.yardstick import six_n_d


def _dims(config: dict) -> dict:
    d = config["d_model"]
    di = config["expand"] * d
    return {"d": d, "di": di, "n": config["d_state"],
            "nh": di // config["headdim"], "p": config["headdim"],
            "k": config["d_conv"], "L": config["n_layer"],
            "vp": config["vocab_rows"]}


def _layer_leaves(config: dict):
    """(name, shape, rule) of one layer's mixer leaves."""
    m = _dims(config)
    return [("in_proj", (m["d"], 2 * m["di"] + 2 * m["n"] + m["nh"]),
             ("normal", 1.0 / math.sqrt(3 * m["d"]))),
            ("conv_w", (m["k"], m["di"] + 2 * m["n"]),
             ("normal", 1.0 / math.sqrt(3 * m["k"]))),
            ("a_log", (m["nh"],), ("a_log", 0.0)),
            ("d_skip", (m["nh"],), ("const", 1.0)),
            ("dt_bias", (m["nh"],), ("dt_bias", 0.0)),
            ("out_proj", (m["di"], m["d"]),
             ("normal", 1.0 / math.sqrt(3 * m["di"] * m["L"])))]


def init_params(config: dict, generator: torch.Generator, device) -> tuple:
    """One node's ``(params, {})``, drawn on ``device`` from ``generator``
    in one normal and one uniform call, at the published model's scales:
    the embedding N(0, 0.02); ``in_proj``, ``conv_w`` and ``out_proj`` at
    the standard deviation of PyTorch's default uniform init of their
    fan-in, ``out_proj`` also over ``sqrt(n_layer)``; ``a_log = log U(1,
    16)``; ``dt_bias`` the inverse softplus of a ``dt`` log-uniform in
    [0.001, 0.1]; ``d_skip`` 1; the norms' weights 0 (a gain of 1)."""
    m = _dims(config)
    L = m["L"]
    per_layer = _layer_leaves(config)
    n_normal = m["vp"] * m["d"] + L * sum(
        math.prod(s) for _, s, (r, _) in per_layer if r == "normal")
    noise = torch.randn(n_normal, generator=generator, device=device)
    unif = torch.rand(2, L, m["nh"], generator=generator, device=device)
    embed = noise[:m["vp"] * m["d"]].reshape(m["vp"], m["d"]) * 0.02
    off = m["vp"] * m["d"]
    layer = {}
    for name, shape, (rule, scale) in per_layer:
        if rule == "normal":
            size = L * math.prod(shape)
            layer[name] = noise[off:off + size].reshape(L, *shape) * scale
            off += size
        elif rule == "a_log":
            layer[name] = torch.log(1.0 + 15.0 * unif[0])
        elif rule == "dt_bias":
            dt = torch.exp(math.log(1e-3) + unif[1] * (
                math.log(1e-1) - math.log(1e-3))).clamp_min(1e-4)
            layer[name] = dt + torch.log(-torch.expm1(-dt))
        else:
            layer[name] = torch.full((L, *shape), scale, device=device)
    blocks = {"ln": torch.zeros(L, m["d"], device=device), "mixer": layer}
    return ({"embed": embed,
             "final_norm": torch.zeros(m["d"], device=device),
             "blocks": (blocks,), "tail": ()}, {})


def _rms(x, w, eps: float = 1e-6):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + w)


def _ssd_quadratic(x, dt, a, b, c):
    """x [B, S, H, P], dt [B, S, H], a [H], b and c [B, S, N] -> y [B, S,
    H, P]."""
    s = x.shape[1]
    adt = (a * dt).transpose(1, 2)                           # [B, H, S]
    later = torch.tril(torch.ones(s, s, dtype=torch.bool, device=x.device),
                       diagonal=-1)                          # r > s
    seg = torch.cumsum(torch.where(later, adt[..., None], 0.0), dim=2)
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=x.device))
    decay = torch.where(causal, torch.exp(seg), 0.0)        # [B, H, t, s]
    weights = (c @ b.transpose(1, 2))[:, None] * decay \
        * dt.transpose(1, 2)[:, :, None, :]
    return torch.einsum("bhts,bshp->bthp", weights, x)


def _block(p: dict, x, config: dict):
    m = _dims(config)
    di, n, nh = m["di"], m["n"], m["nh"]
    mx = p["mixer"]
    proj = _rms(x, p["ln"]) @ mx["in_proj"]
    z, xbc, dt = proj.split([di, di + 2 * n, nh], dim=-1)
    k, s = mx["conv_w"].shape[0], xbc.shape[1]
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    xbc = F.silu(sum(padded[:, i:i + s] * mx["conv_w"][i] for i in range(k)))
    xs, b, c = xbc.split([di, n, n], dim=-1)
    xs = xs.reshape(*xs.shape[:2], nh, m["p"])
    dt = F.softplus(dt + mx["dt_bias"])
    y = _ssd_quadratic(xs, dt, -torch.exp(mx["a_log"]), b, c) \
        + xs * mx["d_skip"][:, None]
    return x + (y.reshape(*y.shape[:2], di) * F.silu(z)) @ mx["out_proj"]


def node_loss(config: dict, params: dict, batch: tuple) -> torch.Tensor:
    """One node's mean next-token cross-entropy over its sequences
    ``tokens`` [B, S + 1]."""
    (tokens,) = batch
    tokens = tokens.long()
    blocks = params["blocks"][0]
    x = F.embedding(tokens[:, :-1], params["embed"])
    for layer in range(config["n_layer"]):
        x = _block({"ln": blocks["ln"][layer],
                    "mixer": {k: v[layer]
                              for k, v in blocks["mixer"].items()}},
                   x, config)
    logits = _rms(x, params["final_norm"]) @ params["embed"].T
    logits = logits.masked_fill(
        torch.arange(logits.shape[-1], device=logits.device)
        >= config["vocab_size"], torch.finfo(torch.float32).min)
    return F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten())


def flops_per_step(config: dict, mix: dict) -> float:
    """Model FLOPs of one training step of every node: 6 a weight a token
    for every weight a token multiplies (``in_proj``, the conv, ``out_proj``
    of each layer, and the tied head once over the published vocabulary;
    not the embedding lookup), plus 3 times the scan's recurrence count
    (5NP + 3P + 2 a token, head and layer) for forward and backward."""
    m = _dims(config)
    per_layer = (m["d"] * (2 * m["di"] + 2 * m["n"] + m["nh"])
                 + m["k"] * (m["di"] + 2 * m["n"]) + m["di"] * m["d"])
    weights = m["L"] * per_layer + m["d"] * config["vocab_size"]
    scan = m["L"] * m["nh"] * (5 * m["n"] * m["p"] + 3 * m["p"] + 2)
    tokens = mix["nodes"] * mix["batch"] * mix["seq_len"]
    return six_n_d(weights, tokens) + 3.0 * scan * tokens
