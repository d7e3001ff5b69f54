"""Attention: GQA self-attention (full / sliding-window / softcap / qkv-bias),
cross-attention (VLM) and KV-cache decode.

Port of ``repro/models/attention.py``: ``init_attention``, ``_proj``,
``qkv``, ``chunked_attention`` (the online-softmax math),
``decode_attention`` (fp32, and ``lowp`` over a low-precision cache),
``paged_attention`` and ``cross_attention``.  Layouts are the reference's:
q ``[B, S, H, D]``, k/v ``[B, T, K, D]``, GQA by head groups ``H = K * G``.
These are the non-kernel paths (``use_pallas=False``); the kernels
(``flash_attention``, ``paged_decode_attention``) sit behind
``repro_torch.kernels.ops``.  Not ported: the query-chunked sliding-window
variant and the TPU scan controls (``remat``/``unroll``/``repeat_kv``).
"""
from __future__ import annotations

import torch

from ..kernels.ref import attn_scale
from . import layers

__all__ = ["NEG_INF", "init_attention", "qkv", "chunked_attention",
           "decode_attention", "paged_attention", "cross_attention"]

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_attention(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, *, qkv_bias: bool = False, device,
                   dtype=torch.float32) -> dict:
    kw = dict(device=device, dtype=dtype)
    p = {"wq": layers.dense_init(gen, d_model, n_heads * head_dim, **kw),
         "wk": layers.dense_init(gen, d_model, n_kv_heads * head_dim, **kw),
         "wv": layers.dense_init(gen, d_model, n_kv_heads * head_dim, **kw),
         "wo": layers.dense_init(gen, n_heads * head_dim, d_model, **kw)}
    if qkv_bias:
        p["bq"] = torch.zeros(n_heads * head_dim, **kw)
        p["bk"] = torch.zeros(n_kv_heads * head_dim, **kw)
        p["bv"] = torch.zeros(n_kv_heads * head_dim, **kw)
    return p


def _proj(x, w, b=None):
    y = x @ w
    return y if b is None else y + b.to(y.dtype)


def qkv(params: dict, x: torch.Tensor, n_heads: int, n_kv_heads: int,
        head_dim: int):
    """x: [B,S,d] -> q [B,S,H,D], k/v [B,S,K,D]."""
    b, s, _ = x.shape
    q = _proj(x, params["wq"], params.get("bq")).reshape(b, s, n_heads,
                                                         head_dim)
    k = _proj(x, params["wk"], params.get("bk")).reshape(b, s, n_kv_heads,
                                                         head_dim)
    v = _proj(x, params["wv"], params.get("bv")).reshape(b, s, n_kv_heads,
                                                         head_dim)
    return q, k, v


# ---------------------------------------------------------------------------
# chunked (flash-style) attention -- train / prefill
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, chunk: int = 1024):
    """Online-softmax attention over KV chunks of ``chunk`` keys; GQA via
    head groups.  q [B,S,H,D], k/v [B,T,K,D] -> [B,S,H,D] in q's dtype."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    assert h % kh == 0
    g = h // kh
    chunk = min(chunk, t)
    n_chunks = -(-t // chunk)
    qf = q.reshape(b, s, kh, g, d).float() * attn_scale(d)
    q_pos = torch.arange(s, device=q.device)
    acc = torch.zeros(b, s, kh, g, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, s, kh, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(b, s, kh, g, dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        # the last chunk is not padded: the reference's padded keys are
        # masked, so a shorter chunk is the same sum
        kb = k[:, c * chunk:(c + 1) * chunk].float()
        vb = v[:, c * chunk:(c + 1) * chunk].float()
        k_pos = torch.arange(c * chunk, c * chunk + kb.shape[1],
                             device=q.device)
        sc = torch.einsum("bskgd,bckd->bskgc", qf, kb)
        if softcap:
            sc = layers.softcap(sc, softcap)
        mask = torch.ones(s, kb.shape[1], dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        bmask = mask[None, :, None, None, :]
        sc = torch.where(bmask, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        # zero fully-masked chunks explicitly: exp(NEG_INF - NEG_INF) == 1
        p = torch.where(bmask, torch.exp(sc - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bskgc,bckd->bskgd", p,
                                                   vb)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, s, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# decode attention (one query token over a KV cache)
# ---------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, cur_pos, *, window: int = 0,
                     softcap: float = 0.0, k_pos=None, lowp: bool = False):
    """q [B,1,H,D]; k/v_cache [B,T,K,D]; ``cur_pos`` the new token's
    position (0-d int tensor); ``k_pos`` [T] per-slot positions of a ring
    buffer (-1 = empty).

    ``lowp`` is the reference's form for a low-precision (bf16) cache:
    ``q * scale`` and the softmax weights are rounded to the cache's dtype
    before their products, which accumulate in fp32.  A product of two
    bf16 values is exact in fp32, so products taken in fp32 after that
    rounding are the reference's; only the summation order differs."""
    b, _, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qf = q.reshape(b, 1, kh, g, d).float() * attn_scale(d)
    if lowp:
        qf = qf.to(k_cache.dtype).float()
    sc = torch.einsum("bskgd,btkd->bskgt", qf, k_cache.float())
    if softcap:
        sc = layers.softcap(sc, softcap)
    if k_pos is None:
        k_pos = torch.arange(t, device=q.device)
        mask = k_pos <= cur_pos
    else:
        mask = (k_pos >= 0) & (k_pos <= cur_pos)
    if window:
        mask &= k_pos > cur_pos - window
    sc = torch.where(mask[None, None, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    if lowp:
        p = p.to(v_cache.dtype).float()
    out = torch.einsum("bskgt,btkd->bskgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# paged attention (serving) -- per-row positions over a gathered page span
# ---------------------------------------------------------------------------

def paged_attention(q, k, v, q_pos, *, window: int = 0, softcap: float = 0.0):
    """Dense semantics of gather-by-block-table attention.  q [B,C,H,D] a
    chunk of queries per slot; k/v [B,T,K,D] gathered from the page pool;
    ``q_pos`` [B,C] the absolute position of each query.

    The causal mask ``k_pos <= q_pos`` is also the slot-reuse guarantee:
    pool rows holding stale K/V from an evicted sequence only appear at
    logical positions >= the new sequence's length, so they are masked
    without any cache zeroing."""
    b, c, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.reshape(b, c, kh, g, d).float() * attn_scale(d)
    sc = torch.einsum("bskgd,btkd->bskgt", qf, k.float())
    if softcap:
        sc = layers.softcap(sc, softcap)
    k_pos = torch.arange(t, device=q.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]           # [B, C, T]
    if window:
        mask &= k_pos[None, None, :] > q_pos[:, :, None] - window
    sc = torch.where(mask[:, :, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bskgt,btkd->bskgd", p, v.float())
    return out.reshape(b, c, h, d).to(q.dtype)



# ---------------------------------------------------------------------------
# cross attention (VLM) -- queries from text, K/V from image embeddings
# ---------------------------------------------------------------------------

def cross_attention(params: dict, x, kv_src, n_heads: int, n_kv_heads: int,
                    head_dim: int):
    """x [B,S,d] text hidden; kv_src [B,T,d] image embeddings -> [B,S,d]:
    non-causal chunked attention over all T image keys, in KV chunks of
    ``min(1024, T)`` (a shorter last chunk where T is not a multiple)."""
    b, s, _ = x.shape
    t = kv_src.shape[1]
    q = _proj(x, params["wq"], params.get("bq")).reshape(b, s, n_heads,
                                                         head_dim)
    k = _proj(kv_src, params["wk"], params.get("bk")).reshape(
        b, t, n_kv_heads, head_dim)
    v = _proj(kv_src, params["wv"], params.get("bv")).reshape(
        b, t, n_kv_heads, head_dim)
    out = chunked_attention(q, k, v, causal=False, chunk=min(1024, t))
    return out.reshape(b, s, n_heads * head_dim) @ params["wo"]
