"""Attention: GQA self-attention (full / sliding-window / softcap / qkv-bias),
cross-attention (VLM) and KV-cache decode.

Port of ``repro/models/attention.py``: ``init_attention``, ``_proj``,
``qkv``, ``chunked_attention`` (the online-softmax math, with the
reference's two chunk knobs: ``skip_masked_chunks`` takes sliding-window
self-attention by query chunks, each over the KV span it can see, O(S *
window) work instead of O(S^2); ``remat_chunks`` recomputes each KV
chunk's scores in the backward), ``decode_attention`` (fp32, and ``lowp``
over a low-precision cache; through ``decode_attention_block``, which a
pinned decode runs on the rank's block of the cache with the reductions
over the other ranks as arguments), ``paged_attention`` and
``cross_attention`` (its attention on projected heads: ``cross_attend``).
Layouts are the reference's: q ``[B, S, H, D]``, k/v ``[B, T, K, D]``, GQA
by head groups ``H = K * G``.  These are the non-kernel paths
(``use_pallas=False``); the kernels (``flash_attention``,
``paged_decode_attention``) sit behind ``repro_torch.kernels.ops``.  Not
ported: the TPU scan control ``unroll``.
"""
from __future__ import annotations

import torch

from ..kernels.ref import attn_scale
from . import layers

__all__ = ["NEG_INF", "init_attention", "qkv", "chunked_attention",
           "decode_attention", "decode_attention_block", "paged_attention",
           "cross_attention", "cross_attend"]

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

def _one_chunk(acc, m, l, qf, kb, vb, start: int, causal: bool,
               window: int, softcap: float):
    """One KV chunk (keys ``start .. start + C - 1``) of the online
    softmax: ``(acc, m, l)`` -> their values after the chunk."""
    s, c = qf.shape[1], kb.shape[1]
    q_pos = torch.arange(s, device=qf.device)
    k_pos = torch.arange(start, start + c, device=qf.device)
    sc = torch.einsum("bskgd,bckd->bskgc", qf, kb)
    if softcap:
        sc = layers.softcap(sc, softcap)
    mask = torch.ones(s, c, dtype=torch.bool, device=qf.device)
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
    acc = acc * corr[..., None] + torch.einsum("bskgc,bckd->bskgd", p, vb)
    return acc, m_new, l


class _ChunkRemat(torch.autograd.Function):
    """:func:`_one_chunk` whose backward recomputes it: the forward saves
    only its inputs, not the chunk's ``[B, S, K, G, C]`` fp32 scores and
    weights, and the backward runs the chunk again under
    ``torch.func.vjp`` (the reference's ``jax.checkpoint`` of its scan
    body; ``torch.utils.checkpoint`` does not compose with
    ``torch.func``).  The same operations as the plain chunk, so the
    values and gradients are the same bits."""

    generate_vmap_rule = True

    @staticmethod
    def forward(acc, m, l, qf, kb, vb, opts):
        return _one_chunk(acc, m, l, qf, kb, vb, *opts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.opts = inputs[-1]
        ctx.save_for_backward(*inputs[:-1])

    @staticmethod
    def backward(ctx, *grads):
        _, vjp = torch.func.vjp(
            lambda *t: _one_chunk(*t, *ctx.opts), *ctx.saved_tensors)
        return (*vjp(tuple(grads)), None)


def _groups(h: int, kh: int) -> int:
    """Query heads a K/V head: ``h / kh`` (1 for no heads at all)."""
    if kh == 0:
        assert h == 0
        return 1
    assert h % kh == 0
    return h // kh


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, chunk: int = 1024,
                      skip_masked_chunks: bool = False,
                      remat_chunks: bool = False, repeat_kv: bool = False):
    """Online-softmax attention over KV chunks of ``chunk`` keys; GQA via
    head groups.  q [B,S,H,D], k/v [B,T,K,D] -> [B,S,H,D] in q's dtype.

    ``skip_masked_chunks`` takes causal sliding-window self-attention
    (``window``, ``S == T`` a multiple of the chunk) by query chunks
    (:func:`_windowed_attention_qchunked`), the reference's condition;
    elsewhere it changes nothing.  ``remat_chunks`` recomputes each KV
    chunk in the backward (:class:`_ChunkRemat`).  ``repeat_kv`` repeats
    K/V to the H heads first (head ``i`` reads K/V head ``i // G``), as the
    reference does: one head dim, which the heads split over 'model'
    divides.  The values are the same; K/V's gradient sums the G copies
    after the products, another order than the grouped products' sum.
    Zero heads (a rank past the last head of an uneven split) give an empty
    output that autograd still reaches q, K and V from."""
    b, s, h, d = q.shape
    if repeat_kv and k.shape[2] != h:
        g = _groups(h, k.shape[2])
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    t, kh = k.shape[1], k.shape[2]
    g = _groups(h, kh)
    chunk = min(chunk, t)
    if skip_masked_chunks and window and causal and s == t \
            and t % chunk == 0:
        return _windowed_attention_qchunked(q, k, v, window=window,
                                            softcap=softcap, chunk=chunk)
    n_chunks = -(-t // chunk)
    qf = q.reshape(b, s, kh, g, d).float() * attn_scale(d)
    acc = torch.zeros(b, s, kh, g, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, s, kh, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(b, s, kh, g, dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        # the last chunk is not padded: the reference's padded keys are
        # masked, so a shorter chunk is the same sum
        kb = k[:, c * chunk:(c + 1) * chunk].float()
        vb = v[:, c * chunk:(c + 1) * chunk].float()
        opts = (c * chunk, causal, window, softcap)
        if remat_chunks:
            acc, m, l = _ChunkRemat.apply(acc, m, l, qf, kb, vb, opts)
        else:
            acc, m, l = _one_chunk(acc, m, l, qf, kb, vb, *opts)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, s, h, d).to(q.dtype)


def _windowed_attention_qchunked(q, k, v, *, window: int, softcap: float,
                                 chunk: int):
    """Causal sliding-window attention that touches only the keys each
    query chunk can see: query chunk ``i`` attends over the span
    ``[i*chunk - w*chunk, (i+1)*chunk)``, ``w = ceil(window / chunk)``,
    with K/V padded on the left so every span is in bounds (the padded
    keys masked).  One softmax a query chunk over ``(w + 1) * chunk``
    keys: O(S * window) work instead of O(S^2).  ``S`` must be a multiple
    of ``min(chunk, S)``."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = _groups(h, kh)
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"query-chunked windowed attention needs the "
                         f"length {s} to be a multiple of the chunk {chunk}")
    w_chunks = max(1, -(-window // chunk))
    span = (w_chunks + 1) * chunk
    pad = w_chunks * chunk
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, pad, 0))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, pad, 0))
    scale = attn_scale(d)
    outs = []
    for i in range(s // chunk):
        qb = q[:, i * chunk:(i + 1) * chunk].reshape(
            b, chunk, kh, g, d).float() * scale
        kb = kp[:, i * chunk:i * chunk + span].float()
        vb = vp[:, i * chunk:i * chunk + span].float()
        q_pos = i * chunk + torch.arange(chunk, device=q.device)
        k_pos = i * chunk - pad + torch.arange(span, device=q.device)
        sc = torch.einsum("bskgd,bckd->bskgc", qb, kb)
        if softcap:
            sc = layers.softcap(sc, softcap)
        mask = ((q_pos[:, None] >= k_pos[None, :])
                & (q_pos[:, None] - k_pos[None, :] < window)
                & (k_pos[None, :] >= 0))
        sc = torch.where(mask[None, :, None, None, :], sc, NEG_INF)
        p = torch.softmax(sc, dim=-1)
        out = torch.einsum("bskgc,bckd->bskgd", p, vb)
        outs.append(out.reshape(b, chunk, h, d))
    return torch.cat(outs, dim=1).to(q.dtype)


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
    qf = q.reshape(b, 1, kh, h // kh, d).float() * attn_scale(d)
    if k_pos is None:
        k_pos = torch.arange(t, device=q.device)
    out = decode_attention_block(qf, k_cache, v_cache, cur_pos, k_pos,
                                 window=window, softcap=softcap, lowp=lowp)
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_block(qf, k_block, v_block, cur_pos, k_pos, *,
                           window: int = 0, softcap: float = 0.0,
                           lowp: bool = False, sum_scores=None,
                           over_slots=None):
    """:func:`decode_attention` on a block of the cache: ``qf`` [B', 1,
    K', G, D'] the query rows, heads and features that meet the block,
    already scaled (fp32); ``k_block`` / ``v_block`` [B', T', K', D'];
    ``k_pos`` [T'] the positions the block's slots hold (-1 = empty).
    The reductions over the ranks that hold the rest come as arguments:
    ``sum_scores(s)`` sums the partial scores over the feature blocks
    (before the softcap and the mask: the softcap is not linear), and
    ``over_slots(x, op)`` reduces ('max' or 'sum') over the blocks of the
    slots, with which the softmax runs in two passes (the global max, then
    the global sum of exps; under ``lowp`` the weights are rounded after
    both, as the whole softmax's are) and the weighted values are summed.
    Where the slots are whole (``over_slots`` None) the softmax is
    ``torch.softmax``, as :func:`decode_attention` takes it, so a block
    that is the whole cache gives its bits.  Returns [B', 1, K', G, D']
    fp32."""
    if lowp:
        qf = qf.to(k_block.dtype).float()
    sc = torch.einsum("bskgd,btkd->bskgt", qf, k_block.float())
    if sum_scores is not None:
        sc = sum_scores(sc)
    if softcap:
        sc = layers.softcap(sc, softcap)
    mask = (k_pos >= 0) & (k_pos <= cur_pos)
    if window:
        mask &= k_pos > cur_pos - window
    sc = torch.where(mask[None, None, None, None, :], sc, NEG_INF)
    if over_slots is None:
        p = torch.softmax(sc, dim=-1)
    else:
        e = torch.exp(sc - over_slots(sc.amax(dim=-1, keepdim=True), "max"))
        p = e / over_slots(e.sum(dim=-1, keepdim=True), "sum")
    if lowp:
        p = p.to(v_block.dtype).float()
    out = torch.einsum("bskgt,btkd->bskgd", p, v_block.float())
    return out if over_slots is None else over_slots(out, "sum")


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
    return cross_attend(q, k, v).reshape(b, s, n_heads * head_dim) \
        @ params["wo"]


def cross_attend(q, k, v):
    """The attention of :func:`cross_attention` on its projected heads: q
    [B,S,H,D] over every image key of k/v [B,T,K,D] -> [B,S,H,D].  H and K
    are whatever heads the caller computes (a rank's under the compute
    split, ``launch/sharding.Split``)."""
    return chunked_attention(q, k, v, causal=False,
                             chunk=min(1024, k.shape[1]))
