"""Decoder LM covering all ten configured architectures, and the paged
serving step.

Port of ``repro/models/transformer.py``.  A model is a repeating *period*
of block kinds (``configs.base.ModelConfig``):

    dense   self-attention (full causal) + SwiGLU MLP
    local   self-attention with sliding window
    global  full self-attention (alias of dense; used in alternating patterns)
    moe     self-attention + mixture-of-experts FFN (optional dense residual;
            ``models/moe.py``)
    mamba   Mamba-2 SSD mixer (no MLP; ``models/ssm.py``)
    cross   gated cross-attention to image embeddings + gated MLP (VLM);
            both gates are 0-d fp32 params through ``tanh``, 0 at init

zamba2's *shared block* is one ``dense``-shaped param set
(``params["shared_attn"]``) applied at the end of every period (never after
the tail layers), with one KV cache per use site stacked over the periods
like the backbone caches (a ring buffer of ``window`` rows when the config
has a window).  ``tail_layers`` extra blocks of kind ``period[0]`` follow
the periods.

Parameters and caches keep the reference's layout -- one entry of
``params["blocks"]`` per period position, each leaf stacked over the periods
-- and the port loops over the periods where the reference scans.  Four
modes: ``train`` (tokens -> logits at every position), ``prefill`` (tokens
-> last logits + KV caches / Mamba states / image K/V), ``decode`` (one
token + caches -> logits) and ``paged`` (a chunk of tokens per serving slot
against the paged KV pool, the continuous-batching serving path: every slot
carries its own absolute position, K/V are written into fixed-size pages
addressed by a per-slot block table, and attention reads the slot's pages
back; attention stacks only, as in the reference: ``dense``, ``local``,
``global`` and ``moe``, where the MoE layer keeps the chunk's padded rows
out of its capacity queues through ``PageInfo.token_mask``).

Where the reference returns new caches (its arrays are immutable; the
engine donates the pools), the port writes the decode caches, the Mamba
decode states and the page pools in place and returns the same tensors.
A ``prefill`` takes each Mamba layer's SSM state from the scan's own
final-state output (the kernel's under ``use_pallas``) and its conv state
from the raw conv input, where the reference recomputes both through a
second jnp pass (its ``_mamba_prefill_state``).

``train_loss`` is the mean token cross-entropy of a ``train`` forward plus
its auxiliary loss (the MoE balance loss, summed over the blocks), the
loss of decentralized LM training; it is a plain function of the params
dict, so the training plugin (``api/models.py``) maps it over the node axis
with ``torch.func.vmap``.

Not ported: the TPU mesh and scan controls (``cache_constraint``,
``act_spec``, ``head_spec``, ``moe_expert_spec``, ``repeat_kv``, ``remat``,
``unroll``, ``skip_masked_chunks``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from ..tree import tree_flatten, tree_map, tree_unflatten
from . import attention, layers, moe, ssm

__all__ = ["ATTN_KINDS", "RunCtx", "PageInfo", "init_lm", "init_cache",
           "init_paged_cache", "supports_paged", "apply_block", "forward",
           "train_loss", "prefill", "decode_step", "paged_step"]

#: the block kinds with a self-attention KV cache, which paged serving
#: takes (``mamba`` keeps an O(1) state, ``cross`` the image's K/V)
ATTN_KINDS = ("dense", "local", "global", "moe")


@dataclasses.dataclass(frozen=True)
class RunCtx:
    cfg: ModelConfig
    mode: str                       # train | prefill | decode | paged
    pos: Any = None                 # decode: 0-d int tensor, current position
    img: Any = None                 # vlm: [B, T_img, d] image embeddings
    chunk: int = 1024               # attention KV-chunk size
    ssd_chunk: int = 128            # Mamba-2 SSD chunk size
    cache_len: int = 0              # prefill: total KV capacity (>= seq len)
    use_pallas: bool = False
    decode_lowp: bool = False       # decode attention: cache-dtype operands
    pages: Any = None               # paged mode: PageInfo


@dataclasses.dataclass(frozen=True)
class PageInfo:
    """Per-call paged-KV addressing, computed once in :func:`paged_step` and
    shared by every attention layer.  Token ``i`` of slot ``b`` sits at
    absolute position ``q_pos[b, i]``.

    The reference scatters with ``mode="drop"`` through an out-of-bounds
    sentinel; an out-of-bounds index is a device fault on CUDA, so the port
    sends the rows it must drop (inactive slots, prompt overhang, pages not
    allocated) to a dump row instead: pool row ``scatter_idx[r]`` receives
    chunk row ``scatter_src[r]`` (of the chunk's ``B*C`` K/V rows followed
    by the pool's row 0).  A dropped row rewrites the first kept row with
    that row's own value, or, when the call keeps no row at all, pool row 0
    with its current value: every write to one row carries the same bits,
    so the scatter is exact, in place and needs no host sync.

    ``gather_idx[b, t]`` maps the slot's logical position ``t`` back to a
    pool row; positions beyond the allocated pages clamp to row 0 and are
    killed by the causal mask (``t`` <= current position implies the row
    was written by this sequence, so slot and page reuse need no zeroing).
    It is None for a kernel decode step, which reads the block table
    itself."""

    q_pos: Any          # [B, C] int32 absolute positions of the chunk
    scatter_idx: Any    # [B*C] int64 pool rows written
    scatter_src: Any    # [B*C] int64 row of (chunk K/V ++ pool row 0)
    gather_idx: Any     # [B, T] int64 pool row per logical position, or None
    last_idx: Any       # [B] chunk index of the last valid token
    block_tables: Any   # [B, P] int32 page ids, -1 = unallocated
    lengths: Any        # [B] int32 slot length AFTER this chunk lands
    token_mask: Any = None  # [B, C] bool, False on padded chunk rows
    use_pallas: bool = False   # decode (C == 1): the paged-decode kernel


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen, kind: str, cfg: ModelConfig, device, dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(device=device, dtype=dtype)
    if kind == "mamba":
        return {"ln": torch.zeros(d, **kw),
                "mixer": ssm.init_mamba(gen, d, cfg.ssm, **kw)}
    if kind == "cross":
        gate = dict(device=device, dtype=torch.float32)
        return {"ln1": torch.zeros(d, **kw),
                "xattn": attention.init_attention(
                    gen, d, cfg.n_heads, cfg.n_kv_heads, hd, **kw),
                "gate_attn": torch.zeros((), **gate),
                "ln2": torch.zeros(d, **kw),
                "mlp": layers.init_mlp(gen, d, cfg.d_ff, **kw),
                "gate_mlp": torch.zeros((), **gate)}
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    p = {"ln1": torch.zeros(d, **kw),
         "attn": attention.init_attention(
             gen, d, cfg.n_heads, cfg.n_kv_heads, hd,
             qkv_bias=cfg.qkv_bias, **kw),
         "ln2": torch.zeros(d, **kw)}
    if kind == "moe":
        p["moe"] = moe.init_moe(gen, d, cfg.d_ff, cfg.moe, **kw)
    else:
        p["mlp"] = layers.init_mlp(gen, d, cfg.d_ff, **kw)
    return p


def init_lm(gen, cfg: ModelConfig, dtype=torch.float32, *,
            device=None) -> dict:
    """Parameters in the reference's structure (``embed``, ``final_norm``,
    ``lm_head`` unless tied, ``blocks`` a tuple over the period of trees
    stacked over ``n_periods``, ``tail`` a tuple, and zamba2's
    ``shared_attn``), drawn from the ``torch.Generator`` ``gen`` on its
    device (``device`` overrides it; ``device="meta"`` with ``gen=None``
    builds the shapes only)."""
    device = torch.device(device if device is not None else gen.device)
    kw = dict(device=device, dtype=dtype)
    vp = cfg.vocab_padded
    params: dict[str, Any] = {
        "embed": layers.embed_init(gen, vp, cfg.d_model, **kw),
        "final_norm": torch.zeros(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, cfg.d_model, vp, **kw)
    params["blocks"] = tuple(
        layers.stack_layers(cfg.n_periods, lambda kind=kind: _init_block(
            gen, kind, cfg, device, dtype))
        for kind in cfg.period)
    params["tail"] = tuple(_init_block(gen, cfg.period[0], cfg, device, dtype)
                           for _ in range(cfg.tail_layers))
    if cfg.shared_attn_every:
        params["shared_attn"] = _init_block(gen, "dense", cfg, device, dtype)
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _attn_cache_len(kind: str, cfg: ModelConfig, cache_len: int) -> int:
    if kind == "local" and cfg.window:
        return min(cfg.window, cache_len)
    return cache_len


def _empty_block_cache(kind, cfg, lead, batch, cache_len, dtype, device):
    if kind == "mamba":
        return ssm.init_mamba_state(batch, cfg.d_model, cfg.ssm, dtype,
                                    device=device, lead=lead)
    hd = cfg.resolved_head_dim
    if kind == "cross":
        shape = (*lead, batch, cfg.n_image_tokens, cfg.n_kv_heads, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    length = _attn_cache_len(kind, cfg, cache_len)
    shape = (*lead, batch, length, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((*lead, length), -1, dtype=torch.int32,
                                   device=device)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.float32, *, device="cuda") -> dict:
    """Dense per-batch KV caches (zero Mamba states for mamba layers, zero
    image K/V for cross layers) for :func:`decode_step`, in
    :func:`prefill`'s structure (each period position stacked over
    ``n_periods``; zamba2's shared block one cache per use site, stacked
    alike)."""
    cache = {"blocks": tuple(
                 _empty_block_cache(kind, cfg, (cfg.n_periods,), batch,
                                    cache_len, dtype, device)
                 for kind in cfg.period),
             "tail": tuple(
                 _empty_block_cache(cfg.period[0], cfg, (), batch, cache_len,
                                    dtype, device)
                 for _ in range(cfg.tail_layers))}
    if cfg.shared_attn_every:
        cache["shared_attn"] = _empty_block_cache(
            _shared_kind(cfg), cfg, (cfg.n_periods,), batch, cache_len,
            dtype, device)
    return cache


def _shared_kind(cfg: ModelConfig) -> str:
    """The shared block attends as a ``local`` layer when the config has a
    window, else as a ``dense`` one."""
    return "local" if cfg.window else "dense"


def supports_paged(cfg: ModelConfig) -> bool:
    """Paged serving covers attention-only stacks (dense/local/global/moe),
    as in the reference."""
    return (all(k in ATTN_KINDS for k in cfg.period)
            and not cfg.shared_attn_every and not cfg.n_image_tokens)


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype=torch.float32, *, device="cuda") -> dict:
    """One K/V page pool ``[n_pages, page_size, K, D]`` per attention
    layer, in :func:`init_cache`'s structure, with no batch axis: slots
    address the shared pool through their block tables."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"{cfg.name}: paged serving supports attention-only stacks "
            f"(period={cfg.period}, shared_attn_every="
            f"{cfg.shared_attn_every}, n_image_tokens={cfg.n_image_tokens})")
    hd = cfg.resolved_head_dim

    def pool(*lead):
        shape = (*lead, n_pages, page_size, cfg.n_kv_heads, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"blocks": tuple(pool(cfg.n_periods) for _ in cfg.period),
            "tail": tuple(pool() for _ in range(cfg.tail_layers))}


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _paged_self_attn(p, x, window: int, ctx: RunCtx, cache):
    """Paged-KV attention for one layer: write the chunk's K/V into the
    layer's page pool (in place), then attend over the slot's pages -- by
    gather, or through the paged-decode kernel for a one-token decode step.
    ``cache`` is ``{"k": [NP, ps, K, D], "v": ...}``, the pool."""
    cfg, pg = ctx.cfg, ctx.pages
    hd = cfg.resolved_head_dim
    b, c, _ = x.shape
    q, k, v = attention.qkv(p, x, cfg.n_heads, cfg.n_kv_heads, hd)
    q = layers.apply_rope(q, pg.q_pos, cfg.rope_theta)
    k = layers.apply_rope(k, pg.q_pos, cfg.rope_theta)
    n_pages, ps, kh, _ = cache["k"].shape
    kf = cache["k"].view(n_pages * ps, kh, hd)
    vf = cache["v"].view(n_pages * ps, kh, hd)
    for pool, new in ((kf, k), (vf, v)):
        rows = torch.cat([new.reshape(b * c, kh, hd).to(pool.dtype),
                          pool[:1]])
        pool[pg.scatter_idx] = rows[pg.scatter_src]
    if pg.use_pallas and c == 1:
        out = kops.paged_decode_attention(
            q, cache["k"], cache["v"], pg.block_tables, pg.lengths,
            window=window, softcap=cfg.attn_softcap)
    else:
        out = attention.paged_attention(q, kf[pg.gather_idx],
                                        vf[pg.gather_idx], pg.q_pos,
                                        window=window,
                                        softcap=cfg.attn_softcap)
    out = out.reshape(b, c, cfg.n_heads * hd)
    return out @ p["wo"], cache


def _prefill_cache(k, v, kind, ctx: RunCtx):
    cfg = ctx.cfg
    s = k.shape[1]
    length = _attn_cache_len(kind, cfg, max(ctx.cache_len, s))
    if length >= s:  # pad; position p sits at slot p % length == p
        pad = length - s
        kc = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        vc = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        slot_pos = torch.cat([
            torch.arange(s, dtype=torch.int32, device=k.device),
            torch.full((pad,), -1, dtype=torch.int32, device=k.device)])
    else:  # ring buffer: keep the last `length`, slot = pos % length
        positions = torch.arange(s - length, s, dtype=torch.int32,
                                 device=k.device)
        shift = int((s - length) % length)
        kc = torch.roll(k[:, s - length:], shift, dims=1)
        vc = torch.roll(v[:, s - length:], shift, dims=1)
        slot_pos = torch.roll(positions, shift)
    return {"k": kc, "v": vc, "slot_pos": slot_pos}


def _self_attn(p, x, kind: str, ctx: RunCtx, cache):
    cfg = ctx.cfg
    hd = cfg.resolved_head_dim
    window = cfg.window if kind == "local" else 0
    if ctx.mode == "paged":
        return _paged_self_attn(p, x, window, ctx, cache)
    b, s, _ = x.shape
    q, k, v = attention.qkv(p, x, cfg.n_heads, cfg.n_kv_heads, hd)
    new_cache = None
    if ctx.mode == "decode":
        pos = ctx.pos + torch.zeros((b, 1), dtype=torch.int32,
                                    device=x.device)
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
        slot = (ctx.pos % cache["k"].shape[1]).reshape(1).long()
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        cache["slot_pos"].index_copy_(0, slot, ctx.pos.reshape(1).to(
            torch.int32))
        out = attention.decode_attention(
            q, cache["k"], cache["v"], ctx.pos, window=window,
            softcap=cfg.attn_softcap, k_pos=cache["slot_pos"],
            lowp=ctx.decode_lowp)
        new_cache = cache
    else:
        pos = torch.arange(s, device=x.device)[None, :]
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
        if ctx.use_pallas:
            out = kops.flash_attention(q, k, v, causal=True, window=window,
                                       softcap=cfg.attn_softcap)
        else:
            out = attention.chunked_attention(
                q, k, v, causal=True, window=window,
                softcap=cfg.attn_softcap, chunk=ctx.chunk)
        if ctx.mode == "prefill":
            new_cache = _prefill_cache(k, v, kind, ctx)
    out = out.reshape(out.shape[0], out.shape[1], cfg.n_heads * hd)
    return out @ p["wo"], new_cache


def _cross_block(p, x, ctx: RunCtx, cache):
    """Gated cross-attention to the image embeddings, then the gated MLP.
    Prefill keeps the image's K/V as the block's cache; a decode step's
    query attends every image key of that cache (no positions: the image
    sits wholly before the text)."""
    cfg = ctx.cfg
    hd = cfg.resolved_head_dim
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    new_cache = None
    if ctx.mode == "decode":
        b = x.shape[0]
        q = attention._proj(h, p["xattn"]["wq"]).reshape(b, 1, cfg.n_heads,
                                                         hd)
        out = attention.decode_attention(q, cache["k"], cache["v"],
                                         cache["k"].shape[1] - 1)
        out = out.reshape(b, 1, cfg.n_heads * hd) @ p["xattn"]["wo"]
        new_cache = cache
    else:
        if ctx.img is None:
            raise ValueError(f"{cfg.name}: a cross block needs the image "
                             f"embeddings (img [B, {cfg.n_image_tokens}, "
                             f"{cfg.d_model}])")
        out = attention.cross_attention(p["xattn"], h, ctx.img, cfg.n_heads,
                                        cfg.n_kv_heads, hd)
        if ctx.mode == "prefill":
            b, t, _ = ctx.img.shape
            new_cache = {
                "k": attention._proj(ctx.img, p["xattn"]["wk"]).reshape(
                    b, t, cfg.n_kv_heads, hd),
                "v": attention._proj(ctx.img, p["xattn"]["wv"]).reshape(
                    b, t, cfg.n_kv_heads, hd)}
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * out
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    m = layers.swiglu(h, p["mlp"]["gate"], p["mlp"]["up"], p["mlp"]["down"])
    return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * m, new_cache


def apply_block(kind: str, p, x, ctx: RunCtx, cache):
    """One block; returns ``(x, aux_loss, new_cache)`` as the reference.
    ``aux_loss`` is the MoE balance loss (a 0-d tensor) for ``moe`` and
    0.0 for every other kind."""
    cfg = ctx.cfg
    if ctx.mode == "paged" and kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"paged serving supports attention-only stacks; block kind "
            f"{kind!r} (mamba/cross state caches are per-slot, not paged)")
    if kind == "mamba":
        h = layers.rms_norm(x, p["ln"], cfg.norm_eps)
        if ctx.mode == "decode":
            out, new_cache = ssm.mamba_decode(p["mixer"], h, cache, cfg.ssm)
        elif ctx.mode == "prefill":
            out, new_cache = ssm.mamba_prefill(p["mixer"], h, cfg.ssm,
                                               chunk=ctx.ssd_chunk,
                                               use_pallas=ctx.use_pallas)
        else:
            out = ssm.mamba_mixer(p["mixer"], h, cfg.ssm, chunk=ctx.ssd_chunk,
                                  use_pallas=ctx.use_pallas)
            new_cache = cache
        return x + out, 0.0, new_cache
    if kind == "cross":
        x, new_cache = _cross_block(p, x, ctx, cache)
        return x, 0.0, new_cache
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    out, new_cache = _self_attn(p["attn"], h, kind, ctx, cache)
    x = x + out
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind == "moe":
        # a paged chunk's rows past each slot's n_valid are junk: keep them
        # out of the capacity queues
        tm = ctx.pages.token_mask if ctx.mode == "paged" else None
        y, aux = moe.moe_ffn(p["moe"], h, cfg.moe, token_mask=tm)
        return x + y, aux, new_cache
    y = layers.swiglu(h, p["mlp"]["gate"], p["mlp"]["up"], p["mlp"]["down"])
    return x + y, 0.0, new_cache


def _shared_attn_block(p, x, ctx: RunCtx, cache):
    """zamba2's shared block: one param set, applied at the end of every
    period with that use site's KV cache."""
    cfg = ctx.cfg
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    out, new_cache = _self_attn(p["attn"], h, _shared_kind(cfg), ctx, cache)
    x = x + out
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.swiglu(h, p["mlp"]["gate"], p["mlp"]["up"],
                             p["mlp"]["down"]), new_cache


# ---------------------------------------------------------------------------
# full model passes
# ---------------------------------------------------------------------------

def _embed(params, tokens, cfg):
    return params["embed"][tokens]


def _logits(params, x, cfg: ModelConfig):
    h = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return layers.softcap((h @ head).float(), cfg.logit_softcap)


def _unstack(tree, n: int) -> list:
    """A tree of leaves stacked ``[n, ...]`` -> its ``n`` entries, views
    from one ``unbind`` a leaf.  Under autograd the backward of an unbind
    is one stack, where indexing each period apart would give every
    leaf's gradient a zero-filled full-size tensor a period to add up."""
    leaves, treedef = tree_flatten(tree)
    parts = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [p[i] for p in parts]) for i in range(n)]


def forward(params, tokens, cfg: ModelConfig, *, mode: str, img=None,
            cache=None, pos=None, chunk: int = 1024, ssd_chunk: int = 128,
            cache_len: int = 0, use_pallas: bool = False,
            decode_lowp: bool = False, pages=None):
    """The shared forward pass.  Returns ``(logits, aux_loss, new_cache)``;
    ``img`` [B, T_img, d] feeds the cross blocks (train and prefill).

    train:   tokens [B,S] -> logits [B,S,Vp], aux, None
    prefill: tokens [B,S] -> logits [B,Vp] (last pos), aux, cache
    decode:  tokens [B,1] -> logits [B,Vp], aux, cache (written in place)
    paged:   tokens [B,C] -> logits [B,Vp] (per-slot last valid), aux, pages
             (written in place)
    """
    if mode not in ("train", "prefill", "decode", "paged"):
        raise ValueError(f"unknown forward mode {mode!r}")
    ctx = RunCtx(cfg=cfg, mode=mode, pos=pos, img=img, chunk=chunk,
                 ssd_chunk=ssd_chunk, cache_len=cache_len,
                 use_pallas=use_pallas, decode_lowp=decode_lowp, pages=pages)
    x = _embed(params, tokens, cfg)
    reads_cache = mode in ("decode", "paged")
    shared_p = params.get("shared_attn")
    made = [[] for _ in cfg.period]
    made_shared = []
    auxes = []
    periods = [_unstack(bp, cfg.n_periods) for bp in params["blocks"]]
    for i in range(cfg.n_periods):
        for j, kind in enumerate(cfg.period):
            # period i of the stacked params and caches, as views
            c = (tree_map(lambda t: t[i], cache["blocks"][j]) if reads_cache
                 else None)
            x, aux, nc = apply_block(kind, periods[j][i], x, ctx, c)
            made[j].append(nc)
            if kind == "moe":
                auxes.append(aux)
        if shared_p is not None:
            c = (tree_map(lambda t: t[i], cache["shared_attn"])
                 if reads_cache else None)
            x, nc = _shared_attn_block(shared_p, x, ctx, c)
            made_shared.append(nc)
    tail_caches = []
    for i, tp in enumerate(params["tail"]):
        c = cache["tail"][i] if reads_cache else None
        x, aux, nc = apply_block(cfg.period[0], tp, x, ctx, c)
        tail_caches.append(nc)
        if cfg.period[0] == "moe":
            auxes.append(aux)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for aux in auxes:
        aux_total = aux_total + aux

    if mode == "train":
        return _logits(params, x, cfg), aux_total, None
    if mode == "prefill":
        def stack(m):
            return tree_map(lambda *ls: torch.stack(ls), *m)
        new_cache = {"blocks": tuple(stack(m) for m in made),
                     "tail": tuple(tail_caches)}
        if shared_p is not None:
            new_cache["shared_attn"] = stack(made_shared)
        return _logits(params, x[:, -1], cfg), aux_total, new_cache
    if mode == "paged":
        x_last = x[torch.arange(x.shape[0], device=x.device), pages.last_idx]
        return _logits(params, x_last, cfg), aux_total, cache
    return _logits(params, x[:, 0], cfg), aux_total, cache


def train_loss(params, batch, cfg: ModelConfig, **kw):
    """batch: ``{tokens [B,S], labels [B,S], (image_embeds [B,T,d])}`` ->
    0-d loss: the mean token cross-entropy over the valid vocab, plus the
    auxiliary loss."""
    logits, aux, _ = forward(params, batch["tokens"], cfg, mode="train",
                             img=batch.get("image_embeds"), **kw)
    return layers.cross_entropy(logits, batch["labels"],
                                cfg.vocab_size) + aux


def prefill(params, tokens, cfg: ModelConfig, *, img=None, **kw):
    logits, _, cache = forward(params, tokens, cfg, mode="prefill", img=img,
                               **kw)
    return logits, cache


def decode_step(params, token, pos, cache, cfg: ModelConfig, **kw):
    """token [B,1] int, ``pos`` the position (int or 0-d int tensor), cache
    from :func:`init_cache`/:func:`prefill`, updated in place."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
    logits, _, new_cache = forward(params, token, cfg, mode="decode",
                                   cache=cache, pos=pos, **kw)
    return logits, new_cache


# ---------------------------------------------------------------------------
# paged serving (continuous batching)
# ---------------------------------------------------------------------------

def paged_step(params, tokens, pos, n_valid, block_tables, pages,
               cfg: ModelConfig, *, page_size: int,
               use_pallas: bool = False):
    """One serving step: each slot consumes a chunk of C tokens at its own
    absolute position.  C == 1 is batched decode; C == prefill_chunk is one
    chunked-prefill slice.  Slot liveness is data (``n_valid == 0`` masks a
    row), so admission and eviction change no shape.

    tokens        [B, C] int (junk beyond ``n_valid`` is masked)
    pos           [B]    int32 start position of the chunk per slot
    n_valid       [B]    int32 valid tokens in the chunk (0 = inactive slot)
    block_tables  [B, P] int32 page ids, -1 = unallocated
    pages         from :func:`init_paged_cache`, written in place

    Returns ``(logits [B, Vp] at each slot's last valid token, pages)``.
    No host sync: every index is computed on the tensors' device.
    """
    dev = tokens.device
    b, c = tokens.shape
    p_max = block_tables.shape[1]
    n_pages = pages["blocks"][0]["k"].shape[-4] if pages["blocks"] else \
        pages["tail"][0]["k"].shape[-4]
    pos = pos.to(torch.int32)
    n_valid = n_valid.to(torch.int32)
    block_tables = block_tables.to(torch.int32)

    ar = torch.arange(c, dtype=torch.int32, device=dev)
    q_pos = pos[:, None] + ar[None, :]
    token_mask = ar[None, :] < n_valid[:, None]
    page_slot = torch.clamp(q_pos // page_size, 0, p_max - 1)
    page_of = torch.gather(block_tables, 1, page_slot.long())
    flat = (page_of * page_size + q_pos % page_size).reshape(b * c).long()
    keep = (token_mask & (page_of >= 0) & (page_of < n_pages)).reshape(b * c)
    # dropped rows rewrite the first kept row with its own value, or pool
    # row 0 with its current value (source row b*c) when none is kept
    # index_select with a [1] index: a 0-d tensor index is read on the host
    first = keep.to(torch.int32).argmax().reshape(1)
    any_kept = keep.any()
    dump_row = torch.where(any_kept, flat.index_select(0, first), 0)
    dump_src = torch.where(any_kept, first, b * c)
    scatter_idx = torch.where(keep, flat, dump_row)
    scatter_src = torch.where(keep, torch.arange(b * c, device=dev),
                              dump_src)
    gather_idx = None
    kernel_decode = use_pallas and c == 1
    if not kernel_decode:
        t_idx = torch.arange(p_max * page_size, device=dev)
        gather_pages = block_tables[:, t_idx // page_size].long()
        gather_idx = torch.clamp(gather_pages * page_size + t_idx % page_size,
                                 0, n_pages * page_size - 1)
    pi = PageInfo(q_pos=q_pos, scatter_idx=scatter_idx,
                  scatter_src=scatter_src, gather_idx=gather_idx,
                  last_idx=torch.clamp_min(n_valid - 1, 0).long(),
                  block_tables=block_tables.contiguous(),
                  lengths=pos + n_valid, token_mask=token_mask,
                  use_pallas=use_pallas)
    logits, _, pages = forward(params, tokens, cfg, mode="paged",
                               cache=pages, pages=pi)
    return logits, pages
