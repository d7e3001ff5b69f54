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

``remat="full"`` recomputes each period of a ``train`` forward in the
backward (``_PeriodRemat``, a ``torch.autograd.Function`` that
``torch.func.vmap`` composes with), as the reference
checkpoints its scan body; the tail layers keep their activations, as the
reference's do.  ``skip_masked_chunks`` and ``remat_attention`` reach the
plain attention as in the reference (``attention.chunked_attention``).

A ``placement`` (``launch/sharding.Placement``) runs the forward on a
rank's blocks of the params and caches: each block's params are gathered
just before the block uses them (inside ``_PeriodRemat``, so its backward
gathers them again), a decode step gathers each layer's cache and puts the
rank's block back after writing it, and a prefill keeps the rank's block
of each new cache.  With ``pin_cache`` (the reference's
``pin_decode_cache``) a decode step computes on the rank's cache blocks
instead and gathers no cache leaf: each self-attention writes the new
token's K/V into its block (where it holds the slot) and attends over it
(``_attend_blocks``: partial scores summed over the feature blocks, a
softmax across the slot blocks, the outputs all-gathered), a cross block
attends over its block of the image K/V, and a mamba block updates its
blocks of the conv and SSM states (``ssm.mamba_decode(blocks=)``).

A ``split`` (``launch/sharding.Split``, on that placement; train, prefill
and decode) is the reference's ``head_spec`` / ``act_spec`` /
``moe_expert_spec`` as explicit collectives over 'model': each rank
computes its heads (K/V repeated to the head count, ``wo`` row-parallel),
keeps its features of the residual stream between blocks (the norms'
sums of squares all-reduced, the MLP column- then row-parallel, the
embedding, head and loss by vocabulary blocks) and runs its experts, with
the leaves it computes with used as the rank's blocks; a cross block
splits as a self-attention block, and a mamba block its SSM heads
(``ssm.mamba_mixer(split=)``).  A decode step takes q, K and V whole
from their column-parallel products, attends over its cache (whole, or
the rank's blocks when pinned) and enters ``wo`` row-parallel with the
whole output; a cross block's decode takes its q and ``wo`` so, over the
image K/V in its cache, and its MLP as any MLP under the split; a mamba
block's decode makes the one-token projection whole from ``in_proj``'s
stored 'model' block, convolves its conv cache's channels (with
``conv_w``'s block where 'model' stores it alike) and enters ``out_proj``
by the split's rule (``ssm.mamba_decode(split=)``).  ``repeat_kv``
reaches the plain attention as in the reference.  Not ported: the XLA
control ``unroll`` (``launch/steps.py`` states what it does).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from ..tree import tree_flatten, tree_map, tree_unflatten
from . import attention, layers, moe, ssm

__all__ = ["ATTN_KINDS", "REMAT_MODES", "RunCtx", "PageInfo", "init_lm",
           "init_cache", "init_paged_cache", "supports_paged", "apply_block",
           "forward", "train_loss", "prefill", "decode_step", "paged_step"]

#: ``forward(remat=)``: ``"full"`` recomputes each period of a ``train``
#: forward in its backward (the reference's ``jax.checkpoint`` of the scan
#: body), ``"none"`` keeps every activation; the values are the same
REMAT_MODES = ("none", "full")

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
    skip_masked_chunks: bool = False  # windowed attention by query chunks
    remat_attention: bool = False   # recompute attention chunks in backward
    repeat_kv: bool = False         # GQA: repeat K/V to the head count
    placement: Any = None           # launch/sharding.Placement: gather on use
    split: Any = None               # launch/sharding.Split: not paged
    pin_cache: bool = False         # decode: compute on the cache blocks
    rows: Any = None                # launch/sharding.Rows: the rank's rows


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


def _residual(ctx: RunCtx) -> str:
    """The residual stream's state between blocks: ``"R"`` (whole) unless
    a split keeps the rank's features (``launch/sharding.Split``)."""
    return "R" if ctx.split is None else ctx.split.residual


def _linear(ctx: RunCtx, x, state: str, w, key, inputs=None):
    """``x @ w`` for ``x`` in ``state``: ``(y, y's state)``.  The plain
    product without a split; under one, by the split's rule for the leaf at
    ``key`` (``Split.linear``: column- or row-parallel on the rank's block,
    or whole).  ``inputs`` shares the moved ``x`` between products."""
    if ctx.split is None:
        return x @ w, "R"
    return ctx.split.linear(x, state, w, key, inputs)


def _to(ctx: RunCtx, x, state: str, want: str):
    """``x`` from ``state`` to ``want`` under a split (``Split.to``); the
    identity without one."""
    return x if ctx.split is None else ctx.split.to(x, state, want)


def _norm(ctx: RunCtx, x, w):
    """``layers.rms_norm`` of the residual in its state (under a split of
    the features, the sum of squares all-reduced over 'model')."""
    if ctx.split is None:
        return layers.rms_norm(x, w, ctx.cfg.norm_eps)
    return ctx.split.rms_norm(x, w, ctx.cfg.norm_eps)


def _write_slot(leaf, new, block, dim: int, slot) -> None:
    """Write ``new`` (one row along the leaf's ``dim``, counted from the
    end) at the cache's ``slot`` (a [1] index), in place: into the rank's
    block where it holds that slot (``block``, a ``CacheBlock``; a rank
    that does not rewrites a row with its own value, so no host reads
    the position)."""
    at = leaf.dim() + dim
    if block is None or block.parts(dim) == 1:
        leaf.index_copy_(at, slot, new)
        return
    n = leaf.shape[dim]
    local = slot - block.start(dim, n)
    held = ((local >= 0) & (local < n)).reshape(())
    local = local.clamp(0, n - 1)
    leaf.index_copy_(at, local, torch.where(held, new,
                                            leaf.index_select(at, local)))


def _slot_positions(cache, blocks, pos, length: int):
    """The positions the slots of the rank's K block hold: read from its
    block of ``slot_pos`` where that block holds those slots, else derived
    from ``pos`` by the slot rule (a prefill puts position p at slot ``p %
    length``, ring buffers included, and each decode step the next
    position): slot t holds the last position <= ``pos`` at t, -1 where
    that is negative."""
    bk, bp = blocks["k"], blocks["slot_pos"]
    nt, ns = cache["k"].shape[-3], cache["slot_pos"].shape[-1]
    t0, s0 = bk.start(-3, nt), bp.start(-1, ns)
    if s0 <= t0 and t0 + nt <= s0 + ns:
        return cache["slot_pos"].narrow(-1, t0 - s0, nt)
    t = torch.arange(t0, t0 + nt, dtype=torch.int32, device=pos.device)
    held = pos - (pos - t) % length
    return torch.where(held >= 0, held, -1)


def _attend_blocks(q, cache, blocks, cur_pos, k_pos, *, window: int = 0,
                   softcap: float = 0.0, lowp: bool = False):
    """Decode attention of the whole query ``q`` [B, 1, H, D] over the
    rank's blocks of a layer's K/V (``blocks`` their ``CacheBlock``s; the
    pinned decode): the queries cut to the rows, K/V heads (with their G
    query heads) and features the block holds, the partial scores summed
    over the ranks that split the features, the softmax across the ranks
    that split the slots, and the outputs all-gathered back to [B, 1, H,
    D]."""
    bk = blocks["k"]
    b, _, h, hd = q.shape
    kh = cache["k"].shape[-2] * bk.parts(-2)
    qf = q.reshape(b, 1, kh, h // kh, hd).float() * attention.attn_scale(hd)
    qf = bk.cut(bk.cut(bk.cut(qf, -4, 0), -2, -3), -1)
    out = attention.decode_attention_block(
        qf, cache["k"], cache["v"], cur_pos, k_pos, window=window,
        softcap=softcap, lowp=lowp,
        sum_scores=(lambda s: bk.reduce(s, -1)) if bk.axes(-1) else None,
        over_slots=((lambda t, op: bk.reduce(t, -3, op))
                    if bk.parts(-3) > 1 else None))
    out = bk.join(bk.join(bk.join(out.to(q.dtype), -1), -2, -3), -4, 0)
    return out.reshape(b, 1, h, hd)


def _decode_self_attn(q, k, v, cache, window: int, ctx: RunCtx, key):
    """One decode step of a self-attention layer on its cache, written in
    place: ``q`` [B, 1, H, D], the new ``k`` / ``v`` [B, 1, K, D] (after
    RoPE).  Pinned (``ctx.pin_cache``), ``cache`` is the rank's blocks:
    the new token's K/V cut to the block and written where the rank holds
    its slot, then :func:`_attend_blocks`."""
    cfg = ctx.cfg
    blocks = ctx.placement.cache_blocks(*key) if ctx.pin_cache else None
    bk = blocks["k"] if blocks else None
    length = cache["k"].shape[1] * (bk.parts(-3) if bk else 1)
    slot = (ctx.pos % length).reshape(1).long()
    for name, new in (("k", k), ("v", v)):
        if blocks:
            bn = blocks[name]
            new = bn.cut(bn.cut(bn.cut(new, -4), -2), -1)
        _write_slot(cache[name], new.to(cache[name].dtype),
                    blocks[name] if blocks else None, -3, slot)
    _write_slot(cache["slot_pos"], ctx.pos.reshape(1).to(torch.int32),
                blocks["slot_pos"] if blocks else None, -1, slot)
    if blocks is None:
        return attention.decode_attention(
            q, cache["k"], cache["v"], ctx.pos, window=window,
            softcap=cfg.attn_softcap, k_pos=cache["slot_pos"],
            lowp=ctx.decode_lowp)
    return _attend_blocks(q, cache, blocks, ctx.pos,
                          _slot_positions(cache, blocks, ctx.pos, length),
                          window=window, softcap=cfg.attn_softcap,
                          lowp=ctx.decode_lowp)


def _heads_split(ctx: RunCtx):
    """The split when it computes the rank's attention heads, else None."""
    return ctx.split if ctx.split is not None and ctx.split.heads else None


def _head_proj(ctx: RunCtx, p, name: str, x, state: str, key, inputs,
               *, whole: bool = False):
    """``x @ p[name] + bias`` of ``x`` in ``state`` as [B, S, heads, D]:
    under the heads split the rank's query heads (``Split.to_heads``: its
    range of them, possibly none), or with ``whole`` all of them for the
    rank's own use; ``inputs`` shares the moved ``x`` between the products
    that read it (``_linear``).  A bias that 'model' stores by blocks is
    added in the block's state, one gathered whole through *f*."""
    sp = _heads_split(ctx)
    hd = ctx.cfg.resolved_head_dim
    y, st = _linear(ctx, x, state, p[name], key + (name,), inputs)
    bname = "b" + name[1]
    bias = p.get(bname)
    if sp is None:
        if bias is not None:
            y = y + bias.to(y.dtype)
    elif not whole:
        y = sp.to_heads(y, st, hd)
        if bias is not None:
            stored = "S" if sp.model_dim(key + (bname,)) == -1 else "R"
            y = y + sp.to_heads(bias, stored, hd).to(y.dtype)
    else:
        if bias is not None and sp.model_dim(key + (bname,)) == -1:
            y, st = sp.to(y, st, "S") + bias.to(y.dtype), "S"
            bias = None
        y = sp.enter(y, st)
        if bias is not None:
            y = y + sp.copy(bias).to(y.dtype)
    return y.reshape(x.shape[0], x.shape[1], y.shape[-1] // hd, hd)


def _heads_out(ctx: RunCtx, out, p, key, *, whole: bool):
    """``wo`` of an attention's output ``out`` [B, S, heads, D] (the rank's
    heads under the heads split, all of them with ``whole``):
    ``(y, state)`` by the split's rule (``Split.linear_heads``)."""
    sp = _heads_split(ctx)
    b, s, h, hd = out.shape
    out = out.reshape(b, s, h * hd)
    if sp is None or whole:
        return _linear(ctx, out, "R", p["wo"], key + ("wo",))
    return sp.linear_heads(out, p["wo"], key + ("wo",), hd)


def _self_attn(p, x, kind: str, ctx: RunCtx, cache, key=()):
    """Self-attention of the normed ``x`` (in the residual's state):
    ``(out in that state, new cache)``.  Under a split with ``heads`` each
    rank computes its heads (``Split.head_range``: ``H / M``, or GSPMD's
    ``ceil(H / M)`` from rank 0 on, possibly none): q by the split's rule
    (``Split.to_heads``), K/V whole for the rank's own use (a prefill's
    cache is whole), then repeated to H heads and cut to the rank's; ``wo``
    takes the output back by the split's rule (``Split.linear_heads``).  A
    decode step takes q, K and V column-parallel and whole for its cache
    (whole, or the rank's blocks when pinned), and its output whole into
    the row-parallel ``wo``.  Under a split without ``heads`` every
    product is whole on every rank."""
    cfg = ctx.cfg
    hd = cfg.resolved_head_dim
    window = cfg.window if kind == "local" else 0
    if ctx.mode == "paged":
        return _paged_self_attn(p, x, window, ctx, cache)
    b, s = x.shape[0], x.shape[1]
    sp = _heads_split(ctx)
    xs, inputs = _residual(ctx), {}
    decode = ctx.mode == "decode"
    q, k, v = (_head_proj(ctx, p, name, x, xs, key, inputs, whole=whole)
               for name, whole in (("wq", decode), ("wk", True),
                                   ("wv", True)))
    new_cache = None
    if decode:
        pos = ctx.pos + torch.zeros((b, 1), dtype=torch.int32,
                                    device=x.device)
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
        out = _decode_self_attn(q, k, v, cache, window, ctx, key[:-1])
        new_cache = cache
    else:
        pos = torch.arange(s, device=x.device)[None, :]
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
        kv = (k, v)                 # a prefill's cache holds every head
        if sp is not None:
            g = cfg.n_heads // cfg.n_kv_heads
            k, v = (sp.head_block(t.repeat_interleave(g, dim=2), dim=-2)
                    for t in (k, v))
        if ctx.use_pallas and q.shape[2]:
            out = kops.flash_attention(q, k, v, causal=True, window=window,
                                       softcap=cfg.attn_softcap)
        else:
            out = attention.chunked_attention(
                q, k, v, causal=True, window=window,
                softcap=cfg.attn_softcap, chunk=ctx.chunk,
                skip_masked_chunks=ctx.skip_masked_chunks,
                remat_chunks=ctx.remat_attention, repeat_kv=ctx.repeat_kv)
        if ctx.mode == "prefill":
            new_cache = _prefill_cache(*kv, kind, ctx)
    out, state = _heads_out(ctx, out, p, key, whole=decode)
    return _to(ctx, out, state, xs), new_cache


def _mlp(p, h, ctx: RunCtx, key):
    """``layers.swiglu`` of the normed ``h`` (in the residual's state).
    Under a split of the features: the features gathered, ``gate`` /
    ``up`` column-parallel and ``down`` row-parallel, reduce-scattered back
    onto the features."""
    xs, inputs = _residual(ctx), {}
    g, state = _linear(ctx, h, xs, p["gate"], key + ("gate",), inputs)
    u, _ = _linear(ctx, h, xs, p["up"], key + ("up",), inputs)
    if state == "P":
        g, u, state = ctx.split.all_reduce(g), ctx.split.all_reduce(u), "R"
    y, state = _linear(ctx, torch.nn.functional.silu(g) * u, state,
                       p["down"], key + ("down",))
    return _to(ctx, y, state, xs)


def _moe(p, h, ctx: RunCtx, key):
    """The MoE FFN of the normed ``h`` (in the residual's state).  Under a
    split whose experts are the rank's ``E / M`` (``pin_moe_dispatch``),
    each rank runs them on all the routed tokens of its batch (the routes
    and the capacity are the unsplit ones; under ``ctx.rows`` its rows',
    in the node's queue) and the partial sums are reduced over 'model';
    under any split the dense residual branch takes :func:`_mlp`'s routes
    (without one it runs inside ``moe_ffn``)."""
    mcfg, sp = ctx.cfg.moe, ctx.split
    xs = _residual(ctx)
    experts = sp is not None and sp.model_dim(key + ("w_gate",)) == -3
    # a paged chunk's rows past each slot's n_valid are junk: keep them
    # out of the capacity queues
    tm = ctx.pages.token_mask if ctx.mode == "paged" else None
    y, aux = moe.moe_ffn(
        p, _to(ctx, h, xs, "R"),
        mcfg if sp is None else dataclasses.replace(mcfg, dense_ff=0),
        token_mask=tm, split=sp if experts else None, rows=ctx.rows)
    y = _to(ctx, y, "P" if experts else "R", xs)
    if sp is not None and mcfg.dense_ff:
        y = y + _mlp(p["dense"], h, ctx, key + ("dense",))
    return y, aux


def _gate(ctx: RunCtx, gate, state: str):
    """``tanh`` of a 0-d fp32 gate for a branch in ``state``: through *f*
    where each rank scales its own features, so the gate's gradient is
    summed over 'model'."""
    g = torch.tanh(gate)
    return ctx.split.copy(g) if state == "S" else g


def _cross_attn(p, h, ctx: RunCtx, key):
    """The cross-attention of the normed text ``h`` (in the residual's
    state) to the whole image ``ctx.img``: ``(out in that state, the
    image's K/V)``.  Under the heads split each rank computes its query
    heads as a self-attention does (``Split.head_range``) and takes K/V
    whole from their products for its own use (the prefill's cache is
    whole), cut to the K/V heads its queries read where both head counts
    divide, else repeated to H heads and cut to the rank's; ``wo`` as a
    self-attention's."""
    cfg = ctx.cfg
    sp = _heads_split(ctx)
    xs, inputs = _residual(ctx), {}
    q = _head_proj(ctx, p, "wq", h, xs, key, {})
    k, v = (_head_proj(ctx, p, name, ctx.img, "R", key, inputs, whole=True)
            for name in ("wk", "wv"))
    kv = {"k": k, "v": v}
    if sp is not None:
        n = k.shape[2]
        if cfg.n_heads % sp.size or n % sp.size:
            k, v = (t.repeat_interleave(cfg.n_heads // n, dim=2)
                    for t in (k, v))
            n = cfg.n_heads
        k, v = sp.head_block(k, n, -2), sp.head_block(v, n, -2)
    out, state = _heads_out(ctx, attention.cross_attend(q, k, v), p, key,
                            whole=False)
    return _to(ctx, out, state, xs), kv


def _cross_block(p, x, ctx: RunCtx, cache, key=()):
    """Gated cross-attention to the image embeddings, then the gated MLP,
    on ``x`` in the residual's state (a split takes the heads, the norms
    and the MLP as a self-attention block's; ``_gate``).  Prefill keeps
    the image's K/V as the block's cache; a decode step's query attends
    every image key of that cache (no positions: the image sits wholly
    before the text), pinned over the rank's block of it
    (:func:`_attend_blocks`; nothing is written)."""
    cfg = ctx.cfg
    hd = cfg.resolved_head_dim
    xs = _residual(ctx)
    h = _norm(ctx, x, p["ln1"])
    new_cache = None
    if ctx.mode == "decode":
        b = x.shape[0]
        q = _head_proj(ctx, p["xattn"], "wq", h, xs, key + ("xattn",), {},
                       whole=True)
        if ctx.pin_cache:
            blocks = ctx.placement.cache_blocks(*key)
            nt = cache["k"].shape[1]
            t0 = blocks["k"].start(-3, nt)
            out = _attend_blocks(
                q, cache, blocks, nt * blocks["k"].parts(-3) - 1,
                torch.arange(t0, t0 + nt, device=x.device))
        else:
            out = attention.decode_attention(q, cache["k"], cache["v"],
                                             cache["k"].shape[1] - 1)
        out, state = _linear(ctx, out.reshape(b, 1, cfg.n_heads * hd), "R",
                             p["xattn"]["wo"], key + ("xattn", "wo"))
        out = _to(ctx, out, state, xs)
        new_cache = cache
    else:
        if ctx.img is None:
            raise ValueError(f"{cfg.name}: a cross block needs the image "
                             f"embeddings (img [B, {cfg.n_image_tokens}, "
                             f"{cfg.d_model}])")
        out, kv = _cross_attn(p["xattn"], h, ctx, key + ("xattn",))
        if ctx.mode == "prefill":
            new_cache = kv
    x = x + _gate(ctx, p["gate_attn"], xs).to(x.dtype) * out
    h = _norm(ctx, x, p["ln2"])
    m = _mlp(p["mlp"], h, ctx, key + ("mlp",))
    return x + _gate(ctx, p["gate_mlp"], xs).to(x.dtype) * m, new_cache


def _mamba_block(p, x, ctx: RunCtx, cache, key=()):
    """The Mamba-2 mixer with its residual, on ``x`` in the residual's
    state: ``(x, new cache)``.  Under a split the norm takes the rank's
    features and, where ``split.ssm``, the mixer its ``nh / M`` heads
    (``ssm.mamba_mixer(split=)``) or, in a decode step, its projections on
    the rank's weight blocks (``ssm.mamba_decode(split=)``); else the mixer
    runs whole.  A pinned decode step runs on the rank's blocks of the
    states."""
    h = _norm(ctx, x, p["ln"])
    xs = _residual(ctx)
    sp = ctx.split if ctx.split is not None and ctx.split.ssm else None
    if sp is None:
        h = _to(ctx, h, xs, "R")
    state = xs if sp is not None else "R"
    new_cache = cache
    if ctx.mode == "decode":
        out, new_cache = ssm.mamba_decode(
            p["mixer"], h, cache, ctx.cfg.ssm,
            blocks=ctx.placement.cache_blocks(*key) if ctx.pin_cache
            else None, split=sp, residual=state, key=key + ("mixer",))
    else:
        kw = dict(chunk=ctx.ssd_chunk, use_pallas=ctx.use_pallas, split=sp,
                  state=state, key=key + ("mixer",))
        if ctx.mode == "prefill":
            out, new_cache = ssm.mamba_prefill(p["mixer"], h, ctx.cfg.ssm,
                                               **kw)
        else:
            out = ssm.mamba_mixer(p["mixer"], h, ctx.cfg.ssm, **kw)
    if sp is None:
        out = _to(ctx, out, "R", xs)
    return x + out, new_cache


def apply_block(kind: str, p, x, ctx: RunCtx, cache, key=()):
    """One block; returns ``(x, aux_loss, new_cache)`` as the reference.
    ``aux_loss`` is the MoE balance loss (a 0-d tensor) for ``moe`` and
    0.0 for every other kind.  Under a split (``ctx.split``) ``x`` is in
    the residual's state and ``key`` is the block's path in the params tree
    (by which the split finds each leaf's 'model' block)."""
    if ctx.mode == "paged" and kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"paged serving supports attention-only stacks; block kind "
            f"{kind!r} (mamba/cross state caches are per-slot, not paged)")
    if kind in ("mamba", "cross"):
        run = _mamba_block if kind == "mamba" else _cross_block
        y, new_cache = run(p, x, ctx, cache, key)
        return y, 0.0, new_cache
    h = _norm(ctx, x, p["ln1"])
    out, new_cache = _self_attn(p["attn"], h, kind, ctx, cache,
                                key + ("attn",))
    x = x + out
    h = _norm(ctx, x, p["ln2"])
    if kind == "moe":
        y, aux = _moe(p["moe"], h, ctx, key + ("moe",))
        return x + y, aux, new_cache
    return x + _mlp(p["mlp"], h, ctx, key + ("mlp",)), 0.0, new_cache


def _shared_attn_block(p, x, ctx: RunCtx, cache):
    """zamba2's shared block: one param set, applied at the end of every
    period with that use site's KV cache; ``(x, 0.0, new_cache)`` as
    :func:`apply_block`."""
    return apply_block(_shared_kind(ctx.cfg), p, x, ctx, cache,
                       ("shared_attn",))


# ---------------------------------------------------------------------------
# full model passes
# ---------------------------------------------------------------------------

def _use(ctx: RunCtx, tree, *key):
    """``tree`` (params at ``key`` in the params tree) as the model uses
    it: gathered from the rank's blocks under a placement (under a split,
    the leaves it computes with keep their 'model' block)."""
    if ctx.placement is None:
        return tree
    return ctx.placement.gather_params(
        tree, *key, keep=ctx.split.keep if ctx.split is not None else None)


def _embed(params, tokens, ctx: RunCtx):
    """The embedding, in the split's residual state under a split: by
    vocabulary blocks, each rank's lookup masked to its rows and the
    partial rows summed over 'model'."""
    # an embedding, not ``embed[tokens]``: an index's backward accumulates
    # repeated tokens into whatever gradient a tied head left first, so its
    # sums ran in the order the autograd engine reached them
    w = _use(ctx, params["embed"], "embed")
    sp = ctx.split
    if sp is None or not sp.vocab:
        return _to(ctx, torch.nn.functional.embedding(tokens, w), "R",
                   _residual(ctx))
    local = tokens - sp.index * w.shape[-2]
    inside = (local >= 0) & (local < w.shape[-2])
    x = torch.nn.functional.embedding(torch.where(inside, local, 0), w)
    return sp.to(torch.where(inside[..., None], x, 0.0), "P", sp.residual)


def _logits(params, x, ctx: RunCtx, *, whole: bool = True):
    """The head's fp32 logits.  Under a split with ``vocab`` the head is
    column-parallel over the vocabulary: the rank's block of the logits,
    gathered whole unless ``whole`` is False (a train step's loss reads
    the blocks)."""
    cfg, sp = ctx.cfg, ctx.split
    norm = _use(ctx, params["final_norm"], "final_norm")
    head = (_use(ctx, params["embed"], "embed").T if cfg.tie_embeddings
            else _use(ctx, params["lm_head"], "lm_head"))
    h = _norm(ctx, x, norm)
    if sp is None or not sp.vocab:
        return layers.softcap((_to(ctx, h, _residual(ctx), "R") @ head)
                              .float(), cfg.logit_softcap)
    logits = layers.softcap((sp.enter(h, sp.residual) @ head).float(),
                            cfg.logit_softcap)
    return sp.all_gather(logits) if whole else logits


def _with_cache(ctx: RunCtx, run, cache, *key):
    """``run(cache)`` -> ``(x, aux, new_cache)`` on a block's cache: under a
    placement a decode step gathers the cache, writes it in place and puts
    the rank's block back, or, pinned, runs on the rank's blocks as they
    are; a prefill keeps the rank's block of the new cache."""
    pl = ctx.placement
    if pl is None or pl.cache is None or ctx.pin_cache:
        return run(cache)
    if cache is not None:
        full = pl.gather_cache(cache, *key)
        x, aux, _ = run(full)
        pl.store_cache(cache, full, *key)
        return x, aux, cache
    x, aux, nc = run(None)
    return x, aux, (None if nc is None else pl.cut_cache(nc, *key))


def _unstack(tree, n: int) -> list:
    """A tree of leaves stacked ``[n, ...]`` -> its ``n`` entries, views
    from one ``unbind`` a leaf.  Under autograd the backward of an unbind
    is one stack, where indexing each period apart would give every
    leaf's gradient a zero-filled full-size tensor a period to add up."""
    leaves, treedef = tree_flatten(tree)
    parts = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [p[i] for p in parts]) for i in range(n)]


def _period_train(ctx: RunCtx, x, block_params, shared_p):
    """One period of a ``train`` forward: ``(x, [moe aux losses])``."""
    auxes = []
    for j, kind in enumerate(ctx.cfg.period):
        x, aux, _ = apply_block(kind, _use(ctx, block_params[j], "blocks",
                                           j), x, ctx, None, ("blocks", j))
        if kind == "moe":
            auxes.append(aux)
    if shared_p is not None:
        x, _, _ = _shared_attn_block(_use(ctx, shared_p, "shared_attn"), x,
                                     ctx, None)
    return x, auxes


def _period_args(treedef, leaves) -> tuple:
    """``(block_params, shared_p, img)`` back from :func:`_period_remat`'s
    leaves."""
    parts = tree_unflatten(treedef, list(leaves))
    return parts["blocks"], parts.get("shared"), parts.get("img")


class _PeriodRemat(torch.autograd.Function):
    """A period whose backward recomputes it: the forward keeps only its
    inputs (the residual stream, the period's params and the image
    embeddings a cross block reads), and the backward runs the period again
    under autograd and differentiates it with ``torch.autograd.grad``.  The
    reference's ``jax.checkpoint`` of its scan body; it composes with
    ``torch.func.vmap`` (``torch.utils.checkpoint`` does not: it refuses
    saved-tensor hooks and reentrant functions).  Every tensor the period
    reads is an input, never a closure: a closed-over tensor of an outer
    ``vmap`` level is gone when the backward runs.

    Under ``torch.func.vmap`` (the node axis of a training step) its own
    :meth:`vmap` rule applies it once to the whole node stack
    (``mapped``), running the period under ``torch.func.vmap`` inside
    both passes.  So its backward runs below the caller's ``vmap``, where
    a recomputing function nested in the period (the attention's
    ``remat_chunks``) can run its own ``torch.func.vjp``: under the
    generated rule, that nesting fails inside ``torch.func``.  The
    recompute is plain autograd, not ``torch.func.vjp``, because an
    autograd function inside the period (the gathers, the split's
    collectives) then costs one vmap level a call, where under
    ``torch.func.vjp`` each call builds a function class; so a backward
    under a ``torch.func`` gradient transform is refused (the step
    builders differentiate with ``torch.autograd.grad``)."""

    @staticmethod
    def _period(run: RunCtx, treedef, mapped: bool, x, leaves):
        def one(x, *leaves):
            blocks, shared, img = _period_args(treedef, leaves)
            y, auxes = _period_train(dataclasses.replace(run, img=img), x,
                                     blocks, shared)
            return (y, *auxes)

        return torch.func.vmap(one)(x, *leaves) if mapped else one(x,
                                                                   *leaves)

    @staticmethod
    def forward(run, treedef, mapped, x, *leaves):
        return _PeriodRemat._period(run, treedef, mapped, x, leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run, ctx.treedef, ctx.mapped = inputs[:3]
        ctx.save_for_backward(*inputs[3:])

    @staticmethod
    def backward(ctx, *grads):
        if torch._C._are_functorch_transforms_active():
            raise NotImplementedError(
                "remat='full' recomputes a period under torch.autograd; "
                "differentiate the loss with torch.autograd.grad, not a "
                "torch.func gradient transform")
        inputs = [t.detach().requires_grad_(True)
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = _PeriodRemat._period(ctx.run, ctx.treedef, ctx.mapped,
                                        inputs[0], inputs[1:])
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        got = torch.autograd.grad([o for o, _ in pairs], inputs,
                                  [g for _, g in pairs], allow_unused=True)
        return (None, None, None, *got)

    @staticmethod
    def vmap(info, in_dims, run, treedef, mapped, x, *leaves):
        if mapped:
            raise NotImplementedError("a period maps one node axis")
        ts = [t.movedim(d, 0) if d is not None
              else t.expand(info.batch_size, *t.shape)
              for t, d in zip((x, *leaves), in_dims[3:])]
        out = _PeriodRemat.apply(run, treedef, True, *ts)
        return out, tuple(0 for _ in out)


def _period_remat(ctx: RunCtx, x, block_params, shared_p):
    """:func:`_period_train` through :class:`_PeriodRemat`."""
    parts = {"blocks": block_params}
    if shared_p is not None:
        parts["shared"] = shared_p
    if ctx.img is not None:
        parts["img"] = ctx.img
    leaves, treedef = tree_flatten(parts)
    y, *auxes = _PeriodRemat.apply(dataclasses.replace(ctx, img=None),
                                   treedef, False, x, *leaves)
    return y, auxes


def forward(params, tokens, cfg: ModelConfig, *, mode: str, img=None,
            cache=None, pos=None, chunk: int = 1024, ssd_chunk: int = 128,
            cache_len: int = 0, use_pallas: bool = False,
            decode_lowp: bool = False, pages=None, remat: str = "none",
            skip_masked_chunks: bool = False, remat_attention: bool = False,
            repeat_kv: bool = False, placement=None, split=None,
            pin_cache: bool = False, rows=None):
    """The shared forward pass.  Returns ``(logits, aux_loss, new_cache)``;
    ``img`` [B, T_img, d] feeds the cross blocks (train and prefill).
    ``placement`` (``launch/sharding.Placement``): ``params`` and a decode
    step's ``cache`` are the rank's blocks, and a prefill's cache comes back
    as the rank's blocks.  ``split`` (``launch/sharding.Split``, on that
    placement; not paged): the compute split over 'model', and a train
    forward's logits are the rank's vocabulary block where the split
    divides the vocabulary (``split.vocab``).  ``pin_cache`` (decode, under
    a placement of the caches): attend over and write into the rank's
    cache blocks, with no cache leaf gathered (the reference's
    ``pin_decode_cache``).  ``rows`` (``launch/sharding.Rows``; not paged):
    ``tokens`` are the rank's rows of a node's batch; every block computes
    row by row, and the MoE queues them in the node's queue
    (``moe.moe_ffn(rows=)``).

    train:   tokens [B,S] -> logits [B,S,Vp], aux, None
    prefill: tokens [B,S] -> logits [B,Vp] (last pos), aux, cache
    decode:  tokens [B,1] -> logits [B,Vp], aux, cache (written in place)
    paged:   tokens [B,C] -> logits [B,Vp] (per-slot last valid), aux, pages
             (written in place)
    """
    if mode not in ("train", "prefill", "decode", "paged"):
        raise ValueError(f"unknown forward mode {mode!r}")
    if split is not None and (mode == "paged"
                              or split.placement is not placement):
        raise ValueError(f"a compute split runs train, prefill and decode "
                         f"forwards on its own placement, not a {mode!r} "
                         "forward")
    pin_cache = pin_cache and mode == "decode" and placement is not None \
        and placement.cache is not None
    ctx = RunCtx(cfg=cfg, mode=mode, pos=pos, img=img, chunk=chunk,
                 ssd_chunk=ssd_chunk, cache_len=cache_len,
                 use_pallas=use_pallas, decode_lowp=decode_lowp, pages=pages,
                 skip_masked_chunks=skip_masked_chunks,
                 remat_attention=remat_attention, repeat_kv=repeat_kv,
                 placement=placement, split=split, pin_cache=pin_cache,
                 rows=rows)
    x = _embed(params, tokens, ctx)
    reads_cache = mode in ("decode", "paged")
    shared_p = params.get("shared_attn")
    made = [[] for _ in cfg.period]
    made_shared = []
    auxes = []
    periods = [_unstack(bp, cfg.n_periods) for bp in params["blocks"]]
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                         f"{remat!r}")
    for i in range(cfg.n_periods):
        if remat == "full" and mode == "train":
            x, period_aux = _period_remat(
                ctx, x, tuple(pj[i] for pj in periods), shared_p)
            auxes.extend(period_aux)
            continue
        for j, kind in enumerate(cfg.period):
            # period i of the stacked params and caches, as views
            c = (tree_map(lambda t: t[i], cache["blocks"][j]) if reads_cache
                 else None)
            p = _use(ctx, periods[j][i], "blocks", j)
            x, aux, nc = _with_cache(
                ctx, lambda c, kind=kind, p=p, j=j: apply_block(
                    kind, p, x, ctx, c, ("blocks", j)), c, "blocks", j)
            made[j].append(nc)
            if kind == "moe":
                auxes.append(aux)
        if shared_p is not None:
            c = (tree_map(lambda t: t[i], cache["shared_attn"])
                 if reads_cache else None)
            p = _use(ctx, shared_p, "shared_attn")
            x, _, nc = _with_cache(
                ctx, lambda c, p=p: _shared_attn_block(p, x, ctx, c), c,
                "shared_attn")
            made_shared.append(nc)
    tail_caches = []
    for i, tp in enumerate(params["tail"]):
        c = cache["tail"][i] if reads_cache else None
        p = _use(ctx, tp, "tail", i)
        x, aux, nc = _with_cache(
            ctx, lambda c, p=p, i=i: apply_block(
                cfg.period[0], p, x, ctx, c, ("tail", i)), c, "tail", i)
        tail_caches.append(nc)
        if cfg.period[0] == "moe":
            auxes.append(aux)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for aux in auxes:
        aux_total = aux_total + aux

    if mode == "train":
        return _logits(params, x, ctx, whole=False), aux_total, None
    if mode == "prefill":
        def stack(m):
            return tree_map(lambda *ls: torch.stack(ls), *m)
        new_cache = {"blocks": tuple(stack(m) for m in made),
                     "tail": tuple(tail_caches)}
        if shared_p is not None:
            new_cache["shared_attn"] = stack(made_shared)
        return _logits(params, x[:, -1], ctx), aux_total, new_cache
    if mode == "paged":
        x_last = x[torch.arange(x.shape[0], device=x.device), pages.last_idx]
        return _logits(params, x_last, ctx), aux_total, cache
    return _logits(params, x[:, 0], ctx), aux_total, cache


def train_loss(params, batch, cfg: ModelConfig, **kw):
    """batch: ``{tokens [B,S], labels [B,S], (image_embeds [B,T,d])}`` ->
    0-d loss: the mean token cross-entropy over the valid vocab, plus the
    auxiliary loss.  Under ``rows`` (the batch is the rank's rows of a
    node's, ``launch/sharding.Rows``) the loss over R, the rank's share:
    the ranks' losses sum to the node's."""
    logits, aux, _ = forward(params, batch["tokens"], cfg, mode="train",
                             img=batch.get("image_embeds"), **kw)
    split, rows = kw.get("split"), kw.get("rows")
    loss = layers.cross_entropy(
        logits, batch["labels"], cfg.vocab_size,
        split=split if split is not None and split.vocab else None) + aux
    return loss if rows is None else loss / rows.size


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
