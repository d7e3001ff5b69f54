"""Mamba-2 (SSD, state-space duality -- arXiv:2405.21060) mixer.

Port of ``repro/models/ssm.py``.  Scalar-identity per-head decay
``a = -exp(a_log)``, discretized with a per-token, per-head step ``dt``:

    h_t = exp(a * dt_t) h_{t-1} + dt_t * B_t x_t^T      h in R^{N x P}
    y_t = C_t h_t + D x_t

Three implementations with the same semantics:
  * ``ssd_reference``  -- sequential over time (the oracle);
  * ``ssd_chunked``    -- chunked SSD (intra-chunk attention-like products
    and an inter-chunk state recurrence, a Python loop over the chunks where
    the reference scans), the model's plain path;
  * ``kernels.ops.ssd_scan`` -- the CUDA kernel of ``csrc/ssd_scan.cu`` on
    CUDA tensors, the plain sequential version on CPU ones (``use_pallas``).

The decode path carries (conv_state, ssm_state) and costs O(1) per token.
Where the reference returns a new state, :func:`mamba_decode` writes the
given one in place and returns it, as the port's KV caches are written;
a pinned decode on a mesh updates the rank's blocks of the two states
(``blocks=``), and a decode's split computes the projections on the
rank's 'model' blocks of the weights (``split=``).
``SSMConfig`` lives in ``configs/base.py``.  The reference's ``unroll`` (a
TPU scan control) is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import SSMConfig
from ..kernels import ops as kops
from ..kernels import ref as kref
from . import layers

__all__ = ["SSMConfig", "init_mamba", "ssd_reference", "ssd_chunked",
           "ssd_decode_step", "mamba_mixer", "mamba_prefill", "mamba_decode",
           "init_mamba_state"]


def init_mamba(gen, d_model: int, cfg: SSMConfig, *, device,
               dtype=torch.float32) -> dict:
    """The mixer's params, drawn from the ``torch.Generator`` ``gen``
    (``device="meta"`` builds the shapes only); ``a_log``, ``d_skip`` and
    ``dt_bias`` are fp32 whatever ``dtype``, as in the reference."""
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    d_bc = 2 * cfg.d_state
    kw = dict(device=device, dtype=dtype)
    f32 = dict(device=device, dtype=torch.float32)
    # in_proj packs [z (gate), x, B, C, dt]
    return {
        "in_proj": layers.dense_init(gen, d_model, 2 * di + d_bc + nh, **kw),
        "conv_w": layers.normal_init(gen, (cfg.d_conv, di + d_bc), 0.1, **kw),
        "a_log": torch.zeros(nh, **f32),       # a = -exp(a_log) = -1
        "d_skip": torch.ones(nh, **f32),
        "dt_bias": torch.zeros(nh, **f32),
        "out_proj": layers.dense_init(gen, di, d_model, **kw),
    }


def _split_proj(proj: torch.Tensor, di: int, n: int, nh: int):
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    return z, xbc, dt  # dt: [..., nh]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d; xbc [B,S,C], w [K,C]."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(out)


# ---------------------------------------------------------------------------
# SSD cores
# ---------------------------------------------------------------------------

def ssd_reference(x, dt, a, b, c, d_skip):
    """Sequential oracle.  x [B,S,H,P], dt [B,S,H], a [H] (negative), b/c
    [B,S,N], d_skip [H].  Returns y [B,S,H,P] (x's dtype) and the final
    state [B,H,N,P] (fp32): the scan kernel's plain version."""
    return kref.ssd_scan(x, dt, a, b, c, d_skip)


def ssd_chunked(x, dt, a, b, c, d_skip, *, chunk: int = 128,
                initial_state=None):
    """Chunked SSD: ``S / chunk`` sequential steps of attention-like
    products.  ``chunk`` is ``min(chunk, S)`` and must divide S."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    chunk = kref.ssd_chunk_len(s, chunk)
    nc = s // chunk

    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtf = dt.float().reshape(bsz, nc, chunk, h)
    bf = b.float().reshape(bsz, nc, chunk, n)
    cf = c.float().reshape(bsz, nc, chunk, n)

    adt = a[None, None, None, :] * dtf                     # [B,nc,L,H] (<=0)
    cum = torch.cumsum(adt, dim=2)                         # s_t within chunk
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]

    hstate = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                          device=x.device) if initial_state is None
              else initial_state.float())
    ys = []
    for k in range(nc):
        xk, dtk, bk, ck, cumk = (xf[:, k], dtf[:, k], bf[:, k], cf[:, k],
                                 cum[:, k])
        # intra-chunk: M[t,s] = (C_t.B_s) exp(s_t - s_s) dt_s  (causal)
        gram = torch.einsum("btn,bsn->bts", ck, bk)        # [B,L,L]
        dec = cumk[:, :, None, :] - cumk[:, None, :, :]    # [B,L,L,H]
        m = gram[..., None] * torch.exp(torch.where(causal, dec,
                                                    -torch.inf))
        m = m * dtk[:, None, :, :]                         # weight by dt_s
        y_intra = torch.einsum("btsh,bshp->bthp", m, xk)
        # state to pass on: sum_s exp(s_L - s_s) dt_s B_s x_s
        w_out = torch.exp(cumk[:, -1:, :] - cumk) * dtk    # [B,L,H]
        state_out = torch.einsum("bsh,bsn,bshp->bhnp", w_out, bk, xk)
        # inter-chunk contribution: C_t exp(s_t) h_in
        w_in = torch.exp(cumk)                             # [B,L,H]
        y_inter = torch.einsum("btn,bhnp,bth->bthp", ck, hstate, w_in)
        tot = torch.exp(cumk[:, -1, :])                    # [B,H]
        hstate = tot[:, :, None, None] * hstate + state_out
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, p)
    y = y + x.float() * d_skip[None, None, :, None]
    return y.to(x.dtype), hstate


def ssd_decode_step(hstate, xt, dtt, a, bt, ct, d_skip, *, sum_states=None):
    """One-token state update; hstate [B,H,N,P].  ``sum_states(y)`` sums
    the readout ``C h`` over the ranks that hold the state's other N
    blocks (a pinned decode on a block of the state; before the skip
    term, which every rank has whole)."""
    decay = torch.exp(a * dtt)[..., None, None]
    inject = dtt[..., None, None] * bt[:, None, :, None] * xt[:, :, None, :]
    h_new = decay * hstate.float() + inject
    y = torch.einsum("bhnp,bn->bhp", h_new, ct)
    if sum_states is not None:
        y = sum_states(y)
    return h_new, y + xt * d_skip[None, :, None]


# ---------------------------------------------------------------------------
# full mixer
# ---------------------------------------------------------------------------

def _rank_proj(params: dict, x: torch.Tensor, cfg: SSMConfig, split,
               state: str, key: tuple):
    """``(z, raw conv input, dt, conv_w)`` of the rank's ``nh / M`` heads
    under a ``launch/sharding.Split``, from ``x`` in ``state``, without
    ``in_proj`` gathered.  Where 'model' stores ``in_proj`` by column
    blocks (of ``[z | x | B | C | dt]``, which need not line up with the
    heads), the column-parallel product's blocks are regrouped by one
    all-to-all into the rank's z, x and dt, and B and C are summed whole
    from the blocks that hold them (zeros elsewhere) for the rank's own
    use; else the projection is made whole for the rank's own use (a row
    block's partial sums all-reduced, a leaf gathered whole entered
    through *f*) and cut.  Either way B's and C's gradients, which every
    rank's heads add to, are summed over the ranks.  The conv input is
    ``[x of its heads | B | C]``, and ``conv_w`` (gathered whole on use)
    the matching columns, through *f*."""
    m, r = split.size, split.index
    d_model = split.cfg.d_model          # x may be the rank's features
    di, nh, n = cfg.d_inner(d_model), cfg.n_heads(d_model), cfg.d_state
    dh, hh = di // m, nh // m
    y, ys = split.linear(x, state, params["in_proj"], key + ("in_proj",))
    if ys == "S":
        zxdt = split.regroup(y, lambda t: ((t * dh, dh), (di + t * dh, dh),
                                           (2 * di + 2 * n + t * hh, hh)))
        lo, width = r * y.shape[-1], y.shape[-1]
        a, b = max(lo, 2 * di), min(lo + width, 2 * di + 2 * n)
        if a >= b:                       # no B or C column in the block
            a = b = 2 * di
        bc = split.all_reduce(F.pad(y[..., a - lo:b - lo],
                                    (a - 2 * di, 2 * di + 2 * n - b)),
                              local=True)
        z, xr, dt = zxdt.split([dh, dh, hh], dim=-1)
        z, (b, c) = z.contiguous(), bc.split([n, n], dim=-1)
    else:
        # [z_0 .. z_M-1 | x_0 .. x_M-1 | B | C | dt_0 .. dt_M-1], one split
        # so that the backward is one concatenation
        parts = split.enter(y, ys).split(
            [dh] * (2 * m) + [n, n] + [hh] * m, dim=-1)
        b, c, xr, dt = parts[2 * m], parts[2 * m + 1], parts[m + r], \
            parts[2 * m + 2 + r]
        # a copy: a view would keep the whole projection alive for silu(z)
        z = parts[r].contiguous()
    xbc_raw = torch.cat([xr, b, c], dim=-1)
    w = split.copy(params["conv_w"]).split([dh] * m + [n, n], dim=-1)
    conv_w = torch.cat([w[r], w[m], w[m + 1]], dim=-1)
    return z, xbc_raw, dt, conv_w


def _scan_inputs(params: dict, x: torch.Tensor, cfg: SSMConfig, split=None,
                 state: str = "R", key: tuple = ()):
    """``(z, raw conv input [B,S,C], (x [B,S,H,P], dt, a, b, c,
    d_skip))`` of the train/prefill mixer: the scan's operands, x, b and c
    as views of the conv output, which the kernel reads in place.  Under a
    ``split`` (:func:`_rank_proj`) H is the rank's heads and the conv
    output ``[x of its heads | B | C]``, so the same views hold (a token
    stride of ``di / M + 2N``)."""
    bsz, s, d_model = x.shape
    n = cfg.d_state
    if split is None:
        di, nh = cfg.d_inner(d_model), cfg.n_heads(d_model)
        z, xbc_raw, dt = _split_proj(x @ params["in_proj"], di, n, nh)
        conv_w, own = params["conv_w"], lambda name: params[name]
    else:
        z, xbc_raw, dt, conv_w = _rank_proj(params, x, cfg, split, state,
                                            key)
        di, nh = z.shape[-1], dt.shape[-1]
        own = lambda name: split.own(params[name], key + (name,))
    xbc = _causal_conv(xbc_raw, conv_w)
    xi = xbc[..., :di].reshape(bsz, s, nh, cfg.head_dim)
    dt = F.softplus(dt.float() + own("dt_bias"))
    a = -torch.exp(own("a_log"))
    return z, xbc_raw, (xi, dt, a, xbc[..., di:di + n], xbc[..., di + n:],
                        own("d_skip"))


def _conv_state(xbc_raw: torch.Tensor, k: int) -> torch.Tensor:
    """The decode conv state a prefill leaves: the last K-1 raw conv
    inputs, copied (a view would keep the whole projection alive)."""
    return xbc_raw[:, xbc_raw.shape[1] - (k - 1):, :].clone()


def _mixer(params: dict, x: torch.Tensor, cfg: SSMConfig, chunk: int,
           use_pallas: bool, split=None, state: str = "R", key: tuple = ()):
    """``(out [B,S,d] in ``state``, final ssm state [B,H,N,P], raw conv
    input [B,S,C])`` of the train/prefill mixer; under a ``split`` H and C
    are the rank's, and ``out_proj`` takes the rank's heads (its ``di /
    M`` input rows where it is stored so: row-parallel), its partial sums
    moved back to ``state``."""
    bsz, s, _ = x.shape
    z, xbc_raw, scan_args = _scan_inputs(params, x, cfg, split, state, key)
    scan = kops.ssd_scan if use_pallas else ssd_chunked
    y, fin = scan(*scan_args, chunk=chunk)
    y = y.reshape(bsz, s, -1) * F.silu(z)
    if split is None:
        return y @ params["out_proj"], fin, xbc_raw
    out, ys = split.linear(y, "S", params["out_proj"], key + ("out_proj",))
    return split.to(out, ys, state), fin, xbc_raw


def mamba_mixer(params: dict, x: torch.Tensor, cfg: SSMConfig, *,
                chunk: int = 128, use_pallas: bool = False, split=None,
                state: str = "R", key: tuple = ()) -> torch.Tensor:
    """Train/prefill path.  x: [B,S,d] -> [B,S,d].  ``split`` (a
    ``launch/sharding.Split`` whose ``ssm`` heads divide): ``x`` and the
    output are in ``state`` ("R" whole, "S" the rank's features), each rank
    computes its ``nh / M`` heads with the mixer's leaves at ``key`` in the
    params tree as the split keeps them."""
    return _mixer(params, x, cfg, chunk, use_pallas, split, state, key)[0]


def mamba_prefill(params: dict, x: torch.Tensor, cfg: SSMConfig, *,
                  chunk: int = 128, use_pallas: bool = False, split=None,
                  state: str = "R", key: tuple = ()):
    """The prefill mixer and the state it leaves, in one pass: ``(out
    [B,S,d], {"conv": [B,K-1,C], "ssm": [B,H,N,P]})``.  The SSM state is
    the scan's own final state (the kernel's output under ``use_pallas``)
    and the conv state the last K-1 rows of the raw conv input, where the
    reference recomputes both through a second jnp pass
    (``repro/models/transformer.py:379`` ``_mamba_prefill_state``).  Under
    a ``split`` (as :func:`mamba_mixer`) the rank's heads of both states
    are all-gathered whole (the caller keeps the block its cache layout
    stores)."""
    out, fin, xbc_raw = _mixer(params, x, cfg, chunk, use_pallas, split,
                               state, key)
    conv = _conv_state(xbc_raw, params["conv_w"].shape[0])
    if split is not None:
        di = fin.shape[-3] * cfg.head_dim
        conv = torch.cat([split.all_gather(conv[..., :di]), conv[..., di:]],
                         dim=-1)
        fin = split.all_gather(fin, -3)
    return out, {"conv": conv, "ssm": fin}


def mamba_decode(params: dict, x: torch.Tensor, state: dict,
                 cfg: SSMConfig, *, blocks=None, split=None,
                 residual: str = "R", key: tuple = ()):
    """Decode path.  x: [B,1,d]; state: {conv: [B,K-1,C], ssm: [B,H,N,P]},
    written in place and returned with the output.

    ``blocks`` (a pinned decode on a mesh): ``state`` is the rank's block
    of each leaf and ``blocks[name]`` its ``launch/sharding.CacheBlock``.
    Each rank convolves its rows and channels of the conv state and
    all-gathers the output (an activation, whole on every rank), then
    updates its block of the SSM state from the whole ``x``, ``B``, ``C``
    and ``dt`` and all-gathers ``y`` (the readout summed over the ranks
    that split N); no state leaf is gathered.

    ``split`` (a decode's ``launch/sharding.Split`` with ``ssm``): ``x``
    and the output are in ``residual`` ("R" whole, "S" the rank's
    features) and the mixer's leaves at ``key`` in the params tree are as
    the split keeps them.  ``in_proj`` on its stored 'model' block (its
    columns, or its rows: the partial sums all-reduced) gives the
    one-token projection, made whole; ``conv_w``, where the split keeps
    it, is the rank's channel block, so the conv runs on those channels;
    ``y`` is whole after its joins and ``out_proj`` takes it by the
    split's rule (row-parallel on the rank's contiguous rows of ``y``),
    its partial sums moved to ``residual``."""
    bsz = x.shape[0]
    d_model = x.shape[-1] if split is None else split.cfg.d_model
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    n = cfg.d_state
    if split is None:
        proj = x @ params["in_proj"]
    else:
        proj = split.to(*split.linear(x, residual, params["in_proj"],
                                      key + ("in_proj",)), "R")
    z, xbc, dt = _split_proj(proj[:, 0], di, n, nh)
    w = params["conv_w"]
    own_w = split is not None and split.keep(key + ("conv_w",))
    bc = bs = None
    if blocks is not None:
        bc, bs = blocks["conv"], blocks["ssm"]
        if bc.axes(-2):
            raise NotImplementedError("a conv state stored by its time dim")
        xbc = bc.cut(bc.cut(xbc, -3, 0), -1)
        if not own_w:
            w = bc.cut(w, -1)
    # rolling conv state
    conv_in = torch.cat([state["conv"], xbc[:, None, :]], dim=1)
    # a whole conv state meets conv_w's block on the rank's channels
    own = split.block(conv_in) if own_w and bc is None else conv_in
    xbc = F.silu(torch.einsum("bkc,kc->bc", own, w))
    if bc is not None:
        xbc = bc.join(bc.join(xbc, -1), -3, 0)
    elif own_w:
        xbc = split.all_gather(xbc)
    xi = xbc[..., :di].reshape(bsz, nh, cfg.head_dim).float()
    b = xbc[..., di:di + n].float()
    c = xbc[..., di + n:].float()
    dtv = F.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    d_skip = params["d_skip"]
    sum_states = None
    if bs is not None:
        # the block's rows, heads, N and P of every operand
        xi = bs.cut(bs.cut(bs.cut(xi, -4, 0), -3, 1), -1)
        dtv = bs.cut(bs.cut(dtv, -4, 0), -3, 1)
        a, d_skip = bs.cut(a, -3, 0), bs.cut(d_skip, -3, 0)
        b, c = (bs.cut(bs.cut(t, -4, 0), -2, -1) for t in (b, c))
        if bs.axes(-2):
            sum_states = lambda y: bs.reduce(y, -2)
    h_new, yt = ssd_decode_step(state["ssm"], xi, dtv, a, b, c, d_skip,
                                sum_states=sum_states)
    if bs is not None:
        yt = bs.join(bs.join(bs.join(yt, -1), -3, 1), -4, 0)
    y = yt.reshape(bsz, di).to(x.dtype) * F.silu(z)
    if split is None:
        out = y @ params["out_proj"]
    else:
        out = split.to(*split.linear(y, "R", params["out_proj"],
                                     key + ("out_proj",)), residual)
    state["conv"].copy_(conv_in[:, 1:, :])
    state["ssm"].copy_(h_new)
    return out[:, None, :], state


def init_mamba_state(bsz: int, d_model: int, cfg: SSMConfig,
                     dtype=torch.float32, *, device="cuda", lead=()) -> dict:
    """Zero decode state; ``lead`` prepends axes (the stacked periods)."""
    di = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    return {
        "conv": torch.zeros((*lead, bsz, cfg.d_conv - 1, di + 2 * cfg.d_state),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((*lead, bsz, nh, cfg.d_state, cfg.head_dim),
                           dtype=torch.float32, device=device),
    }
