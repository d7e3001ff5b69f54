"""Plain PyTorch versions of the ``qg_update``, ``compress``, ``attention``
and ``ssd_scan`` kernels.

Port of ``repro/kernels/ref.py:16-80`` (the streaming kernels) and
``:87``/``:115`` (the two attention kernels, below).  Each streaming
function keeps the expression order of the Pallas body it stands for
(``repro/kernels/qg_update.py``, ``repro/kernels/compress.py``), so that on
the same fp32 inputs it rounds exactly as the CUDA kernel in
``csrc/qg_update.cu`` or ``csrc/compress.cu`` does: every product, sum and quotient is its own rounded operation, and the
coefficients fold the way the reference folds them.  A quotient is always a
true division of two tensors on one device: PyTorch computes
``scalar / tensor`` as ``tensor.reciprocal() * scalar``, and on CUDA
``tensor / python_scalar`` as a product with the reciprocal, neither of which
rounds as the reference's division does.
They are the kernels' test oracle and serve CPU tensors in
``kernels/ops.py``; they run on any device.

The attention versions are the reference's quadratic masked softmax, in
fp32, written in the online-softmax kernels' form: ``p = exp(s - m)`` where
the mask holds and 0 elsewhere, ``out = sum(p v) / max(sum(p), 1e-30)``.
On every row with at least one unmasked key that is the softmax of
``ref.py``; on a row with none (a paged slot of length 0, an inactive
serving slot) it is 0, as the Pallas and the CUDA kernels give, where
``ref.py``'s dense-gather oracle gives the mean of the gathered values.
Their sums run in another order than the kernels', so they agree to
rounding, not to the bit.  ``paged_decode_partials`` and
``paged_decode_merge`` are the paged kernel's two passes written plainly
(per split of the pages: running max, sum and unnormalised accumulator;
then the rescaled sum over splits): the CPU oracle of the split-KV design.

The SSD scan's version is the reference's sequential oracle
(``repro/kernels/ref.py:152``), one state update per token, with the D-skip
term that ``repro/kernels/ops.py:84`` adds outside its kernel.
``ssd_chunk_states``, ``ssd_state_passing`` and ``ssd_chunk_outputs`` are
the scan kernel's three passes written plainly, over chunks of
``SSD_BLOCK`` tokens (the SSD paper's chunk-parallel form, arXiv:2405.21060
sections 6-7); ``ssd_scan_passes`` composes them into the same function.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["qg_local_step", "qg_buffer_update", "fused_halfstep",
           "fused_qg_buffer", "qg_step", "gamma_correct", "choco_exchange",
           "threshold_mask", "quantize_dequantize", "threshold_mask_group",
           "quantize_dequantize_group", "attn_scale", "flash_attention",
           "paged_decode_attention", "paged_decode_partials",
           "paged_decode_merge", "ssd_chunk_len", "ssd_scan", "SSD_BLOCK",
           "ssd_chunk_states", "ssd_state_passing", "ssd_chunk_outputs",
           "ssd_scan_passes"]

NEG_INF = -2.0e38


def attn_scale(d: int) -> float:
    """``1/sqrt(d)`` rounded to fp32, as the reference computes it
    (``1 / jnp.sqrt(jnp.asarray(d, jnp.float32))``), as a Python float: a
    product with it rounds once in fp32, and it needs no device tensor (a
    host-to-device copy would sync, and cannot be captured in a graph)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d fp32 tensor on ``like``'s device (a [1] operand or a float)."""
    return torch.as_tensor(v, dtype=torch.float32,
                           device=like.device).reshape(())


def qg_local_step(x, m_hat, g, *, eta: float, beta: float,
                  nesterov: bool) -> torch.Tensor:
    """Alg. 1 lines 5-6 (+ Nesterov): ``x - eta * upd`` with
    ``upd = beta*m_hat + g`` or ``g + beta*(beta*m_hat + g)``."""
    m_local = beta * m_hat + g
    upd = g + beta * m_local if nesterov else m_local
    return x - eta * upd


def qg_buffer_update(x_old, x_new, m_hat, *, eta: float,
                     mu: float) -> torch.Tensor:
    """Alg. 1 lines 8-9: ``mu*m_hat + (1-mu)*(x_old - x_new)/eta``, in the
    Pallas body's form: ``1/eta`` and ``1-mu`` are folded in double on the
    host and multiply, rather than divide, the difference."""
    return mu * m_hat + (1.0 - mu) * (x_old - x_new) * (1.0 / eta)


def fused_halfstep(x, m, g, eta, *, beta: float, wd: float = 0.0,
                   nesterov: bool = False):
    """Weight decay + HeavyBall/QG-seeded momentum + the gossip half step.
    ``eta`` is a fp32 [1] tensor (or a float).  Returns ``(half, m_new)``."""
    eta = _scalar(eta, x)
    ge = g + wd * x if wd else g
    mn = beta * m + ge
    upd = beta * mn + ge if nesterov else mn
    return -eta * upd + x, mn


def fused_qg_buffer(x_pre, x_post, m_hat, eta, refresh, *, mu: float):
    """Post-mix QG refresh with the Alg. 3 tau gate: where ``refresh`` is
    nonzero, ``mu*m_hat + (1-mu)*(1/eta)*(x_pre - x_post)``, else the old
    buffer carries through."""
    s = torch.reciprocal(_scalar(eta, x_pre))
    d = s * (x_pre - x_post)
    new = mu * m_hat + (1.0 - mu) * d
    return torch.where(_scalar(refresh, x_pre) != 0.0, new, m_hat)


def qg_step(xs, ms, gs, w, eta, refresh=None, *, beta: float,
            wd: float = 0.0, nesterov: bool = False, mu: float | None = None):
    """The dense-gossip step of ``qg_step`` as the stages compose it, leaf
    by leaf: :func:`fused_halfstep`, the mix ``W @ half`` along the nodes
    (fp32 W and leaves: the same product as ``core/gossip.py``'s
    ``mix_leaf_dense``), then (QG form, ``mu`` given)
    :func:`fused_qg_buffer`.  Returns ``(x_new, m_out)``,
    lists of leaves: ``m_out`` is DSGDm's new buffer or QG's refreshed
    m_hat.  (The kernel sums the mix in node order, this version as
    ``torch.matmul`` does.)"""
    x_new, m_out = [], []
    for x, m, g in zip(xs, ms, gs):
        half, mn = fused_halfstep(x, m, g, eta, beta=beta, wd=wd,
                                  nesterov=nesterov)
        mixed = torch.matmul(w, half.reshape(half.shape[0], -1)
                             ).reshape(half.shape)
        x_new.append(mixed)
        m_out.append(mn if mu is None else
                     fused_qg_buffer(x, mixed, m, eta, refresh, mu=mu))
    return x_new, m_out


def gamma_correct(x, mixed, anchor, *, gamma: float) -> torch.Tensor:
    """CHOCO/EF post-exchange correction ``x + gamma*(mixed - anchor)``;
    ``gamma`` rounds to fp32 as the reference's weak-typed scalar does."""
    return x + gamma * (mixed - anchor)


def choco_exchange(halves, qs, w, *, gamma: float, x_hats=None,
                   x_pres=None, m_hats=None, eta=None, refresh=None,
                   mu: float | None = None):
    """The exchange half of a compressed gossip round on the dense mix, as
    the stages compose it, leaf by leaf: the anchor ``a = x_hat + q``
    (CHOCO, ``x_hats`` given: the replica advance of
    ``comm/error_feedback.py``'s ``ef21_update``) or ``a = q`` (EF), the mix
    ``W @ a`` along the nodes (fp32 W and leaves: the product of
    ``core/gossip.py``'s ``mix_leaf_dense``), :func:`gamma_correct`, then
    (QG form, ``mu`` given) :func:`fused_qg_buffer` on ``x_pre`` and the
    corrected params.  Returns ``(x_out, x_hat_new, m_out)``, lists of
    leaves: ``x_hat_new`` the anchors in CHOCO form (else None), ``m_out``
    the refreshed m_hat in QG form (else None).  (The kernel sums the mix
    in node order, this version as ``torch.matmul`` does.)"""
    x_out, anchors, m_out = [], [], []
    for i, (half, q) in enumerate(zip(halves, qs, strict=True)):
        a = q if x_hats is None else x_hats[i] + q
        mixed = torch.matmul(w, a.reshape(a.shape[0], -1)).reshape(a.shape)
        xo = gamma_correct(half, mixed, a, gamma=gamma)
        x_out.append(xo)
        anchors.append(a)
        if mu is not None:
            m_out.append(fused_qg_buffer(x_pres[i], xo, m_hats[i], eta,
                                         refresh, mu=mu))
    return (x_out, None if x_hats is None else anchors,
            None if mu is None else m_out)


def threshold_mask(x2d, thr):
    """Magnitude-threshold sparsification with residual.  ``x2d`` [rows, f],
    ``thr`` [rows]; keeps every entry with ``|x| >= thr`` of its row (ties at
    the threshold included).  Returns ``(kept, residual)`` in fp32."""
    x = x2d.to(torch.float32)
    q = torch.where(x.abs() >= thr.to(torch.float32)[:, None], x, 0.0)
    return q, x - q


def quantize_dequantize(x2d, scale, u, *, levels: int):
    """QSGD stochastic quantize->dequantize with residual.  ``x2d`` [rows, f],
    ``scale`` [rows] (max ``|x|`` per row), ``u`` [rows, f] uniform in
    [0, 1); ``q = sign(x) * min(floor(|x|*(L/s) + u), L) * (s/L)`` with
    ``s = max(scale, 1e-12)``.  Returns ``(q, x - q)`` in fp32."""
    x = x2d.to(torch.float32)
    s = torch.clamp_min(scale.to(torch.float32), 1e-12)[:, None]
    lv = torch.full_like(s, float(levels))
    y = x.abs() * (lv / s)
    xi = torch.clamp_max(torch.floor(y + u.to(torch.float32)), levels)
    q = torch.sign(x) * xi * (s / lv)
    return q, x - q


def threshold_mask_group(x2ds, thrs):
    """``threshold_mask`` of each leaf of a message: ``[(q, r), ...]``."""
    return [threshold_mask(x, t) for x, t in zip(x2ds, thrs, strict=True)]


def quantize_dequantize_group(x2ds, scales, us, *, levels: int):
    """``quantize_dequantize`` of each leaf of a message:
    ``[(q, r), ...]``."""
    return [quantize_dequantize(x, s, u, levels=levels)
            for x, s, u in zip(x2ds, scales, us, strict=True)]


def _masked_softmax_av(sc, mask, v):
    """``sum_t p v / max(sum_t p, 1e-30)`` with ``p = exp(sc - max sc)``
    where ``mask`` holds and 0 elsewhere; ``sc`` [..., T], ``v`` matches
    the einsum ``bskgt,btkd->bskgd``."""
    sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), 0.0)
    acc = torch.einsum("bskgt,btkd->bskgd", p, v)
    return acc / torch.clamp_min(p.sum(dim=-1)[..., None], 1e-30)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """Masked softmax attention, GQA by head groups.  q [B,S,H,D]; k/v
    [B,T,K,D] -> [B,S,H,D] in q's dtype.  Query ``i`` sees key ``j`` when
    ``i >= j`` (causal) and ``i - j < window`` (window > 0); the softcap
    ``cap*tanh(s/cap)`` applies to the scaled scores before the mask."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.reshape(b, s, kh, g, d).float() * attn_scale(d)
    sc = torch.einsum("bskgd,btkd->bskgt", qf, k.float())
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones(s, t, dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    out = _masked_softmax_av(sc, mask[None, :, None, None, :], v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def _paged_scores(q, k_pages, v_pages, tables, lengths, window, softcap):
    """Each slot's query against the rows its block table names, by dense
    gather: the scaled (and softcapped) scores [B,K,G,T] in fp32, the
    visibility mask [B,T] and the gathered values [B,T,K,D] in fp32, for
    T = tables.shape[1] * ps logical positions."""
    b, _, h, d = q.shape
    n_p, ps, kh, _ = k_pages.shape
    t_idx = torch.arange(tables.shape[1] * ps, device=q.device)
    pages = tables.long()[:, t_idx // ps]                         # [B, T]
    rows = torch.clamp(pages * ps + t_idx % ps, 0, n_p * ps - 1)
    ks = k_pages.reshape(n_p * ps, kh, d)[rows].float()           # [B,T,K,D]
    vs = v_pages.reshape(n_p * ps, kh, d)[rows].float()
    qf = q.reshape(b, kh, h // kh, d).float() * attn_scale(d)
    sc = torch.einsum("bkgd,btkd->bkgt", qf, ks)
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    lengths = lengths.long()
    mask = (t_idx[None, :] < lengths[:, None]) & (pages >= 0)
    if window:
        mask &= t_idx[None, :] > (lengths - 1)[:, None] - window
    return sc, mask, vs


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           window: int = 0, softcap: float = 0.0):
    """One-token decode over a paged KV pool, by dense gather.  q [B,1,H,D];
    k/v_pages [NP,ps,K,D]; ``block_tables`` [B,P] page ids (-1 =
    unallocated); ``lengths`` [B] tokens written per slot, the current one
    included.  Slot ``b`` sees its logical positions ``t < lengths[b]``
    whose page is allocated (and ``t > lengths[b] - 1 - window``); a slot
    that sees none (length 0) gives 0."""
    b, _, h, d = q.shape
    sc, mask, vs = _paged_scores(q, k_pages, v_pages, block_tables, lengths,
                                 window, softcap)
    out = _masked_softmax_av(sc[:, None], mask[:, None, None, None, :], vs)
    return out.reshape(b, 1, h, d).to(q.dtype)


def paged_decode_partials(q, k_pages, v_pages, block_tables, lengths, *,
                          pages_per_split: int, window: int = 0,
                          softcap: float = 0.0):
    """The split pass of the paged-decode kernel: the slot's pages cut into
    splits of ``pages_per_split`` pages, and per (slot, KV head, split) the
    max ``m`` [B,K,S,G] of the visible scores, ``l = sum p`` [B,K,S,G] and
    ``acc = sum p v`` [B,K,S,G,D] with ``p = exp(s - m)``, all fp32.  A
    split with no visible key has ``m = NEG_INF``, ``l = 0``, ``acc = 0``.
    Visibility is :func:`paged_decode_attention`'s."""
    b, _, h, d = q.shape
    kh, ps = k_pages.shape[2], k_pages.shape[1]
    p = block_tables.shape[1]
    n_split = max(1, -(-p // pages_per_split))
    tables = torch.nn.functional.pad(
        block_tables, (0, n_split * pages_per_split - p), value=-1)
    sc, mask, vs = _paged_scores(q, k_pages, v_pages, tables, lengths,
                                 window, softcap)
    shape = (b, kh, h // kh, n_split, pages_per_split * ps)
    sc = sc.reshape(shape)
    mask = mask[:, None, None, :].expand(b, kh, h // kh, -1).reshape(shape)
    m = torch.where(mask, sc, NEG_INF).amax(dim=-1)                # [B,K,G,S]
    pr = torch.where(mask, torch.exp(sc - m[..., None]), 0.0)
    acc = torch.einsum("bkgst,bstkd->bkgsd", pr,
                       vs.reshape(b, n_split, pages_per_split * ps, kh, d))
    return (m.transpose(2, 3).contiguous(),
            pr.sum(dim=-1).transpose(2, 3).contiguous(),
            acc.transpose(2, 3).contiguous())


def paged_decode_merge(m, l, acc, dtype=torch.float32):
    """The merge pass: ``sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30)``
    with ``w_s = exp(m_s - max_s m_s)``, over the splits of m/l
    [B,K,S,G] and acc [B,K,S,G,D] -> [B,1,K*G,D] in ``dtype``.  A slot
    whose splits are all empty gives 0."""
    b, kh, _, g, d = acc.shape
    w = torch.exp(m - m.amax(dim=2, keepdim=True))
    den = torch.clamp_min((l * w).sum(dim=2), 1e-30)               # [B,K,G]
    out = (acc * w[..., None]).sum(dim=2) / den[..., None]
    return out.reshape(b, 1, kh * g, d).to(dtype)


def ssd_chunk_len(s: int, chunk: int) -> int:
    """The SSD chunk for a sequence of ``s`` tokens, ``min(chunk, s)``, as
    the reference takes it; raises unless it divides ``s`` (the reference
    asserts the same and does not pad)."""
    if s < 1 or chunk < 1:
        raise ValueError(f"ssd_scan: need S >= 1 and chunk >= 1, got S = {s}, "
                         f"chunk = {chunk}")
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd_scan: S = {s} is not a multiple of the chunk "
                         f"{chunk} (the reference keeps this limit and does "
                         f"not pad)")
    return chunk


def ssd_scan(x, dt, a, b, c, d_skip, *, initial_state=None):
    """Mamba-2 SSD recurrence, one token at a time.  x [B,S,H,P]; dt
    [B,S,H]; a [H] (negative); b/c [B,S,N]; d_skip [H]; ``initial_state``
    [B,H,N,P] or None (zeros).  Per token
    ``h = exp(a dt) h + dt B x^T`` and ``y = C h + D x``, in fp32.  Returns
    ``(y [B,S,H,P] in x's dtype, final state [B,H,N,P] fp32)``; the D-skip
    is added in fp32 before the one rounding to x's dtype."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    af = a.float()
    hstate = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                          device=x.device) if initial_state is None
              else initial_state.float())
    ys = []
    for t in range(s):
        dtt = dtf[:, t]                                       # [B,H]
        decay = torch.exp(af * dtt)[..., None, None]          # [B,H,1,1]
        inject = (dtt[..., None, None] * bf[:, t, None, :, None]
                  * xf[:, t, :, None, :])                     # [B,H,N,P]
        hstate = decay * hstate + inject
        ys.append(torch.einsum("bhnp,bn->bhp", hstate, cf[:, t]))
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((bsz, 0, h, p), dtype=torch.float32, device=x.device))
    y = y + xf * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), hstate


#: tokens per chunk of the scan kernel's passes (independent of the
#: caller's ``chunk``, which only has to divide S)
SSD_BLOCK = 64


def _ssd_blocks(x, dt, a, b):
    """x, dt, b in fp32, padded with zero tokens to whole blocks of
    ``SSD_BLOCK`` and cut into them ([B,nc,L,H,P], [B,nc,L,H], [B,nc,L,N]),
    and ``cum``, the running sum of ``a dt`` inside each block [B,nc,L,H].
    Zero tokens (dt 0, B 0, x 0) add no decay and no input."""
    bsz, s, h, p = x.shape
    block = SSD_BLOCK
    nc = -(-s // block)
    pad = nc * block - s
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    bf = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    xf = xf.reshape(bsz, nc, block, h, p)
    dtf = dtf.reshape(bsz, nc, block, h)
    bf = bf.reshape(bsz, nc, block, -1)
    cum = torch.cumsum(a.float() * dtf, dim=2)
    return xf, dtf, bf, cum


def ssd_chunk_states(x, dt, a, b):
    """The chunk pass: per block of ``SSD_BLOCK`` tokens and head, the state the
    block alone leaves, ``dS = sum_s B_s^T (exp(cum_L - cum_s) dt_s x_s)``
    [B,nc,H,N,P], and its decay ``exp(cum_L)`` [B,nc,H], both fp32."""
    xf, dtf, bf, cum = _ssd_blocks(x, dt, a, b)
    w_out = torch.exp(cum[:, :, -1:] - cum) * dtf              # [B,nc,L,H]
    dstate = torch.einsum("bcsn,bcshp->bchnp", bf, w_out[..., None] * xf)
    return dstate.contiguous(), torch.exp(cum[:, :, -1])


def ssd_state_passing(dstate, decay):
    """The state pass: ``S_in[0] = 0``, ``S_in[c] = decay[c-1] S_in[c-1] +
    dS[c-1]`` -> ``(S_in [B,nc,H,N,P], final state [B,H,N,P])``, fp32; the
    final state is ``decay[nc-1] S_in[nc-1] + dS[nc-1]``."""
    state = torch.zeros_like(dstate[:, 0])
    s_in = []
    for c in range(dstate.shape[1]):
        s_in.append(state)
        state = decay[:, c, :, None, None] * state + dstate[:, c]
    return torch.stack(s_in, dim=1), state


def ssd_chunk_outputs(x, dt, a, b, c, d_skip, s_in):
    """The output pass: per block and head ``y = diag(exp(cum)) C S_in +
    (G o mask) x + D x`` with ``G = C B^T`` and mask ``exp(cum_t - cum_s)
    dt_s`` for s <= t (0 above the diagonal, by a select: exp overflows
    there), in fp32, rounded once to x's dtype -> y [B,S,H,P]."""
    bsz, s, h, p = x.shape
    block = SSD_BLOCK
    xf, dtf, bf, cum = _ssd_blocks(x, dt, a, b)
    cf = _ssd_blocks(x, dt, a, c)[2]
    gram = torch.einsum("bctn,bcsn->bcts", cf, bf)             # [B,nc,L,L]
    causal = torch.tril(torch.ones((block, block), dtype=torch.bool,
                                   device=x.device))[:, :, None]
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [..,t,s,H]
    m = gram[..., None] * torch.exp(torch.where(causal, dec, -torch.inf))
    m = m * dtf[:, :, None, :, :]
    y = torch.einsum("bctn,bchnp->bcthp", cf, s_in) * torch.exp(cum)[..., None]
    y = y + torch.einsum("bctsh,bcshp->bcthp", m, xf)
    y = y + xf * d_skip.float()[None, None, None, :, None]
    return y.reshape(bsz, -1, h, p)[:, :s].to(x.dtype)


def ssd_scan_passes(x, dt, a, b, c, d_skip):
    """The three passes composed: the chunk-parallel form of
    :func:`ssd_scan` -> ``(y [B,S,H,P] in x's dtype, final state [B,H,N,P]
    fp32)``."""
    s_in, final = ssd_state_passing(*ssd_chunk_states(x, dt, a, b))
    return ssd_chunk_outputs(x, dt, a, b, c, d_skip, s_in), final
