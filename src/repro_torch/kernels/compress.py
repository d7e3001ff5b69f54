"""Launch wrappers of the CUDA compressed-gossip kernels.

The kernels live in ``csrc/compress.cu`` (built and bound by
``kernels/build.py``); each replaces one Pallas kernel of
``repro/kernels/compress.py``:

  * ``gamma_correct``        the CHOCO/EF post-exchange correction
    ``x + gamma*(mixed - anchor)`` in one pass over the packed tree;
  * ``threshold_mask``       top-k's mask and residual on ``[rows, f]``,
    ``q = x*[|x| >= thr_row]``, ``r = x - q`` (the per-row k-th magnitude
    is computed outside, as in the reference);
  * ``quantize_dequantize``  QSGD's stochastic quantize -> dequantize and
    residual on ``[rows, f]``, with the uniform noise ``u`` an operand;
  * ``choco_exchange``  on the compressed-gossip path, the replica advance
    ``x_hat + q``, the dense mix of the anchors, ``gamma_correct`` and the
    QG refresh that follows the round (``fused_qg_buffer`` of
    ``repro/kernels/qg_update.py``) of a whole tree in one launch (one per
    ``MAX_LEAVES`` leaves), unpacked, over ``qg_update``'s column tiles of
    all n nodes (``exchange_plan`` lays out the kernel's leaf table).

The two row-wise kernels take a whole message at once:
``threshold_mask_group`` and ``quantize_dequantize_group`` launch one
kernel for up to ``MAX_LEAVES`` leaves (more take ``ceil(n / MAX_LEAVES)``
launches); ``threshold_mask`` and ``quantize_dequantize`` are the one-leaf
case.  The launch geometry is laid out here (``group_plan``, ``row_split``)
and passed to the kernel in its leaf table; the kernel's own copy of the
tile sizes is checked against this one when the library is bound.

Every wrapper takes CUDA tensors only, checks them (device, fp32,
contiguity, shapes), allocates its outputs with ``torch.empty`` and launches
on the current stream; ``kernels/ops.py`` routes CPU tensors to the plain
versions instead.  ``LAUNCHES`` counts the launches of each kernel;
``ROW_PATHS`` counts the leaves the row-wise kernels ran on their float4
path and on their scalar loop, ``EXCHANGE_PATHS`` those of
``choco_exchange``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build as _build
from .qg_update import (STEP_COLS, STEP_MAX_NODES, _views, qg_step_plan,
                        step_operands)

__all__ = ["gamma_correct", "threshold_mask", "quantize_dequantize",
           "threshold_mask_group", "quantize_dequantize_group",
           "choco_exchange", "exchange_plan", "group_plan", "row_split",
           "tiles_per_row", "MAX_LEAVES", "TILE_VECS", "TILE", "PEELS",
           "EXCHANGE_FIELDS", "LAUNCHES", "ROW_PATHS", "EXCHANGE_PATHS"]

#: launches of each kernel in this process (bumped once per kernel launch)
LAUNCHES = {"gamma_correct": 0, "threshold_mask": 0,
            "quantize_dequantize": 0, "choco_exchange": 0}
#: leaves launched by the row-wise kernels, by path: ``vector`` (head,
#: float4 body, tail) or ``scalar`` (the scalar loop)
ROW_PATHS = {"vector": 0, "scalar": 0}
#: leaves launched by ``choco_exchange``, by path: ``vector`` (float4) or
#: ``scalar`` (the scalar loop)
EXCHANGE_PATHS = {"vector": 0, "scalar": 0}

#: leaves a row-wise launch takes (``kMaxLeaves`` of
#: ``csrc/elementwise.cuh``: the leaf table, a kernel parameter, stays
#: within 4 KB)
MAX_LEAVES = 48
#: float4 of a row's body a tile covers (256 threads x 2), and elements a
#: tile of the scalar loop covers (``kTileVecs``, ``kTile``)
TILE_VECS = 256 * 2
TILE = 4 * TILE_VECS
#: int64 fields of a leaf in the table (``kLeafFields``)
LEAF_FIELDS = 9
#: the boundaries, in bytes, a vector row's head may be peeled to: 128 (the
#: default: whole 128-byte lines for the body) or 16 (the least float4
#: needs), kept to time the two against each other
PEELS = (128, 16)
#: int64 fields of a leaf in ``choco_exchange``'s table
#: (``kExchangeFields``: half, x_hat, q, x_pre, m_hat, out, f, tile0, vec);
#: its tiles are ``qg_step``'s, ``STEP_COLS`` columns of all n <=
#: ``STEP_MAX_NODES`` nodes, ``MAX_LEAVES`` leaves a launch
EXCHANGE_FIELDS = 9
#: the input roles of a leaf in that table, in order
EXCHANGE_INPUTS = ("half", "x_hat", "q", "x_pre", "m_hat")

_P, _N, _F, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, \
    ctypes.c_int
_SIGNATURES = {
    "cmp_gamma_correct": [_P, _P, _P, _P, _N, _F, _P],
    "cmp_threshold_mask_group": [_P, _I, _N, _P],
    "cmp_quantize_dequantize_group": [_P, _I, _N, _F, _P],
    "cmp_rowwise_geometry": [_P],
    "cmp_choco_exchange": [_P, _I, _N, _I, _P, _P, _P, _P, _P, _P, _F, _F,
                           _F, _P],
    "cmp_exchange_geometry": [_P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The typed library handle, built on the first CUDA launch; raises
    if the kernel's tile sizes are not the ones ``group_plan`` and
    ``exchange_plan`` lay out."""
    lib = _build.bind("compress", _SIGNATURES, "cmp_error_string")
    for what, fn, want in (
            ("row-wise", lib.cmp_rowwise_geometry,
             (TILE_VECS, TILE, MAX_LEAVES, LEAF_FIELDS)),
            ("exchange", lib.cmp_exchange_geometry,
             (STEP_COLS, MAX_LEAVES, EXCHANGE_FIELDS, STEP_MAX_NODES))):
        geometry = (ctypes.c_int64 * 4)()
        fn(geometry)
        if tuple(geometry) != want:
            raise RuntimeError(f"compress: the kernel's {what} geometry "
                               f"{tuple(geometry)} is not the wrapper's "
                               f"{want}")
    return lib


def _run(kernel: str, fn: str, dev: torch.device, *args) -> None:
    _build.launch(_lib(), "cmp_error_string", LAUNCHES, kernel, fn, dev,
                  *args)


def gamma_correct(x, mixed, anchor, *, gamma: float):
    """``x + gamma*(mixed - anchor)``; ``gamma`` is folded to fp32."""
    dev = _build.check_operands(
        "gamma_correct", {"x": x, "mixed": mixed, "anchor": anchor})
    out = torch.empty_like(x)
    if out.numel():
        _run("gamma_correct", "cmp_gamma_correct", dev, x.data_ptr(),
             mixed.data_ptr(), anchor.data_ptr(), out.data_ptr(),
             out.numel(), gamma)
    return out


# ---------------------------------------------------------------------------
# the row-wise kernels: launch geometry
# ---------------------------------------------------------------------------

def row_split(addr: int, f: int,
              peel: int = PEELS[0]) -> tuple[int, int, int]:
    """``(head, body, tail)`` of a row of ``f`` fp32 elements at byte
    address ``addr`` on the float4 path: ``head`` scalar elements up to the
    first ``peel``-byte boundary (0-31 at 128, 0-3 at 16), ``body`` float4,
    then ``tail`` (0-3) scalar elements.  The kernel splits each row so."""
    head = min((peel - addr % peel) % peel // 4, f)
    body = (f - head) // 4
    return head, body, f - head - 4 * body


def tiles_per_row(f: int, vec: bool) -> int:
    """Tiles a row of ``f`` elements takes: ``TILE_VECS`` float4 of its body
    a tile (at least one tile, which also does the head and tail), or
    ``TILE`` elements a tile on the scalar loop."""
    if vec:
        return max(1, -(-(f // 4) // TILE_VECS))
    return -(-f // TILE)


def group_plan(leaves) -> list[tuple[list[tuple[int, int, int]], int]]:
    """The launches of a grouped call over ``leaves``, a list of ``(rows,
    f, vec)`` (none empty): ``[(entries, tiles), ...]``, one per
    ``MAX_LEAVES`` leaves, where ``entries`` lists ``(leaf index, first
    tile, tiles a row)`` and ``tiles`` counts the launch's tiles.  A block
    of the kernel finds its leaf by the first tiles, its row and chunk by
    the tiles a row."""
    launches = []
    for start in range(0, len(leaves), MAX_LEAVES):
        entries, tiles = [], 0
        for i in range(start, min(start + MAX_LEAVES, len(leaves))):
            rows, f, vec = leaves[i]
            chunks = tiles_per_row(f, vec)
            entries.append((i, tiles, chunks))
            tiles += rows * chunks
        launches.append((entries, tiles))
    return launches


# ---------------------------------------------------------------------------
# the row-wise kernels: wrappers
# ---------------------------------------------------------------------------

def _rowwise_check(kernel: str, x2d, extra: dict, row: dict):
    if x2d.dim() != 2:
        raise ValueError(f"{kernel}: x2d must be [rows, f], got shape "
                         f"{tuple(x2d.shape)}")
    for name, t in extra.items():
        if isinstance(t, torch.Tensor) and t.shape != x2d.shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"x2d {tuple(x2d.shape)}")
    return _build.check_operands(kernel, {"x2d": x2d, **extra}, row,
                                 scalar_len=x2d.shape[0])


def _group(kernel: str, fn: str, x2ds, scalar: str, scalars, us, peel,
           *extra):
    """Check every leaf, allocate its outputs and launch ``fn`` over the
    table of each ``MAX_LEAVES`` non-empty leaves; ``[(q, r), ...]``."""
    n = len(x2ds)
    if len(scalars) != n or (us is not None and len(us) != n):
        raise ValueError(f"{kernel}: {n} leaves, {len(scalars)} {scalar}"
                         + ("" if us is None else f", {len(us)} u"))
    if peel not in PEELS:
        raise ValueError(f"{kernel}: peel must be one of {PEELS}, got "
                         f"{peel!r}")
    dev, outs, leaves, table = None, [], [], []
    for i, x2d in enumerate(x2ds):
        u = None if us is None else us[i]
        d = _rowwise_check(kernel, x2d, {} if u is None else {"u": u},
                           {scalar: scalars[i]})
        if dev is not None and d != dev:
            raise ValueError(f"{kernel}: leaf {i} is on {d}, leaf 0 on {dev}")
        dev = d
        q, r = torch.empty_like(x2d), torch.empty_like(x2d)
        outs.append((q, r))
        if not x2d.numel():
            continue
        streams = [x2d.data_ptr(), 0 if u is None else u.data_ptr(),
                   q.data_ptr(), r.data_ptr()]
        # the float4 path needs every stream at one address modulo 16
        vec = len({p % 16 for p in streams if p}) == 1
        leaves.append((*x2d.shape, vec))
        table.append(streams[:2] + [scalars[i].data_ptr()] + streams[2:])
    for entries, tiles in group_plan(leaves):
        fields = []
        for i, tile0, chunks in entries:
            _, f, vec = leaves[i]
            fields += [*table[i], f, tile0, chunks, peel if vec else 0]
            ROW_PATHS["vector" if vec else "scalar"] += 1
        _run(kernel, fn, dev, (ctypes.c_int64 * len(fields))(*fields),
             len(entries), tiles, *extra)
    return outs


def threshold_mask_group(x2ds, thrs, *, peel: int = PEELS[0]):
    """``[(q, r), ...]``, for each leaf ``x2d`` [rows, f] with ``thr``
    [rows], ``q = x*[|x| >= thr[row]]`` and ``r = x - q``: one launch for
    every ``MAX_LEAVES`` leaves, vector rows peeled to ``peel`` bytes."""
    return _group("threshold_mask", "cmp_threshold_mask_group", x2ds, "thr",
                  thrs, None, peel)


def quantize_dequantize_group(x2ds, scales, us, *, levels: int,
                              peel: int = PEELS[0]):
    """QSGD ``[(q, r), ...]`` for each leaf ``x2d`` [rows, f] with its
    ``scale`` [rows] and uniform noise ``u`` [rows, f]; ``levels`` =
    2^bits - 1.  One launch for every ``MAX_LEAVES`` leaves, vector rows
    peeled to ``peel`` bytes."""
    return _group("quantize_dequantize", "cmp_quantize_dequantize_group",
                  x2ds, "scale", scales, us, peel, float(levels))


def threshold_mask(x2d, thr):
    """``(q, r)`` with ``q = x*[|x| >= thr[row]]`` and ``r = x - q``;
    ``x2d`` [rows, f], ``thr`` [rows]: the one-leaf group."""
    return threshold_mask_group([x2d], [thr])[0]


def quantize_dequantize(x2d, scale, u, *, levels: int):
    """QSGD ``(q, r)`` on ``x2d`` [rows, f] with ``scale`` [rows] and the
    uniform noise ``u`` [rows, f]; ``levels`` = 2^bits - 1: the one-leaf
    group."""
    return quantize_dequantize_group([x2d], [scale], [u], levels=levels)[0]


# ---------------------------------------------------------------------------
# choco_exchange: the exchange half of a compressed round in one launch
# ---------------------------------------------------------------------------

def exchange_plan(leaves) -> list[tuple[list[list[int]], int]]:
    """The launches of ``choco_exchange`` over ``leaves``, a list of ``(f,
    ins, out)`` (none empty): ``f`` columns, ``ins`` the byte addresses of
    the leaf's ``EXCHANGE_INPUTS`` (0 for a role the form does not read)
    and ``out`` its first element in every output buffer.  Returns
    ``[(rows, tiles), ...]``, one per ``MAX_LEAVES`` leaves, ``rows`` the
    kernel's leaf table, ``EXCHANGE_FIELDS`` ints a leaf (``*ins, out, f,
    tile0, vec``), and ``tiles`` the launch's tiles of ``STEP_COLS``
    columns, as ``qg_update.qg_step_plan`` cuts them.  A leaf runs on
    float4 when ``f % 4 == 0``, every input it reads starts on 16 bytes and
    so does ``out`` (each output buffer does: ``4 * out`` stands for the
    outputs' addresses)."""
    plan = qg_step_plan([(f, [a for a in ins if a] + [4 * out])
                         for f, ins, out in leaves])
    return [([[*leaves[i][1], leaves[i][2], leaves[i][0], tile0, int(vec)]
              for i, tile0, vec in entries], tiles)
            for entries, tiles in plan]


def choco_exchange(halves, qs, w, *, gamma: float, x_hats=None,
                   x_pres=None, m_hats=None, eta=None, refresh=None,
                   mu: float | None = None):
    """``(x_out, x_hat_new, m_out)``, lists of the leaves of the exchange
    half of one compressed gossip round on the dense mix: for each leaf [n,
    ...] of ``halves`` (the tree the mix hook receives) with the
    compressor's ``qs``, the anchor ``a = x_hat + q`` (CHOCO, ``x_hats``
    given: ``x_hat_new`` is a, the site's new replicas) or ``a = q`` (EF:
    ``x_hat_new`` is None), ``x_out = half + gamma*(W @ a - a)`` with the
    mix along the nodes, and, in the QG form (``mu`` given),
    ``m_out = fused_qg_buffer(x_pre, x_out, m_hat, eta, refresh, mu=mu)``
    (else None).  ``gamma`` is folded to fp32; ``w`` is the fp32 [n, n]
    mixing matrix, ``eta`` and ``refresh`` fp32 [1] tensors, all on the
    leaves' CUDA device; n is at most ``STEP_MAX_NODES``."""
    choco, qg = x_hats is not None, mu is not None
    if qg and any(v is None for v in (x_pres, m_hats, eta, refresh)):
        raise ValueError("choco_exchange: the QG form (mu given) needs "
                         "x_pres, m_hats, eta and refresh")
    roles = {"half": halves, "q": qs, **({"x_hat": x_hats} if choco else {}),
             **({"x_pre": x_pres, "m_hat": m_hats} if qg else {})}
    checked = step_operands("choco_exchange", roles, w,
                            {"eta": eta, "refresh": refresh} if qg else {})
    if checked is None:
        return [], [] if choco else None, [] if qg else None
    dev, nodes = checked
    shapes = [h.shape for h in halves]
    x_out = _views(shapes, dev)
    x_hat_new = _views(shapes, dev) if choco else None
    m_out = _views(shapes, dev) if qg else None
    base = x_out[0].untyped_storage().data_ptr()
    live = [i for i, h in enumerate(halves) if h.numel()]
    plan = exchange_plan([
        (halves[i].numel() // nodes,
         [roles[r][i].data_ptr() if r in roles else 0
          for r in EXCHANGE_INPUTS], (x_out[i].data_ptr() - base) // 4)
        for i in live])
    outs = [None if v is None else v[0].untyped_storage().data_ptr()
            for v in (x_out, x_hat_new, m_out)]
    for rows, tiles in plan:
        for row in rows:
            EXCHANGE_PATHS["vector" if row[-1] else "scalar"] += 1
        fields = [x for row in rows for x in row]
        _run("choco_exchange", "cmp_choco_exchange", dev,
             (ctypes.c_int64 * len(fields))(*fields), len(rows), tiles,
             nodes, *outs, w.data_ptr(), eta.data_ptr() if qg else None,
             refresh.data_ptr() if qg else None, gamma, mu if qg else 0.0,
             1.0 - mu if qg else 0.0)
    return x_out, x_hat_new, m_out
