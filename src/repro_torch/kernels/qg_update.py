"""Launch wrappers of the CUDA quasi-global momentum kernels.

The kernels live in ``csrc/qg_update.cu`` (built and bound by
``kernels/build.py``); each replaces one Pallas kernel of
``repro/kernels/qg_update.py``:

  * ``fused_halfstep``   weight decay + HeavyBall/QG-seeded momentum + the
    gossip half step in one pass, emitting the half step and, for stateful
    momentum (``emit_m``), the new buffer;
  * ``fused_qg_buffer``  the post-mix QG refresh behind the tau gate;
  * ``qg_local_step`` / ``qg_buffer_update``  the static-lr forms;
  * ``qg_step``  on the dense-gossip path, ``fused_halfstep``, the dense
    mix ``W @ half`` and ``fused_qg_buffer`` of a whole tree in one launch
    (one per ``MAX_LEAVES`` leaves), unpacked: each leaf [n, f] is cut
    into tiles of ``STEP_COLS`` columns of all n nodes, laid out here
    (``qg_step_plan``) and passed to the kernel in its leaf table.

The fused forms take the lr and the refresh gate as fp32 [1] device tensors
(a schedule value, read by the kernel, never by the host).  Every wrapper
takes CUDA tensors only, checks them (device, fp32, contiguity, equal
lengths), allocates its outputs with ``torch.empty`` and launches on the
current stream; ``kernels/ops.py`` routes CPU tensors to the plain versions
instead.  ``LAUNCHES`` counts the launches of each kernel, so that a run can
show that its main path went through them; ``STEP_PATHS`` counts the
leaves ``qg_step`` ran on its float4 path and on its scalar loop.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build as _build

__all__ = ["fused_halfstep", "fused_qg_buffer", "qg_local_step",
           "qg_buffer_update", "qg_step", "qg_step_plan", "step_operands",
           "step_vec",
           "STEP_COLS", "STEP_MAX_NODES", "MAX_LEAVES", "LAUNCHES",
           "STEP_PATHS"]

#: launches of each kernel in this process (bumped once per kernel launch)
LAUNCHES = {"fused_halfstep": 0, "fused_qg_buffer": 0, "qg_local_step": 0,
            "qg_buffer_update": 0, "qg_step": 0}
#: leaves launched by ``qg_step``, by path: ``vector`` (float4) or
#: ``scalar`` (the scalar loop)
STEP_PATHS = {"vector": 0, "scalar": 0}

#: ``qg_step``'s geometry (``kStepCols``, ``kMaxLeaves``, ``kStepFields``,
#: ``kStepMaxNodes`` of ``csrc/qg_update.cu``): columns of all n nodes a
#: tile, leaves a launch (the leaf table, a kernel parameter, stays within
#: 4 KB), int64 fields a leaf in the table and the most nodes (W and a
#: tile's half step, 32 KB at 64 nodes, sit in shared memory)
STEP_COLS = 64
MAX_LEAVES = 48
STEP_FIELDS = 8
STEP_MAX_NODES = 64

_P, _N, _F, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
_SIGNATURES = {
    "qg_fused_halfstep": [_P, _P, _P, _P, _P, _P, _N, _F, _F, _I, _I, _P],
    "qg_fused_qg_buffer": [_P, _P, _P, _P, _P, _P, _N, _F, _F, _P],
    "qg_local_step": [_P, _P, _P, _P, _N, _F, _F, _I, _P],
    "qg_buffer_update": [_P, _P, _P, _P, _N, _F, _F, _F, _P],
    "qg_step": [_P, _I, _N, _I, _P, _P, _P, _F, _F, _I, _I, _I, _F, _F, _P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The typed library handle, built on the first CUDA launch; raises
    if ``qg_step``'s geometry is not the one ``qg_step_plan`` lays out."""
    lib = _build.bind("qg_update", _SIGNATURES, "qg_error_string")
    lib.qg_step_geometry.argtypes = [_P]
    lib.qg_step_geometry.restype = None
    geometry = (ctypes.c_int64 * 4)()
    lib.qg_step_geometry(geometry)
    want = (STEP_COLS, MAX_LEAVES, STEP_FIELDS, STEP_MAX_NODES)
    if tuple(geometry) != want:
        raise RuntimeError(f"qg_update: the kernel's qg_step geometry "
                           f"{tuple(geometry)} is not the wrapper's {want}")
    return lib


def _run(kernel: str, fn: str, dev: torch.device, *args) -> None:
    _build.launch(_lib(), "qg_error_string", LAUNCHES, kernel, fn, dev, *args)


def fused_halfstep(x, m, g, eta, *, beta: float, wd: float = 0.0,
                   nesterov: bool = False, emit_m: bool = True):
    """``(half, m_new)`` with ``emit_m``, else ``half``; see the module
    docstring.  ``eta`` is a fp32 [1] CUDA tensor."""
    dev = _build.check_operands("fused_halfstep", {"x": x, "m": m, "g": g},
                                {"eta": eta})
    half = torch.empty_like(x)
    m_new = torch.empty_like(x) if emit_m else None
    if x.numel():
        _run("fused_halfstep", "qg_fused_halfstep", dev,
             x.data_ptr(), m.data_ptr(), g.data_ptr(), eta.data_ptr(),
             half.data_ptr(), m_new.data_ptr() if emit_m else None,
             x.numel(), beta, wd, int(nesterov), int(bool(wd)))
    return (half, m_new) if emit_m else half


def fused_qg_buffer(x_pre, x_post, m_hat, eta, refresh, *, mu: float):
    """``mu*m_hat + (1-mu)*(x_pre - x_post)/eta`` where ``refresh != 0``,
    else ``m_hat``.  ``eta`` and ``refresh`` are fp32 [1] CUDA tensors."""
    dev = _build.check_operands(
        "fused_qg_buffer", {"x_pre": x_pre, "x_post": x_post, "m_hat": m_hat},
        {"eta": eta, "refresh": refresh})
    out = torch.empty_like(m_hat)
    if out.numel():
        _run("fused_qg_buffer", "qg_fused_qg_buffer", dev,
             x_pre.data_ptr(), x_post.data_ptr(), m_hat.data_ptr(),
             eta.data_ptr(), refresh.data_ptr(), out.data_ptr(),
             out.numel(), mu, 1.0 - mu)
    return out


def qg_local_step(x, m_hat, g, *, eta: float, beta: float,
                  nesterov: bool = False):
    """``x - eta*(beta*m_hat + g)`` (Nesterov: ``x - eta*(g +
    beta*(beta*m_hat + g))``) with a static ``eta``."""
    dev = _build.check_operands("qg_local_step",
                                {"x": x, "m_hat": m_hat, "g": g})
    out = torch.empty_like(x)
    if out.numel():
        _run("qg_local_step", "qg_local_step", dev,
             x.data_ptr(), m_hat.data_ptr(), g.data_ptr(), out.data_ptr(),
             out.numel(), eta, beta, int(nesterov))
    return out


def qg_buffer_update(x_old, x_new, m_hat, *, eta: float, mu: float):
    """``mu*m_hat + (1-mu)*(x_old - x_new)/eta`` with a static ``eta``."""
    dev = _build.check_operands(
        "qg_buffer_update", {"x_old": x_old, "x_new": x_new, "m_hat": m_hat})
    out = torch.empty_like(m_hat)
    if out.numel():
        _run("qg_buffer_update", "qg_buffer_update", dev,
             x_old.data_ptr(), x_new.data_ptr(), m_hat.data_ptr(),
             out.data_ptr(), out.numel(), mu, 1.0 - mu, 1.0 / eta)
    return out


# ---------------------------------------------------------------------------
# qg_step: the dense-gossip step in one launch
# ---------------------------------------------------------------------------

def step_vec(f: int, addrs) -> bool:
    """Whether a leaf of ``f`` columns whose streams begin at byte addresses
    ``addrs`` runs on the float4 path: every row of every stream then
    starts on 16 bytes.  Any other leaf takes the scalar loop."""
    return f % 4 == 0 and all(a % 16 == 0 for a in addrs)


def qg_step_plan(leaves) -> list[tuple[list[tuple[int, int, bool]], int]]:
    """The launches of ``qg_step`` over ``leaves``, a list of ``(f,
    addrs)`` (none empty): ``[(entries, tiles), ...]``, one per
    ``MAX_LEAVES`` leaves, where ``entries`` lists ``(leaf index, first
    tile, vec)`` and ``tiles`` counts the launch's tiles, ``ceil(f /
    STEP_COLS)`` a leaf.  A block of the kernel finds its leaf by the first
    tiles."""
    launches = []
    for start in range(0, len(leaves), MAX_LEAVES):
        entries, tiles = [], 0
        for i in range(start, min(start + MAX_LEAVES, len(leaves))):
            f, addrs = leaves[i]
            entries.append((i, tiles, step_vec(f, addrs)))
            tiles += -(-f // STEP_COLS)
        launches.append((entries, tiles))
    return launches


def _views(shapes, dev):
    """One ``torch.empty`` buffer for the leaves of ``shapes`` and the
    leaves as views of it, each starting on 16 bytes."""
    offsets, total = [], 0
    for s in shapes:
        offsets.append(total)
        total += -(-s.numel() // 4) * 4
    buf = torch.empty(total, dtype=torch.float32, device=dev)
    return [buf[o:o + s.numel()].view(s) for o, s in zip(offsets, shapes)]


def step_operands(kernel: str, roles: dict, w, scalars: dict):
    """Check the operands of a step kernel (``qg_step``, or ``compress``'s
    ``choco_exchange``) before anything is built: ``roles`` maps each role
    to its list of leaves, one length for all, leaf i [n, ...] of one shape
    in every role with 1 <= n <= ``STEP_MAX_NODES``; ``w`` is the [n, n]
    mixing matrix and ``scalars`` fp32 [1] tensors; every operand is a
    contiguous fp32 tensor, all on one CUDA device.  Returns ``(device,
    n)``, or None for no leaves."""
    counts = {role: len(leaves) for role, leaves in roles.items()}
    if len(set(counts.values())) > 1:
        raise ValueError(f"{kernel}: leaves by role {counts}")
    tensors = [*(t for leaves in roles.values() for t in leaves), w,
               *scalars.values()]
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"{kernel}: operands lie on several devices: "
                         f"{sorted(map(str, devices))}")
    first = next(iter(roles.values()))
    if not first:
        return None
    nodes = first[0].shape[0] if first[0].dim() else 0
    if not 1 <= nodes <= STEP_MAX_NODES:
        raise ValueError(f"{kernel}: takes 1 to {STEP_MAX_NODES} nodes, got "
                         f"{nodes} (leaf 0 has shape {tuple(first[0].shape)})")
    if not isinstance(w, torch.Tensor) or tuple(w.shape) != (nodes, nodes):
        raise ValueError(f"{kernel}: w must be [{nodes}, {nodes}], got "
                         f"{getattr(w, 'shape', w)!r}")
    for i, leaf in enumerate(zip(*roles.values())):
        if len({t.shape for t in leaf}) > 1 or leaf[0].shape[:1] != (nodes,):
            raise ValueError(
                f"{kernel}: leaf {i} has shapes "
                f"{ {r: tuple(t.shape) for r, t in zip(roles, leaf)} }; want "
                f"one shape with {nodes} nodes first")
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.dtype != torch.float32:
            raise TypeError(f"{kernel}: every operand must be float32, got "
                            f"{t.dtype}")
    dev = _build.check_operands(kernel, {"w": w}, scalars)
    for leaf in zip(*roles.values()):
        _build.check_operands(kernel, dict(zip(roles, leaf)))
    return dev, nodes


def qg_step(xs, ms, gs, w, eta, refresh=None, *, beta: float,
            wd: float = 0.0, nesterov: bool = False, mu: float | None = None):
    """``(x_new, m_out)``, lists of the leaves of one optimizer step on the
    dense-gossip path: for each leaf [n, ...] of ``xs`` with its buffer
    ``ms`` and gradient ``gs``, ``x_new = W @ half`` along the nodes, where
    ``half`` is ``fused_halfstep``'s, and ``m_out`` the DSGDm buffer
    ``beta*m + ge`` (``mu`` None) or, in the QG form (``m`` is m_hat),
    ``fused_qg_buffer(x, x_new, m_hat, eta, refresh, mu=mu)``.  ``w`` is the
    fp32 [n, n] mixing matrix, ``eta`` and ``refresh`` fp32 [1] tensors,
    all on the leaves' CUDA device; n is at most ``STEP_MAX_NODES``."""
    qg = mu is not None
    if qg and refresh is None:
        raise ValueError("qg_step: the QG form (mu given) needs refresh")
    checked = step_operands(
        "qg_step", {"x": xs, "m": ms, "g": gs}, w,
        {"eta": eta, **({"refresh": refresh} if qg else {})})
    if checked is None:
        return [], []
    dev, nodes = checked
    shapes = [x.shape for x in xs]
    x_new, m_out = _views(shapes, dev), _views(shapes, dev)
    live = [i for i, x in enumerate(xs) if x.numel()]
    streams = [(xs[i], ms[i], gs[i], x_new[i], m_out[i]) for i in live]
    plan = qg_step_plan([(xs[i].numel() // nodes,
                          [t.data_ptr() for t in s])
                         for i, s in zip(live, streams)])
    for entries, tiles in plan:
        fields = []
        for j, tile0, vec in entries:
            fields += [t.data_ptr() for t in streams[j]]
            fields += [xs[live[j]].numel() // nodes, tile0, int(vec)]
            STEP_PATHS["vector" if vec else "scalar"] += 1
        _run("qg_step", "qg_step", dev,
             (ctypes.c_int64 * len(fields))(*fields), len(entries), tiles,
             nodes, w.data_ptr(), eta.data_ptr(),
             refresh.data_ptr() if qg else None, beta, wd, int(nesterov),
             int(bool(wd)), int(qg), mu if qg else 0.0,
             1.0 - mu if qg else 0.0)
    return x_new, m_out
