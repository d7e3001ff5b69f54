"""Roofline analysis from traced dry-run steps.

Port of ``repro/launch/roofline.py``.  A step is traced on the ``meta``
device (shapes only, nothing allocated or computed) under two counters:

  flops           ``torch.utils.flop_counter.FlopCounterMode``: matrix
                  products, attention and convolutions only.  XLA's
                  ``cost_analysis`` counts every flop, elementwise work too,
                  so the two packages' counts of one step differ by that
                  elementwise share.
  bytes_accessed  the sum of every traced operation's input and output
                  bytes (views move nothing and are skipped): each operation
                  reads its inputs from and writes its outputs to memory,
                  as an unfused eager step does.
  collective_bytes the gossip a rank puts on the wire a step, from the
                  compiled schedule (:func:`wire_bytes`).

Terms, per rank (one node a rank, so a rank's share of a node-stacked
trace is one node's):

  compute_t    = flops / peak(dtype)
  memory_t     = bytes_accessed / hbm_bw
  collective_t = collective_bytes / link_bw

on a :class:`Hardware` record: :data:`H100` for the port, :data:`V5E` (the
reference's constants) for the reference's rows.  The dry run traces the
1- and 2-period probes and extrapolates linearly, as the reference does:

  total(T) = probe1 + (T - 1) * max(0, probe2 - probe1)

which is exact here for costs linear in depth: the port runs every period
in turn, so a trace counts each one.  The reference's HLO readers
(``parse_collectives`` and ``cost_analysis_dict``, which read XLA's
compiled text and cost dict) have no counterpart: there is no compiled
program to read.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["Hardware", "V5E", "H100", "PEAK_FLOPS", "HBM_BW", "ICI_BW",
           "ProbeCost", "collective_detail", "wire_bytes", "trace_cost",
           "mix_flops", "extrapolate", "roofline_terms", "model_flops",
           "summarize"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    """A device's roofline figures.  ``peak_flops`` by dtype name
    (``"any"`` covers every dtype the record does not name)."""

    name: str
    peak_flops: dict
    hbm_bw: float               # bytes/s
    link_bw: float              # bytes/s each way, one link
    hbm_bytes: float
    source: str

    def peak(self, dtype=None) -> float:
        key = str(dtype).replace("torch.", "") if dtype is not None else "any"
        if key in self.peak_flops:
            return self.peak_flops[key]
        return self.peak_flops["any"]


#: the reference's hardware model (its task sheet): for its rows only
V5E = Hardware("tpu-v5e", {"any": 197e12}, 819e9, 50e9, 16e9,
               "the reference's task sheet: 197 TFLOP/s bf16 a chip, "
               "819 GB/s HBM, ~50 GB/s a link of ICI")

#: the card: NVIDIA H100 SXM5 data sheet, dense rates (no sparsity), 700 W.
#: fp32 products run outside the tensor cores: the port turns TF32 off
#: (``device.resolve_device``)
H100 = Hardware("h100-sxm5",
                {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
                 "float32": 67e12, "any": 67e12},
                3.35e12, 450e9, 80e9,
                "NVIDIA H100 SXM5 data sheet, dense, 700 W: 989 TFLOP/s "
                "bf16, 495 TF32, 67 fp32; 3.35 TB/s HBM3, 80 GB; NVLink "
                "450 GB/s each way")

# the reference's module constants (V5E)
PEAK_FLOPS = V5E.peak_flops["any"]
HBM_BW = V5E.hbm_bw
ICI_BW = V5E.link_bw

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class ProbeCost:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    collective_detail: dict


def collective_detail(per_kind: dict | None = None) -> dict:
    """The reference's ``parse_collectives`` record from bytes by kind
    (the dense gossip is an all-gather, a compiled schedule's rounds
    collective-permutes)."""
    per_kind = {k: float((per_kind or {}).get(k, 0.0)) for k in _COLLECTIVES}
    return {"per_kind_bytes": per_kind,
            "counts": {k: int(per_kind[k] > 0) for k in _COLLECTIVES},
            "total_link_bytes": sum(per_kind.values())}


def wire_bytes(kind: str, *, n: int, node_bytes: float, sites: int,
               messages_per_step: float | None = None) -> dict:
    """Gossip bytes one node puts on the wire a step, by collective kind:
    ``api/build.wire_stats``'s arithmetic (one whole-tree transmission a
    mix site on the dense contraction; ``messages_per_step / n`` trees a
    site under a compiled schedule) times the tree's bytes
    (``node_bytes``, one node's params in their dtype).  One node: none."""
    if n <= 1 or sites == 0:
        return {}
    if kind == "dense":
        return {"all-gather": node_bytes * sites}
    return {"collective-permute":
            node_bytes * sites * messages_per_step / n}


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every operation's tensor inputs and outputs;
    views (which move nothing) are skipped."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in _pt_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def trace_cost(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), flops, bytes_accessed)`` of one call (on
    ``meta`` tensors for a dry run; on the card the same counters see the
    same operations, but not inside a hand-written kernel)."""
    bm = _BytesMode()
    with FlopCounterMode(display=False) as fc, bm:
        out = fn(*args, **kwargs)
    return out, float(fc.get_total_flops()), float(bm.bytes)


def mix_flops(n: int, per_node_elems: int) -> float:
    """The dense mix's products as the flop counter counts them
    (``W [n, n] @ x [n, P]``: 2 n n P), over ``per_node_elems`` elements a
    node: what a ``qg_step`` launch computes inside, where the counter
    cannot see it."""
    return 2.0 * n * n * per_node_elems


def extrapolate(p1: ProbeCost, p2: ProbeCost, n_periods: int) -> dict:
    """total(T) = p1 + (T-1) * max(0, p2 - p1), clamped as the
    reference's (its XLA probes could optimize the 2-period program harder
    than the 1-period one)."""
    t = n_periods

    def lin(a, b):
        return a + (t - 1) * max(0.0, b - a)

    per_kind = {
        k: lin(p1.collective_detail["per_kind_bytes"][k],
               p2.collective_detail["per_kind_bytes"][k])
        for k in _COLLECTIVES}
    return {
        "flops": lin(p1.flops, p2.flops),
        "bytes_accessed": lin(p1.bytes_accessed, p2.bytes_accessed),
        "collective_bytes": lin(p1.collective_bytes, p2.collective_bytes),
        "collective_per_kind": per_kind,
    }


def roofline_terms(costs: dict, *, hw: Hardware = H100,
                   dtype: Any = torch.bfloat16) -> dict:
    """The three terms on ``hw``, the compute one at its peak for
    ``dtype`` (the step's param dtype)."""
    ct = costs["flops"] / hw.peak(dtype)
    mt = costs["bytes_accessed"] / hw.hbm_bw
    xt = costs["collective_bytes"] / hw.link_bw
    dom = max(("compute", ct), ("memory", mt), ("collective", xt),
              key=lambda kv: kv[1])[0]
    return {
        "compute_s": ct,
        "memory_s": mt,
        "collective_s": xt,
        "bottleneck": dom,
        "step_s_lower_bound": max(ct, mt, xt),
    }


def model_flops(cfg, shape, *, n_chips: int) -> dict:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), D = tokens/step."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2
    else:
        tokens = shape.global_batch  # one token per sequence
        mult = 2
    n_active = cfg.n_active_params()
    return {
        "model_flops_total": mult * n_active * tokens,
        "model_flops_per_chip": mult * n_active * tokens / n_chips,
        "n_params": cfg.n_params(),
        "n_active_params": n_active,
    }


def summarize(cfg, shape, *, n_chips: int, probe1: ProbeCost,
              probe2: ProbeCost, n_periods: int, memory_analysis: str,
              extra: dict | None = None, hw: Hardware = H100,
              dtype: Any = torch.bfloat16) -> dict:
    costs = extrapolate(probe1, probe2, n_periods)
    terms = roofline_terms(costs, hw=hw, dtype=dtype)
    mf = model_flops(cfg, shape, n_chips=n_chips)
    useful = mf["model_flops_per_chip"] / max(costs["flops"], 1.0)
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "n_chips": n_chips,
        "costs_per_chip": costs,
        "roofline": terms,
        "model_flops": mf,
        "useful_flops_ratio": useful,
        "memory_analysis": memory_analysis,
        **(extra or {}),
    }
