"""Metric collectors run inside the decentralized step.

Port of ``repro/telemetry/metrics.py``.  A *collector* is a function of one
step's inputs and outputs on the node-stacked layout ``[n, ...]``:

    collector(ctx: CollectorCtx) -> dict[str, fp32 0-d tensor]

Its outputs are fully node-reduced scalars on the step's device, and its
key set is fixed for a run (it may depend on the optimizer's state
structure, one alignment key per momentum buffer, never on values), so
every on-cadence step emits the same row.  Collectors read the ctx and
mutate nothing.  Node reductions go through the ctx's ``node_mean``,
``node_sum`` and ``node_max``, as in the reference: on the node-stacked
layout they are plain reductions over axis 0; with a ``mesh`` (the sharded
and hybrid backends, whose leaves hold this rank's block of the nodes)
they reduce over the ranks, a per-node value gathered to ``[n]`` first, so
that every rank emits the vmap row.

``METRICS`` is the registry a :class:`MetricsSpec` selects from;
:func:`resolve_config` turns the ``TelemetrySpec`` fields into the
:class:`TelemetryConfig` the trainer threads into its runtime.  Under a
scenario (``CollectorCtx.alive``) ``grad_norms`` covers the participating
nodes only and ``scenario`` adds ``alive_frac``; without one both emit
what they emit without it.  Under ``overlap='delayed_1'`` ``staleness``
emits ``staleness_gap``, and nothing without the overlap.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import tree_flatten, tree_leaves

__all__ = [
    "CollectorCtx", "MetricsSpec", "TelemetryConfig", "METRICS",
    "DEFAULT_METRICS", "resolve_config", "TM_PREFIX",
]

#: metric keys emitted by the step carry this prefix, so the host-side
#: recorder splits them off the user-facing metrics (history keeps the
#: telemetry-free key set)
TM_PREFIX = "tm."

_EPS = 1e-12


@dataclasses.dataclass
class CollectorCtx:
    """Everything a collector may read about one decentralized step.

    ``static`` carries host-side constants resolved once at build time
    (spectral gap, wire bits, kernel bytes); a collector whose static key
    is missing returns ``{}``.  ``device`` is where the step's tensors
    live (constants are filled there, never copied from the host).
    ``alive`` is the scenario's ``[n]`` update mask this step (None
    without a scenario)."""

    grads: Any                     # per-node gradients
    params_old: Any                # params entering the step
    params_new: Any                # params leaving the step (post-mix)
    opt_state_old: dict
    opt_state_new: dict
    comm_state_old: Any
    comm_state_new: Any
    lr: Any
    t: Any                         # step counter (device tensor)
    n_nodes: int
    static: dict
    device: Any = None
    alive: Any = None
    mesh: Any = None               # node axis of block-sharded leaves
    mix_buf_old: Any = None        # overlap: exchange buffers in and out
    mix_buf_new: Any = None
    _flat: dict = dataclasses.field(default_factory=dict, repr=False)

    # -- node reductions and shared per-node helpers -------------------------
    def _all(self, x: torch.Tensor) -> torch.Tensor:
        """A per-node ``[b]`` quantity as the ``[n]`` one, node order."""
        return x if self.mesh is None else self.mesh.gather_nodes(x)

    def node_mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over nodes of a per-node ``[n]`` quantity."""
        return torch.mean(self._all(x))

    def node_max(self, x: torch.Tensor) -> torch.Tensor:
        """Max over nodes of a per-node ``[n]`` quantity."""
        return torch.max(self._all(x))

    def node_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over this device's nodes, summed over all nodes."""
        return x if self.mesh is None else self.mesh.all_reduce(x)

    def flat(self, tree) -> torch.Tensor:
        """A node-stacked tree's leaves side by side, fp32 ``[n, P]``: one
        copy, then one reduction for the whole tree where a reduction a
        leaf would launch hundreds of kernels on a deep model (kept for
        the step, by tree)."""
        if id(tree) not in self._flat:
            leaves = tree_leaves(tree)
            n = leaves[0].shape[0]
            self._flat[id(tree)] = (tree, torch.cat(
                [l.reshape(n, -1).to(torch.float32) for l in leaves], 1))
        return self._flat[id(tree)][1]

    def per_node_sq_norm(self, tree) -> torch.Tensor:
        """Per-node squared L2 norm over a whole tree: ``[n]``."""
        f = self.flat(tree)
        return torch.sum(f * f, dim=-1)

    def col_mean(self, f: torch.Tensor) -> torch.Tensor:
        """The node mean ``[1, P]`` of a flat ``[n, P]`` (``[b, P]``)."""
        if self.mesh is None:
            return torch.mean(f, dim=0, keepdim=True)
        return self.node_sum(torch.sum(f, dim=0, keepdim=True)) \
            / self.n_nodes

    def consensus(self, tree) -> torch.Tensor:
        """``core.gossip.consensus_distance`` of ``tree``, over its flat
        form."""
        f = self.flat(tree)
        dev = f - self.col_mean(f)
        return torch.sqrt(self.node_sum(torch.sum(dev * dev))
                          / (self.n_nodes * f.shape[1]))

    def node_std(self, x: torch.Tensor) -> torch.Tensor:
        """Std over nodes of a per-node scalar array."""
        m = self.node_mean(x)
        m2 = self.node_mean(x.to(torch.float32) ** 2)
        return torch.sqrt(torch.clamp(m2 - m ** 2, min=0.0))

    def const(self, value: float) -> torch.Tensor:
        """A build-time constant as a fp32 0-d tensor on the device."""
        return torch.full((), float(value), dtype=torch.float32,
                          device=self.device)


# ---------------------------------------------------------------------------
# collectors
# ---------------------------------------------------------------------------

def _consensus(ctx: CollectorCtx) -> dict:
    """Consensus distance before and after the step (Fig. 3's quantity)."""
    return {"consensus_pre": ctx.consensus(ctx.params_old),
            "consensus_post": ctx.consensus(ctx.params_new)}


def _grad_norms(ctx: CollectorCtx) -> dict:
    """Per-node gradient-norm spread: a large std/max against the mean is
    the heterogeneity signature.  Under a scenario the statistics cover the
    participating nodes only: a dropped node's gradient is discarded by the
    hold, so it never touched the trajectory."""
    norms = torch.sqrt(ctx.per_node_sq_norm(ctx.grads))
    if ctx.alive is None:
        return {"grad_norm_mean": ctx.node_mean(norms),
                "grad_norm_std": ctx.node_std(norms),
                "grad_norm_max": ctx.node_max(norms)}
    a = ctx.alive.to(torch.float32)
    cnt = torch.clamp(ctx.node_sum(torch.sum(a)), min=1.0)
    mean = ctx.node_sum(torch.sum(a * norms)) / cnt
    m2 = ctx.node_sum(torch.sum(a * norms ** 2)) / cnt
    return {"grad_norm_mean": mean,
            "grad_norm_std": torch.sqrt(torch.clamp(m2 - mean ** 2,
                                                    min=0.0)),
            "grad_norm_max": ctx.node_max(torch.where(a > 0, norms,
                                                      torch.zeros_like(
                                                          norms)))}


def _alignment(ctx: CollectorCtx) -> dict:
    """Cosine alignment of every momentum-family buffer (a stage state with
    an ``m``, ``m_hat`` or ``y`` tree) against the node-mean gradient, one
    ``align_<stage>`` key each, node-averaged: the paper's diagnostic (local
    momentum decorrelates from the global direction under heterogeneity;
    the quasi-global buffer stays aligned)."""
    g_bar = ctx.col_mean(ctx.flat(ctx.grads))
    g_bar_sq = torch.sum(g_bar * g_bar)
    out = {}
    for stage, st in sorted(ctx.opt_state_new.items()):
        if not isinstance(st, dict):
            continue
        buf = next((st[k] for k in ("m", "m_hat", "y") if k in st), None)
        if buf is None:
            continue
        dot = torch.sum(ctx.flat(buf) * g_bar, dim=-1)
        denom = torch.sqrt(ctx.per_node_sq_norm(buf) * g_bar_sq) + _EPS
        out[f"align_{stage}"] = ctx.node_mean(dot / denom)
    return out


def _comm_buffers(ctx: CollectorCtx) -> dict:
    """Compressed-comm sites: EF14 residual norms and CHOCO replica norms,
    one key per mix site, node-averaged."""
    sites = ctx.comm_state_new
    if not sites:
        return {}
    out = {}
    for i, site in enumerate(sites):
        if "residual" in site:
            norms = torch.sqrt(ctx.per_node_sq_norm(site["residual"]))
            out[f"ef_residual_norm_{i}"] = ctx.node_mean(norms)
        elif "x_hat" in site:
            norms = torch.sqrt(ctx.per_node_sq_norm(site["x_hat"]))
            out[f"choco_replica_norm_{i}"] = ctx.node_mean(norms)
    return out


def _wire(ctx: CollectorCtx) -> dict:
    """Bits on the wire per node and step (``api.build.wire_stats``), and
    under a compiled schedule its point-to-point messages a step, replayed
    into every row so that a stream describes itself."""
    s = ctx.static
    if "wire_bits_per_node_per_step" not in s:
        return {}
    out = {"wire_bits_per_node": ctx.const(s["wire_bits_per_node_per_step"])}
    if "wire_messages_per_step" in s:
        out["wire_messages_per_step"] = ctx.const(s["wire_messages_per_step"])
    return out


def _kernel(ctx: CollectorCtx) -> dict:
    """The optimizer chain's analytic device-memory bytes per step for the
    path the run takes (``core.transforms.chain_bytes_moved``)."""
    s = ctx.static
    if "kernel_bytes_moved" not in s:
        return {}
    return {"kernel_bytes_moved": ctx.const(s["kernel_bytes_moved"])}


def _mixing(ctx: CollectorCtx) -> dict:
    """Spectral-gap-normalized mixing progress: ``mix_contraction`` is the
    realized ``consensus_post / consensus_pre``, ``mix_progress`` divides it
    by ``rho = sqrt(1 - spectral_gap)``, the worst-case contraction of one
    gossip round (<= 1: the topology realizes its share; >> 1 sustained:
    drift outruns it)."""
    s = ctx.static
    if "rho" not in s:
        return {}
    pre = ctx.consensus(ctx.params_old)
    post = ctx.consensus(ctx.params_new)
    # pre == 0 (every node at x^0): nothing to contract, report 1.0
    contraction = torch.where(pre > 0, post / torch.clamp(pre, min=_EPS),
                              torch.ones_like(pre))
    rho = max(float(s["rho"]), _EPS)
    return {"mix_contraction": contraction,
            "mix_progress": contraction / rho,
            "spectral_gap": ctx.const(s.get("spectral_gap", 0.0))}


def _scenario(ctx: CollectorCtx) -> dict:
    """The run's data heterogeneity (mean pairwise TV distance of the
    Dirichlet partition, a build-time static) and, under a scenario, this
    round's participation fraction ``alive_frac``."""
    out = {}
    if "data_mean_tv" in ctx.static:
        out["data_mean_tv"] = ctx.const(ctx.static["data_mean_tv"])
    if ctx.alive is not None:
        # the sum of 0/1 values times 1/n, as XLA computes the reference's
        # node mean: the step's alive_frac, bit for bit
        a = ctx.alive.to(torch.float32)
        out["alive_frac"] = ctx.node_sum(torch.sum(a)) * (1.0 / ctx.n_nodes)
    return out


def _staleness(ctx: CollectorCtx) -> dict:
    """The overlap's staleness: the RMS gap between the params each node
    will exchange next round (its stale buffer) and the fresh params it
    holds, normalized as the consensus distance.  Emits nothing without the
    overlap; a site whose tree is not params-shaped (a tracker buffer) is
    skipped."""
    sites = ctx.mix_buf_new
    if not sites:
        return {}
    pleaves, pdef = tree_flatten(ctx.params_new)
    for site in sites:
        sleaves, sdef = tree_flatten(site)
        if sdef != pdef or any(a.shape != b.shape
                               for a, b in zip(sleaves, pleaves)):
            continue
        sq, cnt = 0.0, 0
        for a, b in zip(sleaves, pleaves):
            sq = sq + torch.sum((a.to(torch.float32)
                                 - b.to(torch.float32)) ** 2)
            cnt += a[0].numel()
        gap = torch.sqrt(ctx.node_sum(sq) / (ctx.n_nodes * max(cnt, 1)))
        return {"staleness_gap": gap}
    return {}


METRICS: dict[str, Callable[[CollectorCtx], dict]] = {
    "consensus": _consensus,
    "grad_norms": _grad_norms,
    "alignment": _alignment,
    "comm_buffers": _comm_buffers,
    "kernel": _kernel,
    "wire": _wire,
    "mixing": _mixing,
    "scenario": _scenario,
    "staleness": _staleness,
}

DEFAULT_METRICS = tuple(sorted(METRICS))


# ---------------------------------------------------------------------------
# resolved configuration (what the trainer threads into its runtime)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MetricsSpec:
    """Which collectors run, at what step cadence."""

    names: tuple = DEFAULT_METRICS
    every: int = 1

    def validate(self) -> "MetricsSpec":
        """The one check of names and cadence (``ExperimentSpec.validate``
        runs it too); the error names the spec's ``telemetry`` field."""
        if self.every < 1:
            raise ValueError(f"telemetry.every: must be >= 1, got "
                             f"{self.every}")
        unknown = [n for n in self.names if n not in METRICS]
        if unknown:
            raise ValueError(f"telemetry.metrics: unknown metrics {unknown}; "
                             f"have {sorted(METRICS)}")
        return self


@dataclasses.dataclass
class TelemetryConfig:
    """Resolved collectors, cadence and build-time statics.  ``static`` is
    filled by ``api.build`` once the trainer exists; collectors tolerate
    missing keys, so a hand-built config with ``static={}`` still collects
    every dynamic metric."""

    metrics: MetricsSpec = dataclasses.field(default_factory=MetricsSpec)
    static: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.metrics.validate()

    @property
    def every(self) -> int:
        return self.metrics.every

    def collect(self, ctx: CollectorCtx) -> dict:
        """Run every selected collector; enforce the scalar-fp32 contract."""
        out = {}
        for name in self.metrics.names:
            for k, v in METRICS[name](ctx).items():
                v = v.to(torch.float32)
                if v.dim() != 0:
                    raise ValueError(
                        f"telemetry collector {name!r} produced non-scalar "
                        f"{k!r} with shape {tuple(v.shape)}; collectors must "
                        "fully node-reduce (see CollectorCtx node hooks)")
                out[k] = v
        return out


def resolve_config(names=(), every: int = 1) -> TelemetryConfig:
    """``TelemetrySpec`` fields -> validated :class:`TelemetryConfig`
    (empty ``names`` selects :data:`DEFAULT_METRICS`)."""
    return TelemetryConfig(metrics=MetricsSpec(
        names=tuple(names) or DEFAULT_METRICS, every=every))
