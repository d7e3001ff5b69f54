"""Declarative, serializable experiment specs.

Port of ``repro/api/spec.py``.  The spec tree is the reference's, field for
field, so the port loads the reference's JSON unchanged
(``ExperimentSpec.from_json(reference_spec.to_json())``) and round-trips it
losslessly.  ``validate()`` accepts the subset that the port runs today:
every registry topology (the generated graphs too), every optimizer and
explicit stage chain, dense gossip (plain or compressed) on the vmap
runtime, the scenario engine, the MLP and ResNet-20 on classification
data, the transformer LM (every configured arch: dense, local/global,
MoE, Mamba-2, the zamba2 hybrid and the VLM) on ``lm_domains`` data,
checkpoints and telemetry.  Anything outside it raises
``NotImplementedError`` naming the slice of the port that brings it;
malformed values raise ``ValueError`` as in the reference.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

__all__ = [
    "DataSpec", "TopologySpec", "OptimSpec", "CommSpec", "GossipSpec",
    "LoopSpec", "EvalSpec", "ModelSpec", "TelemetrySpec", "ScenarioSpec",
    "ExperimentSpec", "apply_overrides",
]


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Dataset + heterogeneous client partition (paper App. A.2)."""

    dataset: str = "classification"   # 'classification' | 'lm_domains'
    alpha: float = 0.1                # Dirichlet concentration (non-iid-ness)
    batch: int = 16                   # per-node batch size
    seed: int | None = None           # None -> experiment seed
    min_per_client: int = 2
    ensure_min: str = "retry"         # 'retry' (reject + reseed draws) |
                                      # 'redistribute' (deterministic top-up
                                      # from the largest clients — REQUIRED
                                      # at n≈10³ under low alpha, where
                                      # retrying can never cover every
                                      # client; see data/partition.py)
    # classification (synthetic CIFAR-shaped; data/synthetic.py)
    n_data: int = 4096
    n_classes: int = 20
    hw: int = 8
    noise: float = 2.5
    train_frac: float = 0.5           # first train_frac of the data trains
    # lm_domains (per-domain bigram LMs)
    vocab: int = 0                    # 0 -> take from the model config
    seq_len: int = 128
    n_domains: int = 0                # 0 -> n_nodes
    n_seq_per_domain: int = 0         # 0 -> max(64, 16 * batch)


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Gossip graph: any ``core/topology.get_topology`` name.  ``'exp'`` is
    the time-varying 1-peer exponential graph; ``'social'`` pins n=32."""

    name: str = "ring"
    n: int = 16


@dataclasses.dataclass(frozen=True)
class OptimSpec:
    """Optimizer: a registry name + kwargs, or an explicit transform-stage
    chain (``stages`` = ((factory_name, kwargs), ...) resolved through
    ``core/transforms.STAGES``; when non-empty it wins over ``name``)."""

    name: str = "qg_dsgdm_n"
    lr: float = 0.1
    weight_decay: float = 1e-4
    kwargs: dict = dataclasses.field(default_factory=dict)
    stages: tuple = ()
    fused: str = "auto"               # 'kernel' | 'off' | 'auto' (kernel
                                      # iff on CUDA); 'pallas' = 'kernel'


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Compressed-gossip schedule (``comm/choco.py``).  ``backend`` keeps
    the reference's meaning: 'jnp' is the unfused path of plain PyTorch
    expressions, leaf by leaf; 'pallas' and 'auto' go through the kernels
    (CUDA kernels on the card, their plain versions on the CPU)."""

    compressor: str = "dense"
    gamma: float | None = None        # None -> per-compressor default
    error_feedback: bool = False      # EF14 value exchange vs CHOCO replicas
    backend: str = "jnp"              # 'jnp' | 'pallas' | 'auto'


@dataclasses.dataclass(frozen=True)
class GossipSpec:
    """Collective schedule for the mix.  The port runs the dense
    contraction (``'auto'`` | ``'dense'``); the ppermute schedules come
    with slice 8b."""

    schedule: str = "auto"            # auto | dense | ring_ppermute | sparse_ppermute
    node_axis: str = "data"


@dataclasses.dataclass(frozen=True)
class LoopSpec:
    """Training loop + lr schedule.  ``chunk=1`` runs the per-step loop;
    ``chunk>1`` copies that many steps' batches to the device at once
    (step-identical).  ``warmup==0 and decay_at==()`` keeps the optimizer's
    constant lr.  ``rng_seed`` (None = 0) seeds the compressors' random
    draws; the reference seeds its loop rng with it."""

    steps: int = 150
    chunk: int = 1
    warmup: int = 0
    decay_at: tuple = ()              # fractions of total steps
    decay: float = 0.1
    warmup_from: float = 0.1
    log_every: int = 0
    rng_seed: int | None = None
    checkpoint_every: int = 0         # full-TrainState save cadence (steps);
                                      # 0 = off; needs run(checkpoint_path=)


@dataclasses.dataclass(frozen=True)
class EvalSpec:
    """Paper protocol: every node's model on the FULL eval set, averaged
    over nodes.  ``batch=0`` evaluates the whole set in one batch."""

    enabled: bool = True
    batch: int = 0


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Model/loss plugin: a ``repro_torch.api.models`` registry name +
    kwargs, e.g. ``('mlp', {'width': 64, 'init': 'quickstart'})``,
    ``('resnet20', {'norm': 'evonorm'})``."""

    name: str = "mlp"
    kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Metric collection and its sink (``repro_torch.telemetry``).
    Disabled (the default), the step is the telemetry-free step.  Enabled,
    the step runs the selected collectors every ``every`` steps (gated on
    the host: an off-cadence step is the unchanged step) and ``run(spec)``
    streams one row per on-cadence step to the ``sink``; render it with
    ``python -m repro_torch.telemetry.report``."""

    enabled: bool = False
    every: int = 1                    # collect when step % every == 0
    metrics: tuple = ()               # () -> all registered collectors
    sink: str = "jsonl"               # telemetry.SINKS: memory | jsonl | csv
    path: str = ""                    # '' -> metrics.<sink ext> in cwd (file
                                      # sinks); run(telemetry_path=) overrides


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Thousand-node scenario engine: participation/fault model
    (``repro_torch.scenario``).

    Disabled (the default), the step is the no-scenario step.  Enabled,
    each round draws deterministic masks from ``seed``: every node
    participates with probability ``participation``, drops out (holds
    state, mixing renormalizes around it) with probability ``dropout`` per
    ``churn_window`` steps, and straggles (updates locally but misses the
    round's gossip) with probability ``straggler``.  Runs on the vmap
    runtime with dense gossip, uncompressed comm and symmetric mixing
    matrices only: ``validate`` and the trainer raise on other
    combinations."""

    enabled: bool = False
    seed: int = 0
    participation: float = 1.0        # P(node sampled into a round)
    dropout: float = 0.0              # P(node down for a churn window)
    churn_window: int = 1             # steps between alive-set redraws
    straggler: float = 0.0            # P(alive node misses the gossip)


_NESTED = {
    "data": DataSpec, "topology": TopologySpec, "optim": OptimSpec,
    "comm": CommSpec, "gossip": GossipSpec, "loop": LoopSpec,
    "eval": EvalSpec, "model": ModelSpec, "telemetry": TelemetrySpec,
    "scenario": ScenarioSpec,
}


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One experiment = one point on the paper grid, as data."""

    name: str = ""
    seed: int = 0                     # init + data/partition seed
    runtime: str = "auto"             # auto | vmap (sharded, hybrid: 8b)
    overlap: str = "none"             # none (delayed_1: slice 8b)
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    topology: TopologySpec = dataclasses.field(default_factory=TopologySpec)
    optim: OptimSpec = dataclasses.field(default_factory=OptimSpec)
    comm: CommSpec = dataclasses.field(default_factory=CommSpec)
    gossip: GossipSpec = dataclasses.field(default_factory=GossipSpec)
    loop: LoopSpec = dataclasses.field(default_factory=LoopSpec)
    eval: EvalSpec = dataclasses.field(default_factory=EvalSpec)
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    telemetry: TelemetrySpec = dataclasses.field(
        default_factory=TelemetrySpec)
    scenario: ScenarioSpec = dataclasses.field(
        default_factory=ScenarioSpec)

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        return _to_jsonable(self)

    def to_json(self, *, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    def override(self, *assignments: str) -> "ExperimentSpec":
        """``spec.override("loop.steps=3", "data.alpha=0.5")`` — the
        ``--set`` form (see :func:`apply_overrides`)."""
        return apply_overrides(self, assignments)

    def replace(self, **section_updates) -> "ExperimentSpec":
        """Nested ``dataclasses.replace``: ``spec.replace(loop={"steps": 3},
        name="x")`` updates fields inside sections by dict, scalars
        directly."""
        kw = {}
        for k, v in section_updates.items():
            if k in _NESTED and isinstance(v, dict):
                kw[k] = dataclasses.replace(getattr(self, k), **v)
            else:
                kw[k] = v
        return dataclasses.replace(self, **kw)

    # -- eager cross-field validation ----------------------------------------
    def validate(self) -> "ExperimentSpec":
        """Raise ``ValueError`` on an invalid field and
        ``NotImplementedError`` on a valid one the port does not run yet;
        return self so ``spec.validate()`` chains."""
        from repro_torch.api.models import (MODEL_DATASETS, MODELS,
                                            resolve_transformer_config)
        from repro_torch.comm.compressors import BACKENDS, make_compressor
        from repro_torch.core import topology as topo_lib
        from repro_torch.core.optim import OPTIMIZERS
        from repro_torch.core.transforms import FUSED_MODES, STAGES
        from repro_torch.runtime import RUNTIMES

        where = f"ExperimentSpec{f'[{self.name}]' if self.name else ''}"

        def err(field: str, msg: str):
            raise ValueError(f"{where}.{field}: {msg}")

        def later(field: str, what: str, slice_no: str):
            raise NotImplementedError(
                f"{where}.{field}: {what} is not ported yet; it comes with "
                f"slice {slice_no} of the port")

        try:
            topo = topo_lib.get_topology(self.topology.name, self.topology.n)
        except ValueError as e:
            err("topology", str(e))
        # optimizer
        if self.optim.stages:
            for entry in self.optim.stages:
                if (len(entry) != 2 or not isinstance(entry[0], str)
                        or not isinstance(entry[1], dict)):
                    err("optim.stages",
                        f"each entry must be (stage_name, kwargs), got "
                        f"{entry!r}")
                if entry[0] not in STAGES:
                    err("optim.stages", f"unknown stage {entry[0]!r}; have "
                        f"{sorted(STAGES)}")
        elif self.optim.name not in OPTIMIZERS:
            err("optim.name", f"unknown optimizer {self.optim.name!r}; have "
                f"{sorted(OPTIMIZERS)}")
        if self.optim.lr <= 0:
            err("optim.lr", f"must be > 0, got {self.optim.lr}")
        if self.optim.fused not in FUSED_MODES:
            err("optim.fused", f"must be one of {FUSED_MODES}, got "
                f"{self.optim.fused!r}")
        # comm (make_compressor lists the valid forms), runtime, gossip
        # schedule, overlap
        try:
            make_compressor(self.comm.compressor)
        except ValueError as e:
            err("comm.compressor", str(e))
        if self.comm.gamma is not None and not 0.0 < self.comm.gamma <= 1.0:
            err("comm.gamma", f"must be in (0, 1] or None, got "
                f"{self.comm.gamma}")
        if self.comm.backend not in BACKENDS:
            err("comm.backend", f"must be 'jnp', 'pallas' or 'auto', got "
                f"{self.comm.backend!r}")
        if self.runtime not in RUNTIMES:
            err("runtime", f"unknown runtime {self.runtime!r}; valid: "
                f"{' | '.join(RUNTIMES)}")
        if self.runtime not in ("auto", "vmap"):
            later("runtime", f"runtime {self.runtime!r}", "8b")
        if self.overlap != "none":
            later("overlap", f"overlap {self.overlap!r}", "8b")
        if self.gossip.schedule not in ("auto", "dense"):
            later("gossip.schedule", f"schedule {self.gossip.schedule!r}",
                  "8b")
        # data
        d = self.data
        if d.dataset not in ("classification", "lm_domains"):
            err("data.dataset", f"unknown dataset {d.dataset!r}; have "
                "'classification' | 'lm_domains'")
        if d.alpha <= 0:
            err("data.alpha", f"Dirichlet alpha must be > 0, got {d.alpha}")
        if d.batch < 1:
            err("data.batch", f"must be >= 1, got {d.batch}")
        if d.ensure_min not in ("retry", "redistribute"):
            err("data.ensure_min", f"must be 'retry' | 'redistribute', got "
                f"{d.ensure_min!r}")
        if d.dataset == "classification":
            if not 0.0 < d.train_frac < 1.0:
                err("data.train_frac", f"must be in (0, 1), got "
                    f"{d.train_frac}")
            n_train = int(d.n_data * d.train_frac)
            if topo.n * d.min_per_client > n_train:
                err("data", f"min_per_client={d.min_per_client} "
                    f"unsatisfiable: {topo.n} clients need "
                    f"{topo.n * d.min_per_client} train samples, have "
                    f"{n_train} (= {d.n_data} * train_frac "
                    f"{d.train_frac}); shrink the grid or grow n_data")
        else:
            if d.seq_len < 2:
                err("data.seq_len", f"must be >= 2, got {d.seq_len}")
            if d.vocab == 0 and self.model.name != "transformer":
                err("data.vocab", "vocab=0 means 'take from the model "
                    f"config', but model {self.model.name!r} has no vocab; "
                    "set data.vocab explicitly")
        # loop
        lp = self.loop
        if lp.steps < 1:
            err("loop.steps", f"must be >= 1, got {lp.steps}")
        if lp.chunk < 1:
            err("loop.chunk", f"must be >= 1, got {lp.chunk}")
        if lp.checkpoint_every < 0:
            err("loop.checkpoint_every", f"must be >= 0, got "
                f"{lp.checkpoint_every}")
        for f in lp.decay_at:
            if not 0.0 <= f <= 1.0:
                err("loop.decay_at", f"fractions must be in [0, 1], got "
                    f"{lp.decay_at}")
        # telemetry (names and sink checked against the registries)
        from repro_torch.telemetry import SINKS, MetricsSpec
        tl = self.telemetry
        try:
            MetricsSpec(names=tuple(tl.metrics), every=tl.every).validate()
        except ValueError as e:
            raise ValueError(f"{where}.{e}") from None
        if tl.sink not in SINKS:
            err("telemetry.sink", f"unknown sink {tl.sink!r}; have "
                f"{sorted(SINKS)}")
        # scenario: field ranges here; the n/comm/symmetry cross-checks
        # live in DecentralizedTrainer, as in the reference
        sc = self.scenario
        if not 0.0 < sc.participation <= 1.0:
            err("scenario.participation", f"must be in (0, 1], got "
                f"{sc.participation}")
        if not 0.0 <= sc.dropout < 1.0:
            err("scenario.dropout", f"must be in [0, 1), got {sc.dropout}")
        if not 0.0 <= sc.straggler < 1.0:
            err("scenario.straggler", f"must be in [0, 1), got "
                f"{sc.straggler}")
        if sc.churn_window < 1:
            err("scenario.churn_window", f"must be >= 1, got "
                f"{sc.churn_window}")
        if sc.enabled and (sc.participation < 1.0 or sc.dropout > 0.0
                           or sc.straggler > 0.0):
            if self.comm.compressor != "dense":
                err("scenario", "fault injection with compressed comm is "
                    "not supported (CHOCO/EF replicas assume full "
                    "participation); set comm.compressor='dense'")
        # model
        if self.model.name not in MODELS:
            err("model.name", f"unknown model plugin {self.model.name!r}; "
                f"have {sorted(MODELS)}")
        allowed = MODEL_DATASETS.get(self.model.name)
        if allowed is not None and d.dataset not in allowed:
            err("model", f"model {self.model.name!r} consumes "
                f"{' | '.join(allowed)} data, not dataset={d.dataset!r}")
        if self.model.name == "transformer":
            try:
                resolve_transformer_config(self.model)
            except (ValueError, TypeError) as e:
                err("model.kwargs", str(e))
        return self


# ---------------------------------------------------------------------------
# generic (de)serialization over the spec dataclass tree
# ---------------------------------------------------------------------------

def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


def _coerce(cls, fname: str, ftype: str, v: Any) -> Any:
    """JSON -> field value: nested spec dicts, list -> tuple, int -> float."""
    if fname in _NESTED and cls is ExperimentSpec:
        if not isinstance(v, dict):
            raise ValueError(f"ExperimentSpec.{fname}: expected a dict, got "
                             f"{type(v).__name__}")
        return _from_dict(_NESTED[fname], v)
    if fname == "stages":
        return tuple((str(n), dict(kw)) for n, kw in v)
    if ftype.startswith("tuple"):
        return tuple(v)
    if ftype == "float" and isinstance(v, int) and not isinstance(v, bool):
        return float(v)
    return v


def _from_dict(cls, d: dict):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(fields)
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown keys {sorted(unknown)}; "
                         f"valid keys: {sorted(fields)}")
    kw = {k: _coerce(cls, k, str(fields[k].type), v) for k, v in d.items()}
    return cls(**kw)


# ---------------------------------------------------------------------------
# --set key=value dotted overrides
# ---------------------------------------------------------------------------

def _parse_value(raw: str) -> Any:
    """JSON if it parses ('0.1', 'true', 'null', '[0.5,0.75]',
    '{"norm":"bn"}'), bare string otherwise ('ring', 'topk:0.01')."""
    try:
        return json.loads(raw)
    except (ValueError, TypeError):
        return raw


def apply_overrides(spec: ExperimentSpec, assignments) -> ExperimentSpec:
    """Apply ``--set``-style dotted overrides, e.g.
    ``apply_overrides(spec, ["loop.steps=3", "data.alpha=0.5",
    "comm.compressor=topk:0.01"])``.  Unknown paths raise ``ValueError``
    listing the valid keys at that level; the result is rebuilt through
    ``from_dict`` so type coercion and strictness apply."""
    d = spec.to_dict()
    for a in assignments:
        key, sep, raw = a.partition("=")
        if not sep:
            raise ValueError(f"override {a!r} is not of the form "
                             "section.key=value")
        parts = key.strip().split(".")
        node = d
        for i, p in enumerate(parts):
            if not isinstance(node, dict) or p not in node:
                level = ".".join(parts[:i]) or "<top level>"
                valid = sorted(node) if isinstance(node, dict) else []
                raise ValueError(f"override {a!r}: no key {p!r} under "
                                 f"{level}; valid keys: {valid}")
            if i == len(parts) - 1:
                node[p] = _parse_value(raw)
            else:
                node = node[p]
    return ExperimentSpec.from_dict(d)
