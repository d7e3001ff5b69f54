"""Telemetry: collectors run inside the step, trace spans, sinks.

Port of ``repro/telemetry``:

  * collectors (:mod:`repro_torch.telemetry.metrics`) run inside the step
    when the loop asks for them; the cadence is gated on the host, so an
    off-cadence step is the unchanged step (no extra launch, no host sync);
  * spans and timing (:mod:`repro_torch.telemetry.trace`): NVTX ranges,
    ``torch.profiler`` labels and a host step timer;
  * sinks and the recorder (:mod:`repro_torch.telemetry.sinks`,
    ``.recorder``): the host side, which splits the ``tm.`` keys off the
    step's metrics and streams rows to memory, JSONL or CSV.

Set ``telemetry=TelemetrySpec(enabled=True)`` on an ``ExperimentSpec`` and
``run(spec)`` writes ``metrics.jsonl``; render it with ``python -m
repro_torch.telemetry.report``.
"""
from repro_torch.telemetry.metrics import (
    METRICS, DEFAULT_METRICS, TM_PREFIX, CollectorCtx, MetricsSpec,
    TelemetryConfig, resolve_config)
from repro_torch.telemetry.recorder import TelemetryRecorder
from repro_torch.telemetry.sinks import (
    SINKS, CsvSink, JsonlSink, MemorySink, TelemetrySink, make_sink,
    read_csv, read_jsonl)
from repro_torch.telemetry.trace import StepTimer, graph_span, span

__all__ = [
    "METRICS", "DEFAULT_METRICS", "TM_PREFIX", "CollectorCtx", "MetricsSpec",
    "TelemetryConfig", "resolve_config", "TelemetryRecorder", "SINKS",
    "CsvSink", "JsonlSink", "MemorySink", "TelemetrySink", "make_sink",
    "read_csv", "read_jsonl", "StepTimer", "graph_span", "span",
]
