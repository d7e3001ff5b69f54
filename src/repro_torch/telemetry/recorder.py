"""Host-side telemetry recorder: between the step's ``tm.``-prefixed
metrics and a :class:`~repro_torch.telemetry.sinks.TelemetrySink`.

Port of ``repro/telemetry/recorder.py``.  The training loops take an
optional recorder (``telemetry=None``) and, when given one, pass every
step's metrics through :meth:`TelemetryRecorder.consume` (or
:meth:`consume_chunk`) before recording history.  The recorder

  * splits off every ``tm.`` key, so ``history`` keeps the telemetry-free
    key set;
  * answers the loops' cadence questions (:meth:`wants`,
    :meth:`wants_chunk`): an on-cadence step (``step % every == 0``) runs
    the collectors, any other step is the unchanged step; a chunk with an
    on-cadence step collects on all its steps and the recorder keeps the
    on-cadence rows;
  * drives a :class:`~repro_torch.telemetry.trace.StepTimer`, whose
    percentiles ride along in :meth:`summary`.

Consumed values stay on the device until :meth:`flush` (called by
:meth:`summary` and :meth:`close`), which copies each buffered step or
chunk to the host in one transfer: a copy per chunk during the run would
make the host wait for the device every chunk.  A value the loop timed on
the host (the overlap's ``gossip_wait_ms``) rides along as it is.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.telemetry.metrics import TM_PREFIX, TelemetryConfig
from repro_torch.telemetry.sinks import TelemetrySink
from repro_torch.telemetry.trace import StepTimer, span

__all__ = ["TelemetryRecorder"]


class TelemetryRecorder:
    """Consumes step metrics, streams telemetry rows, times steps."""

    def __init__(self, config: TelemetryConfig, sink: TelemetrySink,
                 timer: Optional[StepTimer] = None):
        self.config = config
        self.sink = sink
        self.timer = timer or StepTimer()
        self.rows_emitted = 0
        # buffered (first step, chunk size or 0 for one step, tm values)
        self._pending: list[tuple[int, int, dict]] = []

    # -- loop interface ------------------------------------------------------
    def wants(self, step: int) -> bool:
        """Should the loop run the collectors at ``step``?"""
        return step % self.config.every == 0

    def wants_chunk(self, start_step: int, k: int) -> bool:
        """Does the chunk ``[start_step, start_step + k)`` hold an
        on-cadence step?  (The whole chunk then collects.)"""
        every = self.config.every
        return (start_step % every == 0) or (start_step % every) + k > every

    def consume(self, step: int, metrics: dict) -> dict:
        """Split one step's metrics: buffer the ``tm.`` values (on cadence)
        and return the rest untouched."""
        self.timer.lap()
        rest, tm = self._split(metrics)
        if tm and step % self.config.every == 0:
            self._pending.append((step, 0, tm))
        return rest

    def consume_chunk(self, start_step: int, metrics: dict) -> dict:
        """The chunked form: values are stacked ``[k]``; one row per
        on-cadence step of the chunk."""
        rest, tm = self._split(metrics)
        k = int(next(iter(metrics.values())).shape[0]) if metrics else 0
        self.timer.lap(steps=k)
        if tm and k:
            self._pending.append((start_step, k, tm))
        return rest

    def flush(self) -> None:
        """Copy the buffered values to the host, one transfer a buffered
        step or chunk, and emit the sink rows.  The only device-to-host
        copy of telemetry: the loops never call it, ``summary`` and
        ``close`` do."""
        with span("tm/flush"):
            for start, k, tm in self._pending:
                # device values in one transfer; the host-timed probes
                # (``gossip_wait_ms``) are already on the host
                keys = [key for key, v in tm.items()
                        if isinstance(v, torch.Tensor)]
                host = dict(zip(keys, torch.stack(
                    [tm[key].reshape(-1) for key in keys]).cpu().tolist()
                    if keys else []))
                for key, v in tm.items():
                    if key not in host:
                        host[key] = np.asarray(v, np.float64).reshape(
                            -1).tolist()
                for j in range(max(k, 1)):
                    if k == 0 or (start + j) % self.config.every == 0:
                        self._emit(start + j, {key: host[key][j]
                                               for key in tm})
            self._pending.clear()

    # -- internals -----------------------------------------------------------
    def _split(self, metrics: dict) -> tuple[dict, dict]:
        rest, tm = {}, {}
        for key, v in metrics.items():
            if key.startswith(TM_PREFIX):
                tm[key[len(TM_PREFIX):]] = v
            else:
                rest[key] = v
        return rest, tm

    def _emit(self, step: int, values: dict) -> None:
        self.sink.emit({"step": step, **values})
        self.rows_emitted += 1

    # -- lifecycle -----------------------------------------------------------
    def summary(self) -> dict:
        """JSON-ready digest for ``Result.telemetry``: sink location, row
        count, cadence, selected collectors, build-time statics and the
        host step-time percentiles.  Flushes buffered rows first."""
        self.flush()
        return {
            "rows_emitted": self.rows_emitted,
            "path": self.sink.path,
            "every": self.config.every,
            "metrics": list(self.config.metrics.names),
            "static": {k: (float(v) if isinstance(v, (int, float)) else v)
                       for k, v in self.config.static.items()},
            "step_time": self.timer.summary(),
        }

    def close(self) -> dict:
        """Flush and close the sink; returns :meth:`summary`."""
        out = self.summary()
        self.sink.close()
        return out
