"""Trace spans + host-side step timing.

Port of ``repro/telemetry/trace.py``.  Two span mechanisms:

  * :func:`graph_span` -- an NVTX range (``torch.cuda.nvtx``), which a
    CUDA timeline (Nsight Systems, ``torch.profiler``'s trace) shows around
    the kernels launched inside it, and nothing in a CPU-only build of
    torch.  The runtime wraps the stages of each collecting step in one
    (``tm/grad``, ``tm/finish_mix``, ``tm/collect``), as the reference
    labels them in its graph; a telemetry-free step carries none;
  * :func:`span` -- a ``graph_span`` plus a ``torch.profiler``
    ``record_function`` label, which the profiler's host-side tables
    (``key_averages``) list by name; it marks host phases (the recorder's
    flush), not per-step work.

Neither touches a tensor, so a labelled step is the same step.

:class:`StepTimer` keeps host wall-clock per step in a fixed-size ring
buffer with percentile summaries.  A lap measures host time, which on the
card covers the device work only where the step ends in a host sync (the
serving engine's decode step does: its argmax is read back).
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import record_function

__all__ = ["span", "graph_span", "StepTimer"]


@contextlib.contextmanager
def graph_span(name: str):
    """An NVTX range named ``name`` (a no-op where torch has no CUDA)."""
    if not torch.cuda.is_available():
        yield
        return
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def span(name: str):
    """:func:`graph_span` plus a ``torch.profiler`` label of the region."""
    with record_function(name), graph_span(name):
        yield


class StepTimer:
    """Ring buffer of host-side per-step wall times with percentile
    summaries.

    Usage: ``timer.lap()`` after every dispatched step (or
    ``timer.lap(steps=k)`` after a k-step fused chunk — the chunk time is
    attributed evenly).  The first lap after construction/reset only arms
    the clock; compile time is excluded by calling :meth:`arm` after
    warm-up (the recorder does this on its first consumed step).
    """

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError("StepTimer capacity must be >= 1")
        self.capacity = capacity
        self._buf: list[float] = []
        self._next = 0          # ring write cursor
        self._t0: float | None = None
        self.total_laps = 0
        self.last_s = 0.0       # most recent per-step lap (read by probes)

    def arm(self) -> None:
        """Start (or restart) the clock; the next lap measures from here."""
        self._t0 = time.perf_counter()

    def lap(self, steps: int = 1) -> None:
        """Record the time since the last lap/arm, split over ``steps``."""
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return
        per_step = (now - self._t0) / max(steps, 1)
        self._t0 = now
        self.last_s = per_step
        for _ in range(steps):
            if len(self._buf) < self.capacity:
                self._buf.append(per_step)
            else:
                self._buf[self._next] = per_step
                self._next = (self._next + 1) % self.capacity
            self.total_laps += 1

    def summary(self) -> dict:
        """{count, mean_s, p50_s, p90_s, p99_s, steps_per_s} over the
        retained window (empty dict before the first measured lap)."""
        if not self._buf:
            return {}
        xs = sorted(self._buf)

        def pct(q: float) -> float:
            # nearest-rank on the retained window
            idx = min(int(q * len(xs)), len(xs) - 1)
            return xs[idx]

        mean = sum(xs) / len(xs)
        return {
            "count": self.total_laps,
            "mean_s": mean,
            "p50_s": pct(0.50),
            "p90_s": pct(0.90),
            "p95_s": pct(0.95),
            "p99_s": pct(0.99),
            "steps_per_s": (1.0 / mean) if mean > 0 else float("inf"),
        }
