"""Host-side step timing.

Port of ``repro/telemetry/trace.py:47`` (:class:`StepTimer`) alone; the
reference's spans (``span``/``graph_span``, labels of the traced graph) come
with the rest of the telemetry slice.  A lap measures host wall-clock time,
which on the card covers the device work only where the step ends in a host
sync (the serving engine's decode step does: its argmax is read back).
"""
from __future__ import annotations

import time

__all__ = ["StepTimer"]


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
