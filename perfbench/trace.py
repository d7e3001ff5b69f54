"""What a traced window of the benchmark saw: the device's kernels and
copies from ``torch.profiler``, which records the device's activities
only, so that the host's dispatch runs at its untraced speed.

Times are in microseconds on the profiler's timeline.
"""
from __future__ import annotations

import dataclasses

#: the host-to-device copy that ``put_batch`` makes: the gap after it is
#: the host issuing the next step after the copy's wait for the device
PUT_COPY = "Memcpy HtoD"


@dataclasses.dataclass
class TraceWindow:
    steps: int                 # steps traced
    window_s: float            # host clock, device sync to device sync
    kernels: list              # (name, start_us, end_us)
    copies: list               # memcpy and memset: (name, start_us, end_us)

    def busy(self, events=None) -> list:
        """The union of the device's activities (or of ``events``):
        sorted, disjoint (start_us, end_us). On Hopper a kernel may start
        before the one before it on the stream has ended (programmatic
        dependent launch), so times are unions, never sums."""
        merged = []
        for _, s, e in sorted(self.kernels + self.copies if events is None
                              else events, key=lambda ev: ev[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def busy_s(self, events=None) -> float:
        return sum(e - s for s, e in self.busy(events)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the idle
        gaps between the device's activities in seconds, summed by what
        the host was doing: ``after_put_batch`` where the gap follows
        ``put_batch``'s copy (the host, released by the copy's wait,
        issuing the next step), ``in_step`` elsewhere (the host issuing
        the step more slowly than the device runs it)."""
        by_name: dict = {}
        for name, s, e in self.kernels + self.copies:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        events = sorted(self.kernels + self.copies, key=lambda ev: ev[2])
        gaps: dict = {}
        busy = self.busy()
        j = 0
        for (_, end), (start, _) in zip(busy, busy[1:]):
            while j + 1 < len(events) and events[j + 1][2] <= end:
                j += 1
            label = ("after_put_batch" if events[j][0].startswith(PUT_COPY)
                     else "in_step")
            gaps[label] = gaps.get(label, 0.0) + (start - end) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in idle]}


def from_profile(prof, steps: int, window_s: float) -> TraceWindow:
    """Sort a finished profile's device events into kernels and copies."""
    from torch.autograd import DeviceType

    kernels, copies = [], []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            (copies if ev.name.startswith(("Memcpy", "Memset"))
             else kernels).append((ev.name, ev.time_range.start,
                                   ev.time_range.end))
    return TraceWindow(steps, window_s, kernels, copies)
