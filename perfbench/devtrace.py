"""Reading a ``torch.profiler`` trace of the measured window.

Device operations are the trace's events on the CUDA device (kernels,
copies, sets), host ranges its ``record_function`` annotations.  The
device is busy where the union of the device operations' intervals
covers the window, so overlapping kernels count once and a host range
around them counts not at all (``chip_smoke.py``'s
``device_busy_share`` summed ranges with their kernels and read 1.79).
"""
from __future__ import annotations

import bisect
import dataclasses


@dataclasses.dataclass
class Trace:
    """The window's events: ``ops`` device (name, start, end), ``ranges``
    host annotations (name, start, end), times in seconds from the
    window's start; ``window_s`` its length."""

    ops: list
    ranges: list
    window_s: float

    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.ops], 0.0,
                             self.window_s)

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def op_seconds(self, patterns) -> tuple[float, int]:
        """Summed device time and count of the operations whose name
        contains any of ``patterns``."""
        total, count = 0.0, 0
        for name, s, e in self.ops:
            if any(p in name for p in patterns):
                total += e - s
                count += 1
        return total, count

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s)
        return sorted(([short(n), t] for n, t in by.items()),
                      key=lambda r: -r[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest intervals of the window with no device
        operation, each named by the innermost host range open at its
        start (or ``host``)."""
        spans = merged([(s, e) for _, s, e in self.ops], 0.0, self.window_s)
        gaps, t = [], 0.0
        for s, e in spans:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.window_s:
            gaps.append((t, self.window_s))
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = sorted(self.ranges, key=lambda r: r[1])
        keys = [r[1] for r in starts]
        out = []
        for s, e in gaps[:k]:
            out.append([self.range_at(starts, keys, s), e - s])
        return out

    @staticmethod
    def range_at(starts, keys, t: float) -> str:
        """The innermost (latest-started) host range open at ``t``."""
        i = bisect.bisect_right(keys, t)
        for name, s, e in reversed(starts[max(0, i - 2000):i]):
            if s <= t < e:
                return name
        return "host"


def short(name: str, limit: int = 120) -> str:
    """A kernel name without its template arguments and parameters."""
    cut = name.split("(")[0]
    if "<" in cut:
        cut = cut.split("<")[0]
    cut = cut.replace("void ", "").strip()
    return (cut or name)[:limit]


def merged(intervals, lo: float, hi: float) -> list:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint
    (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def union_seconds(intervals, lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged(intervals, lo, hi))


def from_profiler(prof, start: str, end: str) -> Trace:
    """The events of a stopped ``torch.profiler.profile`` between the
    starts of the host ranges ``start`` and ``end`` (markers the harness
    records at the window's bounds), on the trace's own clock."""
    events = prof.profiler.kineto_results.events()
    marks = {ev.name(): ev.start_ns() for ev in events
             if ev.is_user_annotation() and ev.name() in (start, end)}
    t0, t1 = marks[start], marks[end]
    ops, ranges = [], []
    for ev in events:
        s = (ev.start_ns() - t0) * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if ev.is_user_annotation():
            # host ranges; their device-side copies are no operation
            if (not str(ev.device_type()).endswith("CUDA")
                    and ev.name() not in (start, end)):
                ranges.append((ev.name(), s, e))
        elif str(ev.device_type()).endswith("CUDA") and 0.0 <= s:
            ops.append((ev.name(), s, e))
    return Trace(ops=ops, ranges=ranges, window_s=(t1 - t0) * 1e-9)
