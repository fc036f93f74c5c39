"""What a traced run reads: the program's spans, the device's operations
from ``torch.profiler``, and the two on one clock.

The profiler records the CPU and CUDA activity of the window. Its clock
is tied to the host's ``perf_counter`` by a marker (a ``record_function``
opened at a known host time) at each end of the window, so every device
operation can be set against the program's ``repro_torch.obs`` spans and
the benchmark's own parts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]  # host perf_counter ns

MARK = "pitbench.mark"


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """Union of intervals, sorted and disjoint."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(merged: Sequence[Interval], a: int, b: int) -> int:
    """ns of [a, b) that the merged intervals cover."""
    import bisect

    starts = [x for x, _ in merged]
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    got = 0
    while i < len(merged) and merged[i][0] < b:
        lo, hi = max(merged[i][0], a), min(merged[i][1], b)
        if hi > lo:
            got += hi - lo
        i += 1
    return got


def subtract(a: int, b: int, holes: Sequence[Interval]) -> List[Interval]:
    """[a, b) less the holes."""
    out, cur = [], a
    for lo, hi in merge([(max(lo, a), min(hi, b)) for lo, hi in holes
                         if hi > a and lo < b]):
        if lo > cur:
            out.append((cur, lo))
        cur = max(cur, hi)
    if cur < b:
        out.append((cur, b))
    return out


@dataclass
class DeviceTimeline:
    """The device's operations in the window, on the host's clock."""

    ops: List[Tuple[str, int, int]]  # name, start, end (host ns)
    drift_ns: int = 0  # the two markers' disagreement
    busy: List[Interval] = field(default_factory=list)

    def __post_init__(self):
        self.busy = merge([(a, b) for _, a, b in self.ops])

    def busy_ns(self, a: int, b: int) -> int:
        return overlap(self.busy, a, b)

    def kernel_s(self, names: Sequence[str]) -> float:
        """Device seconds of every operation whose name contains one of
        ``names``."""
        return sum(b - a for n, a, b in self.ops
                   if any(x in n for x in names)) * 1e-9


class Profiler:
    """``torch.profiler`` over the window, CPU and CUDA activity."""

    def __init__(self):
        self.prof = None
        self.marks: List[int] = []

    def _mark(self):
        from torch.profiler import record_function

        self.marks.append(time.perf_counter_ns())
        with record_function(MARK):
            pass

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._mark()
        return self

    def __exit__(self, *exc):
        self._mark()
        self.prof.__exit__(*exc)
        return False

    def timeline(self) -> Optional[DeviceTimeline]:
        """The device's operations, or None where the trace has none."""
        events = self.prof.profiler.kineto_results.events()
        marks = sorted(e.start_ns() for e in events if e.name() == MARK
                       and "CPU" in str(e.device_type()))
        ops = [(e.name(), e.start_ns(), e.end_ns()) for e in events
               if "CUDA" in str(e.device_type()) and e.name() != MARK
               and e.end_ns() > e.start_ns()]
        if len(marks) != 2 or not ops:
            import sys

            kinds = sorted({str(e.device_type()) for e in events})
            print(f"pitbench: no device timeline ({len(events)} events, "
                  f"{len(marks)} markers, {len(ops)} device ops; device "
                  f"types {kinds})", file=sys.stderr)
            return None
        offset = marks[0] - self.marks[0]
        drift = (marks[1] - self.marks[1]) - offset
        return DeviceTimeline([(n, a - offset, b - offset)
                               for n, a, b in ops], drift_ns=drift)


@dataclass
class SpanRec:
    name: str
    path: str
    t0: int
    t1: int
    tid: int


def spans_of(tracer) -> List[SpanRec]:
    return [SpanRec(s.name, s.path, s.t0_ns, s.t1_ns, s._tid)
            for s in tracer.finished_spans()]


def innermost(spans: Sequence[SpanRec], at: int, tid: int) -> str:
    """The deepest span of thread ``tid`` open at host time ``at``."""
    best = None
    for s in spans:
        if s.tid == tid and s.t0 <= at < s.t1 and (
                best is None or s.path.count("/") > best.path.count("/")):
            best = s
    return best.path if best is not None else "(no span)"


def breakdown(tl: DeviceTimeline, spans: Sequence[SpanRec],
              window: Interval, tid: int, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps in the window, each named by the innermost span open at its
    middle."""
    by_name: Dict[str, int] = {}
    for n, a, b in tl.ops:
        by_name[n] = by_name.get(n, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = subtract(window[0], window[1], tl.busy)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[n[:120], ns * 1e-9] for n, ns in ops],
        "idle_gaps": [[innermost(spans, (a + b) // 2, tid), (b - a) * 1e-9]
                      for a, b in gaps],
    }
