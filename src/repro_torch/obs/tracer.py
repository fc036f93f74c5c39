"""Lightweight thread-safe tracing + metrics.

One global :class:`Tracer` (swap with :func:`install`) records nested
spans into per-thread buffers. Spans carry wall time (perf_counter_ns),
thread id and *scalar* attributes only — sizes, tags, counts. Payloads
(arrays, bytes) are rejected at ``set()`` time so secret material can
never end up in a trace; the ``secretflow`` lint additionally flags any
tainted value reaching a span call site.

Export targets:

- ``tracer.export(path)`` — Chrome ``trace_event`` JSON, loadable in
  chrome://tracing or Perfetto (B/E duration events + instant events).
- ``tracer.report()`` — aggregated tree summary keyed by span *path*
  (``"offline/gc_offline"``): count / total_s / mean_s / max_s.

Disabled tracing is zero-cost-when-off: :data:`NULL_TRACER` returns one
shared pre-allocated no-op span, so instrumented call sites pay a single
attribute load + method call and allocate nothing.

Timing unification: call sites that need a wall-clock *measurement*
regardless of tracing (``Stats.phase``, the serve EWMAs) use
:func:`timer`, which always returns a real timing span — it records into
the trace buffer only when tracing is on, but ``elapsed_s`` is always
valid. This keeps one timing code path instead of three hand-rolled
``perf_counter()`` deltas.

Spans never enter kernels: instrument host-side dispatch only (this
module is pure stdlib). No attribute is read from a device tensor, so a
span never synchronises. The garbled-circuit path records, with their
parents:

- ``circuit.build`` — a netlist built on a cache miss
  (``PiTProtocol.build_fn_circuit``);
- ``gc_exec.get_executor`` — a level plan and executor looked up or
  built;
- ``garble.draw`` — R and the source zero-labels drawn and moved to the
  device (``garble.garble``), beside its ``gc_exec.garble`` walk;
- ``gc_offline`` / ``gc_offline.masks`` — the output-mask draws;
- ``gc_online`` / ``gc_online.encode`` (bit packing, garbler encoding,
  the OT label choice), ``gc_exec.evaluate`` (the walk) and
  ``gc_online.decode`` (waits for the walk, then decodes).
"""
from __future__ import annotations

import json
import threading
import time
from collections import defaultdict

_SCALAR = (int, float, str, bool)


def _check_attrs(attrs):
    for k, v in attrs.items():
        if not isinstance(v, _SCALAR):
            raise TypeError(
                f"span attribute {k!r} must be a scalar "
                f"(int/float/str/bool), got {type(v).__name__}; "
                "record sizes/tags/counts, never payloads")
    return attrs


class Span:
    """A timed region. Use as a context manager or close() by hand."""

    __slots__ = ("name", "attrs", "t0_ns", "t1_ns", "_tracer", "_tid",
                 "path")

    def __init__(self, name, attrs, tracer, tid, path):
        self.name = name
        self.attrs = attrs
        self._tracer = tracer
        self._tid = tid
        self.path = path
        self.t1_ns = None
        self.t0_ns = time.perf_counter_ns()

    @property
    def elapsed_s(self) -> float:
        """Seconds since start (or total duration once closed)."""
        end = self.t1_ns if self.t1_ns is not None else time.perf_counter_ns()
        return (end - self.t0_ns) * 1e-9

    def set(self, **attrs):
        """Attach scalar attributes (sizes/tags/counts — no payloads)."""
        self.attrs.update(_check_attrs(attrs))
        return self

    def close(self):
        if self.t1_ns is None:
            self.t1_ns = time.perf_counter_ns()
            if self._tracer is not None:
                self._tracer._finish(self)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _NullSpan:
    """Shared no-op span: no allocation, no time reads."""

    __slots__ = ()
    name = ""
    attrs: dict = {}
    path = ""
    elapsed_s = 0.0

    def set(self, **attrs):
        return self

    def close(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every call returns the shared no-op span."""

    enabled = False

    def span(self, name, **attrs):
        return _NULL_SPAN

    def instant(self, name, **attrs):
        return None

    def export(self, path):
        raise RuntimeError("tracing is disabled; enable() first")

    def report(self):
        return {}

    def clear(self):
        pass

    def finished_spans(self):
        return []

    def finished_instants(self):
        return []


NULL_TRACER = NullTracer()


class Tracer:
    """Recording tracer: per-thread span stacks + buffers.

    Each thread appends finished spans to its own list (list.append is
    atomic under the GIL, so the hot path takes no lock); the registry
    of per-thread buffers is guarded by a mutex touched once per thread.
    """

    enabled = True

    def __init__(self):
        self._local = threading.local()
        self._mutex = threading.Lock()
        # a LIST of per-thread buffers, not a tid-keyed dict: the OS
        # recycles thread idents, so a short-lived thread's tid can be
        # reissued and a dict entry would silently drop its spans
        self._buffers: list = []
        self._instants = []  # (name, ts_ns, tid, attrs), under _mutex
        self._epoch_ns = time.perf_counter_ns()

    def _state(self):
        st = getattr(self._local, "st", None)
        if st is None:
            tid = threading.get_ident()
            buf: list = []
            with self._mutex:
                self._buffers.append(buf)
            st = self._local.st = (tid, buf, [])  # (tid, buffer, stack)
        return st

    def span(self, name, **attrs):
        tid, _buf, stack = self._state()
        path = stack[-1].path + "/" + name if stack else name
        sp = Span(name, _check_attrs(attrs), self, tid, path)
        stack.append(sp)
        return sp

    def _finish(self, sp: Span):
        tid, buf, stack = self._state()
        # tolerate out-of-order closes (pop whatever is above sp too)
        while stack:
            top = stack.pop()
            if top is sp:
                break
        buf.append(sp)

    def instant(self, name, **attrs):
        """Zero-duration event (Chrome 'i' phase)."""
        tid = threading.get_ident()
        ev = (name, time.perf_counter_ns(), tid, _check_attrs(attrs))
        with self._mutex:
            self._instants.append(ev)

    def finished_spans(self):
        with self._mutex:
            bufs = list(self._buffers)
        out = []
        for b in bufs:
            out.extend(b[:len(b)])
        return out

    def finished_instants(self):
        with self._mutex:
            return list(self._instants)

    def clear(self):
        with self._mutex:
            for b in self._buffers:
                del b[:]
            del self._instants[:]

    # -- export ----------------------------------------------------------

    def export(self, path):
        """Write Chrome trace_event JSON (open in chrome://tracing)."""
        ep = self._epoch_ns
        events = []
        for sp in self.finished_spans():
            base = {"name": sp.name, "cat": "repro", "pid": 1,
                    "tid": sp._tid, "args": sp.attrs}
            events.append({**base, "ph": "B",
                           "ts": (sp.t0_ns - ep) / 1e3})
            events.append({**base, "ph": "E",
                           "ts": (sp.t1_ns - ep) / 1e3})
        with self._mutex:
            instants = list(self._instants)
        for name, ts_ns, tid, attrs in instants:
            events.append({"name": name, "cat": "repro", "pid": 1,
                           "tid": tid, "ph": "i", "s": "t",
                           "ts": (ts_ns - ep) / 1e3, "args": attrs})
        events.sort(key=lambda e: e["ts"])
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def report(self):
        """Aggregate finished spans by path: count/total/mean/max."""
        agg = defaultdict(lambda: [0, 0.0, 0.0])  # count, total, max
        for sp in self.finished_spans():
            a = agg[sp.path]
            d = (sp.t1_ns - sp.t0_ns) * 1e-9
            a[0] += 1
            a[1] += d
            if d > a[2]:
                a[2] = d
        return {
            path: {"count": c, "total_s": t, "mean_s": t / c, "max_s": m}
            for path, (c, t, m) in sorted(agg.items())
        }


# -- module-level current tracer -----------------------------------------

_current: "Tracer | NullTracer" = NULL_TRACER


def current():
    """The installed tracer (NULL_TRACER when tracing is off)."""
    return _current


def install(tracer):
    """Swap the global tracer; returns the previous one."""
    global _current
    prev = _current
    _current = tracer
    return prev


def enable() -> Tracer:
    """Install a fresh recording Tracer and return it."""
    tr = Tracer()
    install(tr)
    return tr


def disable():
    """Back to the no-op tracer."""
    install(NULL_TRACER)


def span(name, **attrs):
    """Open a span on the current tracer (no-op span when disabled)."""
    return _current.span(name, **attrs)


def instant(name, **attrs):
    """Zero-duration event on the current tracer."""
    return _current.instant(name, **attrs)


class _TimerSpan(Span):
    """A real timing span that is never recorded (tracing off)."""

    __slots__ = ()

    def __init__(self, name, attrs):
        super().__init__(name, attrs, None, 0, name)


def timer(name, **attrs):
    """A span whose ``elapsed_s`` is always a real measurement.

    When tracing is on this is a normal recorded span; when off it is a
    tiny unrecorded timing object. Call sites that *need* the duration
    (Stats.phase, serve EWMAs) use this so wall-clock accounting keeps
    working with tracing disabled, through one shared code path.
    """
    if _current.enabled:
        return _current.span(name, **attrs)
    return _TimerSpan(name, _check_attrs(attrs))
