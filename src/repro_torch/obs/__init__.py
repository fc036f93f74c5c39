"""Tracing + metrics subsystem (host-side only; stdlib only).

Usage::

    from repro_torch import obs
    tr = obs.enable()                  # install a recording tracer
    with obs.span("garble", netlist="softmax8", instances=64):
        ...
    tr.export("trace.json")            # chrome://tracing / Perfetto
    tr.report()                        # {path: {count, total_s, ...}}
    obs.disable()

When disabled (the default) ``obs.span()`` returns one shared no-op
span — no allocation, no clock reads.
"""
from repro_torch.obs.tracer import (  # noqa: F401
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    current,
    disable,
    enable,
    install,
    instant,
    span,
    timer,
)

__all__ = [
    "NULL_TRACER", "NullTracer", "Span", "Tracer", "current", "disable",
    "enable", "install", "instant", "span", "timer",
]
