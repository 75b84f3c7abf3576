"""The disabled tracer (counterpart of `repro.obs.trace.NullTracer`).

Instrumented call sites test ``if self.tracer:`` before building any
event, so the falsy `NULL_TRACER` default costs one attribute test; a
caller may pass any truthy object with the same `span`/`instant`
methods to record events."""
from __future__ import annotations


class NullTracer:
    """Falsy and inert: the default `tracer` of the scheduler and the
    inference server."""

    def __bool__(self) -> bool:
        return False

    def span(self, *a, **k) -> None:
        return None

    def instant(self, *a, **k) -> None:
        return None


NULL_TRACER = NullTracer()
