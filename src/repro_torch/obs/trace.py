"""Tracer — structured spans and instants on the *modeled* timeline.

A `TraceEvent` is one record: a duration **span** (``dur`` seconds of
modeled device/stream time) or an **instant** (``dur is None`` — a point
event like a serving dispatch, a publish, a straggler flag). Every event
may carry the three attribution tags the `CostLedger` uses — ``stream``
(arrival stream id, or `FLEET_STREAM` −1 for fleet-caused work),
``device`` (fleet device name) and ``slot`` (model slot) — plus free-form
JSON-able ``args`` (wall-clock milliseconds, recompile flags, vmap bucket
sizes).

The span taxonomy is pinned in DESIGN.md §14. The invariant the obs test
suite enforces: duration-bearing spans with a ``device`` tag are emitted
exactly at `CostLedger` charge sites (`DEVICE_TIME_CATS`), so summing
their durations per device reproduces ``per_device[dev]["time_s"]`` to
float tolerance — the trace *is* the ledger, unrolled over time.

`NullTracer` is the disabled path: falsy, stateless, allocation-free.
Hot paths guard with ``if self.tracer:`` so a disabled run (the default)
never builds an event, never formats an arg, never moves a bit: a
traced run and an untraced one give bitwise equal results.

A copy of `repro.obs.trace`: the port's spans carry the reference's
categories, names, tags and args at the same sites.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

#: Categories whose spans carry modeled *device occupancy* time — one
#: span per `CostLedger` time charge. Per-device sums over exactly these
#: categories reconcile with `per_device[...]["time_s"]`; everything else
#: ("request" spans on stream tracks, instants) is observational.
DEVICE_TIME_CATS = frozenset(
    {"round", "segment", "resume", "swap", "sync", "probe", "cka"})


@dataclass
class TraceEvent:
    """One structured trace record (module docstring)."""
    name: str                      # human label, e.g. "round/cv"
    cat: str                       # taxonomy category, e.g. "round"
    ts: float                      # modeled start time (seconds)
    dur: Optional[float] = None    # span duration (None = instant)
    stream: Optional[int] = None   # arrival stream (-1 = fleet)
    device: Optional[str] = None   # fleet device lane
    slot: Optional[str] = None     # model slot
    args: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TraceEvent":
        return cls(**d)


class Tracer:
    """Collects `TraceEvent`s in memory; truthy, so instrumented call
    sites (guarded by ``if self.tracer:``) emit through it. Sinks
    (`repro_torch.obs.export`) serialize `events` after the run."""

    enabled = True

    def __init__(self):
        self.events: List[TraceEvent] = []

    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        return len(self.events)

    def reset(self) -> None:
        self.events = []

    def span(self, cat: str, name: str, ts: float, dur: float, *,
             stream: Optional[int] = None, device: Optional[str] = None,
             slot: Optional[str] = None, **args: Any) -> TraceEvent:
        """Record a duration span of `dur` modeled seconds at `ts`."""
        ev = TraceEvent(name, cat, float(ts), float(dur), stream, device,
                        slot, args)
        self.events.append(ev)
        return ev

    def instant(self, cat: str, name: str, ts: float, *,
                stream: Optional[int] = None, device: Optional[str] = None,
                slot: Optional[str] = None, **args: Any) -> TraceEvent:
        """Record a point event (no duration) at `ts`."""
        ev = TraceEvent(name, cat, float(ts), None, stream, device, slot,
                        args)
        self.events.append(ev)
        return ev


class NullTracer:
    """The disabled path: falsy and inert. Instrumented sites test
    ``if self.tracer:`` before building any event, so this object's
    methods exist only for unguarded/defensive calls."""

    enabled = False
    events: List[TraceEvent] = []  # always empty, shared, never written

    def __bool__(self) -> bool:
        return False

    def __len__(self) -> int:
        return 0

    def reset(self) -> None:
        pass

    def span(self, *a, **k) -> None:
        return None

    def instant(self, *a, **k) -> None:
        return None


#: Module singleton: the default value of every `tracer` attribute in the
#: runtime, so the disabled path costs one falsy attribute test.
NULL_TRACER = NullTracer()


def device_time(events: List[TraceEvent]) -> Dict[str, float]:
    """Summed durations of device-occupancy spans (`DEVICE_TIME_CATS`)
    per device — the trace-side half of the ledger reconciliation."""
    out: Dict[str, float] = {}
    for e in events:
        if e.dur is not None and e.device is not None \
                and e.cat in DEVICE_TIME_CATS:
            out[e.device] = out.get(e.device, 0.0) + e.dur
    return out
