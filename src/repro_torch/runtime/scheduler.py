"""EventScheduler — the shared timeline of the continual-learning loop.

The paper's central tension (Fig. 1) is that training-data batches and
inference requests arrive on *one* wall-clock, and fine-tuning rounds
occupy it: a request landing mid-round is served by whatever params are
visible, and a round can only launch when the device is idle. This module
owns exactly that: the priority-ordered event queue, the `now`/`busy_until`
device-occupancy semantics, and scenario-boundary bookkeeping. It knows
nothing about models, params or cost models — those live behind the typed
callbacks (`on_data` / `on_inference` / `on_scenario_change`) a composition
root wires up. Counterpart of `repro.runtime.scheduler`.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

# Events pop in (time, kind, -priority, insertion-order) order: `"data" <
# "inference"` (KIND_ORDER), then higher `Event.priority` first, matching
# build_timeline's sort and workloads/generators.compile_workload's, so a
# pre-built timeline replays in exactly its constructed order. Priority 0
# everywhere (the legacy case) degenerates to the original
# (time, kind, insertion) order.
from repro_torch.data.arrivals import KIND_ORDER, Event
from repro_torch.obs.log import get_logger
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime.ledger import DEFAULT_DEVICE

log = get_logger("scheduler")

OnData = Callable[[Event, bool], None]          # (event, scenario_boundary)
OnInference = Callable[[Event], None]
OnScenarioChange = Callable[[int, Event], None]  # (previous_scenario, event)
OnProbe = Callable[[Event], None]                # detector-driven probe
OnInferenceSegment = Callable[[list], None]      # maximal run of inferences


@dataclass
class Reservation:
    """One granted slice of device time (`occupy`'s return value).

    Iterable as ``(start, end)`` so legacy ``start, end = occupy(...)``
    call sites keep working. A *preemptible* reservation may be split by
    `EventScheduler.preempt`: its `end` is pulled back to the preemption
    instant and the caller re-occupies the returned remainder, so one
    logical fine-tuning round becomes several reservations (segments)
    whose durations sum to the original grant."""
    start: float
    end: float
    stream: int = 0
    priority: int = 0
    preemptible: bool = False
    device: str = DEFAULT_DEVICE

    @property
    def duration(self) -> float:
        return self.end - self.start

    def __iter__(self):
        return iter((self.start, self.end))


class EventScheduler:
    """Priority-ordered timeline with device-occupancy accounting.

    - `push` accepts events in any order (streams may inject new work
      mid-run, e.g. detector-driven probes); dispatch is always
      time-ordered, stable for ties.
    - `occupy(start, duration)` models the device being busy: the actual
      start is delayed past any in-flight work (`busy_until`), and the
      returned `Reservation` carries the granted interval so callers can
      timestamp visibility. A *preemptible* reservation can be split at a
      strictly-higher-priority arrival (`can_preempt`/`preempt`) — QoS
      preemption, DESIGN.md §8.
    - scenario progress is tracked **per stream** (`scenario_of(stream)`):
      a stream's counter advances when one of its data events carries a new
      scenario id; the boundary is surfaced both via `on_scenario_change`
      and the `scenario_boundary` flag on `on_data`. Streams progress
      independently — stream 1 may still be in scenario 1 while stream 0
      has drifted to scenario 3.
    - `current_scenario` keeps its legacy meaning: the scenario id of the
      most recent data-event boundary, regardless of stream. Single-stream
      timelines (every event on stream 0) see exactly the pre-multi-stream
      behaviour; multi-stream callers should use `scenario_of`.
    """

    def __init__(self, events: Iterable[Event] = ()):
        self._heap: list = []
        self._seq = 0
        self.now = 0.0
        # Occupancy is tracked per fleet device (DESIGN.md §13); the
        # legacy scalar `busy_until` / `reservation` attributes remain as
        # views of the default device, so single-device callers (every
        # seed-era call site) see exactly the original semantics.
        self._busy: Dict[str, float] = {DEFAULT_DEVICE: 0.0}
        self._resv: Dict[str, Optional[Reservation]] = {DEFAULT_DEVICE: None}
        self.current_scenario = 0
        self.stream_scenarios: Dict[int, int] = {}
        self.dispatched = 0
        # observability (DESIGN.md §14): the fleet swaps in a live Tracer
        # when telemetry is enabled; the falsy NULL_TRACER default keeps
        # the dispatch loop allocation-free. `dropped_probes` counts probe
        # events popped with no `on_probe` handler wired (logged, since a
        # silently vanishing probe is a mis-wired composition root).
        self.tracer = NULL_TRACER
        self.trace_dispatch = True
        self.dropped_probes = 0
        for e in events:
            self.push(e)

    # ---- legacy single-device views --------------------------------------
    @property
    def busy_until(self) -> float:
        return self._busy[DEFAULT_DEVICE]

    @busy_until.setter
    def busy_until(self, value: float) -> None:
        self._busy[DEFAULT_DEVICE] = value

    @property
    def reservation(self) -> Optional[Reservation]:
        """In-flight grant on the default device."""
        return self._resv[DEFAULT_DEVICE]

    @reservation.setter
    def reservation(self, value: Optional[Reservation]) -> None:
        self._resv[DEFAULT_DEVICE] = value

    def busy_until_of(self, device: str = DEFAULT_DEVICE) -> float:
        return self._busy.get(device, 0.0)

    def reservation_of(self, device: str = DEFAULT_DEVICE) \
            -> Optional[Reservation]:
        return self._resv.get(device)

    @property
    def devices(self):
        """Device names that have been occupied at least once."""
        return sorted(self._busy)

    # ---- queue -----------------------------------------------------------
    def push(self, event: Event) -> None:
        key = (event.time, KIND_ORDER.get(event.kind, 2),
               -getattr(event, "priority", 0), self._seq)
        heapq.heappush(self._heap, (key, event))
        self._seq += 1

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def streams(self):
        """Stream ids that have dispatched at least one data event."""
        return sorted(self.stream_scenarios)

    def scenario_of(self, stream: int = 0) -> int:
        """Current scenario of one stream (0 until its first data event)."""
        return self.stream_scenarios.get(stream, 0)

    # ---- device occupancy ------------------------------------------------
    def idle_at(self, t: float, device: str = DEFAULT_DEVICE) -> bool:
        """True when `device` can start new work at time `t`."""
        return t >= self._busy.get(device, 0.0)

    def occupy(self, start: float, duration: float, *, stream: int = 0,
               priority: int = 0, preemptible: bool = False,
               device: str = DEFAULT_DEVICE) -> Reservation:
        """Reserve `device` for `duration` seconds, no earlier than
        `start` and never overlapping that device's in-flight work.
        Returns a `Reservation` (unpacks as ``(actual_start, end)`` for
        legacy callers); the device's `busy_until` advances to its end. A
        `preemptible` reservation may later be split by `preempt`.
        Devices occupy independently — the fleet's timelines only couple
        through the shared event queue and ledger."""
        actual = max(start, self._busy.get(device, 0.0))
        self._busy[device] = actual + duration
        self._resv[device] = Reservation(actual, self._busy[device], stream,
                                         priority, preemptible, device)
        return self._resv[device]

    def can_preempt(self, t: float, priority: int,
                    device: str = DEFAULT_DEVICE) -> bool:
        """True when an arrival of `priority` at time `t` may split the
        device's in-flight reservation: the device is busy, the
        reservation opted in, and the arrival outranks the reservation's
        stream."""
        r = self._resv.get(device)
        return (r is not None and r.preemptible and t < r.end
                and t >= r.start and priority > r.priority)

    def preempt(self, t: float, device: str = DEFAULT_DEVICE) -> float:
        """Split the device's in-flight reservation at time `t`: its `end`
        is pulled back to `t` (the completed segment), the device's
        `busy_until` rewinds with it, and the unserved remainder (seconds)
        is returned — the owner re-occupies it (usually immediately,
        yielding only the preemption *point* to the arrival). Callers gate
        on `can_preempt`; splitting a non-preemptible reservation is
        always an error (its cost was charged as one synchronous round)."""
        r = self._resv.get(device)
        if r is None or not r.preemptible or t < r.start or t >= r.end:
            raise ValueError(f"no preemptible reservation to split at t={t}")
        remaining = r.end - t
        r.end = t
        self._busy[device] = t
        self._resv[device] = None
        return remaining

    # ---- dispatch --------------------------------------------------------
    def run(self, *, on_data: OnData, on_inference: OnInference,
            on_scenario_change: Optional[OnScenarioChange] = None,
            on_probe: Optional[OnProbe] = None,
            on_inference_segment: Optional[OnInferenceSegment] = None
            ) -> None:
        """Drain the queue in time order, advancing `now` monotonically and
        emitting one callback per event. "probe" events (detector-driven
        drift confirmation, typically pushed mid-drain) go to `on_probe`
        and are dropped when no handler is wired — they carry no payload a
        generic embedder must not lose.

        With `on_inference_segment` wired (the compiled hot path,
        DESIGN.md §12), each *maximal run of consecutive inference
        events* — the timeline slice between two non-inference events —
        is popped in one go and delivered as a single segment, so the
        handler can fuse the whole run into one device call. Slicing
        never reorders: the segment's events are exactly the events
        `on_inference` would have seen, in the same order, and `now` /
        `dispatched` advance identically."""
        trace = self.tracer if self.trace_dispatch else NULL_TRACER
        while self._heap:
            _, ev = heapq.heappop(self._heap)
            self.now = max(self.now, ev.time)
            self.dispatched += 1
            if trace:
                trace.instant("dispatch", ev.kind, ev.time,
                              stream=ev.stream, scenario=ev.scenario)
            if ev.kind == "data":
                previous = self.stream_scenarios.get(ev.stream, 0)
                boundary = ev.scenario != previous
                if boundary:
                    self.stream_scenarios[ev.stream] = ev.scenario
                    self.current_scenario = ev.scenario
                    if on_scenario_change is not None:
                        on_scenario_change(previous, ev)
                elif ev.stream not in self.stream_scenarios:
                    self.stream_scenarios[ev.stream] = ev.scenario
                on_data(ev, boundary)
            elif ev.kind == "probe":
                if on_probe is not None:
                    on_probe(ev)
                else:
                    # a probe with no handler vanishes by design (it
                    # carries no payload a generic embedder must not
                    # lose) — but never silently: log + count it, so a
                    # mis-wired composition root is diagnosable
                    self.dropped_probes += 1
                    log.warning(
                        "probe event dropped at t=%.3f (stream %s): no "
                        "on_probe handler wired (%d dropped so far)",
                        ev.time, ev.stream, self.dropped_probes)
            elif on_inference_segment is not None:
                segment = [ev]
                while self._heap and self._heap[0][1].kind == "inference":
                    _, nxt = heapq.heappop(self._heap)
                    self.dispatched += 1
                    segment.append(nxt)
                if trace:
                    for nxt in segment[1:]:
                        trace.instant("dispatch", nxt.kind, nxt.time,
                                      stream=nxt.stream,
                                      scenario=nxt.scenario)
                self.now = max(self.now, segment[-1].time)
                on_inference_segment(segment)
            else:
                on_inference(ev)
