"""Arrival processes for training-data batches and inference requests
(paper §V-A: Poisson by default; §V-D sensitivity adds uniform, normal and
a real-world trace). Deterministic given a seed.

A numpy-only copy of `repro.data.arrivals`: the same seed gives bitwise
the same events (tests/test_torch_data.py holds the two together)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Literal, Sequence

import numpy as np

Kind = Literal["data", "inference", "probe"]

#: Tie-break rank at equal timestamps: data batches dispatch before
#: inference requests, and drift-confirmation probes (detector mode) run
#: last — they observe the state the colliding events produced. Single
#: source of truth for both the scheduler's heap ordering and the workload
#: compiler's sort — they must agree or a pre-sorted timeline would not
#: replay in its constructed order.
KIND_ORDER = {"data": 0, "inference": 1, "probe": 2}


@dataclass(frozen=True)
class Event:
    time: float
    kind: Kind
    scenario: int
    index: int   # index within its (stream, kind) sequence
    stream: int = 0  # arrival stream id (0 = the single legacy stream)
    # QoS priority inherited from the stream's `StreamSpec.priority`:
    # higher dispatches first at equal (time, kind), and a high enough
    # priority may preempt an in-flight fine-tuning round (scheduler.py).
    # 0 = the legacy don't-care priority, so single-stream timelines are
    # byte-identical to their pre-QoS selves.
    priority: int = 0
    # Modality of the stream that emitted the event
    # (`StreamSpec.modality`, stamped by workloads/generators). A
    # ModelPool runtime resolves the event's model slot from this tag;
    # the single-model runtime ignores it. "cv" is the legacy default so
    # hand-built timelines stay valid.
    modality: str = "cv"


def interarrivals(dist: str, n: int, mean_gap: float,
                  rng: np.random.Generator,
                  trace: Sequence[float] = ()) -> np.ndarray:
    """Draw `n` inter-arrival gaps with the given mean from one of the
    paper's §V-D distributions."""
    if n <= 0:
        return np.zeros(0)
    if dist == "poisson":
        return rng.exponential(mean_gap, n)
    if dist == "uniform":
        return rng.uniform(0.0, 2.0 * mean_gap, n)
    if dist == "normal":
        return np.clip(rng.normal(mean_gap, 0.3 * mean_gap, n), 0.01 * mean_gap, None)
    if dist == "trace":
        # Real-world-trace mode: resample the provided inter-arrival trace
        # (normalized to the requested mean), mimicking §V-D's VTT trace.
        t = np.asarray(trace if len(trace) else _DEFAULT_TRACE, np.float64)
        t = t / t.mean() * mean_gap
        reps = int(np.ceil(n / t.size))
        return np.tile(t, reps)[:n]
    raise ValueError(dist)


# A bursty inter-arrival pattern standing in for the Video-Timeline-Tags
# trace used by the paper (long gaps between dense bursts).
_DEFAULT_TRACE = [0.2, 0.1, 0.15, 0.1, 3.0, 0.2, 0.1, 0.1, 4.5, 0.3,
                  0.1, 0.2, 0.1, 0.1, 6.0, 0.5, 0.2, 0.1, 2.5, 0.2]


def build_timeline(*, num_scenarios: int, batches_per_scenario: int,
                   inferences_total: int, scenario_span: float = 100.0,
                   data_dist: str = "poisson", inf_dist: str = "poisson",
                   seed: int = 0) -> List[Event]:
    """Merged, time-sorted event list. Scenario s occupies
    [s*span, (s+1)*span); its training batches arrive inside it; inference
    requests arrive over the whole horizon (paper Fig. 1: bursts allowed)."""
    rng = np.random.default_rng(seed)
    events: List[Event] = []
    for s in range(num_scenarios):
        gaps = interarrivals(data_dist, batches_per_scenario,
                             scenario_span / max(batches_per_scenario, 1) * 0.9,
                             rng)
        t = s * scenario_span + np.cumsum(gaps)
        t = np.minimum(t, (s + 1) * scenario_span - 1e-3)
        for i, ti in enumerate(t):
            events.append(Event(float(ti), "data", s, i))
    horizon = num_scenarios * scenario_span
    gaps = interarrivals(inf_dist, inferences_total,
                         horizon / max(inferences_total, 1), rng)
    t = np.cumsum(gaps)
    t = t * (horizon / max(t[-1], 1e-9)) if len(t) else t
    for i, ti in enumerate(t):
        s = min(int(ti // scenario_span), num_scenarios - 1)
        events.append(Event(float(ti), "inference", s, i))
    events.sort(key=lambda e: (e.time, e.kind))
    return events
