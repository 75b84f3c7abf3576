"""Declarative workload specifications.

EdgeOL's premise is that fine-tuning and serving contend for one device
under realistic arrival patterns (§V-A Poisson arrivals, §V-D sensitivity
to uniform / normal / real-world-trace). A `WorkloadSpec` makes that axis
declarative: it names the arrival process *per stream*, the drift
(scenario) schedule, device duty-cycle windows and the stream mix, and
compiles (repro_torch.workloads.generators) down to the `Event` timeline
the `EventScheduler` replays. Everything is a frozen dataclass so specs are
hashable, comparable and trivially serializable for benchmark manifests.

Stream semantics: a stream is one independent arrival source (a camera, a
sensor, an app's query flow). Streams share the device (`busy_until`) and
the model parameters; scenario drift, controller signals and cost
attribution are tracked per stream (DESIGN.md §7).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

ARRIVAL_DISTS = ("poisson", "uniform", "normal", "trace", "mmpp", "diurnal",
                 "trace-replay")
DRIFT_SCHEDULES = ("aligned", "staggered")


@dataclass(frozen=True)
class MMPPConfig:
    """2-state Markov-modulated Poisson process: a bursty arrival pattern
    (dense bursts separated by quiet stretches — the capture pattern of
    motion-triggered edge cameras). The process alternates between a
    *burst* state and an *idle* state; each state holds for an
    exponentially distributed dwell time and scales the base arrival rate
    by its multiplier."""
    burst_mult: float = 6.0
    idle_mult: float = 0.25
    mean_dwell: float = 25.0  # mean sojourn per state, timeline seconds


@dataclass(frozen=True)
class DiurnalConfig:
    """Sinusoidal rate modulation — a smooth day/night load curve. The
    instantaneous rate swings between ``(1-amplitude)`` and
    ``(1+amplitude)`` times the base rate over one `period`."""
    period: float = 120.0
    amplitude: float = 0.8


@dataclass(frozen=True)
class DutyCycle:
    """Hard on/off capture windows (duty-cycled devices: the stream emits
    only during the first ``on_fraction`` of every ``period``)."""
    period: float = 50.0
    on_fraction: float = 0.5


@dataclass(frozen=True)
class StreamSpec:
    """One arrival source. `benchmark` binds the stream to a continual-
    learning data stream (repro_torch.data.streams.REGISTRY) when a spec is
    materialized by the benchmark harness; the arrival fields shape *when*
    its batches and requests land. `modality` names the stream's **model
    slot**: `compile_workload` stamps it on every event the stream emits,
    and a `ModelPool` runtime (DESIGN.md §9) resolves each event to the
    slot of that name — so a 'cv' and an 'nlp' stream really train and
    serve different models on the one shared device."""
    modality: str = "cv"              # model-slot key ('cv' | 'nlp' | ...)
    benchmark: str = "nc"             # repro_torch.data.streams.REGISTRY key
    data_dist: str = "poisson"        # one of ARRIVAL_DISTS
    inf_dist: str = "poisson"
    batches_per_scenario: int = 8
    inferences: int = 24              # requests over the whole horizon
    phase: float = 0.0                # wall-clock offset of this stream
    # QoS priority (higher = more latency-critical): rides on every event
    # the stream emits; at equal timestamps higher-priority events
    # dispatch first, and when the runtime runs `preemptible=True` the
    # stream's inference arrivals split in-flight fine-tuning rounds of
    # strictly lower-priority streams. 0 = bulk / best-effort.
    priority: int = 0
    mmpp: Optional[MMPPConfig] = None
    diurnal: Optional[DiurnalConfig] = None
    duty_cycle: Optional[DutyCycle] = None
    # Recorded inter-arrival gaps (seconds) for the 'trace-replay'
    # distribution: consumed verbatim — tiled when the event count
    # outruns the recording, never rescaled to the window, so the
    # recorded burst geometry survives every scale knob. Empty falls
    # back to `repro_torch.data.arrivals._DEFAULT_TRACE` (the VTT-style
    # bursty stand-in). Contrast with 'trace', which *resamples* the
    # same recording normalized to the requested mean rate.
    trace: Tuple[float, ...] = ()


@dataclass(frozen=True)
class WorkloadSpec:
    """A full workload: stream mix + drift schedule + horizon geometry.

    - `num_scenarios` counts *tuning* scenarios; the harness maps them to
      benchmark scenarios 1..num_scenarios (scenario 0 pretrains).
    - `drift`: 'aligned' — every stream crosses scenario boundaries at the
      same wall-clock; 'staggered' — stream i's boundaries are offset by
      ``i/len(streams)`` of a scenario span, so drift hits streams at
      different times (the multi-camera rollout case).
    """
    name: str
    streams: Tuple[StreamSpec, ...]
    num_scenarios: int = 3
    scenario_span: float = 100.0
    drift: str = "aligned"
    seed: int = 0

    def validate(self) -> "WorkloadSpec":
        if not self.streams:
            raise ValueError(f"workload {self.name!r}: needs >= 1 stream")
        if self.num_scenarios < 1 or self.scenario_span <= 0:
            raise ValueError(f"workload {self.name!r}: bad horizon geometry")
        if self.drift not in DRIFT_SCHEDULES:
            raise ValueError(f"workload {self.name!r}: drift {self.drift!r} "
                             f"not in {DRIFT_SCHEDULES}")
        for i, s in enumerate(self.streams):
            if not isinstance(s.modality, str) or not s.modality:
                raise ValueError(
                    f"workload {self.name!r} stream {i}: modality must be "
                    f"a non-empty model-slot key (got {s.modality!r})")
            if not isinstance(s.priority, int) or s.priority < 0:
                raise ValueError(
                    f"workload {self.name!r} stream {i}: priority must be "
                    f"a non-negative int (got {s.priority!r})")
            for d in (s.data_dist, s.inf_dist):
                if d not in ARRIVAL_DISTS:
                    raise ValueError(
                        f"workload {self.name!r} stream {i}: arrival "
                        f"{d!r} not in {ARRIVAL_DISTS}")
            if "mmpp" in (s.data_dist, s.inf_dist):
                m = s.mmpp
                if m is None:
                    raise ValueError(
                        f"workload {self.name!r} stream {i}: 'mmpp' "
                        f"arrivals need an MMPPConfig")
                if m.burst_mult <= 0 or m.idle_mult <= 0 or m.mean_dwell <= 0:
                    raise ValueError(
                        f"workload {self.name!r} stream {i}: MMPP "
                        f"multipliers and dwell must be positive")
            if "diurnal" in (s.data_dist, s.inf_dist):
                d = s.diurnal
                if d is None:
                    raise ValueError(
                        f"workload {self.name!r} stream {i}: 'diurnal' "
                        f"arrivals need a DiurnalConfig")
                # amplitude > 1 makes the NHPP rate negative and its
                # cumulative integral non-monotone (inversion breaks)
                if not (0.0 <= d.amplitude <= 1.0) or d.period <= 0:
                    raise ValueError(
                        f"workload {self.name!r} stream {i}: diurnal "
                        f"amplitude must be in [0, 1] and period > 0")
            if s.duty_cycle is not None and not (
                    0 < s.duty_cycle.on_fraction <= 1):
                raise ValueError(
                    f"workload {self.name!r} stream {i}: on_fraction "
                    f"must be in (0, 1]")
            if "trace-replay" in (s.data_dist, s.inf_dist):
                for g in s.trace:
                    if not (isinstance(g, (int, float))
                            and math.isfinite(g) and g > 0):
                        raise ValueError(
                            f"workload {self.name!r} stream {i}: "
                            f"trace-replay gaps must be positive finite "
                            f"seconds (got {g!r})")
        return self

    @property
    def horizon(self) -> float:
        return self.num_scenarios * self.scenario_span

    @property
    def modalities(self) -> Tuple[str, ...]:
        """Distinct model-slot keys, in first-stream order — the slots a
        `ModelPool` must provide to run this workload. A single-entry
        result means the workload runs on the plain single-model path."""
        seen = []
        for s in self.streams:
            if s.modality not in seen:
                seen.append(s.modality)
        return tuple(seen)

    def stream_offset(self, stream: int) -> float:
        """Wall-clock offset of `stream`'s scenario boundaries."""
        if self.drift == "staggered" and len(self.streams) > 1:
            return self.scenario_span * stream / len(self.streams)
        return 0.0

    def describe(self) -> Dict:
        """JSON-ready summary used by benchmark manifests."""
        return {
            "name": self.name, "num_streams": len(self.streams),
            "num_scenarios": self.num_scenarios,
            "scenario_span": self.scenario_span, "drift": self.drift,
            "seed": self.seed,
            "streams": [dataclasses.asdict(s) for s in self.streams],
        }
