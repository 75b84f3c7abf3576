"""Compile a `WorkloadSpec` down to the `Event` timeline.

The output is a plain, time-sorted ``List[Event]`` — exactly what
`EventScheduler` replays — with each event tagged by its arrival stream
and its stream's model-slot `modality` (the binding a `ModelPool` runtime
resolves to decide *which* model an event trains or serves).
Generation is **bit-reproducible**: every stream draws from its own
`np.random.Generator` seeded by ``(spec.seed, stream_index)``, so the
compiled timeline is a pure function of the spec and independent of
iteration order (a regression test pins this down).

Arrival processes: the four paper distributions (poisson / uniform /
normal / trace) are delegated to `repro_torch.data.arrivals.interarrivals`;
on top of those this module adds the modulated processes a single-stream
timeline cannot express — 2-state MMPP bursts and diurnal (sinusoidal)
rate curves — plus hard duty-cycle on/off windows applied as a time-warp.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.arrivals import (_DEFAULT_TRACE, KIND_ORDER, Event,
                                       interarrivals)
from repro_torch.workloads.spec import StreamSpec, WorkloadSpec


# ---------------------------------------------------------------------------
# modulated inter-arrival processes


def _mmpp_gaps(n: int, mean_gap: float, rng: np.random.Generator,
               cfg) -> np.ndarray:
    """2-state Markov-modulated Poisson: exponential gaps whose rate is
    scaled by the current state's multiplier; states hold for exponential
    dwell times. Normalized so the expected gap stays ~`mean_gap`."""
    if n <= 0:
        return np.zeros(0)
    # normalize the two multipliers so the *time-averaged* rate matches
    # the base rate (each state occupies half the time in expectation)
    scale = 2.0 / (cfg.burst_mult + cfg.idle_mult)
    mults = (cfg.burst_mult * scale, cfg.idle_mult * scale)
    base_rate = 1.0 / mean_gap
    state = int(rng.integers(2))          # 0 = burst, 1 = idle
    dwell_left = rng.exponential(cfg.mean_dwell)
    gaps = np.empty(n)
    for i in range(n):
        # time-change construction: each event needs Exp(1) of intensity
        # mass; the current state supplies it at base_rate * multiplier
        u = rng.exponential(1.0)
        gap = 0.0
        while True:
            rate = base_rate * mults[state]
            if u <= rate * dwell_left:
                gap += u / rate
                dwell_left -= u / rate
                break
            u -= rate * dwell_left
            gap += dwell_left
            state = 1 - state
            dwell_left = rng.exponential(cfg.mean_dwell)
        gaps[i] = gap
    return gaps


def _diurnal_times(n: int, horizon: float, rng: np.random.Generator,
                   cfg, duty=None) -> np.ndarray:
    """Non-homogeneous Poisson with rate(t) ∝ 1 + a·sin(2πt/period) on
    **wall-clock** time, realized by inverting the cumulative rate Λ(t)
    on a dense grid (standard NHPP time-change construction). A duty
    cycle composes as a multiplicative on/off indicator in the same rate
    function, so the configured diurnal period is never distorted and no
    arrival lands in an off-window."""
    if n <= 0:
        return np.zeros(0)
    grid = np.linspace(0.0, horizon, max(int(horizon * 8), 256))
    if duty is not None:
        # snap the grid to the on/off edges so every integration cell lies
        # entirely inside one window — the midpoint test below is then
        # exact and no inverted arrival can straddle a boundary
        starts = np.arange(0.0, horizon + duty.period, duty.period)
        edges = np.concatenate(
            [starts, starts + duty.period * duty.on_fraction])
        edges = edges[(edges > 0.0) & (edges < horizon)]
        grid = np.unique(np.concatenate([grid, edges]))
    rate = 1.0 + cfg.amplitude * np.sin(2 * np.pi * grid / cfg.period)
    seg = 0.5 * (rate[1:] + rate[:-1]) * np.diff(grid)
    if duty is not None:
        mid = 0.5 * (grid[1:] + grid[:-1])
        seg = seg * (mid % duty.period < duty.period * duty.on_fraction)
    lam = np.concatenate([[0.0], np.cumsum(seg)])
    # n homogeneous arrivals on [0, Λ(horizon)] -> warp back through Λ⁻¹
    u = np.sort(rng.uniform(0.0, lam[-1], n))
    return np.interp(u, lam, grid)


def _duty_cycle_warp(times: np.ndarray, cfg) -> np.ndarray:
    """Map 'active time' to wall-clock: each period contributes only its
    first ``on_fraction`` as live capture time, so arrivals generated on
    the compressed active axis land inside the on-windows."""
    on = cfg.period * cfg.on_fraction
    cycles = np.floor(times / on)
    return cycles * cfg.period + (times - cycles * on)


# ---------------------------------------------------------------------------
# per-stream event generation


def _arrival_times(dist: str, n: int, window: float,
                   rng: np.random.Generator, s: StreamSpec) -> np.ndarray:
    """`n` arrival times in [0, `window`) of **wall-clock** time, by
    distribution, honoring the stream's duty cycle. Diurnal composes the
    duty windows directly into its NHPP rate; the gap-based processes are
    generated on the duty-compressed active-time axis and warped back, so
    every arrival lands inside an on-window either way."""
    if n <= 0:
        return np.zeros(0)
    if dist == "diurnal":
        return _diurnal_times(n, window, rng, s.diurnal, s.duty_cycle)
    active = window * (s.duty_cycle.on_fraction if s.duty_cycle else 1.0)
    if dist == "trace-replay":
        # recorded-timestamp replay: consume the stream's recorded gaps
        # verbatim (tiled when n outruns the recording, falling back to
        # the module's VTT-style default trace) — deliberately NOT
        # rescaled into the window, so the recorded burst geometry
        # survives every scale knob; only the duty warp applies, like
        # any other gap-based process. Identical traces across streams
        # give perfectly correlated arrivals (the flash-crowd preset).
        gaps = np.asarray(s.trace if len(s.trace) else _DEFAULT_TRACE,
                          np.float64)
        t = np.cumsum(np.tile(gaps, int(np.ceil(n / gaps.size)))[:n])
        if s.duty_cycle is not None:
            t = _duty_cycle_warp(np.minimum(t, active - 1e-6),
                                 s.duty_cycle)
        return t
    if dist == "mmpp":
        t = np.cumsum(_mmpp_gaps(n, active / n, rng, s.mmpp))
    else:
        t = np.cumsum(interarrivals(dist, n, active / n, rng))
    # scale into the window (build_timeline does the same for inference
    # arrivals) so every spec'd event lands inside the horizon; clamp
    # strictly below the active span *before* warping — an arrival pinned
    # exactly to the end of active time would otherwise warp onto the
    # next period's off-boundary
    t = t * (active / max(t[-1], 1e-9))
    if s.duty_cycle is not None:
        t = _duty_cycle_warp(np.minimum(t, active - 1e-6), s.duty_cycle)
    return t


def stream_events(spec: WorkloadSpec, stream: int,
                  first_scenario: int = 1) -> List[Event]:
    """All events of one stream, un-merged. Scenario ids run
    ``first_scenario .. first_scenario + num_scenarios - 1`` (the runtime
    reserves benchmark scenario 0 for pretraining)."""
    s = spec.streams[stream]
    rng = np.random.default_rng([spec.seed, stream])
    offset = spec.stream_offset(stream) + s.phase
    span, horizon = spec.scenario_span, spec.horizon
    events: List[Event] = []
    # -- training-data batches: per scenario, inside its window ------------
    # (duty-cycle phase is anchored to each generation window's start —
    # coincident with the wall-clock duty grid whenever scenario_span is a
    # whole number of duty periods, as in the presets)
    for sc in range(spec.num_scenarios):
        t = _arrival_times(s.data_dist, s.batches_per_scenario, span * 0.9,
                           rng, s)
        t = offset + sc * span + np.minimum(t, span - 1e-3)
        for i, ti in enumerate(t):
            events.append(Event(float(ti), "data", first_scenario + sc, i,
                                stream=stream, priority=s.priority,
                                modality=s.modality))
    # -- inference requests: over the whole horizon ------------------------
    t = _arrival_times(s.inf_dist, s.inferences, horizon, rng, s)
    t = offset + np.minimum(t, horizon - 1e-3)
    for i, ti in enumerate(t):
        sc = min(int((ti - offset) // span), spec.num_scenarios - 1)
        events.append(Event(float(ti), "inference", first_scenario + sc, i,
                            stream=stream, priority=s.priority,
                            modality=s.modality))
    return events


def compile_workload(spec: WorkloadSpec,
                     first_scenario: int = 1) -> List[Event]:
    """Merged, time-sorted multi-stream timeline for `spec`. Ties break
    (kind: data first, then higher priority, then stream, then index) — a
    total order matching `EventScheduler`'s heap key, so the compiled
    timeline is deterministic given the spec and replays in exactly its
    constructed order."""
    spec.validate()
    events: List[Event] = []
    for stream in range(len(spec.streams)):
        events.extend(stream_events(spec, stream, first_scenario))
    events.sort(key=lambda e: (e.time, KIND_ORDER.get(e.kind, 2),
                               -e.priority, e.stream, e.index))
    return events
