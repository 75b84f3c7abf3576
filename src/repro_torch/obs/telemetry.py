"""Telemetry — the live observability bundle one session carries.

Built by `resolve_session` when `RuntimeConfig.telemetry` is active and
threaded to `ContinualRuntime._init` as ``telemetry=``; the `DeviceFleet`
resets it per run, hands its `tracer` to every instrumented subsystem,
installs it as the `CostLedger`'s observer, and flushes the configured
sinks at run end. A session without telemetry carries ``None`` and every
hot path short-circuits on the falsy `NULL_TRACER` — the disabled run is
allocation-free and bit-exact.

The ledger-observer contract (`on_charge`/`on_round`/`on_preemption`/
`on_swap`/`on_sync`) mirrors `CostLedger`'s charge methods one-to-one:
each charge bumps the matching `time_s`/`energy_j`/`flops` counters per
stream, per model and per device, so `reconcile(ledger)` — the max
absolute difference between counter sums and ledger attributions across
all three dimensions — is zero by construction on a consistent run.

A copy of `repro.obs.telemetry`. Nothing here touches a tensor: every
hook takes the ledger's Python floats, so a traced run on the card
launches and synchronizes exactly as an untraced one.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.obs.export import write_chrome_trace, write_jsonl
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.spec import TelemetrySpec
from repro_torch.obs.trace import Tracer

#: (ledger dimension name, counter label key) pairs `reconcile` walks.
_DIMS = (("per_stream", "stream"), ("per_model", "model"),
         ("per_device", "device"))


class Telemetry:
    def __init__(self, spec: Optional[TelemetrySpec] = None):
        self.spec = spec if spec is not None else TelemetrySpec(enabled=True)
        self.tracer = Tracer()
        self.metrics = MetricsRegistry()

    def reset(self) -> None:
        """Fresh tracer + registry (the fleet calls this at run start so
        a session re-run doesn't accumulate the previous run's events)."""
        self.tracer = Tracer()
        self.metrics = MetricsRegistry()

    # ---- CostLedger observer hooks ---------------------------------------
    def on_charge(self, *, time_s: float, energy_j: float, flops: float,
                  stream: int, model: str, device: str,
                  kind: str = "round") -> None:
        """Every ledger charge lands here once; `kind` is the breakdown
        family ('round', 'cka', 'swap', 'sync', 'probe', 'resume')."""
        m = self.metrics
        for name, amount in (("time_s", time_s), ("energy_j", energy_j),
                             ("flops", flops)):
            if amount:
                m.counter(name, stream=stream).inc(amount)
                m.counter(name, model=model).inc(amount)
                m.counter(name, device=device).inc(amount)
        m.counter("charges", kind=kind).inc()

    def on_round(self, *, stream: int, model: str, device: str) -> None:
        self.metrics.counter("rounds", device=device).inc()
        self.metrics.counter("rounds", stream=stream).inc()

    def on_preemption(self, *, stream: int) -> None:
        self.metrics.counter("preemptions", stream=stream).inc()

    def on_swap(self, *, model: str, device: str) -> None:
        self.metrics.counter("swaps", device=device).inc()
        self.metrics.counter("swaps", model=model).inc()

    def on_sync(self, *, device: str) -> None:
        self.metrics.counter("syncs", device=device).inc()

    # ---- reporting -------------------------------------------------------
    def reconcile(self, ledger) -> Dict[str, float]:
        """Max |counter sum − ledger attribution| per (dimension, field):
        ``{"per_stream.time_s": 0.0, ...}``. Exact zeros on a consistent
        run — the test suite asserts tiny float tolerances anyway."""
        out: Dict[str, float] = {}
        for dim_name, label in _DIMS:
            dim = getattr(ledger, dim_name)
            for fname in ("time_s", "energy_j", "flops"):
                worst = 0.0
                for key, cell in dim.items():
                    got = self.metrics.sum_counters(fname, **{label: key})
                    worst = max(worst, abs(got - cell.get(fname, 0.0)))
                out[f"{dim_name}.{fname}"] = worst
        return out

    def snapshot(self, ledger=None) -> Dict[str, Any]:
        """Metrics snapshot, with the ledger reconciliation and totals
        attached when a ledger is given. `ledger` may be the live
        `CostLedger` or a finished `RunResult` — both carry the three
        attribution dicts `reconcile` walks (the result's flops total is
        reported in TFLOPs, hence the fallback)."""
        snap = self.metrics.snapshot()
        snap["trace_events"] = len(self.tracer.events)
        if ledger is not None:
            flops = getattr(ledger, "total_flops", None)
            if flops is None:
                flops = ledger.compute_tflops * 1e12
            snap["ledger"] = {"total_time_s": ledger.total_time_s,
                              "total_energy_j": ledger.total_energy_j,
                              "total_flops": flops,
                              "rounds": ledger.rounds}
            snap["reconciliation"] = self.reconcile(ledger)
        return snap

    def flush_sinks(self) -> None:
        """Write the configured trace sinks (no-op when no paths set)."""
        if self.spec.trace_jsonl:
            write_jsonl(self.tracer.events, self.spec.trace_jsonl)
        if self.spec.chrome_trace:
            write_chrome_trace(self.tracer.events, self.spec.chrome_trace)
