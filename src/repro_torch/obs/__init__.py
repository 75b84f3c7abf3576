"""repro_torch.obs — the port's observability layer (a copy of
`repro.obs`, DESIGN.md §14).

Three cooperating pieces, all optional and all off by default:

- `trace` — a `Tracer` recording structured spans/instants on the
  *modeled* timeline (rounds, preemption segments, swaps, syncs, probes,
  serving dispatches), tagged with stream/device/slot; `NULL_TRACER` is
  the falsy no-op stand-in every hot path guards on, so a disabled run
  allocates nothing and stays bit-exact.
- `metrics` — a `MetricsRegistry` of labeled counters/gauges/histograms
  fed by the `CostLedger` observer hook, so `snapshot()` reconciles
  against ledger totals exactly (per stream, per model, per device).
- `export` — JSONL and Chrome trace-event (Perfetto-loadable) sinks plus
  the validating loader; the files are the reference's format.

`TelemetrySpec` (spec.py) is the JSON-round-trippable config knob
(`RuntimeConfig.telemetry`); `Telemetry` (telemetry.py) is the live
bundle a session carries. `log` is the structured-logging bootstrap
(`EDGEOL_LOG` env level) the port logs through.
"""
from repro_torch.obs.export import (chrome_trace, chrome_tracks,
                                    events_from_chrome, load_chrome_trace,
                                    read_jsonl, write_chrome_trace,
                                    write_jsonl)
from repro_torch.obs.log import configure_logging, get_logger
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.spec import TelemetrySpec
from repro_torch.obs.telemetry import Telemetry
from repro_torch.obs.trace import (DEVICE_TIME_CATS, NULL_TRACER,
                                   NullTracer, TraceEvent, Tracer,
                                   device_time)

__all__ = [
    "Counter", "DEVICE_TIME_CATS", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_TRACER", "NullTracer", "Telemetry", "TelemetrySpec", "TraceEvent",
    "Tracer", "chrome_trace", "chrome_tracks", "configure_logging",
    "device_time",
    "events_from_chrome", "get_logger", "load_chrome_trace", "read_jsonl",
    "write_chrome_trace", "write_jsonl",
]
