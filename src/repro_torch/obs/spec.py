"""TelemetrySpec — the declarative telemetry knob on `RuntimeConfig`.

Serializable like every other config piece (strict `to_dict`/`from_dict`
round trip, unknown keys raise listing the valid set). The default spec
is inactive: no tracer, no metrics, no sinks — the runtime takes the
legacy bit-exact path with zero telemetry allocations. Any of `enabled`
or a sink path activates it::

    RuntimeConfig(..., telemetry=TelemetrySpec(enabled=True,
                                               chrome_trace="run.json"))

A copy of `repro.obs.spec`. The port's live telemetry (`obs/telemetry.py`
and its metrics and sinks) comes with ROADMAP A.8: until then a session
whose spec is active raises `NotImplementedError`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class TelemetrySpec:
    """Telemetry configuration (module docstring).

    - `enabled`: collect spans + metrics in memory (exposed on the
      session as ``rt.telemetry`` after a run);
    - `trace_jsonl` / `chrome_trace`: sink paths written at run end
      (setting either implies collection);
    - `dispatch_events`: additionally record an instant per scheduler
      dispatch (event-level granularity; cheap, but the chattiest
      category — turn off for very long timelines).
    """
    enabled: bool = False
    trace_jsonl: Optional[str] = None
    chrome_trace: Optional[str] = None
    dispatch_events: bool = True

    @property
    def active(self) -> bool:
        return bool(self.enabled or self.trace_jsonl or self.chrome_trace)

    def validate(self, context: str = "telemetry") -> "TelemetrySpec":
        for fname in ("trace_jsonl", "chrome_trace"):
            v = getattr(self, fname)
            if v is not None and (not isinstance(v, str) or not v):
                raise ValueError(f"{context}: {fname} must be a non-empty "
                                 f"path string or None (got {v!r})")
        for fname in ("enabled", "dispatch_events"):
            if not isinstance(getattr(self, fname), bool):
                raise ValueError(f"{context}: {fname} must be a bool")
        return self

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"enabled": self.enabled}
        if self.trace_jsonl is not None:
            out["trace_jsonl"] = self.trace_jsonl
        if self.chrome_trace is not None:
            out["chrome_trace"] = self.chrome_trace
        if not self.dispatch_events:
            out["dispatch_events"] = False
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TelemetrySpec":
        if not isinstance(d, dict):
            raise ValueError(f"a telemetry spec must be a dict (got {d!r})")
        valid = {"enabled", "trace_jsonl", "chrome_trace", "dispatch_events"}
        unknown = set(d) - valid
        if unknown:
            raise ValueError(f"telemetry spec: unknown key(s) "
                             f"{sorted(unknown)}; valid: {sorted(valid)}")
        return cls(**d).validate()
