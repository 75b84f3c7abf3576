"""MetricsRegistry — labeled counters, gauges and histograms.

The registry is the aggregate view the Tracer's event stream is too raw
for: per-stream serving-latency histograms, per-device utilization
gauges, swap/sync/preemption/recompile counters, and — crucially — the
`time_s`/`energy_j`/`flops` counters the `CostLedger` bumps through its
telemetry observer at every charge. Because ledger and registry see the
*same* increments, `Telemetry.reconcile(ledger)` is exact by
construction (float-identical, not merely close), across all three
attribution dimensions.

Metrics are identified by ``(name, frozen label set)``: ``counter("syncs",
device="dev1")`` get-or-creates one instrument per label combination.
`snapshot()` renders everything JSON-ready with stable
``name{k=v,...}`` keys (a copy of `repro.obs.metrics`: the same
operations give the reference's snapshot, key for key).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, Any]) -> _Key:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render(key: _Key) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing float."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Append-only sample set summarized at snapshot time (count / sum /
    min / max / p50 / p95). Runs are bounded (one sample per request), so
    samples are kept exact rather than bucketed."""

    __slots__ = ("samples",)

    def __init__(self):
        self.samples: List[float] = []

    def observe(self, value: float) -> None:
        self.samples.append(float(value))

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {"count": 0, "sum": 0.0}
        s = sorted(self.samples)
        n = len(s)

        def pct(q: float) -> float:
            return s[min(n - 1, int(q * (n - 1) + 0.5))]

        return {"count": n, "sum": float(sum(s)), "min": s[0], "max": s[-1],
                "p50": pct(0.50), "p95": pct(0.95)}


class MetricsRegistry:
    def __init__(self):
        self._counters: Dict[_Key, Counter] = {}
        self._gauges: Dict[_Key, Gauge] = {}
        self._histograms: Dict[_Key, Histogram] = {}

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._counters.setdefault(_key(name, labels), Counter())

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._gauges.setdefault(_key(name, labels), Gauge())

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._histograms.setdefault(_key(name, labels), Histogram())

    def counter_value(self, name: str, **labels: Any) -> float:
        c = self._counters.get(_key(name, labels))
        return c.value if c is not None else 0.0

    def sum_counters(self, name: str, **labels: Any) -> float:
        """Sum of every counter named `name` whose labels include the
        given subset (e.g. ``sum_counters("time_s", device="dev0")``)."""
        want = set(_key(name, labels)[1])
        return sum(c.value for (n, ls), c in self._counters.items()
                   if n == name and want <= set(ls))

    def label_values(self, name: str, label: str) -> List[str]:
        """Distinct values `label` takes across counters named `name`."""
        out = set()
        for (n, ls) in self._counters:
            if n != name:
                continue
            for k, v in ls:
                if k == label:
                    out.add(v)
        return sorted(out)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready dump: counters/gauges as scalars, histograms as
        summary dicts, keys rendered ``name{label=value,...}``."""
        return {
            "counters": {_render(k): c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {_render(k): g.value
                       for k, g in sorted(self._gauges.items())},
            "histograms": {_render(k): h.summary()
                           for k, h in sorted(self._histograms.items())},
        }
