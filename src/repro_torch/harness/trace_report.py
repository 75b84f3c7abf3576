"""Summarize an EdgeOL telemetry trace (DESIGN.md §14); the port's copy
of `benchmarks/trace_report.py`, on `repro_torch.obs`.

Reads either sink format — the JSONL event feed or the Chrome
trace-event export (`events_from_chrome` inverts it) — and prints three
human summaries of the modeled run:

- a per-device **utilization timeline** (bucketed occupancy bars),
- a per-device **round Gantt** (fine-tune rounds / segments / syncs as
  they landed on each lane),
- the **top-N slowest spans** (where the modeled device time went).

``--validate`` instead runs the strict Chrome-trace loader and exits
non-zero on a malformed file — the CI gate for the bench-smoke artifact.

    PYTHONPATH=src python -m repro_torch.harness.trace_report trace.json
    PYTHONPATH=src python -m repro_torch.harness.trace_report t.jsonl --top 20
    PYTHONPATH=src python -m repro_torch.harness.trace_report t.json --validate
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from repro_torch.obs import (DEVICE_TIME_CATS, TraceEvent, chrome_tracks,
                             device_time, events_from_chrome,
                             load_chrome_trace, read_jsonl)

#: Occupancy ramp for the utilization bars: " " = idle, "#" = saturated.
RAMP = " .:-=#"

#: Default bucket count of the utilization timeline.
BUCKETS = 60


def load_events(path: str) -> List[TraceEvent]:
    """Load a trace from either sink format: a ``.jsonl`` suffix (or a
    first line that parses as a single event record) means the JSONL
    feed, anything else the Chrome export."""
    if path.endswith(".jsonl"):
        return read_jsonl(path)
    with open(path) as f:
        first = f.readline()
    try:
        head = json.loads(first)
    except json.JSONDecodeError:
        head = None
    if isinstance(head, dict) and "traceEvents" not in head \
            and "ts" in head:
        return read_jsonl(path)
    return events_from_chrome(load_chrome_trace(path))


# ---------------------------------------------------------------------------
# summaries


def _span_of(events: List[TraceEvent]) -> tuple:
    ts = [e.ts for e in events] + \
        [e.ts + e.dur for e in events if e.dur is not None]
    return (min(ts), max(ts)) if ts else (0.0, 0.0)


def utilization_timeline(events: List[TraceEvent], *,
                         buckets: int = BUCKETS) -> str:
    """Per-device occupancy bars: each column is one time bucket, its
    glyph the fraction of the bucket covered by device-time spans."""
    t0, t1 = _span_of(events)
    width = max(t1 - t0, 1e-9)
    step = width / buckets
    occ: Dict[str, List[float]] = {}
    for e in events:
        if e.dur is None or e.device is None or e.cat not in DEVICE_TIME_CATS:
            continue
        lane = occ.setdefault(e.device, [0.0] * buckets)
        lo, hi = e.ts, e.ts + e.dur
        b0 = max(0, min(buckets - 1, int((lo - t0) / step)))
        b1 = max(0, min(buckets - 1, int((hi - t0) / step)))
        for b in range(b0, b1 + 1):
            blo, bhi = t0 + b * step, t0 + (b + 1) * step
            lane[b] += max(0.0, min(hi, bhi) - max(lo, blo))
    lines = [f"utilization ({t0:.1f}s .. {t1:.1f}s, "
             f"{step:.2f}s/bucket, ramp '{RAMP}')"]
    for dev in sorted(occ):
        busy = device_time(events).get(dev, 0.0)
        bar = "".join(
            RAMP[min(len(RAMP) - 1, int(frac / step * (len(RAMP) - 1) + 1e-9))]
            if frac > 0 else RAMP[0]
            for frac in occ[dev])
        lines.append(f"  {dev:>8} |{bar}| busy {busy:.1f}s "
                     f"({busy / width * 100:.0f}%)")
    if len(lines) == 1:
        lines.append("  (no device-time spans in trace)")
    return "\n".join(lines)


def round_gantt(events: List[TraceEvent], *, limit: int = 40) -> str:
    """Chronological listing of the fine-tune work per device lane:
    rounds, preemption segments, resumes, swaps and fleet syncs."""
    cats = {"round", "segment", "resume", "swap", "sync"}
    rows = sorted((e for e in events
                   if e.dur is not None and e.device is not None
                   and e.cat in cats),
                  key=lambda e: (e.ts, e.device or ""))
    lines = [f"round gantt ({len(rows)} spans"
             + (f", first {limit} shown" if len(rows) > limit else "")
             + ")"]
    for e in rows[:limit]:
        tag = f" stream {e.stream}" if e.stream is not None \
            and e.stream >= 0 else ""
        extra = ""
        if e.args.get("recompiled"):
            extra += " [recompiled]"
        if e.cat == "segment":
            extra += f" seg#{e.args.get('seg', '?')}" + \
                (" final" if e.args.get("final") else "")
        lines.append(f"  {e.ts:9.2f}s +{e.dur:7.2f}s  {e.device:>8} "
                     f"{e.cat:>7} {e.name}{tag}{extra}")
    if len(rows) == 0:
        lines.append("  (no fine-tune spans in trace)")
    return "\n".join(lines)


def slowest_spans(events: List[TraceEvent], *, top: int = 10) -> str:
    """The top-N duration spans — where the modeled time went."""
    spans = sorted((e for e in events if e.dur is not None),
                   key=lambda e: -e.dur)[:top]
    lines = [f"top {len(spans)} slowest spans"]
    for e in spans:
        where = e.device or (f"stream {e.stream}"
                             if e.stream is not None else "?")
        lines.append(f"  {e.dur:9.3f}s  {e.cat:>7} {e.name:<20} on {where} "
                     f"@ {e.ts:.2f}s")
    if not spans:
        lines.append("  (no duration spans in trace)")
    return "\n".join(lines)


def summarize(events: List[TraceEvent], *, top: int = 10,
              buckets: int = BUCKETS, gantt_limit: int = 40) -> str:
    n_inst = sum(1 for e in events if e.dur is None)
    devs = sorted({e.device for e in events if e.device is not None})
    streams = sorted({e.stream for e in events if e.stream is not None})
    head = (f"{len(events)} events ({len(events) - n_inst} spans, "
            f"{n_inst} instants) | devices: {', '.join(devs) or '-'} | "
            f"streams: {', '.join(str(s) for s in streams) or '-'}")
    return "\n\n".join([head,
                        utilization_timeline(events, buckets=buckets),
                        round_gantt(events, limit=gantt_limit),
                        slowest_spans(events, top=top)])


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="trace file: Chrome JSON or JSONL")
    ap.add_argument("--top", type=int, default=10,
                    help="slowest spans to list (default 10)")
    ap.add_argument("--buckets", type=int, default=BUCKETS,
                    help="utilization timeline buckets (default 60)")
    ap.add_argument("--gantt", type=int, default=40,
                    help="max gantt rows (default 40)")
    ap.add_argument("--validate", action="store_true",
                    help="strict Chrome-trace validation only (CI gate): "
                         "check structure + track metadata, print the "
                         "track inventory, exit non-zero on failure")
    args = ap.parse_args(argv)

    if args.validate:
        try:
            doc = load_chrome_trace(args.trace)
        except ValueError as e:
            print(f"INVALID: {e}", file=sys.stderr)
            return 1
        tracks = chrome_tracks(doc)
        print(f"{args.trace}: valid Chrome trace, "
              f"{len(doc['traceEvents'])} records")
        print(f"  device tracks: {json.dumps(tracks['devices'])}")
        print(f"  stream tracks: {json.dumps(tracks['streams'])}")
        return 0

    try:
        events = load_events(args.trace)
    except (ValueError, OSError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    print(summarize(events, top=args.top, buckets=args.buckets,
                    gantt_limit=args.gantt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
