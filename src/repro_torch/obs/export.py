"""Trace sinks: JSONL (full-fidelity round trip) and Chrome trace-event
JSON (Perfetto-loadable), plus the validating loader (a copy of
`repro.obs.export`: a file written by either package loads in the
other).

JSONL is the machine feed (one `TraceEvent` dict per line; `read_jsonl ∘
write_jsonl` is the identity — a test pins it). The Chrome export is the
human feed: open https://ui.perfetto.dev and drag the file in, or load
it at chrome://tracing. Track layout (DESIGN.md §14):

- **pid 1 "devices"** — one thread (track) per fleet device lane, named
  after the device. Every event tagged with a ``device`` lands here;
  duration spans on these tracks are exactly the ledger's device-time
  charges, so the lane reads as the device's occupancy Gantt.
- **pid 2 "streams"** — one track per arrival stream (the fleet
  pseudo-stream −1 renders as "fleet"). Every event tagged with a
  ``stream`` lands here too (an event may appear on both a device and a
  stream track — same span, two views).

Timestamps/durations are modeled seconds scaled to the format's
microseconds. Provenance (stream/device/slot) rides in each event's
``args``, so `events_from_chrome` can invert the export (device-track
copies win; stream-only events are picked off pid 2), so a summary can
read either sink format.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List

from repro_torch.obs.trace import TraceEvent

#: Chrome trace pids: one process groups the device lanes, one the
#: per-stream tracks.
DEVICE_PID = 1
STREAM_PID = 2

#: Display name of the fleet pseudo-stream's track (FLEET_STREAM = -1).
FLEET_TRACK = "fleet"

_US = 1e6  # modeled seconds -> trace microseconds


# ---------------------------------------------------------------------------
# JSONL


def write_jsonl(events: List[TraceEvent], path: str) -> None:
    """One JSON object per line; directories are created on demand."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e.to_dict(), sort_keys=True))
            f.write("\n")


def read_jsonl(path: str) -> List[TraceEvent]:
    out: List[TraceEvent] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(TraceEvent.from_dict(json.loads(line)))
            except (json.JSONDecodeError, TypeError) as e:
                raise ValueError(f"malformed trace JSONL {path} "
                                 f"line {i + 1}: {e}") from None
    return out


# ---------------------------------------------------------------------------
# Chrome trace-event format


def _stream_track(stream: int) -> str:
    return FLEET_TRACK if stream < 0 else f"stream {stream}"


def chrome_trace(events: List[TraceEvent]) -> Dict[str, Any]:
    """Build a Chrome trace-event document (module docstring layout)."""
    devices = sorted({e.device for e in events if e.device is not None})
    streams = sorted({e.stream for e in events if e.stream is not None})
    dev_tid = {d: i for i, d in enumerate(devices)}
    st_tid = {s: i for i, s in enumerate(streams)}
    out: List[Dict[str, Any]] = []
    for pid, pname in ((DEVICE_PID, "devices"), (STREAM_PID, "streams")):
        out.append({"ph": "M", "pid": pid, "tid": 0,
                    "name": "process_name", "args": {"name": pname}})
    for d, tid in dev_tid.items():
        out.append({"ph": "M", "pid": DEVICE_PID, "tid": tid,
                    "name": "thread_name", "args": {"name": d}})
    for s, tid in st_tid.items():
        out.append({"ph": "M", "pid": STREAM_PID, "tid": tid,
                    "name": "thread_name",
                    "args": {"name": _stream_track(s)}})

    def emit(e: TraceEvent, pid: int, tid: int) -> None:
        args = {"cat_": e.cat, "stream": e.stream, "device": e.device,
                "slot": e.slot, **e.args}
        rec: Dict[str, Any] = {"name": e.name, "cat": e.cat, "pid": pid,
                               "tid": tid, "ts": e.ts * _US, "args": args}
        if e.cat == "gauge":
            # env gauges (DESIGN.md §15) render as Perfetto counter
            # tracks. Counter identity is (pid, name) — gauge names embed
            # the device (`temperature_c/dev0`) so fleets don't collide —
            # and counter args must be numeric-only series.
            rec["ph"] = "C"
            rec["args"] = {k: v for k, v in e.args.items()
                           if isinstance(v, (int, float))}
        elif e.dur is None:
            rec["ph"] = "i"
            rec["s"] = "t"
        else:
            rec["ph"] = "X"
            rec["dur"] = e.dur * _US
        out.append(rec)

    for e in events:
        if e.device is not None:
            emit(e, DEVICE_PID, dev_tid[e.device])
        if e.stream is not None:
            emit(e, STREAM_PID, st_tid[e.stream])
    return {"traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"generator": "edgeol.obs",
                          "devices": devices,
                          "streams": [_stream_track(s) for s in streams]}}


def write_chrome_trace(events: List[TraceEvent], path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_trace(events), f)
        f.write("\n")


def load_chrome_trace(path: str) -> Dict[str, Any]:
    """Load + validate a Chrome trace file. Raises
    `ValueError` naming the file and the first structural problem;
    returns the parsed document."""
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"malformed Chrome trace {path}: {e}") from None
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome trace (missing the "
                         f"'traceEvents' object key)")
    evs = doc["traceEvents"]
    if not isinstance(evs, list) or not evs:
        raise ValueError(f"{path}: 'traceEvents' must be a non-empty list")
    for i, rec in enumerate(evs):
        for key in ("ph", "pid", "tid", "name"):
            if key not in rec:
                raise ValueError(f"{path}: traceEvents[{i}] missing {key!r}")
        if rec["ph"] in ("X", "i", "C") and not isinstance(
                rec.get("ts"), (int, float)):
            raise ValueError(f"{path}: traceEvents[{i}] ({rec['ph']!r}) "
                             f"needs a numeric 'ts'")
        if rec["ph"] == "X":
            dur = rec.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{path}: traceEvents[{i}] span has no "
                                 f"non-negative 'dur' (got {dur!r})")
    if not chrome_tracks(doc)["devices"]:
        raise ValueError(f"{path}: no named device tracks (pid "
                         f"{DEVICE_PID} thread_name metadata)")
    return doc


def chrome_tracks(doc: Dict[str, Any]) -> Dict[str, List[str]]:
    """Track names by group: ``{"devices": [...], "streams": [...]}``
    from the document's thread_name metadata."""
    out: Dict[str, List[str]] = {"devices": [], "streams": []}
    for rec in doc.get("traceEvents", []):
        if rec.get("ph") == "M" and rec.get("name") == "thread_name":
            group = "devices" if rec.get("pid") == DEVICE_PID else "streams"
            out[group].append(rec.get("args", {}).get("name", "?"))
    out["devices"].sort()
    out["streams"].sort()
    return out


def events_from_chrome(doc: Dict[str, Any]) -> List[TraceEvent]:
    """Invert `chrome_trace`: reconstruct `TraceEvent`s from the export.
    Device-track copies are taken verbatim; stream-track records are kept
    only when the event had no device tag (otherwise the device copy
    already carries it) — so the result matches the original event list
    up to ordering."""
    out: List[TraceEvent] = []
    for rec in doc.get("traceEvents", []):
        if rec.get("ph") not in ("X", "i", "C"):
            continue
        args = dict(rec.get("args", {}))
        device = args.pop("device", None)
        stream = args.pop("stream", None)
        slot = args.pop("slot", None)
        cat = args.pop("cat_", rec.get("cat", ""))
        if rec["pid"] == STREAM_PID and device is not None:
            continue  # duplicate of the device-track copy
        dur = rec["dur"] / _US if rec.get("ph") == "X" else None
        out.append(TraceEvent(rec["name"], cat, rec["ts"] / _US, dur,
                              stream, device, slot, args))
    return out
