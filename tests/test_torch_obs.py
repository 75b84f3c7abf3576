"""The port's live telemetry (`repro_torch.obs`, DESIGN.md §14) against
the JAX package's `repro.obs` on the CPU, at `tests/test_obs.py`'s scale
(reduced MobileNetV2, one pretraining epoch).

Sinks and metrics on the same inputs: a JSONL file and a Chrome trace
written by either package load in the other, the same `TraceEvent` list
gives equal Chrome documents, the loaders reject the same malformed
files with the same message, and the same operations give equal metrics
snapshots. Within the port: telemetry on and off give bitwise equal
results and params, compiled and eager; the metrics reconcile with the
ledger below 1e-9 in every dimension and the device-time spans sum to
each device's time within 1e-6; a session run twice records the same
events; dispatch instants follow `TelemetrySpec.dispatch_events`.

Session parity with the live reference, for the preemptible
`two-stream` session and the `fleet` preset on three devices: the event
sequences are equal in (cat, name, stream, device, slot) and in every
discrete arg, in order, with `ts` and `dur` within rel 3% (`wall_ms`,
the host's time, is left out); the metric key sets are equal, the
count-valued counters equal and the time, energy, latency and gauge
figures within rel 3%. The `flops` counters are held as shares of the
session's total within rel 3%: the totals themselves part by XLA's
recomputation (ROADMAP C.8), and `test_flop_counters_part_from_xla_as_c5_says`
holds them to the reference's counted less it.

The port's model is injected with an `init` returning the JAX package's
`init(PRNGKey(0))` carried across by `bridge.params_from_jax`; the JAX
side gets one shared model, so its sessions reuse their compiled steps.
"""
import dataclasses
import functools
import io
import json
import logging
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.configs import get_reduced as jax_get_reduced
from repro.data.arrivals import Event as JaxEvent
from repro.models import build_model as jax_build_model
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.runtime import SlotConfig as JaxSlotConfig
from repro.runtime import edgeol_session as jax_edgeol_session
from repro.runtime.fleet import fleet_devices as jax_fleet_devices
from repro.runtime.scheduler import EventScheduler as JaxEventScheduler
from repro_torch import obs, tree_leaves
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.data.arrivals import Event
from repro_torch.models import build_model
from repro_torch.runtime import RuntimeConfig, SlotConfig, edgeol_session
from repro_torch.runtime.fleet import fleet_devices
from repro_torch.runtime.scheduler import EventScheduler

CPU = "cpu"
SCALE = dict(batches_per_scenario=3, inferences=6, num_scenarios=2)
REL = 0.03

#: counters whose values count things, held equal across the packages
COUNTS = ("rounds", "preemptions", "swaps", "syncs", "charges",
          "straggler_flags", "evictions", "sync_skips",
          "throttle_deferrals")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: a test worker shares the machine's cores with
    the others, and torch's OpenMP threads would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_model():
    return jax_build_model(jax_get_reduced("mobilenetv2"))


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.tree.map(np.asarray, _jax_model().init(jax.random.PRNGKey(0)))


def _port_model():
    cfg = get_reduced("mobilenetv2")
    params = params_from_jax(_jax_params(), cfg, device=CPU)
    return dataclasses.replace(build_model(cfg, device=CPU),
                               init=lambda generator: params)


class _Jax:
    obs = jax_obs
    Event = JaxEvent
    EventScheduler = JaxEventScheduler
    RuntimeConfig = JaxRuntimeConfig
    SlotConfig = JaxSlotConfig
    fleet_devices = staticmethod(jax_fleet_devices)

    @staticmethod
    def session(cfg):
        return jax_edgeol_session(cfg, model=_jax_model())


class _Port:
    obs = obs
    Event = Event
    EventScheduler = EventScheduler
    RuntimeConfig = RuntimeConfig
    SlotConfig = SlotConfig
    fleet_devices = staticmethod(fleet_devices)

    @staticmethod
    def session(cfg):
        return edgeol_session(cfg, device=CPU, model=_port_model())


def _config(api, name, *, compiled=True, **telemetry):
    """`tests/test_obs.py`'s sessions: the preemptible `two-stream` one
    and the `fleet` preset on three devices, least-loaded, merging."""
    kw = dict(preemptible=True)
    workload, scale = "two-stream", SCALE
    if name == "fleet":
        workload, scale = "fleet", dict(SCALE, fleet_streams=4)
        kw = dict(devices=api.fleet_devices(3, seed=0, speed_spread=0.4,
                                            energy_spread=0.2),
                  routing="least-loaded", aggregate_every=25.0)
    return api.RuntimeConfig(
        slots={"cv": api.SlotConfig()}, workload=workload,
        workload_scale=dict(scale), seed=0, pretrain_epochs=1,
        compiled=compiled, telemetry=api.obs.TelemetrySpec(**telemetry),
        **kw)


def _run_session(rt):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return rt.run()


@functools.lru_cache(maxsize=None)
def _run(api, name, compiled=True, traced=True):
    rt = api.session(_config(api, name, compiled=compiled, enabled=traced))
    return _run_session(rt), rt


def _trace_events(mod):
    T = mod.TraceEvent
    return [
        T("round/cv", "round", 10.0, 2.5, stream=0, device="dev0",
          slot="cv", args={"iters": 3, "recompiled": True, "wall_ms": 1.5}),
        T("sync/cv", "sync", 20.0, 0.5, stream=-1, device="dev1",
          slot="cv", args={"participants": 2}),
        T("serve/cv", "serve", 12.0, None, device="dev0", slot="cv",
          args={"requests": 4}),
        T("s1", "request", 12.0, 1.25, stream=1, slot="cv"),
        T("temperature_c/dev0", "gauge", 13.0, None, device="dev0",
          args={"value": 31.5, "unit": "C"}),
        T("defer/cv", "throttle", 14.0, None, stream=0, device="dev1",
          slot="cv"),
        T("flag", "straggler", 25.0, None, device="dev1"),
    ]


def _dicts(events):
    return [e.to_dict() for e in events]


# ---------------------------------------------------------------------------
# sinks


def test_jsonl_round_trips_across_packages(tmp_path):
    port, ref = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    obs.write_jsonl(_trace_events(obs), port)
    jax_obs.write_jsonl(_trace_events(jax_obs), ref)
    assert open(port).read() == open(ref).read()
    assert obs.read_jsonl(port) == _trace_events(obs)
    assert _dicts(obs.read_jsonl(ref)) == _dicts(_trace_events(jax_obs))
    assert _dicts(jax_obs.read_jsonl(port)) == _dicts(_trace_events(obs))


def test_jsonl_malformed_line_names_file(tmp_path):
    path = str(tmp_path / "bad.jsonl")
    with open(path, "w") as f:
        f.write('{"name": "ok", "cat": "round", "ts": 1.0}\n{oops\n')
    with pytest.raises(ValueError, match=r"bad\.jsonl line 2"):
        obs.read_jsonl(path)


def test_chrome_doc_equals_reference():
    doc = obs.chrome_trace(_trace_events(obs))
    assert doc == jax_obs.chrome_trace(_trace_events(jax_obs))
    assert json.dumps(doc) == json.dumps(
        jax_obs.chrome_trace(_trace_events(jax_obs)))
    tracks = obs.chrome_tracks(doc)
    assert tracks == {"devices": ["dev0", "dev1"],
                      "streams": ["fleet", "stream 0", "stream 1"]}
    # the gauge renders as a counter record with its numeric args only
    gauge = [r for r in doc["traceEvents"] if r["ph"] == "C"]
    assert gauge and all(r["args"] == {"value": 31.5} for r in gauge)
    key = lambda e: (e.ts, e.name, e.cat)  # noqa: E731
    back = obs.events_from_chrome(doc)
    # a gauge's "C" record keeps its numeric args only, so it comes back
    # without its tags and its unit (the reference's format); the rest
    # verbatim
    want = [dataclasses.replace(e, device=None, args={"value": 31.5})
            if e.cat == "gauge" else e for e in _trace_events(obs)]
    assert _dicts(back) == _dicts(jax_obs.events_from_chrome(doc))
    assert sorted(back, key=key) == sorted(want, key=key)


@pytest.mark.parametrize("writer,loader", [(obs, jax_obs), (jax_obs, obs),
                                           (obs, obs)],
                         ids=["port-to-ref", "ref-to-port", "port"])
def test_chrome_files_load_across_packages(tmp_path, writer, loader):
    path = str(tmp_path / "trace.json")
    writer.write_chrome_trace(_trace_events(writer), path)
    doc = loader.load_chrome_trace(path)
    assert loader.chrome_tracks(doc) == writer.chrome_tracks(
        writer.chrome_trace(_trace_events(writer)))
    assert _dicts(loader.events_from_chrome(doc)) == _dicts(
        writer.events_from_chrome(writer.chrome_trace(
            _trace_events(writer))))


def _valid_doc():
    return jax_obs.chrome_trace(_trace_events(jax_obs))


def _drop(key, ph="X"):
    doc = _valid_doc()
    rec = next(r for r in doc["traceEvents"] if r["ph"] == ph)
    del rec[key]
    return doc


def _with(ph, **kw):
    doc = _valid_doc()
    next(r for r in doc["traceEvents"] if r["ph"] == ph).update(kw)
    return doc


def _no_device_tracks():
    doc = _valid_doc()
    doc["traceEvents"] = [r for r in doc["traceEvents"]
                          if not (r["ph"] == "M" and r["pid"] == 1
                                  and r["name"] == "thread_name")]
    return doc


#: malformed Chrome trace files, as text
MALFORMED = {
    "not-json": "{not json",
    "not-a-dict": json.dumps([1, 2]),
    "no-trace-events": json.dumps({"events": []}),
    "empty": json.dumps({"traceEvents": []}),
    "not-a-list": json.dumps({"traceEvents": {"ph": "X"}}),
    "no-ph": json.dumps(_drop("ph")),
    "no-pid": json.dumps(_drop("pid")),
    "no-tid": json.dumps(_drop("tid", ph="i")),
    "no-name": json.dumps(_drop("name", ph="M")),
    "span-without-ts": json.dumps(_drop("ts")),
    "counter-with-text-ts": json.dumps(_with("C", ts="13")),
    "span-without-dur": json.dumps(_drop("dur")),
    "negative-dur": json.dumps(_with("X", dur=-1.0)),
    "no-device-tracks": json.dumps(_no_device_tracks()),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_load_chrome_trace_rejects_malformed(tmp_path, case):
    path = tmp_path / f"{case}.json"
    path.write_text(MALFORMED[case])
    with pytest.raises(ValueError) as port:
        obs.load_chrome_trace(str(path))
    with pytest.raises(ValueError) as ref:
        jax_obs.load_chrome_trace(str(path))
    assert str(port.value) == str(ref.value)
    assert str(path) in str(port.value)


def test_device_time_matches_reference():
    got = obs.device_time(_trace_events(obs))
    assert got == jax_obs.device_time(_trace_events(jax_obs))
    assert got == {"dev0": 2.5, "dev1": 0.5}
    assert obs.DEVICE_TIME_CATS == jax_obs.DEVICE_TIME_CATS


def test_null_tracer_is_falsy_and_inert():
    t = obs.NULL_TRACER
    assert not t and len(t) == 0 and not t.enabled
    assert t.span("round", "r", 0.0, 1.0) is None
    assert t.instant("serve", "s", 0.0) is None
    t.reset()
    assert t.events == [] and len(t) == 0
    live = obs.Tracer()
    assert live and live.enabled and len(live) == 0
    live.span("round", "r", 1, 2, stream=0, iters=3)
    live.instant("serve", "s", 3.0)
    assert len(live) == 2 and live.events[0].ts == 1.0 \
        and isinstance(live.events[0].dur, float)
    live.reset()
    assert len(live) == 0


# ---------------------------------------------------------------------------
# metrics


def _ops_counters(m):
    m.counter("time_s", stream=0, device="dev0").inc(2.0)
    m.counter("time_s", stream=1, device="dev0").inc(3.0)
    m.counter("time_s", stream=1, device="dev1").inc(5.0)
    m.counter("rounds").inc()
    m.counter("rounds").inc()


def _ops_gauges(m):
    m.gauge("utilization", device="dev0").set(0.5)
    m.gauge("utilization", device="dev0").set(0.25)
    m.gauge("makespan_s").set(7)
    m.gauge("soc", device="dev1").set(np.float64(0.125))


def _ops_histograms(m):
    for v in (0.1, 0.4, 0.2, 0.9, 0.0, 3.5):
        m.histogram("latency_s", stream=0).observe(v)
    m.histogram("latency_s", stream=1).observe(2)
    m.histogram("latency_s", stream=-1)  # created, never observed


def _ops_labels(m):
    # label values render through str(): ints, negative streams and
    # labels given in any order land on one key
    m.counter("flops", stream=-1, model="cv").inc(1e12)
    m.counter("flops", model="cv", stream=-1).inc(0.5e12)
    m.counter("flops", kind="sync").inc()
    m.counter("charges", kind="round").inc()
    m.gauge("recompiles").set(3.0)


METRIC_OPS = {"counters": _ops_counters, "gauges": _ops_gauges,
              "histograms": _ops_histograms, "labels": _ops_labels}


@pytest.mark.parametrize("case", sorted(METRIC_OPS))
def test_metrics_snapshot_matches_reference(case):
    port, ref = obs.MetricsRegistry(), jax_obs.MetricsRegistry()
    METRIC_OPS[case](port)
    METRIC_OPS[case](ref)
    snap = port.snapshot()
    assert snap == ref.snapshot()
    assert json.dumps(snap) == json.dumps(ref.snapshot())
    for name in ("time_s", "flops", "rounds", "charges"):
        assert port.sum_counters(name) == ref.sum_counters(name)
        for label in ("stream", "device", "model", "kind"):
            assert port.label_values(name, label) == \
                ref.label_values(name, label)
    assert port.sum_counters("time_s", device="dev0") == \
        ref.sum_counters("time_s", device="dev0")
    assert port.counter_value("flops", model="cv", stream=-1) == \
        ref.counter_value("flops", model="cv", stream=-1)
    assert port.counter_value("missing") == 0.0


def test_ledger_hooks_and_reconcile_match_reference():
    """The five observer hooks on the same charges give the reference's
    snapshot, and `reconcile` walks the same nine entries."""
    tels = (obs.Telemetry(), jax_obs.Telemetry())
    charges = [dict(time_s=1.5, energy_j=3.0, flops=2e9, stream=0,
                    model="cv", device="dev0"),
               dict(time_s=0.25, energy_j=0.5, flops=0.0, stream=-1,
                    model="cv", device="dev1", kind="sync"),
               dict(time_s=0.0, energy_j=0.0, flops=0.0, stream=1,
                    model="nlp", device="dev0", kind="cka")]
    for tel in tels:
        for c in charges:
            tel.on_charge(**c)
        tel.on_round(stream=0, model="cv", device="dev0")
        tel.on_preemption(stream=1)
        tel.on_swap(model="nlp", device="dev0")
        tel.on_sync(device="dev1")
        tel.tracer.instant("dispatch", "data", 0.0, stream=0)
    ledger = {"per_stream": {0: {"time_s": 1.5, "energy_j": 3.0,
                                 "flops": 2e9},
                             -1: {"time_s": 0.25, "energy_j": 0.5}},
              "per_model": {"cv": {"time_s": 1.75, "energy_j": 3.5,
                                   "flops": 2e9}},
              "per_device": {"dev0": {"time_s": 1.5, "energy_j": 3.0,
                                      "flops": 2e9},
                             "dev1": {"time_s": 0.5, "energy_j": 0.5}}}
    fake = type("Ledger", (), dict(ledger, total_time_s=1.75,
                                   total_energy_j=3.5, rounds=1,
                                   compute_tflops=2e-3))
    port, ref = (t.snapshot(fake) for t in tels)
    assert port == ref
    assert port["ledger"]["total_flops"] == 2e9  # from compute_tflops
    assert port["reconciliation"]["per_device.time_s"] == 0.25
    assert port["trace_events"] == 1
    tels[0].reset()
    assert len(tels[0].tracer) == 0 and tels[0].metrics.snapshot() == {
        "counters": {}, "gauges": {}, "histograms": {}}


# ---------------------------------------------------------------------------
# TelemetrySpec and logging


SPECS = [dict(), dict(enabled=True), dict(trace_jsonl="t.jsonl"),
         dict(enabled=True, chrome_trace="t.json", dispatch_events=False)]


@pytest.mark.parametrize("kw", SPECS, ids=["default", "enabled", "jsonl",
                                           "chrome-no-dispatch"])
def test_telemetry_spec_round_trips_in_config_across_packages(kw):
    for src, dst in ((_Port, _Jax), (_Jax, _Port)):
        cfg = src.RuntimeConfig(slots={"cv": src.SlotConfig()},
                                workload="two-stream",
                                telemetry=src.obs.TelemetrySpec(**kw))
        d = json.loads(json.dumps(cfg.to_dict()))
        back = dst.RuntimeConfig.from_dict(d)
        assert back.telemetry.to_dict() == cfg.telemetry.to_dict()
        assert back.telemetry.active == cfg.telemetry.active
        assert back.to_dict() == d
        assert ("telemetry" in d) == bool(kw)


def test_telemetry_spec_errors_match_reference():
    for bad in ({"enabled": True, "chrom_trace": "x"},
                {"trace_jsonl": ""}, {"enabled": 1}, "on"):
        with pytest.raises(ValueError) as port:
            obs.TelemetrySpec.from_dict(bad)
        with pytest.raises(ValueError) as ref:
            jax_obs.TelemetrySpec.from_dict(bad)
        assert str(port.value) == str(ref.value)


def test_configure_logging_matches_reference(monkeypatch):
    root = logging.getLogger(obs.log.ROOT)
    saved = (list(root.handlers), root.propagate, root.level)
    try:
        monkeypatch.setenv("EDGEOL_LOG", "debug")
        assert obs.configure_logging(force=True).level == logging.DEBUG
        assert len(root.handlers) == 1
        obs.configure_logging("error")  # idempotent: no second handler
        assert len(root.handlers) == 1 and root.level == logging.ERROR
        for mod in (obs, jax_obs):
            with pytest.raises(ValueError, match="unknown log level"):
                mod.configure_logging("chatty")
        assert obs.get_logger("fleet").name == "edgeol.fleet"
        assert obs.get_logger("edgeol.x").name == \
            jax_obs.get_logger("edgeol.x").name
    finally:
        root.handlers[:] = saved[0]
        root.propagate, root.level = saved[1], saved[2]


def test_probe_drop_is_logged_through_configure_logging():
    root = logging.getLogger(obs.log.ROOT)
    saved = (list(root.handlers), root.propagate, root.level)
    out = io.StringIO()
    try:
        obs.configure_logging("WARNING", stream=out, force=True)
        sched = EventScheduler([Event(1.0, "probe", 0, 0, stream=2)])
        sched.run(on_data=lambda e, b: None, on_inference=lambda e: None)
    finally:
        root.handlers[:] = saved[0]
        root.propagate, root.level = saved[1], saved[2]
    assert sched.dropped_probes == 1
    line = out.getvalue()
    assert "probe event dropped" in line and "stream 2" in line
    assert " W edgeol.scheduler: " in line


# ---------------------------------------------------------------------------
# dispatch instants


@pytest.mark.parametrize("trace_dispatch", [True, False])
def test_dispatch_instants_match_reference(trace_dispatch):
    got = []
    for api in (_Port, _Jax):
        E = api.Event
        sched = api.EventScheduler([E(0.0, "data", 0, 0, stream=0),
                                    E(1.0, "inference", 0, 0, stream=0),
                                    E(2.0, "inference", 0, 1, stream=1)])
        sched.tracer = api.obs.Tracer()
        sched.trace_dispatch = trace_dispatch
        sched.run(on_data=lambda e, b: None, on_inference=lambda e: None,
                  on_inference_segment=lambda seg: None)
        got.append(_dicts(sched.tracer.events))
    assert got[0] == got[1]
    # segment mode pops inner inference events in one go; each still
    # gets its own dispatch instant
    assert [d["ts"] for d in got[0]] == ([0.0, 1.0, 2.0] if trace_dispatch
                                         else [])


def test_dispatch_events_off_silences_only_dispatches():
    on = _run(_Port, "two-stream")[1].telemetry.tracer.events
    rt = _Port.session(_config(_Port, "two-stream", enabled=True,
                               dispatch_events=False))
    _run_session(rt)
    off = rt.telemetry.tracer.events
    assert sum(e.cat == "dispatch" for e in on) == 24
    assert not any(e.cat == "dispatch" for e in off)
    assert _no_wall(off) == _no_wall([e for e in on
                                      if e.cat != "dispatch"])


# ---------------------------------------------------------------------------
# sessions in the port


def _no_wall(events):
    return [dict(e.to_dict(), args={k: v for k, v in e.args.items()
                                    if k != "wall_ms"}) for e in events]


def _assert_identical(a, b):
    """`tests/test_torch_fleet.py::_assert_identical`."""
    assert a.rounds == b.rounds
    assert a.swaps == b.swaps
    assert a.syncs == b.syncs
    assert a.preemptions == b.preemptions
    assert a.probes == b.probes
    np.testing.assert_array_equal(a.inference_accs, b.inference_accs)
    np.testing.assert_array_equal(a.val_curve, b.val_curve)
    assert a.total_time_s == b.total_time_s
    assert a.total_energy_j == b.total_energy_j
    assert a.compute_tflops == b.compute_tflops
    assert a.breakdown == b.breakdown
    assert a.controller_stats == b.controller_stats
    assert a.per_stream == b.per_stream
    assert a.per_model == b.per_model
    assert a.per_device == b.per_device


@pytest.mark.parametrize("name,compiled", [("two-stream", True),
                                           ("two-stream", False),
                                           ("fleet", True)],
                         ids=["two-stream-compiled", "two-stream-eager",
                              "fleet-compiled"])
def test_telemetry_on_is_bitwise_off(name, compiled):
    (on, ort), (off, frt) = _run(_Port, name, compiled), \
        _run(_Port, name, compiled, traced=False)
    assert frt.telemetry is None and ort.telemetry is not None
    assert len(ort.telemetry.tracer) > 0
    assert frt.fleet.ledger.telemetry is None
    _assert_identical(on, off)
    for a, b in zip(ort.fleet.devices, frt.fleet.devices, strict=True):
        for x, y in zip(tree_leaves(a.primary.executor.params),
                        tree_leaves(b.primary.executor.params),
                        strict=True):
            assert torch.equal(x, y)


def _span_counts(events):
    out = {}
    for e in events:
        if e.dur is not None:
            out[e.cat] = out.get(e.cat, 0) + 1
    return out


def test_compiled_span_counts_equal_eager():
    compiled = _run(_Port, "two-stream")[1].telemetry.tracer.events
    eager = _run(_Port, "two-stream", False)[1].telemetry.tracer.events
    assert _span_counts(compiled) == _span_counts(eager)
    assert [e.to_dict() for e in compiled if e.dur is not None] == \
        [e.to_dict() for e in eager if e.dur is not None]


@pytest.mark.parametrize("name", ["two-stream", "fleet"])
def test_reconciliation_all_dimensions(name):
    res, rt = _run(_Port, name)
    tel = rt.telemetry
    rec = tel.reconcile(res)
    assert set(rec) == {f"{d}.{f}" for d in
                        ("per_stream", "per_model", "per_device")
                        for f in ("time_s", "energy_j", "flops")}
    assert max(rec.values()) < 1e-9
    # per-device span-duration sums reproduce the ledger's device time
    spans = obs.device_time(tel.tracer.events)
    assert set(spans) == set(res.per_device)
    for dev, cell in res.per_device.items():
        np.testing.assert_allclose(spans[dev], cell["time_s"], rtol=0,
                                   atol=1e-6)
    snap = tel.snapshot(res)
    assert snap["trace_events"] == len(tel.tracer.events)
    assert max(snap["reconciliation"].values()) < 1e-9
    assert snap["ledger"]["rounds"] == res.rounds
    json.dumps(snap)  # every figure is a plain Python number
    json.dumps(_dicts(tel.tracer.events))


def test_session_run_twice_writes_the_same_trace(tmp_path):
    jsonl, chrome = str(tmp_path / "t.jsonl"), str(tmp_path / "t.json")
    rt = _Port.session(_config(_Port, "fleet", trace_jsonl=jsonl,
                               chrome_trace=chrome))
    runs = []
    for _ in range(2):
        _run_session(rt)
        runs.append(rt.telemetry.tracer.events)
        # the sinks hold this run's events, written at its end
        assert obs.read_jsonl(jsonl) == rt.telemetry.tracer.events
        doc = obs.load_chrome_trace(chrome)
        assert obs.chrome_tracks(doc)["devices"] == ["dev0", "dev1", "dev2"]
    assert runs[0] is not runs[1]
    assert _no_wall(runs[0]) == _no_wall(runs[1])
    # every executor and server of the second run held the new tracer
    assert rt.fleet.tracer is rt.telemetry.tracer
    for dev in rt.fleet.devices:
        assert dev.server.tracer is rt.telemetry.tracer
        assert all(st.executor.tracer is rt.telemetry.tracer
                   for st in dev.slots.values())


# ---------------------------------------------------------------------------
# session parity with the live reference


def _close(a, b):
    return abs(a - b) <= REL * abs(b) + 1e-12


@functools.lru_cache(maxsize=None)
def _pair(name):
    return _run(_Port, name), _run(_Jax, name)


@pytest.mark.parametrize("name", ["two-stream", "fleet"])
def test_trace_events_match_reference(name):
    (res, rt), (ref, jrt) = _pair(name)
    got, want = rt.telemetry.tracer.events, jrt.telemetry.tracer.events
    key = lambda e: (e.cat, e.name, e.stream, e.device, e.slot)  # noqa
    assert [key(e) for e in got] == [key(e) for e in want]
    for g, w in zip(got, want):
        assert set(g.args) == set(w.args), (g, w)
        for k, v in w.args.items():
            if k == "wall_ms":
                continue
            assert type(g.args[k]) is type(v), (g, k)
            if isinstance(v, float):
                assert _close(g.args[k], v), (g, w, k)
            else:
                assert g.args[k] == v, (g, w, k)
        assert _close(g.ts, w.ts), (g, w)
        assert (g.dur is None) == (w.dur is None), (g, w)
        if w.dur is not None:
            assert _close(g.dur, w.dur), (g, w)
    cats = {e.cat for e in got}
    assert {"dispatch", "request", "publish", "serve"} <= cats
    assert ("segment" if name == "two-stream" else "sync") in cats
    # the Chrome documents lay out the same tracks
    assert obs.chrome_tracks(obs.chrome_trace(got)) == \
        jax_obs.chrome_tracks(jax_obs.chrome_trace(want))
    assert res.rounds == ref.rounds


@pytest.mark.parametrize("name", ["two-stream", "fleet"])
def test_metrics_match_reference(name):
    (res, rt), (ref, jrt) = _pair(name)
    got, want = rt.telemetry.snapshot(res), jrt.telemetry.snapshot(ref)
    for group in ("counters", "gauges", "histograms"):
        assert sorted(got[group]) == sorted(want[group]), group
    assert got["trace_events"] == want["trace_events"]
    total = (sum(v for k, v in got["counters"].items()
                 if k.startswith("flops{device=")),
             sum(v for k, v in want["counters"].items()
                 if k.startswith("flops{device=")))
    for k, v in want["counters"].items():
        g = got["counters"][k]
        if k.split("{")[0] in COUNTS:
            assert g == v, k
        elif k.startswith("flops"):
            # shares of the session's FLOPs (the totals: C.5)
            assert _close(g / total[0], v / total[1]), k
        else:
            assert _close(g, v), k
    for k, v in want["gauges"].items():
        assert (got["gauges"][k] == v) if k == "recompiles" \
            else _close(got["gauges"][k], v), k
    for k, v in want["histograms"].items():
        g = got["histograms"][k]
        assert g["count"] == v["count"] and set(g) == set(v), k
        for f in set(v) - {"count"}:
            assert _close(g[f], v[f]), (k, f)
    assert max(got["reconciliation"].values()) < 1e-9
    assert got["ledger"]["rounds"] == want["ledger"]["rounds"]
    for f in ("total_time_s", "total_energy_j"):
        assert _close(got["ledger"][f], want["ledger"][f]), f
    if name == "fleet":
        assert got["counters"]["syncs{device=dev0}"] > 0


@functools.lru_cache(maxsize=None)
def _reference_less_recomputation(name):
    """The reference's session `name`, its steps counted by XLA less
    what XLA recomputes (`test_torch_train.xla_less_recomputation`)."""
    from test_torch_train import xla_less_recomputation

    with xla_less_recomputation():
        rt = _Jax.session(_config(_Jax, name, enabled=True))
        return _run_session(rt), rt


@pytest.mark.parametrize("name", ["two-stream", "fleet"])
def test_flop_counters_part_from_xla_as_c5_says(name):
    """The port counts a whole step as XLA's cost analysis counts the
    reference's (`runtime/flops.py`), less the work XLA's fusion pass
    recomputes, which the port's programs do not (ROADMAP C.8). Held
    against the reference's session with its steps counted so, the
    session's FLOPs agree within rel 3%, in every counter and in
    `compute_tflops`; against XLA's whole count they are 0.83-0.85x on
    the reduced MobileNetV2 (0.741x when the port counted matmuls and
    convolutions only), and the modeled times, calibrated from each
    side's own count, agree."""
    (res, rt), (ref, jrt) = _pair(name)
    less, lrt = _reference_less_recomputation(name)
    got = rt.telemetry.metrics.sum_counters("flops", device="dev0")
    want = lrt.telemetry.metrics.sum_counters("flops", device="dev0")
    assert got == pytest.approx(want, rel=REL)
    for k, v in lrt.telemetry.snapshot(less)["counters"].items():
        if k.startswith("flops"):
            assert _close(rt.telemetry.snapshot(res)["counters"][k], v), k
    assert res.compute_tflops == pytest.approx(less.compute_tflops, rel=REL)
    whole = jrt.telemetry.metrics.sum_counters("flops", device="dev0")
    print(f"{name}: the port's FLOPs {got / whole:.4f}x XLA's whole count, "
          f"compute_tflops {res.compute_tflops / ref.compute_tflops:.4f}x")
    assert 0.8 < got / whole < 0.9
    assert less.rounds == ref.rounds == res.rounds
    assert res.total_time_s == pytest.approx(ref.total_time_s, rel=1e-9)