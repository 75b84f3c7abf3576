"""The port's workloads sweep (`repro_torch.harness.workloads`) and its
trace report against the reference's (`benchmarks/workloads.py`,
`benchmarks/trace_report.py`), live in both packages on the CPU.

- `workload_config`: equal `RuntimeConfig.to_dict()` for every preset x
  method, and for the QoS, trigger, fleet and environment arguments.
- `run_workload` on `two-stream`/`etuner`, preemptible `qos`/`etuner`
  under `priority-weighted`, and the sweep's `fleet` env cell on 3
  devices (its battery, thermal cap and throttle), at the sweep's
  `--quick` scale: equal counts, equal per-stream and per-device rounds,
  time and energy within rel 3% (the FLOPs: `test_torch_obs.py`).
- `validate_bench`: the same error lists on a valid document and on each
  mutation of `tests/test_workloads.py`'s validator test; the same field
  tuples.
- `sweep` on one preset and two methods writes a document both
  validators pass, that `benchmarks/bench_diff.py` reads, and whose
  trace `trace_report` summarizes as the reference's does.

The port's models start from the JAX package's `init(PRNGKey(0))`
(`bridge.params_from_jax`); the reference builds one model an
(architecture, kernels, compiled) triple, so its sessions share their
compiled steps.
"""
import dataclasses
import functools
import io
import json
import subprocess
import sys
import tempfile
import warnings
from contextlib import redirect_stdout
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import benchmarks.workloads as W
from benchmarks import trace_report as jax_trace_report
from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.runtime import config as jax_config
from repro.runtime import fleet_devices as jax_fleet_devices
from repro.workloads import presets as jax_presets
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.harness import trace_report, workloads
from repro_torch.runtime import config, fleet_devices
from repro_torch.workloads import presets

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
QUICK = dict(batches_per_scenario=4, inferences=10, num_scenarios=2,
             fleet_streams=6)
REL = 0.03


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: a test worker shares the machine's cores with
    the others, and torch's OpenMP threads would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.tree.map(np.asarray, jax_build_model(
        jax_get_reduced(arch)).init(jax.random.PRNGKey(0)))


ARCH = {get_reduced(a).name: a for a in ("mobilenetv2", "bert-base")}


def _with_jax_init(model):
    params = params_from_jax(_jax_params(ARCH[model.cfg.name]), model.cfg,
                             device=CPU)
    return dataclasses.replace(model, init=lambda generator: params)


_port_build = config._build_model
_port_plain_build = workloads.build_model
_jax_build = functools.lru_cache(maxsize=None)(jax_config._build_model)
_jax_plain_build = functools.lru_cache(maxsize=None)(W.build_model)


def _port_patches():
    return [mock.patch.object(config, "_build_model",
                              lambda arch, **kw: _with_jax_init(
                                  _port_build(arch, **kw))),
            mock.patch.object(workloads, "build_model",
                              lambda cfg, device=None: _with_jax_init(
                                  _port_plain_build(cfg, device=device)))]


def _jax_patches():
    return [mock.patch.object(jax_config, "_build_model", _jax_build),
            mock.patch.object(W, "build_model", _jax_plain_build)]


class _Patched:
    def __init__(self, patches):
        self.patches = patches

    def __enter__(self):
        self.w = warnings.catch_warnings()
        self.w.__enter__()
        warnings.simplefilter("ignore")
        for p in self.patches:
            p.start()

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()
        self.w.__exit__(*exc)


def _fleet_kw(api_fleet_devices, spec):
    return dict(devices=api_fleet_devices(3, seed=0, speed_spread=0.4,
                                          energy_spread=0.2),
                routing="least-loaded",
                aggregate_every=spec.scenario_span / 4.0,
                energy_budget_j=80.0, thermal_cap_c=26.0,
                throttle="battery")


CELLS = {"two-stream": ("two-stream", "etuner", {}),
         "qos-pw": ("qos", "etuner",
                    dict(preemptible=True,
                         trigger_policy="priority-weighted")),
         "fleet-env": ("fleet", "etuner", "fleet")}


@functools.lru_cache(maxsize=None)
def _cell(side, name):
    preset, method, kw = CELLS[name]
    if side == "port":
        spec = presets(seed=0, **QUICK)[preset]
        kw = _fleet_kw(fleet_devices, spec) if kw == "fleet" else kw
        with _Patched(_port_patches()):
            return workloads.run_workload("mobilenetv2", spec, method,
                                          workload_scale=QUICK, device=CPU,
                                          **kw)
    spec = jax_presets(seed=0, **QUICK)[preset]
    kw = _fleet_kw(jax_fleet_devices, spec) if kw == "fleet" else kw
    with _Patched(_jax_patches()):
        return W.run_workload("mobilenetv2", spec, method,
                              workload_scale=QUICK, **kw)


# ---------------------------------------------------------------------------
# configs


def test_schema_and_field_tuples_match_reference():
    assert workloads.SCHEMA_VERSION == W.SCHEMA_VERSION == 7
    for name in ("CELL_FIELDS", "CELL_STR_FIELDS", "STREAM_FIELDS",
                 "MODEL_FIELDS", "DEVICE_FIELDS", "METHODS",
                 "MODALITY_ARCH"):
        assert getattr(workloads, name) == getattr(W, name), name
    assert workloads.DEFAULT_OUT.endswith(
        "results_torch/BENCH_workloads.json")
    assert Path(workloads.DEFAULT_OUT).resolve() != \
        (ROOT / "BENCH_workloads.json").resolve()


@pytest.mark.parametrize("method", W.METHODS + ("egeria",))
@pytest.mark.parametrize("preset", sorted(jax_presets()))
def test_workload_config_matches_reference(preset, method):
    got = workloads.workload_config("mobilenetv2", preset, method,
                                    workload_scale=QUICK)
    want = W.workload_config("mobilenetv2", preset, method,
                             workload_scale=QUICK)
    assert got.to_dict() == want.to_dict()


OPTIONS = {
    "qos-preemptible": dict(preemptible=True),
    "priority-weighted": dict(trigger_policy="priority-weighted"),
    "eager-kernels": dict(compiled=False, use_pallas=True),
    "budget": dict(memory_budget_mb=2.5, inference_batch=4, batch_size=4),
    "fleet": "fleet",
    "fleet-mains": "fleet-mains",
    "thermal": dict(thermal_cap_c=30.0, throttle="thermal"),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("method", ["etuner", "lazytune", "immed",
                                    "slimfit"])
def test_workload_config_options_match_reference(method, option):
    kw, jkw = OPTIONS[option], OPTIONS[option]
    if option.startswith("fleet"):
        kw = _fleet_kw(fleet_devices, presets(seed=0, **QUICK)["fleet"])
        jkw = _fleet_kw(jax_fleet_devices,
                        jax_presets(seed=0, **QUICK)["fleet"])
        if option == "fleet-mains":
            for k in ("energy_budget_j", "thermal_cap_c", "throttle"):
                kw.pop(k), jkw.pop(k)
    preset = "fleet" if option.startswith("fleet") else "qos"
    try:
        want = W.workload_config("mobilenetv2", preset, method,
                                 workload_scale=QUICK, **jkw).to_dict()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            workloads.workload_config("mobilenetv2", preset, method,
                                      workload_scale=QUICK, **kw)
        assert str(got.value) == str(e)
        return
    got = workloads.workload_config("mobilenetv2", preset, method,
                                    workload_scale=QUICK, **kw).to_dict()
    assert got == want


def test_slot_arch_refuses_an_unmapped_modality():
    with pytest.raises(ValueError, match="no architecture mapped"):
        workloads._slot_arch("mobilenetv2", "audio")
    assert workloads._slot_arch("mobilenetv2", "nlp") == "bert-base"


# ---------------------------------------------------------------------------
# cells


COUNTS = ("workload", "method", "trigger_policy", "throttle",
          "energy_budget_j", "streams", "events", "models", "rounds",
          "recompiles", "preemptible", "preemptions", "swaps", "compiled",
          "devices", "syncs")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_run_workload_matches_reference(name):
    got, want = _cell("port", name), _cell("jax", name)
    assert set(got) == set(want)
    for k in COUNTS:
        assert got[k] == want[k], k
    for k in ("time_s", "energy_j"):
        assert got[k] == pytest.approx(want[k], rel=REL), k
    assert got["acc"] == pytest.approx(want["acc"], abs=1e-6)
    for part in ("per_stream", "per_device", "per_model"):
        assert sorted(got[part]) == sorted(want[part]), part
        for key, w in want[part].items():
            g = got[part][key]
            assert set(g) == set(w), (part, key)
            assert g["rounds"] == w["rounds"], (part, key)
            for f in ("time_s", "energy_j"):
                assert g[f] == pytest.approx(w[f], rel=REL, abs=1e-9), \
                    (part, key, f)
    if name == "qos-pw":
        # the priority-weighted trigger: the priority-2 stream trains
        # less and is served faster than the bulk stream
        prio = {str(i): s.priority for i, s in enumerate(
            presets(seed=0, **QUICK)["qos"].streams)}
        hi = max(prio, key=prio.get)
        lo = min(prio, key=prio.get)
        assert prio[hi] == 2
        per = got["per_stream"]
        assert per[hi]["rounds"] < per[lo]["rounds"]
        assert per[hi]["latency_p95"] < per[lo]["latency_p95"]
    if name == "fleet-env":
        assert W.validate_bench(dict(_doc([got]), workloads={"fleet": {}}),
                                min_workloads=1) == []


def _doc(cells):
    return {"schema_version": 7, "suite": "workloads",
            "arch": "mobilenetv2", "created_unix": 1, "quick": True,
            "workloads": {c["workload"]: {} for c in cells}, "cells": cells}


# ---------------------------------------------------------------------------
# the validator


def _valid_doc(mod):
    cell = {f: 1.0 for f in mod.CELL_FIELDS}
    cell["devices"] = 1
    cell["energy_budget_j"] = 0.0
    cells = [dict(cell, workload=w, method=m, trigger_policy="default",
                  throttle="none",
                  per_stream={"0": {f: 1.0 for f in mod.STREAM_FIELDS}},
                  per_model={"default": {f: 1.0
                                         for f in mod.MODEL_FIELDS}},
                  per_device={"dev0": {f: 1.0 for f in mod.DEVICE_FIELDS}})
             for w in ("a", "b", "c") for m in mod.METHODS]
    return {"schema_version": mod.SCHEMA_VERSION, "suite": "workloads",
            "arch": "mobilenetv2", "created_unix": 1, "quick": True,
            "workloads": {"a": {}, "b": {}, "c": {}}, "cells": cells}


def _cells(doc, **kw):
    return [dict(c, **kw) for c in doc["cells"]]


def _drop(doc, path):
    """`doc` with the field at `path` of its first cell removed."""
    bad = dict(doc, cells=json.loads(json.dumps(doc["cells"])))
    node = bad["cells"][0]
    for k in path[:-1]:
        node = node[k]
    del node[path[-1]]
    return bad


def _env(doc, **dev):
    idle = dict(doc["cells"][0]["per_device"]["dev0"], battery_dead=0.0,
                throttle_s=0.0, energy_j=49.0)
    return dict(doc, cells=_cells(doc, workload="fleet", throttle="battery",
                                  energy_budget_j=50.0,
                                  per_device={"dev0": dict(idle, **dev)}))


MUTATIONS = {
    "valid": (lambda d: d, {}),
    "empty": (lambda d: {}, {}),
    "not-a-dict": (lambda d: [], {}),
    "schema": (lambda d: dict(d, schema_version=99), {}),
    "one-workload": (lambda d: dict(d, cells=d["cells"][:4]), {}),
    "no-acc": (lambda d: _drop(d, ["acc"]), {}),
    "nan-time": (lambda d: dict(d, cells=[dict(d["cells"][0],
                                               time_s=float("nan"))]
                                + d["cells"][1:]), {}),
    "no-preemptible": (lambda d: _drop(d, ["preemptible"]), {}),
    "missing-controller": (lambda d: dict(d, cells=d["cells"][1:]), {}),
    "no-latency": (lambda d: _drop(d, ["per_stream", "0", "latency_p95"]),
                   {}),
    "no-per-model": (lambda d: _drop(d, ["per_model"]), {}),
    "no-swaps": (lambda d: _drop(d, ["per_model", "default", "swaps"]), {}),
    "no-trigger": (lambda d: _drop(d, ["trigger_policy"]), {}),
    "qos-without-pw": (lambda d: dict(d, cells=_cells(d, workload="qos")),
                       dict(min_workloads=1)),
    "no-per-device": (lambda d: _drop(d, ["per_device"]), {}),
    "devices-mismatch": (lambda d: dict(d, cells=_cells(d, devices=2)), {}),
    "no-utilization": (lambda d: _drop(d, ["per_device", "dev0",
                                            "utilization"]), {}),
    "fleet-one-device": (lambda d: dict(d, cells=_cells(d, workload="fleet")),
                         dict(min_workloads=1)),
    "no-throttle": (lambda d: _drop(d, ["throttle"]), {}),
    "fleet-no-env": (lambda d: dict(d, cells=_cells(d, workload="fleet",
                                                    devices=1)),
                     dict(min_workloads=1)),
    "env-idle": (lambda d: _env(d), dict(min_workloads=1)),
    "env-engaged": (lambda d: _env(d, throttle_s=5.0),
                    dict(min_workloads=1)),
    "env-overdrawn": (lambda d: _env(d, throttle_s=5.0, energy_j=51.0),
                      dict(min_workloads=1)),
    "no-cells": (lambda d: dict(d, cells=[]), {}),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_validate_bench_matches_reference(name):
    mutate, kw = MUTATIONS[name]
    got = workloads.validate_bench(mutate(_valid_doc(workloads)), **kw)
    want = W.validate_bench(mutate(_valid_doc(W)), **kw)
    assert got == want
    assert (got == []) == (name == "valid")


# ---------------------------------------------------------------------------
# the sweep's document, bench_diff and the trace report


@functools.lru_cache(maxsize=None)
def _sweep():
    """The port's quick sweep of `two-stream` for immed and etuner, its
    first cell traced: (document, trace path)."""
    trace = str(Path(tempfile.mkdtemp()) / "trace.json")
    with _Patched(_port_patches()):
        return workloads.sweep(quick=True, workload_names=["two-stream"],
                               methods=("immed", "etuner"), device=CPU,
                               trace_out=trace), trace


def test_sweep_document_validates_and_bench_diff_reads_it(tmp_path):
    doc, trace = _sweep()
    assert doc["torch_version"] == torch.__version__
    assert doc["device"] == "cpu" and "jax_version" not in doc
    assert [c["method"] for c in doc["cells"]] == ["immed", "etuner"]
    for validate in (workloads.validate_bench, W.validate_bench):
        assert validate(doc, min_workloads=1,
                        methods=("immed", "etuner")) == []
    path = tmp_path / "port.json"
    path.write_text(json.dumps(doc, indent=1, sort_keys=True))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "bench_diff.py"),
         str(path), str(path)], capture_output=True, text=True,
        timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    from benchmarks import bench_diff
    regressions, _ = bench_diff.diff_cells(
        json.loads((ROOT / "BENCH_workloads.json").read_text()), doc)
    assert regressions  # the reference's cells the port's run left out
    # trace_report reads the traced cell as the reference's does
    for args in ([trace], [trace, "--top", "3"], [trace, "--validate"]):
        outs = []
        for mod in (trace_report, jax_trace_report):
            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = mod.main(args)
            outs.append((rc, buf.getvalue()))
        assert outs[0] == outs[1]
        assert outs[0][0] == 0 and outs[0][1]


def test_sweep_main_writes_results_torch_and_validates(tmp_path, capsys):
    out = tmp_path / "nested" / "bench.json"
    with mock.patch.object(workloads, "sweep", lambda **kw: _sweep()[0]):
        rc = workloads.main(["--quick", "--workloads", "two-stream",
                             "--methods", "immed,etuner", "--device", "cpu",
                             "--out", str(out)])
    assert rc == 0 and json.loads(out.read_text())["cells"]
    assert workloads.main(["--validate", str(out)]) == 1  # 1 workload < 3
    assert "INVALID" in capsys.readouterr().out
