"""Workload benchmark sweep on the port (counterpart of
`benchmarks/workloads.py`): every controller x every workload preset.

Runs the four paper controllers (immed / lazytune / simfreeze / etuner)
against the declarative workload presets (`repro_torch.workloads`) —
multi-stream, staggered drift, MMPP bursts, diurnal + duty-cycle, mixed,
the fleet — and writes the reference's schema'd BENCH document (v7, the
same field tuples), with `torch_version` and `device` where the
reference writes `jax_version`, to ``results_torch/BENCH_workloads.json``
by default (never the repo root's ``BENCH_workloads.json``).

Sessions are built through the declarative `RuntimeConfig` front door
(`workload_config` -> `edgeol_session`, DESIGN.md §11); only the
monolithic SOTA baselines inject live controller objects. Every entry
point runs on the card unless the caller passes the CPU.

    PYTHONPATH=src python -m repro_torch.harness.workloads --quick
    PYTHONPATH=src python -m repro_torch.harness.workloads --quick \\
        --device cpu --workloads two-stream --methods immed,etuner
    PYTHONPATH=src python -m repro_torch.harness.workloads --validate PATH

Every number is produced by the port's runtime (its train steps, their
FLOP counts) + the calibrated EdgeCostModel; nothing is hard-coded.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.baselines.harness import (PAPER_METHODS, make_controller,
                                           method_policies)
from repro_torch.configs import get_reduced
from repro_torch.core.policies import PolicySpec
from repro_torch.harness.common import RESULTS_DIR
from repro_torch.models import build_model
from repro_torch.runtime import (EnvSpec, RuntimeConfig, SlotConfig,
                                 TelemetrySpec, edgeol_session,
                                 fleet_devices,
                                 materialize_stream_benchmarks)
from repro_torch.runtime.modelpool import ModelPool, ModelSlot
from repro_torch.workloads import WorkloadSpec, presets

#: v7: device-environment columns (DESIGN.md §15) — every cell carries
#: `energy_budget_j` (0 = mains power) and a `throttle` mode string, the
#: per-device attribution grows `battery_dead`/`throttle_s`, and the
#: sweep adds a second `fleet` cell running under a finite per-device
#: battery with the BudgetThrottle policy stack facet + a thermal DVFS
#: cap. (v6 added the DeviceFleet columns — `devices`/`syncs` +
#: validated `per_device` attribution; v5 moved cells to the compiled
#: hot path and gated `wall_s`/`recompiles`; v4 added the PolicyStack
#: `trigger_policy` column + priority-weighted qos cells; v3 the
#: ModelPool columns; v2 QoS — `preemptible`/`preemptions` + per-stream
#: latency.)
SCHEMA_VERSION = 7
METHODS = PAPER_METHODS
DEFAULT_OUT = os.path.join(RESULTS_DIR, "BENCH_workloads.json")

#: Per-modality architecture: the model a ModelPool slot runs. "cv" uses
#: the sweep's `--arch`; other modalities are fixed paper models.
MODALITY_ARCH = {"nlp": "bert-base"}

#: Numeric fields every cell must carry (schema contract with CI).
CELL_FIELDS = ("acc", "time_s", "energy_j", "tflops", "rounds",
               "recompiles", "events", "streams", "wall_s",
               "preemptible", "preemptions", "models", "swaps",
               "compiled", "devices", "syncs", "energy_budget_j")

#: String fields every cell must carry (schema contract, v4; v7 adds the
#: `throttle` policy mode — "none" for mains-powered cells).
CELL_STR_FIELDS = ("workload", "method", "trigger_policy", "throttle")

#: Numeric fields every per-stream attribution cell must carry.
STREAM_FIELDS = ("time_s", "energy_j", "flops", "rounds", "preemptions",
                 "avg_inference_acc", "inferences",
                 "latency_p50", "latency_p95")

#: Numeric fields every per-model attribution cell must carry (v3).
MODEL_FIELDS = ("time_s", "energy_j", "flops", "rounds", "swaps",
                "avg_inference_acc", "inferences")

#: Numeric fields every per-device attribution cell must carry (v6; v7
#: adds the env columns — `battery_dead` is a 0/1 flag, `throttle_s` the
#: modeled seconds the device spent DVFS-throttled below full speed).
DEVICE_FIELDS = ("time_s", "energy_j", "flops", "rounds", "swaps",
                 "syncs", "avg_inference_acc", "inferences", "streams",
                 "utilization", "battery_dead", "throttle_s")


def trace_spec(path: Optional[str]) -> Optional[TelemetrySpec]:
    """Map a CLI ``--trace-out`` path to a `TelemetrySpec` (None stays
    None): a ``.jsonl`` suffix selects the JSONL event feed, anything
    else the Perfetto-loadable Chrome export (DESIGN.md §14)."""
    if not path:
        return None
    if path.endswith(".jsonl"):
        return TelemetrySpec(enabled=True, trace_jsonl=path)
    return TelemetrySpec(enabled=True, chrome_trace=path)


# ---------------------------------------------------------------------------
# one sweep cell


def _stream_benchmarks(spec: WorkloadSpec, seed: int,
                       batch_size: int) -> Dict[int, object]:
    """One continual benchmark per stream (kept as a thin alias of the
    runtime-config materializer so tests and the sweep share one
    binding)."""
    return materialize_stream_benchmarks(spec, seed, batch_size)


def build_pool(arch: str, spec: WorkloadSpec, benches: Dict[int, object],
               *, memory_budget_mb: float = 0.0, device=None) -> ModelPool:
    """One model slot per modality the spec names: 'cv' runs the sweep
    arch, other modalities their `MODALITY_ARCH` paper model; each slot
    pretrains/validates on the benchmark of its first bound stream."""
    device = resolve_device(device)
    slots = []
    for m in spec.modalities:
        first = next(i for i, s in enumerate(spec.streams)
                     if s.modality == m)
        slots.append(ModelSlot(m, build_model(get_reduced(_slot_arch(
            arch, m)), device=device), benches[first]))
    return ModelPool(slots, memory_budget_mb=memory_budget_mb)


def _slot_arch(arch: str, modality: str) -> str:
    if modality == "cv":
        return arch
    if modality not in MODALITY_ARCH:
        raise ValueError(
            f"no architecture mapped for modality {modality!r}; extend "
            f"repro_torch.harness.workloads.MODALITY_ARCH (known: "
            f"{['cv'] + sorted(MODALITY_ARCH)})")
    return MODALITY_ARCH[modality]


def workload_config(arch: str, workload, method: str, *, seed: int = 0,
                    batch_size: int = 8, pretrain_epochs: int = 1,
                    inference_batch: int = 8, preemptible: bool = False,
                    memory_budget_mb: float = 0.0,
                    trigger_policy: str = "default",
                    workload_scale: Optional[Dict] = None,
                    compiled: bool = True,
                    use_pallas: bool = False,
                    devices=(), routing: str = "static",
                    aggregate_every: float = 0.0,
                    energy_budget_j: float = 0.0,
                    thermal_cap_c: float = 0.0,
                    throttle: str = "none",
                    telemetry: Optional[TelemetrySpec] = None
                    ) -> RuntimeConfig:
    """The declarative session config of one sweep cell. `workload` is a
    preset name or an already-scaled `WorkloadSpec`; paper methods get
    their policy stacks per slot (baselines keep the default stack and
    inject controllers at session build). Cells run on the compiled hot
    path (DESIGN.md §12) unless `compiled=False`. `devices`/`routing`/
    `aggregate_every` (v6) turn the cell into a DeviceFleet run;
    `telemetry` (PR 9, DESIGN.md §14) attaches a `TelemetrySpec` so the
    cell records a structured trace. `energy_budget_j`/`thermal_cap_c`/
    `throttle` (v7, DESIGN.md §15) attach a device environment: every
    device gets a finite battery and/or thermal DVFS cap, and the paper
    methods' policy stacks grow the named ThrottlePolicy facet
    (baselines stay legacy — no throttle facet means always-allow)."""
    if isinstance(workload, WorkloadSpec):
        spec = workload
    else:
        knobs = {k: v for k, v in (workload_scale or {}).items()
                 if k != "batch_size"}
        spec = presets(seed=seed, **knobs)[workload]
    if energy_budget_j > 0 or thermal_cap_c > 0:
        env = EnvSpec(battery_capacity_j=energy_budget_j,
                      thermal_cap_c=thermal_cap_c)
        devices = tuple(dataclasses.replace(d, env=env) for d in devices)
    policies = method_policies(method, trigger_policy) \
        if method in PAPER_METHODS else None
    if throttle != "none" and policies is not None:
        policies = dataclasses.replace(policies,
                                       throttle=PolicySpec(throttle))
    slots = {}
    for m in spec.modalities:
        slots[m] = SlotConfig(arch=_slot_arch(arch, m),
                              **({"policies": policies} if policies else {}))
    scale = dict(workload_scale or {})
    scale["batch_size"] = batch_size
    return RuntimeConfig(
        slots=slots, workload=spec.name, workload_scale=scale,
        seed=seed, pretrain_epochs=pretrain_epochs,
        inference_batch=inference_batch, preemptible=preemptible,
        memory_budget_mb=memory_budget_mb,
        compiled=compiled, use_pallas=use_pallas,
        devices=tuple(devices), routing=routing,
        aggregate_every=aggregate_every,
        **({"telemetry": telemetry} if telemetry is not None else {}))


def run_workload(arch: str, spec: WorkloadSpec, method: str, *,
                 seed: int = 0, batch_size: int = 8,
                 pretrain_epochs: int = 1,
                 inference_batch: int = 8,
                 preemptible: bool = False,
                 memory_budget_mb: float = 0.0,
                 trigger_policy: str = "default",
                 workload_scale: Optional[Dict] = None,
                 compiled: bool = True,
                 use_pallas: bool = False,
                 devices=(), routing: str = "static",
                 aggregate_every: float = 0.0,
                 energy_budget_j: float = 0.0,
                 thermal_cap_c: float = 0.0,
                 throttle: str = "none",
                 telemetry: Optional[TelemetrySpec] = None,
                 device=None) -> Dict:
    """One (workload, controller) cell: full runtime run, paper metrics +
    per-stream, per-model and per-device attribution (incl. p50/p95
    serving latency). `preemptible` turns on QoS round preemption;
    `trigger_policy` ("default" | "priority-weighted") picks the paper
    methods' trigger (BENCH v4). A spec naming more than one modality
    (the faithful `mixed` preset) runs on a `ModelPool` — one model slot
    per modality sharing the device under `memory_budget_mb` (0 =
    unlimited). `devices`/`routing`/`aggregate_every` (v6) run the cell
    on a DeviceFleet — streams routed across the device list, fine-tuned
    deltas merged federated-style every `aggregate_every` seconds.
    `energy_budget_j`/`thermal_cap_c`/`throttle` (v7) run the cell under
    a per-device environment (DESIGN.md §15). The cell runs on `device`
    (the card unless the caller passes the CPU)."""
    device = resolve_device(device)
    cfg = workload_config(arch, spec, method, seed=seed,
                          batch_size=batch_size,
                          pretrain_epochs=pretrain_epochs,
                          inference_batch=inference_batch,
                          preemptible=preemptible,
                          memory_budget_mb=memory_budget_mb,
                          trigger_policy=trigger_policy,
                          workload_scale=workload_scale,
                          compiled=compiled, use_pallas=use_pallas,
                          devices=devices, routing=routing,
                          aggregate_every=aggregate_every,
                          energy_budget_j=energy_budget_j,
                          thermal_cap_c=thermal_cap_c,
                          throttle=throttle,
                          telemetry=telemetry)
    t0 = time.time()
    if method in PAPER_METHODS:
        # fully declarative: benchmarks, pool, controllers and the event
        # timeline all materialize from the config (the spec object is
        # injected because the sweep pre-scales it)
        rt = edgeol_session(cfg, workload_spec=spec, device=device)
    else:
        # monolithic SOTA baselines: inject live controller objects
        # through the factory seam (exercises the legacy adapter)
        benches = _stream_benchmarks(spec, seed, batch_size)
        if len(spec.modalities) > 1:
            pool = build_pool(arch, spec, benches,
                              memory_budget_mb=memory_budget_mb,
                              device=device)
            rt = edgeol_session(
                cfg, workload_spec=spec, stream_benchmarks=benches,
                model_pool=pool, device=device,
                controller_factory=lambda slot: make_controller(
                    pool.slot(slot).model, method, trigger_policy))
        else:
            model = build_model(get_reduced(arch), device=device)
            rt = edgeol_session(
                cfg, workload_spec=spec, stream_benchmarks=benches,
                model=model, device=device,
                controller=make_controller(model, method, trigger_policy),
                controller_factory=lambda st: make_controller(
                    model, method, trigger_policy))
    res = rt.run()
    events = rt.session_events or []
    return {
        "workload": spec.name, "method": method,
        "trigger_policy": trigger_policy,
        "throttle": throttle,
        "energy_budget_j": float(energy_budget_j),
        "streams": len(spec.streams), "events": len(events),
        "models": len(spec.modalities),
        "acc": res.avg_inference_acc, "time_s": res.total_time_s,
        "energy_j": res.total_energy_j, "tflops": res.compute_tflops,
        "rounds": res.rounds, "recompiles": res.recompiles,
        "preemptible": int(preemptible), "preemptions": res.preemptions,
        "swaps": res.swaps, "compiled": int(compiled),
        "devices": len(res.per_device), "syncs": res.syncs,
        "wall_s": round(time.time() - t0, 2),
        "per_stream": {str(k): v for k, v in res.per_stream.items()},
        "per_model": dict(res.per_model),
        "per_device": dict(res.per_device),
        # multi-model cells record the pool manifest (slot footprints as
        # measured at run start + the budget the cell ran under)
        **({"pool": rt.pool.describe()} if rt.pool is not None else {}),
    }


# ---------------------------------------------------------------------------
# sweep + manifest


def sweep(*, quick: bool = True, arch: str = "mobilenetv2", seed: int = 0,
          workload_names: Optional[Sequence[str]] = None,
          methods: Sequence[str] = METHODS,
          trace_out: Optional[str] = None, device=None,
          use_pallas: bool = False) -> Dict:
    """The sweep: every method on every named preset (the fleet preset's
    two dedicated cells), at CI scale when `quick`; on `device` (the
    card unless the caller passes the CPU), under the kernels when
    `use_pallas`. Returns the BENCH document."""
    device = resolve_device(device)
    scale = (dict(batches_per_scenario=4, inferences=10, num_scenarios=2,
                  fleet_streams=6)
             if quick else
             dict(batches_per_scenario=8, inferences=24, num_scenarios=3,
                  fleet_streams=24))
    # the fleet cell's device count (v6): a few devices at CI scale, a
    # dozen for full local runs (the preset itself scales to hundreds of
    # streams via `fleet_streams`)
    fleet_size = 3 if quick else 12
    specs = presets(seed=seed, **scale)
    names = list(workload_names) if workload_names else list(specs)
    cells: List[Dict] = []
    # --trace-out (PR 9): record a Chrome trace of ONE representative
    # cell — the fleet cell when the sweep includes it (richest track
    # layout: devices x streams), else the first cell run
    tspec = trace_spec(trace_out)
    trace_on = "fleet" if (tspec and "fleet" in names) else \
        (names[0] if tspec and names else None)

    pending_trace = {"spec": tspec}

    def one(spec, method, preemptible, trigger_policy, base, **fleet_kw):
        if spec.name == trace_on and pending_trace["spec"] is not None:
            fleet_kw["telemetry"] = pending_trace.pop("spec")
            pending_trace["spec"] = None
        cell = run_workload(arch, spec, method, seed=seed,
                            preemptible=preemptible,
                            trigger_policy=trigger_policy,
                            workload_scale=scale, device=device,
                            use_pallas=use_pallas, **fleet_kw)
        if base is None:
            base = cell
        cell["time_norm"] = cell["time_s"] / max(base["time_s"], 1e-9)
        cell["energy_norm"] = (cell["energy_j"]
                               / max(base["energy_j"], 1e-9))
        cells.append(cell)
        tag = ("/qos" if preemptible else "") + \
            ("/pw" if trigger_policy == "priority-weighted" else "") + \
            (f"/x{cell['devices']}" if cell["devices"] > 1 else "") + \
            (f"/env:{cell['throttle']}"
             if cell["throttle"] != "none" else "")
        print(f"workloads,{spec.name}/{method}{tag},"
              f"acc={cell['acc']:.4f} "
              f"time={cell['time_s']:.1f}s "
              f"energy={cell['energy_j']:.1f}J "
              f"rounds={cell['rounds']} "
              f"preempt={cell['preemptions']} "
              f"models={cell['models']} swaps={cell['swaps']} "
              f"devices={cell['devices']} syncs={cell['syncs']} "
              f"wall={cell['wall_s']:.0f}s",
              flush=True)
        return base

    for name in names:
        spec = specs[name]
        if name == "fleet":
            # DeviceFleet cell (v6): one method (etuner), many streams
            # routed least-loaded across a heterogeneous fleet, federated
            # merges every quarter scenario span. Too many streams for
            # the full method x workload product — it gets its own cell
            # and validate_bench exempts it from method coverage.
            fleet = fleet_devices(fleet_size, seed=seed,
                                  speed_spread=0.4, energy_spread=0.2)
            # v7 env cell (DESIGN.md §15): the same fleet under a finite
            # per-device battery + a thermal DVFS cap barely above
            # ambient, with the BudgetThrottle facet gating rounds — the
            # budget is sized well below the mains cell's per-device
            # energy so the environment demonstrably engages: devices
            # throttle / drain dead / ride the eviction path
            # (validate_bench and bench-smoke both assert it). Runs
            # first so a `--trace-out` sweep records THIS cell — the
            # richest track layout: devices x streams plus temperature/
            # SoC counter tracks and DVFS throttle spans.
            one(spec, "etuner", False, "default", None,
                devices=fleet, routing="least-loaded",
                aggregate_every=spec.scenario_span / 4.0,
                energy_budget_j=80.0 if quick else 400.0,
                thermal_cap_c=26.0, throttle="battery")
            one(spec, "etuner", False, "default", None,
                devices=fleet, routing="least-loaded",
                aggregate_every=spec.scenario_span / 4.0)
            continue
        # prioritized presets (qos) sweep both QoS modes so the artifact
        # records the preemption latency win next to its baseline
        prioritized = any(s.priority for s in spec.streams)
        modes = (False, True) if prioritized else (False,)
        base = None
        for method in methods:
            for preemptible in modes:
                base = one(spec, method, preemptible, "default", base)
        # v4: prioritized presets add the PriorityWeightedTrigger cell —
        # etuner with the accumulation target scaled by stream priority —
        # in both QoS modes, gated by bench_diff like every other cell
        if prioritized and "etuner" in methods:
            for preemptible in modes:
                base = one(spec, "etuner", preemptible,
                           "priority-weighted", base)
    return {
        "schema_version": SCHEMA_VERSION, "suite": "workloads",
        "arch": arch, "seed": seed, "quick": quick,
        "created_unix": int(time.time()), "torch_version": torch.__version__,
        "device": str(device),
        "workloads": {n: specs[n].describe() for n in names},
        "cells": cells,
    }


# ---------------------------------------------------------------------------
# schema validation (used by CI and tests)


def validate_bench(doc: Dict, *, min_workloads: int = 3,
                   methods: Sequence[str] = METHODS) -> List[str]:
    """Return a list of schema violations (empty = valid)."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    if doc.get("schema_version") != SCHEMA_VERSION:
        errors.append(f"schema_version != {SCHEMA_VERSION}")
    if doc.get("suite") != "workloads":
        errors.append("suite != 'workloads'")
    for key in ("arch", "workloads", "cells", "created_unix"):
        if key not in doc:
            errors.append(f"missing top-level key {key!r}")
    cells = doc.get("cells") or []
    if not isinstance(cells, list) or not cells:
        errors.append("cells must be a non-empty list")
        return errors
    seen: Dict[str, set] = {}
    for i, cell in enumerate(cells):
        for f in CELL_FIELDS:
            v = cell.get(f)
            if not isinstance(v, (int, float)) or v != v or v < 0:
                errors.append(f"cell {i}: field {f!r} missing or not a "
                              f"non-negative finite number (got {v!r})")
        for f in CELL_STR_FIELDS:
            if not isinstance(cell.get(f), str) or not cell.get(f):
                errors.append(f"cell {i}: field {f!r} missing or not a "
                              f"non-empty string (got {cell.get(f)!r})")
        per = cell.get("per_stream")
        if not isinstance(per, dict):
            errors.append(f"cell {i}: missing per_stream attribution")
        else:
            for sid, sc in per.items():
                for f in STREAM_FIELDS:
                    v = sc.get(f) if isinstance(sc, dict) else None
                    if not isinstance(v, (int, float)) or v != v or v < 0:
                        errors.append(
                            f"cell {i} stream {sid}: field {f!r} missing "
                            f"or not a non-negative finite number "
                            f"(got {v!r})")
        pm = cell.get("per_model")
        if not isinstance(pm, dict) or not pm:
            errors.append(f"cell {i}: missing per_model attribution (v3)")
        else:
            for mid, mc in pm.items():
                for f in MODEL_FIELDS:
                    v = mc.get(f) if isinstance(mc, dict) else None
                    if not isinstance(v, (int, float)) or v != v or v < 0:
                        errors.append(
                            f"cell {i} model {mid}: field {f!r} missing "
                            f"or not a non-negative finite number "
                            f"(got {v!r})")
        pd = cell.get("per_device")
        if not isinstance(pd, dict) or not pd:
            errors.append(f"cell {i}: missing per_device attribution (v6)")
        else:
            if len(pd) != cell.get("devices"):
                errors.append(f"cell {i}: devices={cell.get('devices')!r} "
                              f"but per_device has {len(pd)} entries")
            for did, dc in pd.items():
                for f in DEVICE_FIELDS:
                    v = dc.get(f) if isinstance(dc, dict) else None
                    if not isinstance(v, (int, float)) or v != v or v < 0:
                        errors.append(
                            f"cell {i} device {did}: field {f!r} missing "
                            f"or not a non-negative finite number "
                            f"(got {v!r})")
        if "workload" not in cell or "method" not in cell:
            continue
        seen.setdefault(cell["workload"], set()).add(cell["method"])
    if len(seen) < min_workloads:
        errors.append(f"only {len(seen)} workload(s) covered; "
                      f"need >= {min_workloads}")
    for wl, ms in seen.items():
        if wl == "fleet":
            continue  # v6: the fleet preset runs one dedicated cell
        missing = set(methods) - ms
        if missing:
            errors.append(f"workload {wl!r}: missing controllers "
                          f"{sorted(missing)}")
    # v4: a prioritized preset must carry its priority-weighted cell(s)
    pw = [c for c in cells
          if c.get("trigger_policy") == "priority-weighted"]
    if any(wl == "qos" for wl in seen) and not pw:
        errors.append("qos preset present but no priority-weighted "
                      "trigger cell (v4)")
    # v6: a fleet preset cell must really be multi-device
    fleet_cells = [c for c in cells if c.get("workload") == "fleet"]
    if "fleet" in seen and not any(
            c.get("devices", 0) >= 2 for c in fleet_cells):
        errors.append("fleet preset present but no cell with >= 2 "
                      "devices (v6)")
    # v7: the fleet preset must carry an env cell (finite battery +
    # throttle facet) in which the environment demonstrably engaged —
    # at least one device drained dead, spent time DVFS-throttled, or
    # was evicted — and no device's ledger energy may exceed its budget
    env_cells = [c for c in fleet_cells
                 if c.get("throttle", "none") != "none"
                 and c.get("energy_budget_j", 0) > 0]
    if "fleet" in seen and not env_cells:
        errors.append("fleet preset present but no env cell (finite "
                      "energy_budget_j + throttle mode, v7)")
    for c in env_cells:
        pd = c.get("per_device") or {}
        if not any(dc.get("battery_dead", 0) > 0
                   or dc.get("throttle_s", 0) > 0
                   or dc.get("evicted", 0) > 0 for dc in pd.values()):
            errors.append(
                "env cell ran but no device throttled, drained dead or "
                "was evicted — env not engaged (v7)")
        for did, dc in pd.items():
            if dc.get("energy_j", 0) > c["energy_budget_j"] + 1e-6:
                errors.append(
                    f"env cell device {did}: ledger energy "
                    f"{dc.get('energy_j'):.3f} J exceeds the "
                    f"{c['energy_budget_j']:.3f} J battery budget (v7)")
    return errors


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="CI scale: 2 scenarios, 4 batches/scenario")
    ap.add_argument("--arch", default="mobilenetv2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--workloads", default="",
                    help="comma-separated preset names (default: all)")
    ap.add_argument("--methods", default=",".join(METHODS))
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="record a Chrome trace (DESIGN.md §14) of one "
                         "representative cell — the fleet cell when the "
                         "sweep includes it — to PATH; summarize with "
                         "`python -m repro_torch.harness.trace_report "
                         "PATH`")
    ap.add_argument("--validate", metavar="PATH",
                    help="validate an existing BENCH file and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)

    if args.validate:
        with open(args.validate) as f:
            errors = validate_bench(json.load(f))
        for e in errors:
            print(f"SCHEMA ERROR: {e}", file=sys.stderr)
        print(f"{args.validate}: " +
              ("INVALID" if errors else "schema valid"))
        return 1 if errors else 0

    names = [n for n in args.workloads.split(",") if n] or None
    methods = tuple(m for m in args.methods.split(",") if m)
    t0 = time.time()
    doc = sweep(quick=args.quick, arch=args.arch, seed=args.seed,
                workload_names=names, methods=methods,
                trace_out=args.trace_out, device=args.device)
    errors = validate_bench(doc, min_workloads=min(
        3, len(doc["workloads"])), methods=methods)
    if errors:
        for e in errors:
            print(f"SCHEMA ERROR: {e}", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"# wrote {args.out}: {len(doc['cells'])} cells over "
          f"{len(doc['workloads'])} workloads "
          f"(wall {time.time() - t0:.0f}s)")
    if args.trace_out:
        print(f"# wrote {args.trace_out}: Chrome trace — load at "
              f"https://ui.perfetto.dev or summarize with "
              f"`python -m repro_torch.harness.trace_report "
              f"{args.trace_out}`")
    return 0


if __name__ == "__main__":
    sys.exit(main())
