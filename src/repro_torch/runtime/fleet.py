"""DeviceFleet — the coordinator over DeviceRuntimes (the port of
`repro.runtime.fleet`, DESIGN.md §13), at one device.

The reference drives N simulated edge devices — each a full
`DeviceRuntime` (runtime/device.py) — off ONE shared event timeline and
ONE shared `CostLedger`, and owns three cross-device concerns: routing
streams to devices, the federated merge of devices' params every
`aggregate_every` seconds, and straggler eviction. `ContinualRuntime.run()`
always delegates here; the default session is a fleet of one device, so
every `RunResult` carries `per_device` attribution and a `syncs` counter.

The port runs that default fleet: one device, `StaticAffinity` routing,
no aggregation. What needs more than one device raises
`NotImplementedError` naming ROADMAP A.8 before any work is done: N > 1
devices, `LeastLoaded` routing, `aggregate_every > 0` (the merge), and a
device with an active `EnvSpec`. Straggler eviction needs two devices
and a merge period, so it cannot arise.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.policies import adapt_controller
from repro_torch.data.arrivals import Event
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime.config import DeviceConfig
from repro_torch.runtime.device import DeviceRuntime
from repro_torch.runtime.ledger import (DEFAULT_DEVICE, DEVICE_KEYS,
                                        MODEL_KEYS, STREAM_KEYS, CostLedger)
from repro_torch.runtime.scheduler import EventScheduler
from repro_torch.runtime.train_loop import (as_tensor, make_optimizer_state,
                                            same_shape_runs)

#: Pseudo-stream id cross-device sync charges land on: no arrival stream
#: caused them, the fleet did.
FLEET_STREAM = -1

_A8 = "ROADMAP A.8: the multi-device fleet and the device environment"


# ---------------------------------------------------------------------------
# routing policies


class RoutingPolicy:
    """Maps arrival streams to device indices, once, before the run."""

    name = "routing"

    def assign(self, stream_ids: List[int], events: List[Event],
               specs: List[DeviceConfig]) -> Dict[int, int]:
        raise NotImplementedError


class StaticAffinity(RoutingPolicy):
    """Stream i -> device i mod N: deterministic, oblivious to load.
    Keeps stream 0 on device 0."""

    name = "static"

    def assign(self, stream_ids, events, specs):
        n = len(specs)
        return {st: i % n for i, st in enumerate(sorted(stream_ids))}


class LeastLoaded(RoutingPolicy):
    """LPT over per-stream event counts, weighted by device speed. Only
    more than one device makes it differ from `StaticAffinity`, and the
    port's fleet has one: it raises until ROADMAP A.8."""

    name = "least-loaded"

    def __init__(self):
        raise NotImplementedError(
            f"least-loaded routing is not ported yet ({_A8})")


ROUTING_POLICIES = {"static": StaticAffinity, "least-loaded": LeastLoaded}


def build_routing(name: str) -> RoutingPolicy:
    if name not in ROUTING_POLICIES:
        raise ValueError(f"unknown routing policy {name!r}; known: "
                         f"{sorted(ROUTING_POLICIES)}")
    return ROUTING_POLICIES[name]()


def fleet_devices(n: int, *, seed: int = 0, speed_spread: float = 0.0,
                  energy_spread: float = 0.0,
                  memory_budget_mb: float = 0.0) -> tuple:
    """N `DeviceConfig`s named dev0..dev{N-1}. Device 0 is always the
    reference device (scale 1.0); the rest draw deterministic
    speed/energy scales from `1 +- spread`."""
    if n < 1:
        raise ValueError("a fleet needs at least one device")
    rng = np.random.default_rng([seed, 7, n])
    out = [DeviceConfig(DEFAULT_DEVICE, memory_budget_mb=memory_budget_mb)]
    for i in range(1, n):
        speed = 1.0 + speed_spread * float(rng.uniform(-1.0, 1.0))
        energy = 1.0 + energy_spread * float(rng.uniform(-1.0, 1.0))
        out.append(DeviceConfig(f"dev{i}", speed_scale=max(speed, 0.05),
                                energy_scale=max(energy, 0.05),
                                memory_budget_mb=memory_budget_mb))
    return tuple(out)


# ---------------------------------------------------------------------------
# the coordinator


class DeviceFleet:
    """Drives one session's timeline across its `DeviceRuntime`s.

    Constructed from a `ContinualRuntime` (the config holder); device
    specs / routing / aggregation period default to the host's
    (`RuntimeConfig.devices/routing/aggregate_every`) and can be
    overridden per run. What the port cannot run yet raises here, before
    any slot is built (module docstring)."""

    def __init__(self, host, *, devices: Optional[List[DeviceConfig]] = None,
                 routing: Optional[str] = None,
                 aggregate_every: Optional[float] = None):
        self.host = host
        specs = list(devices) if devices is not None \
            else (list(getattr(host, "devices", ())) or
                  [DeviceConfig(DEFAULT_DEVICE)])
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"device names must be unique (got {names})")
        if len(specs) > 1:
            raise NotImplementedError(
                f"a fleet of {len(specs)} devices is not ported yet ({_A8})")
        if specs[0].env is not None and specs[0].env.active:
            raise NotImplementedError(
                f"an active device environment is not ported yet ({_A8})")
        self.specs = specs
        self.policy = build_routing(
            routing if routing is not None
            else getattr(host, "routing", "static"))
        self.aggregate_every = float(
            aggregate_every if aggregate_every is not None
            else getattr(host, "aggregate_every", 0.0))
        if self.aggregate_every > 0.0:
            raise NotImplementedError(
                f"the federated merge (aggregate_every > 0) is not ported "
                f"yet ({_A8})")
        # populated by run()
        self.scheduler: Optional[EventScheduler] = None
        self.ledger: Optional[CostLedger] = None
        self.devices: List[DeviceRuntime] = []
        self.assignment: Dict[int, int] = {}
        self.tracer = NULL_TRACER

    # ---- lookups (fleet-level policy state, see device.py docstring) -----
    def device_for(self, stream: int) -> DeviceRuntime:
        return self.devices[self.assignment.get(stream, 0)]

    def ctrl_for(self, st: int):
        return self.controllers.get(st, self.primary_ctrl)

    def bench_for(self, st: int):
        b = self.host.stream_benchmarks.get(st)
        return b if b is not None else self.device_for(st).slot_of(st).bench

    # ---- run -------------------------------------------------------------
    def run(self, events: List[Event]):
        from repro_torch.runtime.continual import RunResult

        host = self.host
        rng = np.random.default_rng(host.seed)
        ledger = CostLedger()
        self.ledger = ledger
        slots0 = host._build_slots(ledger, rng, device=self.specs[0])
        primary_slot = next(iter(slots0.values()))
        primary_ctrl = host.controller if host.controller is not None \
            else primary_slot.controller

        # --- pretrain every slot on its scenario 0 (not cost-accounted;
        # paper §V-A) and measure slot memory footprints ------------------
        for st in slots0.values():
            params = st.model.init(torch.Generator().manual_seed(host.seed))
            opt_state = make_optimizer_state(st.model, host.opt_cfg, params)
            plan0 = st.controller.plan
            pre = [b for _ in range(host.pretrain_epochs)
                   for b in st.bench.scenarios[0].train_batches]
            if host.compiled:
                # one fused call per same-shape run of pretrain batches
                for run in same_shape_runs(pre):
                    params, opt_state, _ = st.steps.fused_call(
                        plan0, params, opt_state, run)
            else:
                step0 = st.steps.get(plan0)
                for b in pre:
                    params, opt_state, _ = step0(
                        params, opt_state, as_tensor(b, st.model.device))
            st.reference_params = params  # "initial model before fine-tuning"
            st.executor.load(params, opt_state)
        if host.pool is not None:
            from repro_torch.runtime.modelpool import tree_mb

            for name, st in slots0.items():
                host.pool.set_memory(name, tree_mb(st.executor.params,
                                                   st.executor.opt_state))
            host.pool.warm()

        # --- route streams, compose the per-device runtime ---------------
        stream_ids = sorted({e.stream for e in events}) or [0]
        self.stream_slot: Dict[int, str] = {}
        if host.pool is not None:
            for e in events:
                self.stream_slot.setdefault(e.stream, e.modality)
            for st_id, name in self.stream_slot.items():
                host.pool.slot(name)  # raise early on an unknown modality
        self.assignment = dict(self.policy.assign(stream_ids, events,
                                                  self.specs))
        scheduler = EventScheduler(events)
        self.scheduler = scheduler
        # live handles: controller callbacks / tests may push events onto
        # the running timeline (mid-drain push is supported)
        host.scheduler = scheduler
        host.fleet = self

        self.pending_change = {st: False for st in stream_ids}
        # probes_pushed numbers probe Events; probes_fired counts the ones
        # actually dispatched (a detection during the post-drain flush
        # pushes onto an already-drained scheduler and never runs)
        self.probes_pushed = [0]
        self.probes_fired = [0]
        self.scenario_started: Dict[int, bool] = {}
        self.last_round_end: Dict[int, float] = {}
        self.launch_scenario: Dict[int, int] = {}
        self.val_curve: List[float] = []
        # QoS: a stream's priority rides on its events; a round reserves
        # its device at the stream's priority, so only strictly-higher-
        # priority arrivals can split it
        self.stream_priority: Dict[int, int] = {st: 0 for st in stream_ids}
        for e in events:
            self.stream_priority[e.stream] = max(
                self.stream_priority[e.stream], e.priority)

        self.devices = [DeviceRuntime(self, self.specs[0], 0, slots0,
                                      host.pool, rng)]

        # per-stream controllers: stream 0 is the primary controller;
        # extra streams get their own from the factory, or share the
        # primary one. Under a ModelPool a stream's controller is its
        # slot's (streams sharing a model share the policy that owns its
        # freeze plan).
        controllers: Dict[int, object] = {}
        for st in stream_ids:
            if host.pool is not None:
                controllers[st] = self.device_for(st).slot_of(st).controller
            elif st == 0 or host.controller_factory is None:
                controllers[st] = primary_ctrl
            else:
                controllers[st] = host.controller_factory(st)
        self.controllers = {st: adapt_controller(c)
                            for st, c in controllers.items()}
        self.primary_ctrl = adapt_controller(primary_ctrl)

        # --- drive the shared timeline ------------------------------------
        def on_data(ev: Event, boundary: bool) -> None:
            self._settle_all(ev.time)
            self.device_for(ev.stream).on_data(ev, boundary)

        def on_scenario_change(previous: int, ev: Event) -> None:
            self.device_for(ev.stream).on_scenario_change(previous, ev)

        def on_inference(ev: Event) -> None:
            self._settle_all(ev.time)
            self.device_for(ev.stream).on_inference(ev)

        def on_probe(ev: Event) -> None:
            self._settle_all(ev.time)
            self.device_for(ev.stream).on_probe(ev)

        def on_inference_event(ev: Event) -> None:
            # compiled but unsegmented (detector mode, or `segment` off):
            # serve each event's deferred dispatch before the next event
            on_inference(ev)
            self.device_for(ev.stream).server.drain()

        def on_inference_segment(segment: List[Event]) -> None:
            # a maximal run of consecutive inference events (compiled hot
            # path, DESIGN.md §12): per-event bookkeeping is unchanged,
            # only each device's dispatch is deferred and fused per drain
            for ev in segment:
                on_inference(ev)
            for dev in self.devices:
                dev.server.drain()

        segmented = (host.compiled and host.segment
                     and host.boundaries != "detector")
        scheduler.run(
            on_data=on_data,
            on_inference=on_inference_event if host.compiled
            else on_inference,
            on_scenario_change=on_scenario_change, on_probe=on_probe,
            on_inference_segment=on_inference_segment if segmented
            else None)
        self._settle_all(float("inf"))  # finalize rounds still in flight
        for dev in self.devices:
            dev.server.flush()
            dev.server.drain()
            dev.trailing_flush()

        return self._assemble(RunResult)

    def _settle_all(self, now: float) -> None:
        for dev in self.devices:
            dev.settle(now)

    # ---- result ----------------------------------------------------------
    def _assemble(self, RunResult):
        host = self.host
        ledger, scheduler = self.ledger, self.scheduler
        slots0 = self.devices[0].slots
        stats = self.primary_ctrl.stats() \
            if hasattr(self.primary_ctrl, "stats") else {}
        accs_by_stream: Dict[int, List[float]] = {}
        lats_by_stream: Dict[int, List[float]] = {}
        accs_by_slot: Dict[str, List[float]] = {}
        all_accs: List[float] = []
        for dev in self.devices:
            for st, a in dev.server.accs_by_stream.items():
                accs_by_stream.setdefault(st, []).extend(a)
            for st, ls in dev.server.latencies_by_stream.items():
                lats_by_stream.setdefault(st, []).extend(ls)
            for name, a in dev.server.accs_by_slot.items():
                accs_by_slot.setdefault(name, []).extend(a)
            all_accs.extend(dev.server.accs)
        per_stream: Dict[int, Dict[str, float]] = {}
        for st in sorted(set(self.assignment) | set(ledger.per_stream)
                         | set(accs_by_stream)):
            cell = dict(ledger.per_stream.get(
                st, {k: 0.0 for k in STREAM_KEYS}))
            accs = accs_by_stream.get(st, [])
            cell["avg_inference_acc"] = float(np.mean(accs)) if accs else 0.0
            cell["inferences"] = float(len(accs))
            lats = lats_by_stream.get(st, [])
            cell["latency_p50"] = float(np.percentile(lats, 50)) \
                if lats else 0.0
            cell["latency_p95"] = float(np.percentile(lats, 95)) \
                if lats else 0.0
            per_stream[st] = cell
        per_model: Dict[str, Dict[str, float]] = {}
        for name in sorted(set(slots0) | set(ledger.per_model)
                           | set(accs_by_slot)):
            cell = dict(ledger.per_model.get(
                name, {k: 0.0 for k in MODEL_KEYS}))
            accs = accs_by_slot.get(name, [])
            cell["avg_inference_acc"] = float(np.mean(accs)) if accs else 0.0
            cell["inferences"] = float(len(accs))
            per_model[name] = cell
        makespan = max([scheduler.now]
                       + [scheduler.busy_until_of(d.name)
                          for d in self.devices])
        per_device: Dict[str, Dict[str, float]] = {}
        for dev in self.devices:
            cell = dict(ledger.per_device.get(
                dev.name, {k: 0.0 for k in DEVICE_KEYS}))
            accs = dev.server.accs
            cell["avg_inference_acc"] = float(np.mean(accs)) if accs else 0.0
            cell["inferences"] = float(len(accs))
            cell["streams"] = float(sum(
                1 for di in self.assignment.values() if di == dev.index))
            cell["utilization"] = cell["time_s"] / makespan \
                if makespan > 0 else 0.0
            # no eviction and no environment at one device (A.8)
            cell["evicted"] = 0.0
            cell["battery_dead"] = 0.0
            cell["throttle_s"] = 0.0
            per_device[dev.name] = cell
        return RunResult(
            avg_inference_acc=float(np.mean(all_accs)) if all_accs else 0.0,
            total_time_s=ledger.total_time_s,
            total_energy_j=ledger.total_energy_j,
            compute_tflops=ledger.compute_tflops, rounds=ledger.rounds,
            recompiles=sum(st.steps.recompiles for st in slots0.values())
            if host.pool is not None else host.steps.recompiles,
            inference_accs=all_accs,
            breakdown=ledger.breakdown, controller_stats=stats,
            val_curve=self.val_curve, per_stream=per_stream,
            per_model=per_model, per_device=per_device,
            preemptions=ledger.preemptions,
            swaps=ledger.swaps, syncs=ledger.syncs,
            probes=self.probes_fired[0])
