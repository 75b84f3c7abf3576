"""DeviceFleet — the multi-device coordinator over DeviceRuntimes (the
port of `repro.runtime.fleet`, DESIGN.md §13).

N simulated edge devices — each a full `DeviceRuntime`
(runtime/device.py) with its own executors, serving lane, pool and
occupancy lane — driven off ONE shared event timeline and ONE shared
`CostLedger`. The fleet owns three cross-device concerns:

- **routing**: a `RoutingPolicy` assigns each arrival stream to a device
  up front (`static` index affinity, or `least-loaded` LPT over event
  counts weighted by device speed), and re-routes the streams of slow or
  evicted devices mid-run;
- **aggregation**: every `aggregate_every` timeline seconds, devices'
  fine-tuned params are merged federated-style — a per-slot weighted
  average, weight = rounds trained since the last merge, summed in fp32
  in device order (``0 + w0·l0 + w1·l1 …``, then ``/ total``), as the
  reference sums. Each participant is charged a cross-device sync
  (`CostLedger.charge_sync`) on the fleet pseudo-stream `FLEET_STREAM`.
  A merged tree replaces `executor.params` between rounds; the compiled
  path copies params into every graph call, so the next replay trains
  the merged values;
- **stragglers**: `distributed.StragglerTracker` is fed each device's
  mean round time per sync interval; flagged devices' streams re-route
  to the fastest active device and their deltas drop out of the merge;
  `evict_after` consecutive flags evicts the device for good. A device
  whose battery dies (an active `EnvSpec`, DESIGN.md §15) rides the same
  eviction path.

`ContinualRuntime.run()` always delegates here; the default session is a
fleet of one device. An injected elastic mesh (`mesh`, a DeviceMesh;
`mesh_axis`; `param_specs`, `distributed.sharding` specs of a slot's
params) shrinks on eviction, where `mesh_axis` is even and 2 or more,
to its first half along that axis (`distributed.elastic.shrink_mesh`),
and each surviving device's params are re-sharded onto it
(`elastic.remesh`, values kept) into `mesh_params[(device index, slot)]`.
The simulated devices train on their params' whole values, as before
the eviction: the DTensors there are what a sharded save or a
multi-rank caller reads. With a live
`Telemetry` on the host, the fleet records the reference's sync spans,
straggler instants, counters and gauges, and writes the sinks at run end.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree_map
from repro_torch.core.policies import adapt_controller
from repro_torch.data.arrivals import Event
from repro_torch.distributed.straggler import StragglerConfig, StragglerTracker
from repro_torch.env import DeviceEnv, EnvLedgerObserver
from repro_torch.obs.log import get_logger
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime.config import DeviceConfig
from repro_torch.runtime.device import (DeviceRuntime, clone_device_slots,
                                        clone_pool)
from repro_torch.runtime.ledger import (DEFAULT_DEVICE, DEVICE_KEYS,
                                        MODEL_KEYS, STREAM_KEYS, CostLedger)
from repro_torch.runtime.scheduler import EventScheduler
from repro_torch.runtime.train_loop import (as_tensor, make_optimizer_state,
                                            same_shape_runs)

#: Pseudo-stream id cross-device sync charges land on: no arrival stream
#: caused them, the fleet did.
FLEET_STREAM = -1

log = get_logger("fleet")


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
    """LPT over per-stream event counts: streams are placed heaviest
    first, each onto the device with the least assigned load, where load
    is assigned events divided by the device's speed scale (a 2x device
    absorbs twice the events). Deterministic: ties break on stream id
    (sort) and device index (argmin)."""

    name = "least-loaded"

    def assign(self, stream_ids, events, specs):
        weight: Dict[int, int] = {st: 0 for st in stream_ids}
        for e in events:
            weight[e.stream] = weight.get(e.stream, 0) + 1
        load = [0.0] * len(specs)
        out: Dict[int, int] = {}
        for st in sorted(stream_ids, key=lambda s: (-weight.get(s, 0), s)):
            d = min(range(len(specs)), key=lambda i: (load[i], i))
            out[st] = d
            load[d] += weight.get(st, 0) / specs[d].speed_scale
        return out


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
    """Drives one session's timeline across N `DeviceRuntime`s.

    Constructed from a `ContinualRuntime` (the config holder); device
    specs / routing / aggregation period default to the host's
    (`RuntimeConfig.devices/routing/aggregate_every`) and can be
    overridden per run. `straggler` takes a `StragglerConfig` (else the
    host's `straggler_config`, else the tracker's defaults). `mesh`,
    `mesh_axis` and `param_specs` wire the elastic mesh (module
    docstring)."""

    def __init__(self, host, *, devices: Optional[List[DeviceConfig]] = None,
                 routing: Optional[str] = None,
                 aggregate_every: Optional[float] = None,
                 straggler: Optional[StragglerConfig] = None,
                 mesh=None, mesh_axis: str = "data", param_specs=None):
        self.host = host
        specs = list(devices) if devices is not None \
            else (list(getattr(host, "devices", ())) or
                  [DeviceConfig(DEFAULT_DEVICE)])
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"device names must be unique (got {names})")
        self.specs = specs
        self.policy = build_routing(
            routing if routing is not None
            else getattr(host, "routing", "static"))
        self.aggregate_every = float(
            aggregate_every if aggregate_every is not None
            else getattr(host, "aggregate_every", 0.0))
        self._straggler_cfg = straggler \
            or getattr(host, "straggler_config", None)
        # populated by run()
        self.scheduler: Optional[EventScheduler] = None
        self.ledger: Optional[CostLedger] = None
        self.devices: List[DeviceRuntime] = []
        self.assignment: Dict[int, int] = {}
        self.tracker: Optional[StragglerTracker] = None
        self._evicted: set = set()
        self._flagged: set = set()
        self._mesh = mesh
        self._mesh_axis = mesh_axis
        self._param_specs = param_specs
        self.mesh_params: Dict[tuple, dict] = {}
        # physical environment (DESIGN.md §15): device name -> DeviceEnv
        # for every device whose DeviceConfig carries an active EnvSpec;
        # empty (the default) keeps every env branch untaken.
        self.envs: Dict[str, DeviceEnv] = {}
        # observability (DESIGN.md §14): run() swaps in the host's live
        # Telemetry bundle when one is configured; the falsy NULL_TRACER
        # default keeps every instrumented path allocation-free.
        self.telemetry = None
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
        # observability: reset the host's Telemetry for this run (fresh
        # tracer + registry), install it as the ledger's observer and
        # expose its tracer to every subsystem built below. A host
        # without telemetry keeps the falsy NULL_TRACER everywhere.
        tel = getattr(host, "telemetry", None)
        self.telemetry = tel
        if tel is not None:
            tel.reset()
            self.tracer = tel.tracer
            ledger.telemetry = tel
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

        # --- route streams, compose the per-device runtimes --------------
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
        scheduler.tracer = self.tracer
        scheduler.trace_dispatch = tel.spec.dispatch_events \
            if tel is not None else True
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
        for d, spec in enumerate(self.specs[1:], start=1):
            slots, dev_rng = clone_device_slots(self, spec, d, slots0,
                                                ledger)
            self.devices.append(DeviceRuntime(
                self, spec, d, slots, clone_pool(host, spec, slots),
                dev_rng))

        # --- physical environments (DESIGN.md §15): one DeviceEnv per
        # device with an active EnvSpec; the env observer wraps whatever
        # telemetry observer the ledger already has, so every charge's
        # energy drains the owning device's battery / heats its RC node.
        # No active env -> no observer swap: the default path is
        # untouched.
        self.envs = {}
        for dev in self.devices:
            env_spec = getattr(dev.spec, "env", None)
            if env_spec is not None and env_spec.active:
                dev.env = DeviceEnv(env_spec, dev.name, tracer=self.tracer)
                self.envs[dev.name] = dev.env
        if self.envs:
            ledger.telemetry = EnvLedgerObserver(self.envs,
                                                 inner=ledger.telemetry)

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

        # stragglers are observable once >= 2 devices report round times;
        # mitigation fires at sync boundaries, so it needs a sync period
        if len(self.specs) > 1 and self.aggregate_every > 0.0:
            self.tracker = StragglerTracker(
                len(self.specs), config=self._straggler_cfg)
        self._next_sync = self.aggregate_every or float("inf")

        # --- drive the shared timeline ------------------------------------
        def on_data(ev: Event, boundary: bool) -> None:
            self._advance(ev.time)
            self._settle_all(ev.time)
            if self.envs:
                self._step_envs(ev.time)
            self.device_for(ev.stream).on_data(ev, boundary)

        def on_scenario_change(previous: int, ev: Event) -> None:
            self.device_for(ev.stream).on_scenario_change(previous, ev)

        def on_inference(ev: Event) -> None:
            self._advance(ev.time)
            self._settle_all(ev.time)
            if self.envs:
                self._step_envs(ev.time)
            self.device_for(ev.stream).on_inference(ev)

        def on_probe(ev: Event) -> None:
            self._advance(ev.time)
            self._settle_all(ev.time)
            if self.envs:
                self._step_envs(ev.time)
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

    # ---- aggregation / stragglers ----------------------------------------
    def _settle_all(self, now: float) -> None:
        for dev in self.devices:
            dev.settle(now)

    def _step_envs(self, now: float) -> None:
        """Advance every live environment to `now` (after the devices
        settled, so the energy each env integrates is the energy the
        ledger charged up to `now`), apply any DVFS rescale to the
        device's executors, and hand battery-dead devices to the eviction
        path: streams re-route, deltas leave the merge — like a persistent
        straggler, with another cause."""
        for dev in self.devices:
            env = dev.env
            if env is None:
                continue
            env.step(now)
            dev.apply_dvfs()
            if env.battery_dead and dev.index not in self._evicted:
                self.evict_device(dev.index, now, reason="battery dead")

    def _advance(self, t: float) -> None:
        """Cross the sync boundaries the timeline has passed: settle
        every device to the boundary instant, then merge/mitigate."""
        while t >= self._next_sync:
            ts = self._next_sync
            self._settle_all(ts)
            self._sync(ts)
            self._next_sync += self.aggregate_every

    def _sync(self, ts: float) -> None:
        if self.tracker is not None:
            times = {d.index: float(np.mean(d.round_times))
                     for d in self.devices
                     if d.round_times and d.index not in self._evicted}
            if times:
                self.tracker.record_step(times)
            for d in self.devices:
                d.round_times.clear()
            for h in sorted(set(self.tracker.to_evict()) - self._evicted):
                self.evict_device(h, ts)
            current = set(self.tracker.stragglers()) - self._evicted
            for h in sorted(current - self._flagged):
                # straggler mitigation must be loud: a flagged device
                # loses its streams and sits merges out until it recovers
                log.warning("sync at t=%.3f: device %s flagged as "
                            "straggler — re-routing its streams",
                            ts, self.devices[h].name)
                if self.telemetry is not None:
                    self.telemetry.metrics.counter(
                        "straggler_flags",
                        device=self.devices[h].name).inc()
                if self.tracer:
                    self.tracer.instant("straggler", "flag", ts,
                                        device=self.devices[h].name)
                self._reroute_streams(h, ts)
            self._flagged = current
        self._merge(ts)

    def _merge(self, ts: float) -> None:
        """Federated merge (module docstring): per slot, average the
        participants' params weighted by rounds trained since the last
        sync. A device sits a slot's merge out when it is evicted,
        flagged slow, or mid-round (its params are a checkpointed round
        in flight); a merge needs >= 2 such devices and > 0 total weight.
        Optimizer state stays local (FedAvg merges params only)."""
        candidates = [d for d in self.devices
                      if d.index not in self._evicted
                      and d.index not in self._flagged
                      and not (d.env is not None and d.env.battery_dead)]
        tel = self.telemetry
        for name in self.devices[0].slots:
            group = [d for d in candidates
                     if d.slots[name].executor.active_round is None]
            for d in candidates:
                if d not in group:
                    # never a silent drop: a mid-round device sitting a
                    # merge out is expected, but observable (log + counter)
                    log.info("sync at t=%.3f: device %s sits out slot %r "
                             "merge (round in flight)", ts, d.name, name)
                    if tel is not None:
                        tel.metrics.counter("sync_skips",
                                            device=d.name).inc()
            if len(group) < 2:
                log.info("sync at t=%.3f: slot %r merge skipped "
                         "(%d eligible device(s), need >= 2)",
                         ts, name, len(group))
                continue
            ws = [float(d.rounds_since_sync.get(name, 0)) for d in group]
            total = sum(ws)
            if total <= 0.0:
                continue
            merged = tree_map(
                lambda *ls: (sum(w * l.float() for w, l in zip(ws, ls))
                             / total).to(ls[0].dtype),
                *[d.slots[name].executor.params for d in group])
            for d in group:
                ex = d.slots[name].executor
                ex.params = tree_map(torch.clone, merged)
                d.server.publish(ex.params, ts, slot=name)
                c = ex.cost
                t_sync = c.t_save_s + c.t_load_s
                self.ledger.charge_sync(
                    time_s=t_sync, energy_j=t_sync * c.overhead_power_w,
                    device=d.name, stream=FLEET_STREAM, model=name)
                r = self.scheduler.occupy(ts, t_sync, stream=FLEET_STREAM,
                                          device=d.name)
                if self.tracer:
                    self.tracer.span("sync", f"sync/{name}", r.start,
                                     t_sync, stream=FLEET_STREAM,
                                     device=d.name, slot=name,
                                     participants=len(group))
                d.rounds_since_sync[name] = 0

    def _reroute_streams(self, from_idx: int, ts: float) -> None:
        """Move every stream off device `from_idx` to the active
        non-flagged device with the largest rebalance share (inverse EMA
        step time — the fastest one). Buffered batches move with the
        stream; controllers and policy latches are fleet-level, so the
        stream's policy state survives the move untouched."""
        plan = self.tracker.rebalance_plan() if self.tracker else {}
        targets = [d for d in self.devices
                   if d.index not in self._evicted
                   and d.index not in self._flagged
                   and d.index != from_idx]
        if not targets:
            return
        target = max(targets, key=lambda d: plan.get(d.index, 0.0))
        src = self.devices[from_idx]
        for st, di in sorted(self.assignment.items()):
            if di != from_idx:
                continue
            self.assignment[st] = target.index
            batches = src.slot_of(st).executor.buffers.pop(st, None)
            for b in batches or ():
                target.slot_of(st).executor.enqueue(b, stream=st)

    def evict_device(self, index: int, ts: float, *,
                     reason: str = "persistent straggler") -> None:
        """Drop a device for good: its streams re-route, its deltas drop
        out of every future merge, and — when an elastic mesh was
        injected — the mesh shrinks and the survivors' params re-shard
        onto it (`mesh_params`). `reason` tells straggler evictions from
        environment-driven ones (a dead battery rides the same path,
        DESIGN.md §15)."""
        if index in self._evicted:
            return
        log.warning("t=%.3f: evicting device %s (%s); "
                    "its streams re-route and its deltas leave the merge",
                    ts, self.devices[index].name, reason)
        if self.telemetry is not None:
            self.telemetry.metrics.counter(
                "evictions", device=self.devices[index].name).inc()
        if self.tracer:
            self.tracer.instant("straggler", "evict", ts,
                                device=self.devices[index].name,
                                reason=reason)
        if self.tracker is not None:
            self.tracker.evict(index)
        self._evicted.add(index)
        self._reroute_streams(index, ts)
        if self._mesh is not None:
            from repro_torch.distributed import elastic, sharding

            size = sharding.axis_sizes(self._mesh).get(self._mesh_axis, 0)
            if size % 2 == 0 and size >= 2:
                self._mesh = elastic.shrink_mesh(self._mesh,
                                                 self._mesh_axis)
                if self._param_specs is not None:
                    for d in self.devices:
                        if d.index in self._evicted:
                            continue
                        for name, st in d.slots.items():
                            self.mesh_params[(d.index, name)] = \
                                elastic.remesh(st.executor.params,
                                               self._mesh,
                                               self._param_specs)

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
        for dev in self.devices:
            if dev.env is not None:
                dev.env.finalize(makespan)
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
            cell["evicted"] = float(dev.index in self._evicted)
            cell["battery_dead"] = float(dev.env.battery_dead) \
                if dev.env is not None else 0.0
            cell["throttle_s"] = dev.env.throttle_s \
                if dev.env is not None else 0.0
            per_device[dev.name] = cell
        tel = self.telemetry
        if tel is not None:
            for dev in self.devices:
                tel.metrics.gauge("utilization", device=dev.name).set(
                    per_device[dev.name]["utilization"])
                env = dev.env
                if env is not None:
                    st = env.state()
                    tel.metrics.gauge("temperature_c",
                                      device=dev.name).set(st.temperature_c)
                    if st.soc is not None:
                        tel.metrics.gauge("soc",
                                          device=dev.name).set(st.soc)
            tel.metrics.gauge("recompiles").set(float(
                sum(st.steps.recompiles for st in slots0.values())
                if host.pool is not None else host.steps.recompiles))
            tel.metrics.gauge("makespan_s").set(makespan)
            tel.flush_sinks()
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
