"""DeviceRuntime — one fleet device's slice of the continual runtime
(the port of `repro.runtime.device`, DESIGN.md §13).

Everything that used to live in `ContinualRuntime.run()`'s closures — the
per-slot executors, the serving lane, ModelPool residency, the
event-callback bodies (data / inference / probe / settle / trailing
flush) — lives on a `DeviceRuntime`, one instance per fleet device.
`ContinualRuntime` itself is "a fleet of size 1": its `run()` resolves
the timeline and hands it to a `DeviceFleet` (runtime/fleet.py), whose
device 0 is built through the reference's construction order (same RNG
objects, same order), so the replay samples and request draws match the
reference's run on the same seed.

What is *per device*: slots (params/optimizer/executor/replay), the
`InferenceServer` lane, the ModelPool clone, the occupancy lane on the
shared `EventScheduler`, and the device's numpy RNG. What stays *shared*
(fleet-level): the event timeline, the `CostLedger`, the per-stream
controllers and policy latches (`pending_change` / `scenario_started` /
`last_round_end` / `launch_scenario`), probe counters and the validation
curve. Device 0 of the default fleet shares the run's RNG with its
executor; clone devices draw from `default_rng([seed, 104729, index])`
(and `[..., slot]` under a pool) so no stream collides with device 0's.

A device may carry a physical environment (`env`, DESIGN.md §15): the
fleet builds one for a `DeviceConfig` with an active `EnvSpec`. Then
`apply_dvfs` rescales the device's cost models to the governor's level,
and `allow_round` asks the stream's `ThrottlePolicy` facet before a
round starts. Without one, every round is allowed.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch import tree_map
from repro_torch.data.arrivals import Event
from repro_torch.runtime.costmodel import scale_cost
from repro_torch.runtime.executor import FineTuneExecutor, ReplayBuffer
from repro_torch.runtime.inference import InferenceServer
from repro_torch.runtime.modelpool import ModelPool, ModelSlot, tree_mb
from repro_torch.runtime.train_loop import as_tensor, evaluate


class DeviceRuntime:
    """Scheduler + serving + executors + pool for ONE fleet device.

    Method bodies are the reference's, modulo batches becoming tensors
    on the slot model's device (`as_tensor`). The fleet settles every
    device before dispatching an event, so the `on_*` handlers do not
    re-settle."""

    def __init__(self, fleet, spec, index: int, slots: Dict, pool, rng):
        self.fleet = fleet
        self.host = fleet.host
        self.spec = spec
        self.name = spec.name
        self.index = index
        self.scheduler = fleet.scheduler
        self.ledger = fleet.ledger
        self.rng = rng
        self.slots = slots
        self.pool = pool
        self.primary = next(iter(slots.values()))
        # fine-tuning rounds completed since the last cross-device merge
        # (the FedAvg weight) and the interval's round times (the
        # straggler-tracker feed), reset by the fleet at each sync
        self.rounds_since_sync: Dict[str, int] = {n: 0 for n in slots}
        self.round_times: List[float] = []
        # observability (DESIGN.md §14): the fleet's tracer (NULL_TRACER
        # when telemetry is off) records this device's swap/cka/probe
        # spans
        self.tracer = fleet.tracer
        # physical environment (DESIGN.md §15): assigned by the fleet
        # when this device's DeviceConfig carries an active EnvSpec.
        # None (the default) keeps every env branch untaken.
        self.env = None
        self._dvfs_applied: Dict[str, float] = {}
        host = self.host
        self.server = InferenceServer(self.primary.model,
                                      batch_window=host.inference_window,
                                      on_served=self.served,
                                      fused=host.compiled,
                                      tracer=self.tracer, track=self.name)
        for name, st in slots.items():
            self.server.register(name, st.model)
            self.server.publish(st.executor.params, 0.0, slot=name)

    # ---- lookups ---------------------------------------------------------
    def slot_of(self, st: int):
        return self.slots.get(self.fleet.stream_slot.get(st,
                                                         self.primary.name),
                              self.primary)

    # ---- serving ---------------------------------------------------------
    def served(self, logits, stream=0) -> bool:
        # route the request's logits to its stream's controller; a True
        # return (detected scenario change) is latched per stream — or,
        # in detector mode, schedules a dedicated drift-confirmation
        # probe on the live timeline instead
        fleet = self.fleet
        hit = fleet.ctrl_for(stream).inference_served(logits)
        if hit:
            if self.host.boundaries == "detector":
                fleet.probes_pushed[0] += 1
                self.scheduler.push(Event(
                    self.scheduler.now, "probe",
                    self.scheduler.scenario_of(stream),
                    fleet.probes_pushed[0] - 1, stream=stream,
                    modality=fleet.stream_slot.get(stream, "cv")))
            else:
                fleet.pending_change[stream] = True
        return hit

    # ---- rounds ----------------------------------------------------------
    def acquire(self, slot, now: float, stream: int) -> None:
        # ModelPool residency: touching a cold slot swaps it in — a
        # real ledger charge and real occupancy on this device's lane
        if self.pool is None:
            return
        t_swap, e_swap, _ = self.pool.ensure_resident(slot.name)
        if t_swap:
            self.ledger.charge_swap(time_s=t_swap, energy_j=e_swap,
                                    model=slot.name, stream=stream,
                                    device=self.name)
            r = self.scheduler.occupy(now, t_swap, stream=stream,
                                      device=self.name)
            if self.tracer:
                self.tracer.span("swap", f"swap/{slot.name}", r.start,
                                 t_swap, stream=stream, device=self.name,
                                 slot=slot.name)

    def complete(self, slot, report) -> None:
        # a round's results reach the rest of the system when it
        # completes: publish to serving, validate, notify the
        # stream's controller, charge SimFreeze's CKA probes
        fleet = self.fleet
        stream = report.stream
        ctrl = fleet.ctrl_for(stream)
        pub = getattr(ctrl, "publish_policy", None)
        if pub is None:
            self.server.publish(slot.executor.params, report.end,
                                slot=slot.name)
        else:
            self.server.publish(slot.executor.params,
                                pub.visible_at(report.end), slot=slot.name,
                                delayed=pub.delayed)
        # validation accuracy (labeled 5% split) -> LazyTune; the
        # split belongs to the scenario current at round *launch*
        val = fleet.bench_for(stream).scenarios[
            fleet.launch_scenario.pop(
                stream, self.scheduler.scenario_of(stream))].val
        val_acc, _ = evaluate(slot.model, slot.executor.params,
                              as_tensor(val, slot.model.device))
        fleet.val_curve.append(val_acc)
        cka_before = ctrl.simfreeze.state.cka_flops \
            if hasattr(ctrl, "simfreeze") else 0.0
        ctrl.round_finished(report.iters, val_acc, slot.executor.params)
        if hasattr(ctrl, "simfreeze"):
            dcka = ctrl.simfreeze.state.cka_flops - cka_before
            if dcka:
                tc, ec = slot.executor.cost.compute_cost(dcka)
                self.ledger.charge_probe("cka", tc, ec, stream=stream,
                                         model=slot.name, device=self.name)
                if self.tracer:
                    self.tracer.span("cka", f"cka/{slot.name}", report.end,
                                     tc, stream=stream, device=self.name,
                                     slot=slot.name)
        fleet.last_round_end[stream] = report.end
        self.rounds_since_sync[slot.name] += 1
        self.round_times.append(report.time_s)

    def settle(self, now: float) -> None:
        # preemptible rounds complete lazily: once the timeline passes
        # a reservation's end, finalize it (train the remaining
        # checkpointed batches, charge the exact-remainder segment)
        for st in self.slots.values():
            report = st.executor.finalize_round(now)
            if report is not None:
                self.complete(st, report)

    # ---- env / throttling (DESIGN.md §15) --------------------------------
    def apply_dvfs(self) -> None:
        """Rescale this device's executor cost models to the env's
        current DVFS level. Rescaling is *relative* (new level over the
        level already applied) so the calibrated base survives repeated
        transitions; executors still awaiting their one-shot calibration
        are skipped — calibration would overwrite the scale wholesale —
        and pick the level up after their first round."""
        level = self.env.level
        exp = self.env.spec.dvfs_power_exponent
        for name, st in self.slots.items():
            ex = st.executor
            if ex.calibrate_cost:
                continue
            applied = self._dvfs_applied.get(name, 1.0)
            if level != applied:
                rel = level / applied
                ex.cost = scale_cost(ex.cost, speed=rel, energy=rel ** exp)
                self._dvfs_applied[name] = level

    def allow_round(self, now: float, stream: int) -> bool:
        """ThrottlePolicy consultation — the fifth PolicyStack facet.
        Env-less devices, and controllers without a throttle facet
        (monolithic controllers, the baselines among them), always
        allow."""
        if self.env is None:
            return True
        ctrl = self.fleet.ctrl_for(stream)
        pol = getattr(ctrl, "throttle", None)
        if pol is None:
            return True
        slot = self.slot_of(stream)
        t_est, e_est = slot.executor.estimate_round(ctrl.plan, stream)
        if pol.allow_round(self.env.state(), time_s=t_est, energy_j=e_est):
            return True
        if self.tracer:
            self.tracer.instant("throttle", f"defer/{slot.name}", now,
                                stream=stream, device=self.name,
                                slot=slot.name)
        if self.fleet.telemetry is not None:
            self.fleet.telemetry.metrics.counter(
                "throttle_deferrals", device=self.name).inc()
        return False

    def finish_round(self, now: float, stream: int = 0) -> None:
        fleet = self.fleet
        slot = self.slot_of(stream)
        self.acquire(slot, now, stream)
        fleet.launch_scenario[stream] = self.scheduler.scenario_of(stream)
        report = slot.executor.execute_round(
            fleet.ctrl_for(stream).plan, now, self.scheduler, stream=stream,
            priority=fleet.stream_priority.get(stream, 0),
            preemptible=self.host.preemptible)
        if report is None and slot.executor.active_round is None:
            fleet.launch_scenario.pop(stream, None)  # nothing was buffered
        elif report is not None:  # synchronous (non-preemptible) path
            self.complete(slot, report)

    # ---- event handlers (fleet settles every device first) ---------------
    def on_scenario_change(self, previous: int, ev: Event) -> None:
        # keep a replay sample of the just-entered scenario
        sc = self.fleet.bench_for(ev.stream).scenarios[ev.scenario]
        self.slot_of(ev.stream).executor.replay.add(
            sc.train_batches[ev.index % len(sc.train_batches)])

    def on_data(self, ev: Event, boundary: bool) -> None:
        fleet = self.fleet
        st = ev.stream
        ctrl = fleet.ctrl_for(st)
        slot = self.slot_of(st)
        sc = fleet.bench_for(st).scenarios[ev.scenario]
        batch = sc.train_batches[ev.index % len(sc.train_batches)]
        # bound micro-batch deferral: a queued group whose window has
        # elapsed is served now, so controller signals driven by
        # inference_served (LazyTune decay, scenario detection) lag by
        # at most one window.
        self.server.expire(ev.time)
        self.server.drain()  # fused mode: deliver deferred serves now
        change = fleet.pending_change.get(st, False) \
            and self.host.boundaries == "detector"
        if (boundary and self.host.boundaries == "oracle") or change:
            fleet.pending_change[st] = False
            if ctrl.plan is not None and hasattr(ctrl, "scenario_changed"):
                ctrl.scenario_changed(slot.executor.params,
                                      as_tensor(batch, slot.model.device))
        if getattr(ctrl, "needs_reference", True) and \
                hasattr(ctrl, "start_scenario") and \
                (boundary or (self.scheduler.scenario_of(st)
                              and not fleet.scenario_started.get(st, False))):
            ctrl.start_scenario(slot.reference_params,
                                as_tensor(batch, slot.model.device))
            fleet.scenario_started[st] = True
        slot.executor.enqueue(batch, stream=st)
        if ctrl.should_trigger(slot.executor.pending_for(st),
                               staleness=ev.time
                               - fleet.last_round_end.get(st, 0.0),
                               priority=fleet.stream_priority.get(st, 0)) \
                and self.scheduler.idle_at(ev.time, self.name) \
                and self.allow_round(ev.time, st):
            self.finish_round(ev.time, st)

    def on_inference(self, ev: Event) -> None:
        fleet = self.fleet
        st = ev.stream
        b = fleet.bench_for(st)
        slot = self.slot_of(st)
        cur = self.scheduler.scenario_of(st)
        sc = b.scenarios[min(ev.scenario, cur) or ev.scenario]
        test = b.scenarios[max(cur, 1)].test \
            if ev.scenario <= cur else sc.test
        idx = self.rng.choice(len(test["labels"]),
                              min(self.host.inference_batch,
                                  len(test["labels"])),
                              replace=False)
        # QoS serving latency (arrival -> modeled service instant): an
        # idle device serves at once; a busy one makes the request
        # wait out the round's occupancy — unless the arrival outranks
        # a preemptible round, which it splits and is served at its
        # arrival time. A request for a *cold* ModelPool slot first
        # waits out the slot's swap-in (and never preempts).
        swap_needed = self.pool is not None \
            and not self.pool.is_resident(slot.name)
        if self.scheduler.idle_at(ev.time, self.name) and not swap_needed:
            latency = 0.0
        elif not swap_needed and self.scheduler.can_preempt(
                ev.time, ev.priority, self.name):
            active = next(s.executor for s in self.slots.values()
                          if s.executor.active_round is not None)
            active.preempt(ev.time, self.scheduler, preempting_stream=st)
            latency = 0.0
        else:
            self.acquire(slot, ev.time, st)
            latency = self.scheduler.busy_until_of(self.name) - ev.time
        if self.fleet.telemetry is not None:
            self.fleet.telemetry.metrics.histogram(
                "latency_s", stream=st).observe(latency)
        self.server.submit(ev.time, {k: v[idx] for k, v in test.items()},
                           stream=st, latency=latency, slot=slot.name)

    def on_probe(self, ev: Event) -> None:
        # detector-driven probe: confirm a flagged drift with a
        # dedicated forward pass over the stream's current validation
        # split before the policy reacts (charged as probe compute,
        # ~1/3 of a measured train step: forward only)
        fleet = self.fleet
        st = ev.stream
        self.server.drain()  # fused mode: serve anything deferred first
        fleet.probes_fired[0] += 1
        slot = self.slot_of(st)
        self.acquire(slot, ev.time, st)
        ctrl = fleet.ctrl_for(st)
        b = fleet.bench_for(st)
        sc = b.scenarios[min(max(self.scheduler.scenario_of(st), ev.scenario,
                                 1), len(b.scenarios) - 1)]
        _, logits = evaluate(slot.model, slot.executor.params,
                             as_tensor(sc.val, slot.model.device))
        flops = slot.steps.flops(ctrl.plan, sc.train_batches[0]) / 3.0
        tc, ec = slot.executor.cost.compute_cost(flops)
        self.ledger.charge_probe("probe", tc, ec, stream=st,
                                 model=slot.name, device=self.name)
        if self.tracer:
            self.tracer.span("probe", f"probe/{slot.name}", ev.time, tc,
                             stream=st, device=self.name, slot=slot.name)
        confirm = getattr(ctrl, "probe_served", None)
        if confirm is None or confirm(logits):
            fleet.pending_change[st] = True

    def trailing_flush(self) -> None:
        # any buffered data still fine-tunes (no data dropped) — unless
        # the device's ThrottlePolicy says it cannot afford the round
        # (a drained battery must not be overdrawn by the flush)
        for slot in self.slots.values():
            for st in slot.executor.pending_streams:
                now = self.scheduler.busy_until_of(self.name)
                if not self.allow_round(now, st):
                    continue
                self.finish_round(now, st)
                self.settle(float("inf"))


# ---------------------------------------------------------------------------
# clone-device construction (devices 1..N-1 of a fleet)


def clone_device_slots(fleet, spec, index: int, slots0: Dict,
                       ledger) -> Dict:
    """Per-device slot states for a clone device: same models, benchmarks,
    hook objects and the SAME `TrainStepCache`s as device 0, but its own
    executor (scaled cost model, this device's attribution keys), its own
    replay buffer, and a copy of device 0's pretrained params/optimizer
    state (every device starts from the same "originally well-trained"
    model). Under a pool, per-device controllers come from the host's
    `controller_factory` when available, else the slot controller is
    shared."""
    from repro_torch.runtime.continual import _SlotState

    host = fleet.host
    slots: Dict = {}
    device_rng = np.random.default_rng([host.seed, 104729, index])
    for i, (name, src) in enumerate(slots0.items()):
        base = host.cost if host.pool is None else host.pool.slot(name).cost
        cost = scale_cost(base, speed=spec.speed_scale,
                          energy=spec.energy_scale)
        replay = ReplayBuffer(
            src.bench.scenarios[0].train_batches[:host.replay_batches])
        if host.pool is not None:
            ctrl = host.controller_factory(name) \
                if host.controller_factory is not None else src.controller
            ex_rng = np.random.default_rng([host.seed, 104729, index, i])
        else:
            ctrl = src.controller
            ex_rng = device_rng  # shared with the device's inference draws
        executor = FineTuneExecutor(
            src.steps, cost, ledger, replay, rng=ex_rng,
            hooks=src.executor.hooks, calibrate_cost=host.calibrate_cost,
            model_name=name, device_name=spec.name,
            speed_scale=spec.speed_scale,
            preempt_resume_cost_s=host.preempt_resume_cost_s,
            compiled=host.compiled, fuse=host.segment,
            tracer=fleet.tracer)
        executor.load(tree_map(torch.clone, src.executor.params),
                      _clone_state(src.executor.opt_state))
        slots[name] = _SlotState(name, src.model, src.bench, ctrl,
                                 src.steps, executor,
                                 reference_params=src.reference_params)
    return slots, device_rng


def _clone_state(opt_state):
    """A copy of an optimizer state (a NamedTuple of tensors and trees)."""
    return type(opt_state)(*(tree_map(torch.clone, t) for t in opt_state))


def clone_pool(host, spec, slots):
    """A clone device's ModelPool: same slot bindings, per-device scaled
    swap costs, residency tracked against the device's own memory budget
    (`DeviceConfig.memory_budget_mb`, falling back to the session's)."""
    if host.pool is None:
        return None
    budget = spec.memory_budget_mb or host.pool.memory_budget_mb
    pslots = [ModelSlot(s.name, s.model, s.benchmark,
                        cost=scale_cost(s.cost, speed=spec.speed_scale,
                                        energy=spec.energy_scale),
                        memory_mb=s.memory_mb)
              for s in host.pool.slots.values()]
    pool = ModelPool(pslots, memory_budget_mb=budget)
    for name, st in slots.items():
        pool.set_memory(name, tree_mb(st.executor.params,
                                      st.executor.opt_state))
    pool.warm()
    return pool
