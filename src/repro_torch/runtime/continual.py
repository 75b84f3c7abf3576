"""ContinualRuntime — composition root of the event-driven continual-
learning loop of the paper (Fig. 1), ported from
`repro.runtime.continual`: training batches and inference requests
arrive on a shared timeline; a controller (ETuner or a baseline) decides
when to launch fine-tuning rounds and which layers are frozen; the cost
model charges per-round overheads (system init / load / save),
per-plan recompiles and the measured compute FLOPs.

The runtime itself is thin. It wires four owned subsystems (DESIGN.md
§1): `EventScheduler` (the timeline, device occupancy, scenario
boundaries), `InferenceServer` (request serving, the arrival-time
params-visibility seam, opt-in micro-batched serving), `FineTuneExecutor`
(round execution, the replay buffer, `RoundHook`s) and `CostLedger` (all
time/energy/FLOPs accounting); plus, optionally, a `ModelPool` of model
slots under a device memory budget. `run()` hands the timeline to a
`DeviceFleet` of one device (runtime/fleet.py → runtime/device.py).

Construction (DESIGN.md §11): the front door is the declarative
`RuntimeConfig` — `ContinualRuntime.from_config(cfg, ...)` or
`edgeol_session(cfg)` — with live objects (a custom benchmark, a
pre-built controller/pool, a cost model) injected alongside the config.
Both take ``device=`` (CUDA unless the caller names another, through
`repro_torch.resolve_device`); the models, train steps and batches live
there. The legacy kwarg constructor still works but is deprecated: it
delegates to the same resolution path and emits a `DeprecationWarning`.

Faithfulness notes (as the reference's): the model is pre-trained on
scenario 0 and costs are accounted from scenario 1 on; a small replay
buffer stands in for CORe50's CWR; inference requests resolve their
params at arrival time; validation accuracy (5% split) drives LazyTune,
inference accuracy is only recorded.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.data.arrivals import Event, build_timeline
from repro_torch.data.streams import ContinualBenchmark
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.config import (DeviceConfig, HookSpec, RuntimeConfig,
                                        SlotConfig, resolve_session)
from repro_torch.runtime.costmodel import EdgeCostModel, scale_cost
from repro_torch.runtime.executor import (FineTuneExecutor, ReplayBuffer,
                                          RoundHook)
from repro_torch.runtime.ledger import (DEFAULT_DEVICE, DEFAULT_MODEL,
                                        CostLedger)
from repro_torch.runtime.modelpool import ModelPool
from repro_torch.runtime.train_loop import TrainStepCache


@dataclass
class RunResult:
    avg_inference_acc: float
    total_time_s: float
    total_energy_j: float
    compute_tflops: float
    rounds: int
    recompiles: int
    inference_accs: List[float] = field(default_factory=list)
    breakdown: Dict[str, float] = field(default_factory=dict)
    controller_stats: Dict[str, Any] = field(default_factory=dict)
    val_curve: List[float] = field(default_factory=list)
    # per-arrival-stream attribution: stream id -> {time_s, energy_j,
    # flops, rounds, preemptions, avg_inference_acc, inferences,
    # latency_p50, latency_p95}
    per_stream: Dict[int, Dict[str, float]] = field(default_factory=dict)
    # per-model-slot attribution (single-model runs report one "default"
    # slot): slot -> {time_s, energy_j, flops, rounds, swaps,
    # avg_inference_acc, inferences}
    per_model: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # per-device attribution (one "dev0" in the port): device -> {time_s,
    # energy_j, flops, rounds, swaps, syncs, avg_inference_acc,
    # inferences, streams, utilization, evicted, battery_dead,
    # throttle_s}
    per_device: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # QoS: total round splits absorbed by lower-priority streams' rounds
    preemptions: int = 0
    # ModelPool: total cold-slot swap-ins charged to the run
    swaps: int = 0
    # DeviceFleet: per-device cross-device sync charges (federated merges)
    syncs: int = 0
    # detector mode: drift-confirmation probe passes fired
    probes: int = 0

    def summary(self) -> str:
        return (f"acc={self.avg_inference_acc*100:.2f}% "
                f"time={self.total_time_s:.1f}s energy={self.total_energy_j:.1f}J "
                f"rounds={self.rounds} recompiles={self.recompiles} "
                f"tflops={self.compute_tflops:.2f}")


@dataclass
class _SlotState:
    """Per-model-slot runtime state assembled by `run()`: the single-model
    path has exactly one ("default"); a ModelPool run has one per slot."""
    name: str
    model: Any
    bench: ContinualBenchmark
    controller: Any
    steps: TrainStepCache
    executor: FineTuneExecutor
    reference_params: Any = None


class ContinualRuntime:
    def __init__(self, model, benchmark: Optional[ContinualBenchmark],
                 controller,
                 cost_model: Optional[EdgeCostModel] = None,
                 opt_cfg=None, seed: int = 0,
                 boundaries: str = "oracle",       # 'oracle' | 'detector'
                 replay_batches: int = 2,
                 pretrain_epochs: int = 3,
                 inference_batch: int = 16,
                 quant_bits: int = 0,
                 unlabeled_fraction: float = 0.0,
                 calibrate_cost: bool = True,
                 inference_window: float = 0.0,
                 extra_hooks: Optional[List[RoundHook]] = None,
                 stream_benchmarks: Optional[Dict[int, ContinualBenchmark]] = None,
                 controller_factory: Optional[Callable[[Any], Any]] = None,
                 preemptible: bool = False,
                 preempt_resume_cost_s: float = 0.0,
                 model_pool: Optional[ModelPool] = None,
                 device=None):
        """Deprecated legacy kwarg constructor. It builds the equivalent
        `RuntimeConfig` (quant_bits/unlabeled_fraction become per-slot
        `HookSpec`s) and delegates to the same resolution path as
        `from_config`, while steering callers to the declarative API."""
        warnings.warn(
            "ContinualRuntime legacy kwarg construction is deprecated; "
            "build a RuntimeConfig and use "
            "ContinualRuntime.from_config(cfg, ...) or edgeol_session(cfg) "
            "(DESIGN.md §11)", DeprecationWarning, stacklevel=2)
        hook_specs = []
        if quant_bits:
            hook_specs.append(HookSpec("fake-quant", {"bits": quant_bits}))
        if unlabeled_fraction:
            hook_specs.append(HookSpec("simsiam",
                                       {"fraction": unlabeled_fraction}))
        cfg = RuntimeConfig(
            slots={"default": SlotConfig(hooks=tuple(hook_specs))},
            seed=seed, boundaries=boundaries,
            replay_batches=replay_batches, pretrain_epochs=pretrain_epochs,
            inference_batch=inference_batch, calibrate_cost=calibrate_cost,
            inference_window=inference_window, preemptible=preemptible,
            preempt_resume_cost_s=preempt_resume_cost_s)
        self._init(**resolve_session(
            cfg, device=device, model=model, benchmark=benchmark,
            controller=controller, controller_factory=controller_factory,
            stream_benchmarks=stream_benchmarks, model_pool=model_pool,
            cost_model=cost_model, opt_cfg=opt_cfg,
            extra_hooks=extra_hooks))

    @classmethod
    def from_config(cls, cfg: RuntimeConfig, *, device=None, model=None,
                    benchmark=None, controller=None, controller_factory=None,
                    stream_benchmarks=None, model_pool=None,
                    cost_model=None, opt_cfg=None, extra_hooks=None,
                    workload_spec=None) -> "ContinualRuntime":
        """The declarative front door (DESIGN.md §11): materialize a
        session from a validated `RuntimeConfig` on `device`. Anything
        the config cannot express serializably — a custom benchmark
        object, a pre-built controller/factory/pool, a cost model, live
        RoundHooks, an already-scaled `WorkloadSpec` — is injected as a
        keyword and wins over what the config would build. When the
        config names a workload preset, the per-stream benchmarks and the
        compiled event timeline are materialized too and `run()` replays
        them by default."""
        rt = cls.__new__(cls)
        rt._init(**resolve_session(
            cfg, device=device, model=model, benchmark=benchmark,
            controller=controller, controller_factory=controller_factory,
            stream_benchmarks=stream_benchmarks, model_pool=model_pool,
            cost_model=cost_model, opt_cfg=opt_cfg,
            extra_hooks=extra_hooks, workload_spec=workload_spec))
        return rt

    def _init(self, *, model, benchmark, controller, cost_model, opt_cfg,
              seed, boundaries, replay_batches, pretrain_epochs,
              inference_batch, calibrate_cost, inference_window, hooks,
              slot_hooks, stream_benchmarks, controller_factory,
              preemptible, preempt_resume_cost_s, model_pool, device,
              compiled=False, session_events=None,
              devices=(), routing="static", aggregate_every=0.0):
        # ModelPool construction path: the pool's slots carry the models,
        # benchmarks and (optionally) controllers; model/benchmark/
        # controller may be None and default to the first slot's. Slot
        # controllers missing from the pool are built through the
        # `controller_factory` seam, called with the *slot name*.
        self.pool = model_pool
        if model_pool is not None:
            first = next(iter(model_pool.slots.values()))
            model = model if model is not None else first.model
            benchmark = benchmark if benchmark is not None else first.benchmark
        self.device = device
        self.model = model
        self.bench = benchmark
        self.controller = controller
        # multi-stream runs: stream id -> its own benchmark (falls back to
        # `benchmark`); streams > 0 get controllers from
        # `controller_factory(stream)` when given, else share `controller`
        self.stream_benchmarks = dict(stream_benchmarks or {})
        self.controller_factory = controller_factory
        self.cost = cost_model if cost_model is not None else EdgeCostModel()
        self.opt_cfg = opt_cfg or AdamWConfig(lr=1e-3)
        self.seed = seed
        self.boundaries = boundaries
        self.replay_batches = replay_batches
        self.pretrain_epochs = pretrain_epochs
        self.inference_batch = inference_batch
        self.calibrate_cost = calibrate_cost
        self.inference_window = inference_window
        # QoS: when True, fine-tuning rounds run as preemptible
        # reservations — a strictly-higher-priority inference arrival
        # splits the in-flight round and the round resumes, its cost
        # charged in segments that sum to the unpreempted charge
        self.preemptible = preemptible
        # QoS: modeled checkpoint-resume overhead paid on each round split
        self.preempt_resume_cost_s = preempt_resume_cost_s
        # compiled hot path (DESIGN.md §12): all training goes through the
        # fused masked step (CUDA graphs on the card), serving through
        # deferred stacked dispatch, and the event loop through segment
        # slicing. `segment` (overridable before run(); the equivalence
        # tests force it off) additionally fuses whole same-shape runs —
        # per-event compiled execution is the same masked loop at bucket
        # 1, so toggling it never moves a bit.
        self.compiled = bool(compiled)
        self.segment = True
        # round hooks: model-wrapping ones bind first so every later
        # consumer sees the wrapped model
        self.hooks: List[RoundHook] = list(hooks or [])
        self.slot_hooks: Dict[str, List[RoundHook]] = {
            k: list(v) for k, v in (slot_hooks or {}).items()}
        for h in self.hooks:
            self.model = h.bind(self.model)
        # DeviceFleet knobs (DESIGN.md §13): device specs, initial stream
        # routing and the federated aggregation period
        self.devices = tuple(devices or ())
        self.routing = routing
        self.aggregate_every = float(aggregate_every)
        # the DeviceFleet the last run() drove (live handle for tests)
        self.fleet = None
        # a config-built session may carry its workload's compiled event
        # timeline; run() replays it when no explicit events are passed
        self._session_events: Optional[List[Event]] = session_events
        # single-model step cache lives on the runtime (reused across
        # run() calls); pool slots build their own caches per run
        self.steps = None if model_pool is not None else \
            TrainStepCache(model=self.model, opt_cfg=self.opt_cfg)

    @property
    def session_events(self) -> Optional[List[Event]]:
        """The workload timeline a config-built session will replay when
        `run()` is called without explicit events (None otherwise)."""
        return self._session_events

    # -------------------------------------------------------------------
    def _build_slots(self, ledger: CostLedger, rng: np.random.Generator,
                     device: Optional[DeviceConfig] = None
                     ) -> Dict[str, _SlotState]:
        """Assemble per-slot runtime state for one device (`device=None`
        means the reference "dev0" at identity cost scales). The
        single-model path builds exactly one "default" slot wired to the
        runtime's own model/steps/cost and the *shared* rng — the
        reference's RNG consumption order, which the replay samples and
        request draws depend on."""
        spec = device if device is not None else DeviceConfig(DEFAULT_DEVICE)
        slots: Dict[str, _SlotState] = {}
        if self.pool is None:
            replay = ReplayBuffer(
                self.bench.scenarios[0].train_batches[:self.replay_batches])
            executor = FineTuneExecutor(
                self.steps,
                scale_cost(self.cost, speed=spec.speed_scale,
                           energy=spec.energy_scale),
                ledger, replay, rng=rng,
                hooks=self.hooks, calibrate_cost=self.calibrate_cost,
                device_name=spec.name, speed_scale=spec.speed_scale,
                preempt_resume_cost_s=self.preempt_resume_cost_s,
                compiled=self.compiled, fuse=self.segment)
            slots[DEFAULT_MODEL] = _SlotState(
                DEFAULT_MODEL, self.model, self.bench, self.controller,
                self.steps, executor)
            return slots
        for i, slot in enumerate(self.pool.slots.values()):
            # per-slot RoundHooks: wrap this slot's model only
            hooks = self.slot_hooks.get(slot.name, [])
            model = slot.model
            for h in hooks:
                model = h.bind(model)
            ctrl = slot.controller
            if ctrl is None and self.controller_factory is not None:
                ctrl = self.controller_factory(slot.name)
            if ctrl is None:
                ctrl = self.controller
            if ctrl is None:
                raise ValueError(
                    f"slot {slot.name!r} has no controller: set "
                    f"ModelSlot.controller or pass controller_factory")
            steps = TrainStepCache(model=model, opt_cfg=self.opt_cfg)
            replay = ReplayBuffer(
                slot.benchmark.scenarios[0].train_batches[:self.replay_batches])
            executor = FineTuneExecutor(
                steps,
                scale_cost(slot.cost, speed=spec.speed_scale,
                           energy=spec.energy_scale),
                ledger, replay,
                rng=np.random.default_rng([self.seed, i]),
                hooks=hooks, calibrate_cost=self.calibrate_cost,
                model_name=slot.name, device_name=spec.name,
                speed_scale=spec.speed_scale,
                preempt_resume_cost_s=self.preempt_resume_cost_s,
                compiled=self.compiled, fuse=self.segment)
            slots[slot.name] = _SlotState(slot.name, model,
                                          slot.benchmark, ctrl, steps,
                                          executor)
        return slots

    # -------------------------------------------------------------------
    def run(self, events: Optional[List[Event]] = None,
            inferences_total: Optional[int] = None,
            data_dist: Optional[str] = None,
            inf_dist: Optional[str] = None) -> RunResult:
        """Drive the full continual-learning session. The timeline comes
        from, in precedence order: explicit `events`, the config-built
        session's compiled workload (`session_events`), or a legacy
        timeline generated from `inferences_total`/`data_dist`/`inf_dist`
        (defaults 60/"poisson"/"poisson") — the generation knobs apply
        only to that last case."""
        timeline_kw = {k: v for k, v in (("inferences_total",
                                          inferences_total),
                                         ("data_dist", data_dist),
                                         ("inf_dist", inf_dist))
                       if v is not None}
        if timeline_kw and (events is not None
                            or self._session_events is not None):
            warnings.warn(
                f"run(): {sorted(timeline_kw)} only shape the generated "
                f"legacy timeline and are ignored when events are "
                f"supplied (explicit or from the session's workload "
                f"config)", UserWarning, stacklevel=2)
        bench = self.bench
        if events is None and self._session_events is not None:
            # config-built session: replay the workload's compiled timeline
            events = list(self._session_events)
        if events is None:
            events = build_timeline(
                num_scenarios=bench.num_scenarios - 1,
                batches_per_scenario=len(bench.scenarios[1].train_batches),
                inferences_total=timeline_kw.get("inferences_total", 60),
                seed=self.seed,
                data_dist=timeline_kw.get("data_dist", "poisson"),
                inf_dist=timeline_kw.get("inf_dist", "poisson"))
            # shift scenario ids by 1 (scenario 0 = pretraining)
            events = [dataclasses.replace(e, scenario=e.scenario + 1)
                      for e in events]

        # delegate to the fleet (DESIGN.md §13): the session is a
        # DeviceFleet of one device
        from repro_torch.runtime.fleet import DeviceFleet

        self.fleet = DeviceFleet(self)
        return self.fleet.run(events)


def edgeol_session(cfg: RuntimeConfig, **inject) -> ContinualRuntime:
    """Declarative session front door (DESIGN.md §11): build a ready
    `ContinualRuntime` from a `RuntimeConfig`. Keyword injections are the
    same as `ContinualRuntime.from_config`, ``device=`` included::

        res = edgeol_session(RuntimeConfig(slots={"default": SlotConfig(
            arch="deit-tiny")}), device="cpu").run()
    """
    return ContinualRuntime.from_config(cfg, **inject)
