"""RuntimeConfig — the declarative, validated, dict/JSON-round-trippable
session description for `ContinualRuntime` (DESIGN.md §11).

The pre-config runtime had accreted ~18 constructor kwargs across PRs;
every new capability (per-stream policies, QoS, ModelPool, hooks) meant
threading yet another argument through `ContinualRuntime.__init__`. A
`RuntimeConfig` replaces that surface with one serializable object:

- **slots**: one `SlotConfig` per model slot (a single entry is the
  single-model path; several entries run under a `ModelPool`). Each slot
  names its architecture, benchmark, **policy stack**
  (`repro_torch.core.policies.PolicyStackSpec` — trigger / freeze /
  drift / publish / throttle) and **hooks** (fake-quant QAT, SimSiam — per slot, so a
  quantized CV slot can sit next to an fp32 NLP slot under a pool).
- **workload**: optionally a workload preset name +
  `workload_scale` knobs; the session then materializes per-stream
  benchmarks and the compiled event timeline itself.
- scalar session knobs: seed, boundaries, QoS (preemptible +
  preempt_resume_cost_s), serving (inference_batch/window), pool memory
  budget, replay/pretrain settings.

`ContinualRuntime.from_config(cfg, ...)` / `edgeol_session(cfg)` are the
front doors; non-serializable live objects (a custom benchmark, a
pre-built controller or pool, a cost model) are *injected* alongside the
config and win over what the config would build. The legacy kwarg
constructor delegates here and emits a `DeprecationWarning`.

`RuntimeConfig.from_dict(cfg.to_dict())` is the identity; unknown keys,
policy names and hook names raise with the valid alternatives listed.

The port's copy (`repro_torch.runtime.config`) keeps the reference's
names, fields, validation and dict form, so a dict either package's
`to_dict` writes loads in the other. What the port cannot run yet raises
`NotImplementedError` naming its ROADMAP item. An active `TelemetrySpec`
builds a live `repro_torch.obs.Telemetry`. Several devices, least-loaded
routing, cross-device merging, straggler eviction and devices with an
active `EnvSpec` run in the port's fleet (runtime/fleet.py). Every
workload preset runs, the two-modality `mixed` one too: its `nlp`
stream binds a bert-base slot beside the CV slot in a config-built
`ModelPool`. Sessions take ``device=`` and resolve it through
`repro_torch.resolve_device`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import resolve_device
from repro_torch.core.policies import PolicyStackSpec
from repro_torch.env.spec import EnvSpec
from repro_torch.obs.spec import TelemetrySpec
from repro_torch.runtime.executor import (FakeQuantHook, RoundHook,
                                          SimSiamHook)

#: workload_scale keys forwarded to the workload presets (plus
#: `batch_size`, consumed by per-stream benchmark materialization).
WORKLOAD_SCALE_KEYS = ("batches_per_scenario", "inferences",
                       "num_scenarios", "scenario_span", "batch_size",
                       "fleet_streams")

BOUNDARY_MODES = ("oracle", "detector")


@dataclass(frozen=True)
class HookSpec:
    """One named `RoundHook`: ``{"name": "fake-quant", "bits": 8}`` or
    ``{"name": "simsiam", "fraction": 0.5}``."""
    name: str
    params: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, **self.params}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HookSpec":
        if not isinstance(d, dict) or "name" not in d:
            raise ValueError(f"a hook spec must be a dict with a 'name' "
                             f"key (got {d!r})")
        d = dict(d)
        return cls(name=d.pop("name"), params=d)


_HOOK_PARAMS = {"fake-quant": ("bits",), "simsiam": ("fraction",)}


def _check_hook_spec(spec: HookSpec) -> None:
    """Validate name/params without instantiating."""
    if spec.name not in _HOOK_PARAMS:
        raise ValueError(f"unknown hook {spec.name!r}; known hooks: "
                         f"{sorted(_HOOK_PARAMS)}")
    required = _HOOK_PARAMS[spec.name]
    if set(spec.params) != set(required):
        raise ValueError(f"hook {spec.name!r}: expected exactly "
                         f"parameter(s) {list(required)} "
                         f"(got {sorted(spec.params)})")


def build_hook(spec: HookSpec) -> RoundHook:
    _check_hook_spec(spec)
    if spec.name == "fake-quant":
        return FakeQuantHook(int(spec.params["bits"]))
    return SimSiamHook(float(spec.params["fraction"]))


@dataclass(frozen=True)
class SlotConfig:
    """One model slot: architecture + benchmark binding + policy stack +
    per-slot hooks. `benchmark_kw` feeds the benchmark maker when the
    session (not a workload preset) materializes it; `memory_mb` pins the
    slot's footprint under a pool budget (None = measure live)."""
    arch: str = "mobilenetv2"
    benchmark: str = "nc"
    benchmark_kw: Dict[str, Any] = field(default_factory=dict)
    policies: PolicyStackSpec = field(default_factory=PolicyStackSpec)
    hooks: Tuple[HookSpec, ...] = ()
    memory_mb: Optional[float] = None

    def validate(self, context: str) -> "SlotConfig":
        if not self.arch or not isinstance(self.arch, str):
            raise ValueError(f"{context}: arch must be a non-empty string")
        try:
            self.policies.validate()
            for h in self.hooks:
                _check_hook_spec(h)
        except ValueError as e:
            raise ValueError(f"{context}: {e}") from None
        return self

    def build_hooks(self) -> List[RoundHook]:
        return [build_hook(h) for h in self.hooks]

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"arch": self.arch, "benchmark": self.benchmark}
        if self.benchmark_kw:
            out["benchmark_kw"] = dict(self.benchmark_kw)
        out["policies"] = self.policies.to_dict()
        if self.hooks:
            out["hooks"] = [h.to_dict() for h in self.hooks]
        if self.memory_mb is not None:
            out["memory_mb"] = self.memory_mb
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SlotConfig":
        if not isinstance(d, dict):
            raise ValueError(f"a slot config must be a dict (got {d!r})")
        valid = {"arch", "benchmark", "benchmark_kw", "policies", "hooks",
                 "memory_mb"}
        unknown = set(d) - valid
        if unknown:
            raise ValueError(f"slot config: unknown key(s) "
                             f"{sorted(unknown)}; valid: {sorted(valid)}")
        kw = dict(d)
        if "policies" in kw:
            kw["policies"] = PolicyStackSpec.from_dict(kw["policies"])
        if "hooks" in kw:
            kw["hooks"] = tuple(HookSpec.from_dict(h) for h in kw["hooks"])
        return cls(**kw)


@dataclass(frozen=True)
class DeviceConfig:
    """One fleet device (DESIGN.md §13): a name plus its hardware envelope
    relative to the reference `EdgeCostModel` device. `speed_scale`
    multiplies throughput (2.0 = rounds finish in half the time),
    `energy_scale` multiplies both power draws (0.5 = half the joules per
    second), and `memory_budget_mb` caps the device's ModelPool residency
    (0.0 = unbounded, like the single-device default). `env` optionally
    attaches a physical environment (`repro_torch.env.EnvSpec`, DESIGN.md
    §15: battery budget, thermal RC node, DVFS governor); the default
    None — and an inactive spec — is today's unconstrained behavior,
    bit-exact."""
    name: str
    speed_scale: float = 1.0
    energy_scale: float = 1.0
    memory_budget_mb: float = 0.0
    env: Optional[EnvSpec] = None

    def validate(self, context: str = "device") -> "DeviceConfig":
        if not self.name or not isinstance(self.name, str):
            raise ValueError(f"{context}: name must be a non-empty string")
        for fname in ("speed_scale", "energy_scale"):
            if getattr(self, fname) <= 0:
                raise ValueError(f"{context} {self.name!r}: {fname} must "
                                 f"be > 0")
        if self.memory_budget_mb < 0:
            raise ValueError(f"{context} {self.name!r}: memory_budget_mb "
                             f"must be >= 0")
        if self.env is not None:
            if not isinstance(self.env, EnvSpec):
                raise ValueError(f"{context} {self.name!r}: env must be an "
                                 f"EnvSpec or None (got "
                                 f"{type(self.env).__name__})")
            self.env.validate(f"{context} {self.name!r} env")
        return self

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name}
        if self.speed_scale != 1.0:
            out["speed_scale"] = self.speed_scale
        if self.energy_scale != 1.0:
            out["energy_scale"] = self.energy_scale
        if self.memory_budget_mb:
            out["memory_budget_mb"] = self.memory_budget_mb
        if self.env is not None:
            out["env"] = self.env.to_dict()
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeviceConfig":
        if not isinstance(d, dict) or "name" not in d:
            raise ValueError(f"a device config must be a dict with a "
                             f"'name' key (got {d!r})")
        valid = {"name", "speed_scale", "energy_scale", "memory_budget_mb",
                 "env"}
        unknown = set(d) - valid
        if unknown:
            raise ValueError(f"device config: unknown key(s) "
                             f"{sorted(unknown)}; valid: {sorted(valid)}")
        kw = dict(d)
        if "env" in kw:
            kw["env"] = EnvSpec.from_dict(kw["env"])
        return cls(**kw)


def _default_slots() -> Dict[str, SlotConfig]:
    return {"default": SlotConfig()}


@dataclass(frozen=True)
class RuntimeConfig:
    """Full declarative session description (module docstring)."""
    slots: Dict[str, SlotConfig] = field(default_factory=_default_slots)
    workload: Optional[str] = None
    workload_scale: Dict[str, Any] = field(default_factory=dict)
    seed: int = 0
    boundaries: str = "oracle"
    replay_batches: int = 2
    pretrain_epochs: int = 3
    inference_batch: int = 16
    calibrate_cost: bool = True
    inference_window: float = 0.0
    preemptible: bool = False
    preempt_resume_cost_s: float = 0.0
    memory_budget_mb: float = 0.0
    # compiled hot path (DESIGN.md §12): fused scan training, deferred
    # vmapped serving, segment-sliced event loop; in the port, CUDA
    # graphs of the train steps and of serving. Off by default.
    compiled: bool = False
    # route attention forwards and the SimFreeze CKA probe through the
    # CUDA kernels (their wrappers take the plain versions on the CPU)
    use_pallas: bool = False
    # fleet (DESIGN.md §13): the devices streams route across (empty =
    # one implicit default device, the legacy single-device session),
    # the stream->device routing policy, and the cross-device delta-merge
    # period in timeline seconds (0.0 = never aggregate)
    devices: Tuple[DeviceConfig, ...] = ()
    routing: str = "static"
    aggregate_every: float = 0.0
    # observability (DESIGN.md §14): the default spec is inactive — no
    # tracer, no metrics, no sinks; the run is bit-exact with the
    # pre-telemetry runtime. Any of enabled/trace_jsonl/chrome_trace
    # builds a live `repro_torch.obs.Telemetry` for the session.
    telemetry: TelemetrySpec = field(default_factory=TelemetrySpec)

    # ---- validation ------------------------------------------------------
    def validate(self) -> "RuntimeConfig":
        if not self.slots or not isinstance(self.slots, dict):
            raise ValueError("RuntimeConfig.slots must be a non-empty "
                             "dict of slot-name -> SlotConfig")
        for name, sc in self.slots.items():
            if not isinstance(name, str) or not name:
                raise ValueError(f"slot names must be non-empty strings "
                                 f"(got {name!r})")
            if not isinstance(sc, SlotConfig):
                raise ValueError(f"slot {name!r} must be a SlotConfig "
                                 f"(got {type(sc).__name__})")
            sc.validate(f"slot {name!r}")
        if self.boundaries not in BOUNDARY_MODES:
            raise ValueError(f"boundaries must be one of {BOUNDARY_MODES} "
                             f"(got {self.boundaries!r})")
        unknown = set(self.workload_scale) - set(WORKLOAD_SCALE_KEYS)
        if unknown:
            raise ValueError(f"workload_scale: unknown key(s) "
                             f"{sorted(unknown)}; valid: "
                             f"{list(WORKLOAD_SCALE_KEYS)}")
        if self.workload_scale and self.workload is None:
            raise ValueError("workload_scale given without a workload name")
        for fname in ("replay_batches", "pretrain_epochs"):
            if getattr(self, fname) < 0:
                raise ValueError(f"{fname} must be >= 0")
        if self.inference_batch < 1:
            raise ValueError("inference_batch must be >= 1")
        for fname in ("inference_window", "preempt_resume_cost_s",
                      "memory_budget_mb", "aggregate_every"):
            if getattr(self, fname) < 0:
                raise ValueError(f"{fname} must be >= 0")
        names = [dc.name for dc in self.devices]
        if len(set(names)) != len(names):
            raise ValueError(f"device names must be unique (got {names})")
        for dc in self.devices:
            if not isinstance(dc, DeviceConfig):
                raise ValueError(f"devices entries must be DeviceConfig "
                                 f"(got {type(dc).__name__})")
            dc.validate()
        from repro_torch.runtime.fleet import ROUTING_POLICIES

        if self.routing not in ROUTING_POLICIES:
            raise ValueError(f"unknown routing policy {self.routing!r}; "
                             f"known: {sorted(ROUTING_POLICIES)}")
        if not isinstance(self.telemetry, TelemetrySpec):
            raise ValueError(f"telemetry must be a TelemetrySpec (got "
                             f"{type(self.telemetry).__name__})")
        self.telemetry.validate()
        return self

    # ---- serialization ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "slots": {n: s.to_dict() for n, s in self.slots.items()},
            "seed": self.seed, "boundaries": self.boundaries,
            "replay_batches": self.replay_batches,
            "pretrain_epochs": self.pretrain_epochs,
            "inference_batch": self.inference_batch,
            "calibrate_cost": self.calibrate_cost,
            "inference_window": self.inference_window,
            "preemptible": self.preemptible,
            "preempt_resume_cost_s": self.preempt_resume_cost_s,
            "memory_budget_mb": self.memory_budget_mb,
            "compiled": self.compiled,
            "use_pallas": self.use_pallas,
        }
        if self.workload is not None:
            out["workload"] = self.workload
            if self.workload_scale:
                out["workload_scale"] = dict(self.workload_scale)
        if self.devices:
            out["devices"] = [dc.to_dict() for dc in self.devices]
        if self.routing != "static":
            out["routing"] = self.routing
        if self.aggregate_every:
            out["aggregate_every"] = self.aggregate_every
        if self.telemetry != TelemetrySpec():
            out["telemetry"] = self.telemetry.to_dict()
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RuntimeConfig":
        if not isinstance(d, dict):
            raise ValueError(f"a runtime config must be a dict (got {d!r})")
        valid = {"slots", "workload", "workload_scale", "seed", "boundaries",
                 "replay_batches", "pretrain_epochs", "inference_batch",
                 "calibrate_cost", "inference_window", "preemptible",
                 "preempt_resume_cost_s", "memory_budget_mb", "compiled",
                 "use_pallas", "devices", "routing", "aggregate_every",
                 "telemetry"}
        unknown = set(d) - valid
        if unknown:
            raise ValueError(f"runtime config: unknown key(s) "
                             f"{sorted(unknown)}; valid: {sorted(valid)}")
        kw = dict(d)
        if "slots" in kw:
            if not isinstance(kw["slots"], dict):
                raise ValueError("runtime config: 'slots' must be a dict")
            kw["slots"] = {n: SlotConfig.from_dict(s)
                           for n, s in kw["slots"].items()}
        if "devices" in kw:
            kw["devices"] = tuple(DeviceConfig.from_dict(dc)
                                  for dc in kw["devices"])
        if "telemetry" in kw:
            kw["telemetry"] = TelemetrySpec.from_dict(kw["telemetry"])
        return cls(**kw).validate()


# ---------------------------------------------------------------------------
# session materialization


def _build_telemetry(spec: TelemetrySpec):
    """An active spec becomes a live `repro_torch.obs.Telemetry`; the
    default inactive spec builds nothing — the zero-overhead path."""
    if not spec.active:
        return None
    from repro_torch.obs.telemetry import Telemetry

    return Telemetry(spec)


def materialize_stream_benchmarks(spec, seed: int,
                                  batch_size: int = 8) -> Dict[int, Any]:
    """One continual benchmark per stream of a `WorkloadSpec` (scenario 0
    is reserved for pretraining, so each gets num_scenarios + 1)."""
    from repro_torch.data import streams

    benches: Dict[int, Any] = {}
    for i, ss in enumerate(spec.streams):
        maker = streams.REGISTRY[ss.benchmark]
        kw = dict(batches=max(ss.batches_per_scenario, 2),
                  batch_size=batch_size, seed=seed + 13 * i)
        if ss.benchmark != "s-cifar":
            kw["num_scenarios"] = spec.num_scenarios + 1
        benches[i] = maker(**kw)
    return benches


def _build_benchmark(slot_cfg: SlotConfig, seed: int):
    from repro_torch.data import streams

    name = slot_cfg.benchmark
    if name not in streams.REGISTRY:
        raise ValueError(f"unknown benchmark {name!r}; known: "
                         f"{sorted(streams.REGISTRY)}")
    kw = dict(slot_cfg.benchmark_kw)
    kw.setdefault("seed", seed)
    return streams.REGISTRY[name](**kw)


def _build_model(arch: str, *, use_pallas: bool = False,
                 compiled: bool = False, device=None):
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model

    mcfg = get_reduced(arch)
    if use_pallas:
        mcfg = mcfg.replace(use_pallas=True)
    model = build_model(mcfg, device=device)
    if compiled:
        from repro_torch.runtime.train_loop import compiled_model

        model = compiled_model(model)
    return model


def _slot_policies(cfg: RuntimeConfig, sc: SlotConfig) -> PolicyStackSpec:
    """The slot's policy stack, with the SimFreeze drift probe routed
    through the CKA kernel when the session asks for it (an explicit
    `use_kernel` in the spec always wins)."""
    import dataclasses

    if not cfg.use_pallas or sc.policies.freeze.name != "simfreeze" \
            or "use_kernel" in sc.policies.freeze.params:
        return sc.policies
    freeze = dataclasses.replace(
        sc.policies.freeze,
        params={**sc.policies.freeze.params, "use_kernel": True})
    return dataclasses.replace(sc.policies, freeze=freeze)


def _pool_from_config(cfg: RuntimeConfig, spec, benches, device):
    """One `ModelSlot` per workload modality, arch/memory from the
    matching `SlotConfig`; each slot pretrains/validates on the benchmark
    of its first bound stream."""
    from repro_torch.runtime.modelpool import ModelPool, ModelSlot

    slots = []
    for m in spec.modalities:
        sc = cfg.slots[m]
        first = next(i for i, s in enumerate(spec.streams)
                     if s.modality == m)
        slots.append(ModelSlot(
            m, _build_model(sc.arch, use_pallas=cfg.use_pallas,
                            compiled=cfg.compiled, device=device),
            benches[first], memory_mb=sc.memory_mb))
    return ModelPool(slots, memory_budget_mb=cfg.memory_budget_mb)


def resolve_session(cfg: RuntimeConfig, *, device=None, model=None,
                    benchmark=None, controller=None,
                    controller_factory=None, stream_benchmarks=None,
                    model_pool=None, cost_model=None, opt_cfg=None,
                    extra_hooks=None, workload_spec=None) -> Dict[str, Any]:
    """Turn a `RuntimeConfig` (+ optional injected live objects, which
    win over what the config would build) into the keyword set
    `ContinualRuntime._init` wires. Returns a plain dict so the
    constructor paths — `from_config` and the deprecated legacy kwarg
    `__init__` — share one resolution. `device` (CUDA unless the caller
    names another) is where the models, train steps and batches live; an
    injected model must already be there."""
    cfg.validate()
    session_events = None
    spec = workload_spec

    if spec is None and cfg.workload is not None:
        from repro_torch.workloads import presets

        scale = dict(cfg.workload_scale)
        batch_size = scale.pop("batch_size", 8)
        known = presets(seed=cfg.seed, **scale)
        if cfg.workload not in known:
            raise ValueError(f"unknown workload preset {cfg.workload!r}; "
                             f"known presets: {sorted(known)}")
        spec = known[cfg.workload]
    else:
        batch_size = dict(cfg.workload_scale).get("batch_size", 8)
    device = resolve_device(device)
    for m in ([model] if model is not None else []) + \
            ([s.model for s in model_pool.slots.values()]
             if model_pool is not None else []):
        if m.device != device:
            raise ValueError(f"the injected model lives on {m.device}, the "
                             f"session on {device}")

    slot_hooks: Dict[str, List[RoundHook]] = {}
    config_built_pool = False

    if spec is not None:
        from repro_torch.workloads.generators import compile_workload

        missing = [m for m in spec.modalities if m not in cfg.slots]
        if missing:
            raise ValueError(
                f"workload {spec.name!r} needs a SlotConfig per modality; "
                f"missing {missing} (have {sorted(cfg.slots)})")
        if stream_benchmarks is None:
            stream_benchmarks = materialize_stream_benchmarks(
                spec, cfg.seed, batch_size)
        session_events = compile_workload(spec)
        if len(spec.modalities) > 1 and model_pool is None:
            model_pool = _pool_from_config(cfg, spec, stream_benchmarks,
                                           device)
            config_built_pool = True

    hooks: List[RoundHook] = []
    if model_pool is not None:
        # per-slot hooks: each pool slot binds the hooks its SlotConfig
        # names; hooks on a slot the pool does not have are rejected, as
        # is the extra_hooks injection (ambiguous binding).
        if extra_hooks:
            raise ValueError("extra_hooks wrap one model; with model_pool "
                             "bind hooks per slot via SlotConfig.hooks")
        for name, sc in cfg.slots.items():
            if not sc.hooks:
                continue
            if name not in model_pool.slots:
                raise ValueError(
                    f"hooks configured for slot {name!r}, but the pool "
                    f"has {sorted(model_pool.slots)}; RoundHooks bind "
                    f"per slot under a ModelPool")
            slot_hooks[name] = sc.build_hooks()
        # synthesize per-slot controllers from the slot policies ONLY for
        # a pool this resolution built from the config — an injected pool
        # keeps the explicit "slot has no controller" contract
        if controller_factory is None and config_built_pool:
            pool = model_pool
            stacks = {n: _slot_policies(cfg, sc)
                      for n, sc in cfg.slots.items()}

            def controller_factory(key, _pool=pool, _stacks=stacks):
                return _stacks[key].build(_pool.slot(key).model)
    else:
        single = cfg.slots[next(iter(cfg.slots))] if len(cfg.slots) == 1 \
            else None
        if single is None:
            raise ValueError(
                "multiple slots need a multi-modality workload or an "
                "injected model_pool (got "
                f"{sorted(cfg.slots)} and neither)")
        if model is None:
            model = _build_model(single.arch, use_pallas=cfg.use_pallas,
                                 compiled=cfg.compiled, device=device)
        elif cfg.compiled:
            # injected model: still graph its serving/probe forwards (the
            # controller below is built on the wrapped model, so
            # SimFreeze's feature probes replay from graphs too)
            from repro_torch.runtime.train_loop import compiled_model

            model = compiled_model(model)
        if benchmark is None:
            if stream_benchmarks is not None and 0 in stream_benchmarks:
                benchmark = stream_benchmarks[0]
            else:
                benchmark = _build_benchmark(single, cfg.seed)
        if controller is None:
            controller = _slot_policies(cfg, single).build(model)
        if controller_factory is None and spec is not None:
            mdl = model
            policies = _slot_policies(cfg, single)

            def controller_factory(key, _m=mdl, _p=policies):
                return _p.build(_m)
        hooks = single.build_hooks()
        hooks.extend(extra_hooks or [])

    from repro_torch.runtime.costmodel import EdgeCostModel

    return dict(
        model=model, benchmark=benchmark, controller=controller,
        cost_model=cost_model if cost_model is not None else EdgeCostModel(),
        opt_cfg=opt_cfg, seed=cfg.seed, boundaries=cfg.boundaries,
        replay_batches=cfg.replay_batches,
        pretrain_epochs=cfg.pretrain_epochs,
        inference_batch=cfg.inference_batch,
        calibrate_cost=cfg.calibrate_cost,
        inference_window=cfg.inference_window,
        hooks=hooks, slot_hooks=slot_hooks,
        stream_benchmarks=stream_benchmarks,
        controller_factory=controller_factory,
        preemptible=cfg.preemptible,
        preempt_resume_cost_s=cfg.preempt_resume_cost_s,
        model_pool=model_pool, compiled=cfg.compiled,
        session_events=session_events, devices=cfg.devices,
        routing=cfg.routing,
        aggregate_every=cfg.aggregate_every, device=device,
        telemetry=_build_telemetry(cfg.telemetry))
