"""Declarative policy specs — named, parameterized, JSON-round-trippable
descriptions of a `PolicyStack`, the per-slot policy entries of
`repro_torch.runtime.config.RuntimeConfig` (DESIGN.md §11). A copy of
`repro.core.policies.spec`: the same names, parameters and dict form, so
a spec written by either package loads in the other.

A `PolicySpec` is `{"name": <registered name>, **params}`; params are the
flattened fields of the underlying config dataclass (e.g. the trigger
spec `{"name": "lazytune", "max_batches_needed": 6}` builds
`LazyTuneTrigger(LazyTuneConfig(max_batches_needed=6))`). Unknown names
and unknown params raise with the valid alternatives spelled out.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from repro_torch.core.lazytune import LazyTuneConfig
from repro_torch.core.ood import EnergyOODConfig
from repro_torch.core.policies.drift import EnergyDriftPolicy, NoDriftPolicy
from repro_torch.core.policies.freeze import NoFreezePolicy, SimFreezePolicy
from repro_torch.core.policies.publish import ImmediatePublish, RoundEndPublish
from repro_torch.core.policies.stack import PolicyStack
from repro_torch.core.policies.throttle import (BudgetThrottle, NullThrottle,
                                          ThermalThrottle)
from repro_torch.core.policies.trigger import (ImmediateTrigger, LazyTuneTrigger,
                                         PriorityWeightedTrigger,
                                         StalenessGuard)
from repro_torch.core.simfreeze import SimFreezeConfig


@dataclass(frozen=True)
class PolicySpec:
    """One named policy + its parameters. Serializes flat:
    ``{"name": "lazytune", "max_batches_needed": 6}``."""
    name: str
    params: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        if "name" in self.params:
            raise ValueError("PolicySpec params cannot shadow 'name'")
        return {"name": self.name, **self.params}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PolicySpec":
        if not isinstance(d, dict) or "name" not in d:
            raise ValueError(f"a policy spec must be a dict with a 'name' "
                             f"key (got {d!r})")
        d = dict(d)
        return cls(name=d.pop("name"), params=d)


# ---------------------------------------------------------------------------
# builders: spec name -> policy instance


def _cfg_build(cfg_cls, params: Dict[str, Any], *, context: str):
    known = {f.name for f in dataclasses.fields(cfg_cls)}
    unknown = set(params) - known
    if unknown:
        raise ValueError(f"{context}: unknown parameter(s) "
                         f"{sorted(unknown)}; valid: {sorted(known)}")
    return cfg_cls(**params)


def _build_lazytune_cfg(params: Dict[str, Any], *, context: str,
                        extra=()) -> tuple:
    """Split `params` into (LazyTuneConfig, leftover-dict of `extra`)."""
    params = dict(params)
    leftovers = {k: params.pop(k) for k in extra if k in params}
    return _cfg_build(LazyTuneConfig, params, context=context), leftovers


def _trigger_immediate(params, context):
    if set(params) - {"batches_needed", "max_staleness"}:
        raise ValueError(f"{context}: valid parameters: "
                         f"['batches_needed', 'max_staleness']")
    ms = params.pop("max_staleness", None)
    trig = ImmediateTrigger(**params)
    return trig if ms is None else StalenessGuard(trig, ms)


def _trigger_lazytune(params, context):
    cfg, kw = _build_lazytune_cfg(params, context=context,
                                  extra=("max_staleness",))
    trig = LazyTuneTrigger(cfg)
    ms = kw.get("max_staleness")
    return trig if ms is None else StalenessGuard(trig, ms)


def _trigger_priority_weighted(params, context):
    cfg, kw = _build_lazytune_cfg(
        params, context=context, extra=("max_staleness", "priority_weight"))
    trig = PriorityWeightedTrigger(
        cfg, priority_weight=kw.get("priority_weight", 0.5))
    ms = kw.get("max_staleness")
    return trig if ms is None else StalenessGuard(trig, ms)


TRIGGER_POLICIES = {
    "immediate": _trigger_immediate,
    "lazytune": _trigger_lazytune,
    "priority-weighted": _trigger_priority_weighted,
}

FREEZE_POLICIES = {
    "none": lambda model, params, context: NoFreezePolicy(model)
    if not params else _raise_params(context, []),
    "simfreeze": lambda model, params, context: SimFreezePolicy(
        model, _cfg_build(SimFreezeConfig, params, context=context)),
}

DRIFT_POLICIES = {
    "none": lambda params, context: NoDriftPolicy()
    if not params else _raise_params(context, []),
    "energy": lambda params, context: EnergyDriftPolicy(
        _cfg_build(EnergyOODConfig, params, context=context)),
}

PUBLISH_POLICIES = {
    "immediate": lambda params, context: ImmediatePublish()
    if not params else _raise_params(context, []),
    "round-end": lambda params, context: RoundEndPublish()
    if not params else _raise_params(context, []),
}


def _throttle_build(cls_, params, context, valid):
    unknown = set(params) - valid
    if unknown:
        raise ValueError(f"{context}: unknown parameter(s) "
                         f"{sorted(unknown)}; valid: {sorted(valid)}")
    return cls_(**params)


THROTTLE_POLICIES = {
    "none": lambda params, context: NullThrottle()
    if not params else _raise_params(context, []),
    "battery": lambda params, context: _throttle_build(
        BudgetThrottle, params, context, {"min_soc"}),
    "thermal": lambda params, context: _throttle_build(
        ThermalThrottle, params, context, {"max_temp_c"}),
}


def _raise_params(context, valid):
    raise ValueError(f"{context}: takes no parameters" if not valid
                     else f"{context}: valid parameters: {valid}")


def _lookup(registry, kind: str, spec: PolicySpec):
    if spec.name not in registry:
        raise ValueError(
            f"unknown {kind} policy {spec.name!r}; known {kind} policies: "
            f"{sorted(registry)}")
    return registry[spec.name]


def build_trigger(spec: PolicySpec):
    return _lookup(TRIGGER_POLICIES, "trigger", spec)(
        dict(spec.params), f"trigger policy {spec.name!r}")


def build_freeze(spec: PolicySpec, model):
    return _lookup(FREEZE_POLICIES, "freeze", spec)(
        model, dict(spec.params), f"freeze policy {spec.name!r}")


def build_drift(spec: PolicySpec):
    return _lookup(DRIFT_POLICIES, "drift", spec)(
        dict(spec.params), f"drift policy {spec.name!r}")


def build_publish(spec: PolicySpec):
    return _lookup(PUBLISH_POLICIES, "publish", spec)(
        dict(spec.params), f"publish policy {spec.name!r}")


def build_throttle(spec: PolicySpec):
    return _lookup(THROTTLE_POLICIES, "throttle", spec)(
        dict(spec.params), f"throttle policy {spec.name!r}")


# ---------------------------------------------------------------------------
# a full stack spec


@dataclass(frozen=True)
class PolicyStackSpec:
    """Declarative description of one `PolicyStack` (one runtime slot's
    policy entry). Defaults mirror `ETunerConfig` defaults: LazyTune +
    SimFreeze + energy-score detection + bug-compat publish."""
    trigger: PolicySpec = field(default_factory=lambda: PolicySpec("lazytune"))
    freeze: PolicySpec = field(default_factory=lambda: PolicySpec("simfreeze"))
    drift: PolicySpec = field(default_factory=lambda: PolicySpec("energy"))
    publish: PolicySpec = field(
        default_factory=lambda: PolicySpec("immediate"))
    # the fifth facet (DESIGN.md §15): env-aware round gating. "none"
    # (the default) is inert and serialized away, so every pre-env
    # stack spec round-trips byte-identically.
    throttle: PolicySpec = field(default_factory=lambda: PolicySpec("none"))

    def validate(self) -> "PolicyStackSpec":
        """Check every name/param against the registries (builds throw-
        away instances for the model-free kinds; freeze params are
        checked against the config fields without a model)."""
        build_trigger(self.trigger)
        _lookup(FREEZE_POLICIES, "freeze", self.freeze)
        if self.freeze.name == "simfreeze":
            _cfg_build(SimFreezeConfig, dict(self.freeze.params),
                       context=f"freeze policy {self.freeze.name!r}")
        elif self.freeze.params:
            raise ValueError(f"freeze policy {self.freeze.name!r}: takes "
                             f"no parameters")
        build_drift(self.drift)
        build_publish(self.publish)
        build_throttle(self.throttle)
        return self

    def build(self, model) -> PolicyStack:
        """Materialize the stack for `model`."""
        return PolicyStack(model,
                           trigger=build_trigger(self.trigger),
                           freeze=build_freeze(self.freeze, model),
                           drift=build_drift(self.drift),
                           publish=build_publish(self.publish),
                           throttle=build_throttle(self.throttle))

    def to_dict(self) -> Dict[str, Any]:
        out = {"trigger": self.trigger.to_dict(),
               "freeze": self.freeze.to_dict(),
               "drift": self.drift.to_dict(),
               "publish": self.publish.to_dict()}
        if self.throttle != PolicySpec("none"):
            out["throttle"] = self.throttle.to_dict()
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PolicyStackSpec":
        if not isinstance(d, dict):
            raise ValueError(f"a policy-stack spec must be a dict "
                             f"(got {d!r})")
        unknown = set(d) - {"trigger", "freeze", "drift", "publish",
                            "throttle"}
        if unknown:
            raise ValueError(
                f"policy-stack spec: unknown key(s) {sorted(unknown)}; "
                f"valid: ['trigger', 'freeze', 'drift', 'publish', "
                f"'throttle']")
        kw = {k: PolicySpec.from_dict(v) for k, v in d.items()}
        return cls(**kw)


def etuner_stack_spec(*, lazytune: bool = True, simfreeze: bool = True,
                      detect_scenario_changes: bool = True,
                      lazytune_params: Optional[Dict[str, Any]] = None,
                      simfreeze_params: Optional[Dict[str, Any]] = None,
                      max_staleness: Optional[float] = None,
                      publish: str = "immediate") -> PolicyStackSpec:
    """The four paper ablations as stack specs (Immed. / LazyTune /
    SimFreeze / ETuner), mirroring the `ETunerConfig` switches."""
    tparams = dict(lazytune_params or {})
    if not lazytune:
        # mirror ETunerConfig(lazytune=False): only the initial target
        # survives (it is what a disabled LazyTune's stats report);
        # anything else supplied for a disabled facet is a
        # misconfiguration, not something to drop silently
        extra = set(tparams) - {"initial_batches_needed"}
        if extra:
            raise ValueError(
                f"lazytune=False: lazytune_params {sorted(extra)} have no "
                f"effect (only 'initial_batches_needed' maps to the "
                f"immediate trigger's reported batches_needed)")
        tparams = {"batches_needed": tparams["initial_batches_needed"]} \
            if tparams else {}
    if max_staleness is not None:
        tparams["max_staleness"] = max_staleness
    return PolicyStackSpec(
        trigger=PolicySpec("lazytune" if lazytune else "immediate", tparams),
        freeze=PolicySpec("simfreeze", dict(simfreeze_params or {}))
        if simfreeze else PolicySpec("none"),
        drift=PolicySpec("energy") if detect_scenario_changes
        else PolicySpec("none"),
        publish=PolicySpec(publish))
