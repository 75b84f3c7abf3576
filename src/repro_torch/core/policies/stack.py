"""PolicyStack — one trigger + freeze + drift + publish + throttle policy
composed back into a full controller, plus the legacy adapter that lets
monolithic controllers keep working. A copy of
`repro.core.policies.stack`.
"""
from __future__ import annotations

import inspect
from typing import Optional

from repro_torch.core.policies.drift import NoDriftPolicy
from repro_torch.core.policies.freeze import NoFreezePolicy
from repro_torch.core.policies.publish import ImmediatePublish
from repro_torch.core.policies.throttle import NullThrottle
from repro_torch.core.policies.trigger import ImmediateTrigger


class PolicyStack:
    """The runtime-facing controller as a composition of five policies.
    Each facet is independently swappable:

        PolicyStack(trigger=LazyTuneTrigger(), freeze=SimFreezePolicy(m),
                    drift=NoDriftPolicy(), publish=RoundEndPublish())

    Omitted facets default to the inert implementations (immediate
    trigger, no freezing, no detection, bug-compat publish, no
    throttling); `model` is only needed when `freeze` is omitted (the
    default plan's shape).
    """

    def __init__(self, model=None, *, trigger=None, freeze=None, drift=None,
                 publish=None, throttle=None):
        if freeze is None and model is None:
            raise ValueError("PolicyStack needs either a freeze policy or "
                             "a model to derive the default plan from")
        self.trigger = trigger if trigger is not None else ImmediateTrigger()
        self.freeze = freeze if freeze is not None else NoFreezePolicy(model)
        self.drift = drift if drift is not None else NoDriftPolicy()
        self.publish_policy = publish if publish is not None \
            else ImmediatePublish()
        # fifth facet (DESIGN.md §15): env-aware round gating, consulted
        # by the runtime only on devices carrying a live env — the
        # default NullThrottle keeps every other path untouched
        self.throttle = throttle if throttle is not None else NullThrottle()

    # ---- plan (owned by the freeze policy) -------------------------------
    @property
    def plan(self):
        return self.freeze.plan

    @property
    def plan_changes(self) -> int:
        return self.freeze.plan_changes

    # ---- events ----------------------------------------------------------
    def start_scenario(self, reference_params, probe_batch) -> None:
        self.freeze.start_scenario(reference_params, probe_batch)

    def should_trigger(self, batches_available: int, staleness: float = 0.0,
                       priority: int = 0) -> bool:
        return self.trigger.should_trigger(batches_available,
                                           staleness=staleness,
                                           priority=priority)

    def round_finished(self, iters: int, val_acc: float, params) -> None:
        self.trigger.round_finished(iters, val_acc)
        self.freeze.round_finished(iters, params)

    def inference_served(self, logits) -> bool:
        """Returns True when a scenario change was detected."""
        self.trigger.inference_arrived()
        return self.drift.observe(logits)

    def probe_served(self, logits) -> bool:
        """Dedicated drift-confirmation pass (DESIGN.md §10)."""
        return self.drift.confirm(logits)

    def scenario_changed(self, params, new_probe_batch) -> None:
        """External or detected scenario boundary (Alg. 1 l.19-26)."""
        self.trigger.scenario_changed()
        self.freeze.scenario_changed(params, new_probe_batch)

    # ---- reporting -------------------------------------------------------
    def stats(self) -> dict:
        out = dict(self.trigger.stats())
        out.update(self.freeze.stats())
        out.update(self.drift.stats())
        out.update(self.throttle.stats())
        return out

    # ---- compat surfaces (state machines owned by the facets) ------------
    @property
    def lazytune(self):
        """The trigger's LazyTune state machine (LazyTune-based triggers
        only — AttributeError otherwise, like any absent attribute)."""
        return self.trigger.lazytune

    @property
    def simfreeze(self):
        """The freeze policy's SimFreeze state machine (the runtime
        charges its CKA probe FLOPs when present)."""
        return self.freeze.simfreeze

    @property
    def detector(self):
        """The drift policy's energy-score detector, when it has one."""
        return self.drift.detector


def _accepts(callable_, name: str) -> Optional[bool]:
    """Does `callable_` accept keyword `name`? None = unknown (builtins,
    C callables — treat as legacy)."""
    try:
        params = inspect.signature(callable_).parameters
    except (TypeError, ValueError):
        return None
    return name in params or any(p.kind is p.VAR_KEYWORD
                                 for p in params.values())


class LegacyControllerAdapter:
    """Presents a monolithic controller written against an older
    `should_trigger` contract (without the `staleness` and `priority`
    keywords) through the current surface: it drops the keywords the
    wrapped controller does not understand and forwards everything else
    untouched (same objects, same state)."""

    def __init__(self, controller):
        self._controller = controller
        self._staleness = bool(_accepts(controller.should_trigger,
                                        "staleness"))

    def should_trigger(self, batches_available: int, staleness: float = 0.0,
                       priority: int = 0) -> bool:
        if self._staleness:
            return self._controller.should_trigger(batches_available,
                                                   staleness=staleness)
        return self._controller.should_trigger(batches_available)

    def __getattr__(self, name):
        return getattr(self._controller, name)


def adapt_controller(controller):
    """Return `controller` itself when it already speaks the full
    protocol (`should_trigger` accepts `priority`), else wrap it in a
    `LegacyControllerAdapter`."""
    if _accepts(controller.should_trigger, "priority"):
        return controller
    return LegacyControllerAdapter(controller)
