"""Composable scheduling policies (counterpart of `repro.core.policies`).

EdgeOL's Algorithm 1 makes four orthogonal decisions — when to fine-tune
(`TriggerPolicy`), what to train (`FreezePolicy`), when the scenario
changed (`DriftPolicy`) and when to publish trained params
(`PublishPolicy`); a fifth facet (`ThrottlePolicy`) gates rounds on the
device's environment. This package gives each its own protocol and
implementations, a `PolicyStack` that composes one of each back into a
full controller, declarative `PolicySpec`/`PolicyStackSpec` descriptions
(the per-slot policy entries of `repro_torch.runtime.config.RuntimeConfig`)
and the legacy adapter.
"""
from repro_torch.core.policies.base import (DriftPolicy, FreezePolicy,
                                            PublishPolicy, ThrottlePolicy,
                                            TriggerPolicy)
from repro_torch.core.policies.drift import EnergyDriftPolicy, NoDriftPolicy
from repro_torch.core.policies.freeze import (NoFreezePolicy,
                                              SimFreezePolicy, empty_plan)
from repro_torch.core.policies.publish import (ImmediatePublish,
                                               RoundEndPublish)
from repro_torch.core.policies.spec import (DRIFT_POLICIES, FREEZE_POLICIES,
                                            PUBLISH_POLICIES,
                                            THROTTLE_POLICIES,
                                            TRIGGER_POLICIES, PolicySpec,
                                            PolicyStackSpec, build_drift,
                                            build_freeze, build_publish,
                                            build_throttle, build_trigger,
                                            etuner_stack_spec)
from repro_torch.core.policies.stack import (LegacyControllerAdapter,
                                             PolicyStack, adapt_controller)
from repro_torch.core.policies.throttle import (BudgetThrottle, NullThrottle,
                                                ThermalThrottle)
from repro_torch.core.policies.trigger import (ImmediateTrigger,
                                               LazyTuneTrigger,
                                               PriorityWeightedTrigger,
                                               StalenessGuard)

__all__ = [
    "TriggerPolicy", "FreezePolicy", "DriftPolicy", "PublishPolicy",
    "ThrottlePolicy",
    "ImmediateTrigger", "LazyTuneTrigger", "StalenessGuard",
    "PriorityWeightedTrigger",
    "NoFreezePolicy", "SimFreezePolicy", "empty_plan",
    "NoDriftPolicy", "EnergyDriftPolicy",
    "ImmediatePublish", "RoundEndPublish",
    "NullThrottle", "BudgetThrottle", "ThermalThrottle",
    "PolicyStack", "LegacyControllerAdapter", "adapt_controller",
    "PolicySpec", "PolicyStackSpec", "etuner_stack_spec",
    "build_trigger", "build_freeze", "build_drift", "build_publish",
    "build_throttle",
    "TRIGGER_POLICIES", "FREEZE_POLICIES", "DRIFT_POLICIES",
    "PUBLISH_POLICIES", "THROTTLE_POLICIES",
]
