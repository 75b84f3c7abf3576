"""Composable scheduling policies (counterpart of `repro.core.policies`).

EdgeOL's Algorithm 1 makes four orthogonal decisions — when to fine-tune
(`TriggerPolicy`), what to train (`FreezePolicy`), when the scenario
changed (`DriftPolicy`) and when to publish trained params
(`PublishPolicy`). This package gives each its own protocol and
implementations, a `PolicyStack` that composes one of each back into a
full controller, and the legacy adapter. The throttle facet and the
declarative `PolicySpec`s come with the port of the runtime's config.
"""
from repro_torch.core.policies.base import (DriftPolicy, FreezePolicy,
                                            PublishPolicy, TriggerPolicy)
from repro_torch.core.policies.drift import EnergyDriftPolicy, NoDriftPolicy
from repro_torch.core.policies.freeze import (NoFreezePolicy,
                                              SimFreezePolicy, empty_plan)
from repro_torch.core.policies.publish import (ImmediatePublish,
                                               RoundEndPublish)
from repro_torch.core.policies.stack import (LegacyControllerAdapter,
                                             PolicyStack, adapt_controller)
from repro_torch.core.policies.trigger import (ImmediateTrigger,
                                               LazyTuneTrigger,
                                               PriorityWeightedTrigger,
                                               StalenessGuard)

__all__ = [
    "TriggerPolicy", "FreezePolicy", "DriftPolicy", "PublishPolicy",
    "ImmediateTrigger", "LazyTuneTrigger", "StalenessGuard",
    "PriorityWeightedTrigger",
    "NoFreezePolicy", "SimFreezePolicy", "empty_plan",
    "NoDriftPolicy", "EnergyDriftPolicy",
    "ImmediatePublish", "RoundEndPublish",
    "PolicyStack", "LegacyControllerAdapter", "adapt_controller",
]
