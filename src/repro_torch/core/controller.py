"""ETunerController — the paper's combined policy (Algorithm 1), a thin
`PolicyStack` composition (core.policies, DESIGN.md §11): LazyTune
(inter-tuning) is a `TriggerPolicy`, SimFreeze (intra-tuning) a
`FreezePolicy`, and the energy-score scenario detector a `DriftPolicy`.
A copy of `repro.core.controller`.

Ablation switches make the controller cover all four paper configurations:
  Immed.    = ETunerController(lazytune=False, simfreeze=False)
  LazyTune  = ETunerController(lazytune=True,  simfreeze=False)
  SimFreeze = ETunerController(lazytune=False, simfreeze=True)
  ETuner    = ETunerController(lazytune=True,  simfreeze=True)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Protocol, runtime_checkable

from repro_torch.core.lazytune import LazyTuneConfig
from repro_torch.core.ood import EnergyOODConfig
from repro_torch.core.policies.drift import EnergyDriftPolicy, NoDriftPolicy
from repro_torch.core.policies.freeze import NoFreezePolicy, SimFreezePolicy
from repro_torch.core.policies.stack import PolicyStack
from repro_torch.core.policies.trigger import (ImmediateTrigger, LazyTuneTrigger,
                                         StalenessGuard)
from repro_torch.core.simfreeze import SimFreezeConfig


@runtime_checkable
class ControllerProtocol(Protocol):
    """The contract every scheduling policy implements (DESIGN.md §2).

    Controllers are *driven* by the runtime's event loop — they never see
    the `EventScheduler` or executor internals. The runtime calls, in
    event order:

    - `plan` (property): the current freeze plan — a hashable key of the
      train-step cache; a changed plan implies a recompile charge.
    - `should_trigger(batches_available, staleness=0.0, priority=0)`:
      called on every buffered data batch; return True to launch a
      fine-tuning round now (the runtime additionally requires the
      device to be idle). `staleness` is the wall-clock seconds since
      *this stream's* last round completed (run start counts as fresh);
      `priority` is the stream's QoS priority (`StreamSpec.priority`) —
      a priority-aware policy (e.g. `PriorityWeightedTrigger`) can weigh
      both against LazyTune's accumulation target. Controllers written
      against the older two- or one-argument contracts keep working: the
      runtime adapts them via `core.policies.adapt_controller`.
    - `round_finished(iters, val_acc, params)`: after each round, with the
      number of iterations run, validation accuracy, and the new params.
    - `inference_served(logits)`: after each served request, with that
      request's logits; return True to signal a detected scenario change
      (only honored when the runtime runs with boundaries='detector').
    - `scenario_changed(params, probe_batch)`: at an oracle scenario
      boundary or a detector-confirmed change.
    - `start_scenario(reference_params, probe_batch)` (optional): offered
      once per scenario to controllers that track reference-model
      similarity; gate with a `needs_reference` attribute.
    - `stats()` (optional): a dict folded into `RunResult.controller_stats`.
    - `publish_policy` (optional): a `core.policies.PublishPolicy`
      deciding when a round's params reach serving (default: the
      bug-compat immediate publish, DESIGN.md §5).
    """

    @property
    def plan(self) -> Any: ...

    def should_trigger(self, batches_available: int,
                       staleness: float = 0.0,
                       priority: int = 0) -> bool: ...

    def round_finished(self, iters: int, val_acc: float, params) -> None: ...

    def inference_served(self, logits) -> bool: ...

    def scenario_changed(self, params, probe_batch) -> None: ...


@dataclass
class ETunerConfig:
    lazytune: bool = True
    simfreeze: bool = True
    detect_scenario_changes: bool = True
    lazytune_cfg: LazyTuneConfig = field(default_factory=LazyTuneConfig)
    simfreeze_cfg: SimFreezeConfig = field(default_factory=SimFreezeConfig)
    ood_cfg: EnergyOODConfig = field(default_factory=EnergyOODConfig)
    # QoS starvation guard: trigger a round regardless of LazyTune's
    # accumulation target once this stream has gone `max_staleness`
    # timeline-seconds without one (None = disabled, the paper behaviour)
    max_staleness: Optional[float] = None


class ETunerController(PolicyStack):
    def __init__(self, model, config: Optional[ETunerConfig] = None):
        # default must be constructed per instance: a shared module-level
        # default ETunerConfig() is mutable (e.g. cfg.max_staleness), so
        # one controller's tweak would leak into every other
        # default-constructed controller (regression-tested)
        config = ETunerConfig() if config is None else config
        self.cfg = config
        self.model = model
        if config.lazytune:
            trigger = LazyTuneTrigger(config.lazytune_cfg)
        else:
            trigger = ImmediateTrigger(
                config.lazytune_cfg.initial_batches_needed)
        if config.max_staleness is not None:
            trigger = StalenessGuard(trigger, config.max_staleness)
        freeze = SimFreezePolicy(model, config.simfreeze_cfg) \
            if config.simfreeze else NoFreezePolicy(model)
        drift = EnergyDriftPolicy(config.ood_cfg) \
            if config.detect_scenario_changes else NoDriftPolicy()
        super().__init__(model, trigger=trigger, freeze=freeze, drift=drift)
