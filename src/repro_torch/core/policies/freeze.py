"""Freeze policies — *what* to train each round (the freeze plan).

The plan is a hashable key of the train-step cache: a change implies a
recompile charge, so the policy caches it and counts `plan_changes`
exactly like the reference. A copy of `repro.core.policies.freeze`.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.freeze_plan import LayerFreezePlan, all_active
from repro_torch.core.simfreeze import SimFreeze, SimFreezeConfig


def empty_plan(model):
    """The everything-trains plan for `model` (scanned LMs use group
    plans, the unrolled paper models per-layer plans)."""
    if getattr(model.cfg, "is_lm", False) and model.cfg.scan_layers:
        return all_active(model.num_freeze_units)
    return LayerFreezePlan(layers=(False,) * model.num_freeze_units)


class NoFreezePolicy:
    """Every layer trains every round (the paper's non-SimFreeze arms)."""

    def __init__(self, model):
        self._plan = empty_plan(model)
        self.plan_changes = 0

    @property
    def plan(self):
        return self._plan

    def start_scenario(self, reference_params, probe_batch) -> None:
        pass

    def round_finished(self, iters: int, params) -> None:
        pass

    def scenario_changed(self, params, probe_batch) -> None:
        pass

    def stats(self) -> dict:
        return {"frozen_fraction": 0.0, "freezes": 0, "unfreezes": 0,
                "plan_changes": self.plan_changes}


class SimFreezePolicy:
    """The paper's SimFreeze intra-tuning policy (Alg. 1 l.4-9, 22-26):
    CKA-guided freeze/unfreeze against the per-scenario reference model.
    Wraps the existing `repro.core.simfreeze` state machine with the plan
    cache + change counter the runtime charges recompiles from."""

    def __init__(self, model, config: Optional[SimFreezeConfig] = None):
        scan_mode = getattr(model.cfg, "is_lm", False) and \
            model.cfg.scan_layers
        self.simfreeze = SimFreeze(
            model.num_freeze_units, model.features,
            config if config is not None else SimFreezeConfig(),
            scan_mode=scan_mode)
        self._plan = empty_plan(model)
        self.plan_changes = 0

    @property
    def plan(self):
        return self._plan

    def _refresh_plan(self) -> None:
        new = self.simfreeze.plan()
        if new != self._plan:
            self.plan_changes += 1
        self._plan = new

    def start_scenario(self, reference_params, probe_batch) -> None:
        self.simfreeze.start_scenario(reference_params, probe_batch)

    def round_finished(self, iters: int, params) -> None:
        if self.simfreeze.probe_batch is not None and \
                self.simfreeze.maybe_freeze(params, iters):
            self._refresh_plan()

    def scenario_changed(self, params, probe_batch) -> None:
        if self.simfreeze.reference_params is not None and \
                self.simfreeze.scenario_changed(params, probe_batch):
            self._refresh_plan()

    def stats(self) -> dict:
        return {"frozen_fraction": self.simfreeze.frozen_fraction(),
                "freezes": self.simfreeze.state.freezes,
                "unfreezes": self.simfreeze.state.unfreezes,
                "plan_changes": self.plan_changes}
