"""Drift policies — *when the scenario changed*, inferred from serving.

`observe` feeds each served request's logits (honored by the runtime in
boundaries='detector' mode); `confirm` is the side-effect-free check a
dedicated probe pass runs before the change is latched (DESIGN.md §10).

A copy of `repro.core.policies.drift`.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.ood import EnergyOODConfig, EnergyOODDetector


class NoDriftPolicy:
    """Scenario changes come only from oracle boundaries. `confirm`
    returns True so an externally-fired probe (e.g. a spy controller in
    tests) still latches — matching the pre-stack monolith with
    `detect_scenario_changes=False`."""

    def observe(self, logits) -> bool:
        return False

    def confirm(self, logits) -> bool:
        return True

    def stats(self) -> dict:
        return {"ood_detections": 0}


class EnergyDriftPolicy:
    """Energy-score OOD detection (paper §IV-A3): flag a change when a
    window of served requests' energies drifts above the z-threshold;
    confirm probes z-test against the baseline snapshotted at the
    triggering detection (`EnergyOODDetector.confirm`)."""

    def __init__(self, config: Optional[EnergyOODConfig] = None):
        self.detector = EnergyOODDetector(config if config is not None
                                          else EnergyOODConfig())

    def observe(self, logits) -> bool:
        return self.detector.observe(logits)

    def confirm(self, logits) -> bool:
        return self.detector.confirm(logits)

    def stats(self) -> dict:
        return {"ood_detections": self.detector.detections}
