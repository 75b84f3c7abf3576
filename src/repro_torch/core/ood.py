"""Energy-score scenario-change detection (paper §IV-A3, following
Liu et al., NeurIPS'20 "Energy-based Out-of-distribution Detection").

E(x) = -logsumexp(logits(x)): in-distribution inputs score low, OOD inputs
score high. We keep a running mean/std of energies of served inference
requests and flag a scenario change when a window of recent requests drifts
above a z-score threshold. The scenario boundary therefore "comes with and
is determined by the inference data" exactly as in the paper. A copy of
`repro.core.ood`."""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np


@dataclass
class EnergyOODConfig:
    window: int = 8            # recent requests considered
    warmup: int = 16           # energies before detection activates
    z_threshold: float = 3.0   # window-mean z-score that flags a change
    cooldown: int = 16         # requests to ignore after a detection


class EnergyOODDetector:
    def __init__(self, config: EnergyOODConfig = EnergyOODConfig()):
        self.cfg = config
        self._recent = deque(maxlen=config.window)
        self._count = 0
        self._mean = 0.0
        self._m2 = 0.0
        self._cooldown = 0
        self.detections = 0
        # (mean, std) snapshotted at the last detection, *before* the
        # stats reset — the baseline a dedicated confirmation probe is
        # z-tested against (detector-driven probes, DESIGN.md)
        self._baseline = None

    @staticmethod
    def energy(logits: np.ndarray) -> float:
        """Mean energy score of a batch of logits [B, C]."""
        logits = np.asarray(logits, np.float64)
        m = logits.max(axis=-1, keepdims=True)
        lse = m[..., 0] + np.log(np.exp(logits - m).sum(axis=-1))
        return float(np.mean(-lse))

    def observe(self, logits: np.ndarray) -> bool:
        """Feed logits of one served request; True => scenario change."""
        e = self.energy(logits)
        self._recent.append(e)
        if self._cooldown > 0:
            self._cooldown -= 1
            self._update_stats(e)
            return False
        if self._count < self.cfg.warmup or len(self._recent) < self.cfg.window:
            self._update_stats(e)
            return False
        std = max(np.sqrt(self._m2 / max(self._count - 1, 1)), 1e-6)
        z = (np.mean(self._recent) - self._mean) / std
        if z > self.cfg.z_threshold:
            self.detections += 1
            self._baseline = (self._mean, std)
            self._reset_stats()
            self._cooldown = self.cfg.cooldown
            return True
        self._update_stats(e)
        return False

    def confirm(self, logits: np.ndarray) -> bool:
        """Side-effect-free drift check for a *dedicated* confirmation
        probe (detector-driven probes): z-test the probe pass's energy
        against the baseline snapshotted at the triggering detection.
        Never perturbs the running request statistics; True before any
        detection happened (nothing to refute the trigger with)."""
        if self._baseline is None:
            return True
        mean, std = self._baseline
        return (self.energy(logits) - mean) / std > self.cfg.z_threshold

    def _update_stats(self, e: float) -> None:
        self._count += 1
        delta = e - self._mean
        self._mean += delta / self._count
        self._m2 += delta * (e - self._mean)

    def _reset_stats(self) -> None:
        self._count = 0
        self._mean = 0.0
        self._m2 = 0.0
        self._recent.clear()
