"""The three physical sub-models a `DeviceEnv` steps (DESIGN.md §15).

All three are plain mutable state machines on the *modeled* timeline —
no jax, no randomness, a handful of floats each — so a fleet of hundreds
of env-enabled devices costs nothing measurable per dispatch. The exact
discrete RC solution (not an Euler step) keeps `ThermalModel.step`
unconditionally stable for any `dt`, which matters because env steps are
driven by the event scheduler and their spacing is arbitrary.
"""
from __future__ import annotations

import math
from typing import Tuple


class BatteryModel:
    """A charge reservoir in joules. `drain` mirrors ledger energy
    charges one-to-one (the conservation test pins ``drained_j`` against
    per-device ledger energy exactly); `harvest` refills at a constant
    rate over modeled time, clamped to capacity."""

    def __init__(self, capacity_j: float, *, harvest_w: float = 0.0,
                 reserve_frac: float = 0.05):
        self.capacity_j = float(capacity_j)
        self.harvest_w = float(harvest_w)
        self.reserve_frac = float(reserve_frac)
        self.charge_j = float(capacity_j)
        self.drained_j = 0.0
        self.harvested_j = 0.0

    def drain(self, energy_j: float) -> None:
        self.drained_j += energy_j
        self.charge_j -= energy_j

    def harvest(self, dt: float) -> None:
        if self.harvest_w <= 0.0 or dt <= 0.0:
            return
        gain = min(self.harvest_w * dt,
                   max(self.capacity_j - self.charge_j, 0.0))
        self.harvested_j += gain
        self.charge_j += gain

    @property
    def soc(self) -> float:
        """State of charge in [0, 1] (clamped — overdrawn reads as 0)."""
        return min(max(self.charge_j / self.capacity_j, 0.0), 1.0)

    @property
    def dead(self) -> bool:
        return self.charge_j <= self.reserve_frac * self.capacity_j


class ThermalModel:
    """First-order RC node above ambient. Each step applies the exact
    discrete solution for a constant power `P` over `dt` seconds::

        T' = T_amb + P·R + (T − T_amb − P·R) · exp(−dt/τ)

    so the temperature relaxes monotonically toward the steady state
    ``T_amb + P·R`` regardless of step size."""

    def __init__(self, *, ambient_c: float, resistance_c_per_w: float,
                 time_constant_s: float):
        self.ambient_c = float(ambient_c)
        self.resistance_c_per_w = float(resistance_c_per_w)
        self.time_constant_s = float(time_constant_s)
        self.temp_c = float(ambient_c)

    def step(self, power_w: float, dt: float) -> float:
        if dt > 0.0:
            target = self.ambient_c + power_w * self.resistance_c_per_w
            decay = math.exp(-dt / self.time_constant_s)
            self.temp_c = target + (self.temp_c - target) * decay
        return self.temp_c


class DvfsGovernor:
    """Discrete frequency governor: temperature at or above `cap_c`
    steps one level down the (descending) `levels` ladder; cooling to
    ``cap_c − hysteresis_c`` steps back up. `cap_c <= 0` disables the
    governor (always level 1.0)."""

    def __init__(self, levels: Tuple[float, ...], *, cap_c: float,
                 hysteresis_c: float = 5.0):
        self.levels = tuple(levels)
        self.cap_c = float(cap_c)
        self.hysteresis_c = float(hysteresis_c)
        self.index = 0
        self.transitions = 0

    @property
    def level(self) -> float:
        return self.levels[self.index]

    def update(self, temp_c: float) -> float:
        if self.cap_c > 0.0:
            if temp_c >= self.cap_c and self.index < len(self.levels) - 1:
                self.index += 1
                self.transitions += 1
            elif (temp_c <= self.cap_c - self.hysteresis_c
                  and self.index > 0):
                self.index -= 1
                self.transitions += 1
        return self.level
