"""EnvSpec — the declarative physical-environment knob on `DeviceConfig`.

Serializable like every other config piece (strict `to_dict`/`from_dict`
round trip, unknown keys raise listing the valid set). The default spec
is inactive: no battery, no thermal cap — the runtime takes the legacy
bit-exact path with zero env allocations. A positive battery capacity or
thermal cap activates it::

    DeviceConfig("dev1", env=EnvSpec(battery_capacity_j=500.0,
                                     thermal_cap_c=70.0))

The three physical sub-models the spec parameterizes (DESIGN.md §15):

- **battery**: a charge reservoir of `battery_capacity_j` joules drained
  by every `CostLedger` energy charge attributed to the device, optionally
  refilled at `harvest_w` watts of modeled time (solar/kinetic harvest).
  The device counts as *dead* — and degrades into the fleet's straggler
  evict + reroute path — once state-of-charge falls to
  `battery_reserve_frac`; the reserve keeps the small un-gateable charges
  (probes, CKA, sync participation) from overdrawing the budget.
- **thermal**: a first-order RC node. Average power over each env step
  drives the exact discrete solution
  ``T' = T_amb + P·R + (T − T_amb − P·R)·exp(−dt/τ)`` with
  `thermal_resistance_c_per_w` (R) and `thermal_time_constant_s` (τ)
  above `ambient_c`.
- **dvfs**: discrete frequency states `dvfs_levels` (descending speed
  multipliers, level 0 = 1.0 nominal). Temperature at or above
  `thermal_cap_c` steps one level down; cooling below
  ``cap − dvfs_hysteresis_c`` steps back up. A level L rescales the
  device's `EdgeCostModel` via `scale_cost(speed=L,
  energy=L**dvfs_power_exponent)` — slower but cooler per unit work
  whenever the exponent exceeds 1 (dynamic power ~ f·V² ≈ f³; the
  default 2.0 is conservative).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

#: Fields with non-trivial defaults that `to_dict` omits when unchanged.
_DEFAULTS = dict(battery_capacity_j=0.0, harvest_w=0.0,
                 battery_reserve_frac=0.05, ambient_c=25.0,
                 thermal_resistance_c_per_w=2.0, thermal_time_constant_s=30.0,
                 thermal_cap_c=0.0, dvfs_levels=(1.0, 0.75, 0.5),
                 dvfs_hysteresis_c=5.0, dvfs_power_exponent=2.0,
                 gauge_period_s=5.0)


@dataclass(frozen=True)
class EnvSpec:
    """Physical-environment configuration (module docstring).

    - `battery_capacity_j`: battery budget in joules (0 = mains-powered,
      no battery model);
    - `harvest_w`: recharge rate in watts of modeled time (0 = none);
    - `battery_reserve_frac`: state-of-charge at which the device counts
      as dead and is evicted from the fleet;
    - `ambient_c`: thermal ambient the device cools toward;
    - `thermal_resistance_c_per_w` / `thermal_time_constant_s`: the RC
      node (steady-state °C per watt, and seconds to ~63% of a step);
    - `thermal_cap_c`: DVFS throttling threshold (0 = no governor);
    - `dvfs_levels`: descending speed multipliers, first must be 1.0;
    - `dvfs_hysteresis_c`: cooling margin below the cap before the
      governor steps frequency back up;
    - `dvfs_power_exponent`: power ~ level**exponent (>1 = throttling
      saves energy per unit work);
    - `gauge_period_s`: minimum modeled seconds between temperature/SoC
      gauge samples in the telemetry trace.
    """
    battery_capacity_j: float = 0.0
    harvest_w: float = 0.0
    battery_reserve_frac: float = 0.05
    ambient_c: float = 25.0
    thermal_resistance_c_per_w: float = 2.0
    thermal_time_constant_s: float = 30.0
    thermal_cap_c: float = 0.0
    dvfs_levels: Tuple[float, ...] = (1.0, 0.75, 0.5)
    dvfs_hysteresis_c: float = 5.0
    dvfs_power_exponent: float = 2.0
    gauge_period_s: float = 5.0

    @property
    def active(self) -> bool:
        """Whether the env constrains anything: a finite battery budget
        or a thermal cap. Inactive specs build no runtime state at all —
        the device behaves exactly as if it had no env."""
        return bool(self.battery_capacity_j > 0 or self.thermal_cap_c > 0)

    def validate(self, context: str = "env") -> "EnvSpec":
        for fname in ("battery_capacity_j", "harvest_w", "ambient_c",
                      "thermal_cap_c", "dvfs_hysteresis_c"):
            v = getattr(self, fname)
            if not isinstance(v, (int, float)) or v < 0:
                raise ValueError(f"{context}: {fname} must be a "
                                 f"non-negative number (got {v!r})")
        for fname in ("thermal_resistance_c_per_w", "thermal_time_constant_s",
                      "dvfs_power_exponent", "gauge_period_s"):
            v = getattr(self, fname)
            if not isinstance(v, (int, float)) or v <= 0:
                raise ValueError(f"{context}: {fname} must be a positive "
                                 f"number (got {v!r})")
        if not 0.0 <= self.battery_reserve_frac < 1.0:
            raise ValueError(f"{context}: battery_reserve_frac must be in "
                             f"[0, 1) (got {self.battery_reserve_frac!r})")
        levels = self.dvfs_levels
        if (not isinstance(levels, tuple) or not levels
                or levels[0] != 1.0
                or any(not isinstance(v, (int, float)) or not 0 < v <= 1.0
                       for v in levels)
                or list(levels) != sorted(levels, reverse=True)):
            raise ValueError(f"{context}: dvfs_levels must be a descending "
                             f"tuple of speed multipliers in (0, 1] starting "
                             f"at 1.0 (got {levels!r})")
        return self

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for fname, default in _DEFAULTS.items():
            v = getattr(self, fname)
            if v != default:
                out[fname] = list(v) if isinstance(v, tuple) else v
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EnvSpec":
        if not isinstance(d, dict):
            raise ValueError(f"an env spec must be a dict (got {d!r})")
        unknown = set(d) - set(_DEFAULTS)
        if unknown:
            raise ValueError(f"env spec: unknown key(s) {sorted(unknown)}; "
                             f"valid: {sorted(_DEFAULTS)}")
        kw = dict(d)
        if "dvfs_levels" in kw:
            levels = kw["dvfs_levels"]
            if not isinstance(levels, (list, tuple)):
                raise ValueError(f"env spec: dvfs_levels must be a list "
                                 f"(got {levels!r})")
            kw["dvfs_levels"] = tuple(float(v) for v in levels)
        return cls(**kw).validate()
