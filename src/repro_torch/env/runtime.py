"""DeviceEnv — the live per-device environment one fleet device carries.

The env is fed from two sides of the runtime (DESIGN.md §15):

- **energy in**: `EnvLedgerObserver` sits in the `CostLedger`'s single
  observer slot (wrapping the session `Telemetry`, when one is active)
  and routes every charge's joules to the owning device's env — the
  battery drains at the exact instant the ledger accounts the energy, so
  battery conservation against per-device ledger energy is an identity.
- **time in**: `DeviceFleet._step_envs` advances every env to the
  scheduler's current time at each dispatch. A step converts the energy
  accumulated since the previous step into an average power, drives the
  thermal RC node with it, applies harvest, and lets the DVFS governor
  pick a frequency level. The fleet then rescales throttled devices'
  `EdgeCostModel`s via `scale_cost` and consults the `ThrottlePolicy`
  before triggering fine-tune rounds.

A device with no (or an inactive) `EnvSpec` carries ``env = None`` and
every hot path short-circuits on that — the disabled run allocates
nothing and stays bit-exact.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.env.models import BatteryModel, DvfsGovernor, ThermalModel
from repro_torch.env.spec import EnvSpec
from repro_torch.obs.trace import NULL_TRACER


@dataclass(frozen=True)
class EnvState:
    """The read-only env snapshot a `ThrottlePolicy` sees per decision.
    Battery fields are ``None`` on mains-powered (thermal-only) envs."""
    device: str
    temperature_c: float
    level: float                       # current DVFS speed multiplier
    soc: Optional[float] = None        # state of charge in [0, 1]
    charge_j: Optional[float] = None   # joules remaining (may be < reserve)
    reserve_j: float = 0.0             # dead-threshold joules
    battery_dead: bool = False


class DeviceEnv:
    """Live environment state for one device (module docstring)."""

    def __init__(self, spec: EnvSpec, device: str, *, tracer=NULL_TRACER):
        self.spec = spec
        self.device = device
        self.tracer = tracer
        self.battery: Optional[BatteryModel] = None
        if spec.battery_capacity_j > 0:
            self.battery = BatteryModel(
                spec.battery_capacity_j, harvest_w=spec.harvest_w,
                reserve_frac=spec.battery_reserve_frac)
        self.thermal = ThermalModel(
            ambient_c=spec.ambient_c,
            resistance_c_per_w=spec.thermal_resistance_c_per_w,
            time_constant_s=spec.thermal_time_constant_s)
        self.dvfs = DvfsGovernor(spec.dvfs_levels, cap_c=spec.thermal_cap_c,
                                 hysteresis_c=spec.dvfs_hysteresis_c)
        self.level = 1.0
        self.throttle_s = 0.0          # modeled seconds spent below 1.0x
        self._last_step = 0.0
        self._energy_acc = 0.0         # joules since the previous step
        self._last_gauge = float("-inf")
        self._throttle_start: Optional[float] = None
        self._throttle_min = 1.0

    # ---- energy in (EnvLedgerObserver) -----------------------------------
    def on_energy(self, energy_j: float) -> None:
        if self.battery is not None:
            self.battery.drain(energy_j)
        self._energy_acc += energy_j

    # ---- time in (DeviceFleet._step_envs) --------------------------------
    def step(self, now: float) -> float:
        """Advance the physics to `now`; returns the DVFS level in force
        from `now` on. Idempotent for non-advancing timestamps."""
        dt = now - self._last_step
        if dt <= 0.0:
            return self.level
        if self.level < 1.0:
            self.throttle_s += dt
        power_w = self._energy_acc / dt
        self._energy_acc = 0.0
        self.thermal.step(power_w, dt)
        if self.battery is not None:
            self.battery.harvest(dt)
        level = self.dvfs.update(self.thermal.temp_c)
        if level != self.level:
            self._note_transition(level, now)
        self.level = level
        self._last_step = now
        if self.tracer and now - self._last_gauge >= self.spec.gauge_period_s:
            self._emit_gauges(now)
        return self.level

    def finalize(self, now: float) -> None:
        """Run-end bookkeeping: a last physics step, the closing gauge
        sample and the tail of any open throttle span."""
        self.step(now)
        if self._throttle_start is not None:
            self._close_throttle_span(now)
        if self.tracer and now > self._last_gauge:
            self._emit_gauges(now)

    # ---- state out (ThrottlePolicy / fleet) ------------------------------
    def state(self) -> EnvState:
        b = self.battery
        return EnvState(
            device=self.device, temperature_c=self.thermal.temp_c,
            level=self.level,
            soc=None if b is None else b.soc,
            charge_j=None if b is None else b.charge_j,
            reserve_j=0.0 if b is None else b.reserve_frac * b.capacity_j,
            battery_dead=False if b is None else b.dead)

    @property
    def battery_dead(self) -> bool:
        return self.battery is not None and self.battery.dead

    # ---- trace emission --------------------------------------------------
    def _note_transition(self, level: float, now: float) -> None:
        if level < 1.0 and self._throttle_start is None:
            self._throttle_start = now
            self._throttle_min = level
        elif level < 1.0:
            self._throttle_min = min(self._throttle_min, level)
        elif self._throttle_start is not None:
            self._close_throttle_span(now)

    def _close_throttle_span(self, now: float) -> None:
        if self.tracer:
            self.tracer.span("throttle", f"dvfs x{self._throttle_min:g}",
                             self._throttle_start,
                             now - self._throttle_start, device=self.device,
                             min_level=self._throttle_min)
        self._throttle_start = None
        self._throttle_min = 1.0

    def _emit_gauges(self, now: float) -> None:
        self._last_gauge = now
        t = self.tracer
        t.instant("gauge", f"temperature_c/{self.device}", now,
                  device=self.device, value=self.thermal.temp_c)
        if self.battery is not None:
            t.instant("gauge", f"soc/{self.device}", now, device=self.device,
                      value=self.battery.soc)


class EnvLedgerObserver:
    """The `CostLedger` observer installed when at least one device has
    an active env: routes every charge's energy to the owning device's
    battery/thermal accumulator, then delegates each hook verbatim to the
    session `Telemetry` (or swallows it when telemetry is off). Installed
    only when needed — env-less runs keep the ledger untouched."""

    def __init__(self, envs: Dict[str, DeviceEnv], inner=None):
        self.envs = envs
        self.inner = inner

    def on_charge(self, *, time_s: float, energy_j: float, flops: float,
                  stream: int, model: str, device: str,
                  kind: str = "round") -> None:
        env = self.envs.get(device)
        if env is not None and energy_j:
            env.on_energy(energy_j)
        if self.inner is not None:
            self.inner.on_charge(time_s=time_s, energy_j=energy_j,
                                 flops=flops, stream=stream, model=model,
                                 device=device, kind=kind)

    def on_round(self, *, stream: int, model: str, device: str) -> None:
        if self.inner is not None:
            self.inner.on_round(stream=stream, model=model, device=device)

    def on_preemption(self, *, stream: int) -> None:
        if self.inner is not None:
            self.inner.on_preemption(stream=stream)

    def on_swap(self, *, model: str, device: str) -> None:
        if self.inner is not None:
            self.inner.on_swap(model=model, device=device)

    def on_sync(self, *, device: str) -> None:
        if self.inner is not None:
            self.inner.on_sync(device=device)
