"""ThrottlePolicy implementations — the fifth PolicyStack facet: should
the device spend a fine-tuning round's time and energy *right now*, given
its physical environment (DESIGN.md §15)?

The policy sees an `repro_torch.env.EnvState` snapshot (battery state of
charge, joules remaining, temperature, DVFS level) plus the runtime's
modeled estimate of the round about to launch, and answers allow/defer.
Deferred rounds are not dropped: the buffered batches stay queued and the
next arrival re-asks, so a recovering battery or a cooling device picks
the work back up. Policies are duck-typed against `EnvState`'s attribute
names — no import of `repro_torch.env` — so the policy layer stays decoupled
from the physics.

`NullThrottle` ("none") is the default on every stack and always allows:
with no env configured the consultation path is short-circuited entirely
and the run is bit-exact with the pre-env runtime. A copy of
`repro.core.policies.throttle`.
"""
from __future__ import annotations


class NullThrottle:
    """Always allow — the inert default facet (bit-exact legacy path)."""

    name = "none"

    def allow_round(self, state, *, time_s: float = 0.0,
                    energy_j: float = 0.0) -> bool:
        return True

    def stats(self) -> dict:
        return {}


class BudgetThrottle:
    """Battery-budget gating: a round launches only while the battery
    can afford its estimated energy *above* the dead-reserve (so the
    un-gateable small charges — probes, CKA, sync participation — have
    headroom), and state of charge sits above `min_soc`. A dead battery
    always defers (the fleet evicts the device anyway)."""

    name = "battery"

    def __init__(self, min_soc: float = 0.0):
        if not 0.0 <= min_soc < 1.0:
            raise ValueError(f"min_soc must be in [0, 1) (got {min_soc!r})")
        self.min_soc = float(min_soc)
        self.deferred = 0

    def allow_round(self, state, *, time_s: float = 0.0,
                    energy_j: float = 0.0) -> bool:
        if state.charge_j is None:  # mains-powered: nothing to conserve
            return True
        ok = (not state.battery_dead
              and state.soc > self.min_soc
              and state.charge_j - state.reserve_j >= energy_j)
        if not ok:
            self.deferred += 1
        return ok

    def stats(self) -> dict:
        return {"throttle_deferred": self.deferred}


class ThermalThrottle:
    """Thermal gating: defer rounds while the device sits at or above
    `max_temp_c`. Complements the DVFS governor (which merely slows the
    clock): under a sustained overload the governor bottoms out and this
    policy sheds the *work* until the RC node cools."""

    name = "thermal"

    def __init__(self, max_temp_c: float = 80.0):
        if max_temp_c <= 0:
            raise ValueError(f"max_temp_c must be > 0 (got {max_temp_c!r})")
        self.max_temp_c = float(max_temp_c)
        self.deferred = 0

    def allow_round(self, state, *, time_s: float = 0.0,
                    energy_j: float = 0.0) -> bool:
        ok = state.temperature_c < self.max_temp_c
        if not ok:
            self.deferred += 1
        return ok

    def stats(self) -> dict:
        return {"throttle_deferred": self.deferred}
