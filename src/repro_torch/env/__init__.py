"""Per-device physical environment models (a copy of `repro.env`,
DESIGN.md §15): a battery drained by the device's ledger charges, a
first-order thermal RC node driven by its average power, and a DVFS
governor that rescales the device's cost model under a thermal cap.

A `DeviceConfig` with an active `EnvSpec` gets a live `DeviceEnv` in the
port's fleet (runtime/fleet.py): `EnvLedgerObserver` drains its battery
from the ledger's charges, the fleet steps it at every dispatch and
evicts the device when its battery dies, and the device consults its
`ThrottlePolicy` facet before a round. An inactive spec builds nothing.
"""
from repro_torch.env.models import BatteryModel, DvfsGovernor, ThermalModel
from repro_torch.env.runtime import DeviceEnv, EnvLedgerObserver, EnvState
from repro_torch.env.spec import EnvSpec

__all__ = ["BatteryModel", "DeviceEnv", "DvfsGovernor", "EnvLedgerObserver",
           "EnvSpec", "EnvState", "ThermalModel"]
