"""Per-device physical environment models (a copy of `repro.env`,
DESIGN.md §15): a battery drained by the device's ledger charges, a
first-order thermal RC node driven by its average power, and a DVFS
governor that rescales the device's cost model under a thermal cap.

`RuntimeConfig` and `DeviceConfig` carry an `EnvSpec`, so the port needs
the spec. The port's fleet takes only an inactive spec for now: an
active one raises `NotImplementedError` naming ROADMAP A.8, which makes
the environment live. The models are copied whole so that A.8 only has to
wire them in.
"""
from repro_torch.env.models import BatteryModel, DvfsGovernor, ThermalModel
from repro_torch.env.runtime import DeviceEnv, EnvLedgerObserver, EnvState
from repro_torch.env.spec import EnvSpec

__all__ = ["BatteryModel", "DeviceEnv", "DvfsGovernor", "EnvLedgerObserver",
           "EnvSpec", "EnvState", "ThermalModel"]
