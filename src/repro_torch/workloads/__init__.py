"""Declarative multi-stream workloads (DESIGN.md §7): `WorkloadSpec` +
generators that compile arrival processes (Poisson / uniform / normal /
trace / MMPP / diurnal, with duty-cycle windows and staggered drift) down
to the multi-stream `Event` timeline the `EventScheduler` replays.

A copy of `repro.workloads`, which imports no JAX: the same spec compiles
to the same events in both packages (tests/test_torch_workloads.py)."""
from repro_torch.workloads.generators import compile_workload, stream_events
from repro_torch.workloads.presets import WORKLOADS, presets
from repro_torch.workloads.spec import (ARRIVAL_DISTS, DRIFT_SCHEDULES,
                                        DiurnalConfig, DutyCycle, MMPPConfig,
                                        StreamSpec, WorkloadSpec)

__all__ = [
    "ARRIVAL_DISTS", "DRIFT_SCHEDULES", "DiurnalConfig", "DutyCycle",
    "MMPPConfig", "StreamSpec", "WorkloadSpec", "WORKLOADS",
    "compile_workload", "presets", "stream_events",
]
