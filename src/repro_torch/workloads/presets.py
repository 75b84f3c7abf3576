"""Named workload presets — the workload axis the benchmark sweep (and any
future PR) runs controllers against.

Each preset is a `WorkloadSpec` builder parameterized by scale knobs so the
same shapes serve both the CI quick sweep and full local runs. The mix
covers the regimes the paper's single Poisson timeline cannot express:
multi-stream contention, staggered drift, MMPP bursts, diurnal + duty-
cycle capture, and a heterogeneous two-benchmark mix.

The 'mixed' preset is a faithful CV+NLP mix: its NLP stream binds
(`modality="nlp"`, `benchmark="20news"`) to a real BERT model slot in a
`ModelPool` runtime — both modalities fine-tune and serve on the one
shared device under its memory budget (DESIGN.md §9). The trace arrival
process mimics the bursty VTT query pattern of paper §V-D.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.workloads.spec import (DiurnalConfig, DutyCycle,
                                        MMPPConfig, StreamSpec, WorkloadSpec)


def presets(*, batches_per_scenario: int = 8, inferences: int = 24,
            num_scenarios: int = 3, scenario_span: float = 100.0,
            seed: int = 0,
            fleet_streams: int = 120) -> Dict[str, WorkloadSpec]:
    """The standard preset set, scaled by the given knobs.
    `fleet_streams` sizes only the `fleet` preset (the DeviceFleet cell,
    DESIGN.md §13): hundreds of light camera streams by default, scaled
    down to a handful for the CI quick sweep."""
    def cv(**kw) -> StreamSpec:
        base = dict(modality="cv", benchmark="nc",
                    batches_per_scenario=batches_per_scenario,
                    inferences=inferences)
        base.update(kw)
        return StreamSpec(**base)

    geom = dict(num_scenarios=num_scenarios, scenario_span=scenario_span,
                seed=seed)
    specs = [
        # the paper's own setting, expressed as a workload (baseline cell)
        WorkloadSpec("single-poisson", (cv(),), **geom),
        # two cameras sharing one device; drift reaches them staggered
        WorkloadSpec("two-stream", (cv(), cv(benchmark="ni")),
                     drift="staggered", **geom),
        # motion-triggered capture: MMPP bursts on both batches + queries
        WorkloadSpec("bursty-mmpp",
                     (cv(data_dist="mmpp", inf_dist="mmpp",
                         mmpp=MMPPConfig(burst_mult=6.0, idle_mult=0.2,
                                         mean_dwell=scenario_span / 4)),),
                     **geom),
        # day/night query curve + duty-cycled capture windows
        WorkloadSpec("diurnal-duty",
                     (cv(inf_dist="diurnal",
                         diurnal=DiurnalConfig(period=scenario_span,
                                               amplitude=0.8),
                         duty_cycle=DutyCycle(period=scenario_span / 2,
                                              on_fraction=0.6)),),
                     **geom),
        # heterogeneous modality mix: steady CV stream + a real NLP
        # stream (BERT on the 20News-style token benchmark, bursty trace
        # arrivals) — one model slot per modality, one shared device
        WorkloadSpec("mixed",
                     (cv(),
                      cv(modality="nlp", benchmark="20news",
                         data_dist="trace", inf_dist="trace",
                         inferences=max(inferences // 2, 4),
                         phase=scenario_span / 7)),
                     **geom),
        # QoS: a latency-critical query stream (high priority, few
        # training batches, many requests) sharing the device with a bulk
        # tuning stream (priority 0, heavy batch load — its rounds keep
        # the device busy, which is exactly what preemption must cut
        # through). The sweep runs this preset with preemption off and on
        # and reports per-stream p50/p95 serving latency.
        WorkloadSpec("qos",
                     (cv(priority=2, inferences=inferences * 2,
                         batches_per_scenario=max(
                             batches_per_scenario // 2, 2)),
                      cv(benchmark="ni", priority=0,
                         batches_per_scenario=batches_per_scenario * 2,
                         inferences=max(inferences // 2, 4))),
                     **geom),
        # adversarial flash crowd: four cameras replaying the SAME
        # recorded trace — a long quiet stretch, then a dense burst
        # hitting every stream at the same instant (a stadium goal, a
        # doorbell storm). 'trace-replay' honors the recorded gaps
        # verbatim (no window rescale), so the burst stays exactly as
        # tight as recorded no matter the scale knobs — the worst case
        # for triggers, serving latency and (with env enabled) thermal
        # headroom.
        WorkloadSpec("flash-crowd",
                     tuple(cv(benchmark="ni" if i % 2 else "nc",
                              data_dist="trace-replay",
                              inf_dist="trace-replay",
                              trace=(scenario_span * 0.55,)
                              + (scenario_span / 200.0,) * 23)
                           for i in range(4)),
                     **geom),
        # DeviceFleet cell (DESIGN.md §13): a whole fleet of light camera
        # streams — each a fraction of the single-device load, phased so
        # arrivals spread over the scenario span — routed across tens of
        # devices by the runtime's `RuntimeConfig.devices` axis. Every
        # fourth stream is latency-critical (priority 1) so the routing
        # policies have asymmetry to work with; drift is staggered like a
        # rolling multi-camera deployment.
        WorkloadSpec("fleet",
                     tuple(cv(benchmark="ni" if i % 3 == 2 else "nc",
                              batches_per_scenario=max(
                                  batches_per_scenario // 2, 2),
                              inferences=max(inferences // 4, 3),
                              priority=1 if i % 4 == 3 else 0,
                              phase=(i % 8) * scenario_span / 8.0)
                           for i in range(fleet_streams)),
                     drift="staggered", **geom),
    ]
    return {s.validate().name: s for s in specs}


WORKLOADS: Dict[str, WorkloadSpec] = presets()
