"""Execution-cost model of the edge device (counterpart of
`repro.runtime.costmodel`; `PodCostModel` and its TPU v5e constants are
not carried over).

``EdgeCostModel`` — Jetson-Xavier-NX-class device for the paper-faithful
experiments. Time/energy are *modeled* from FLOPs plus per-round
overheads, not measured. Constants are calibrated so that immediate
fine-tuning reproduces the paper's Fig. 3 breakdown: overheads (system
init + model load/save) = ~58% of round time and ~38% of round energy on
ResNet50 with 16-image batches. All outputs that use it are model-derived.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EdgeCostModel:
    # compute
    flops_per_sec: float = 0.5e12     # effective sustained training throughput
    compute_power_w: float = 15.0     # paper: 15W power mode
    # per-round overheads (system init / compile, model load, model save)
    t_init_s: float = 0.55
    t_load_s: float = 0.3
    t_save_s: float = 0.25
    overhead_power_w: float = 6.5     # IO/compile phases draw less than compute
    # recompilation after a freeze-plan change (extra system init)
    t_recompile_s: float = 0.55

    @property
    def t_overhead_s(self) -> float:
        return self.t_init_s + self.t_load_s + self.t_save_s

    def round_cost(self, compute_flops: float, recompiles: int = 0):
        """Returns (time_s, energy_j, breakdown dict) for one fine-tuning
        round executing `compute_flops` of training work."""
        t_compute = compute_flops / self.flops_per_sec
        t_over = self.t_overhead_s + recompiles * self.t_recompile_s
        e_compute = t_compute * self.compute_power_w
        e_over = t_over * self.overhead_power_w
        return (t_compute + t_over, e_compute + e_over, {
            "t_compute": t_compute, "t_overhead": t_over,
            "e_compute": e_compute, "e_overhead": e_over})

    def compute_cost(self, flops: float):
        """Pure-compute cost (e.g. CKA probes)."""
        t = flops / self.flops_per_sec
        return t, t * self.compute_power_w


def scale_cost(cost: EdgeCostModel, *, speed: float = 1.0,
               energy: float = 1.0) -> EdgeCostModel:
    """A heterogeneous fleet device's cost model, relative to a reference
    one (DESIGN.md §13): `speed` multiplies throughput and divides every
    fixed time overhead (init/load/save/recompile), `energy` multiplies
    both power draws. Identity scales return `cost` unchanged, so the
    default device is bitwise the reference device. Note executor cost
    calibration re-derives `flops_per_sec` and multiplies the calibrated
    figure by the same speed scale (`FineTuneExecutor.speed_scale`)."""
    if speed == 1.0 and energy == 1.0:
        return cost
    import dataclasses

    return dataclasses.replace(
        cost,
        flops_per_sec=cost.flops_per_sec * speed,
        compute_power_w=cost.compute_power_w * energy,
        overhead_power_w=cost.overhead_power_w * energy,
        t_init_s=cost.t_init_s / speed,
        t_load_s=cost.t_load_s / speed,
        t_save_s=cost.t_save_s / speed,
        t_recompile_s=cost.t_recompile_s / speed)

