"""CostLedger — the single accumulation point for modeled execution costs.

Every time/energy/FLOPs figure a run reports flows through one ledger
instance: per-round charges (compute + fixed overheads, from
``EdgeCostModel.round_cost``), auxiliary probe charges (e.g. SimFreeze's
CKA similarity computations) and ModelPool swap charges (loading/saving a
model slot across the device memory budget). Centralizing the arithmetic
keeps the breakdown keys consistent across the runtime, benchmarks and
tests, and makes "where did the joules go" auditable instead of being
smeared across the event loop. Counterpart of `repro.runtime.ledger`,
without the telemetry observer hook (the metrics registry is not ported
yet).

Attribution is three-dimensional: every charge lands in the global totals,
in ``per_stream[stream]`` (which arrival stream caused it), in
``per_model[model]`` (which model slot executed it — DESIGN.md §9) and in
``per_device[device]`` (which fleet device ran it — DESIGN.md §13). All
three attributions independently sum back to the totals; single-model
single-device runs put everything under the ``"default"`` slot and the
``"dev0"`` device so the invariant is universal.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

#: Breakdown keys every `RunResult.breakdown` carries. `t_`/`e_` prefix =
#: seconds / joules; `compute`/`overhead` follow the paper's Fig. 3 split;
#: `cka` is SimFreeze's similarity-probe cost (charged as pure compute).
#: ModelPool swap charges (`t_swap`/`e_swap`) and preemption-resume
#: charges (`t_resume`/`e_resume`) appear lazily, only when a run
#: actually incurs them — keeping legacy breakdowns byte-identical.
BREAKDOWN_KEYS = ("t_compute", "t_overhead", "e_compute", "e_overhead",
                  "t_cka", "e_cka")


#: Per-stream attribution keys: every charge lands both in the global
#: totals and in `per_stream[stream]` under these names, so a multi-stream
#: run can answer "which stream spent the joules" (and tests can assert the
#: attributions always sum back to the totals). `preemptions` counts how
#: many times the stream's in-flight round was split by a higher-priority
#: arrival (QoS preemption; it is a counter, not a cost — excluded from
#: the sums-to-totals contract, which covers the first four keys).
STREAM_KEYS = ("time_s", "energy_j", "flops", "rounds", "preemptions")

#: Per-model-slot attribution keys (ModelPool, DESIGN.md §9). The cost
#: keys mirror STREAM_KEYS and sum to the totals the same way; `swaps`
#: counts how many times the slot was loaded back into device memory
#: after an eviction (a counter, like `preemptions`).
MODEL_KEYS = ("time_s", "energy_j", "flops", "rounds", "swaps")

#: Model-slot key used when the runtime runs a single model (no pool).
DEFAULT_MODEL = "default"

#: Per-device attribution keys (DeviceFleet, DESIGN.md §13). The cost keys
#: mirror STREAM_KEYS and sum to the totals the same way; `swaps` counts
#: the device's ModelPool reloads and `syncs` its participations in
#: cross-device delta merges (counters, like `preemptions`).
DEVICE_KEYS = ("time_s", "energy_j", "flops", "rounds", "swaps", "syncs")

#: Device key used when the runtime runs a fleet of size 1 (the legacy
#: single-device case — every seed-era run).
DEFAULT_DEVICE = "dev0"


@dataclass
class CostLedger:
    total_time_s: float = 0.0
    total_energy_j: float = 0.0
    total_flops: float = 0.0
    rounds: int = 0
    breakdown: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in BREAKDOWN_KEYS})
    per_stream: Dict[int, Dict[str, float]] = field(default_factory=dict)
    per_model: Dict[str, Dict[str, float]] = field(default_factory=dict)
    per_device: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def _stream(self, stream: int) -> Dict[str, float]:
        return self.per_stream.setdefault(
            stream, {k: 0.0 for k in STREAM_KEYS})

    def _model(self, model: str) -> Dict[str, float]:
        return self.per_model.setdefault(
            model, {k: 0.0 for k in MODEL_KEYS})

    def _device(self, device: str) -> Dict[str, float]:
        return self.per_device.setdefault(
            device, {k: 0.0 for k in DEVICE_KEYS})

    def charge_round(self, *, flops: float, time_s: float, energy_j: float,
                     parts: Dict[str, float], stream: int = 0,
                     model: str = DEFAULT_MODEL,
                     device: str = DEFAULT_DEVICE) -> None:
        """One fine-tuning round: `parts` is EdgeCostModel's breakdown dict
        (t_compute/t_overhead/e_compute/e_overhead); `stream` is the
        arrival stream whose buffered batches the round trained; `model`
        the slot that executed it; `device` the fleet device it ran on."""
        self.charge_round_segment(flops=flops, time_s=time_s,
                                  energy_j=energy_j, parts=parts,
                                  stream=stream, model=model, device=device,
                                  final=True)

    def charge_round_segment(self, *, flops: float, time_s: float,
                             energy_j: float, parts: Dict[str, float],
                             stream: int = 0, model: str = DEFAULT_MODEL,
                             device: str = DEFAULT_DEVICE,
                             final: bool = True) -> None:
        """One *segment* of a (possibly preempted) round. A preemptible
        round charges each occupancy segment as it completes; the caller
        splits the round's total cost across segments so they sum exactly
        to the unpreempted round's charge. `final=True` on the last (or
        only) segment counts the round itself."""
        self.total_time_s += time_s
        self.total_energy_j += energy_j
        self.total_flops += flops
        for k in ("t_compute", "t_overhead", "e_compute", "e_overhead"):
            self.breakdown[k] += parts[k]
        per = self._stream(stream)
        per["time_s"] += time_s
        per["energy_j"] += energy_j
        per["flops"] += flops
        pm = self._model(model)
        pm["time_s"] += time_s
        pm["energy_j"] += energy_j
        pm["flops"] += flops
        pd = self._device(device)
        pd["time_s"] += time_s
        pd["energy_j"] += energy_j
        pd["flops"] += flops
        if final:
            self.rounds += 1
            per["rounds"] += 1
            pm["rounds"] += 1
            pd["rounds"] += 1

    def note_preemption(self, stream: int = 0) -> None:
        """A higher-priority arrival split `stream`'s in-flight round."""
        self._stream(stream)["preemptions"] += 1

    @property
    def preemptions(self) -> int:
        return int(sum(v.get("preemptions", 0)
                       for v in self.per_stream.values()))

    def charge_probe(self, key: str, time_s: float, energy_j: float,
                     stream: int = 0, model: str = DEFAULT_MODEL,
                     device: str = DEFAULT_DEVICE) -> None:
        """An auxiliary compute charge outside the round proper (e.g. `key`
        = 'cka'). Adds to the totals and to `t_<key>` / `e_<key>`."""
        time_s, energy_j = float(time_s), float(energy_j)
        self.breakdown[f"t_{key}"] = self.breakdown.get(f"t_{key}", 0.0) + time_s
        self.breakdown[f"e_{key}"] = self.breakdown.get(f"e_{key}", 0.0) + energy_j
        self.total_time_s += time_s
        self.total_energy_j += energy_j
        per = self._stream(stream)
        per["time_s"] += time_s
        per["energy_j"] += energy_j
        pm = self._model(model)
        pm["time_s"] += time_s
        pm["energy_j"] += energy_j
        pd = self._device(device)
        pd["time_s"] += time_s
        pd["energy_j"] += energy_j

    def charge_swap(self, *, time_s: float, energy_j: float, model: str,
                    stream: int = 0, device: str = DEFAULT_DEVICE) -> None:
        """A ModelPool residency swap: `model` was loaded back into device
        memory (evicted peers saved out first). Lands in the totals, the
        `t_swap`/`e_swap` breakdown, all attributions, and bumps the
        slot's and device's `swaps` counters."""
        self.charge_probe("swap", time_s, energy_j, stream=stream,
                          model=model, device=device)
        self._model(model)["swaps"] += 1
        self._device(device)["swaps"] += 1

    def charge_sync(self, *, time_s: float, energy_j: float, device: str,
                    stream: int = 0, model: str = DEFAULT_MODEL) -> None:
        """One device's participation in a cross-device delta merge
        (DeviceFleet aggregation, DESIGN.md §13): serializing its unfrozen
        params out and loading the merged result back. Lands in the totals,
        the `t_sync`/`e_sync` breakdown, all attributions, and bumps the
        device's `syncs` counter."""
        self.charge_probe("sync", time_s, energy_j, stream=stream,
                          model=model, device=device)
        self._device(device)["syncs"] += 1

    @property
    def swaps(self) -> int:
        return int(sum(v.get("swaps", 0) for v in self.per_model.values()))

    @property
    def syncs(self) -> int:
        return int(sum(v.get("syncs", 0) for v in self.per_device.values()))

    @property
    def compute_tflops(self) -> float:
        return self.total_flops / 1e12
