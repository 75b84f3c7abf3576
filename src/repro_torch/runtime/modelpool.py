"""ModelPool — the mixed-modality multi-model runtime (DESIGN.md §9).

EdgeOL's target deployments mix modalities: the paper evaluates CV
(CORe50/CIFAR) *and* NLP (20News) workloads, and a real edge box serves
both from one device. A `ModelPool` owns N independent model **slots** —
one per modality, each with its own params, optimizer state, compiled
train steps (`TrainStepCache`), replay buffer, freeze-plan controller and
per-model cost calibration — all multiplexed over the single shared
device timeline (`EventScheduler.busy_until`).

The pool's own job is **residency** under a device memory budget:

- each slot's footprint is its params + optimizer state (measured from
  the live pytrees at run start, or pinned via `ModelSlot.memory_mb`);
- `memory_budget_mb` caps how many footprints fit at once (0 = unlimited,
  every slot stays resident and no swap is ever charged);
- touching a **cold** slot — a fine-tuning round *or* an inference
  request — first swaps it in: least-recently-used resident slots are
  evicted (paying their cost model's `t_save_s`; training dirties a slot,
  so eviction always saves) until the incoming slot (paying `t_load_s`)
  fits. The swap is real device occupancy *and* a real ledger charge
  (`CostLedger.charge_swap` → `t_swap`/`e_swap` breakdown, attributed to
  the touching stream and the loaded slot, whose `swaps` counter bumps).

The pool is deliberately runtime-state-free beyond residency: the
composition root (`runtime/continual.py`) owns one `FineTuneExecutor` and
one serving lane per slot and asks the pool only "is this slot hot, and
what does making it hot cost" — so the swap-charging policy is testable
without a model in sight.

A copy of `repro.runtime.modelpool`; `tree_mb` counts tensor bytes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree_leaves
from repro_torch.runtime.costmodel import EdgeCostModel


def tree_mb(*trees: Any) -> float:
    """Total tensor bytes of the given trees, in MB (the footprint a
    resident slot pins in device memory)."""
    total = 0
    for tree in trees:
        for leaf in tree_leaves(tree):
            total += leaf.numel() * leaf.element_size() \
                if isinstance(leaf, torch.Tensor) else np.asarray(leaf).nbytes
    return total / 2**20


@dataclass
class ModelSlot:
    """One modality's model binding. `name` is the modality key streams
    bind to (`StreamSpec.modality` → `Event.modality` → this slot);
    `benchmark` provides the slot's pretraining scenario 0 and its
    replay/validation data; `cost` is calibrated per slot (different
    architectures sustain different modeled throughput); `controller` may
    be pre-built, else the runtime builds one via its `controller_factory`
    seam; `memory_mb` overrides the measured params+optimizer footprint
    (useful for tests and what-if budget sweeps)."""
    name: str
    model: Any
    benchmark: Any
    cost: EdgeCostModel = field(default_factory=EdgeCostModel)
    controller: Any = None
    memory_mb: Optional[float] = None


class ModelPool:
    """N model slots sharing one device memory budget (LRU residency)."""

    def __init__(self, slots: Sequence[ModelSlot],
                 memory_budget_mb: float = 0.0):
        if not slots:
            raise ValueError("ModelPool needs at least one slot")
        names = [s.name for s in slots]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate slot names: {names}")
        self.slots: Dict[str, ModelSlot] = {s.name: s for s in slots}
        self.memory_budget_mb = float(memory_budget_mb)
        self._memory: Dict[str, float] = {
            s.name: float(s.memory_mb) for s in slots
            if s.memory_mb is not None}
        self._resident: List[str] = []   # LRU order, most-recent last

    # ---- introspection ---------------------------------------------------
    def slot(self, name: str) -> ModelSlot:
        try:
            return self.slots[name]
        except KeyError:
            raise KeyError(
                f"no model slot for modality {name!r}; pool has "
                f"{sorted(self.slots)}") from None

    def __len__(self) -> int:
        return len(self.slots)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self.slots)

    @property
    def resident(self) -> Tuple[str, ...]:
        return tuple(self._resident)

    def is_resident(self, name: str) -> bool:
        return name in self._resident

    def memory_of(self, name: str) -> float:
        """Footprint of one slot, MB (0.0 until measured/pinned)."""
        return self._memory.get(name, 0.0)

    @property
    def resident_mb(self) -> float:
        return sum(self.memory_of(n) for n in self._resident)

    def describe(self) -> Dict:
        """JSON-ready summary for benchmark manifests."""
        return {
            "memory_budget_mb": self.memory_budget_mb,
            "slots": {n: {"memory_mb": round(self.memory_of(n), 3),
                          "model": getattr(getattr(s.model, "cfg", None),
                                           "name", "?"),
                          "benchmark": getattr(s.benchmark, "name", "?")}
                      for n, s in self.slots.items()},
        }

    # ---- residency -------------------------------------------------------
    def set_memory(self, name: str, mb: float) -> None:
        """Pin a slot's measured footprint (the runtime calls this once
        its params/optimizer pytrees exist). An explicit
        `ModelSlot.memory_mb` wins over the measurement."""
        if self.slot(name).memory_mb is None:
            self._memory[name] = float(mb)
        if self.memory_budget_mb > 0.0 \
                and self._memory[name] > self.memory_budget_mb:
            raise ValueError(
                f"slot {name!r} ({self._memory[name]:.1f} MB) can never "
                f"fit the {self.memory_budget_mb:.1f} MB device budget")

    def warm(self) -> Tuple[str, ...]:
        """Initial residency at timeline start: slots become resident in
        declaration order until the budget is full (pretraining happens
        off-timeline, so these initial loads are not cost-accounted —
        paper §V-A's "originally well-trained" premise). Returns the
        resident set."""
        self._resident = []
        for name in self.slots:
            mem = self.memory_of(name)
            if self.memory_budget_mb <= 0.0 \
                    or self.resident_mb + mem <= self.memory_budget_mb:
                self._resident.append(name)
        return self.resident

    def ensure_resident(self, name: str) -> Tuple[float, float, List[str]]:
        """Make `name` resident. Returns ``(swap_time_s, swap_energy_j,
        evicted)`` — all-zero/empty when the slot was already hot (its LRU
        position is refreshed). A cold slot evicts least-recently-used
        residents until it fits, paying each eviction's `t_save_s` plus
        its own `t_load_s`, at the respective cost models' overhead power
        (swaps are IO, not compute). The caller charges the ledger and
        occupies the device timeline with the returned figures."""
        slot = self.slot(name)
        if name in self._resident:
            self._resident.remove(name)
            self._resident.append(name)
            return 0.0, 0.0, []
        mem = self.memory_of(name)
        evicted: List[str] = []
        if self.memory_budget_mb > 0.0:
            while self._resident \
                    and self.resident_mb + mem > self.memory_budget_mb:
                evicted.append(self._resident.pop(0))
            if self.resident_mb + mem > self.memory_budget_mb:
                raise ValueError(
                    f"slot {name!r} ({mem:.1f} MB) cannot fit the "
                    f"{self.memory_budget_mb:.1f} MB budget even alone")
        time_s = slot.cost.t_load_s
        energy_j = slot.cost.t_load_s * slot.cost.overhead_power_w
        for ev in evicted:
            c = self.slot(ev).cost
            time_s += c.t_save_s
            energy_j += c.t_save_s * c.overhead_power_w
        self._resident.append(name)
        return time_s, energy_j, evicted
