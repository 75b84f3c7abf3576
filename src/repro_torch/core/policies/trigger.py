"""Trigger policies — *when* to launch a fine-tuning round.

`LazyTuneTrigger` is the paper's inter-tuning policy (Alg. 1); the rest
cover the ablation baseline (`ImmediateTrigger`), the QoS starvation
guard (`StalenessGuard`, previously `ETunerConfig.max_staleness`) and the
ROADMAP's priority-aware variant (`PriorityWeightedTrigger`), which
scales LazyTune's accumulation target by the stream's QoS priority.

A copy of `repro.core.policies.trigger`.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.lazytune import LazyTune, LazyTuneConfig


class ImmediateTrigger:
    """Fine-tune as soon as any batch is buffered (the paper's Immed.
    baseline). `batches_needed` mirrors what the pre-stack monolith
    reported for a disabled LazyTune (its untouched initial target), so
    `stats()` stays key- and value-compatible."""

    def __init__(self, batches_needed: float = 1.0):
        self.batches_needed = float(batches_needed)

    def should_trigger(self, batches_available: int, staleness: float = 0.0,
                       priority: int = 0) -> bool:
        return batches_available >= 1

    def round_finished(self, iters: int, val_acc: float) -> None:
        pass

    def inference_arrived(self) -> None:
        pass

    def scenario_changed(self) -> None:
        pass

    def stats(self) -> dict:
        return {"rounds_triggered": 0, "batches_needed": self.batches_needed}


class LazyTuneTrigger:
    """The paper's LazyTune accumulation target (Alg. 1 l.1-2, 10-21),
    unchanged — this class only gives the existing `core.lazytune`
    state machine the TriggerPolicy surface."""

    def __init__(self, config: Optional[LazyTuneConfig] = None):
        self.lazytune = LazyTune(config if config is not None
                                 else LazyTuneConfig())

    def should_trigger(self, batches_available: int, staleness: float = 0.0,
                       priority: int = 0) -> bool:
        return self.lazytune.should_trigger(batches_available)

    def round_finished(self, iters: int, val_acc: float) -> None:
        self.lazytune.round_finished(iters, val_acc)

    def inference_arrived(self) -> None:
        self.lazytune.inference_arrived()

    def scenario_changed(self) -> None:
        self.lazytune.scenario_changed()

    def stats(self) -> dict:
        st = self.lazytune.state
        return {"rounds_triggered": st.rounds_triggered,
                "batches_needed": st.batches_needed}


class StalenessGuard:
    """TriggerPolicy decorator: force a round once the stream has gone
    `max_staleness` timeline-seconds without one (and has data buffered),
    otherwise defer to the wrapped policy. This is the QoS starvation
    guard previously baked into `ETunerConfig.max_staleness` (DESIGN.md
    §8) — now composable around any trigger."""

    def __init__(self, inner, max_staleness: float):
        if max_staleness <= 0:
            raise ValueError(f"max_staleness must be positive "
                             f"(got {max_staleness!r})")
        self.inner = inner
        self.max_staleness = float(max_staleness)

    def should_trigger(self, batches_available: int, staleness: float = 0.0,
                       priority: int = 0) -> bool:
        if batches_available and staleness >= self.max_staleness:
            return True
        return self.inner.should_trigger(batches_available,
                                         staleness=staleness,
                                         priority=priority)

    def round_finished(self, iters: int, val_acc: float) -> None:
        self.inner.round_finished(iters, val_acc)

    def inference_arrived(self) -> None:
        self.inner.inference_arrived()

    def scenario_changed(self) -> None:
        self.inner.scenario_changed()

    def stats(self) -> dict:
        return self.inner.stats()

    def __getattr__(self, name):
        # decorator transparency: `.lazytune` etc. reach the wrapped policy
        return getattr(self.inner, name)


class PriorityWeightedTrigger:
    """LazyTune whose accumulation target is scaled by the stream's QoS
    priority (ROADMAP: priority-weighted LazyTune targets).

    A priority-`p` stream triggers only once `batches_available >=
    batches_needed * (1 + priority_weight * p)`: latency-critical
    streams *defer* fine-tuning — accumulating more batches per round
    keeps the one shared device free for their many requests (each round
    the stream skips is occupancy its own queries never wait out), which
    is exactly LazyTune's bet that tuning less often costs little
    accuracy. Priority-0 bulk streams keep the paper's plain LazyTune
    behaviour, as does every stream at `priority_weight=0`. Compose with
    a `StalenessGuard` (the reference's `build_trigger` does, from the
    `max_staleness` param) for the *joint* priority/staleness decision:
    the unscaled guard force-triggers a deferred stream before its model
    goes stale, so priority buys serving latency only up to that
    freshness bound."""

    def __init__(self, config: Optional[LazyTuneConfig] = None,
                 priority_weight: float = 0.5):
        if priority_weight < 0:
            raise ValueError(f"priority_weight must be >= 0 "
                             f"(got {priority_weight!r})")
        self.lazytune = LazyTune(config if config is not None
                                 else LazyTuneConfig())
        self.priority_weight = float(priority_weight)

    def _boost(self, priority: int) -> float:
        return 1.0 + self.priority_weight * max(int(priority), 0)

    def should_trigger(self, batches_available: int, staleness: float = 0.0,
                       priority: int = 0) -> bool:
        st = self.lazytune.state
        trig = batches_available >= st.batches_needed * self._boost(priority)
        if not trig and batches_available > 0:
            # LazyTune.should_trigger's delay bookkeeping, kept in step
            # (we cannot call it directly: its predicate has no boost)
            st.rounds_delayed += 1
        return trig

    def round_finished(self, iters: int, val_acc: float) -> None:
        self.lazytune.round_finished(iters, val_acc)

    def inference_arrived(self) -> None:
        self.lazytune.inference_arrived()

    def scenario_changed(self) -> None:
        self.lazytune.scenario_changed()

    def stats(self) -> dict:
        st = self.lazytune.state
        return {"rounds_triggered": st.rounds_triggered,
                "batches_needed": st.batches_needed}
