"""Straggler detection & mitigation (a copy of
`repro.distributed.straggler`, numpy only; the fleet imports it).

The tracker keeps a per-host EMA of step times, flags hosts whose recent
times exceed a robust threshold, and the mitigation policy decides
between:
- `rebalance`: shrink the flagged host's data shard (work stealing) —
  returns a per-host batch-fraction plan;
- `evict`: drop the host.

The port's fleet (runtime/fleet.py) feeds it each device's mean round
time at every sync and evicts what it says to evict; a flagged device's
streams re-route to the fastest active one."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class StragglerConfig:
    ema: float = 0.9
    z_threshold: float = 3.0
    min_samples: int = 8
    slow_factor: float = 1.5        # flagged if > factor x fleet median
    evict_after: int = 3            # consecutive flags before eviction


@dataclass
class HostStat:
    ema_time: float = 0.0
    samples: int = 0
    flags: int = 0


class StragglerTracker:
    def __init__(self, num_hosts: int,
                 config: Optional[StragglerConfig] = None):
        # NOTE: the config default must be built per instance — a
        # `config=StragglerConfig()` default would be evaluated once at
        # function definition and *shared by every tracker* (mutable
        # dataclass), so tuning one tracker's thresholds would silently
        # retune all of them
        self.cfg = config if config is not None else StragglerConfig()
        self.hosts: Dict[int, HostStat] = {h: HostStat() for h in range(num_hosts)}
        self.evicted: List[int] = []

    def record_step(self, host_times: Dict[int, float]) -> None:
        for h, t in host_times.items():
            st = self.hosts.get(h)
            if st is None or h in self.evicted:
                continue
            st.ema_time = t if st.samples == 0 else \
                self.cfg.ema * st.ema_time + (1 - self.cfg.ema) * t
            st.samples += 1
        self._update_flags()

    def _active(self) -> List[int]:
        return [h for h in self.hosts if h not in self.evicted]

    def _update_flags(self) -> None:
        act = [h for h in self._active()
               if self.hosts[h].samples >= self.cfg.min_samples]
        if len(act) < 2:
            return
        med = float(np.median([self.hosts[h].ema_time for h in act]))
        for h in act:
            if self.hosts[h].ema_time > self.cfg.slow_factor * med:
                self.hosts[h].flags += 1
            else:
                self.hosts[h].flags = 0

    def stragglers(self) -> List[int]:
        return [h for h in self._active() if self.hosts[h].flags > 0]

    def to_evict(self) -> List[int]:
        return [h for h in self._active()
                if self.hosts[h].flags >= self.cfg.evict_after]

    # -- mitigation plans ------------------------------------------------
    def rebalance_plan(self) -> Dict[int, float]:
        """Per-host share of the global batch, inversely proportional to
        EMA step time (work stealing). Sums to 1."""
        act = self._active()
        times = np.array([max(self.hosts[h].ema_time, 1e-6) for h in act])
        inv = 1.0 / times
        shares = inv / inv.sum()
        return {h: float(s) for h, s in zip(act, shares)}

    def evict(self, host: int) -> None:
        if host not in self.evicted:
            self.evicted.append(host)
            self.hosts[host].flags = 0
