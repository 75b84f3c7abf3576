"""SimFreeze — the intra-tuning optimization (paper §IV-B, Algorithm 1),
ported from `repro.core.simfreeze`.

Tracks per-layer CKA between the model under fine-tuning and the frozen
*reference* (initial) model, on a fixed per-scenario probe batch (the first
training batch of the scenario):

- every ``freeze_interval`` training iterations, recompute CKA for each
  *active* layer; a layer whose CKA variation rate is below ``cka_threshold``
  (default 1%) is converged -> freeze (Alg. 1 l.4-9);
- on a scenario change, recompute CKA for each *frozen* layer on the new
  scenario's probe batch; if it moved by more than the threshold, unfreeze
  (Alg. 1 l.22-26).

The reference features stay on the model's device (the JAX version pulls
them to host numpy; the values are the same). `features_fn` returns L+1
activations for an L-block ViT while the model has L+2 freeze units; the
zip in `_all_cka` leaves the last unit (the head) without a CKA, as in
the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from repro_torch.core.cka import cka as _cka
from repro_torch.core.freeze_plan import FreezePlan, LayerFreezePlan


@dataclass
class SimFreezeConfig:
    cka_threshold: float = 0.01      # 1% variation rate (paper default)
    freeze_interval: int = 200       # iterations between freezing passes
    min_history: int = 2             # CKA points before a freeze decision
    never_freeze_head: bool = True   # classifier/lm head keeps training
    use_kernel: bool = False         # route CKA through the CKA kernel


@dataclass
class SimFreezeState:
    frozen: List[bool]
    cka_history: List[List[float]]   # per layer
    iters_since_pass: int = 0
    freezes: int = 0
    unfreezes: int = 0
    cka_flops: float = 0.0           # bookkeeping for the overhead account


def _probe_flops(f) -> float:
    """The cost-model FLOPs of one layer's CKA, as the JAX version counts
    them: 2 * numel * min(rows, features) with rows = numel / features."""
    d = f.shape[-1]
    numel = f.numel()
    return 2.0 * numel * min(numel // d, d)


class SimFreeze:
    """`features_fn(params, probe_batch) -> [acts per layer]` must present
    layers in execution order; layer i here is freeze-unit i of the model
    (groups for scanned LMs, layers for unrolled paper models)."""

    def __init__(self, num_units: int, features_fn: Callable,
                 config: Optional[SimFreezeConfig] = None,
                 scan_mode: bool = False):
        self.cfg = config if config is not None else SimFreezeConfig()
        self.num_units = num_units
        self.features_fn = features_fn
        self.scan_mode = scan_mode
        self.state = SimFreezeState(
            frozen=[False] * num_units,
            cka_history=[[] for _ in range(num_units)])
        self.reference_params = None
        self.probe_batch = None
        self._ref_feats = None

    # -- lifecycle -----------------------------------------------------------
    def start_scenario(self, reference_params, probe_batch) -> None:
        """Set the reference model and per-scenario CKA probe data
        (paper: 'the first arrived training data batch')."""
        self.reference_params = reference_params
        self.probe_batch = probe_batch
        self._ref_feats = [f.float() for f in
                           self.features_fn(reference_params, probe_batch)]
        for h in self.state.cka_history:
            h.clear()

    # -- Alg.1 l.4-9: periodic freezing pass ----------------------------------
    def maybe_freeze(self, params, iters_elapsed: int) -> bool:
        """Returns True if the plan changed."""
        st = self.state
        st.iters_since_pass += iters_elapsed
        if st.iters_since_pass < self.cfg.freeze_interval:
            return False
        st.iters_since_pass = 0
        return self._freeze_pass(params)

    def _layer_cka(self, params, unit: int) -> float:
        feats = self.features_fn(params, self.probe_batch)
        return float(_cka(feats[unit], self._ref_feats[unit],
                          use_kernel=self.cfg.use_kernel))

    def _all_cka(self, params) -> List[float]:
        feats = self.features_fn(params, self.probe_batch)
        vals = []
        for f, rf in zip(feats, self._ref_feats):
            vals.append(float(_cka(f, rf, use_kernel=self.cfg.use_kernel)))
            self.state.cka_flops += _probe_flops(f)
        return vals

    def _freeze_pass(self, params) -> bool:
        st, cfg = self.state, self.cfg
        vals = self._all_cka(params)
        changed = False
        for i, v in enumerate(vals):
            st.cka_history[i].append(v)
            if st.frozen[i]:
                continue  # paper §III-B: stay frozen within a scenario
            h = st.cka_history[i]
            if len(h) < cfg.min_history:
                continue
            prev = h[-2]
            variation = abs(v - prev) / max(abs(prev), 1e-8)
            if variation <= cfg.cka_threshold:
                st.frozen[i] = True
                st.freezes += 1
                changed = True
        return changed

    # -- Alg.1 l.22-26: unfreezing on scenario change -------------------------
    def scenario_changed(self, params, new_probe_batch) -> bool:
        """Re-evaluate frozen layers on the new scenario's probe data."""
        st, cfg = self.state, self.cfg
        old_vals = {i: st.cka_history[i][-1]
                    for i in range(self.num_units)
                    if st.frozen[i] and st.cka_history[i]}
        self.probe_batch = new_probe_batch
        self._ref_feats = [f.float() for f in
                           self.features_fn(self.reference_params, new_probe_batch)]
        vals = self._all_cka(params)
        changed = False
        for i in range(self.num_units):
            if not st.frozen[i]:
                continue
            old = old_vals.get(i)
            if old is None:
                continue
            variation = abs(vals[i] - old) / max(abs(old), 1e-8)
            if variation > cfg.cka_threshold:
                st.frozen[i] = False
                st.unfreezes += 1
                changed = True
        for h in st.cka_history:
            h.clear()
        for i, v in enumerate(vals):
            st.cka_history[i].append(v)
        return changed

    # -- plan export -----------------------------------------------------------
    def plan(self):
        if self.scan_mode:
            return FreezePlan(groups=tuple(self.state.frozen))
        flags = list(self.state.frozen)
        if self.cfg.never_freeze_head:
            flags = flags[:-1] + [False] if len(flags) == self.num_units else flags
        return LayerFreezePlan(layers=tuple(flags))

    def frozen_fraction(self) -> float:
        return sum(self.state.frozen) / max(self.num_units, 1)
