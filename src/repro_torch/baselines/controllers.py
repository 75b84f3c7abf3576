"""Baseline controllers (see package docstring), ported from
`repro.baselines.controllers`. Simplified but faithful to each method's
*scheduling decision*; simplifications are noted inline and in DESIGN.md.

Where a decision reads params, it reads them as the reference does:

- SlimFit and RigL walk a params tree in `jax.tree.leaves` order, which
  sorts dict keys (`_sorted_leaves`, `_sorted_map`); the port's trees keep
  insertion order. SlimFit's norms are numpy float32 on the host, summed
  in that order, so a different summation cannot flip its threshold test.
- RigL's masks are drawn and updated in numpy, in flattened order, from
  the same `np.random.default_rng` streams. The port's params keep the
  JAX layouts (the ViT patch matrix [p*p*3, d] flattens in HWIO order).
- RigL mirrors ROADMAP C.9: the reference's jitted programs read
  `masks` at their trace, once per cache entry: the train step per
  (plan, batch signature), the fused step per bucket too, and on the
  compiled path the forward per batch signature and the stacked serving
  call per bucket. Pretraining traces its steps while `masks` is still
  None, so training stays dense in those entries, and an entry first met
  later (a new batch shape or bucket) trains masked; an eager `predict`
  applies the live masks; `flops_scale` is never read. The port's wrapped
  functions keep the masks each entry's first call saw (`traced_masks`,
  keyed by `train_loop.current_program`) and read the live masks outside
  one.
- Egeria's probes call `core.cka.cka` without `use_kernel`: plain CKA, as
  in the reference, whatever the session's `use_pallas`. Its reference
  features stay on the params' device in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core.cka import cka as _cka
from repro_torch.core.freeze_plan import LayerFreezePlan
from repro_torch.core.lazytune import LazyTune, LazyTuneConfig
from repro_torch.runtime.train_loop import current_program


def _sorted_leaves(tree) -> list:
    """The leaves of a params tree in `jax.tree.leaves` order (dict keys
    sorted); None is an empty tree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _sorted_leaves(v)]
    return [tree]


def _sorted_map(fn, tree, *rest):
    """`fn` over the matching leaves of `tree` and `rest`, called in
    `jax.tree.map` order (dict keys sorted): a stateful `fn` (one RNG drawn
    leaf after leaf) draws as the reference does. The result keeps
    `tree`'s structure."""
    if isinstance(tree, dict):
        done = {k: _sorted_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_sorted_map(fn, *vs) for vs in zip(tree, *rest, strict=True)]
    return fn(tree, *rest)


def _host(t) -> np.ndarray:
    """A float32 numpy copy of a tensor (or array) on the host."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", torch.float32)
    return np.array(t, np.float32)


class _Base:
    """Shared plumbing: optional LazyTune integration (paper Table V runs
    every baseline on top of LazyTune). Implements the runtime's
    controller protocol — baselines differ only in how they answer
    `should_trigger` and evolve `plan` in `round_finished`."""

    def __init__(self, model, with_lazytune: bool = False):
        self.model = model
        self.with_lazytune = with_lazytune
        self.lazytune = LazyTune(LazyTuneConfig())
        self.n_units = model.num_freeze_units
        self._plan = LayerFreezePlan(layers=(False,) * self.n_units)
        self.flops_scale = 1.0

    @property
    def plan(self):
        return self._plan

    def should_trigger(self, batches_available: int,
                       staleness: float = 0.0,
                       priority: int = 0) -> bool:
        # `staleness` / `priority` are accepted protocol-wide; the paper
        # baselines don't weigh them.
        if self.with_lazytune:
            return self.lazytune.should_trigger(batches_available)
        return batches_available >= 1

    def round_finished(self, iters: int, val_acc: float, params) -> None:
        if self.with_lazytune:
            self.lazytune.round_finished(iters, val_acc)

    def inference_served(self, logits) -> bool:
        if self.with_lazytune:
            self.lazytune.inference_arrived()
        return False

    def scenario_changed(self, params, probe) -> None:
        if self.with_lazytune:
            self.lazytune.scenario_changed()

    def start_scenario(self, reference_params, probe) -> None:
        pass

    def stats(self) -> dict:
        return {"frozen_fraction": sum(self._plan.layers) / self.n_units,
                "rounds_triggered": self.lazytune.state.rounds_triggered,
                "batches_needed": self.lazytune.state.batches_needed}


class StaticController(_Base):
    """Table VII S1..S4: trigger a round every `interval` data batches."""

    def __init__(self, model, interval: int = 5):
        super().__init__(model, with_lazytune=False)
        self.interval = interval

    def should_trigger(self, batches_available: int,
                       staleness: float = 0.0,
                       priority: int = 0) -> bool:
        return batches_available >= self.interval


class EgeriaController(_Base):
    """Egeria: layers grouped into modules; a module freezes only when all
    earlier modules are frozen AND its reference-model similarity has
    stabilized (strict front-to-back — the rigidity ETuner beats)."""

    def __init__(self, model, with_lazytune: bool = True,
                 module_size: int = 2, threshold: float = 0.01,
                 interval: int = 8):
        super().__init__(model, with_lazytune)
        self.module_size = module_size
        self.threshold = threshold
        self.interval = interval
        self._iters = 0
        self.reference_params = None
        self.probe = None
        self._hist: List[List[float]] = []

    def _reference_features(self, probe) -> list:
        return [f.to(torch.float32, copy=True) for f in
                self.model.features(self.reference_params, probe)]

    def start_scenario(self, reference_params, probe) -> None:
        self.reference_params = reference_params
        self.probe = probe
        self._ref_feats = self._reference_features(probe)
        self._hist = [[] for _ in range(self.n_units)]

    def round_finished(self, iters, val_acc, params) -> None:
        super().round_finished(iters, val_acc, params)
        if self.probe is None:
            return
        self._iters += iters
        if self._iters < self.interval:
            return
        self._iters = 0
        feats = self.model.features(params, self.probe)
        flags = list(self._plan.layers)
        n_modules = (self.n_units + self.module_size - 1) // self.module_size
        for m in range(n_modules):
            lo, hi = m * self.module_size, min((m + 1) * self.module_size,
                                               self.n_units)
            if all(flags[lo:hi]):
                continue
            # front-to-back: all previous modules must already be frozen
            if m > 0 and not all(flags[:lo]):
                break
            stable = True
            for i in range(lo, hi):
                v = float(_cka(feats[i], self._ref_feats[i]))
                self._hist[i].append(v)
                h = self._hist[i]
                if len(h) < 2 or abs(h[-1] - h[-2]) / max(abs(h[-2]), 1e-8) \
                        > self.threshold:
                    stable = False
            if stable:
                for i in range(lo, hi):
                    flags[i] = True
            break  # only the frontier module is evaluated per pass
        self._plan = LayerFreezePlan(layers=tuple(flags))

    def scenario_changed(self, params, probe) -> None:
        super().scenario_changed(params, probe)
        # Egeria restarts its module frontier on drift
        self._plan = LayerFreezePlan(layers=(False,) * self.n_units)
        self.probe = probe
        if self.reference_params is not None:
            self._ref_feats = self._reference_features(probe)
        self._hist = [[] for _ in range(self.n_units)]


class SlimFitController(_Base):
    """SlimFit: freeze layers whose relative weight-update magnitude
    ||dW||/||W|| falls below a threshold (the *indirect* signal ETuner's
    representational CKA improves upon)."""

    def __init__(self, model, with_lazytune: bool = True,
                 threshold: float = 2e-3, interval: int = 8,
                 max_frozen_frac: float = 0.9):
        super().__init__(model, with_lazytune)
        self.threshold = threshold
        self.interval = interval
        self.max_frozen_frac = max_frozen_frac
        self._prev_params = None
        self._iters = 0

    def _unit_leaves(self, params):
        # mirrors the model's freeze-unit structure: units list + head
        if "units" in params:
            units = list(params["units"]) + [params["head"]]
        elif "blocks" in params and isinstance(params["blocks"], list):
            units = [params.get("embed", params.get("patch"))] + \
                list(params["blocks"]) + [params["head"]]
        else:
            units = [params.get("embed")] + list(params["blocks"]) + \
                [params.get("head", params.get("final_ln"))]
        return units[:self.n_units]

    def round_finished(self, iters, val_acc, params) -> None:
        super().round_finished(iters, val_acc, params)
        self._iters += iters
        if self._prev_params is None:
            self._prev_params = _sorted_map(_host, params)
            return
        if self._iters < self.interval:
            return
        self._iters = 0
        flags = list(self._plan.layers)
        cur_units = self._unit_leaves(params)
        prev_units = self._unit_leaves(self._prev_params)
        budget = int(self.max_frozen_frac * self.n_units)
        for i, (cu, pu) in enumerate(zip(cur_units, prev_units)):
            if flags[i] or sum(flags) >= budget or cu is None:
                continue
            num = 0.0
            den = 0.0
            for c, p in zip(_sorted_leaves(cu), _sorted_leaves(pu)):
                c = _host(c)  # `p` is a host float32 copy already
                num += float(np.linalg.norm(c - p))
                den += float(np.linalg.norm(p)) + 1e-8
            if num / den < self.threshold:
                flags[i] = True
        self._plan = LayerFreezePlan(layers=tuple(flags))
        self._prev_params = _sorted_map(_host, params)

    def scenario_changed(self, params, probe) -> None:
        super().scenario_changed(params, probe)
        self._plan = LayerFreezePlan(layers=(False,) * self.n_units)
        self._prev_params = None


class RigLController(_Base):
    """RigL: sparse training at fixed sparsity with periodic magnitude-drop
    / gradient-regrow. Freezing-free; compute savings come from sparsity —
    the reference means to charge FLOPs * (1 - sparsity * realization),
    where realization < 1 models the hardware-underutilization the paper
    criticizes, but no cost reads `flops_scale` (ROADMAP C.9)."""

    def __init__(self, model, with_lazytune: bool = True,
                 sparsity: float = 0.5, realization: float = 0.5):
        super().__init__(model, with_lazytune)
        self.sparsity = sparsity
        self.flops_scale = 1.0 - sparsity * realization
        self.masks = None
        self.update_every = 4
        self._rounds = 0
        # cache entry -> the masks its programs apply: those of the
        # entry's first call, the reference's trace (module docstring)
        self.traced_masks = {}

    def wrap_model(self):
        """Model whose loss and predict apply the sparsity masks
        (straight-through): inside a cache entry the masks its first call
        saw, as the reference's traced program does, else the live
        masks."""
        base = self.model
        ctrl = self

        def masks():
            key = current_program()
            if key is None:
                return ctrl.masks
            return ctrl.traced_masks.setdefault(key, ctrl.masks)

        def masked(params):
            ms = masks()
            if ms is None:
                return params
            # `flops` runs the loss on meta params
            return _sorted_map(lambda p, m: p * m.to(p.device, p.dtype),
                               params, ms)

        def loss(params, batch, plan=None):
            return base.loss(masked(params), batch, plan)

        def predict(params, batch):
            return base.predict(masked(params), batch)

        return dataclasses.replace(base, loss=loss, predict=predict)

    def init_masks(self, params, rng: np.random.Generator):
        def mask(t):
            p = _host(t)
            if p.ndim < 2:
                m = np.ones_like(p, np.float32)
            else:
                k = int(p.size * (1 - self.sparsity))
                thr = np.partition(np.abs(p).ravel(), -k)[-k] if k \
                    else np.inf
                m = (np.abs(p) >= thr).astype(np.float32)
            return torch.from_numpy(m).to(t.device)

        self.masks = _sorted_map(mask, params)

    def round_finished(self, iters, val_acc, params) -> None:
        super().round_finished(iters, val_acc, params)
        self._rounds += 1
        if self.masks is None:
            self.init_masks(params, np.random.default_rng(0))
        elif self._rounds % self.update_every == 0:
            # drop lowest-|w| 10% of active, regrow same count randomly
            # (gradient-regrow approximated by random-regrow; noted)
            rng = np.random.default_rng(self._rounds)

            def update(t, mt):
                p = _host(t)
                m = _host(mt)
                if p.ndim < 2:
                    return mt
                act = np.flatnonzero(m.ravel())
                if act.size < 10:
                    return mt
                k = max(1, act.size // 10)
                mag = np.abs(p.ravel()[act])
                drop = act[np.argpartition(mag, k)[:k]]
                inact = np.flatnonzero(m.ravel() == 0)
                grow = rng.choice(inact, min(k, inact.size), replace=False) \
                    if inact.size else np.empty(0, int)
                flat = m.ravel().copy()
                flat[drop] = 0.0
                flat[grow] = 1.0
                return torch.from_numpy(flat.reshape(m.shape)).to(mt.device)

            self.masks = _sorted_map(update, params, self.masks)


class EkyaController(_Base):
    """Ekya: fixed-length windows; at each window boundary run a
    trial-and-error micro-profiling over candidate configs (here: freeze-
    prefix depths) and adopt the best. The profiling cost is charged by
    the caller from `profile_rounds` (the inefficiency ETuner removes)."""

    def __init__(self, model, with_lazytune: bool = True,
                 window_batches: int = 8,
                 candidate_prefixes=(0.0, 0.25, 0.5)):
        super().__init__(model, with_lazytune)
        self.window_batches = window_batches
        self.candidates = candidate_prefixes
        self._since_profile = 0
        self.profile_rounds = 0

    def should_trigger(self, batches_available: int,
                       staleness: float = 0.0,
                       priority: int = 0) -> bool:
        if self.with_lazytune:
            return self.lazytune.should_trigger(batches_available)
        return batches_available >= self.window_batches

    def round_finished(self, iters, val_acc, params) -> None:
        super().round_finished(iters, val_acc, params)
        self._since_profile += iters
        if self._since_profile >= self.window_batches:
            self._since_profile = 0
            self.profile_rounds += 1
            # micro-profiling: pretend to try each candidate (cost charged
            # from profile_rounds); adopt the candidate the cycle reaches
            # — a coarse stand-in for Ekya's thief scheduler.
            frac = self.candidates[self.profile_rounds % len(self.candidates)]
            k = int(self.n_units * frac)
            flags = tuple(i < k for i in range(self.n_units))
            self._plan = LayerFreezePlan(layers=flags)

    def scenario_changed(self, params, probe) -> None:
        super().scenario_changed(params, probe)
        self._plan = LayerFreezePlan(layers=(False,) * self.n_units)
        self._since_profile = 0
