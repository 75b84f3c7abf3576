"""LazyTune — the inter-tuning optimization (paper §IV-A, Algorithm 1).

State machine over three signals:

1. *Per-round accuracy trend* (Alg. 1 l.10-12): after each fine-tuning
   round, record (cumulative iterations, validation accuracy), refit the
   NNLS accuracy curve, and set ``batches_needed`` so the *next* round is
   predicted to gain as much accuracy as the current round did.
2. *Inference arrival pattern* (Alg. 1 l.13-18): every inference request
   decays ``batches_needed`` via the logarithmic backoff
   d <- d * (1 - 1/log(d)) so request bursts force frequent updates.
3. *Scenario change* (Alg. 1 l.19-21): reset ``batches_needed`` to 1
   (immediate fine-tuning) for fast adaptation.

The controller is pure-Python bookkeeping — it *schedules* the train
steps, it never sits inside them. A copy of `repro.core.lazytune`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.curvefit import AccuracyCurve, fit_accuracy_curve


@dataclass
class LazyTuneConfig:
    initial_batches_needed: float = 1.0
    max_batches_needed: float = 64.0
    iters_per_batch: int = 1          # training iterations per data batch
    min_gain_floor: float = 1e-4      # treat gains below this as saturation


@dataclass
class LazyTuneState:
    batches_needed: float = 1.0
    cum_iters: float = 0.0
    history_iters: List[float] = field(default_factory=list)
    history_accs: List[float] = field(default_factory=list)
    last_gain: Optional[float] = None
    curve: Optional[AccuracyCurve] = None
    rounds_triggered: int = 0
    rounds_delayed: int = 0


class LazyTune:
    def __init__(self, config: LazyTuneConfig = LazyTuneConfig()):
        self.cfg = config
        self.state = LazyTuneState(batches_needed=config.initial_batches_needed)

    # -- Alg.1 line 2: trigger predicate ------------------------------------
    def should_trigger(self, batches_available: int) -> bool:
        trig = batches_available >= self.state.batches_needed
        if not trig and batches_available > 0:
            self.state.rounds_delayed += 1
        return trig

    # -- Alg.1 lines 10-12: after a round, re-estimate batches_needed -------
    def round_finished(self, iters_this_round: int, val_acc: float) -> None:
        st = self.state
        st.rounds_triggered += 1
        prev_acc = st.history_accs[-1] if st.history_accs else None
        st.cum_iters += iters_this_round
        st.history_iters.append(st.cum_iters)
        st.history_accs.append(val_acc)
        if prev_acc is not None:
            st.last_gain = val_acc - prev_acc
        st.curve = fit_accuracy_curve(st.history_iters, st.history_accs)
        st.batches_needed = self._estimate_batches_needed()

    def _estimate_batches_needed(self) -> float:
        st, cfg = self.state, self.cfg
        if st.curve is None or st.last_gain is None:
            return st.batches_needed  # not enough data yet
        target_gain = max(st.last_gain, cfg.min_gain_floor)
        k_next = st.curve.iters_for_gain(st.cum_iters, target_gain)
        need = (k_next - st.cum_iters) / max(cfg.iters_per_batch, 1)
        return float(min(max(need, 1.0), cfg.max_batches_needed))

    # -- Alg.1 lines 15-18: logarithmic decay on inference arrival ----------
    def inference_arrived(self) -> None:
        d = self.state.batches_needed
        if d > math.e:  # log(d) > 1 required for a positive decrease
            d = d * (1.0 - 1.0 / math.log(d))
        else:
            d = 1.0
        self.state.batches_needed = max(1.0, d)

    # -- Alg.1 lines 20-21: scenario change reset ----------------------------
    def scenario_changed(self) -> None:
        self.state.batches_needed = self.cfg.initial_batches_needed
        # accuracy history restarts: the curve of the old scenario does not
        # predict the new one (paper Fig. 4 shows the post-change drop).
        self.state.history_iters.clear()
        self.state.history_accs.clear()
        self.state.curve = None
        self.state.last_gain = None
