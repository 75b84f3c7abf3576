"""Optimus-style non-linear accuracy-curve model fit with NNLS
(paper §IV-A1, following Peng et al., EuroSys'18 and the Ekya estimator).

We model validation accuracy after k cumulative training iterations as

    acc(k) = c0 - c1 / (k + 1) - c2 / (k + 1)^2 ,   c1, c2 >= 0

which is linear in (c0, c1, c2) over the basis [1, -1/(k+1), -1/(k+1)^2];
the non-negativity of (c1, c2) makes the curve monotonically increasing
and saturating — exactly the "improves quickly early, saturates late"
shape of paper Fig. 4. Fitting uses ``scipy.optimize.nnls`` (the solver
the paper cites). The fitted curve extrapolates the accuracy gain of
fine-tuning with a given amount of additional data, which LazyTune inverts
to size the next round (``batches_needed``). A copy of
`repro.core.curvefit`."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
from scipy.optimize import nnls


@dataclass
class AccuracyCurve:
    c0: float
    c1: float
    c2: float

    def predict(self, k) -> np.ndarray:
        k = np.asarray(k, np.float64)
        return self.c0 - self.c1 / (k + 1.0) - self.c2 / (k + 1.0) ** 2

    def gain(self, k_from: float, k_to: float) -> float:
        return float(self.predict(k_to) - self.predict(k_from))

    def iters_for_gain(self, k_now: float, target_gain: float,
                       k_max: float = 1e7) -> float:
        """Smallest k' > k_now with predict(k') - predict(k_now) >= gain,
        found by bisection on the monotone curve; returns k_max if the
        asymptote can't deliver the gain."""
        base = float(self.predict(k_now))
        if float(self.predict(k_max)) - base < target_gain:
            return k_max
        lo, hi = k_now, k_max
        for _ in range(64):
            mid = 0.5 * (lo + hi)
            if float(self.predict(mid)) - base >= target_gain:
                hi = mid
            else:
                lo = mid
        return hi


def fit_accuracy_curve(iters: Sequence[float],
                       accs: Sequence[float]) -> Optional[AccuracyCurve]:
    """NNLS fit. Needs >= 2 points; returns None when underdetermined."""
    iters = np.asarray(iters, np.float64)
    accs = np.asarray(accs, np.float64)
    if iters.size < 2:
        return None
    k1 = 1.0 / (iters + 1.0)
    # Basis chosen so all three coefficients are constrained >= 0.
    A = np.stack([np.ones_like(iters), -k1, -k1 ** 2], axis=1)
    # nnls constrains x >= 0; c0 >= 0 is natural for accuracy.
    try:
        x, _ = nnls(A, accs)
    except Exception:
        return None
    return AccuracyCurve(c0=float(x[0]), c1=float(x[1]), c2=float(x[2]))
