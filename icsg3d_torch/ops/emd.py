# Verbatim copy of icsg3d_tpu/ops/emd.py.
"""Earth mover's distance between atom sets (evaluation metric).

Reference: eval.py:45-53 — Hungarian assignment on the RECTANGULAR
pairwise distance matrix (scipy matches min(len) pairs; no padding
anywhere in the reference), summed matched distance divided by
min(len(pred), len(true)).  An earlier version here zero-padded the
smaller set and divided by max — a genuinely different metric that
charged unmatched atoms their distance to the coordinate origin (a
frame-dependent penalty) and was NOT comparable to reference numbers.

Host-side scipy (the O(n^3) Hungarian solve on <100 atoms is
microseconds; not worth a device kernel).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist


def earth_movers_distance(mu_pred: np.ndarray, mu_true: np.ndarray) -> float:
    """Reference emd (eval.py:45-53): assignment cost / min set size.

    Both sets empty -> 0.0.  Exactly one side empty -> NaN (the
    reference's 0/0; callers should count these separately rather than
    average them — see apps/evaluate.py).
    """
    mu_pred = np.atleast_2d(np.asarray(mu_pred, dtype=float))
    mu_true = np.atleast_2d(np.asarray(mu_true, dtype=float))
    if mu_pred.size == 0 and mu_true.size == 0:
        return 0.0
    if mu_pred.size == 0 or mu_true.size == 0:
        return float("nan")
    if mu_pred.shape[1] != mu_true.shape[1]:
        # an implicit broadcast here once fabricated points like [x,x,x]
        # from a column vector and returned a meaningless finite value
        raise ValueError(
            f"point dims differ: {mu_pred.shape[1]} vs {mu_true.shape[1]}"
        )
    d = cdist(mu_pred, mu_true)
    row, col = linear_sum_assignment(d)
    return float(d[row, col].sum() / min(len(mu_pred), len(mu_true)))
