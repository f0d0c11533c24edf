# Verbatim copy of icsg3d_tpu/train/common.py.
"""Helpers shared by the three training drivers."""

from __future__ import annotations

import numpy as np


def mean_metrics(history):
    """Mean of each metric over a list of per-step metric dicts.

    Scalar metrics reduce to python floats; vector metrics (e.g. per-class
    CE sums/counts) mean elementwise and stay JSON-safe lists.
    """
    if not history:
        return {}
    out = {}
    for k in history[0]:
        m = np.mean(np.stack([np.asarray(h[k]) for h in history]), axis=0)
        out[k] = float(m) if m.ndim == 0 else m.astype(float).tolist()
    return out
