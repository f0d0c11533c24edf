# Verbatim copy of icsg3d_tpu/data/binning.py.
"""Quantile binning of target properties into condition classes.

The reference conditions the VAE on a ``pd.qcut(property, 10)`` bin one-hot
(vae/data.py:39,88-91).  This module reproduces qcut's semantics in plain
numpy (rank-based quantile edges, right-closed intervals) so the condition
encoding carries over exactly, without a pandas dependency on the hot path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def quantile_bins(values: np.ndarray, n_bins: int = 10) -> np.ndarray:
    """Bin edges (length n_bins+1) matching pandas.qcut.

    qcut uses linear-interpolation quantiles of the data at probabilities
    linspace(0, 1, n_bins+1).
    """
    values = np.asarray(values, dtype=float)
    probs = np.linspace(0.0, 1.0, n_bins + 1)
    return np.quantile(values, probs, method="linear")


def assign_bins(values: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Assign each value to a bin index in [0, n_bins).

    Matches qcut: intervals are right-closed, (e[i], e[i+1]], with the lowest
    edge included in bin 0.  Values outside the edge range clip to the
    nearest bin (qcut would emit NaN; downstream needs a valid condition for
    every sample, so clipping is the documented divergence).
    """
    values = np.asarray(values, dtype=float)
    n_bins = len(edges) - 1
    # searchsorted with side='left' on the right-closed edges: a value equal
    # to an interior edge belongs to the lower bin.
    idx = np.searchsorted(edges[1:-1], values, side="left")
    return np.clip(idx, 0, n_bins - 1).astype(np.int32)


def one_hot(indices: np.ndarray, n_classes: int) -> np.ndarray:
    """Dense one-hot encoding (keras to_categorical equivalent)."""
    indices = np.asarray(indices, dtype=np.int64)
    out = np.zeros(indices.shape + (n_classes,), dtype=np.float32)
    np.put_along_axis(out, indices[..., None], 1.0, axis=-1)
    return out


def bin_and_encode(
    values: np.ndarray, n_bins: int = 10
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-shot helper: (bin indices, one-hot conditions, edges)."""
    edges = quantile_bins(values, n_bins)
    idx = assign_bins(values, edges)
    return idx, one_hot(idx, n_bins), edges
