# Verbatim copy of icsg3d_tpu/data/class_weights.py.
"""Inverse-frequency class weights for the U-Net segmentation loss.

Reference: unet/get_weights.py — per-class voxel counts over the *training*
species matrices; weight = total/count, infinities (absent classes) -> 0.
The reference computed this by re-reading every .npy from disk; here it is a
single bincount over the packed species array.
"""

from __future__ import annotations

import numpy as np


def inverse_frequency_weights(
    species: np.ndarray, n_classes: int = 95
) -> np.ndarray:
    """Class weights from an integer species array of any shape.

    species: integer atomic-number labels (0 = background).
    Returns float32 (n_classes,) with weight[c] = total_voxels / count[c],
    0 for absent classes (get_weights.py:29-33).  The zero class keeps its
    inverse-frequency weight here; the training driver zeroes it explicitly
    (train_unet.py:117-118) so the policy is visible at the call site.
    """
    counts = np.bincount(
        np.asarray(species).astype(np.int64).ravel(), minlength=n_classes
    )[:n_classes].astype(np.float64)
    total = counts.sum()
    with np.errstate(divide="ignore"):
        weights = total / counts
    weights[~np.isfinite(weights)] = 0.0
    return weights.astype(np.float32)
