"""Segmentation metrics matching the reference's Keras metric math.

Counterpart of icsg3d_tpu/ops/metrics.py (reference unet/unet.py:159-193).
y_true is one-hot, y_pred is softmax probabilities; round(clip(y_true *
y_pred)) counts a true positive wherever the true class's predicted
probability exceeds 0.5.  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""

from __future__ import annotations

import torch

KERAS_EPSILON = 1e-7


def _round_clip(x):
    return torch.round(torch.clamp(x, 0.0, 1.0))


def recall(y_true, y_pred):
    """r_m (unet/unet.py:159-167)."""
    tp = torch.sum(_round_clip(y_true * y_pred))
    possible = torch.sum(_round_clip(y_true))
    return tp / (possible + KERAS_EPSILON)


def weighted_recall(y_true, y_pred, num_classes: int = 95):
    """wr_m: recall excluding the background class (unet/unet.py:170-179)."""
    w = torch.ones(num_classes, device=y_pred.device)
    w[0] = 0.0
    tp = torch.sum(_round_clip(w * y_true * y_pred))
    possible = torch.sum(_round_clip(w * y_true))
    return tp / (possible + KERAS_EPSILON)


def precision(y_true, y_pred):
    """p_m (unet/unet.py:182-187)."""
    tp = torch.sum(_round_clip(y_true * y_pred))
    predicted = torch.sum(_round_clip(y_pred))
    return tp / (predicted + KERAS_EPSILON)


def f1_score(y_true, y_pred):
    """f1_m (unet/unet.py:189-193)."""
    p = precision(y_true, y_pred)
    r = recall(y_true, y_pred)
    return 2.0 * p * r / (p + r + KERAS_EPSILON)


# -- integer-label forms ------------------------------------------------------
# Mathematically identical to the one-hot forms above (y_true one-hot rows
# have exactly one 1), but never materialize the (B, d^3, C) one-hot.


def _p_true(labels, probs):
    """Probability of each voxel's true class.

    NOTE: the JAX gather CLAMPS out-of-range labels under jit (a label >=
    num_classes counts the last class's probability where the one-hot form
    counts zero), and torch's gather raises on them: callers must pre-clip
    labels to the class range, as prepare_unet_batch does.
    """
    return torch.gather(probs, -1, labels.long()[..., None])[..., 0]


def _count(labels, probs):
    # a fill on the device, not a host->device copy (which a CUDA graph
    # capture refuses)
    return torch.full((), float(labels.numel()), dtype=torch.float32,
                      device=probs.device)


def recall_from_labels(labels, probs):
    tp = torch.sum(torch.round(_p_true(labels, probs)))
    return tp / (_count(labels, probs) + KERAS_EPSILON)


def weighted_recall_parts(labels, probs):
    """(true positives, possible) of ``weighted_recall_from_labels``: sums
    over the batch, which add up across data-parallel ranks."""
    fg = labels != 0
    tp = torch.sum(torch.round(_p_true(labels, probs)) * fg)
    return tp, torch.sum(fg.float())


def weighted_recall_from_parts(tp, possible):
    return tp / (possible + KERAS_EPSILON)


def weighted_recall_from_labels(labels, probs):
    return weighted_recall_from_parts(*weighted_recall_parts(labels, probs))


def precision_from_labels(labels, probs):
    tp = torch.sum(torch.round(_p_true(labels, probs)))
    predicted = torch.sum(torch.round(torch.clamp(probs, 0.0, 1.0)))
    return tp / (predicted + KERAS_EPSILON)


def f1_parts(labels, probs):
    """(true positives, predicted positives, voxels) of
    ``f1_score_from_labels``: sums over the batch, which add up across
    data-parallel ranks."""
    # one shared true-positive count for precision and recall
    tp = torch.sum(torch.round(_p_true(labels, probs)))
    predicted = torch.sum(torch.round(torch.clamp(probs, 0.0, 1.0)))
    return tp, predicted, _count(labels, probs)


def f1_from_parts(tp, predicted, count):
    p = tp / (predicted + KERAS_EPSILON)
    r = tp / (count + KERAS_EPSILON)
    return 2.0 * p * r / (p + r + KERAS_EPSILON)


def f1_score_from_labels(labels, probs):
    return f1_from_parts(*f1_parts(labels, probs))
