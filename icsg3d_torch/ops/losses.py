"""Loss functions matching the reference's Keras losses, in torch.

Counterpart of icsg3d_tpu/ops/losses.py, function for function.  All
losses take float32 logits/targets and reduce per sample first, so a
batch mean is the same whatever the batch split.

One documented numerical deviation (as in the JAX package):
binary_crossentropy_from_logits uses the stable log-sum-exp form instead
of Keras's clipped-probability BCE, so at saturation (|logit| > ~16) the
per-element loss keeps growing with a live gradient where Keras plateaus.
"""

from __future__ import annotations

import torch

KERAS_EPSILON = 1e-7  # K.epsilon()


def _spatial_mean(t: torch.Tensor) -> torch.Tensor:
    return t.mean(dim=tuple(range(1, t.dim())))


def weighted_categorical_crossentropy(logits, labels_onehot, class_weights):
    """Per-voxel class-weighted CCE, mean over spatial dims.

    Matches weighted_categorical_crossentropy (unet/unet.py:196-221): probs
    renormalized, clipped to [eps, 1-eps], loss = -sum(y*log(p)*w) per
    voxel, mean over (D,H,W).  Returns (B,) per-sample losses.
    """
    probs = torch.softmax(logits.float(), dim=-1)
    probs = probs.clamp(KERAS_EPSILON, 1.0 - KERAS_EPSILON)
    w = torch.as_tensor(class_weights, dtype=torch.float32, device=logits.device)
    per_voxel = -(labels_onehot * torch.log(probs) * w).sum(dim=-1)
    return _spatial_mean(per_voxel)


def weighted_categorical_crossentropy_from_labels(logits, labels, class_weights):
    """Integer-label form of weighted_categorical_crossentropy: a gather of
    the true class's log-prob and weight, no one-hot.  Returns (B,)."""
    w = torch.as_tensor(class_weights, dtype=torch.float32, device=logits.device)
    if w.shape[0] != logits.shape[-1]:
        raise ValueError(
            f"class_weights has {w.shape[0]} entries for "
            f"{logits.shape[-1]} classes"
        )
    probs = torch.softmax(logits.float(), dim=-1)
    probs = probs.clamp(KERAS_EPSILON, 1.0 - KERAS_EPSILON)
    labels = labels.long()
    p_true = torch.gather(probs, -1, labels[..., None])[..., 0]
    per_voxel = -torch.log(p_true) * w[labels]
    return _spatial_mean(per_voxel)


def binary_crossentropy_from_logits(logits, targets):
    """Keras binary_crossentropy (mean over all non-batch axes), stable form.

    Reference: the U-Net 'sig' head loss (unet/unet.py:256).
    """
    logits = logits.float()
    targets = targets.float()
    per_elem = (torch.clamp(logits, min=0.0) - logits * targets
                + torch.log1p(torch.exp(-logits.abs())))
    return _spatial_mean(per_elem)


def mse_flat(x, y):
    """Keras mse over flattened tensors: mean square error per sample
    (vae/lattice_vae.py:232-233).  Returns (B,)."""
    x = x.float().reshape(x.shape[0], -1)
    y = y.float().reshape(y.shape[0], -1)
    return ((x - y) ** 2).mean(dim=-1)


def kld_gaussian(z_mean, z_log_var):
    """KL(q(z|x) || N(0, I)) per sample (vae/lattice_vae.py:235-239):
    -0.5 * sum(1 + log_var - mu^2 - exp(log_var))."""
    z_mean = z_mean.float()
    z_log_var = z_log_var.float()
    kl = 1.0 + z_log_var - torch.square(z_mean) - torch.exp(z_log_var)
    return -0.5 * kl.sum(dim=-1)


def perceptual_feature_loss(feats_true, feats_pred, weights):
    """DFC perceptual loss: weighted per-layer feature MSE, flattened
    (vae/lattice_vae.py:257-270).  feats_*: sequences of (B, ...)
    activations.  Returns (B,)."""
    if not (len(feats_true) == len(feats_pred) == len(weights)):
        # zip would silently truncate, dropping taps from the loss
        raise ValueError(
            f"{len(feats_true)}/{len(feats_pred)} feature taps vs "
            f"{len(weights)} weights"
        )
    total = 0.0
    for h1, h2, w in zip(feats_true, feats_pred, weights):
        h1 = h1.float().reshape(h1.shape[0], -1)
        h2 = h2.float().reshape(h2.shape[0], -1)
        total = total + w * torch.square(h1 - h2).mean(dim=-1)
    return total


def mse_loss(preds, targets):
    """Scalar MSE (CGCNN regression, train_cgcnn.py:89): per-sample mean
    first, then batch mean."""
    p = preds.float().reshape(preds.shape[0], -1)
    t = targets.float().reshape(preds.shape[0], -1)
    return ((p - t) ** 2).mean(dim=-1).mean()


def mae(preds, targets):
    p = preds.float().reshape(preds.shape[0], -1)
    t = targets.float().reshape(preds.shape[0], -1)
    return (p - t).abs().mean(dim=-1).mean()
