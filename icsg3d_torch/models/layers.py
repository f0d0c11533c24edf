"""Building blocks of the 3D conv models, NDHWC activations.

Parameters keep Flax's names and layouts so weights.py maps a Flax tree
onto them mechanically: a conv holds ``kernel`` (k, k, k, Cin, Cout) and
``bias``; a dense layer ``kernel`` (in, out) and ``bias``; a BatchNorm
``weight``/``bias`` (Flax scale/bias) and the ``running_mean`` /
``running_var`` buffers (Flax batch_stats mean/var).

Keras-parity notes (as in icsg3d_tpu/models/layers.py): BatchNorm uses
epsilon 1e-3, and both block orders of the reference exist: U-Net blocks
are Conv -> ReLU -> BN, VAE blocks Conv -> BN -> LeakyReLU.  In eval mode
a whole block is one call of the fused conv kernel (ops/conv.py).  In
training a block is the differentiable conv (epilogue ``bias``), then a
batch-statistics BatchNorm in plain torch with Flax's numerics (see
``BatchNorm.train_forward``), then the activation.

With a (data, spatial) ``mesh`` (parallel/mesh.py) the conv of a block runs
depth-sharded (parallel/halo.conv_sharded) whenever the batch divides by
``data`` and the depth by ``spatial``, and the SAME kernel otherwise, as
the JAX package's ``SpatialMajorConv`` does for indivisible shapes
(models/layers.py:134-149).  BatchNorm and the activation stay global.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from icsg3d_torch.ops.conv import conv3d_same, conv3d_same_diff, fold_batchnorm
from icsg3d_torch.parallel.halo import conv_sharded, mesh_divides
from icsg3d_torch.parallel.mesh import Mesh

KERAS_BN_MOMENTUM = 0.99
KERAS_BN_EPSILON = 1e-3


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    """Flax's default kernel init: a normal truncated at +-2 std, scaled so
    the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(
            t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
        )


class Conv3d(nn.Module):
    """Flax ``nn.Conv`` parameters: kernel (k, k, k, Cin, Cout), bias."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel_size
        self.kernel = nn.Parameter(torch.empty(k, k, k, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        lecun_normal_(self.kernel, k * k * k * cin, generator)

    def diff(self, x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
        """The differentiable 3x3x3 conv + bias, depth-sharded over ``mesh``
        where it divides x."""
        if mesh is not None and mesh_divides(x, mesh):
            return conv_sharded(x, self.kernel, self.bias, mesh)
        return conv3d_same_diff(x, self.kernel, self.bias)

    def pointwise(self, x: torch.Tensor) -> torch.Tensor:
        """A 1x1x1 conv in f32 (the U-Net heads): a plain matmul."""
        cin, cout = self.kernel.shape[-2:]
        return x.float() @ self.kernel.reshape(cin, cout) + self.bias


class Dense(nn.Module):
    """Flax ``nn.Dense`` parameters: kernel (in, out), bias."""

    def __init__(self, fin: int, fout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fin, fout))
        self.bias = nn.Parameter(torch.zeros(fout))
        lecun_normal_(self.kernel, fin, generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        # Flax promotes input, kernel and bias to the compute dtype
        return x.to(dtype) @ self.kernel.to(dtype) + self.bias.to(dtype)


class BatchNorm(nn.Module):
    """BatchNorm state.  Eval mode folds it into a conv epilogue (``fold``)
    or applies the running statistics (``eval_forward``); training
    normalises with the batch statistics (``train_forward``)."""

    def __init__(self, channels: int, eps: float = KERAS_BN_EPSILON,
                 momentum: float = KERAS_BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def fold(self):
        """(scale, shift) in f32 with y = scale * x + shift."""
        return fold_batchnorm(
            self.weight, self.bias, self.running_mean, self.running_var,
            self.eps,
        )

    def _normalize(self, x, mean, var, dtype):
        # flax _normalize: (x - mean) * (rsqrt(var + eps) * scale) + bias,
        # in f32, cast to the layer's dtype
        y = x.float() - mean
        y = y * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(dtype)

    def eval_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Running-statistics BN with Flax's formula, out in x.dtype."""
        return self._normalize(x, self.running_mean, self.running_var, x.dtype)

    def train_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Batch-statistics BN over all but the channel axis, out in x.dtype;
        updates the running statistics.

        Flax's numerics (flax/linen/normalization.py, flax 0.12.3,
        ``_compute_stats`` with ``use_fast_variance``): the statistics are
        f32, var = max(0, E[x^2] - E[x]^2), and the BIASED variance both
        normalises and enters the running variance (torch's own
        batch_norm would put the unbiased one there):
        ra = momentum * ra + (1 - momentum) * batch.
        """
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=dims)
        var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return self._normalize(x, mean, var, x.dtype)


def conv_block(
    x: torch.Tensor,
    conv: Conv3d,
    bn: BatchNorm,
    order: str = "relu_bn",
    act: str = "relu",
    slope: float = 0.3,
    out_dtype: Optional[torch.dtype] = None,
    train: bool = False,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Conv3D(3x3x3, SAME) + BatchNorm + activation.

    order="relu_bn": conv -> relu -> bn   (U-Net, unet/unet.py:276-278)
    order="bn_act":  conv -> bn -> act    (VAE,   vae/lattice_vae.py:173-175)
    with act "relu" or "leaky" (slope ``slope``) for "bn_act".

    Eval mode is one fused kernel call.  ``train=True`` runs the
    differentiable conv and batch-statistics BN (updating the running
    statistics); its output is in x.dtype and ``out_dtype`` is ignored.
    ``mesh`` shards the conv in depth where it divides x (module note).
    """
    if order == "relu_bn":
        if act != "relu":
            raise ValueError(f"order 'relu_bn' takes act 'relu', got {act!r}")
        epilogue = "relu_affine"
    elif order == "bn_act":
        epilogue = {"leaky": "affine_leaky", "relu": "affine_relu"}.get(act)
        if epilogue is None:
            raise ValueError(f"unknown act {act!r}")
    else:
        raise ValueError(f"unknown order {order!r}")
    if train:
        y = conv.diff(x, mesh)
        if order == "relu_bn":
            return bn.train_forward(torch.relu(y))
        y = bn.train_forward(y)
        return leaky_relu(y, slope) if act == "leaky" else torch.relu(y)
    scale, shift = bn.fold()
    fused = dict(scale=scale, shift=shift, epilogue=epilogue, out_dtype=out_dtype,
                 slope=slope)
    if mesh is not None and mesh_divides(x, mesh):
        return conv_sharded(x, conv.kernel, conv.bias, mesh, **fused)
    return conv3d_same(x, conv.kernel, conv.bias, **fused)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """Flax/Keras leaky ReLU: x if x >= 0 else slope * x."""
    return torch.where(x >= 0, x, slope * x)


def max_pool_3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """2x2x2 max pool, stride 2, VALID (Keras MaxPool3D(strides=(2,2,2))).

    One ``max_pool3d`` call on the channels_last_3d NCDHW view (no copy).
    Its gradient goes to ONE element of each window, the first maximum in
    (d, h, w) window order, as the select-and-scatter gradient of JAX's
    ``nn.max_pool`` does; ``amax`` would split it among tied maxima, which
    bf16 activations produce.
    """
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), window, window)
    return y.permute(0, 2, 3, 4, 1)


def upsample_3d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbor upsampling (Keras UpSampling3D)."""
    b, d, h, w, c = x.shape
    x = x[:, :, None, :, None, :, None, :]
    x = x.expand(b, d, factor, h, factor, w, factor, c)
    return x.reshape(b, d * factor, h * factor, w * factor, c)


def broadcast_condition(cond: torch.Tensor, spatial_shape: Sequence[int],
                        repeat: int = 1) -> torch.Tensor:
    """Tile a (B, C) condition over the grid -> (B, *spatial, C*repeat).

    ``repeat`` reproduces the reference's 4x channel-repeated condition
    block (config.VAEConfig.cond_repeat).
    """
    b, c = cond.shape
    if repeat != 1:
        cond = cond.repeat(1, repeat)
        c = c * repeat
    shape = (b,) + (1,) * len(spatial_shape) + (c,)
    return cond.reshape(shape).expand((b,) + tuple(spatial_shape) + (c,))
