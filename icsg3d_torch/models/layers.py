"""Building blocks of the 3D conv models, eval mode, NDHWC activations.

Parameters keep Flax's names and layouts so weights.py maps a Flax tree
onto them mechanically: a conv holds ``kernel`` (k, k, k, Cin, Cout) and
``bias``; a dense layer ``kernel`` (in, out) and ``bias``; a BatchNorm
``weight``/``bias`` (Flax scale/bias) and the ``running_mean`` /
``running_var`` buffers (Flax batch_stats mean/var).

Keras-parity notes (as in icsg3d_tpu/models/layers.py): BatchNorm uses
epsilon 1e-3, and both block orders of the reference exist: U-Net blocks
are Conv -> ReLU -> BN, VAE blocks Conv -> BN -> LeakyReLU.  In eval mode
a whole block is one call of the fused conv kernel (ops/conv.py).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from icsg3d_torch.ops.conv import conv3d_same, fold_batchnorm

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
    """Inference BatchNorm state; applied folded into a conv epilogue."""

    def __init__(self, channels: int, eps: float = KERAS_BN_EPSILON):
        super().__init__()
        self.eps = eps
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


def conv_block(
    x: torch.Tensor,
    conv: Conv3d,
    bn: BatchNorm,
    order: str = "relu_bn",
    act: str = "relu",
    slope: float = 0.3,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Conv3D(3x3x3, SAME) + BatchNorm + activation as one fused call.

    order="relu_bn": conv -> relu -> bn   (U-Net, unet/unet.py:276-278)
    order="bn_act":  conv -> bn -> act    (VAE,   vae/lattice_vae.py:173-175)
    with act "relu" or "leaky" (slope ``slope``) for "bn_act".
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
    scale, shift = bn.fold()
    return conv3d_same(
        x, conv.kernel, conv.bias, scale=scale, shift=shift,
        epilogue=epilogue, out_dtype=out_dtype, slope=slope,
    )


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """Flax/Keras leaky ReLU: x if x >= 0 else slope * x."""
    return torch.where(x >= 0, x, slope * x)


def max_pool_3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """2x2x2 max pool, stride 2, VALID (Keras MaxPool3D(strides=(2,2,2)))."""
    b, d, h, w, c = x.shape
    d, h, w = d // window, h // window, w // window
    x = x[:, : d * window, : h * window, : w * window]
    x = x.reshape(b, d, window, h, window, w, window, c)
    return x.amax(dim=(2, 4, 6))


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
