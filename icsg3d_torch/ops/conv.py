"""Conv3D(3x3x3, stride 1, SAME) with a fused epilogue, NDHWC in and out.

The port's counterpart of ``icsg3d_tpu/ops/lowc_conv.py::conv3d_lowc``
(conv + bias, K1 forward) and ``icsg3d_tpu/ops/pallas_conv.py::
conv3d_bn_relu_pallas`` (conv + folded BN + ReLU, K3): one entry point, the
epilogue chosen by name (see kernels/conv3d.py for the table).

``conv3d_same_diff`` is the differentiable form, the counterpart of
``conv_ndcs``'s custom_vjp (lowc_conv.py:524-570): forward on the conv
kernel (epilogue ``bias``), dx on the same kernel with flipped,
channel-swapped weights (K1 as dx), dW on the weight-gradient kernel (K2),
db a plain f32 sum of the cotangent.

A CUDA tensor launches the hand-written kernels (or the wrapper raises); a
CPU tensor takes their plain PyTorch versions.  There is no other route.
"""

from __future__ import annotations

from typing import Optional

import torch

from icsg3d_torch.kernels import conv3d as _k
from icsg3d_torch.kernels import conv3d_dw as _dw


def fold_batchnorm(gamma, beta, mean, var, eps: float):
    """Inference BatchNorm as a per-channel (scale, shift) in f32:
    scale = gamma / sqrt(var + eps), shift = beta - mean * scale."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    shift = beta.float() - mean.float() * scale
    return scale.contiguous(), shift.contiguous()


def conv3d_same(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    epilogue: str = "bias",
    out_dtype: Optional[torch.dtype] = None,
    slope: float = 0.3,
) -> torch.Tensor:
    """x: (B, D, H, W, Cin); w: (3, 3, 3, Cin, Cout) (DHWIO, any float
    dtype: it is cast to x.dtype as Flax casts its kernel to the compute
    dtype); bias/scale/shift: (Cout,).  Returns (B, D, H, W, Cout) in
    ``out_dtype`` (default x.dtype), accumulated in f32.
    """
    cout = w.shape[-1]
    if bias is None:
        bias = torch.zeros(cout, dtype=torch.float32, device=x.device)
    bias = bias.float().contiguous()
    if scale is not None:
        scale = scale.float().contiguous()
    if shift is not None:
        shift = shift.float().contiguous()
    w = w.to(x.dtype).contiguous()
    if x.is_cuda:
        return _k.conv3d_same_cuda(
            x.contiguous(), w, bias, scale, shift, epilogue, out_dtype, slope
        )
    if x.device.type == "cpu":
        return _k.conv3d_same_reference(
            x, w, bias, scale, shift, epilogue, out_dtype, slope
        )
    raise ValueError(f"conv3d_same runs on cuda or cpu tensors, not {x.device}")


def _route(t: torch.Tensor, cuda_fn, plain_fn):
    if t.is_cuda:
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"conv3d_same_diff runs on cuda or cpu tensors, not {t.device}")


class Conv3dSame(torch.autograd.Function):
    """y = conv(x, w) + bias with x in the compute dtype and the f32
    parameters w (3,3,3,Cin,Cout) and bias (Cout,) cast inside, as Flax
    casts its kernel (models/layers.py:181): dW and db then come back f32
    from the kernel's f32 accumulator instead of rounded to bf16."""

    @staticmethod
    def forward(ctx, x, w, bias):
        wc = w.to(x.dtype).contiguous()
        x = x.contiguous()
        ctx.save_for_backward(x, wc)
        return conv3d_same(x, wc, bias, epilogue="bias")

    @staticmethod
    def backward(ctx, g):
        x, wc = ctx.saved_tensors
        # the cotangent in the compute dtype, as lowc_conv.py:563 casts it
        g = g.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:  # not for data inputs (encoder Conv_0)
            dx = _route(g, _k.conv3d_dx_cuda, _k.conv3d_dx_reference)(g, wc)
        if ctx.needs_input_grad[1]:  # not for the frozen U-Net
            dw = _route(x, _dw.conv3d_dw_cuda, _dw.conv3d_dw_reference)(x, g)
        if ctx.needs_input_grad[2]:
            # upcast first: a bf16 sum over ~10^5 voxels loses the bias grad
            db = g.float().sum(dim=(0, 1, 2, 3))
        return dx, dw, db


def conv3d_same_diff(x: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """Differentiable Conv3D(3x3x3, SAME) + bias: x (B, D, H, W, Cin) in the
    compute dtype, w (3, 3, 3, Cin, Cout) and bias (Cout,) f32 parameters.
    Returns (B, D, H, W, Cout) in x.dtype."""
    return Conv3dSame.apply(x, w, bias)
