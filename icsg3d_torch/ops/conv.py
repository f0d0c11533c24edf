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

``conv3d_valid`` and ``Conv3dValid`` are the depth-VALID forms for the
halo-padded slabs of a depth-sharded conv (parallel/halo.py): the
counterpart of ``conv_ndcs_valid`` (lowc_conv.py:573-633).  The backward
runs the full-window dx kernel (all D + 2 input planes, halos included)
and K2 VALID.

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
    return _conv(_k.conv3d_same_cuda, _k.conv3d_same_reference, "conv3d_same",
                 x, w, bias, scale, shift, epilogue, out_dtype, slope)


def conv3d_valid(
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
    """``conv3d_same`` with a VALID depth window: x (B, D + 2, H, W, Cin), a
    depth slab padded with its two halo planes, gives (B, D, H, W, Cout)."""
    return _conv(_k.conv3d_valid_cuda, _k.conv3d_valid_reference, "conv3d_valid",
                 x, w, bias, scale, shift, epilogue, out_dtype, slope)


def _conv(cuda_fn, plain_fn, name, x, w, bias, scale, shift, epilogue, out_dtype,
          slope):
    cout = w.shape[-1]
    if bias is None:
        bias = torch.zeros(cout, dtype=torch.float32, device=x.device)
    bias = bias.float().contiguous()
    if scale is not None:
        scale = scale.float().contiguous()
    if shift is not None:
        shift = shift.float().contiguous()
    w = w.to(x.dtype).contiguous()
    fn = _route(x, cuda_fn, plain_fn, name)
    if x.is_cuda:
        x = x.contiguous()
    return fn(x, w, bias, scale, shift, epilogue, out_dtype, slope)


def _route(t: torch.Tensor, cuda_fn, plain_fn, name: str):
    if t.is_cuda:
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"{name} runs on cuda or cpu tensors, not {t.device}")


def _conv_function(name, conv, dx_fns, dw_fns, doc):
    """A ``torch.autograd.Function`` for one depth mode: y = conv(x, w) +
    bias with x in the compute dtype and the f32 parameters w (3,3,3,Cin,
    Cout) and bias (Cout,) cast inside, as Flax casts its kernel
    (models/layers.py:181), so dW and db come back f32 from the kernels'
    f32 accumulators instead of rounded to bf16.  ``dx_fns`` and ``dw_fns``
    are the (kernel, plain version) pairs of the backward."""

    class ConvFunction(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, bias):
            wc = w.to(x.dtype).contiguous()
            x = x.contiguous()
            ctx.save_for_backward(x, wc)
            return conv(x, wc, bias, epilogue="bias")

        @staticmethod
        def backward(ctx, g):
            x, wc = ctx.saved_tensors
            # the cotangent in the compute dtype, as lowc_conv.py:563 casts it
            g = g.to(x.dtype).contiguous()
            dx = dw = db = None
            if ctx.needs_input_grad[0]:  # not for data inputs (encoder Conv_0)
                dx = _route(g, *dx_fns, name)(g, wc)
            if ctx.needs_input_grad[1]:  # not for the frozen U-Net
                dw = _route(x, *dw_fns, name)(x, g)
            if ctx.needs_input_grad[2]:
                # upcast first: a bf16 sum over ~10^5 voxels loses the bias grad
                db = g.float().sum(dim=(0, 1, 2, 3))
            return dx, dw, db

    ConvFunction.__name__ = ConvFunction.__qualname__ = name
    ConvFunction.__doc__ = doc
    return ConvFunction


Conv3dSame = _conv_function(
    "Conv3dSame", conv3d_same, (_k.conv3d_dx_cuda, _k.conv3d_dx_reference),
    (_dw.conv3d_dw_cuda, _dw.conv3d_dw_reference),
    """The SAME conv + bias: forward on the conv kernel, dx on it with
    flipped weights (K1 as dx), dW on K2, db a f32 sum.""")

Conv3dValid = _conv_function(
    "Conv3dValid", conv3d_valid,
    (_k.conv3d_dx_valid_cuda, _k.conv3d_dx_valid_reference),
    (_dw.conv3d_dw_valid_cuda, _dw.conv3d_dw_valid_reference),
    """The depth-VALID conv + bias on a halo-padded slab x (B, D + 2, H, W,
    Cin) (lowc_conv.py:573-633): dx for all D + 2 input planes by the
    full-window kernel, so the halo planes' cotangents flow back through
    the exchange to the neighbours' slabs; dW by K2 VALID; db a f32 sum.""")


def conv3d_same_diff(x: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """Differentiable Conv3D(3x3x3, SAME) + bias: x (B, D, H, W, Cin) in the
    compute dtype, w (3, 3, 3, Cin, Cout) and bias (Cout,) f32 parameters.
    Returns (B, D, H, W, Cout) in x.dtype."""
    return Conv3dSame.apply(x, w, bias)


def conv3d_valid_diff(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Differentiable depth-VALID Conv3D + bias: x (B, D + 2, H, W, Cin) in
    the compute dtype, w (3, 3, 3, Cin, Cout) and bias (Cout,) f32
    parameters.  Returns (B, D, H, W, Cout) in x.dtype."""
    return Conv3dValid.apply(x, w, bias)
