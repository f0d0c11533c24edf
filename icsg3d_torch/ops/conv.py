"""Conv3D(3x3x3, stride 1, SAME) with a fused epilogue, NDHWC in and out.

The port's counterpart of ``icsg3d_tpu/ops/lowc_conv.py::conv3d_lowc``
(conv + bias, K1 forward) and ``icsg3d_tpu/ops/pallas_conv.py::
conv3d_bn_relu_pallas`` (conv + folded BN + ReLU, K3): one entry point, the
epilogue chosen by name (see kernels/conv3d.py for the table).

A CUDA tensor launches the hand-written kernel (or the wrapper raises); a
CPU tensor takes the plain PyTorch version.  There is no other route.
"""

from __future__ import annotations

from typing import Optional

import torch

from icsg3d_torch.kernels import conv3d as _k


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
