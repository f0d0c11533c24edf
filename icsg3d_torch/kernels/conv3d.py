"""3x3x3 conv with a fused epilogue, SAME or depth-VALID: the Hopper kernel,
its build and loader, and its plain PyTorch versions.

Replaces two Pallas TPU kernels of the JAX package:

- K1 forward, ``icsg3d_tpu/ops/lowc_conv.py::_kernel`` (conv + bias; the
  spatial-major conv behind ``SpatialMajorConv`` under ``--layout ndcs``);
- K3, ``icsg3d_tpu/ops/pallas_conv.py::_conv_kernel`` (conv + folded
  inference BN + ReLU), whose epilogue is what every eval-mode conv block
  of the VAE and the U-Net computes.

The kernel (``icsg3d_torch/csrc/conv3d.cu``) is an implicit GEMM on NDHWC
data with M = B*D*H*W voxels, N = Cout, K = 27*Cin, f32 accumulation and
zero padding by zero-filling predicated loads.  bf16 input runs on
mma.sync tensor cores fed by a 3-stage cp.async ring; f32 input on a plain
FMA kernel.  At the U-Net's widths the conv is bound by tensor-core
throughput, which only wgmma reaches in full (see the note in the .cu
file).  The 128x64 block tile, the absence of an im2col buffer and the
fused epilogue keep device-memory bytes to one read of x per block column
and one write of the output.

Epilogues (``acc`` = conv sum + bias, all in f32):

=============  =================================  ==========================
name           formula                            serves
=============  =================================  ==========================
bias           acc                                VAE encoder's last conv
affine_leaky   leaky(scale*acc + shift, slope)    VAE conv blocks
relu_affine    scale*relu(acc) + shift            U-Net blocks (conv->ReLU->BN)
affine_relu    relu(scale*acc + shift)            K3; VAE output head (f32)
=============  =================================  ==========================

The same kernel computes K1 run as dx, the input gradient of the conv
(``icsg3d_tpu/ops/lowc_conv.py:549-567``): a SAME conv of the cotangent
with spatially flipped, channel-swapped weights and zero bias
(``conv3d_dx_cuda``).

Depth modes (K1's ``depth_valid``, lowc_conv.py:224-231, 573-633), for the
halo-padded slabs of a depth-sharded conv (parallel/halo.py):

- VALID, ``conv3d_valid_cuda``: x has D + 2 planes, the output D; every
  epilogue;
- full, ``conv3d_dx_valid_cuda``: the input gradient of a VALID conv, all
  D + 2 input planes (halos included) from the D-plane cotangent, without
  materialising the cotangent zero-padded by 2 planes.

Launch counters (each binding its own): ``launches`` and
``launches_by_epilogue`` (SAME forwards), ``launches_dx`` (SAME dx),
``launches_valid`` and ``launches_valid_by_epilogue`` (VALID forwards),
``launches_dx_valid`` (full-window dx).

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``icsg3d_torch/_build/`` on first use (kernels/_nvcc.py), loaded with
ctypes (plain C interface).  Nothing is imported or built when this module
is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from icsg3d_torch.kernels._nvcc import PKG, build_library

EPILOGUES = ("bias", "affine_leaky", "relu_affine", "affine_relu")

SOURCE = PKG / "csrc" / "conv3d.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Incremented once per kernel launch, never by the plain version: SAME
# forward launches (in total and by epilogue), SAME input-gradient launches,
# and the same for the depth-VALID forward and its full-window dx.
launches = 0
launches_by_epilogue = {e: 0 for e in EPILOGUES}
launches_dx = 0
launches_valid = 0
launches_valid_by_epilogue = {e: 0 for e in EPILOGUES}
launches_dx_valid = 0

# Depth offset of the window per mode (csrc/conv3d.cu): output plane d
# reads input planes d + off - 1 .. d + off + 1.
_DEPTH_OFF = {"same": 0, "valid": 1, "full": -1}

_lib = None


def reset_launches() -> None:
    global launches, launches_dx, launches_valid, launches_dx_valid
    launches = launches_dx = launches_valid = launches_dx_valid = 0
    for e in EPILOGUES:
        launches_by_epilogue[e] = 0
        launches_valid_by_epilogue[e] = 0


def build() -> Path:
    """Compile ``csrc/conv3d.cu`` for sm_90a; returns the library path."""
    return build_library(SOURCE, "libconv3d")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.conv3d
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 8
            + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_channels(t: Optional[torch.Tensor], cout: int, name: str, x):
    if t is None:
        raise ValueError(f"{name} is required for this epilogue")
    if t.shape != (cout,) or t.dtype != torch.float32 or t.device != x.device:
        raise ValueError(
            f"{name} must be float32 ({cout},) on {x.device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_operands(x: torch.Tensor, w: torch.Tensor, name: str):
    """Raise unless x (B,D,H,W,C) and w (3,3,3,Cin,Cout) are contiguous
    CUDA tensors of one supported dtype on one device; the caller checks
    which side of w the channel C matches."""
    if not x.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(
            f"want x (B,D,H,W,C) and w (3,3,3,Cin,Cout), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(
            f"x and w must share dtype float32 or bfloat16, got {x.dtype}, {w.dtype}"
        )
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")


def _launch(x, wt, bias, scale, shift, epilogue, out_dtype, slope, mode="same"):
    """One kernel launch: x (B,D,H,W,K) conv wt (27, N, K) -> (B,D_out,H,W,N)
    with D_out = D (``mode`` "same"), D - 2 ("valid") or D + 2 ("full")."""
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    B, D, H, W, k = x.shape
    n = wt.shape[1]
    off = _DEPTH_OFF[mode]
    d_out = D - 2 * off
    if d_out < 1:
        raise ValueError(f"a {mode} conv of {D} planes has no output plane")
    lib = load()
    out = torch.empty((B, d_out, H, W, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv3d(
            x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            shift.data_ptr() if shift is not None else None,
            out.data_ptr(), B, D, d_out, off, H, W, k, n,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
            EPILOGUES.index(epilogue), float(slope), stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3d kernel launch failed ({mode}): CUDA error {err}")
    return out


def conv3d_same_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    epilogue: str = "bias",
    out_dtype: Optional[torch.dtype] = None,
    slope: float = 0.3,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors.

    x: (B, D, H, W, Cin) contiguous, bf16 or f32; w: (3, 3, 3, Cin, Cout)
    contiguous in x.dtype; bias/scale/shift: (Cout,) contiguous f32.
    Returns a new (B, D, H, W, Cout) tensor in ``out_dtype`` (default
    x.dtype).  Raises on anything else; never falls back.
    """
    global launches
    out = _forward(x, w, bias, scale, shift, epilogue, out_dtype, slope, "same",
                   "conv3d_same_cuda")
    launches += 1
    launches_by_epilogue[epilogue] += 1
    return out


def conv3d_valid_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    epilogue: str = "bias",
    out_dtype: Optional[torch.dtype] = None,
    slope: float = 0.3,
) -> torch.Tensor:
    """The depth-VALID conv on CUDA tensors: x (B, D + 2, H, W, Cin) is a
    depth slab padded with its two halo planes, the result (B, D, H, W,
    Cout) its slice of the global SAME conv.  Arguments and checks as in
    ``conv3d_same_cuda``; every epilogue."""
    global launches_valid
    out = _forward(x, w, bias, scale, shift, epilogue, out_dtype, slope, "valid",
                   "conv3d_valid_cuda")
    launches_valid += 1
    launches_valid_by_epilogue[epilogue] += 1
    return out


def _forward(x, w, bias, scale, shift, epilogue, out_dtype, slope, mode, name):
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; choose from {EPILOGUES}")
    _check_operands(x, w, name)
    cin, cout = w.shape[3], w.shape[4]
    if x.shape[4] != cin:
        raise ValueError(f"w has Cin={cin}, x has {x.shape[4]}")
    _check_channels(bias, cout, "bias", x)
    if epilogue != "bias":
        _check_channels(scale, cout, "scale", x)
        _check_channels(shift, cout, "shift", x)
    # the kernel reads weights K-contiguous per output channel: (27, Cout, Cin)
    wt = w.reshape(27, cin, cout).transpose(1, 2).contiguous()
    return _launch(x, wt, bias, scale, shift, epilogue, out_dtype or x.dtype, slope,
                   mode)


def conv3d_dx_cuda(
    g: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """K1 run as dx: the input gradient of the SAME conv with weights w.

    g: (B, D, H, W, Cout) cotangent, contiguous, bf16 or f32; w: (3, 3, 3,
    Cin, Cout) contiguous in g.dtype.  Returns (B, D, H, W, Cin) in
    ``out_dtype`` (default g.dtype): the same kernel on the flipped,
    channel-swapped weights (``_flip_w``, lowc_conv.py:518-521) with zero
    bias.  In the kernel's (27, N, K) weight layout those are w's own
    (27, Cin, Cout) rows in reverse tap order, so no transpose is needed.
    """
    global launches_dx
    out = _dx(g, w, out_dtype, "same", "conv3d_dx_cuda")
    launches_dx += 1
    return out


def conv3d_dx_valid_cuda(
    g: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """The input gradient of the depth-VALID conv with weights w: g (B, D,
    H, W, Cout) -> dx (B, D + 2, H, W, Cin), every input plane of the
    halo-padded slab.  The kernel's full depth window (offset -1) on the
    flipped weights does what lowc_conv.py:609-623 does on a cotangent
    zero-padded by 2 planes, without writing that pad."""
    global launches_dx_valid
    out = _dx(g, w, out_dtype, "full", "conv3d_dx_valid_cuda")
    launches_dx_valid += 1
    return out


def _dx(g, w, out_dtype, mode, name):
    _check_operands(g, w, name)
    cin, cout = w.shape[3], w.shape[4]
    if g.shape[4] != cout:
        raise ValueError(f"w has Cout={cout}, g has {g.shape[4]}")
    wt = w.reshape(27, cin, cout).flip(0).contiguous()
    zero = torch.zeros(cin, dtype=torch.float32, device=g.device)
    return _launch(g, wt, zero, None, None, "bias", out_dtype or g.dtype, 0.0, mode)


def apply_epilogue(y, epilogue, scale=None, shift=None, slope: float = 0.3):
    """The kernel's epilogue in torch, on an f32 ``y`` = conv + bias."""
    if epilogue == "bias":
        return y
    if epilogue == "affine_leaky":
        y = y * scale + shift
        return torch.where(y >= 0, y, slope * y)
    if epilogue == "relu_affine":
        return torch.relu(y) * scale + shift
    if epilogue == "affine_relu":
        return torch.relu(y * scale + shift)
    raise ValueError(f"unknown epilogue {epilogue!r}; choose from {EPILOGUES}")


def conv3d_same_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    epilogue: str = "bias",
    out_dtype: Optional[torch.dtype] = None,
    slope: float = 0.3,
) -> torch.Tensor:
    """The plain PyTorch version: F.conv3d in f32 on the same (x.dtype)
    operands, the epilogue in f32, then a cast to ``out_dtype``.

    On CUDA tensors it serves as the oracle for the kernel, so it turns
    TF32 off for cuDNN convolutions and cuBLAS matmuls
    (``torch.backends.cudnn.allow_tf32 = False``,
    ``torch.backends.cuda.matmul.allow_tf32 = False``): TF32 keeps about
    three decimal digits, too few to check an f32 output against.
    """
    return _reference(x, w, bias, scale, shift, epilogue, out_dtype, slope, 1)


def conv3d_valid_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    epilogue: str = "bias",
    out_dtype: Optional[torch.dtype] = None,
    slope: float = 0.3,
) -> torch.Tensor:
    """The plain version of ``conv3d_valid_cuda``: as
    ``conv3d_same_reference`` with F.conv3d's ``padding=(0, 1, 1)``, so x
    (B, D + 2, H, W, Cin) gives (B, D, H, W, Cout)."""
    return _reference(x, w, bias, scale, shift, epilogue, out_dtype, slope, 0)


def _reference(x, w, bias, scale, shift, epilogue, out_dtype, slope, depth_pad):
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; choose from {EPILOGUES}")
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out_dtype = out_dtype or x.dtype
    xf = x.float().permute(0, 4, 1, 2, 3)
    wf = w.to(x.dtype).float().permute(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    y = F.conv3d(xf, wf, padding=(depth_pad, 1, 1)).permute(0, 2, 3, 4, 1)
    y = y + bias.float()
    if epilogue != "bias":
        scale, shift = scale.float(), shift.float()
    y = apply_epilogue(y, epilogue, scale, shift, slope)
    return y.to(out_dtype).contiguous()


def flip_weights(w: torch.Tensor) -> torch.Tensor:
    """Weights of the input-gradient conv: spatial flip + channel swap,
    (3, 3, 3, Cin, Cout) -> (3, 3, 3, Cout, Cin) (lowc_conv.py:518-521)."""
    return w.flip((0, 1, 2)).transpose(3, 4)


def conv3d_dx_reference(
    g: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """The plain version of ``conv3d_dx_cuda``: ``conv3d_same_reference`` of
    the cotangent with the flipped, channel-swapped weights, zero bias."""
    zero = torch.zeros(w.shape[3], dtype=torch.float32, device=g.device)
    return conv3d_same_reference(g, flip_weights(w), zero, out_dtype=out_dtype)


def conv3d_dx_valid_reference(
    g: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """The plain version of ``conv3d_dx_valid_cuda``: the cotangent
    zero-padded by 2 planes on each side, then ``conv3d_valid_reference``
    with the flipped, channel-swapped weights and zero bias
    (lowc_conv.py:609-623)."""
    zero = torch.zeros(w.shape[3], dtype=torch.float32, device=g.device)
    gp = F.pad(g, (0, 0, 0, 0, 0, 0, 2, 2))
    return conv3d_valid_reference(gp, flip_weights(w), zero, out_dtype=out_dtype)
