"""3x3x3 SAME conv with a fused epilogue: the Hopper kernel, its build and
loader, and its plain PyTorch version.

Replaces two Pallas TPU kernels of the JAX package:

- K1 forward, ``icsg3d_tpu/ops/lowc_conv.py::_kernel`` (conv + bias; the
  spatial-major conv behind ``SpatialMajorConv`` under ``--layout ndcs``);
- K3, ``icsg3d_tpu/ops/pallas_conv.py::_conv_kernel`` (conv + folded
  inference BN + ReLU), whose epilogue is what every eval-mode conv block
  of the VAE and the U-Net computes.

The kernel (``icsg3d_torch/csrc/conv3d.cu``) is an implicit GEMM on NDHWC
data with M = B*D*H*W voxels, N = Cout, K = 27*Cin, f32 accumulation and
SAME padding by zero-filling predicated loads.  bf16 input runs on
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

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``icsg3d_torch/_build/`` on first use, loaded with ctypes (plain C
interface).  Nothing is imported or built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

EPILOGUES = ("bias", "affine_leaky", "relu_affine", "affine_relu")

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "conv3d.cu"
BUILD_DIR = _PKG / "_build"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Incremented once per kernel launch, never by the plain version.
launches = 0
launches_by_epilogue = {e: 0 for e in EPILOGUES}

_lib = None


def reset_launches() -> None:
    global launches
    launches = 0
    for e in EPILOGUES:
        launches_by_epilogue[e] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the conv3d kernel needs the CUDA toolkit")


def build() -> Path:
    """Compile ``csrc/conv3d.cu`` for sm_90a into a shared library.

    The library name carries a hash of the source, so an edited source is
    never served by a stale build.  Returns the library path.
    """
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    lib = BUILD_DIR / f"libconv3d_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(SOURCE),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.conv3d_same
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 6
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
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; choose from {EPILOGUES}")
    if not x.is_cuda:
        raise ValueError("conv3d_same_cuda needs CUDA tensors")
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(
            f"want x (B,D,H,W,Cin) and w (3,3,3,Cin,Cout), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    B, D, H, W, cin = x.shape
    cout = w.shape[4]
    if w.shape[3] != cin:
        raise ValueError(f"w has Cin={w.shape[3]}, x has {cin}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(
            f"x and w must share dtype float32 or bfloat16, got {x.dtype}, {w.dtype}"
        )
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    _check_channels(bias, cout, "bias", x)
    if epilogue != "bias":
        _check_channels(scale, cout, "scale", x)
        _check_channels(shift, cout, "shift", x)
    lib = load()
    # the kernel reads weights K-contiguous per output channel: (27, Cout, Cin)
    wt = w.reshape(27, cin, cout).transpose(1, 2).contiguous()
    out = torch.empty((B, D, H, W, cout), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv3d_same(
            x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            shift.data_ptr() if shift is not None else None,
            out.data_ptr(), B, D, H, W, cin, cout,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
            EPILOGUES.index(epilogue), float(slope), stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3d_same kernel launch failed: CUDA error {err}")
    launches += 1
    launches_by_epilogue[epilogue] += 1
    return out


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
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; choose from {EPILOGUES}")
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out_dtype = out_dtype or x.dtype
    xf = x.float().permute(0, 4, 1, 2, 3)
    wf = w.to(x.dtype).float().permute(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    y = F.conv3d(xf, wf, padding=1).permute(0, 2, 3, 4, 1)
    y = y + bias.float()
    if epilogue != "bias":
        scale, shift = scale.float(), shift.float()
    y = apply_epilogue(y, epilogue, scale, shift, slope)
    return y.to(out_dtype).contiguous()
