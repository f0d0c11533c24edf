"""Weight gradient of the 3x3x3 conv, SAME or depth-VALID: the Hopper
kernel, its loader, and its plain PyTorch versions.

Replaces the Pallas TPU kernel K2, ``icsg3d_tpu/ops/lowc_conv.py::
_dw_kernel`` (launched by ``conv3d_lowc_ndcs_dw``, lowc_conv.py:372-434):

    dW[dd, dh, dw, ci, co] = sum over (b, d, h, w) of
        x[b, d+dd-1, h+dh-1, w+dw-1, ci] * g[b, d, h, w, co]

with x zero outside the grid, f32 out in the DHWIO layout of the conv's
kernel parameter.  The kernel (``icsg3d_torch/csrc/conv3d_dw.cu``) reads
this as a GEMM with M = 27*Cin, N = Cout and a long K = B*D*H*W, split
across blocks into an f32 workspace that a second pass sums in a fixed
order (deterministic).  bf16 operands run on mma.sync tensor cores fed by
a cp.async ring; f32 operands (the VAE's f32 output head) on an FMA
kernel.  See the note in the .cu file for what bounds it.

The VALID mode (``conv3d_dw_valid_cuda``, K2's ``depth_valid``,
lowc_conv.py:380-387) takes x as a halo-padded depth slab of D + 2 planes
and g with D: the per-shard dW of a depth-sharded conv (parallel/halo.py).
The split-K ranges run over g's voxels.  Counters: ``launches`` (SAME),
``launches_valid`` (VALID).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from icsg3d_torch.kernels._nvcc import PKG, build_library

SOURCE = PKG / "csrc" / "conv3d_dw.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Blocks to aim for across the M/N tiles and the K splits: 8 per SM of the
# H100's 132, enough to cover the card at the small M*N of every shape.
_TARGET_BLOCKS = 8 * 132
_BM, _BN, _BK = 64, 32, 32          # bf16 tile (rows, cols, voxels per stage)
_FMA_TILE = {4: (128, 4), 16: (32, 16)}  # f32: column threads -> (rows, cols)

# Incremented once per kernel launch, never by the plain version.
launches = 0
launches_valid = 0

_lib = None


def reset_launches() -> None:
    global launches, launches_valid
    launches = launches_valid = 0


def build() -> Path:
    """Compile ``csrc/conv3d_dw.cu`` for sm_90a; returns the library path."""
    return build_library(SOURCE, "libconv3d_dw")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.conv3d_dw.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        )
        lib.conv3d_dw.restype = ctypes.c_int
        _lib = lib
    return _lib


def _num_splits(vox: int, cin: int, cout: int, dtype: torch.dtype) -> int:
    """How many blocks share the voxel axis: enough for ``_TARGET_BLOCKS``
    over the M/N tiles, at most one per BK-voxel stage."""
    if dtype == torch.bfloat16:
        rows, cols = _BM, _BN
    else:
        rows, cols = _FMA_TILE[4 if cout <= 4 else 16]
    tiles = -(-27 * cin // rows) * -(-cout // cols)
    return max(1, min(-(-_TARGET_BLOCKS // tiles), -(-vox // _BK)))


def conv3d_dw_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the weight-gradient kernel on CUDA tensors.

    x: (B, D, H, W, Cin) conv input; g: (B, D, H, W, Cout) cotangent; both
    contiguous, one dtype, bf16 or f32.  Returns dW (3, 3, 3, Cin, Cout)
    float32.  Raises on anything else; never falls back.
    """
    global launches
    dw = _launch(x, g, 0, "conv3d_dw_cuda")
    launches += 1
    return dw


def conv3d_dw_valid_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient of the depth-VALID conv on CUDA tensors: x (B,
    D + 2, H, W, Cin) the halo-padded slab, g (B, D, H, W, Cout).  Returns
    dW (3, 3, 3, Cin, Cout) float32; checks as in ``conv3d_dw_cuda``."""
    global launches_valid
    dw = _launch(x, g, 1, "conv3d_dw_valid_cuda")
    launches_valid += 1
    return dw


def _launch(x, g, off, name):
    """One launch with x's depth window offset by ``off`` planes (x has
    g's depth + 2*off planes)."""
    if not (x.is_cuda and g.is_cuda):
        raise ValueError(f"{name} needs CUDA tensors")
    if (x.dim() != 5 or g.dim() != 5 or x.shape[0] != g.shape[0]
            or x.shape[1] != g.shape[1] + 2 * off or x.shape[2:4] != g.shape[2:4]):
        raise ValueError(
            f"want x (B,D{' + 2' if off else ''},H,W,Cin) and g (B,D,H,W,Cout), got "
            f"{tuple(x.shape)} and {tuple(g.shape)}"
        )
    if x.dtype not in _DTYPE_CODE or g.dtype != x.dtype:
        raise ValueError(
            f"x and g must share dtype float32 or bfloat16, got {x.dtype}, {g.dtype}"
        )
    if g.device != x.device:
        raise ValueError(f"g is on {g.device}, x on {x.device}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("x and g must be contiguous")
    B, D, H, W, cout = g.shape
    cin = x.shape[4]
    lib = load()
    splits = _num_splits(B * D * H * W, cin, cout, x.dtype)
    ws = torch.empty(splits * 27 * cin * cout, dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv3d_dw(
            x.data_ptr(), g.data_ptr(), ws.data_ptr(), dw.data_ptr(),
            B, D, H, W, cin, cout, _DTYPE_CODE[x.dtype], splits, off, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return dw


def conv3d_dw_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: for each of the 27 taps, the f32 product
    of the tap-shifted, zero-padded x (voxels x Cin) with g (voxels x
    Cout), on the same (x.dtype) operands.

    On CUDA tensors it serves as the oracle for the kernel, so it turns
    TF32 off for cuBLAS matmuls (``torch.backends.cuda.matmul.allow_tf32 =
    False``): TF32 keeps about three decimal digits.
    """
    return _reference(x, g, 1)


def conv3d_dw_valid_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain version of ``conv3d_dw_valid_cuda``: ``conv3d_dw_reference``
    without the depth pad (x has g's depth + 2 planes)."""
    return _reference(x, g, 0)


def _reference(x, g, depth_pad):
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    B, D, H, W, cout = g.shape
    cin = x.shape[4]
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1, depth_pad, depth_pad))
    gf = g.float().reshape(-1, cout)
    dw = torch.empty((27, cin, cout), dtype=torch.float32, device=x.device)
    for tap in range(27):
        dd, dh, dwi = tap // 9, (tap // 3) % 3, tap % 3
        xs = xp[:, dd:dd + D, dh:dh + H, dwi:dwi + W].reshape(-1, cin)
        dw[tap] = xs.t() @ gf
    return dw.reshape(3, 3, 3, cin, cout)
