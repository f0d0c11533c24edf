"""Fused Gaussian voxelization: the Hopper kernel, its loader, and its plain
PyTorch version.

Replaces the Pallas TPU kernel K4, ``icsg3d_tpu/ops/pallas_voxelize.py::
_kernel`` (launched by ``voxelize_pallas``), and the XLA composite that the
JAX dataset build actually runs, ``icsg3d_tpu/ops/voxelize.py::voxelize``
(vmapped by ``voxelize_batch``, data/voxel_build.py:70).  Both compute one
function: per voxel of a d^3 grid, the Gaussian density summed over the
structure's sites and the species label by the reference's conflict rule
(utils.py:120-131).

The kernel (``icsg3d_torch/csrc/voxelize.cu``) takes a whole batch of B
structures per call (the batch is a grid axis, where the TPU vmapped one
``pallas_call`` per structure) and keeps nothing of size voxels x sites in
device memory.  What bounds it is the bytes of the two f32 output grids
(67 MB for the build's chunk of 256 structures at 32^3); what it spends is
instructions per site-voxel pair, so:

- a setup kernel computes each structure's per-site constants once
  (valid sites packed first, inert pads dropped) and its voxel-centre
  axes, into a workspace the wrapper allocates;
- the main kernel gives a thread ``QUADS_PER_THREAD`` quads of 4 k voxels
  of one column (``tile``), shares vx*sx + vy*sy per site and vx^2 + vy^2
  per column, clamps d2 with an add (h = raw + |raw| = 2 max(d2, 0)),
  takes exp as ex2.approx, and stores one float4 per grid per quad;
- the labelling test compares h with twice a per-site threshold T, the
  least f32 whose rounded square root reaches the radius
  (``label_thresholds`` is its numpy twin): bit for bit the test
  sqrt(d2) < radius.  One exact f32 sum counts the sites within and
  names the site when there is one;
- only a voxel inside two or more radii walks the sites again, for the
  first whose rounded square root equals that of the least d2: the
  reference's first-index argmin over distances.

So the species grid is bitwise the plain version's, the density within
rtol 2e-4 / atol 1e-6 of it.  The note in the .cu file gives the
exactness argument; PERF.md the measured time and instructions per pair
(``tools/k4_sass.py``).

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``icsg3d_torch/_build/`` on first use (kernels/_nvcc.py), loaded with
ctypes.  Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from icsg3d_torch.kernels._nvcc import PKG, build_library

SOURCE = PKG / "csrc" / "voxelize.cu"

# What the kernel's shared memory holds (see csrc/voxelize.cu).  The TPU
# kernel took at most 128 sites (one lane tile).
MAX_SITES = 1024
MAX_D = 512
MAX_BATCH = 65535  # the grid's y dimension
THREADS = 128  # threads per block of the main kernel
QUADS_PER_THREAD = 2  # quads of 4 consecutive k voxels per thread

INV_TWO_PI_POW = float((2.0 * 3.141592653589793) ** -1.5)

# Incremented once per kernel launch, never by the plain version.
launches = 0

_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def build() -> Path:
    """Compile ``csrc/voxelize.cu`` for sm_90a; returns the library path."""
    return build_library(SOURCE, "libvoxelize")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.voxelize.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
            + [ctypes.c_void_p]
        )
        lib.voxelize.restype = ctypes.c_int
        _lib = lib
    return _lib


def tile(d: int) -> Tuple[int, int, int]:
    """The main kernel's thread tiling of one structure's d^3 grid: (quads
    per column ceil(d / 4), threads per column, blocks of ``THREADS``).
    Thread t of the structure owns column t // tpc (i, j = divmod) and in it
    the quads r + h * tpc (r = t % tpc, h < QUADS_PER_THREAD), voxels
    k = 4 * quad + u < d."""
    qd = (d + 3) // 4
    tpc = -(-qd // QUADS_PER_THREAD)
    return qd, tpc, -(-(d * d * tpc) // THREADS)


def workspace_words(B: int, S: int, d: int) -> int:
    """f32 words of the kernel's workspace: a 4-word header, S rows of 8
    words and 3 x d axis coordinates per structure."""
    return B * (4 + 8 * S + 3 * d)


def label_thresholds(sigma, mask, label_frac: float) -> np.ndarray:
    """The numpy twin of the setup kernel's per-site labelling threshold.

    For a valid site (mask > 0) with radius rad = f32(max(sigma, 1e-6)) *
    f32(label_frac), T is the least f32 >= 0 with sqrt_rn(T) >= rad, so
    that for every f32 x >= 0, sqrt_rn(x) < rad exactly when x < T
    (sqrt_rn is monotone): rad^2 rounded, then nextafter steps.  An
    invalid site gets -1, never reached by a d2 >= 0.  Same shape as
    ``sigma``, float32.
    """
    sigma = np.asarray(sigma, np.float32)
    rad = np.maximum(sigma, np.float32(1e-6)) * np.float32(label_frac)
    zero, inf = np.float32(0), np.float32(np.inf)
    with np.errstate(over="ignore"):
        t = rad * rad
    while True:
        down = np.nextafter(t, zero)
        step = (t > 0) & (np.sqrt(down) >= rad)
        if not step.any():
            break
        t = np.where(step, down, t)
    while True:
        step = np.sqrt(t) < rad
        if not step.any():
            break
        t = np.where(step, np.nextafter(t, inf), t)
    return np.where(np.asarray(mask) > 0, t, np.float32(-1)).astype(np.float32)


def _check(sites, z, sigma, mask, abc, d: int, label_frac: float):
    """Raise unless the operands are what the kernel takes: contiguous CUDA
    float32 tensors on one device, sites (B, S, 3), z/sigma/mask (B, S),
    abc (B, 3), within the kernel's limits."""
    named = dict(sites=sites, z=z, sigma=sigma, mask=mask, abc=abc)
    for name, t in named.items():
        if not t.is_cuda:
            raise ValueError(f"voxelize_cuda needs CUDA tensors; {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != sites.device:
            raise ValueError(f"{name} is on {t.device}, sites on {sites.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sites.dim() != 3 or sites.shape[2] != 3:
        raise ValueError(f"sites must be (B, S, 3), got {tuple(sites.shape)}")
    B, S = sites.shape[:2]
    for name in ("z", "sigma", "mask"):
        if tuple(named[name].shape) != (B, S):
            raise ValueError(f"{name} must be ({B}, {S}), got {tuple(named[name].shape)}")
    if tuple(abc.shape) != (B, 3):
        raise ValueError(f"abc must be ({B}, 3), got {tuple(abc.shape)}")
    if not 1 <= S <= MAX_SITES:
        raise ValueError(f"the kernel takes 1 to {MAX_SITES} sites, got {S}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"the kernel takes 1 to {MAX_BATCH} structures, got {B}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the kernel takes grids of 1 to {MAX_D} voxels a side, got {d}")
    if not label_frac >= 0.0:
        raise ValueError(f"label_frac must be >= 0, got {label_frac}")


def voxelize_cuda(sites: torch.Tensor, z: torch.Tensor, sigma: torch.Tensor,
                  mask: torch.Tensor, abc: torch.Tensor, d: int, eps_frac: float,
                  label_frac: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on a batch of B structures (one call: the
    per-structure setup kernel, then the main kernel; counted once in
    ``launches``).

    sites (B, S, 3) cartesian, z/sigma/mask (B, S), abc (B, 3) lattice
    lengths: contiguous float32 CUDA tensors; the grid is d voxels a side
    over [-eps*l, (1+eps)*l) per axis.  Returns (density, species), each a
    new float32 (B, d, d, d) tensor.  Raises on anything else; never falls
    back.
    """
    global launches
    _check(sites, z, sigma, mask, abc, d, label_frac)
    B, S = sites.shape[:2]
    lib = load()
    density = torch.empty((B, d, d, d), dtype=torch.float32, device=sites.device)
    species = torch.empty((B, d, d, d), dtype=torch.float32, device=sites.device)
    work = torch.empty(workspace_words(B, S, d), dtype=torch.float32, device=sites.device)
    with torch.cuda.device(sites.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.voxelize(
            sites.data_ptr(), z.data_ptr(), sigma.data_ptr(), mask.data_ptr(),
            abc.data_ptr(), work.data_ptr(), density.data_ptr(), species.data_ptr(),
            B, S, d, tile(d)[1], float(eps_frac), float(1.0 + 2.0 * eps_frac),
            float(label_frac), INV_TWO_PI_POW, stream,
        )
    if err != 0:
        raise RuntimeError(f"voxelize kernel launch failed: CUDA error {err}")
    launches += 1
    return density, species


def _div(a: torch.Tensor, d: int) -> torch.Tensor:
    """a / d rounded once.  The divisor is a tensor: on CUDA, PyTorch
    divides by a Python number as a product with its rounded reciprocal,
    which differs in the last bit where d is not a power of two."""
    return a / torch.full_like(a, d)


def axis_points(abc: torch.Tensor, d: int, eps_frac: float) -> torch.Tensor:
    """Voxel lower-corner coordinates per axis, (..., 3) lengths -> (..., 3,
    d) float32 (utils.py:109-111: linspace(-a*eps, a + a*eps, d+1)[:-1])."""
    abc = abc.float()
    lo = -abc * eps_frac
    hi = abc + abc * eps_frac
    step = _div(hi - lo, d)
    ar = torch.arange(d, dtype=torch.float32, device=abc.device)
    return lo[..., None] + step[..., None] * ar


def voxel_axes(abc: torch.Tensor, d: int, eps_frac: float) -> torch.Tensor:
    """Voxel-centre coordinates per axis: lower corner + dv/2 with dv =
    l * (1 + 2 eps) / d, in the f32 op order of icsg3d_tpu/ops/
    voxelize.py:35-56 (utils.py:105-115), on the CPU and on CUDA alike."""
    dv = _div(abc.float() * (1.0 + 2.0 * eps_frac), d)
    return axis_points(abc, d, eps_frac) + (dv / 2.0)[..., None]


def _sum3(a0, a1, a2):
    return (a0 + a1) + a2


def voxelize_reference(sites: torch.Tensor, z: torch.Tensor, sigma: torch.Tensor,
                       mask: torch.Tensor, abc: torch.Tensor, d: int,
                       eps_frac: float, label_frac: float = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, step for step icsg3d_tpu/ops/voxelize.py::
    voxelize, one structure at a time.

    The pairwise d2 = max(|v|^2 + |s|^2 - 2 v.s, 0) is written out as
    elementwise products and sums, left to right over (x, y, z), so every
    rounding is fixed and the kernel repeats it; the density is a
    (2 pi)^-1.5-scaled matvec of the Gaussians against z/sigma^3*mask; the
    species takes argmin/argmax over the sqrt distances (first index on
    ties).  On CUDA tensors it is the kernel's oracle and turns TF32 off for
    cuBLAS matmuls (``torch.backends.cuda.matmul.allow_tf32 = False``).
    """
    if sites.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    B = sites.shape[0]
    ax = voxel_axes(abc, d, eps_frac)                     # (B, 3, d)
    dens, spec = [], []
    for b in range(B):
        X, Y, Z = torch.meshgrid(ax[b, 0], ax[b, 1], ax[b, 2], indexing="ij")
        vx, vy, vz = (t.reshape(-1, 1) for t in (X, Y, Z))  # (nv, 1)
        s = sites[b].float()
        sx, sy, sz = s[None, :, 0], s[None, :, 1], s[None, :, 2]  # (1, S)
        m = mask[b].float()
        sg = torch.clamp(sigma[b].float(), min=1e-6)
        zf = z[b].float()
        v2 = _sum3(vx * vx, vy * vy, vz * vz)
        n2 = _sum3(sx * sx, sy * sy, sz * sz)
        cross = _sum3(vx * sx, vy * sy, vz * sz)
        d2 = torch.clamp(v2 + n2 - 2.0 * cross, min=0.0)
        kernel = torch.exp(-d2 / (2.0 * sg * sg)[None, :])
        weights = zf / (sg * sg * sg) * m
        dens.append(INV_TWO_PI_POW * (kernel @ weights))
        dist = torch.sqrt(d2)
        valid = (m > 0)[None, :]
        dist_valid = torch.where(valid, dist, torch.full_like(dist, 1e30))
        within = (dist < (sg * label_frac)[None, :]) & valid
        n_within = within.sum(dim=1)
        closest = torch.argmin(dist_valid, dim=1)
        only = torch.argmax(within.to(torch.uint8), dim=1)
        site_idx = torch.where(n_within >= 2, closest, only)
        spec.append(torch.where(n_within > 0, zf[site_idx], torch.zeros_like(zf[site_idx])))
    shape = (B, d, d, d)
    return (torch.stack(dens).reshape(shape).contiguous(),
            torch.stack(spec).reshape(shape).contiguous())
