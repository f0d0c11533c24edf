"""Gaussian voxelization of crystal structures, on the card.

Counterpart of icsg3d_tpu/ops/voxelize.py (reference utils.py:98-144,
create_matrices.py:105-158).  ``voxelize_batch`` takes a batch of padded
structures: a CUDA tensor launches the hand-written kernel K4
(kernels/voxelize.py, csrc/voxelize.cu) once for the whole batch, a CPU
tensor runs its plain PyTorch version, anything else raises.  The species
grid follows the reference's conflict rule: a voxel inside exactly one
site's labelling radius takes that site; inside two or more, the globally
closest site wins; otherwise background.

The geometry helpers keep the JAX package's f32 operation order, so the
voxel centres and coordinate grids equal its own bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from icsg3d_torch.config import GridSpec
from icsg3d_torch.kernels import voxelize as _k


# voxel lower-corner coordinates along one axis (utils.py:109-111)
_axis_points = _k.axis_points


def voxel_centers(abc, grid: GridSpec) -> torch.Tensor:
    """(d^3, 3) cartesian voxel-center coordinates for lattice lengths abc.

    Reference: utils.py:105-115 (bottom-left corners + dv/2).
    """
    abc = torch.as_tensor(abc, dtype=torch.float32)
    ax = _k.voxel_axes(abc, grid.d, grid.eps_frac)
    X, Y, Z = torch.meshgrid(ax[0], ax[1], ax[2], indexing="ij")
    return torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)


def coordinate_grid(abc, grid: GridSpec) -> torch.Tensor:
    """(d, d, d, 3) grid of absolute coordinates in [0, l + 2*eps*l).

    Reference: utils.py:88-94 — linspace(0, l + 2*eps*l, d+1)[:-1] per axis.
    """
    abc = torch.as_tensor(abc, dtype=torch.float32)
    d = grid.d
    ar = torch.arange(d, dtype=torch.float32, device=abc.device)
    axes = [abc[i] * (1.0 + 2.0 * grid.eps_frac) / d * ar for i in range(3)]
    X, Y, Z = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([X, Y, Z], dim=-1)


def coordinate_grids_np(abc, grid: GridSpec) -> np.ndarray:
    """Batched host-side coordinate grids: (B, 3) lattice lengths ->
    (B, d, d, d, 3) float32 (utils.py:88-94), in numpy for dataset
    building."""
    abc = np.asarray(abc, np.float32).reshape(-1, 3)
    d = grid.d
    ar = np.arange(d, dtype=np.float32)
    step = abc * (1.0 + 2.0 * grid.eps_frac) / d        # (B, 3)
    out = np.empty((abc.shape[0], d, d, d, 3), np.float32)
    out[..., 0] = (step[:, 0, None] * ar)[:, :, None, None]
    out[..., 1] = (step[:, 1, None] * ar)[:, None, :, None]
    out[..., 2] = (step[:, 2, None] * ar)[:, None, None, :]
    return out


def voxelize_batch(sites, z, sigma, mask, abc, grid: GridSpec,
                   label_frac: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density and species grids, each (B, d, d, d) float32, for a batch of
    padded structures: sites (B, S, 3) cartesian, z/sigma/mask (B, S)
    (mask 1 for real sites, 0 for padding; sigma > 0, pads too), abc
    (B, 3) lattice lengths, all on one device."""
    args = [t.float().contiguous() for t in (sites, z, sigma, mask, abc)]
    dev = args[0].device
    if dev.type == "cuda":
        return _k.voxelize_cuda(*args, grid.d, grid.eps_frac, label_frac)
    if dev.type == "cpu":
        return _k.voxelize_reference(*args, grid.d, grid.eps_frac, label_frac)
    raise ValueError(f"voxelize_batch runs on cuda or cpu tensors, not {dev}")


def voxelize(sites, z, sigma, mask, abc, grid: GridSpec,
             label_frac: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density grid M and species grid S, each (d, d, d) float32, for one
    padded structure: sites (S, 3), z/sigma/mask (S,), abc (3,)."""
    M, S = voxelize_batch(*(t[None] for t in (sites, z, sigma, mask, abc)),
                          grid, label_frac)
    return M[0], S[0]


def pad_sites(N, z, sigma, site_pad: int):
    """Host helper: pad per-structure site arrays to a static length.

    Returns (sites, z, sigma, mask) ready for `voxelize`.
    """
    n = len(z)
    if n > site_pad:
        raise ValueError(f"{n} sites exceeds site_pad={site_pad}")
    sites = np.zeros((site_pad, 3), dtype=np.float32)
    zz = np.zeros(site_pad, dtype=np.float32)
    ss = np.ones(site_pad, dtype=np.float32)
    mm = np.zeros(site_pad, dtype=np.float32)
    sites[:n] = N
    zz[:n] = z
    ss[:n] = sigma
    mm[:n] = 1.0
    return sites, zz, ss, mm
