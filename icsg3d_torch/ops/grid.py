"""Grid transforms: lattice lengths -> coordinate channels, and decoded
coordinate channels -> lattice geometry.

Counterpart of icsg3d_tpu/ops/grid.py (reference utils.py:160-190) and of
``icsg3d_tpu/ops/voxelize.py::coordinate_grid`` (utils.py:88-94); the
GridSpec owns d and eps_frac.
"""

from __future__ import annotations

import torch

from icsg3d_torch.config import GridSpec


def coordinate_grids(abc: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    """(B, 3) lattice lengths -> (B, d, d, d, 3) float32 grids of absolute
    coordinates in [0, l + 2*eps*l): per axis (l * (1 + 2*eps)) / d *
    arange(d), the batched form of voxelize.coordinate_grid."""
    abc = abc.float()
    d = grid.d
    hi = abc * (1.0 + 2.0 * grid.eps_frac)
    axes = hi[:, :, None] / d * torch.arange(d, dtype=torch.float32,
                                             device=abc.device)
    b = abc.shape[0]
    X = axes[:, 0, :, None, None].expand(b, d, d, d)
    Y = axes[:, 1, None, :, None].expand(b, d, d, d)
    Z = axes[:, 2, None, None, :].expand(b, d, d, d)
    return torch.stack([X, Y, Z], dim=-1)


def to_lattice_params(coords: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    """Recover (a, b, c) from coordinate channels (B, d, d, d, 3).

    Per-channel span, un-padded by (1 + 2*eps), corrected for the
    half-open grid (d-1 steps span the range), then shrunk by 1/d.
    """
    span = coords.amax(dim=(1, 2, 3)) - coords.amin(dim=(1, 2, 3))
    lp = span / (1.0 + 2.0 * grid.eps_frac)
    lp = lp / (1.0 - 1.0 / grid.d)
    lp = lp - lp / grid.d
    return lp


def to_voxel_params(lattice_params: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    """Voxel edge lengths dv from lattice lengths.  utils.py:181-190."""
    return lattice_params * (1.0 + 2.0 * grid.eps_frac) / grid.d


def voxel_to_cartesian(mu, lattice_params, dv, grid: GridSpec):
    """Voxel-space centroids (..., 3) -> cartesian coordinates:
    mu * dv - eps * l + dv/2 (generate.py:237-241)."""
    return mu * dv - grid.eps_frac * lattice_params + dv / 2.0
