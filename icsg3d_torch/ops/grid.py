"""Inverse grid transforms: decoded coordinate channels -> lattice geometry.

Counterpart of icsg3d_tpu/ops/grid.py (reference utils.py:160-190); the
GridSpec owns d and eps_frac.
"""

from __future__ import annotations

import torch

from icsg3d_torch.config import GridSpec


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
