"""Exact 90-degree rotation augmentation of voxel grids.

Counterpart of icsg3d_tpu/ops/rotations.py.  The reference rotated (M, S,
p) three times by 90 degrees about random axes with ``scipy.ndimage.rotate``
(utils.py:193-222), which at exactly 90 degrees on a cubic grid is an axis
permutation/flip: here ``torch.rot90``, numpy's convention (rotation from
the first axis towards the second), so species labels are preserved
exactly.  The dataset build rotates on the host with ``np.rot90`` and only
needs ``AXES_CHOICES`` from here (data/voxel_build.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

AXES_CHOICES: Tuple[Tuple[int, int], ...] = ((0, 1), (0, 2), (1, 2))


def rotate90(x: torch.Tensor, axes: Tuple[int, int], k: int = 1) -> torch.Tensor:
    """Rotate a (d,d,d) or (d,d,d,C) grid by k*90 degrees in plane ``axes``."""
    return torch.rot90(x, k, dims=axes)


def random_rotation_3d(generator: torch.Generator, M, S, p, nrotations: int = 3):
    """Apply ``nrotations`` successive random-axis 90-degree rotations.

    Matches random_rotation_3d (utils.py:193-222): axes drawn uniformly from
    the three coordinate planes; the same rotation applied to the density
    grid M (d,d,d), species grid S (d,d,d) and coordinate grid p (d,d,d,3).
    The draws come from ``generator`` (torch's, not jax.random's, numbers).
    """
    choices = torch.randint(0, len(AXES_CHOICES), (nrotations,), generator=generator)
    for c in choices.tolist():
        ax = AXES_CHOICES[c]
        M, S, p = (torch.rot90(a, 1, dims=ax) for a in (M, S, p))
    return M, S, p


def all_octahedral_rotations(x: torch.Tensor) -> torch.Tensor:
    """All 24 proper rotations of a cubic grid, stacked on a new axis 0."""
    outs = []
    for k_z in range(4):
        r = torch.rot90(x, k_z, dims=(0, 1))
        outs.append(r)
        outs.append(torch.rot90(r, 1, dims=(1, 2)))
        outs.append(torch.rot90(r, 2, dims=(1, 2)))
        outs.append(torch.rot90(r, 3, dims=(1, 2)))
        outs.append(torch.rot90(r, 1, dims=(0, 2)))
        outs.append(torch.rot90(r, 3, dims=(0, 2)))
    return torch.stack(outs)
