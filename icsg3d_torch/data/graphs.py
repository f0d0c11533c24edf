"""Crystal-graph featurization for the CGCNN property regressor.

Counterpart of icsg3d_tpu/data/graphs.py.  ``GraphSpec``,
``featurize_structure`` and ``featurize_batch`` are verbatim (host numpy:
the neighbour search; tests/test_torch_guards.py holds them equal);
``gaussian_expand`` is torch and runs in the model, on the distances'
device.  A structure becomes fixed-shape padded arrays:

    atom_fea   (max_atoms, 93)                element feature vectors
    nbr_dist   (max_atoms, max_neighbors)     neighbor distances (Angstrom)
    nbr_idx    (max_atoms, max_neighbors)     neighbor site indices
    atom_mask  (max_atoms,)                   1 for real atoms

Under-coordinated sites pad with distance = radius + 1 and index 0, and
padded atom rows point at the last slot, exactly like cgcnn/data.py:195-237.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from icsg3d_torch.crystal.neighbors import neighbor_list
from icsg3d_torch.crystal.structure import Structure
from icsg3d_torch.data.atom_features import atom_feature_table


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Static graph shapes (reference: cgcnn/cgcnn.py:149-152 defaults)."""

    max_atoms: int = 50
    max_neighbors: int = 12
    radius: float = 8.0
    dmin: float = 0.0
    step: float = 0.2

    def __post_init__(self):
        # reference GaussianDistance.__init__ asserts these
        # (cgcnn/data.py:91-92); failing late means a (..., 0)-wide bond
        # basis silently trains with zero bond features
        if self.step <= 0:
            raise ValueError(f"step must be positive, got {self.step}")
        if self.dmin >= self.radius:
            raise ValueError(
                f"dmin {self.dmin} must be < radius {self.radius}"
            )
        if self.radius - self.dmin <= self.step:
            raise ValueError("radius - dmin must exceed step")

    @property
    def num_bond_features(self) -> int:
        # single source of truth: the actual basis width (a closed-form
        # round() disagreed with np.arange for non-commensurate
        # (radius-dmin)/step, e.g. radius=4 step=0.3 -> 15 centers, 14
        # claimed)
        return len(self.filter_centers)

    @property
    def filter_centers(self) -> np.ndarray:
        return np.arange(
            self.dmin, self.radius + self.step, self.step, dtype=np.float32
        )


def gaussian_expand(distances: torch.Tensor, spec: GraphSpec) -> torch.Tensor:
    """Expand distances on a Gaussian basis, on the distances' device.

    Matches GaussianDistance.expand (cgcnn/data.py:95-112): centers
    arange(dmin, dmax+step, step), variance = step**2 (sic: the reference
    divides by var^2 with var=step).  The divisor is an f32 tensor: on CUDA,
    PyTorch divides by a Python number as a product with its rounded
    reciprocal, which is not the quotient the JAX package computes.
    """
    d = torch.as_tensor(distances, dtype=torch.float32)
    centers = torch.from_numpy(spec.filter_centers).to(d.device)
    sq = (d[..., None] - centers) ** 2
    return torch.exp(-sq / torch.full_like(sq, spec.step**2))


def featurize_structure(
    structure: Structure, spec: GraphSpec = GraphSpec()
) -> Dict[str, np.ndarray]:
    """One structure -> padded graph arrays (host side; neighbor search)."""
    n = len(structure)
    if n == 0 or n > spec.max_atoms:
        raise ValueError(f"structure has {n} sites, max {spec.max_atoms}")

    table = atom_feature_table()
    atom_fea = np.zeros((spec.max_atoms, table.shape[1]), dtype=np.float32)
    atom_fea[:n] = table[structure.atomic_numbers]

    nbr_dist = np.full(
        (spec.max_atoms, spec.max_neighbors), spec.radius + 1.0, dtype=np.float32
    )
    nbr_idx = np.zeros((spec.max_atoms, spec.max_neighbors), dtype=np.int32)
    # Padded atom rows point at the last slot like the reference
    # (cgcnn/data.py:237: idx_padding = pad_dim - 1).
    nbr_idx[n:] = spec.max_atoms - 1

    for i, nbrs in enumerate(neighbor_list(structure, spec.radius)):
        take = nbrs[: spec.max_neighbors]
        for j, (dist, idx) in enumerate(take):
            nbr_dist[i, j] = dist
            nbr_idx[i, j] = idx

    atom_mask = np.zeros(spec.max_atoms, dtype=np.float32)
    atom_mask[:n] = 1.0
    return {
        "atom_fea": atom_fea,
        "nbr_dist": nbr_dist,
        "nbr_idx": nbr_idx,
        "atom_mask": atom_mask,
    }


def featurize_batch(
    structures: Sequence[Structure], spec: GraphSpec = GraphSpec()
) -> Dict[str, np.ndarray]:
    """Stack per-structure graph arrays into batch arrays."""
    if not structures:
        raise ValueError(
            "featurize_batch got no structures (empty CIF dir, every "
            "structure filtered by max_atoms, or no target matches)"
        )
    feats: List[Dict[str, np.ndarray]] = [
        featurize_structure(s, spec) for s in structures
    ]
    return {k: np.stack([f[k] for f in feats]) for k in feats[0]}
