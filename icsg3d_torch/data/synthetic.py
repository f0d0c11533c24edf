# Copy of icsg3d_tpu/data/synthetic.py; build_dataset adds a pass-through `device`.
"""Synthetic crystal dataset generation.

The reference pipeline starts from Materials Project CIFs
(query_matproj.py); this environment has no network egress, so tests and
benchmarks build physically-plausible synthetic datasets instead: cubic
ABX3 perovskites and binary rocksalts with jittered lattice constants and
species drawn from curated element pools.  Voxelization runs through the
same on-device pipeline as real data (ops/voxelize.py), so everything
downstream — U-Net, VAE, watershed, CGCNN — exercises identical code paths.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from icsg3d_torch.config import VoxelizerConfig
from icsg3d_torch.crystal import elements
from icsg3d_torch.crystal.lattice import Lattice
from icsg3d_torch.crystal.structure import Site, Structure
from icsg3d_torch.data.store import GridDataset

# Element pools (atomic numbers) for plausible chemistry.
A_SITE = [3, 11, 19, 20, 37, 38, 55, 56, 57]           # alkali/alkaline/La
B_SITE = [13, 22, 23, 24, 25, 26, 27, 28, 31, 40, 41]  # Al + 3d/4d metals
X_SITE = [8, 9, 16, 17]                                # O, F, S, Cl
ROCKSALT_CATION = [3, 11, 12, 19, 20, 26, 28, 30, 38, 56]
ROCKSALT_ANION = [8, 9, 16, 17, 34, 35]


def perovskite(rng: np.random.Generator) -> Structure:
    """Cubic ABX3 perovskite with a jittered lattice constant."""
    a_z = int(rng.choice(A_SITE))
    b_z = int(rng.choice(B_SITE))
    x_z = int(rng.choice(X_SITE))
    a0 = float(rng.uniform(3.6, 4.6))
    lattice = Lattice.from_parameters(a0, a0, a0)
    sites = [
        Site(a_z, np.array([0.0, 0.0, 0.0])),
        Site(b_z, np.array([0.5, 0.5, 0.5])),
        Site(x_z, np.array([0.5, 0.5, 0.0])),
        Site(x_z, np.array([0.5, 0.0, 0.5])),
        Site(x_z, np.array([0.0, 0.5, 0.5])),
    ]
    return Structure(lattice, sites)


def rocksalt(rng: np.random.Generator) -> Structure:
    """Conventional-cell rocksalt AB (8 atoms)."""
    c_z = int(rng.choice(ROCKSALT_CATION))
    a_z = int(rng.choice(ROCKSALT_ANION))
    a0 = float(rng.uniform(4.0, 5.8))
    lattice = Lattice.from_parameters(a0, a0, a0)
    cat = [(0, 0, 0), (0.5, 0.5, 0), (0.5, 0, 0.5), (0, 0.5, 0.5)]
    ani = [(0.5, 0, 0), (0, 0.5, 0), (0, 0, 0.5), (0.5, 0.5, 0.5)]
    sites = [Site(c_z, np.array(f, dtype=float)) for f in cat] + [
        Site(a_z, np.array(f, dtype=float)) for f in ani
    ]
    return Structure(lattice, sites)


def random_structures(
    n: int, seed: int = 0, kinds: Tuple[str, ...] = ("perovskite",)
) -> List[Structure]:
    rng = np.random.default_rng(seed)
    makers = {"perovskite": perovskite, "rocksalt": rocksalt}
    return [makers[kinds[i % len(kinds)]](rng) for i in range(n)]


def synthetic_target(structure: Structure) -> float:
    """Deterministic pseudo formation energy for conditioning/regression.

    A smooth function of composition chemistry — electronegativity spread
    and mean ionic radius — so models have real signal to learn.
    """
    zs = structure.atomic_numbers
    en = elements.ELECTRONEGATIVITY[zs]
    en = en[~np.isnan(en)]
    r = elements.MEAN_IONIC_RADIUS_A[zs]
    spread = float(en.max() - en.min()) if len(en) else 0.0
    return -1.5 * spread - 0.8 * float(np.mean(r)) + 0.1 * len(zs)


def synthetic_band_gap(structure: Structure) -> float:
    """Second deterministic pseudo property (nonnegative, gap-like) so the
    multi-property generate->CGCNN loop (reference generate.py:280-286) can
    be exercised end-to-end with two independently-trained regressors.

    Chemically different signal from synthetic_target: mean
    electronegativity and ionization energy push the pseudo gap up, mean
    atomic number pulls it down; clamped at 0 like a real gap.
    """
    zs = structure.atomic_numbers
    if len(zs) == 0:
        return 0.0
    en = elements.ELECTRONEGATIVITY[zs]
    en = float(np.nanmean(en)) if not np.all(np.isnan(en)) else 1.5
    ie = elements.FIRST_IONIZATION_EV[zs]
    ie = float(np.nanmean(ie)) if not np.all(np.isnan(ie)) else 7.0
    return max(0.0, 1.2 * en + 0.35 * ie - 0.05 * float(np.mean(zs)) - 3.0)


def build_dataset(
    path: str,
    n: int = 32,
    seed: int = 0,
    cfg: VoxelizerConfig = VoxelizerConfig(),
    n_rot: int = 0,
    kinds: Tuple[str, ...] = ("perovskite",),
    device="cuda",
) -> GridDataset:
    """Generate, voxelize on device, and write a packed GridDataset.

    Rotation augmentations are exact 90-degree grid rotations (the
    reference's create_matrices.py:174-207 loop), stored as additional rows
    with `_rot_k` ids so data_split's grouping applies.  The heavy lifting
    (padding, chunked device voxelization, augmentation, ground-truth site
    fields) lives in data/voxel_build.voxelize_structures — shared with the
    CIF ingest CLI.
    """
    from icsg3d_torch.data.voxel_build import voxelize_structures

    structures = random_structures(n, seed=seed, kinds=kinds)
    ids = [f"syn-{i}" for i in range(n)]
    targets = [synthetic_target(s) for s in structures]
    out_ids, arrays = voxelize_structures(
        structures, ids, targets, cfg=cfg, n_rot=n_rot, seed=seed,
        device=device,
    )
    return GridDataset.write(path, out_ids, arrays)
