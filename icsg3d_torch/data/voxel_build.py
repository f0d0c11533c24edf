"""Shared chunked voxelize + rotation-augment pipeline.

Counterpart of icsg3d_tpu/data/voxel_build.py: the one owner of the
structure -> packed-arrays path used by both dataset builders
(apps/voxelize.py for CIF ingest, data/synthetic.py for synthetic data).
Each chunk of structures is one launch of the voxelizer kernel K4 on the
card (ops/voxelize.voxelize_batch); the rotations run on the host with
``np.rot90`` from the same ``default_rng(seed + 1)`` draws as the JAX
package, so ids and arrays equal its own.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from icsg3d_torch.config import VoxelizerConfig
from icsg3d_torch.crystal.structure import Structure
from icsg3d_torch.ops.rotations import AXES_CHOICES
from icsg3d_torch.ops.voxelize import (
    coordinate_grids_np,
    pad_sites,
    voxelize_batch,
)


def default_chunk(d: int) -> int:
    """Voxelization chunk scaled to grid volume (256 at 32^3): bounds the
    plain version's (voxels x sites) temporaries and the chunk's output."""
    return max(8, int(256 * (32 / d) ** 3))


def voxelize_structures(
    structures: Sequence[Structure],
    ids: Sequence[str],
    targets: Sequence[float],
    cfg: VoxelizerConfig = VoxelizerConfig(),
    n_rot: int = 0,
    seed: int = 0,
    chunk: Optional[int] = None,
    device="cuda",
) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """Voxelize structures on ``device`` in chunks; returns (ids, field
    arrays).  ``device`` "cuda" raises when CUDA is unavailable."""
    from icsg3d_torch.apps.common import resolve_device

    device = resolve_device(str(device))
    grid = cfg.grid
    chunk = chunk or default_chunk(grid.d)
    keep_idx, sites_b, z_b, sig_b, mask_b, abc_b = [], [], [], [], [], []
    for i, s in enumerate(structures):
        n = len(s)
        if n == 0 or n > cfg.max_sites or n > cfg.site_pad:
            continue  # skip over-large structures (cgcnn/data.py:161 analog)
        N, z, r = s.site_arrays()
        # the grids sample an axis-aligned box [-eps*l, (1+eps)*l] per axis,
        # so sites map as frac * abc (create_matrices.py: np.multiply(N,
        # lattice_vector[:3])), not through the skew lattice matrix
        cart = N * np.asarray(s.lattice.abc, np.float64)
        arr = pad_sites(cart, z, r * cfg.sigma_frac, cfg.site_pad)
        keep_idx.append(i)
        sites_b.append(arr[0]); z_b.append(arr[1]); sig_b.append(arr[2])
        mask_b.append(arr[3])
        abc_b.append(np.array(s.lattice.abc, np.float32))

    def dev(arrs):
        return torch.from_numpy(np.stack(arrs)).to(device)

    out_ids: List[str] = []
    Ms, Ss, Cs, Ls, Ts = [], [], [], [], []
    for c0 in range(0, len(keep_idx), chunk):
        sl = slice(c0, c0 + chunk)
        M, S = voxelize_batch(
            dev(sites_b[sl]), dev(z_b[sl]), dev(sig_b[sl]), dev(mask_b[sl]),
            dev(abc_b[sl]), grid, label_frac=cfg.label_frac,
        )
        Ms.append(M.cpu().numpy())
        Ss.append(S.cpu().numpy().astype(np.uint8))
        ks = range(*sl.indices(len(keep_idx)))
        Cs.append(coordinate_grids_np(np.stack([abc_b[k] for k in ks]), grid))
        for k in ks:
            i = keep_idx[k]
            Ls.append(np.array(structures[i].lattice.parameters, np.float32))
            Ts.append(np.float32(targets[i]))
            out_ids.append(ids[i])

    if not out_ids:
        empty_shape = (0,) + grid.shape
        return [], {
            "density": np.zeros(empty_shape, np.float32),
            "coords": np.zeros(empty_shape + (3,), np.float32),
            "species": np.zeros(empty_shape, np.uint8),
            "lattice": np.zeros((0, 6), np.float32),
            "target": np.zeros((0,), np.float32),
            "sites": np.zeros((0, cfg.site_pad, 3), np.float32),
            "site_z": np.zeros((0, cfg.site_pad), np.float32),
        }

    M = np.concatenate(Ms)
    S = np.concatenate(Ss)
    C = np.concatenate(Cs)
    L = np.stack(Ls)
    T = np.asarray(Ts, np.float32)
    true_sites = np.stack(sites_b).astype(np.float32)
    true_z = (np.stack(z_b) * np.stack(mask_b)).astype(np.float32)

    if n_rot:
        rng = np.random.default_rng(seed + 1)
        aM, aS, aC = [M], [S], [C]
        aL, aT = [L], [T]
        aSites, aZ = [true_sites], [true_z]
        all_ids = list(out_ids)
        for i in range(len(out_ids)):
            for r in range(n_rot):
                m, s_, c = M[i], S[i], C[i]
                for axes_i in rng.integers(0, len(AXES_CHOICES), size=3):
                    ax = AXES_CHOICES[axes_i]
                    m = np.rot90(m, 1, axes=ax)
                    s_ = np.rot90(s_, 1, axes=ax)
                    c = np.rot90(c, 1, axes=ax)
                aM.append(m[None]); aS.append(s_[None]); aC.append(c[None])
                aL.append(L[i][None]); aT.append(T[i][None])
                # unrotated-frame ground truth (eval splits use n_rot=0)
                aSites.append(true_sites[i][None]); aZ.append(true_z[i][None])
                all_ids.append(f"{out_ids[i]}_rot_{r}")
        M, S, C = np.concatenate(aM), np.concatenate(aS), np.concatenate(aC)
        L, T = np.concatenate(aL), np.concatenate(aT)
        true_sites = np.concatenate(aSites); true_z = np.concatenate(aZ)
        out_ids = all_ids

    return out_ids, {
        "density": M, "coords": C, "species": S, "lattice": L, "target": T,
        "sites": true_sites, "site_z": true_z,
    }
