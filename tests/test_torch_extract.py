"""Extraction parity: the port's batched binary extraction
(icsg3d_torch/ops/extract.py) against icsg3d_tpu's ``extract_atoms(...,
method="binary", erosion_levels=1)`` on the blob fixtures of
tests/test_extract.py, plus the grid transforms.

Atoms and ``valid`` must be equal exactly; centroids (means of integer
voxel coordinates) agree to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icsg3d_torch.config import GridSpec as TGridSpec
from icsg3d_torch.ops import extract as textract
from icsg3d_torch.ops import grid as tgrid
from icsg3d_tpu.config import GridSpec
from icsg3d_tpu.ops import extract as jextract
from icsg3d_tpu.ops import grid as jgrid

torch.set_num_threads(1)


def gaussian_blob(d, center, sigma=1.5):
    g = np.mgrid[:d, :d, :d].astype(float)
    d2 = sum((g[i] - center[i]) ** 2 for i in range(3))
    return np.exp(-d2 / (2 * sigma**2))


def _single_blob():
    M = gaussian_blob(16, (8, 8, 8))
    Sb = (M > 0.1).astype(np.int32)
    return M, np.where(Sb, 26, 0), Sb


def _two_blobs():
    M = gaussian_blob(20, (5, 5, 5)) + gaussian_blob(20, (14, 14, 14))
    Sb = (M > 0.1).astype(np.int32)
    return M, np.where(Sb, 8, 0), Sb


def _dumbbell():
    M = gaussian_blob(26, (8, 13, 13), 2.0) + gaussian_blob(26, (17, 13, 13), 2.0)
    Sb = (M > 0.08).astype(np.int32)
    return M, np.where(Sb, 13, 0), Sb


def _species_confused():
    M = gaussian_blob(24, (12, 12, 12), 3.0)
    Sb = (M > 0.08).astype(np.int32)
    S = np.where(Sb, 26, 0)
    rng = np.random.default_rng(0)
    S[(rng.random(S.shape) < 0.3) & (Sb > 0)] = 25
    return M, S, Sb


def _empty():
    z = np.zeros((8, 8, 8))
    return z, z.astype(np.int32), z.astype(np.int32)


CASES = {
    "single_blob": _single_blob,
    "two_blobs": _two_blobs,
    "dumbbell": _dumbbell,
    "species_confused": _species_confused,
    "empty": _empty,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_binary_extraction_matches_jax(name):
    M, S, Sb = CASES[name]()
    S = S.astype(np.int32)
    ja, jmu, jv = jextract.extract_atoms(
        jnp.asarray(M, jnp.float32), jnp.asarray(S), jnp.asarray(Sb),
        max_atoms=8, method="binary", erosion_levels=1,
    )
    ta, tmu, tv = textract.extract_atoms(
        torch.from_numpy(S[None]), torch.from_numpy(Sb[None]), max_atoms=8,
        erosion_levels=1,
    )
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja))
    np.testing.assert_allclose(tmu[0].numpy(), np.asarray(jmu), atol=1e-5)


def test_batch_is_each_sample_alone():
    """A batch iterates until its slowest sample converges; the others must
    come out as they would alone."""
    grids = [_single_blob(), _two_blobs()]
    d = 20
    S = np.zeros((2, d, d, d), np.int32)
    Sb = np.zeros((2, d, d, d), np.int32)
    _, S[0, :16, :16, :16], Sb[0, :16, :16, :16] = grids[0]
    _, S[1], Sb[1] = grids[1]
    batch = textract.extract_atoms(
        torch.from_numpy(S), torch.from_numpy(Sb), max_atoms=8
    )
    for i in range(2):
        alone = textract.extract_atoms(
            torch.from_numpy(S[i:i + 1]), torch.from_numpy(Sb[i:i + 1]),
            max_atoms=8,
        )
        for b, a in zip(batch, alone):
            np.testing.assert_array_equal(b[i].numpy(), a[0].numpy())


def test_top_regions_by_size_ties_keep_the_smaller_label():
    n_vox = 16
    # regions 3 and 9 both hold 4 voxels, region 12 holds 5; background 16
    labels = np.array([3, 3, 3, 3, 9, 9, 9, 9, 12, 12, 12, 12, 12, 16, 16, 16],
                      np.int32)
    perm = np.random.default_rng(0).permutation(n_vox)
    labels = labels[perm]
    jl, js, jv = jextract.top_regions_by_size(jnp.asarray(labels), 4, 1, n_vox)
    tl, ts, tv = textract.top_regions_by_size(
        torch.from_numpy(labels[None]), 4, 1, n_vox
    )
    assert tl[0].tolist() == [12, 3, 9, 16] == np.asarray(jl).tolist()
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))


def test_grid_transforms_match_jax():
    rng = np.random.default_rng(1)
    coords = rng.uniform(-2, 9, (3, 8, 8, 8, 3)).astype(np.float32)
    mu = rng.uniform(0, 7, (3, 5, 3)).astype(np.float32)
    jg, tg = GridSpec(d=8), TGridSpec(d=8)
    jl = jgrid.to_lattice_params(jnp.asarray(coords), jg)
    tl = tgrid.to_lattice_params(torch.from_numpy(coords), tg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    jdv = jgrid.to_voxel_params(jl, jg)
    tdv = tgrid.to_voxel_params(tl, tg)
    np.testing.assert_allclose(tdv.numpy(), np.asarray(jdv), rtol=1e-6)
    jc = jgrid.voxel_to_cartesian(jnp.asarray(mu), jl[:, None], jdv[:, None], jg)
    tc = tgrid.voxel_to_cartesian(torch.from_numpy(mu), tl[:, None], tdv[:, None], tg)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
