"""Extraction parity: the port's batched binary extraction
(icsg3d_torch/ops/extract.py) against icsg3d_tpu's ``extract_atoms(...,
method="binary", erosion_levels=1)`` on the blob fixtures of
tests/test_extract.py, plus the grid transforms; and the two loops
(``connected_components_same_value``, ``nearest_seed_labels``) against
JAX's on the adversarial grids of tests/test_torch_extract_plan.py.

Atoms, ``valid`` and every label must be equal exactly; centroids (means
of integer voxel coordinates) agree to 1e-5.
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
from test_torch_extract_plan import BLOB_CASES, adversarial, bfs_operands

torch.set_num_threads(1)


# the extraction fixtures, shared with the schedule replays
CASES = BLOB_CASES


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
    grids = [CASES["single_blob"](), CASES["two_blobs"]()]
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


@pytest.mark.parametrize("name", sorted(adversarial()))
def test_loops_match_jax_on_adversarial_grids(name):
    """Equidistant seeds (tie), the one-voxel-wide snake, the full grid, a
    multi-valued grid, a non-cubic grid and the empty one: the port's two
    loops on the CPU equal JAX's exactly, and so does the extraction."""
    grid, seeds = adversarial()[name]
    seeds_t = None if seeds is None else torch.from_numpy(seeds[None])
    seed, cc, fg, seed_labels = bfs_operands(torch.from_numpy(grid[None]), seeds_t)
    tcc = textract.connected_components_same_value(torch.from_numpy(grid[None]))
    jcc = jextract.connected_components_same_value(jnp.asarray(grid))
    np.testing.assert_array_equal(tcc[0].numpy(), np.asarray(jcc))
    tlab = textract.nearest_seed_labels(seed, cc, fg, seed_labels)
    jlab = jextract.nearest_seed_labels(
        jnp.asarray(seed[0].numpy()), jnp.asarray(cc[0].numpy()),
        jnp.asarray(fg[0].numpy()),
        None if seed_labels is None else jnp.asarray(seed_labels[0].numpy()))
    np.testing.assert_array_equal(tlab[0].numpy(), np.asarray(jlab))
    mask = (grid > 0).astype(np.int32)
    ja, jmu, jv = jextract.extract_atoms(
        jnp.zeros(grid.shape, jnp.float32), jnp.asarray(grid), jnp.asarray(mask),
        max_atoms=8, method="binary", erosion_levels=1,
    )
    ta, tmu, tv = textract.extract_atoms(
        torch.from_numpy(grid[None]), torch.from_numpy(mask[None]), max_atoms=8)
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja))
    np.testing.assert_allclose(tmu[0].numpy(), np.asarray(jmu), atol=1e-5)
