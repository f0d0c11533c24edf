"""The port's dataset build (voxelizer, rotations, chunked build, CLI)
against icsg3d_tpu, on the CPU.

- ``voxelize_reference`` (the plain version of the voxelizer kernel K4,
  what ``voxelize_batch`` runs on CPU tensors) against JAX's XLA
  ``ops.voxelize.voxelize`` and the Pallas kernel in interpret mode:
  species exact, density rtol 2e-4 / atol 1e-6 (the JAX package's own
  bound between its two implementations: sums over sites in another
  order).
- The conflict rule on the hand-built case of tests/test_voxelize.py, and
  padding that is inert.
- The geometry helpers and the rotations exactly equal JAX's.
- ``voxelize_structures``, ``build_from_cifs``, ``build_dataset`` and the
  CLI against JAX's builds: identical ids and species, every other field
  within the density bound.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icsg3d_torch.apps import voxelize as tapp
from icsg3d_torch.config import GridSpec as TGrid
from icsg3d_torch.config import VoxelizerConfig as TVoxCfg
from icsg3d_torch.data import synthetic as tsyn
from icsg3d_torch.data.store import GridDataset
from icsg3d_torch.data.voxel_build import voxelize_structures as t_build
from icsg3d_torch.ops import rotations as trot
from icsg3d_tpu.apps import voxelize as japp
from icsg3d_tpu.config import GridSpec, VoxelizerConfig
from icsg3d_tpu.data import synthetic as jsyn
from icsg3d_tpu.data.voxel_build import voxelize_structures as j_build
from icsg3d_tpu.ops.pallas_voxelize import voxelize_pallas
from test_voxelize import make_structure, oracle_density_matrix

tvox = importlib.import_module("icsg3d_torch.ops.voxelize")
jvox = importlib.import_module("icsg3d_tpu.ops.voxelize")
jrot = importlib.import_module("icsg3d_tpu.ops.rotations")

torch.set_num_threads(1)

DENSITY = dict(rtol=2e-4, atol=1e-6)
REAL_CIFS = "tests/fixtures/real_cifs"


def _structure_arrays(seed, site_pad=128):
    """test_pallas_voxelize.py's inputs: one synthetic structure, cartesian
    sites, padded to ``site_pad`` (the Pallas kernel takes at most 128)."""
    s = jsyn.random_structures(1, seed=seed, kinds=("perovskite", "rocksalt"))[0]
    N, z, r = s.site_arrays()
    arrs = jvox.pad_sites(s.lattice.cartesian(N), z, r, site_pad)
    return (*arrs, np.array(s.lattice.abc, np.float32))


def _port(arrs, d, label_frac=1.0):
    M, S = tvox.voxelize(*(torch.from_numpy(np.asarray(a)) for a in arrs),
                         TGrid(d=d), label_frac)
    return M.numpy(), S.numpy()


@pytest.mark.parametrize("seed,d", [(0, 16), (1, 16), (2, 16), (7, 32)])
def test_reference_matches_xla_and_pallas(seed, d):
    arrs = _structure_arrays(seed)
    jarrs = [jnp.asarray(a) for a in arrs]
    M, S = _port(arrs, d)
    assert M.shape == S.shape == (d, d, d) and M.dtype == np.float32
    for impl in (jvox.voxelize, lambda *a: voxelize_pallas(*a, interpret=True)):
        M_ref, S_ref = impl(*jarrs, GridSpec(d=d))
        np.testing.assert_array_equal(S, np.asarray(S_ref))
        np.testing.assert_allclose(M, np.asarray(M_ref), **DENSITY)
    assert set(np.unique(S)) <= {0.0} | set(arrs[1][arrs[3] > 0].tolist())


def test_species_conflict_rule():
    """Voxels inside both radii take the closer site; inside exactly one,
    that site even when the other is closer (utils.py:120-131)."""
    N = np.array([[2.0, 2.0, 2.0], [3.2, 2.0, 2.0]])
    z = np.array([10.0, 20.0])
    sigma = np.array([1.5, 0.7])
    abc = np.array([4.0, 4.0, 4.0])
    M_want, S_want = oracle_density_matrix(N, z, abc, sigma=sigma)
    arrs = (*tvox.pad_sites(N, z, sigma, site_pad=4), abc.astype(np.float32))
    M, S = _port(arrs, 16)
    _, S_jax = jvox.voxelize(*(jnp.asarray(a) for a in arrs), GridSpec(d=16))
    np.testing.assert_array_equal(S, S_want)
    np.testing.assert_array_equal(S, np.asarray(S_jax))
    np.testing.assert_allclose(M, M_want, **DENSITY)
    assert set(np.unique(S)) == {0.0, 10.0, 20.0}


def test_label_frac_matches_jax():
    arrs = _structure_arrays(3, site_pad=16)
    M, S = _port(arrs, 16, label_frac=0.6)
    M_ref, S_ref = jvox.voxelize(*(jnp.asarray(a) for a in arrs), GridSpec(d=16),
                                 label_frac=0.6)
    np.testing.assert_array_equal(S, np.asarray(S_ref))
    np.testing.assert_allclose(M, np.asarray(M_ref), **DENSITY)


def test_padding_is_inert(rng):
    N, z, sigma, abc = make_structure(rng, nsites=3)
    abc = abc.astype(np.float32)
    M8, S8 = _port((*tvox.pad_sites(N, z, sigma, site_pad=8), abc), 16)
    M64, S64 = _port((*tvox.pad_sites(N, z, sigma, site_pad=64), abc), 16)
    np.testing.assert_array_equal(S8, S64)
    np.testing.assert_allclose(M8, M64, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="site_pad"):
        tvox.pad_sites(N, z, sigma, site_pad=2)


def test_batch_equals_per_structure():
    arrs = [_structure_arrays(s, site_pad=16) for s in (4, 5, 6)]
    stacked = [torch.from_numpy(np.stack([a[i] for a in arrs])) for i in range(5)]
    M, S = tvox.voxelize_batch(*stacked, TGrid(d=8))
    assert M.shape == (3, 8, 8, 8)
    for b, a in enumerate(arrs):
        Mb, Sb = _port(a, 8)
        np.testing.assert_array_equal(M[b].numpy(), Mb)
        np.testing.assert_array_equal(S[b].numpy(), Sb)


@pytest.mark.parametrize("d", [8, 16, 32])
def test_geometry_helpers_equal_jax(d):
    abc = np.array([4.1, 5.3, 6.7], np.float32)
    grid, tgrid = GridSpec(d=d), TGrid(d=d)
    np.testing.assert_array_equal(
        tvox.voxel_centers(torch.from_numpy(abc), tgrid).numpy(),
        np.asarray(jvox.voxel_centers(jnp.asarray(abc), grid)))
    np.testing.assert_array_equal(
        tvox.coordinate_grid(torch.from_numpy(abc), tgrid).numpy(),
        np.asarray(jvox.coordinate_grid(jnp.asarray(abc), grid)))
    np.testing.assert_array_equal(
        tvox._axis_points(torch.tensor(5.3), d, 0.25).numpy(),
        np.asarray(jvox._axis_points(jnp.float32(5.3), d, 0.25)))
    batch = np.array([[4.1, 5.3, 6.7], [3.0, 3.5, 9.25]], np.float32)
    np.testing.assert_array_equal(tvox.coordinate_grids_np(batch, tgrid),
                                  jvox.coordinate_grids_np(batch, grid))


def test_rotations_equal_jnp_rot90():
    x = np.arange(4 * 4 * 4 * 2, dtype=np.float32).reshape(4, 4, 4, 2)
    for axes in trot.AXES_CHOICES:
        for k in range(4):
            np.testing.assert_array_equal(
                trot.rotate90(torch.from_numpy(x), axes, k).numpy(),
                np.asarray(jrot.rotate90(jnp.asarray(x), axes, k)))
    np.testing.assert_array_equal(
        trot.all_octahedral_rotations(torch.from_numpy(x)).numpy(),
        np.asarray(jrot.all_octahedral_rotations(jnp.asarray(x))))
    assert trot.AXES_CHOICES == jrot.AXES_CHOICES


def test_random_rotation_preserves_labels_and_mass(rng):
    M = torch.from_numpy(rng.random((8, 8, 8)))
    S = torch.from_numpy(rng.integers(0, 5, (8, 8, 8)).astype(float))
    p = torch.from_numpy(rng.random((8, 8, 8, 3)))
    M2, S2, p2 = trot.random_rotation_3d(torch.Generator().manual_seed(0), M, S, p)
    assert torch.equal(torch.unique(S2), torch.unique(S))
    assert np.isclose(float(M2.sum()), float(M.sum()))
    assert np.isclose(float(p2.sum()), float(p.sum()))
    # the same draws rotate all three alike: the species move with the density
    assert torch.equal(S2[M2 == M.max()], S[M == M.max()])


def _assert_builds_equal(t_out, j_out):
    t_ids, t_arr = t_out
    j_ids, j_arr = j_out
    assert t_ids == j_ids and len(t_ids) > 0
    assert set(t_arr) == set(j_arr)
    for k, v in j_arr.items():
        assert t_arr[k].dtype == v.dtype and t_arr[k].shape == v.shape, k
        if k == "species":
            np.testing.assert_array_equal(t_arr[k], v)
        else:
            np.testing.assert_allclose(t_arr[k], v, err_msg=k, **DENSITY)


def test_voxelize_structures_with_rotations_matches_jax():
    structures = jsyn.random_structures(6, seed=5, kinds=("perovskite", "rocksalt"))
    ids = [f"s{i}" for i in range(6)]
    targets = list(np.linspace(-1, 1, 6))
    kw = dict(n_rot=2, seed=3, chunk=4)
    t_out = t_build(structures, ids, targets, TVoxCfg(grid=TGrid(d=8)), device="cpu", **kw)
    j_out = j_build(structures, ids, targets, VoxelizerConfig(grid=GridSpec(d=8)), **kw)
    _assert_builds_equal(t_out, j_out)
    assert sum("_rot_" in i for i in t_out[0]) == 12
    empty = t_build([], [], [], TVoxCfg(grid=TGrid(d=8)), device="cpu")
    assert empty[0] == [] and empty[1]["species"].shape == (0, 8, 8, 8)


def _read(path):
    ds = GridDataset(path)
    return ds.ids, {k: np.asarray(v) for k, v in ds.arrays.items()}


def test_build_from_cifs_matches_jax(tmp_path):
    kw = dict(targets_csv=f"{REAL_CIFS}/targets.csv", n_rot=1, seed=2)
    tapp.build_from_cifs(REAL_CIFS, str(tmp_path / "t"), device="cpu",
                         cfg=TVoxCfg(grid=TGrid(d=16)), **kw)
    japp.build_from_cifs(REAL_CIFS, str(tmp_path / "j"),
                         cfg=VoxelizerConfig(grid=GridSpec(d=16)), **kw)
    _assert_builds_equal(_read(str(tmp_path / "t")), _read(str(tmp_path / "j")))


def test_build_from_cifs_in_parts_merges_to_the_whole(tmp_path):
    cfg = TVoxCfg(grid=TGrid(d=8))
    for k in range(2):
        tapp.build_from_cifs(REAL_CIFS, str(tmp_path / "parts"), cfg=cfg,
                             process_index=k, process_count=2, device="cpu")
    merged = tapp.merge_parts(str(tmp_path / "parts"))
    whole = tapp.build_from_cifs(REAL_CIFS, str(tmp_path / "whole"), cfg=cfg,
                                 device="cpu")
    assert sorted(merged.ids) == sorted(whole.ids)
    rows = [merged.index[i] for i in whole.ids]
    np.testing.assert_array_equal(np.asarray(merged.arrays["species"])[rows],
                                  np.asarray(whole.arrays["species"]))
    assert tapp.merge_parts(str(tmp_path / "whole")).ids == whole.ids


def test_build_dataset_matches_jax(tmp_path):
    kw = dict(n=5, seed=1, n_rot=1, kinds=("perovskite", "rocksalt"))
    tsyn.build_dataset(str(tmp_path / "t"), cfg=TVoxCfg(grid=TGrid(d=8)),
                       device="cpu", **kw)
    jsyn.build_dataset(str(tmp_path / "j"), cfg=VoxelizerConfig(grid=GridSpec(d=8)),
                       **kw)
    _assert_builds_equal(_read(str(tmp_path / "t")), _read(str(tmp_path / "j")))


def test_cli_synthetic_form_matches_jax(tmp_path):
    """README form: voxelize --synthetic N --out data/synth --d 8."""
    argv = ["--synthetic", "40", "--d", "8", "--nrot", "0",
            "--kinds", "perovskite,rocksalt", "--seed", "0"]
    ds = tapp.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    assert len(ds) == 40
    japp.main(argv + ["--out", str(tmp_path / "j")])
    _assert_builds_equal(_read(str(tmp_path / "t")), _read(str(tmp_path / "j")))


def test_cli_cif_form_with_rotations(tmp_path):
    """MIGRATION form: voxelize --cifs --targets-csv --target --out --d
    --nrot --sigma-frac, on a CIF corpus written from synthetic
    structures."""
    import csv

    from icsg3d_torch.crystal.cif import write_cif

    cif_dir = tmp_path / "cifs"
    cif_dir.mkdir()
    rows = []
    for i, s in enumerate(tsyn.random_structures(10, seed=3,
                                                 kinds=("perovskite", "rocksalt"))):
        write_cif(s, str(cif_dir / f"mp-{i}.cif"), name=f"mp-{i}")
        rows.append({"task_id": f"mp-{i}", "formation_energy_per_atom": -1.0 - 0.1 * i})
    with open(tmp_path / "targets.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    argv = ["--cifs", str(cif_dir), "--targets-csv", str(tmp_path / "targets.csv"),
            "--target", "formation_energy_per_atom", "--d", "8", "--nrot", "1",
            "--sigma-frac", "1.0"]
    ds = tapp.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    assert len(ds) == 20 and any("_rot_" in i for i in ds.ids)
    japp.main(argv + ["--out", str(tmp_path / "j")])
    _assert_builds_equal(_read(str(tmp_path / "t")), _read(str(tmp_path / "j")))


def test_cli_requires_an_input(tmp_path):
    with pytest.raises(SystemExit):
        tapp.main(["--out", str(tmp_path / "x"), "--device", "cpu"])
