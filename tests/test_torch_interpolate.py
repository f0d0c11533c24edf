"""The port's latent interpolation against icsg3d_tpu, on the CPU in f32.

At d = 8 (VAE filters 4, 8, latent 8; every leaf randomised, the same
variables in both packages) on 12 seeded blob grids with quantile
condition bins (some bins hold one sample, so the sweep skips them):

- ``interpolate_latents`` (z and the condition interpolated) and
  ``interpolate_sweep`` (the same ``default_rng(seed).choice`` pairs, the
  same ids) against JAX's: strips within atol/rtol 1e-4 (f32 rounding
  through encoder and decoder), the endpoints bitwise the input grids.
- The CLI in pair and sweep mode writes its ``.npy`` strips (equal to the
  functions'), ``sweep.json`` and the PNGs; ``--voxels`` adds the 3D rows
  (rendered at resample_d 4 here: at the CLI's 12 a row of renders is slow).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icsg3d_torch import config as tcfg
from icsg3d_torch import viz as tviz
from icsg3d_torch import weights
from icsg3d_torch.apps import interpolate as tinterp
from icsg3d_torch.data.store import GridDataset as TGridDataset
from icsg3d_torch.models import ConditionalDFCVAE as TorchVAE
from icsg3d_tpu.apps import interpolate as jinterp
from icsg3d_tpu.config import GridSpec, VAEConfig
from icsg3d_tpu.data.binning import bin_and_encode
from icsg3d_tpu.data.store import GridDataset
from icsg3d_tpu.models import ConditionalDFCVAE
from test_torch_models import randomize

torch.set_num_threads(1)

D, N, BINS, LATENT = 8, 12, 10, 8
VAE_KW = dict(filters=(4, 8), latent_dim=LATENT, dtype="float32")
TOL = dict(atol=1e-4, rtol=1e-4)


def write_blobs(path, n=N, seed=0):
    """n Gaussian-blob density grids with their coordinate grids and
    targets, at d = D."""
    rng = np.random.default_rng(seed)
    g = np.mgrid[:D, :D, :D].astype(np.float32)
    density = np.stack([
        np.exp(-((g - rng.uniform(2, 6, 3)[:, None, None, None]) ** 2).sum(0) / 3.0)
        for _ in range(n)]).astype(np.float32)
    abc = rng.uniform(3.0, 7.0, (n, 3)).astype(np.float32)
    coords = np.stack([np.moveaxis(g, 0, -1) * a * 1.5 / D for a in abc])
    GridDataset.write(str(path), [f"g{i}" for i in range(n)], {
        "density": density, "coords": coords.astype(np.float32),
        "target": rng.standard_normal(n).astype(np.float32)})
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("interp")
    data = write_blobs(tmp / "data")
    vm = ConditionalDFCVAE(VAEConfig(grid=GridSpec(d=D), **VAE_KW))
    vv = randomize(lambda: vm.init(jax.random.key(0), jnp.zeros((1, D, D, D, 4)),
                                   jnp.zeros((1, BINS)), jax.random.key(1)), seed=40)
    tv = TorchVAE(tcfg.VAEConfig(grid=tcfg.GridSpec(d=D), **VAE_KW)).eval()
    weights.load_flax_variables(tv, vv)
    weights.save_npz(str(tmp / "vae.npz"), vv)
    return dict(tmp=tmp, data=data, vm=vm, vv=vv, tv=tv)


def _grid(ds, i):
    return np.concatenate([np.asarray(ds.arrays["density"][i])[..., None],
                           np.asarray(ds.arrays["coords"][i])], -1).astype(np.float32)


@pytest.mark.parametrize("ia,ib,n", [(0, 5, 10), (3, 3, 2), (7, 1, 1)])
def test_interpolate_latents_matches_jax(setup, ia, ib, n):
    s = setup
    ds = GridDataset(s["data"])
    _, conds, _ = bin_and_encode(np.asarray(ds.arrays["target"]), BINS)
    x_a, x_b = _grid(ds, ia), _grid(ds, ib)
    want = jinterp.interpolate_latents(s["vm"], s["vv"], x_a, conds[ia], x_b,
                                       conds[ib], n)
    got = tinterp.interpolate_latents(s["tv"], x_a, conds[ia], x_b, conds[ib], n)
    assert got.shape == want.shape == (n + 2, D, D, D, 4)
    np.testing.assert_array_equal(got[0], x_a)
    np.testing.assert_array_equal(got[-1], x_b)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_interpolate_sweep_matches_jax(setup, seed):
    s = setup
    ds, tds = GridDataset(s["data"]), TGridDataset(s["data"])
    bin_idx, _, _ = bin_and_encode(np.asarray(ds.arrays["target"]), BINS)
    counts = np.bincount(bin_idx, minlength=BINS)
    assert (counts < 2).any() and (counts >= 2).any()  # skips and strips
    want_rows, want_meta = jinterp.interpolate_sweep(
        s["vm"], s["vv"], ds, bin_idx, BINS, n_interps=4, seed=seed)
    rows, meta = tinterp.interpolate_sweep(s["tv"], tds, bin_idx, BINS,
                                           n_interps=4, seed=seed)
    assert meta == want_meta and len(rows) == int((counts >= 2).sum())
    for row, want, m in zip(rows, want_rows, meta):
        assert row.shape == (6, D, D, D, 4)
        np.testing.assert_array_equal(row[0], _grid(ds, ds.index[m["a"]]))
        np.testing.assert_array_equal(row[-1], _grid(ds, ds.index[m["b"]]))
        np.testing.assert_allclose(row, want, **TOL)


def test_interpolate_cli_writes_strips_and_plots(setup, monkeypatch):
    s = setup
    real = tviz.plot_voxels_3d
    monkeypatch.setattr(tviz, "plot_voxels_3d",
                        lambda g, **kw: real(g, **{**kw, "resample_d": 4}))
    base = ["--data", s["data"], "--vae-ckpt", str(s["tmp"] / "vae.npz"),
            "--filters", "4,8", "--latent", str(LATENT), "--device", "cpu"]
    out = s["tmp"] / "pair"
    grids = tinterp.main(base + ["--a", "g0", "--b", "g5", "--ninterps", "3",
                                 "--output", str(out)])
    assert sorted(os.listdir(out)) == ["interpolation.npy", "interpolation.png"]
    np.testing.assert_array_equal(np.load(out / "interpolation.npy"), grids)
    ds = GridDataset(s["data"])
    _, conds, _ = bin_and_encode(np.asarray(ds.arrays["target"]), BINS)
    np.testing.assert_allclose(grids, jinterp.interpolate_latents(
        s["vm"], s["vv"], _grid(ds, 0), conds[0], _grid(ds, 5), conds[5], 3), **TOL)

    out = s["tmp"] / "sweep"
    rows, meta = tinterp.main(base + ["--sweep-conds", "--ninterps", "2", "--seed",
                                      "1", "--voxels", "--output", str(out)])
    with open(out / "sweep.json") as f:
        assert json.load(f) == meta
    for row, m in zip(rows, meta):
        stem = f"interpolation_bin{m['bin']}"
        np.testing.assert_array_equal(np.load(out / f"{stem}.npy"), row)
        assert (out / f"{stem}.png").stat().st_size > 0
        assert (out / f"{stem}_3d.png").stat().st_size > 0
    assert len(os.listdir(out)) == 3 * len(rows) + 1


def test_interpolate_cli_pair_mode_needs_both_ids(setup):
    with pytest.raises(SystemExit):
        tinterp.main(["--data", setup["data"], "--vae-ckpt", "none", "--a", "g0",
                      "--device", "cpu"])
