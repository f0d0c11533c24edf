"""The port's reconstruction evaluation against icsg3d_tpu, on the CPU in f32.

``evaluate_reconstructions`` at d = 8 (VAE filters 4, 8, latent 8; the
small 12-class U-Net of test_torch_models) on a synthetic build of 12
structures (3 validation samples at batch 2, so the id list is padded),
with every leaf of both models randomised, the occupancy threshold set in
the widest gap of the JAX sigmoids (no sigmoid within 1e-3 of it), and
JAX's reparameterization noise passed in: the per-sample atom-count errors
and the counts equal, the EMDs and lattices within atol 1e-4 / rtol 1e-4
(as the generation tests: f32 rounding through the VAE and the lattice
span), with true atoms from the stored sites and from a watershed of the
true grids, and with ``merge_closer_than``.  Then the CLI on the CPU at
production width (d = 16).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icsg3d_torch import config as tcfg
from icsg3d_torch import weights
from icsg3d_torch.apps import evaluate as teval
from icsg3d_torch.data.store import GridDataset as TGridDataset
from icsg3d_torch.models import ConditionalDFCVAE as TorchVAE
from icsg3d_torch.models import UNet3D as TorchUNet
from icsg3d_tpu.apps import common as jcommon
from icsg3d_tpu.apps import evaluate as jeval
from icsg3d_tpu.config import (GridSpec, PipelineConfig, UNetConfig, VAEConfig,
                               VoxelizerConfig)
from icsg3d_tpu.data import synthetic as jsynthetic
from icsg3d_tpu.data.binning import bin_and_encode
from icsg3d_tpu.data.splits import data_split
from icsg3d_tpu.data.store import GridDataset
from icsg3d_tpu.models import ConditionalDFCVAE, UNet3D
from test_torch_generate import MARGIN, threshold_in_gap, widen_occupancy_head
from test_torch_models import UNET_KW, randomize

torch.set_num_threads(1)

D, BATCH, LATENT = 8, 2, 8
VAE_KW = dict(filters=(4, 8), latent_dim=LATENT, dtype="float32")


def jax_noise(n_batches, seed=0):
    """The noise JAX's evaluate draws: one split of key(seed) per batch."""
    key, out = jax.random.key(seed), []
    for _ in range(n_batches):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (BATCH, LATENT), jnp.float32)))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    ds = jsynthetic.build_dataset(
        str(tmp / "sites"), n=12, seed=0, cfg=VoxelizerConfig(grid=GridSpec(d=D)),
        kinds=("perovskite", "rocksalt"))
    assert {"sites", "site_z", "species", "lattice"} <= set(ds.arrays)
    GridDataset.write(str(tmp / "grids"), ds.ids, {
        k: np.asarray(v) for k, v in ds.arrays.items() if k not in ("sites", "site_z")})
    _, conds, _ = bin_and_encode(np.asarray(ds.arrays["target"]), 10)
    _, val_ids = data_split(ds.ids, frac=0.8, n_rot=0)
    assert len(val_ids) % BATCH  # the id list gets padded
    conds_val = conds[[ds.index[i] for i in val_ids]]
    n_batches = -(-len(val_ids) // BATCH)
    noise = jax_noise(n_batches)

    vm = ConditionalDFCVAE(VAEConfig(grid=GridSpec(d=D), **VAE_KW))
    um = UNet3D(UNetConfig(**UNET_KW))
    x0 = jnp.zeros((1, D, D, D, 4))
    vv = randomize(lambda: vm.init(jax.random.key(0), x0, jnp.zeros((1, 10)),
                                   jax.random.key(1)), seed=30)
    uv = randomize(lambda: um.init(jax.random.key(0), x0, train=False), seed=31)
    # the reconstructions evaluate will segment, with JAX's noise
    rows = [ds.index[i] for i in val_ids] + [ds.index[val_ids[-1]]] * (
        n_batches * BATCH - len(val_ids))
    x = jcommon.grid_input(np.asarray(ds.arrays["density"])[rows],
                           np.asarray(ds.arrays["coords"])[rows])
    c = np.concatenate([conds_val, conds_val[-1:].repeat(len(rows) - len(val_ids), 0)])
    recon = jnp.concatenate([
        vm.apply(vv, jnp.asarray(x[b * BATCH:(b + 1) * BATCH]),
                 jnp.asarray(c[b * BATCH:(b + 1) * BATCH]), method=_decode_with(noise[b]))
        for b in range(n_batches)])
    uv = widen_occupancy_head(uv, um.apply(uv, recon, train=False)[1])
    thr, half_gap = threshold_in_gap(um.apply(uv, recon, train=False)[1][..., 0])
    assert half_gap >= MARGIN

    tv = TorchVAE(tcfg.VAEConfig(grid=tcfg.GridSpec(d=D), **VAE_KW)).eval()
    tu = TorchUNet(tcfg.UNetConfig(**UNET_KW)).eval()
    weights.load_flax_variables(tv, vv)
    weights.load_flax_variables(tu, uv)
    return dict(tmp=tmp, vm=vm, vv=vv, um=um, uv=uv, tv=tv, tu=tu, val_ids=val_ids,
                conds_val=conds_val, noise=noise, thr=thr)


def _decode_with(eps):
    """A Flax method that runs the VAE's evaluation pass with ``eps`` as the
    reparameterization noise (the reconstruction only)."""
    def run(module, x, cond):
        z_mean, z_log_var = module.encoder(x, cond)
        z = z_mean + jnp.exp(0.5 * z_log_var) * jnp.asarray(eps)
        return module.decoder(z, cond)
    return run


@pytest.mark.parametrize("data,merge", [("sites", 0.0), ("grids", 0.0),
                                        ("sites", 0.7)])
def test_evaluate_matches_jax(setup, data, merge):
    s = setup
    path = str(s["tmp"] / data)
    pipe = PipelineConfig(grid=GridSpec(d=D), binary_threshold=s["thr"])
    want = jeval.evaluate_reconstructions(
        s["vm"], s["vv"], s["um"], s["uv"], GridDataset(path), s["val_ids"],
        s["conds_val"], batch_size=BATCH, pipe=pipe, seed=0, merge_closer_than=merge)
    tpipe = tcfg.PipelineConfig(grid=tcfg.GridSpec(d=D), binary_threshold=s["thr"])
    got = teval.evaluate_reconstructions(
        s["tv"], s["tu"], TGridDataset(path), s["val_ids"], s["conds_val"],
        batch_size=BATCH, pipe=tpipe, merge_closer_than=merge, noise=s["noise"])
    assert set(got) == set(want)
    assert want["n_evaluated"] == len(s["val_ids"]) and want["n_skipped"] == 0
    assert sum(want["datoms"]) > 0 or data == "grids"
    for k in ("n_evaluated", "n_skipped", "n_emd_undefined", "datoms", "first_error"):
        assert got[k] == want[k], k
    for k in ("emds", "lattice_true", "lattice_pred", "mean_dlattice"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4, err_msg=k)
    for k in ("mean_emd", "mean_datoms"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4, err_msg=k)


def test_evaluate_cli_on_the_cpu(tmp_path, capsys):
    """The CLI at production width (VAE filters 16-128, latent 256, the
    95-class U-Net; seeded, no checkpoint) on a d = 16 synthetic build,
    torch noise from --seed: every validation sample is evaluated or
    skipped, stdout and --output are strict JSON, and the run repeats
    exactly."""
    from icsg3d_torch.data.synthetic import build_dataset

    ds = build_dataset(str(tmp_path / "data"), n=8, seed=1,
                       cfg=tcfg.VoxelizerConfig(grid=tcfg.GridSpec(d=16)),
                       kinds=("perovskite", "rocksalt"), device="cpu")
    _, val_ids = data_split(ds.ids, frac=0.8, n_rot=0)
    argv = ["--data", str(tmp_path / "data"), "--vae-ckpt", "none",
            "--unet-ckpt", "none", "--batch-size", "2", "--device", "cpu",
            "--seed", "3", "--output", str(tmp_path / "eval.json")]
    res = teval.main(argv)
    summary = json.loads(capsys.readouterr().out)
    assert res["n_evaluated"] + res["n_skipped"] == len(val_ids) == 2
    assert summary["n_evaluated"] == res["n_evaluated"]
    saved = json.loads((tmp_path / "eval.json").read_text())
    assert saved["lattice_pred"] == res["lattice_pred"]
    assert teval.main(argv)["lattice_pred"] == res["lattice_pred"]


def test_sanitize_nonfinite_matches_jax():
    obj = {"a": float("nan"), "b": [1.0, float("inf"), {"c": 2}], "d": "x"}
    assert teval._sanitize_nonfinite(obj) == jeval._sanitize_nonfinite(obj)
