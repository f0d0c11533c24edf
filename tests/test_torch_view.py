"""The port's pipeline inspector (apps/view.py) against icsg3d_tpu, on the CPU
in f32.

``view_samples`` at d = 8 (VAE filters 4, 8, latent 8; the small 12-class
U-Net of test_torch_models with its background bias shifted so that
about half the voxels pass the F1's 0.5 rounding; every leaf randomised) on a synthetic
build of 12 structures, with JAX's per-sample noise passed in and the
occupancy threshold set in the widest gap of the JAX sigmoids: the same
ids, mse within rtol 1e-4 (f32 through the VAE), F1 equal (counts of
rounded probabilities), and the same panel files.  Then the CLI with the
torch noise of ``--seed``, and ``--voxels`` (3D renders at resample_d 4
here, the CLI's 12 being slow).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icsg3d_torch import config as tcfg
from icsg3d_torch import viz as tviz
from icsg3d_torch import weights
from icsg3d_torch.apps import view as tview
from icsg3d_torch.data.store import GridDataset as TGridDataset
from icsg3d_torch.models import ConditionalDFCVAE as TorchVAE
from icsg3d_torch.models import UNet3D as TorchUNet
from icsg3d_tpu.apps import view as jview
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

D, LATENT = 8, 8
VAE_KW = dict(filters=(4, 8), latent_dim=LATENT, dtype="float32")
N_VIEW = 2


def jax_noise(n, seed=0):
    """The noise JAX's view draws: one split of key(seed) per sample."""
    key, out = jax.random.key(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, (1, LATENT), jnp.float32)))
    return out


def background_half(unet_vars, soft_logits):
    """Shift head_soft's background bias so that the background class takes
    over half the probability at about half of these voxels: random
    weights leave every probability under the F1's 0.5 rounding."""
    soft = np.asarray(soft_logits, np.float64)
    others = np.log(np.exp(soft[..., 1:]).sum(-1))
    head = unet_vars["params"]["head_soft"]
    bias = np.array(head["bias"], np.float64)
    bias[0] -= np.median(soft[..., 0] - others)
    head["bias"] = bias.astype(np.float32)
    return unet_vars


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("view")
    ds = jsynthetic.build_dataset(
        str(tmp / "data"), n=12, seed=2, cfg=VoxelizerConfig(grid=GridSpec(d=D)),
        kinds=("perovskite", "rocksalt"))
    _, conds, _ = bin_and_encode(np.asarray(ds.arrays["target"]), 10)
    _, val_ids = data_split(ds.ids, frac=0.8, n_rot=0)
    ids = val_ids[:N_VIEW]
    noise = jax_noise(N_VIEW)

    vm = ConditionalDFCVAE(VAEConfig(grid=GridSpec(d=D), **VAE_KW))
    um = UNet3D(UNetConfig(**UNET_KW))
    x0 = jnp.zeros((1, D, D, D, 4))
    vv = randomize(lambda: vm.init(jax.random.key(0), x0, jnp.zeros((1, 10)),
                                   jax.random.key(1)), seed=50)
    uv = randomize(lambda: um.init(jax.random.key(0), x0, train=False), seed=51)
    # the reconstructions view segments, with JAX's noise
    rows = [ds.index[i] for i in ids]
    x = np.concatenate([np.asarray(ds.arrays["density"])[rows][..., None],
                        np.asarray(ds.arrays["coords"])[rows]], -1)
    zm, zlv = vm.apply(vv, jnp.asarray(x), jnp.asarray(conds[rows]),
                       method=ConditionalDFCVAE.encode)
    z = zm + jnp.exp(0.5 * zlv) * jnp.concatenate([jnp.asarray(e) for e in noise])
    recon = vm.apply(vv, z, jnp.asarray(conds[rows]), method=ConditionalDFCVAE.decode)
    uv = background_half(uv, um.apply(uv, recon, train=False)[0])
    uv = widen_occupancy_head(uv, um.apply(uv, recon, train=False)[1])
    thr, half_gap = threshold_in_gap(um.apply(uv, recon, train=False)[1][..., 0])
    assert half_gap >= MARGIN

    tv = TorchVAE(tcfg.VAEConfig(grid=tcfg.GridSpec(d=D), **VAE_KW)).eval()
    tu = TorchUNet(tcfg.UNetConfig(**UNET_KW)).eval()
    weights.load_flax_variables(tv, vv)
    weights.load_flax_variables(tu, uv)
    weights.save_npz(str(tmp / "vae.npz"), vv)
    return dict(tmp=tmp, vm=vm, vv=vv, um=um, uv=uv, tv=tv, tu=tu, ids=ids,
                conds=conds, noise=noise, thr=thr)


def test_view_samples_match_jax(setup, capsys):
    s = setup
    path = str(s["tmp"] / "data")
    want = jview.view_samples(
        s["vm"], s["vv"], s["um"], s["uv"], GridDataset(path), s["ids"], s["conds"],
        str(s["tmp"] / "jax"), PipelineConfig(grid=GridSpec(d=D),
                                              binary_threshold=s["thr"]))
    got = tview.view_samples(
        s["tv"], s["tu"], TGridDataset(path), s["ids"], s["conds"],
        str(s["tmp"] / "port"), tcfg.PipelineConfig(grid=tcfg.GridSpec(d=D),
                                                    binary_threshold=s["thr"]),
        noise=s["noise"])
    assert [r["id"] for r in got] == [r["id"] for r in want] == list(s["ids"])
    assert any(r["f1"] > 0 for r in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["mse"], w["mse"], rtol=1e-4, err_msg=g["id"])
        assert g["f1"] == w["f1"], g["id"]
    printed = capsys.readouterr().out
    assert all(f"{r['id']}: mse {r['mse']:.5f} f1 {r['f1']:.4f}" in printed
               for r in got)
    panels = sorted(os.listdir(s["tmp"] / "port"))
    assert panels == sorted(os.listdir(s["tmp"] / "jax"))
    for sid in s["ids"]:
        assert {f"{sid}_{k}.png" for k in ("recon", "true_species",
                                           "pred_species")} <= set(panels)


def test_view_cli_seeds_its_noise_and_draws_voxels(setup, monkeypatch):
    """The CLI's noise is one (1, latent) draw per sample from a generator
    seeded with --seed: the records equal ``view_samples`` with those draws
    passed in; --voxels adds the 3D renders."""
    s = setup
    unet = TorchUNet(tcfg.UNetConfig(num_classes=12, dtype="float32"),
                     torch.Generator().manual_seed(4)).eval()  # the CLI's widths
    weights.save_npz(str(s["tmp"] / "unet-full.npz"), weights.to_flax_variables(unet))
    real = tviz.plot_voxels_3d
    monkeypatch.setattr(tviz, "plot_voxels_3d",
                        lambda g, **kw: real(g, **{**kw, "resample_d": 4}))
    out = s["tmp"] / "cli"
    recs = tview.main([
        "--data", str(s["tmp"] / "data"), "--vae-ckpt", str(s["tmp"] / "vae.npz"),
        "--unet-ckpt", str(s["tmp"] / "unet-full.npz"), "--n", "1", "--num-classes", "12",
        "--filters", "4,8", "--latent", str(LATENT), "--device", "cpu",
        "--seed", "3", "--voxels", "--output", str(out)])
    sid = s["ids"][0]
    assert [r["id"] for r in recs] == [sid]
    assert (out / f"{sid}_voxels.png").stat().st_size > 0
    gen = torch.Generator().manual_seed(3)
    want = tview.view_samples(
        s["tv"], unet, TGridDataset(str(s["tmp"] / "data")), [sid], s["conds"],
        str(s["tmp"] / "cli2"), tcfg.PipelineConfig(grid=tcfg.GridSpec(d=D)),
        noise=[torch.randn((1, LATENT), generator=gen).numpy()])
    assert recs == want
