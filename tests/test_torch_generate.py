"""Slice parity: the port's generation step and CLI against icsg3d_tpu's, in
f32 at d=8 with the same weights and the same numpy latents.

- ``fused_generate_fn`` (decode -> segment -> binary extraction ->
  Cartesian): lattice and coordinates allclose to 1e-4, atoms and
  ``valid`` equal.
- ``python -m icsg3d_torch.apps.generate`` (``--device cpu``, which
  computes in f32; ``--fused`` and the host watershed) on a tiny dataset
  written with numpy, with
  weights exported by tools/export_flax_npz.py from a JAX fresh init, vs
  the JAX ``generate_structures_fused`` / ``generate_structures`` records.

The occupancy threshold is set in the widest gap of the JAX sigmoids, and
the tests assert that no sigmoid lies within 1e-3 of it: a voxel that
close could flip between the frameworks on f32 rounding alone.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icsg3d_torch import config as tcfg
from icsg3d_torch import weights
from icsg3d_torch.apps import generate as tgen
from icsg3d_torch.data.store import GridDataset
from icsg3d_torch.models import ConditionalDFCVAE as TorchVAE
from icsg3d_torch.models import UNet3D as TorchUNet
from icsg3d_tpu.apps import generate as jgen
from icsg3d_tpu.config import GridSpec, PipelineConfig, UNetConfig, VAEConfig
from icsg3d_tpu.models import ConditionalDFCVAE, UNet3D
from test_torch_models import UNET_KW, randomize

torch.set_num_threads(1)

D = 8
MARGIN = 1e-3


def threshold_in_gap(sig_logits):
    """Midpoint of the widest gap between sorted sigmoids whose quantile
    lies in [0.6, 0.85] (a 15-40% foreground), and that gap's half width."""
    s = np.sort(np.asarray(jax.nn.sigmoid(jnp.asarray(sig_logits))).ravel())
    lo, hi = int(0.6 * len(s)), int(0.85 * len(s))
    i = lo + int(np.argmax(np.diff(s[lo:hi + 1])))
    return float((s[i] + s[i + 1]) / 2), float((s[i + 1] - s[i]) / 2)


def widen_occupancy_head(unet_vars, sig_logits, spread=6.0):
    """Rescale head_sig so its logits on these inputs are centred at 0 with
    std ``spread``: random weights give a narrow, off-centre band of
    sigmoids that leaves the mask all-or-nothing and no gap to threshold
    in.  L -> a * (L - median(L)) is kernel * a, bias a * (bias - median)."""
    logits = np.asarray(sig_logits, np.float64)
    a = spread / logits.std()
    head = unet_vars["params"]["head_sig"]
    head["kernel"] = (head["kernel"] * a).astype(np.float32)
    head["bias"] = (a * (head["bias"] - np.median(logits))).astype(np.float32)
    return unet_vars


@pytest.fixture(scope="module")
def models():
    vm = ConditionalDFCVAE(VAEConfig(grid=GridSpec(d=D), filters=(4, 8),
                                     latent_dim=8, dtype="float32"))
    um = UNet3D(UNetConfig(**UNET_KW))
    x = jnp.zeros((1, D, D, D, 4))
    vv = randomize(lambda: vm.init(jax.random.key(0), x, jnp.zeros((1, 10)),
                                   jax.random.key(1)), seed=10)
    uv = randomize(lambda: um.init(jax.random.key(0), x, train=False), seed=20)
    z, cond = _latents()
    M = vm.apply(vv, jnp.asarray(z), jnp.asarray(cond),
                 method=ConditionalDFCVAE.decode)
    uv = widen_occupancy_head(uv, um.apply(uv, M, train=False)[1])
    tv = TorchVAE(tcfg.VAEConfig(grid=tcfg.GridSpec(d=D), filters=(4, 8),
                                 latent_dim=8, dtype="float32")).eval()
    tu = TorchUNet(tcfg.UNetConfig(**UNET_KW)).eval()
    weights.load_flax_variables(tv, vv)
    weights.load_flax_variables(tu, uv)
    return vm, vv, um, uv, tv, tu


def _latents():
    rng = np.random.default_rng(0)
    z = rng.standard_normal((4, 8)).astype(np.float32)
    return z, np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]


def test_fused_step_matches_jax(models):
    vm, vv, um, uv, tv, tu = models
    z, cond = _latents()
    M = vm.apply(vv, jnp.asarray(z), jnp.asarray(cond),
                 method=ConditionalDFCVAE.decode)
    _, sig = um.apply(uv, M, train=False)
    thr, half_gap = threshold_in_gap(sig[..., 0])
    assert half_gap >= MARGIN

    pipe = PipelineConfig(grid=GridSpec(d=D), binary_threshold=thr)
    tpipe = tcfg.PipelineConfig(grid=tcfg.GridSpec(d=D), binary_threshold=thr)
    jl, ja, jc, jv = map(np.asarray, jgen.fused_generate_fn(vm, vv, um, uv, pipe)(
        jnp.asarray(z), jnp.asarray(cond)))
    tl, ta, tc, tv_ = (t.numpy() for t in tgen.fused_generate_fn(tv, tu, tpipe)(
        torch.from_numpy(z), torch.from_numpy(cond)))
    assert jv.sum() > 0  # the extraction found atoms
    np.testing.assert_array_equal(tv_, jv)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tc, jc, atol=1e-4, rtol=1e-4)


def _load_export_script():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / "export_flax_npz.py"
    spec = importlib.util.spec_from_file_location("export_flax_npz", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _blob_dataset(path, n=3):
    rng = np.random.default_rng(0)
    g = np.mgrid[:D, :D, :D].astype(np.float32)
    density, coords = [], []
    for i in range(n):
        c = rng.uniform(2, 6, 3)
        density.append(np.exp(-((g - c[:, None, None, None]) ** 2).sum(0) / 2.0))
        abc = rng.uniform(3, 6, 3)
        coords.append(np.moveaxis(g, 0, -1) * abc / D)
    return GridDataset.write(str(path), [f"s{i}" for i in range(n)], {
        "density": np.stack(density).astype(np.float32),
        "coords": np.stack(coords).astype(np.float32),
        "target": rng.standard_normal(n).astype(np.float32),
    })


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """Dataset, fresh-init weights exported to .npz (occupancy head
    widened), the JAX models on those weights, and a threshold with a
    margin for the CLI's latents."""
    export = _load_export_script()
    from icsg3d_tpu.apps import common as jcommon
    from icsg3d_tpu.data.binning import bin_and_encode

    tmp = tmp_path_factory.mktemp("gen")
    ds = _blob_dataset(tmp / "data")
    vae_npz, unet_npz = str(tmp / "vae.npz"), str(tmp / "unet.npz")
    export(["--d", str(D), "--filters", "4,8", "--latent", "8",
            "--vae-out", vae_npz, "--unet-out", unet_npz])
    vm = ConditionalDFCVAE(VAEConfig(grid=GridSpec(d=D), filters=(4, 8),
                                     latent_dim=8, dtype="float32"))
    um = UNet3D(UNetConfig(dtype="float32"))
    vv, uv = weights.load_npz(vae_npz), weights.load_npz(unet_npz)

    # the CLI's latents for base "s1": encode, then default_rng(seed=0)
    _, conds, _ = bin_and_encode(np.asarray(ds.arrays["target"]), 10)
    x = jcommon.grid_input(ds.arrays["density"][1:2], ds.arrays["coords"][1:2])
    z_mu = np.asarray(vm.apply(vv, jnp.asarray(x), jnp.asarray(conds[1:2]),
                               method=ConditionalDFCVAE.encode)[0])[0]
    z = np.random.default_rng(0).normal(z_mu, np.sqrt(0.5), (4, 8)).astype(np.float32)
    cond_b = np.repeat(conds[1:2].astype(np.float32), 4, axis=0)
    M = vm.apply(vv, jnp.asarray(z), jnp.asarray(cond_b),
                 method=ConditionalDFCVAE.decode)
    uv = widen_occupancy_head(uv, um.apply(uv, M, train=False)[1][:3])
    weights.save_npz(unet_npz, uv)
    _, sig = um.apply(uv, M, train=False)
    thr, half_gap = threshold_in_gap(sig[..., 0][:3])  # 3 live rows of 4
    assert half_gap >= MARGIN
    return dict(tmp=tmp, ds=ds, vae=vae_npz, unet=unet_npz, vm=vm, vv=vv,
                um=um, uv=uv, conds=conds, thr=thr)


@pytest.mark.parametrize("fused", [True, False])
def test_cli_records_match_jax(cli_setup, fused):
    c = cli_setup
    out = c["tmp"] / ("fused" if fused else "host")
    tgen.main([
        "--data", str(c["tmp"] / "data"), "--base", "s1",
        "--vae-ckpt", c["vae"], "--unet-ckpt", c["unet"],
        "--filters", "4,8", "--latent", "8", "--nsamples", "3",
        "--batch-size", "4", "--binary-threshold", repr(c["thr"]),
        "--device", "cpu", "--output", str(out),
        *(["--fused"] if fused else []),
    ])
    got = json.loads((out / "results.json").read_text())
    ds = c["ds"]
    fn = jgen.generate_structures_fused if fused else jgen.generate_structures
    ref = fn(
        c["vm"], c["vv"], c["um"], c["uv"],
        np.asarray(ds.arrays["density"][1]), np.asarray(ds.arrays["coords"][1]),
        c["conds"][1], n_samples=3, batch_size=4,
        pipe=PipelineConfig(grid=GridSpec(d=D), binary_threshold=c["thr"]),
    )
    assert len(got) == len(ref) == 3
    assert any(r.get("atoms") for r in ref)
    for g, r in zip(got, ref):
        for key in ("valid", "atoms", "formula", "error"):
            assert g.get(key) == r.get(key), key
        np.testing.assert_allclose(g["lattice"], r["lattice"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(g.get("coords", [])),
                                   np.asarray(r.get("coords", [])),
                                   atol=1e-4, rtol=1e-4)
    assert (out / "results.csv").exists()
