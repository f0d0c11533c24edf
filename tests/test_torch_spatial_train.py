"""The depth-sharded training path (``--spatial``) of the PyTorch port
against the JAX package, on the CPU: one VAE and one U-Net train step on a
1x2 mesh against JAX's steps built with a spatial mesh (loss 1e-4,
gradients 1e-5 / 1e-3, batch statistics 1e-5, as the port's step parity
tests use), and both trainer CLIs at ``--device cpu,cpu --spatial 2``
against ``--spatial 1`` (histories within 1e-4).

JAX runs on the conftest's 8 virtual CPU devices with its Pallas kernels in
interpret mode; the port's meshes repeat the CPU device.  The conv-level
parity is in test_torch_spatial.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icsg3d_torch import config as tcfg
from icsg3d_torch import weights
from icsg3d_torch.apps import train_unet as tunet_app
from icsg3d_torch.apps import train_vae as tvae_app
from icsg3d_torch.apps import voxelize as tvox_app
from icsg3d_torch.models import UNet3D as TorchUNet
from icsg3d_torch.train import unet as tunet
from icsg3d_torch.train import vae as tvae
from icsg3d_torch.train.state import TrainState
from icsg3d_tpu.config import GridSpec, UNetConfig
from icsg3d_tpu.models import UNet3D
from icsg3d_tpu.parallel.mesh import make_mesh as j_make_mesh
from icsg3d_tpu.train import unet as junet
from icsg3d_tpu.train import vae as jvae
from test_torch_models import UNET_KW, randomize
from test_torch_spatial import _cpu_mesh, _t, _vae_models
from test_torch_train import _write_dataset
from test_torch_unet_train import CLASS_WEIGHTS, _assert_metrics, _raw_batch

torch.set_num_threads(1)


def _unet_pair(jmesh, tmesh, seed, d):
    jmodel = UNet3D(UNetConfig(layout="ndcs", **UNET_KW), spatial_mesh=jmesh)
    variables = randomize(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, d, d, d, 4), jnp.float32), train=False), seed)
    port = TorchUNet(tcfg.UNetConfig(**UNET_KW), torch.Generator().manual_seed(0),
                     spatial_mesh=tmesh)
    weights.load_flax_variables(port, variables)
    return jmodel, variables, port


def _assert_grads_and_stats(port, grads, batch_stats):
    flat_g = weights.flatten(jax.tree_util.tree_map(np.asarray, {"params": grads}))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat_g[weights.flax_key(name)],
                                   atol=1e-5, rtol=1e-3, err_msg=name)
    flat_bs = weights.flatten(jax.tree_util.tree_map(np.asarray,
                                                     {"batch_stats": batch_stats}))
    for name, t in port.named_buffers():
        np.testing.assert_allclose(t.numpy(), flat_bs[weights.flax_key(name)],
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_vae_train_step_on_1x2_mesh_matches_jax():
    """One VAE train step at d=16 on a 1x2 mesh against JAX's loss and
    gradients with a spatial mesh: loss 1e-4, gradients 1e-5 / 1e-3, batch
    statistics 1e-5.  (The DFC term's frozen U-Net is unsharded on both
    sides, test_torch_train.py holds it.)"""
    d = 16
    rng_np = np.random.default_rng(13)
    g = np.mgrid[:d, :d, :d].astype(np.float32)
    b = {"density": np.stack([
            np.exp(-((g - rng_np.uniform(4, 12, 3)[:, None, None, None]) ** 2).sum(0) / 6.0)
            for _ in range(2)]).astype(np.float32),
         "abc": rng_np.uniform(3.0, 7.0, (2, 3)).astype(np.float32),
         "cond": np.eye(10, dtype=np.float32)[rng_np.integers(0, 10, 2)]}
    x = np.asarray(jvae._assemble_x({k_: jnp.asarray(v) for k_, v in b.items()},
                                    GridSpec(d=d)))
    cfg_kw = dict(grid=GridSpec(d=d), filters=(4, 8), latent_dim=8)
    jmodel, jvars, port = _vae_models(cfg_kw, j_make_mesh(1, 2, devices=jax.devices()[:2]),
                                      _cpu_mesh(1, 2), 14, x, b["cond"])
    rng = jax.random.key(7)
    eps = np.array(jax.random.normal(rng, (2, 8)))

    def loss_fn(params):
        return jvae._vae_losses(jmodel, None, None, params, jvars["batch_stats"], b, rng,
                                train=True)

    grads, (jmets, new_bs) = jax.jit(jax.grad(loss_fn, has_aux=True))(jvars["params"])
    state = TrainState.create(port, 1e-3)
    train_step, _ = tvae.make_vae_steps(port)
    mets = train_step(state, {k_: _t(v) for k_, v in b.items()}, _t(eps))
    for key in ("loss", "mse", "perceptual", "kld"):
        np.testing.assert_allclose(float(mets[key]), float(jmets[key]), rtol=1e-4,
                                   atol=1e-7, err_msg=key)
    _assert_grads_and_stats(port, grads, new_bs)


def test_unet_train_step_on_1x2_mesh_matches_jax():
    """One U-Net train step at d=16 on a 1x2 mesh against JAX's step built
    with a spatial mesh: metrics 1e-4, gradients 1e-5 / 1e-3, batch
    statistics 1e-5."""
    d = 16
    jmodel, jvars, port = _unet_pair(j_make_mesh(1, 2, devices=jax.devices()[:2]),
                                     _cpu_mesh(1, 2), 16, d)
    raw = _raw_batch(n=2, seed=6)
    # the raw batch is d=8: upsample it to d=16 so every level divides
    raw = {k_: (np.repeat(np.repeat(np.repeat(v, 2, 1), 2, 2), 2, 3)
                if k_ in ("density", "species") else v) for k_, v in raw.items()}
    b = tunet.prepare_unet_batch(raw, UNET_KW["num_classes"], device_coords=True)

    def loss_fn(params):
        return junet._unet_losses(jmodel, params, jvars["batch_stats"], b,
                                  jnp.asarray(CLASS_WEIGHTS), train=True)

    grads, (jmets, new_bs) = jax.jit(jax.grad(loss_fn, has_aux=True))(jvars["params"])
    state = TrainState.create(port, 1e-3)
    train, _ = tunet.make_unet_steps(port, CLASS_WEIGHTS)
    mets = train(state, {k_: _t(v) for k_, v in b.items()})
    _assert_metrics({k_: v.numpy() for k_, v in mets.items()},
                    jax.tree_util.tree_map(np.asarray, jmets))
    _assert_grads_and_stats(port, grads, new_bs)


# -- the CLIs -----------------------------------------------------------------

def _assert_same_history(sharded, plain):
    assert len(sharded) == len(plain)
    for hs, hp in zip(sharded, plain):
        assert hs["steps"] == hp["steps"]
        for split in ("train", "val"):
            for key, v in hp[split].items():
                np.testing.assert_allclose(hs[split][key], v, rtol=1e-4, atol=1e-6,
                                           err_msg=f"{split} {key}")


def test_train_vae_cli_spatial_2_matches_spatial_1(tmp_path):
    data = _write_dataset(tmp_path / "data")
    # a small step size: Adam moves every weight by ~lr whatever its
    # gradient, so the f32 rounding of near-zero gradients is not amplified
    base = ["--data", data, "--nrot", "0", "--epochs", "1", "--filters", "4,8",
            "--latent", "8", "--batch-size", "2", "--lr", "1e-5"]
    plain = tvae_app.main(base + ["--device", "cpu", "--ckpt", str(tmp_path / "a")])
    sharded = tvae_app.main(base + ["--device", "cpu,cpu", "--spatial", "2",
                                    "--ckpt", str(tmp_path / "b")])
    _assert_same_history(sharded, plain)


def test_train_unet_cli_spatial_2_matches_spatial_1(tmp_path):
    data = str(tmp_path / "synth")
    tvox_app.main(["--synthetic", "6", "--out", data, "--d", "8", "--nrot", "0",
                   "--kinds", "perovskite,rocksalt", "--seed", "1", "--device", "cpu"])
    base = ["--data", data, "--epochs", "1", "--batch-size", "2", "--nrot", "0",
            "--num-classes", "60"]
    plain = tunet_app.main(base + ["--device", "cpu", "--ckpt", str(tmp_path / "a")])
    sharded = tunet_app.main(base + ["--device", "cpu,cpu", "--spatial", "2",
                                     "--ckpt", str(tmp_path / "b")])
    _assert_same_history(sharded, plain)
    # a data axis that does not divide the batch is refused, as in JAX
    with pytest.raises(SystemExit):
        tunet_app.main(base + ["--device", "cpu,cpu,cpu,cpu", "--spatial", "2",
                               "--batch-size", "3", "--ckpt", str(tmp_path / "c")])
