"""Model parity: the port's VAE and U-Net against the Flax models, in f32 at
d=8, with the same variables carried across by icsg3d_torch/weights.py.

Every leaf of the Flax tree (kernels, biases, BN scale/bias, running
mean/var) is replaced by seeded random values first, so a mis-mapped leaf
cannot hide behind an identity init.  Tolerance atol 1e-4, rtol 1e-3: the
same f32 math, summed in other orders, with BN folded into scale/shift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icsg3d_torch import config as tcfg
from icsg3d_torch import weights
from icsg3d_torch.models import ConditionalDFCVAE as TorchVAE
from icsg3d_torch.models import UNet3D as TorchUNet
from icsg3d_torch.models.vae import reparameterize
from icsg3d_tpu.config import GridSpec, UNetConfig, VAEConfig
from icsg3d_tpu.models import ConditionalDFCVAE, UNet3D

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-3)
D = 8
UNET_KW = dict(
    num_classes=12, enc_filters=((4, 8), (8, 8), (8, 16)),
    bottom_filters=(16, 16), dec_filters=((16, 8), (8, 8), (8, 8)),
    dtype="float32",
)


def randomize(init_fn, seed):
    """The tree ``init_fn`` would build (traced only, never run), every
    leaf filled with seeded random values."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn)
    flat = weights.flatten(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    )
    out = {}
    for key, a in sorted(flat.items()):
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            v = rng.standard_normal(a.shape) / np.sqrt(fan_in)
        elif leaf == "var":
            v = rng.uniform(0.5, 1.5, a.shape)
        elif leaf == "scale":
            v = 1.0 + 0.2 * rng.standard_normal(a.shape)
        else:  # bias, mean
            v = 0.1 * rng.standard_normal(a.shape)
        out[key] = v.astype(np.float32)
    return weights.unflatten(out)


def vae_inputs(n=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D, D, D, 4)).astype(np.float32)
    cond = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, cond


@pytest.fixture(scope="module")
def vae_pair():
    cfg = VAEConfig(grid=GridSpec(d=D), filters=(4, 8), latent_dim=8,
                    dtype="float32")
    model = ConditionalDFCVAE(cfg)
    x, cond = vae_inputs()
    variables = randomize(
        lambda: model.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(cond),
                           jax.random.key(1)),
        seed=1,
    )
    port = TorchVAE(tcfg.VAEConfig(grid=tcfg.GridSpec(d=D), filters=(4, 8),
                                   latent_dim=8, dtype="float32"),
                    torch.Generator().manual_seed(0)).eval()
    weights.load_flax_variables(port, variables)
    return model, variables, port


@pytest.fixture(scope="module")
def unet_pair():
    model = UNet3D(UNetConfig(**UNET_KW))
    x = np.zeros((1, D, D, D, 4), np.float32)
    variables = randomize(
        lambda: model.init(jax.random.key(0), jnp.asarray(x), train=False), seed=2
    )
    port = TorchUNet(tcfg.UNetConfig(**UNET_KW),
                     torch.Generator().manual_seed(0)).eval()
    weights.load_flax_variables(port, variables)
    return model, variables, port


def test_vae_encode_matches(vae_pair):
    model, variables, port = vae_pair
    x, cond = vae_inputs(seed=3)
    zm, zl = model.apply(variables, jnp.asarray(x), jnp.asarray(cond),
                         method=ConditionalDFCVAE.encode)
    with torch.inference_mode():
        tm, tl = port.encode(torch.from_numpy(x), torch.from_numpy(cond))
    np.testing.assert_allclose(tm.numpy(), np.asarray(zm), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(zl), **TOL)


def test_vae_decode_matches(vae_pair):
    model, variables, port = vae_pair
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    _, cond = vae_inputs(seed=4)
    ref = model.apply(variables, jnp.asarray(z), jnp.asarray(cond),
                      method=ConditionalDFCVAE.decode)
    with torch.inference_mode():
        got = port.decode(torch.from_numpy(z), torch.from_numpy(cond))
    assert got.dtype == torch.float32 and got.shape == (2, D, D, D, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_reparameterize_with_injected_noise():
    rng = np.random.default_rng(5)
    mu, lv, eps = (rng.standard_normal((3, 4)).astype(np.float32) for _ in range(3))
    got = reparameterize(*(torch.from_numpy(a) for a in (mu, lv, eps)))
    np.testing.assert_allclose(got.numpy(), mu + np.exp(0.5 * lv) * eps,
                               rtol=1e-6)


def test_unet_logits_match(unet_pair):
    model, variables, port = unet_pair
    x = np.random.default_rng(6).standard_normal((2, D, D, D, 4)).astype(np.float32)
    soft, sig = model.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        tsoft, tsig = port(torch.from_numpy(x))
    assert tsoft.shape == (2, D, D, D, 12) and tsig.shape == (2, D, D, D, 1)
    np.testing.assert_allclose(tsoft.numpy(), np.asarray(soft), **TOL)
    np.testing.assert_allclose(tsig.numpy(), np.asarray(sig), **TOL)


def test_full_width_unet_consumes_the_flax_tree():
    """The production U-Net (95 classes, up to 512 channels) has the same
    leaves as the Flax tree; shapes only, no forward pass."""
    model = UNet3D(UNetConfig())
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0), jnp.zeros((1, 8, 8, 8, 4)),
                           train=False)
    )
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = TorchUNet(tcfg.UNetConfig(), torch.Generator().manual_seed(0))
    weights.load_flax_variables(port, zeros)
    assert float(port.conv9.kernel.detach().abs().sum()) == 0.0
    assert tuple(port.conv9.kernel.shape) == (3, 3, 3, 768, 512)


def test_load_flax_variables_rejects_missing_and_extra_leaves(vae_pair):
    _, variables, port = vae_pair
    flat = weights.flatten(variables)
    missing = dict(flat)
    del missing["params/encoder/Conv_0/bias"]
    with pytest.raises(ValueError, match="missing.*encoder.Conv_0.bias"):
        weights.load_flax_variables(port, weights.unflatten(missing))
    extra = dict(flat)
    extra["params/encoder/Conv_9/kernel"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="left-over.*Conv_9"):
        weights.load_flax_variables(port, weights.unflatten(extra))
    bad = dict(flat)
    bad["batch_stats/decoder/output_bn/mean"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="shape"):
        weights.load_flax_variables(port, weights.unflatten(bad))


def test_to_flax_variables_inverts_the_map(vae_pair):
    _, variables, port = vae_pair
    back = weights.to_flax_variables(port)
    ref = weights.flatten(variables)
    assert sorted(weights.flatten(back)) == sorted(ref)
    fresh = TorchVAE(port.cfg, torch.Generator().manual_seed(7))
    weights.load_flax_variables(fresh, back)
    for key, t in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], t), key


def test_npz_round_trip(vae_pair, tmp_path):
    _, variables, _ = vae_pair
    path = str(tmp_path / "vae.npz")
    weights.save_npz(path, variables)
    back = weights.flatten(weights.load_npz(path))
    ref = weights.flatten(variables)
    assert sorted(back) == sorted(ref)
    assert "params/encoder/Conv_0/kernel" in back
    for key in ref:
        np.testing.assert_array_equal(back[key], ref[key])
