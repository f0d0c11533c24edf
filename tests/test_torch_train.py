"""The port's DFC-VAE training slice against icsg3d_tpu, on the CPU in f32.

- U-Net perceptual taps (``unet_features``) against the Flax U-Net's at
  d=8: atol 1e-4, rtol 1e-3; convs past max(taps) never run.
- One train step against JAX ``make_vae_steps``' losses at
  tests/test_train.py's config (d=8, VAE filters (4, 8), latent 8, the
  full-width 12-class U-Net, batch 4, lr 1e-3), over {DFC, no U-Net} x
  {kld_floor 0, > 0}: loss and metrics rtol 1e-4; every parameter
  gradient (``jax.grad`` of ``_vae_losses``) atol 1e-5, rtol 1e-3; the new
  batch statistics 1e-5; the Adam update from identical gradients 1e-6.
  (A conv bias feeding a training-mode BN has a true gradient of 0 and a
  computed one of rounding noise, which Adam's first step turns into
  +-lr: so the optimisers are fed the same gradients.)
- ``_assemble_x`` from lattice lengths; the cached-feature loss equals the
  live one; the eval step.
- The CLI on the CPU: history/best/latest written, --resume, NaN never
  best, best.npz read by generate, --spatial 2 on one device refused;
  the loss curves and best-val plots written.
- The best-val plots: ``sample_prior`` and the plot forwards against
  JAX's with JAX's draws passed in (atol/rtol 1e-4); they touch no
  training state; ``plot_min_interval`` thins the refreshes as JAX does.

Both packages get the same variables (every leaf randomised, carried by
weights.load_flax_variables) and the same noise: the port's ``eps`` is
``jax.random.normal(rng, z_mean.shape)``, what the JAX model draws.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icsg3d_torch import config as tcfg
from icsg3d_torch import weights
from icsg3d_torch.apps import generate as tgen
from icsg3d_torch.apps import train_vae as ttrain
from icsg3d_torch.data.store import GridDataset
from icsg3d_torch.models import ConditionalDFCVAE as TorchVAE
from icsg3d_torch.models import UNet3D as TorchUNet
from icsg3d_torch.models.unet import unet_features as t_unet_features
from icsg3d_torch.train import vae as tvae
from icsg3d_torch.train.checkpoints import CheckpointManager
from icsg3d_torch.train.state import TrainState
from icsg3d_tpu.config import GridSpec, UNetConfig, VAEConfig
from icsg3d_tpu.models import ConditionalDFCVAE, UNet3D
from icsg3d_tpu.models.unet import unet_features as j_unet_features
from icsg3d_tpu.train import vae as jvae
from test_torch_models import UNET_KW, randomize

torch.set_num_threads(1)

D = 8
TAPS = (3, 5, 7, 9)
VAE_KW = dict(filters=(4, 8), latent_dim=8, dtype="float32")
FULL_UNET = dict(num_classes=12, dtype="float32")
LR = 1e-3
KLD_FLOOR = 3.0  # between the per-sample KLDs of the test batch (2.86 .. 4.45)


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    g = np.mgrid[:D, :D, :D].astype(np.float32)
    abc = rng.uniform(3.0, 7.0, (n, 3)).astype(np.float32)
    density = np.stack([
        np.exp(-((g - rng.uniform(2, 6, 3)[:, None, None, None]) ** 2).sum(0) / 3.0)
        for _ in range(n)]).astype(np.float32)
    coords = np.stack([np.moveaxis(g, 0, -1) * a * 1.5 / D for a in abc])
    cond = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return {"density": density, "coords": coords.astype(np.float32), "cond": cond}


def _unet_pair(kw, seed):
    model = UNet3D(UNetConfig(**kw))
    x = np.zeros((1, D, D, D, 4), np.float32)
    variables = randomize(
        lambda: model.init(jax.random.key(0), jnp.asarray(x), train=False), seed)
    port = TorchUNet(tcfg.UNetConfig(**kw), torch.Generator().manual_seed(0)).eval()
    weights.load_flax_variables(port, variables)
    return model, variables, port


def _vae_pair(kld_floor, seed=1):
    cfg = VAEConfig(grid=GridSpec(d=D), kld_floor=kld_floor, **VAE_KW)
    model = ConditionalDFCVAE(cfg)
    b = _batch()
    x = np.concatenate([b["density"][..., None], b["coords"]], -1)
    variables = randomize(
        lambda: model.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(b["cond"]),
                           jax.random.key(1)), seed)
    port = TorchVAE(tcfg.VAEConfig(grid=tcfg.GridSpec(d=D), kld_floor=kld_floor,
                                   **VAE_KW), torch.Generator().manual_seed(0))
    weights.load_flax_variables(port, variables)
    return model, variables, port


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_unet_taps_match_flax():
    model, variables, port = _unet_pair(UNET_KW, seed=3)
    x = np.random.default_rng(4).standard_normal((2, D, D, D, 4)).astype(np.float32)
    refs = j_unet_features(model, variables, jnp.asarray(x), TAPS)
    with torch.no_grad():  # convs past max(taps) must not run
        for i in range(max(TAPS) + 1, port.n_convs + 1):
            getattr(port, f"conv{i}").kernel.fill_(float("nan"))
        got = t_unet_features(port, torch.from_numpy(x), TAPS)
    assert len(got) == len(TAPS)
    for tap, g, r in zip(TAPS, got, refs):
        assert tuple(g.shape) == tuple(r.shape), tap
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-3,
                                   err_msg=f"tap {tap}")


@pytest.fixture(scope="module")
def full_unet():
    return _unet_pair(FULL_UNET, seed=5)


@pytest.mark.parametrize("dfc", [True, False], ids=["dfc", "no_unet"])
@pytest.mark.parametrize("kld_floor", [0.0, KLD_FLOOR], ids=["floor0", "floor"])
def test_train_step_matches_jax(full_unet, dfc, kld_floor):
    jmodel, jvars, port = _vae_pair(kld_floor)
    junet, juvars, tunet = full_unet if dfc else (None, None, None)
    b = _batch()
    rng = jax.random.key(7)
    eps = np.array(jax.random.normal(rng, (4, VAE_KW["latent_dim"])))

    def loss_fn(params):
        return jvae._vae_losses(jmodel, junet, juvars, params, jvars["batch_stats"],
                                b, rng, train=True)

    grads, (jmets, new_bs) = jax.jit(jax.grad(loss_fn, has_aux=True))(jvars["params"])
    if kld_floor:  # the floor must bind for some samples, not all
        kld = np.asarray(jvae.losses.kld_gaussian(
            *jmodel.apply(jvars, jnp.asarray(np.concatenate(
                [b["density"][..., None], b["coords"]], -1)), jnp.asarray(b["cond"]),
                method=ConditionalDFCVAE.encode)))
        assert kld.min() < kld_floor < kld.max(), kld

    state = TrainState.create(port, LR)
    train_step, _ = tvae.make_vae_steps(port, tunet)
    mets = train_step(state, _torch_batch(b), torch.from_numpy(eps))
    assert state.step == 1
    for k in ("loss", "mse", "perceptual", "kld"):
        np.testing.assert_allclose(float(mets[k]), float(jmets[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    if not dfc:
        assert float(mets["perceptual"]) == 0.0
    flat_g = weights.flatten(jax.tree_util.tree_map(np.asarray, {"params": grads}))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat_g[weights.flax_key(name)],
                                   atol=1e-5, rtol=1e-3, err_msg=name)
    flat_bs = weights.flatten(jax.tree_util.tree_map(np.asarray,
                                                     {"batch_stats": new_bs}))
    for name, t in port.named_buffers():
        np.testing.assert_allclose(t.numpy(), flat_bs[weights.flax_key(name)],
                                   atol=1e-5, rtol=1e-5, err_msg=name)

    # Adam: both optimisers from the same parameters, fed JAX's gradients
    tx = optax.adam(LR)
    updates, _ = tx.update(grads, tx.init(jvars["params"]), jvars["params"])
    new_params = weights.flatten(jax.tree_util.tree_map(
        np.asarray, {"params": optax.apply_updates(jvars["params"], updates)}))
    fresh = TrainState.create(_vae_pair(kld_floor)[2], LR)
    for name, p in fresh.model.named_parameters():
        p.grad = torch.from_numpy(np.array(flat_g[weights.flax_key(name)]))
    fresh.optimizer.step()
    for name, p in fresh.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new_params[weights.flax_key(name)],
                                   atol=1e-6, rtol=0, err_msg=name)


def test_eval_step_and_feature_cache_match_jax(full_unet):
    jmodel, jvars, port = _vae_pair(0.0)
    junet, juvars, tunet = full_unet
    b = _batch(seed=2)
    rng = jax.random.key(8)
    eps = torch.from_numpy(np.array(jax.random.normal(rng, (4, 8))))
    _, (jmets, _) = jax.jit(lambda p: jvae._vae_losses(
        jmodel, junet, juvars, p, jvars["batch_stats"], b, rng, train=False))(
        jvars["params"])
    state = TrainState.create(port.eval(), LR)
    _, eval_step = tvae.make_vae_steps(port, tunet)
    live = eval_step(state, _torch_batch(b), eps)
    for k in ("loss", "mse", "perceptual", "kld"):
        np.testing.assert_allclose(float(live[k]), float(jmets[k]), rtol=1e-4,
                                   err_msg=k)
    tb = _torch_batch(b)
    x = tvae._assemble_x(tb, port.cfg.grid)
    with torch.no_grad():
        feats = t_unet_features(tunet, x, TAPS)
    cached = dict(tb, **{f"pfeat_{t}": f for t, f in zip(TAPS, feats)})
    got = eval_step(state, cached, eps)
    assert float(got["loss"]) == float(live["loss"])
    assert float(got["perceptual"]) == float(live["perceptual"]) > 0
    # the whole-split precompute (padded last batch) gives the same rows
    data = {"density": tb["density"][:3], "coords": tb["coords"][:3]}
    pre = tvae.precompute_true_features(port, tunet, data, batch_size=2)
    for t, f in zip(TAPS, feats):
        np.testing.assert_allclose(pre[f"pfeat_{t}"].numpy(), f[:3].numpy(),
                                   atol=1e-5, rtol=1e-5)
    assert tvae.true_feature_cache_bytes(port, tunet, 3) == sum(
        v.nbytes for v in pre.values())


def test_remat_perceptual_keeps_loss_and_grads():
    _, _, port = _vae_pair(0.0)
    _, _, tunet = _unet_pair(UNET_KW, seed=6)
    tunet.requires_grad_(False)
    b = _torch_batch(_batch(seed=4))
    eps = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 8)).astype(
        np.float32))
    out = []
    for remat in (False, True):
        port.zero_grad(set_to_none=True)
        total, _ = tvae._vae_losses(port, tunet, b, eps, train=True,
                                    remat_perceptual=remat)
        total.backward()
        out.append((float(total.detach()), {n: p.grad.clone() for n, p in port.named_parameters()}))
    assert out[0][0] == out[1][0]
    for n, g in out[0][1].items():
        np.testing.assert_allclose(out[1][1][n].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_assemble_x_from_lattice_lengths_matches_jax():
    b = _batch(seed=3)
    abc = np.random.default_rng(9).uniform(3.0, 8.0, (4, 3)).astype(np.float32)
    jb = {"density": jnp.asarray(b["density"]), "abc": jnp.asarray(abc)}
    ref = jvae._assemble_x(jb, GridSpec(d=D))
    got = tvae._assemble_x({"density": torch.from_numpy(b["density"]),
                            "abc": torch.from_numpy(abc)}, tcfg.GridSpec(d=D))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    both = tvae._assemble_x(_torch_batch(b), None)
    np.testing.assert_array_equal(
        both.numpy(), np.concatenate([b["density"][..., None], b["coords"]], -1))


def _write_dataset(path, n=10):
    rng = np.random.default_rng(11)
    b = _batch(n, seed=11)
    abc = rng.uniform(3.0, 6.0, (n, 3)).astype(np.float32)
    lattice = np.concatenate([abc, np.full((n, 3), 90.0, np.float32)], 1)
    GridDataset.write(str(path), [f"s{i}" for i in range(n)], {
        "density": b["density"], "coords": b["coords"], "lattice": lattice,
        "target": rng.standard_normal(n).astype(np.float32)})
    return str(path)


CLI = ["--device", "cpu", "--filters", "4,8", "--latent", "8", "--batch-size", "2"]


def test_cli_trains_resumes_and_feeds_generate(tmp_path, capsys):
    data = _write_dataset(tmp_path / "data")
    ckpt = str(tmp_path / "ckpt")
    unet = tmp_path / "unet.npz"
    weights.save_npz(str(unet), weights.to_flax_variables(
        TorchUNet(tcfg.UNetConfig(**FULL_UNET), torch.Generator().manual_seed(2))))
    hist = ttrain.main(["--data", data, "--nrot", "0", "--epochs", "2", "--ckpt", ckpt,
                        "--unet-ckpt", str(unet), "--num-classes", "12"] + CLI)
    # 10 parents -> 8 train (4 steps) / 2 val (1 batch) per epoch
    assert [h["steps"] for h in hist] == [4, 4]
    assert all(np.isfinite(h["train"]["loss"]) and h["train"]["perceptual"] > 0
               for h in hist)
    assert {"history.json", "best.npz", "latest.npz", "progress.json",
            "best_metric.json", "loss.png"} <= set(os.listdir(ckpt))
    assert sorted(os.listdir(os.path.join(ckpt, "plots"))) == [
        "latent_kde.png", "reconstructions.png", "samples.png"]
    with np.load(os.path.join(ckpt, "latest.npz")) as f:
        assert int(f["step"]) == 8
        assert "opt_state/mu/params/encoder/Conv_0/kernel" in f.files
    with np.load(os.path.join(ckpt, "best.npz")) as f:
        assert not any(k.startswith("opt_state/") for k in f.files)

    ttrain.main(["--data", data, "--nrot", "0", "--epochs", "1", "--ckpt", ckpt,
                 "--resume", "--resident"] + CLI)
    assert "resumed from" in capsys.readouterr().out
    with open(os.path.join(ckpt, "progress.json")) as f:
        assert json.load(f)["step"] == 12
    with open(os.path.join(ckpt, "history.json")) as f:
        assert len(json.load(f)) == 3

    recs = tgen.main(["--data", data, "--base", "s0", "--vae-ckpt", ckpt,
                      "--unet-ckpt", str(unet), "--num-classes", "12",
                      "--nsamples", "2", "--fused", "--output",
                      str(tmp_path / "gen")] + CLI)
    assert len(recs) == 2


def test_cli_epoch_scan_with_feature_cache_matches_resident(tmp_path):
    """--epoch-scan runs the epoch programs (train/graphs.py: eagerly on the
    CPU, over the same batches and noise as the per-step loop) and
    --cache-true-features replaces only the true-side U-Net forward: the
    losses equal plain --resident's."""
    data = _write_dataset(tmp_path / "data")
    unet = tmp_path / "unet.npz"
    weights.save_npz(str(unet), weights.to_flax_variables(
        TorchUNet(tcfg.UNetConfig(**FULL_UNET), torch.Generator().manual_seed(2))))
    base = ["--data", data, "--nrot", "0", "--epochs", "1", "--resident",
            "--unet-ckpt", str(unet), "--num-classes", "12"] + CLI
    plain = ttrain.main(base + ["--ckpt", str(tmp_path / "a")])
    scan = ttrain.main(base + ["--ckpt", str(tmp_path / "b"), "--epoch-scan",
                               "--cache-true-features"])
    for split in ("train", "val"):
        for k, v in plain[0][split].items():
            np.testing.assert_allclose(scan[0][split][k], v, rtol=1e-5, err_msg=k)


def test_checkpoint_policy(tmp_path):
    state = TrainState.create(
        TorchVAE(tcfg.VAEConfig(grid=tcfg.GridSpec(d=D), **VAE_KW),
                 torch.Generator().manual_seed(0)), LR)
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.save_epoch(state, float("nan"), 0) is False
    assert not ckpt.has("best") and ckpt.has("latest")
    assert ckpt.save_epoch(state, 2.0, 1) is True
    assert ckpt.save_epoch(state, 3.0, 2, latest_every=2) is False
    assert ckpt.save_epoch(state, float("nan"), 3) is False
    assert CheckpointManager(str(tmp_path)).best_metric == 2.0
    with pytest.raises(ValueError, match="mode"):
        CheckpointManager(str(tmp_path), mode="max")


def test_cli_refuses_spatial_sharding(tmp_path):
    """--spatial 2 needs two mesh cells: one device is refused with
    make_mesh's error and the hint to repeat a device, and the repeated
    CPU device trains."""
    data = _write_dataset(tmp_path / "data")
    with pytest.raises(ValueError, match="needs 2 devices, have 1.*cpu,cpu"):
        ttrain.main(["--data", data, "--spatial", "2"] + CLI)
    hist = ttrain.main(["--data", data, "--nrot", "0", "--epochs", "1", "--spatial", "2",
                        "--ckpt", str(tmp_path / "ckpt")] + CLI + ["--device", "cpu,cpu"])
    assert hist[0]["steps"] == 4 and np.isfinite(hist[0]["train"]["loss"])


def test_cli_resume_refuses_an_orbax_checkpoint(tmp_path):
    data = _write_dataset(tmp_path / "data")
    (tmp_path / "ckpt" / "latest").mkdir(parents=True)
    with pytest.raises(ValueError, match="export_flax_npz"):
        ttrain.main(["--data", data, "--nrot", "0", "--epochs", "1", "--resume",
                     "--ckpt", str(tmp_path / "ckpt")] + CLI)


# -- the best-val plots' forwards (train/vae.py _save_best_plots) -----------


def _prior_draws(epoch, n, latent, bins):
    """The latents and condition bins JAX's sample_prior draws from
    key(epoch) (icsg3d_tpu/models/vae.py:306-311)."""
    z_key, c_key = jax.random.split(jax.random.key(epoch))
    z = np.array(jax.random.normal(z_key, (n, latent)))
    b = np.array(jax.random.randint(c_key, (n,), 0, bins))
    return z, b


def test_sample_prior_matches_jax():
    """sample_prior with JAX's draws passed in: the same z back, the decode
    within atol/rtol 1e-4 (f32 through the decoder); without them it draws
    (n, latent) and n bins from the generator, the same on a rerun."""
    from icsg3d_torch.models.vae import sample_prior as t_sample_prior
    from icsg3d_tpu.models.vae import sample_prior as j_sample_prior

    model, variables, port = _vae_pair(0.0)
    port.eval()
    for n, epoch in ((1, 0), (3, 7)):
        jz, jout = j_sample_prior(model, variables, jax.random.key(epoch), n_samples=n)
        z, b = _prior_draws(epoch, n, VAE_KW["latent_dim"], 10)
        np.testing.assert_array_equal(z, np.asarray(jz))
        tz, tout = t_sample_prior(port, n, z=z, bins=b)
        np.testing.assert_array_equal(tz.numpy(), z)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)
    gen = torch.Generator().manual_seed(5)
    z1, out1 = t_sample_prior(port, 2, generator=gen, var=0.5)
    z2, out2 = t_sample_prior(port, 2, generator=torch.Generator().manual_seed(5),
                              var=0.5)
    assert tuple(z1.shape) == (2, VAE_KW["latent_dim"])
    assert tuple(out1.shape) == (2, D, D, D, 4)
    assert torch.equal(z1, z2) and torch.equal(out1, out2)


def test_plot_forwards_match_jax():
    """The best-val plots' reconstruction (4 of a batch of 5, JAX's key(0)
    noise), z_mean and prior sample (key(epoch) draws) against JAX's
    ``_plot_forwards``: atol/rtol 1e-4."""
    model, variables, port = _vae_pair(0.0)
    b = _batch(n=5, seed=3)
    epoch = 4
    recon_fn, sample_fn = jvae._plot_forwards(model)
    x = np.concatenate([b["density"][..., None], b["coords"]], -1)
    jrecon, jzm = recon_fn(variables, jnp.asarray(x[:4]), jnp.asarray(b["cond"][:4]))
    _, jsamples = sample_fn(variables, epoch)
    eps = np.array(jax.random.normal(jax.random.key(0), (4, VAE_KW["latent_dim"])))
    z, bins = _prior_draws(epoch, 1, VAE_KW["latent_dim"], 10)
    tx, trecon, tzm, tsamples = tvae.plot_forwards(
        port, _torch_batch(b), epoch, eps=eps, z=z, bins=bins)
    np.testing.assert_array_equal(tx, x[:4])
    for got, want, name in ((trecon, jrecon, "recon"), (tzm, jzm, "z_mean"),
                            (tsamples, jsamples, "samples")):
        assert got.shape == np.asarray(want).shape, name
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_save_best_plots_touches_no_training_state(tmp_path):
    """_save_best_plots writes its three PNGs and leaves the parameters,
    the BatchNorm running statistics and the Adam state bitwise as they
    were (an eval-mode forward under inference_mode)."""
    state = tvae.create_vae_state(tcfg.VAEConfig(grid=tcfg.GridSpec(d=D), **VAE_KW),
                                  LR, 0, "cpu")
    train_step, _ = tvae.make_vae_steps(state.model)
    b = _torch_batch(_batch())
    train_step(state, b, torch.zeros(4, VAE_KW["latent_dim"]))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt = {(i, k): v.clone() for i, s in enumerate(state.optimizer.state.values())
           for k, v in s.items() if torch.is_tensor(v)}
    tvae._save_best_plots(state.model, b, str(tmp_path / "plots"), epoch=2)
    assert sorted(os.listdir(tmp_path / "plots")) == [
        "latent_kde.png", "reconstructions.png", "samples.png"]
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    after = {(i, k): v for i, s in enumerate(state.optimizer.state.values())
             for k, v in s.items() if torch.is_tensor(v)}
    assert set(after) == set(opt) and all(torch.equal(after[k], opt[k]) for k in opt)


@pytest.mark.parametrize("every,want", [(1, [0, 1, 3]), (2, [0, 3])])
def test_plot_min_interval_thins_refreshes(tmp_path, monkeypatch, every, want):
    """Best-val plots follow JAX's rule (train/vae.py:808-816): only on an
    improved epoch, at least ``plot_min_interval`` epochs after the last."""
    # per epoch: the train metrics, then the val metrics
    losses = iter([1.0, 5.0, 1.0, 4.0, 1.0, 4.5, 1.0, 3.0])
    monkeypatch.setattr(tvae, "_host_metrics",
                        lambda mets: {"loss": next(losses), "mse": 0.0,
                                      "perceptual": 0.0, "kld": 0.0})
    plotted = []
    monkeypatch.setattr(tvae, "_save_best_plots",
                        lambda model, batch, plot_dir, epoch: plotted.append(epoch))
    state = tvae.create_vae_state(tcfg.VAEConfig(grid=tcfg.GridSpec(d=D), **VAE_KW),
                                  LR, 0, "cpu")
    b = _batch(n=2)
    tvae.train_vae(state.model, state, lambda: [b], lambda: [b], epochs=4,
                   checkpoint_dir=str(tmp_path / "ckpt"), plot_dir=str(tmp_path),
                   plot_min_interval=every)
    assert plotted == want
