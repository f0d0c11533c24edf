"""The port's U-Net training slice against icsg3d_tpu, on the CPU in f32.

- One train step against JAX ``make_unet_steps`` at d=8, f32, 12 classes
  (the narrow U-Net of tests/test_torch_models.py, batch 4, lr 1e-3), with
  and without class weights: every metric of ``_unet_losses`` rtol 1e-4;
  every parameter gradient (``jax.grad`` of ``_unet_losses``) atol 1e-5,
  rtol 1e-3; the new batch statistics 1e-5; the Adam update from identical
  gradients 1e-6.
- The eval step; the per-class CE fold; ``prepare_unet_batch`` exact; the
  metrics in one-hot and integer-label forms against ops/metrics.py.
- The CLI on the CPU (the flag forms of tests/test_cli_matrix.py):
  ``--resume`` appends history, ``--no-class-weights``, ``--resident
  --epoch-scan`` equals ``--resident``, the refusals, and the checkpoint
  read by ``generate --unet-ckpt`` and ``train_vae --unet-ckpt``; the loss
  curves and best-val panels written.
- The best-val panels' forward against JAX's ``_plot_forward`` (labels
  equal, sigmoid atol 1e-5); it touches no training state.

Both packages get the same variables (every leaf randomised, carried by
weights.load_flax_variables) and the same batch.
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
from icsg3d_torch.apps import train_unet as tapp
from icsg3d_torch.apps import train_vae as tvae_app
from icsg3d_torch.apps import voxelize as tvox_app
from icsg3d_torch.models import UNet3D as TorchUNet
from icsg3d_torch.ops import metrics as tmetrics
from icsg3d_torch.train import unet as tunet
from icsg3d_torch.train.state import TrainState
from icsg3d_tpu.config import UNetConfig
from icsg3d_tpu.models import UNet3D
from icsg3d_tpu.ops import metrics as jmetrics
from icsg3d_tpu.train import unet as junet
from icsg3d_tpu.train.state import ModelState
from test_torch_models import UNET_KW, randomize

torch.set_num_threads(1)

D = 8
NC = UNET_KW["num_classes"]
LR = 1e-3
CLASS_WEIGHTS = np.linspace(0.0, 3.0, NC).astype(np.float32)


def _raw_batch(n=4, seed=0):
    """Store fields of n samples: density, lattice, coords, species with a
    background majority and labels past the class range (clipped)."""
    rng = np.random.default_rng(seed)
    g = np.mgrid[:D, :D, :D].astype(np.float32)
    density = np.stack([
        np.exp(-((g - rng.uniform(2, 6, 3)[:, None, None, None]) ** 2).sum(0) / 3.0)
        for _ in range(n)]).astype(np.float32)
    abc = rng.uniform(3.0, 7.0, (n, 3)).astype(np.float32)
    lattice = np.concatenate([abc, np.full((n, 3), 90.0, np.float32)], 1)
    coords = np.stack([np.moveaxis(g, 0, -1) * a * 1.5 / D for a in abc])
    species = np.where(density > 0.3, rng.integers(1, NC + 4, density.shape), 0)
    return {"density": density, "lattice": lattice,
            "coords": coords.astype(np.float32), "species": species.astype(np.uint8)}


def _pair(seed=3):
    model = UNet3D(UNetConfig(**UNET_KW))
    x = np.zeros((1, D, D, D, 4), np.float32)
    variables = randomize(
        lambda: model.init(jax.random.key(0), jnp.asarray(x), train=False), seed)
    port = TorchUNet(tcfg.UNetConfig(**UNET_KW), torch.Generator().manual_seed(0))
    weights.load_flax_variables(port, variables)
    return model, variables, port


def _assert_metrics(got, want, rtol=1e-4):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(v, np.float64), rtol=rtol, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("cw", [CLASS_WEIGHTS, None], ids=["weighted", "unweighted"])
def test_train_step_matches_jax(cw):
    jmodel, jvars, port = _pair()
    b = tunet.prepare_unet_batch(_raw_batch(), NC, device_coords=True)
    jcw = jnp.ones(NC) if cw is None else jnp.asarray(cw)

    def loss_fn(params):
        return junet._unet_losses(jmodel, params, jvars["batch_stats"], b, jcw,
                                  train=True)

    grads, (jmets, _) = jax.jit(jax.grad(loss_fn, has_aux=True))(jvars["params"])
    train_step, _ = junet.make_unet_steps(jmodel, cw)
    tx = optax.adam(LR)
    new_state, step_mets = train_step(ModelState.create(jmodel.apply, jvars, tx), b)

    state = TrainState.create(port, LR)
    train, _ = tunet.make_unet_steps(port, cw)
    mets = train(state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert state.step == 1
    _assert_metrics({k: v.numpy() for k, v in mets.items()},
                    jax.tree_util.tree_map(np.asarray, jmets))
    _assert_metrics({k: v.numpy() for k, v in mets.items()},
                    jax.tree_util.tree_map(np.asarray, step_mets))
    assert float(mets["class_count"].sum()) == b["labels"].size
    flat_g = weights.flatten(jax.tree_util.tree_map(np.asarray, {"params": grads}))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat_g[weights.flax_key(name)],
                                   atol=1e-5, rtol=1e-3, err_msg=name)
    flat_bs = weights.flatten(jax.tree_util.tree_map(
        np.asarray, {"batch_stats": new_state.batch_stats}))
    for name, t in port.named_buffers():
        np.testing.assert_allclose(t.numpy(), flat_bs[weights.flax_key(name)],
                                   atol=1e-5, rtol=1e-5, err_msg=name)

    # Adam: both optimisers from the same parameters, fed JAX's gradients
    updates, _ = tx.update(grads, tx.init(jvars["params"]), jvars["params"])
    new_params = weights.flatten(jax.tree_util.tree_map(
        np.asarray, {"params": optax.apply_updates(jvars["params"], updates)}))
    fresh = TrainState.create(_pair()[2], LR)
    for name, p in fresh.model.named_parameters():
        p.grad = torch.from_numpy(np.array(flat_g[weights.flax_key(name)]))
    fresh.optimizer.step()
    for name, p in fresh.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new_params[weights.flax_key(name)],
                                   atol=1e-6, rtol=0, err_msg=name)


def test_eval_step_and_resident_steps_match_jax():
    jmodel, jvars, port = _pair(seed=4)
    raw = _raw_batch(seed=1)
    b = tunet.prepare_unet_batch(raw, NC, device_coords=False)
    _, eval_step = junet.make_unet_steps(jmodel, CLASS_WEIGHTS)
    jmets = eval_step(ModelState.create(jmodel.apply, jvars, optax.adam(LR)), b)
    state = TrainState.create(port, LR)
    _, t_eval = tunet.make_unet_steps(port, CLASS_WEIGHTS)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    got = t_eval(state, tb)
    _assert_metrics({k: v.numpy() for k, v in got.items()},
                    jax.tree_util.tree_map(np.asarray, jmets))
    # the resident form gathers the same rows on the device
    _, r_eval = tunet.make_unet_steps(port, CLASS_WEIGHTS, resident=True)
    data = {k: torch.cat([v, v]) for k, v in tb.items()}
    again = r_eval(state, data, torch.arange(4, 8))
    for k, v in got.items():
        assert torch.equal(again[k], v), k


def test_fold_per_class_ce_matches_jax():
    mets = {"loss": 1.0, "ce_class_sum": [2.0, 0.0, 3.0], "class_count": [4.0, 0.0, 2.0]}
    got = tunet._fold_per_class_ce(dict(mets))
    assert got == junet._fold_per_class_ce(dict(mets))
    assert got["ce_per_class"] == [0.5, 0.0, 1.5]
    assert tunet._fold_per_class_ce({"loss": 1.0}) == {"loss": 1.0}


@pytest.mark.parametrize("device_coords", [True, False])
@pytest.mark.parametrize("ship", ["float32", "float16"])
@pytest.mark.parametrize("nc", [NC, 300])
def test_prepare_unet_batch_equals_jax(device_coords, ship, nc):
    raw = _raw_batch(seed=2)
    raw["species"] = raw["species"].astype(np.int32) * 20  # past 256 too
    got = tunet.prepare_unet_batch(raw, nc, device_coords, ship)
    want = junet.prepare_unet_batch(raw, nc, device_coords, ship)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v)


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 6, (2, 4, 4, 4))
    logits = 3.0 * rng.standard_normal((2, 4, 4, 4, 6)).astype(np.float32)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    probs[0, 0, 0, 0] = [0.5, 0.5, 0.0, 0.0, 0.0, 0.0]  # round half to even
    onehot = np.eye(6, dtype=np.float32)[labels]
    tl, tp, to = (torch.from_numpy(a) for a in (labels, probs, onehot))
    jl, jp, jo = (jnp.asarray(a) for a in (labels, probs, onehot))
    pairs = [
        (tmetrics.recall(to, tp), jmetrics.recall(jo, jp)),
        (tmetrics.weighted_recall(to, tp, 6), jmetrics.weighted_recall(jo, jp, 6)),
        (tmetrics.precision(to, tp), jmetrics.precision(jo, jp)),
        (tmetrics.f1_score(to, tp), jmetrics.f1_score(jo, jp)),
        (tmetrics.recall_from_labels(tl, tp), jmetrics.recall_from_labels(jl, jp)),
        (tmetrics.weighted_recall_from_labels(tl, tp),
         jmetrics.weighted_recall_from_labels(jl, jp)),
        (tmetrics.precision_from_labels(tl, tp), jmetrics.precision_from_labels(jl, jp)),
        (tmetrics.f1_score_from_labels(tl, tp), jmetrics.f1_score_from_labels(jl, jp)),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=str(i))
    # the label forms equal the one-hot forms
    np.testing.assert_allclose(float(tmetrics.f1_score_from_labels(tl, tp)),
                               float(tmetrics.f1_score(to, tp)), rtol=1e-6)
    assert float(tmetrics.recall(to, tp)) > 0


# -- the CLI ------------------------------------------------------------------

NCLS = 60
BS = 4
CLI = ["--device", "cpu", "--batch-size", str(BS), "--nrot", "0",
       "--num-classes", str(NCLS)]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_unet_cli")


@pytest.fixture(scope="module")
def dataset(ws):
    out = str(ws / "synth")
    tvox_app.main(["--synthetic", "20", "--out", out, "--d", str(D), "--nrot", "0",
                   "--kinds", "perovskite,rocksalt", "--seed", "0", "--device", "cpu"])
    return out


@pytest.fixture(scope="module")
def unet_ckpt(ws, dataset):
    """MIGRATION form: train_unet --data --samples --epochs --batch-size
    --lr --ckpt."""
    ckpt = str(ws / "ckpt_unet")
    hist = tapp.main(["--data", dataset, "--samples", "20", "--epochs", "1",
                      "--lr", "3e-6", "--ckpt", ckpt] + CLI)
    # 20 parents -> 16 train (4 steps) / 4 val (1 batch)
    assert [h["steps"] for h in hist] == [4]
    assert np.isfinite(hist[0]["train"]["loss"]) and len(hist[0]["val"]["ce_per_class"]) == NCLS
    assert {"history.json", "best.npz", "latest.npz", "class_weights.json",
            "best_metric.json", "progress.json"} <= set(os.listdir(ckpt))
    with open(os.path.join(ckpt, "class_weights.json")) as f:
        cw = json.load(f)
    assert cw["class_weights"][0] == 0.0 and cw["n_weight_samples"] == 16
    assert sum(w > 0 for w in cw["class_weights"]) > 1
    return ckpt


def test_train_unet_resume(dataset, unet_ckpt, capsys):
    """--resume continues from ckpt/latest and appends history."""
    tapp.main(["--data", dataset, "--epochs", "1", "--ckpt", unet_ckpt, "--resume"]
              + CLI)
    assert "resumed from" in capsys.readouterr().out
    with open(os.path.join(unet_ckpt, "history.json")) as f:
        assert len(json.load(f)) == 2
    with open(os.path.join(unet_ckpt, "progress.json")) as f:
        assert json.load(f)["step"] == 8


def test_train_unet_no_class_weights(ws, dataset):
    ckpt = str(ws / "ckpt_unet_ncw")
    tapp.main(["--data", dataset, "--epochs", "1", "--ckpt", ckpt,
               "--no-class-weights"] + CLI)
    with open(os.path.join(ckpt, "class_weights.json")) as f:
        assert json.load(f)["class_weights"] is None


def test_train_unet_epoch_scan_matches_resident(ws, dataset):
    """--epoch-scan runs the epoch programs (train/graphs.py: eagerly on the
    CPU, over the per-step loop's batches): the metrics equal --resident's."""
    base = ["--data", dataset, "--epochs", "1", "--resident", "--ship-dtype",
            "float16"] + CLI
    plain = tapp.main(base + ["--ckpt", str(ws / "res")])
    scan = tapp.main(base + ["--ckpt", str(ws / "scan"), "--epoch-scan",
                             "--ckpt-every", "1"])
    for split in ("train", "val"):
        for k, v in plain[0][split].items():
            np.testing.assert_allclose(scan[0][split][k], v, rtol=1e-5, err_msg=k)
    assert os.path.exists(str(ws / "scan" / "best.npz"))


def test_train_unet_refusals(dataset, tmp_path):
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tapp.main(["--data", dataset, "--spatial", "2"] + CLI)
    with pytest.raises(SystemExit):
        tapp.main(["--data", dataset, "--epoch-scan", "--ckpt", str(tmp_path)] + CLI)
    with pytest.raises(SystemExit):
        tapp.main(["--data", dataset, "--resident", "--ckpt", str(tmp_path),
                   "--device", "cpu", "--nrot", "2"])


def test_unet_checkpoint_feeds_generate_and_train_vae(ws, dataset, unet_ckpt):
    recs = tgen.main(["--data", dataset, "--base", "syn-0", "--vae-ckpt", "none",
                      "--unet-ckpt", unet_ckpt, "--num-classes", str(NCLS),
                      "--filters", "4,8", "--latent", "8", "--nsamples", "2",
                      "--batch-size", "2", "--device", "cpu", "--fused",
                      "--output", str(ws / "gen")])
    assert len(recs) == 2
    hist = tvae_app.main(["--data", dataset, "--unet-ckpt", unet_ckpt,
                          "--epochs", "1", "--filters", "4,8", "--latent", "8",
                          "--ckpt", str(ws / "vae")] + CLI)
    assert hist[0]["train"]["perceptual"] > 0
    # the checkpoint holds the trained weights, not a fresh init
    with np.load(os.path.join(unet_ckpt, "best.npz")) as f:
        best = {k: f[k] for k in f.files}
    fresh = weights.flatten(weights.to_flax_variables(
        TorchUNet(tcfg.UNetConfig(num_classes=NCLS), torch.Generator().manual_seed(0))))
    assert not np.allclose(best["batch_stats/bn1/mean"], fresh["batch_stats/bn1/mean"])


def test_plot_forward_matches_jax():
    """The best-val panels' forward (4 of a batch of 5) against JAX's
    ``_plot_forward``: predicted labels equal, the occupancy sigmoid within
    atol 1e-5 (f32 through the U-Net), the true labels as given."""
    model, variables, port = _pair()
    raw = _raw_batch(n=5, seed=6)
    batch = tunet.prepare_unet_batch(raw, NC, device_coords=True)
    x = np.concatenate([raw["density"][..., None], raw["coords"]], -1)
    soft, sig = junet._plot_forward(model)(variables, jnp.asarray(x[:4]))
    true, pred, occ = tunet.plot_forward(
        port, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(true[..., 0], batch["labels"][:4])
    np.testing.assert_array_equal(pred[..., 0], np.asarray(jnp.argmax(soft, -1)))
    np.testing.assert_allclose(occ, np.asarray(jax.nn.sigmoid(sig)), atol=1e-5)


def test_save_best_plots_touches_no_training_state(tmp_path):
    """_save_best_plots writes its two panels and leaves the parameters,
    the BatchNorm running statistics and the Adam state bitwise as they
    were."""
    state = tunet.create_unet_state(tcfg.UNetConfig(**UNET_KW), LR, 0, "cpu")
    train_step, _ = tunet.make_unet_steps(state.model)
    batch = {k: torch.from_numpy(v) for k, v in
             tunet.prepare_unet_batch(_raw_batch(), NC).items()}
    train_step(state, batch)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt = {(i, k): v.clone() for i, s in enumerate(state.optimizer.state.values())
           for k, v in s.items() if torch.is_tensor(v)}
    tunet._save_best_plots(state.model, batch, str(tmp_path / "plots"))
    assert sorted(os.listdir(tmp_path / "plots")) == [
        "segmentations_best.png", "segmentations_binary_best.png"]
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for i, s in enumerate(state.optimizer.state.values()):
        for k, v in s.items():
            if torch.is_tensor(v):
                assert torch.equal(v, opt[(i, k)]), k


def test_train_unet_writes_plots(unet_ckpt):
    """Where matplotlib imports, the CLI writes the loss curves and the
    best-val panels of its first (improving) epoch."""
    assert os.path.exists(os.path.join(unet_ckpt, "loss.png"))
    assert sorted(os.listdir(os.path.join(unet_ckpt, "plots"))) == [
        "segmentations_best.png", "segmentations_binary_best.png"]
