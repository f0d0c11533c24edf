"""Conditional DFC-VAE training: the train and eval steps and the epoch loop.

Counterpart of icsg3d_tpu/train/vae.py (reference train_vae.py +
vae/lattice_vae.py:272-342): loss = MSE + alpha*perceptual + beta*KLD,
where the perceptual term compares the frozen U-Net's post-ReLU
activations of the input and the reconstruction (vae/lattice_vae.py:
241-270).  One train step runs the VAE forward with batch-statistics BN,
two U-Net forwards cut at max(taps), the loss, the backward pass (conv
input gradients through the U-Net and the VAE, conv weight gradients for
the VAE) and one Adam update.  PyTorch runs it eagerly; the JAX package
jits it into one program.

The reparameterization noise is drawn by the caller and passed in
(``eps``): torch's and JAX's generators give different numbers.

Data parallelism across processes (the JAX package's ``data`` mesh axis,
train/vae.py:599-760): with a process group in the train state, every
process builds the same global batch and noise and takes its own block of
rows (parallel/mesh.shard_batch); the BatchNorm moments, the gradients and
the metrics are the global batch's (models/layers.py, TrainState,
``mean_over_ranks``), and only rank 0 writes checkpoints and plots.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from icsg3d_torch.config import GridSpec, VAEConfig
from icsg3d_torch.data.store import prefetch_to_device
from icsg3d_torch.models import ConditionalDFCVAE, UNet3D
from icsg3d_torch.models.unet import unet_features
from icsg3d_torch.models.vae import sample_prior
from icsg3d_torch.ops import losses
from icsg3d_torch.ops.grid import coordinate_grids
from icsg3d_torch.parallel.distributed import group_rank, group_size, mean_over_ranks
from icsg3d_torch.parallel.mesh import Mesh, shard_batch
from icsg3d_torch.train.checkpoints import CheckpointManager, PlotThinning
from icsg3d_torch.train.common import mean_metrics as _mean_metrics
from icsg3d_torch.train.graphs import (
    EpochProgram,
    capture_refusal,
    epoch_rows,
    run_epoch,
)
from icsg3d_torch.train.state import TrainState


def create_vae_state(cfg: VAEConfig, learning_rate: float, seed: int,
                     device, spatial_mesh: Optional[Mesh] = None,
                     group=None) -> TrainState:
    """A seeded fresh VAE (Flax's lecun-normal distribution, not its bits)
    on ``device`` with its Adam optimizer.  ``spatial_mesh`` shards its
    convs in depth (models/vae.py; train/vae.py:34-41 of the JAX package);
    ``device`` is the lead device, where the parameters live.  ``group``,
    a torch.distributed process group, trains it data-parallel across
    processes (the module note); every rank builds the same weights."""
    gen = torch.Generator().manual_seed(seed)
    model = ConditionalDFCVAE(cfg, gen, spatial_mesh, group).to(device)
    return TrainState.create(model, learning_rate, group)


def _assemble_x(batch, grid: Optional[GridSpec]):
    """Model input from a batch carrying "x" grids, density + "coords"
    channels, or density + lattice lengths "abc" (train/vae.py:69-93).

    With "abc" the coordinate channels are rebuilt on the device from the
    lattice lengths (utils.py:88-94), so a non-rotated dataset ships 3
    scalars per sample instead of 3 float32 channels.
    """
    if "x" in batch:
        return batch["x"].float()
    density = batch["density"][..., None].float()
    if "coords" in batch:
        return torch.cat([density, batch["coords"].float()], dim=-1)
    if grid is None:  # infer geometry from the density grid (default eps)
        grid = GridSpec(d=batch["density"].shape[1])
    return torch.cat([density, coordinate_grids(batch["abc"], grid)], dim=-1)


def _vae_losses(model: ConditionalDFCVAE, unet: Optional[UNet3D], batch, eps,
                train: bool, remat_perceptual: bool = False):
    """(total loss, metrics) of one batch (train/vae.py:96-163).

    Pre-gathered true-grid features (``pfeat_<tap>`` entries, from
    ``precompute_true_features``) replace the true-side U-Net forward.
    """
    cfg = model.cfg
    taps = cfg.perceptual_taps
    pf_keys = [f"pfeat_{i}" for i in taps]
    f_true_cached = (
        [batch[k] for k in pf_keys] if all(k in batch for k in pf_keys) else None
    )
    x = _assemble_x(batch, cfg.grid)
    recon, z_mean, z_log_var, _ = model(x, batch["cond"], eps, train=train)

    mse = losses.mse_flat(x, recon)
    kld = losses.kld_gaussian(z_mean, z_log_var)
    if unet is not None:
        def feats(xx):
            return unet_features(unet, xx, taps)

        if f_true_cached is not None:
            f_true = f_true_cached
        else:
            # frozen net, constant input: no graph is kept for this forward
            with torch.no_grad():
                f_true = feats(x)
        if remat_perceptual and torch.is_grad_enabled():
            # recompute the recon-side forward in the backward pass instead
            # of keeping its activations
            # (the frozen forward draws no random numbers, so no RNG state
            # is saved and restored: nothing for a CUDA graph to hold)
            f_pred = checkpoint(feats, recon, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            f_pred = feats(recon)
        pm = losses.perceptual_feature_loss(f_true, f_pred,
                                            cfg.perceptual_tap_weights)
    else:
        pm = torch.zeros_like(mse)
    kld_term = torch.clamp(kld, min=cfg.kld_floor) if cfg.kld_floor > 0 else kld
    total = torch.mean(mse + cfg.alpha * pm + cfg.beta * kld_term)
    mets = {
        "loss": total,
        "mse": mse.mean(),
        "perceptual": pm.mean(),
        "kld": kld.mean(),
    }
    return total, mets


def _vae_step_bodies(model: ConditionalDFCVAE, unet: Optional[UNet3D],
                     remat_perceptual: bool):
    """(train_body, eval_step), each ``(state, batch, eps) -> metrics``; the
    train body updates the parameters but leaves ``state.step`` to its
    caller (``make_vae_steps`` or the epoch program)."""
    if unet is not None:
        unet.eval().requires_grad_(False)

    def train_body(state: TrainState, batch, eps):
        state.optimizer.zero_grad(set_to_none=True)
        total, mets = _vae_losses(state.model, unet, batch, eps, train=True,
                                  remat_perceptual=remat_perceptual)
        total.backward()
        state.update()
        return mean_over_ranks({k: v.detach() for k, v in mets.items()}, state.group)

    def eval_step(state: TrainState, batch, eps):
        with torch.no_grad():
            _, mets = _vae_losses(state.model, unet, batch, eps, train=False)
        return mean_over_ranks(mets, state.group)

    return train_body, eval_step


def make_vae_steps(model: ConditionalDFCVAE, unet: Optional[UNet3D] = None,
                   remat_perceptual: bool = False):
    """Build (train_step, eval_step), each ``(state, batch, eps) ->
    metrics`` (0-d tensors on the batch's device; no host sync).

    unet=None trains a plain (non-DFC) conditional VAE.  The U-Net is
    frozen here: eval mode, no parameter gradients.  With a process group
    in the state, ``batch`` and ``eps`` are this rank's rows and the
    metrics are the global batch's.
    """
    train_body, eval_step = _vae_step_bodies(model, unet, remat_perceptual)

    def train_step(state: TrainState, batch, eps):
        mets = train_body(state, batch, eps)
        state.step += 1
        return mets

    return train_step, eval_step


def make_vae_epoch_fns(model: ConditionalDFCVAE, unet: Optional[UNet3D] = None,
                       remat_perceptual: bool = False):
    """Whole-epoch programs for a device-resident split (the counterpart of
    icsg3d_tpu/train/vae.py:228, ``--epoch-scan``): (train_epoch,
    val_epoch), each ``(state, data, rows, noise) -> (n_steps, k) metric
    buffer`` (train/graphs.EpochProgram).

    ``data`` is the resident split on the model's device (with the cached
    ``pfeat_<tap>`` entries of ``precompute_true_features``, gathered like
    every field); ``rows`` the (n_steps, batch) row indices on the device;
    ``noise`` the (n_steps, batch, latent) rows, row i the i-th draw of the
    per-step path's generator.  Step i runs the step of ``make_vae_steps``
    on those rows and that noise, so both paths take the same batches,
    noise and updates.  On a CUDA model each is a captured step replayed
    once per step; on the CPU the same body runs eagerly.  Metric means:
    ``program.means(fetched rows)``."""
    train_body, eval_step = _vae_step_bodies(model, unet, remat_perceptual)
    return (EpochProgram("vae_train", train_body, train=True),
            EpochProgram("vae_eval", eval_step, train=False))


def true_feature_cache_bytes(model: ConditionalDFCVAE, unet: UNet3D,
                             n_samples: int) -> int:
    """Device bytes of the true-feature cache for ``n_samples``, from the
    U-Net's plan: conv i sits at level (i - 1) // 2, the encoder halving
    the grid edge per level down to the bottom, the decoder doubling it."""
    levels = len(unet.cfg.enc_filters)
    per_sample = 0
    for i in model.cfg.perceptual_taps:
        level = (i - 1) // 2
        depth = level if level <= levels else 2 * levels - level
        edge = model.cfg.grid.d // 2 ** depth
        per_sample += edge ** 3 * getattr(unet, f"conv{i}").kernel.shape[-1]
    itemsize = {"bfloat16": 2, "float32": 4}[unet.cfg.dtype]
    return n_samples * itemsize * per_sample


def precompute_true_features(model: ConditionalDFCVAE, unet: UNet3D,
                             data_dev: Dict[str, torch.Tensor],
                             batch_size: int) -> Dict[str, torch.Tensor]:
    """True-grid perceptual tap activations for a whole resident split
    (train/vae.py:339-431): the U-Net is frozen and the data fixed, so the
    true side of the DFC loss is a per-sample constant computed once.
    Runs in batches of ``batch_size`` (the last padded with the split's
    first rows, then cut off) and returns {"pfeat_<tap>": (N, ...)}."""
    taps = model.cfg.perceptual_taps
    n = len(next(iter(data_dev.values())))
    fields = {k: v for k, v in data_dev.items()
              if k in ("density", "abc", "coords", "x")}
    out: Dict[int, List[torch.Tensor]] = {t: [] for t in taps}
    with torch.no_grad():
        for start in range(0, n, batch_size):
            rows = torch.arange(start, start + batch_size) % n
            b = {k: v[rows.to(v.device)] for k, v in fields.items()}
            x = _assemble_x(b, model.cfg.grid)
            for t, f in zip(taps, unet_features(unet, x, taps)):
                out[t].append(f)
    return {f"pfeat_{t}": torch.cat(out[t])[:n] for t in taps}


def prepare_vae_batch(batch: Dict[str, np.ndarray], cond: np.ndarray,
                      device_coords: bool = False,
                      ship_dtype: str = "float32"):
    """Raw store fields + per-sample one-hot conds -> model inputs
    (train/vae.py:453-488).

    device_coords=True ships only the density + lattice lengths and
    rebuilds the coordinate channels on the device (valid only for
    non-rotated samples).  ship_dtype="float16" halves the density bytes
    on the wire; the step casts back to float32.  The coordinate channels
    always ship float32: they are the lattice-parameter regression target.
    """
    dt = np.dtype(ship_dtype)
    if device_coords:
        return {
            "density": batch["density"].astype(dt),
            "abc": batch["lattice"][:, :3].astype(np.float32),
            "cond": cond.astype(np.float32),
        }
    return {
        "density": batch["density"].astype(dt),
        "coords": batch["coords"].astype(np.float32),
        "cond": cond.astype(np.float32),
    }


def _host_metrics(mets: List[Dict[str, torch.Tensor]]):
    """Per-step metric tensors -> the epoch's means, with one device fetch."""
    if not mets:
        return {}
    stacked = {k: torch.stack([m[k] for m in mets]).float().cpu().numpy()
               for k in mets[0]}
    return _mean_metrics([{k: v[i] for k, v in stacked.items()}
                          for i in range(len(mets))])


def plot_forwards(model: ConditionalDFCVAE, batch, epoch: int, eps=None, z=None,
                  bins=None):
    """The arrays of the best-val plots (icsg3d_tpu/train/vae.py:520-547):
    an eval-mode reconstruction of at most 4 samples of ``batch`` and one
    ``sample_prior`` decode, under ``torch.inference_mode`` (no graph, no
    BatchNorm statistics touched).  The reconstruction's noise ``eps`` (n,
    latent) defaults to a draw from ``torch.Generator().manual_seed(0)``
    (JAX uses key(0)), the prior's from one seeded with ``epoch`` (JAX:
    key(epoch)); ``z`` and ``bins`` pass the prior's draws in.  Returns
    numpy (x, reconstruction, z_mean, prior sample)."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        x = _assemble_x(batch, model.cfg.grid)
        n = min(4, len(x))
        x, cond = x[:n].to(device), batch["cond"][:n].float().to(device)
        if eps is None:
            eps = torch.randn((n, model.cfg.latent_dim),
                              generator=torch.Generator().manual_seed(0))
        eps = torch.as_tensor(eps, dtype=torch.float32).to(device)
        recon, z_mean, _, _ = model(x, cond, eps)
        _, samples = sample_prior(model, 1, z=z, bins=bins,
                                  generator=torch.Generator().manual_seed(epoch))
        return tuple(t.float().cpu().numpy() for t in (x, recon, z_mean, samples))


def _save_best_plots(model, batch, plot_dir: str, epoch: int):
    """Best-val visualization set (vae/lattice_vae.py:327-337):
    reconstructions, a prior sample, the latents' KDE."""
    from icsg3d_torch import viz

    os.makedirs(plot_dir, exist_ok=True)
    x, recon, z_mean, samples = plot_forwards(model, batch, epoch)
    viz.plot_real_vs_pred(x, recon, f"{plot_dir}/reconstructions.png")
    viz.plot_slices(samples[0], f"{plot_dir}/samples.png")
    viz.plot_latent_kde(z_mean, f"{plot_dir}/latent_kde.png")


def train_vae(
    model: ConditionalDFCVAE,
    state: TrainState,
    train_batches: Optional[Callable[[], Iterable]],
    val_batches: Optional[Callable[[], Iterable]],
    epochs: int,
    unet: Optional[UNet3D] = None,
    checkpoint_dir: Optional[str] = None,
    seed: int = 0,
    plot_dir: Optional[str] = None,
    latest_every: int = 1,
    plot_min_interval: int = 1,
    remat_perceptual: bool = False,
    resident_data=None,
    batch_size: Optional[int] = None,
    shuffle_seed: int = 0,
    cache_true_features: bool = False,
    epoch_scan: bool = False,
):
    """Epoch loop mirroring icsg3d_tpu's train_vae (train/vae.py:550-824):
    per-epoch train/val metric means, a wall-clock line, best/latest
    checkpoints, and with ``plot_dir`` the best-val plots of the last val
    batch (``_save_best_plots``) when ``best`` improves, at most once per
    ``plot_min_interval`` epochs (matplotlib must import).

    train_batches/val_batches are zero-arg callables returning a fresh
    iterable of host numpy batches per epoch.  resident_data=(train_dict,
    val_dict) instead keeps both splits on the device and gathers every
    batch by index, from the per-epoch host permutation
    ``np.random.default_rng((shuffle_seed, epoch))`` of the JAX package.
    epoch_scan (resident only) runs each epoch through
    ``make_vae_epoch_fns``: one upload of the (n_steps, batch)
    permutation, the steps as replays of a captured train and eval step
    on a CUDA model (eagerly on the CPU), one fetch of the metric rows.
    The batches and noise are the per-step path's (train/vae.py:254-267
    of the JAX package), so the two give the same trajectory and
    ``--resume`` may switch between them.  Under an NCCL process group
    each rank uploads its block of every step's rows and replays the
    step with its all-reduces captured; with a gloo group on a CUDA
    model, or a mesh on several devices, it says why and runs the
    per-step loop (train/graphs.capture_refusal).

    Batches and noise go to the device of the model's parameters.  The
    noise of step i is the i-th draw of one ``torch.Generator`` seeded
    with ``seed``.  With a process group in ``state`` each rank trains on
    its rows of every batch and of its noise, drawn for the global batch;
    the plots and checkpoints are rank 0's.  Returns (state, history).
    """
    resident = resident_data is not None
    if epoch_scan and not resident:
        raise ValueError("epoch_scan requires resident_data")
    train_step, eval_step = make_vae_steps(model, unet, remat_perceptual)
    group = state.group
    ckpt = CheckpointManager(checkpoint_dir, group=group) if checkpoint_dir else None
    if group_rank(group) != 0:
        plot_dir = None
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    latent = model.cfg.latent_dim
    world = group_size(group)
    history = []
    last_val_batch = None
    thinning = PlotThinning(plot_min_interval)

    def noise(n):
        # the global batch's draw (n rows per rank), then this rank's rows
        return shard_batch(torch.randn((n * world, latent), generator=gen,
                                       device=device), group)

    if epoch_scan:
        refusal = capture_refusal(state)
        if refusal:
            print(f"--epoch-scan: not captured ({refusal}); running the "
                  "per-step resident loop")
            epoch_scan = False
    if resident:
        if not batch_size:
            raise ValueError("resident_data requires batch_size")
        t_host, v_host = resident_data
        t_dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in t_host.items()}
        v_dev = ({k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for k, v in v_host.items()} if v_host else None)
        if cache_true_features and unet is not None:
            feats = precompute_true_features(model, unet, t_dev, batch_size)
            t_dev.update(feats)
            print(
                "cached true-grid perceptual features: "
                f"{sum(v.nbytes for v in feats.values()) / 1e9:.2f} GB "
                "device memory; true-side U-Net forward skipped every step"
            )
            del feats
        n_train = len(next(iter(t_host.values())))
        n_val = len(next(iter(v_host.values()))) if v_host else 0
        nb_train, nb_val = n_train // batch_size, n_val // batch_size

        def gather(data, rows: np.ndarray):
            # this rank's rows of the global batch ``rows``
            idx = torch.from_numpy(shard_batch(rows, group).astype(np.int64)).to(device)
            return {k: v[idx] for k, v in data.items()}

        if nb_val:  # the plotted batch: the last full val batch
            last_val_batch = gather(
                v_dev, np.arange((nb_val - 1) * batch_size, nb_val * batch_size))
        if epoch_scan:
            programs = make_vae_epoch_fns(model, unet, remat_perceptual)
            val = (v_dev, epoch_rows(np.arange(n_val), nb_val, batch_size, device,
                                     group)) if nb_val else None

    for epoch in range(epochs):
        t0 = time.time()
        if epoch_scan and nb_train:
            perm = np.random.default_rng((shuffle_seed, epoch)).permutation(n_train)
            rows = epoch_rows(perm, nb_train, batch_size, device, group)
            # each step's draw as the per-step path takes it
            tm, vm = run_epoch(programs, state, [(t_dev, rows), val], noise=lambda n: (
                torch.stack([noise(batch_size // world) for _ in range(n)])))
            n_steps = nb_train
        else:
            train_mets, val_mets = [], []
            if resident:
                perm = np.random.default_rng((shuffle_seed, epoch)).permutation(n_train)
                for i in range(nb_train):
                    b = gather(t_dev, perm[i * batch_size:(i + 1) * batch_size])
                    train_mets.append(train_step(state, b, noise(batch_size // world)))
                for i in range(nb_val):
                    b = gather(v_dev, np.arange(i * batch_size, (i + 1) * batch_size))
                    val_mets.append(eval_step(state, b, noise(batch_size // world)))
            else:
                for b in prefetch_to_device(train_batches(), device, group):
                    train_mets.append(train_step(state, b, noise(len(b["cond"]))))
                for b in prefetch_to_device(val_batches(), device, group):
                    val_mets.append(eval_step(state, b, noise(len(b["cond"]))))
                    last_val_batch = b
            tm, vm = _host_metrics(train_mets), _host_metrics(val_mets)
            n_steps = len(train_mets)
        if not tm:
            raise ValueError(
                "no train batches: the train split is smaller than the "
                "batch size (remainders are dropped, vae/data.py:45 parity)"
            )
        if not vm:
            if epoch == 0:
                print(
                    "warning: no val batches (val split smaller than the "
                    "batch size) — 'val' metrics below are TRAIN metrics "
                    "and best-checkpoint selection is overfitting-blind"
                )
            vm = tm
        epoch_time = time.time() - t0
        history.append({"train": tm, "val": vm, "time": epoch_time,
                        "steps": n_steps})
        print(
            f"epoch {epoch}: time {epoch_time:.2f}s "
            f"({n_steps / max(epoch_time, 1e-9):.1f} steps/s) "
            f"train loss {tm['loss']:.4f} mse {tm['mse']:.4f} "
            f"pm {tm['perceptual']:.4f} kld {tm['kld']:.2f} | "
            f"val loss {vm['loss']:.4f}"
        )
        if ckpt:
            improved = ckpt.save_epoch(state, vm["loss"], epoch,
                                       latest_every=latest_every)
            if (plot_dir and last_val_batch is not None
                    and thinning.due(improved, epoch)):
                _save_best_plots(model, last_val_batch, plot_dir, epoch)
    if (ckpt and epochs > 0 and latest_every > 1
            and ckpt.last_latest_epoch != epochs - 1):
        ckpt.save_latest(state)  # final save so --resume continues from the end
    return state, history
