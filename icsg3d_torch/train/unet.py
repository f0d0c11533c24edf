"""U-Net training: the train and eval steps and the epoch loop.

Counterpart of icsg3d_tpu/train/unet.py (reference train_unet.py +
unet/unet.py:357-381): weighted categorical crossentropy on the ``soft``
head + binary crossentropy on the ``sig`` head, Adam, best-val
checkpointing, f1/weighted-recall metrics.  One train step runs the U-Net
forward with batch-statistics BN (14 conv forwards, epilogue ``bias``), the
losses, the backward pass (13 input gradients on K1 as dx: conv1's input
is data; 14 weight gradients on K2) and one Adam update.  The eval step is
the fused eval forward (14 folded conv + BN + ReLU launches).  PyTorch runs
the steps eagerly; the JAX package jits them.

The class weights are applied for real (the reference compiled its loss
with the integer num_classes as the weight vector, unet/unet.py:252-254);
``class_weights=None`` trains unweighted.  With ``plot_dir`` the loop
draws the best-val segmentation panels (matplotlib must import).

Data parallelism across processes (the JAX package's ``data`` mesh axis,
train/unet.py:356-460): with a process group in the train state each rank
takes its block of rows of every global batch; BatchNorm, the gradients
and the metrics are the global batch's.  ``f1`` and ``weighted_recall`` are
ratios of sums over the batch and ``ce_class_sum``/``class_count`` are
sums, so the ranks add those sums up before any ratio is taken.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from icsg3d_torch.config import UNetConfig
from icsg3d_torch.data.store import prefetch_to_device
from icsg3d_torch.models import UNet3D
from icsg3d_torch.ops import losses, metrics
from icsg3d_torch.parallel.distributed import all_reduce_, group_rank, group_size
from icsg3d_torch.parallel.mesh import Mesh, shard_batch
from icsg3d_torch.train.checkpoints import CheckpointManager, PlotThinning
from icsg3d_torch.train.graphs import (
    EpochProgram,
    capture_refusal,
    epoch_rows,
    run_epoch,
)
from icsg3d_torch.train.state import TrainState
from icsg3d_torch.train.vae import _assemble_x, _host_metrics


def create_unet_state(cfg: UNetConfig, learning_rate: float, seed: int,
                      device, spatial_mesh: Optional[Mesh] = None,
                      group=None) -> TrainState:
    """A seeded fresh U-Net (Flax's lecun-normal distribution, not its
    bits) on ``device`` with its Adam optimizer.  ``spatial_mesh`` shards
    its convs in depth (models/unet.py; train/unet.py:40-47 of the JAX
    package); ``device`` is the lead device, where the parameters live.
    ``group``, a torch.distributed process group, trains it data-parallel
    across processes (the module note)."""
    gen = torch.Generator().manual_seed(seed)
    model = UNet3D(cfg, gen, spatial_mesh, group).to(device)
    return TrainState.create(model, learning_rate, group)


def _unet_losses(model: UNet3D, batch, class_weights: torch.Tensor, train: bool,
                 group=None):
    """(total loss, metrics) of one batch (train/unet.py:60-115).

    Consumes integer species labels (batch["labels"]); the one-hot and the
    binary occupancy derive on the device.
    """
    soft, sig = model(_assemble_x(batch, None), train=train)
    return losses_from_logits(soft, sig, batch["labels"], class_weights, group)


def losses_from_logits(soft: torch.Tensor, sig: torch.Tensor, labels: torch.Tensor,
                       class_weights: torch.Tensor, group=None):
    """The loss and metrics of ``_unet_losses`` from the two heads' logits.
    With a process ``group`` the metrics are the global batch's: the means
    averaged over the ranks, the sums (per-class CE and counts, and the
    parts of f1 and weighted recall) summed, in one all-reduce."""
    labels = labels.long()
    y_sig = (labels != 0).float()[..., None]
    l_soft = torch.mean(
        losses.weighted_categorical_crossentropy_from_labels(soft, labels, class_weights)
    )
    l_sig = torch.mean(losses.binary_crossentropy_from_logits(sig, y_sig))
    loss = l_soft + l_sig
    with torch.no_grad():
        # unweighted CE and per-class CE beside the weighted loss, whose
        # value scales with the class-weight vector of the data build
        probs = torch.softmax(soft.detach(), dim=-1)
        nc = soft.shape[-1]
        p_true = torch.clamp(torch.gather(probs, -1, labels[..., None])[..., 0],
                             losses.KERAS_EPSILON, 1.0 - losses.KERAS_EPSILON)
        nll = -torch.log(p_true)
        flat_l = labels.reshape(-1)
        zeros = torch.zeros(nc, dtype=torch.float32, device=soft.device)
        means = torch.stack([loss.detach(), l_soft.detach(), l_sig.detach(), nll.mean()])
        f1 = metrics.f1_parts(labels, probs)
        wr = metrics.weighted_recall_parts(labels, probs)
        ce_class_sum = zeros.index_add(0, flat_l, nll.reshape(-1))
        class_count = zeros.index_add(0, flat_l, torch.ones_like(nll).reshape(-1))
        if group is not None:
            flat = all_reduce_(torch.cat([means, torch.stack([*f1, *wr]), ce_class_sum,
                                          class_count]), group)
            means, parts, ce_class_sum, class_count = flat.split([4, 5, nc, nc])
            means = means / group_size(group)
            f1, wr = parts[:3], parts[3:]
        mets = {
            "loss": means[0],
            "loss_soft": means[1],
            "loss_sig": means[2],
            "ce": means[3],
            "ce_class_sum": ce_class_sum,
            "class_count": class_count,
            "f1": metrics.f1_from_parts(*f1),
            "weighted_recall": metrics.weighted_recall_from_parts(*wr),
        }
    return loss, mets


def _unet_step_bodies(model: UNet3D, class_weights):
    """(train_body, eval_step), each ``(state, batch) -> metrics``; the
    train body updates the parameters but leaves ``state.step`` to its
    caller (``make_unet_steps`` or the epoch program)."""
    nc = model.cfg.num_classes
    device = next(model.parameters()).device
    cw = (torch.ones(nc) if class_weights is None
          else torch.as_tensor(np.asarray(class_weights), dtype=torch.float32))
    cw = cw.to(device)

    def train_body(state: TrainState, batch):
        state.optimizer.zero_grad(set_to_none=True)
        loss, mets = _unet_losses(state.model, batch, cw, True, state.group)
        loss.backward()
        state.update()
        return mets

    def eval_step(state: TrainState, batch):
        with torch.no_grad():
            return _unet_losses(state.model, batch, cw, False, state.group)[1]

    return train_body, eval_step


def make_unet_steps(model: UNet3D, class_weights=None, resident: bool = False):
    """Build (train_step, eval_step): ``(state, batch) -> metrics`` (tensors
    on the model's device; no host sync).

    resident=True builds steps for a dataset kept on the device: they take
    ``(state, data, idx)`` with ``data`` the whole split and ``idx`` the
    batch's row indices, and gather the batch on the device.  With a
    process group in the state the batch (or ``idx``) is this rank's rows
    and the metrics are the global batch's.
    """
    train_body, eval_step = _unet_step_bodies(model, class_weights)

    def train_step(state: TrainState, batch):
        mets = train_body(state, batch)
        state.step += 1
        return mets

    if not resident:
        return train_step, eval_step

    def _gather(data, idx):
        return {k: v[idx] for k, v in data.items()}

    return (lambda state, data, idx: train_step(state, _gather(data, idx)),
            lambda state, data, idx: eval_step(state, _gather(data, idx)))


def make_unet_epoch_fns(model: UNet3D, class_weights=None):
    """Whole-epoch programs for a device-resident split (the counterpart of
    icsg3d_tpu/train/unet.py:165, ``--epoch-scan``): (train_epoch,
    val_epoch), each ``(state, data, rows) -> (n_steps, k) metric buffer``
    (train/graphs.EpochProgram), ``rows`` the (n_steps, batch) row indices
    on the device.  Step i runs the step of ``make_unet_steps`` on those
    rows: a captured step replayed once per step on a CUDA model, the same
    body eagerly on the CPU.  ``program.means(fetched rows)`` takes the
    means over the step axis only, so ``ce_class_sum`` and ``class_count``
    keep their (num_classes,) shape for ``_fold_per_class_ce``."""
    train_body, eval_step = _unet_step_bodies(model, class_weights)
    return (EpochProgram("unet_train", lambda st, b, _: train_body(st, b), train=True),
            EpochProgram("unet_eval", lambda st, b, _: eval_step(st, b), train=False))


def prepare_unet_batch(
    batch: Dict[str, np.ndarray], num_classes: int,
    device_coords: bool = False,
    ship_dtype: str = "float32",
):
    """Raw store fields -> model inputs (host side, train/unet.py:230-262).

    x = density channel + coordinate channels (unet/data.py:90-100);
    labels = integer species clipped to the class range, uint8 for <= 256
    classes.  device_coords=True ships density + lattice lengths only; the
    coordinate channels rebuild on the device (non-rotated datasets only).
    ship_dtype="float16" halves the density bytes; coordinate channels
    always ship float32.
    """
    s = np.minimum(batch["species"].astype(np.int32), num_classes - 1)
    s = s.astype(np.uint8) if num_classes <= 256 else s
    dt = np.dtype(ship_dtype)
    if device_coords:
        return {
            "density": batch["density"].astype(dt),
            "abc": batch["lattice"][:, :3].astype(np.float32),
            "labels": s,
        }
    return {
        "density": batch["density"].astype(dt),
        "coords": batch["coords"].astype(np.float32),
        "labels": s,
    }


def _fold_per_class_ce(mets: dict) -> dict:
    """Replace the (ce_class_sum, class_count) accumulator vectors with the
    per-class mean CE — mean-of-sums / mean-of-counts over the epoch's
    batches == ratio of epoch totals, so classes absent from some batches
    are weighted correctly."""
    if "ce_class_sum" not in mets:
        return mets
    s = np.asarray(mets.pop("ce_class_sum"))
    c = np.asarray(mets.pop("class_count"))
    mets["ce_per_class"] = (s / np.maximum(c, 1.0)).tolist()
    return mets


def plot_forward(model: UNet3D, batch):
    """The arrays of the best-val panels (icsg3d_tpu/train/unet.py:289-313):
    an eval-mode forward of at most 4 samples of ``batch`` under
    ``torch.inference_mode`` (no graph, no BatchNorm statistics touched).
    Returns numpy (true labels, predicted labels, occupancy sigmoid), each
    (n, d, d, d, 1) float32."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        x = _assemble_x(batch, None)
        n = min(4, len(x))
        soft, sig = model(x[:n].to(device))
        pred = torch.argmax(soft, dim=-1).float()[..., None]
        true = batch["labels"][:n].float()[..., None]
        return tuple(t.float().cpu().numpy()
                     for t in (true, pred, torch.sigmoid(sig)))


def _save_best_plots(model: UNet3D, batch, plot_dir: str):
    """Best-val segmentation panels (the TrainingPlot callback,
    unet/unet.py:39-157): true vs predicted labels and binary masks."""
    from icsg3d_torch import viz

    os.makedirs(plot_dir, exist_ok=True)
    true, pred, occupancy = plot_forward(model, batch)
    viz.plot_real_vs_pred(true, pred, f"{plot_dir}/segmentations_best.png")
    viz.plot_real_vs_pred((true != 0).astype(np.float32), occupancy,
                          f"{plot_dir}/segmentations_binary_best.png")


def train_unet(
    model: UNet3D,
    state: TrainState,
    train_batches: Optional[Callable[[], Iterable]],
    val_batches: Optional[Callable[[], Iterable]],
    epochs: int,
    class_weights=None,
    checkpoint_dir: Optional[str] = None,
    log_fn=print,
    plot_dir: Optional[str] = None,
    latest_every: int = 1,
    resident_data=None,
    batch_size: Optional[int] = None,
    shuffle_seed: int = 0,
    epoch_scan: bool = False,
    plot_min_interval: int = 1,
):
    """Epoch loop with best-val checkpointing (train/unet.py:317-516), and
    with ``plot_dir`` the best-val panels of the last val batch when
    ``best`` improves, at most once per ``plot_min_interval`` epochs.

    train_batches/val_batches are zero-arg callables returning a fresh
    iterable of host numpy batches (prepare_unet_batch) per epoch.
    resident_data=(train_dict, val_dict) instead keeps both splits on the
    device and gathers every batch by index, from the per-epoch host
    permutation ``np.random.default_rng((shuffle_seed, epoch))``; it needs
    ``batch_size``.  epoch_scan (resident only) runs each epoch through
    ``make_unet_epoch_fns``: one upload of the (n_steps, batch)
    permutation, the steps as replays of a captured train and eval step
    on a CUDA model (eagerly on the CPU), one fetch of the metric rows;
    the batches are the per-step path's, so the two give the same
    trajectory.  Under an NCCL process group each rank uploads its block
    of every step's rows and replays the step with its all-reduces
    captured; with a gloo group on a CUDA model, or a mesh on several
    devices, it says why and runs the per-step loop
    (train/graphs.capture_refusal).
    The final ``latest`` save always runs.  With a
    process group in ``state`` each rank trains on its rows of every batch
    and only rank 0 writes checkpoints and plots.  Returns (state,
    history).
    """
    resident = resident_data is not None
    if epoch_scan and not resident:
        raise ValueError("epoch_scan requires resident_data")
    train_step, eval_step = make_unet_steps(model, class_weights, resident=resident)
    group = state.group
    ckpt = CheckpointManager(checkpoint_dir, group=group) if checkpoint_dir else None
    if group_rank(group) != 0:
        plot_dir = None
    device = next(model.parameters()).device
    history = []
    last_val_batch = None
    thinning = PlotThinning(plot_min_interval)
    if epoch_scan:
        refusal = capture_refusal(state)
        if refusal:
            log_fn(f"--epoch-scan: not captured ({refusal}); running the "
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
        n_train = len(next(iter(t_host.values())))
        n_val = len(next(iter(v_host.values()))) if v_host else 0
        nb_train, nb_val = n_train // batch_size, n_val // batch_size

        def rows(r: np.ndarray) -> torch.Tensor:
            # this rank's rows of the global batch ``r``
            return torch.from_numpy(shard_batch(r, group).astype(np.int64)).to(device)

        if nb_val:  # the plotted batch: the last full val batch
            idx = rows(np.arange((nb_val - 1) * batch_size, nb_val * batch_size))
            last_val_batch = {k: v[idx] for k, v in v_dev.items()}
        if epoch_scan:
            programs = make_unet_epoch_fns(model, class_weights)
            val = (v_dev, epoch_rows(np.arange(n_val), nb_val, batch_size, device,
                                     group)) if nb_val else None

    for epoch in range(epochs):
        t0 = time.time()
        if epoch_scan and nb_train:
            perm = np.random.default_rng((shuffle_seed, epoch)).permutation(n_train)
            tm, vm = run_epoch(programs, state, [
                (t_dev, epoch_rows(perm, nb_train, batch_size, device, group)), val])
            n_steps = nb_train
        else:
            train_mets, val_mets = [], []
            if resident:
                perm = np.random.default_rng((shuffle_seed, epoch)).permutation(n_train)
                for i in range(nb_train):
                    idx = rows(perm[i * batch_size:(i + 1) * batch_size])
                    train_mets.append(train_step(state, t_dev, idx))
                for i in range(nb_val):
                    idx = rows(np.arange(i * batch_size, (i + 1) * batch_size))
                    val_mets.append(eval_step(state, v_dev, idx))
            else:
                for b in prefetch_to_device(train_batches(), device, group):
                    train_mets.append(train_step(state, b))
                for b in prefetch_to_device(val_batches(), device, group):
                    val_mets.append(eval_step(state, b))
                    last_val_batch = b
            tm, vm = _host_metrics(train_mets), _host_metrics(val_mets)
            n_steps = len(train_mets)
        if not tm:
            raise ValueError(
                "no train batches: the train split is smaller than the "
                "batch size (remainders are dropped)"
            )
        if not vm:
            if epoch == 0:
                log_fn(
                    "warning: no val batches (val split smaller than the "
                    "batch size) — 'val' metrics below are TRAIN metrics "
                    "and best-checkpoint selection is overfitting-blind"
                )
            vm = dict(tm)
        tm = _fold_per_class_ce(tm)
        vm = _fold_per_class_ce(vm)
        epoch_time = time.time() - t0
        history.append({"train": tm, "val": vm, "time": epoch_time,
                        "steps": n_steps})
        log_fn(
            f"epoch {epoch}: time {epoch_time:.2f}s "
            f"train loss {tm['loss']:.4f} ce {tm['ce']:.4f} "
            f"f1 {tm['f1']:.3f} | "
            f"val loss {vm['loss']:.4f} ce {vm['ce']:.4f} f1 {vm['f1']:.3f}"
        )
        if ckpt:
            improved = ckpt.save_epoch(state, vm["loss"], epoch,
                                       latest_every=latest_every)
            if (plot_dir and last_val_batch is not None
                    and thinning.due(improved, epoch)):
                _save_best_plots(model, last_val_batch, plot_dir)
    if (ckpt and epochs > 0 and latest_every > 1
            and ckpt.last_latest_epoch != epochs - 1):
        ckpt.save_latest(state)  # final save so --resume continues from the end
    return state, history
