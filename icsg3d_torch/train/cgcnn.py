"""CGCNN training: the train and eval steps and the epoch loop.

Counterpart of icsg3d_tpu/train/cgcnn.py (reference train_cgcnn.py): MSE
loss, MAE metric, Adam(1e-3) with optax's defaults, best-val-MAE
checkpointing.  One train step runs the CGCNN forward (the masked BN uses
the live batch's statistics), the loss, the backward pass and one Adam
update, in f32.  PyTorch runs the steps eagerly; the JAX package jits
them.

Data parallelism across processes (train/cgcnn.py:75-126 of the JAX
package shards every batch over its ``data`` axis): with a process group
in the train state each rank takes its block of rows of every batch, the
masked BN statistics are global (models/cgcnn.py), and the gradients and
metrics are averaged over the ranks.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import torch

from icsg3d_torch.config import CGCNNConfig
from icsg3d_torch.data.store import prefetch_to_device
from icsg3d_torch.models import CGCNN
from icsg3d_torch.ops import losses
from icsg3d_torch.parallel.distributed import mean_over_ranks
from icsg3d_torch.train.checkpoints import CheckpointManager
from icsg3d_torch.train.state import TrainState
from icsg3d_torch.train.vae import _host_metrics


def create_cgcnn_state(cfg: CGCNNConfig, learning_rate: float, seed: int,
                       device, group=None) -> TrainState:
    """A seeded fresh CGCNN (Flax's lecun-normal distribution, not its
    bits) on ``device`` with its Adam optimizer; ``group``, a
    torch.distributed process group, trains it data-parallel across
    processes (the module note)."""
    gen = torch.Generator().manual_seed(seed)
    return TrainState.create(CGCNN(cfg, gen, group).to(device), learning_rate, group)


def cgcnn_forward(model: CGCNN, batch) -> torch.Tensor:
    """(B,) predictions of a batch dict of graph tensors."""
    return model(batch["atom_fea"], batch["nbr_dist"], batch["nbr_idx"],
                 batch["atom_mask"])


def _cgcnn_losses(model: CGCNN, batch):
    preds = cgcnn_forward(model, batch)
    loss = losses.mse_loss(preds, batch["target"])
    return loss, {"loss": loss.detach(),
                  "mae": losses.mae(preds.detach(), batch["target"])}


def make_cgcnn_steps(model: CGCNN):
    """Build (train_step, eval_step): ``(state, batch) -> metrics`` (tensors
    on the model's device; no host sync) for the state that holds
    ``model``.  With a process group in the state the batch is this rank's
    rows and the metrics are the global batch's."""

    def train_step(state: TrainState, batch):
        state.optimizer.zero_grad(set_to_none=True)
        loss, mets = _cgcnn_losses(model, batch)
        loss.backward()
        state.apply_gradients()
        return mean_over_ranks(mets, state.group)

    def eval_step(state: TrainState, batch):
        with torch.no_grad():
            return mean_over_ranks(_cgcnn_losses(model, batch)[1], state.group)

    return train_step, eval_step


def train_cgcnn(
    model: CGCNN,
    state: TrainState,
    train_batches: Callable[[], Iterable],
    val_batches: Callable[[], Iterable],
    epochs: int,
    checkpoint_dir: Optional[str] = None,
    log_fn=print,
    latest_every: int = 1,
):
    """Epoch loop of icsg3d_tpu's train_cgcnn: per-epoch train/val metric
    means, best-val-MAE and latest checkpoints, a final ``latest`` save.
    train_batches/val_batches are zero-arg callables returning a fresh
    iterable of host numpy batches per epoch (remainders dropped by the
    caller).  With a process group in ``state`` each rank trains on its
    rows of every batch and only rank 0 writes checkpoints.  Returns
    (state, history)."""
    train_step, eval_step = make_cgcnn_steps(model)
    group = state.group
    ckpt = CheckpointManager(checkpoint_dir, group=group) if checkpoint_dir else None
    device = next(model.parameters()).device
    history = []
    for epoch in range(epochs):
        t0 = time.time()
        train_mets = [train_step(state, b)
                      for b in prefetch_to_device(train_batches(), device, group)]
        val_mets = [eval_step(state, b)
                    for b in prefetch_to_device(val_batches(), device, group)]
        tm = _host_metrics(train_mets)
        if not tm:
            raise ValueError(
                "no train batches: the train split is smaller than the "
                "batch size (remainders are dropped)"
            )
        vm = _host_metrics(val_mets)
        if not vm:
            if epoch == 0:
                log_fn(
                    "warning: no val batches (val split smaller than the "
                    "batch size) — 'val' metrics below are TRAIN metrics "
                    "and best-checkpoint selection is overfitting-blind"
                )
            vm = tm
        history.append({"train": tm, "val": vm, "time": time.time() - t0,
                        "steps": len(train_mets)})
        log_fn(
            f"epoch {epoch}: time {history[-1]['time']:.2f}s "
            f"train mse {tm['loss']:.4f} mae {tm['mae']:.4f} | "
            f"val mae {vm['mae']:.4f}"
        )
        if ckpt:
            ckpt.save_epoch(state, vm["mae"], epoch, latest_every=latest_every)
    if (ckpt and epochs > 0 and latest_every > 1
            and ckpt.last_latest_epoch != epochs - 1):
        ckpt.save_latest(state)  # final save so --resume continues from the end
    return state, history
