"""Checkpointing with a best-validation policy, in the port's own format.

Counterpart of icsg3d_tpu/train/checkpoints.py (Orbax), with its policy:
``best`` holds the inference slice and is written when the validation
metric improves (a NaN metric never does); ``latest`` holds the whole
train state and is written on its cadence; ``best_metric.json`` persists
the best metric and the mode, which a reopen must match; ``progress.json``
records the step that ``latest`` holds.

The files are flat ``.npz`` with Flax-named keys (icsg3d_torch/weights.py):

- ``best.npz``: params/..., batch_stats/..., step -- what generate and the
  VAE trainer's ``--unet-ckpt`` load (apps/common.weights_path resolves a
  checkpoint directory to it);
- ``latest.npz``: the same plus the Adam moments opt_state/{mu,nu}/... .

Every write goes to a temporary file that ``os.replace`` then swaps in
atomically, so a kill mid-save leaves the previous checkpoint whole.

Data parallelism across processes: with a torch.distributed ``group`` the
ranks hold identical states and see the same global metric, so they agree
on every best/latest decision; rank 0 alone writes (the directory too),
and every rank waits for it at ``sync_hosts`` after each save.  Every rank
reads (``restore``, ``best_metric.json``).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

import numpy as np

from icsg3d_torch.parallel.distributed import group_rank, sync_hosts
from icsg3d_torch.train.state import TrainState


class PlotThinning:
    """The trainers' best-val plot refresh rule (icsg3d_tpu/train/vae.py:
    808-816): refresh when ``best`` improved, at most once per
    ``min_interval`` epochs."""

    def __init__(self, min_interval: int = 1):
        self.min_interval = min_interval
        self.last = -min_interval  # epoch 0 may plot

    def due(self, improved: bool, epoch: int) -> bool:
        if improved and epoch - self.last >= self.min_interval:
            self.last = epoch
            return True
        return False


class CheckpointManager:
    """Saves `best` and `latest` train states under a directory."""

    def __init__(self, directory: str, mode: str = "min", group=None):
        self.directory = os.path.abspath(directory)
        self.group = group
        self.writer = group_rank(group) == 0
        if self.writer:
            os.makedirs(self.directory, exist_ok=True)
        self.mode = mode
        self.best_metric: Optional[float] = None
        self.last_latest_epoch: Optional[int] = None  # set by save_epoch
        meta = os.path.join(self.directory, "best_metric.json")
        if os.path.exists(meta):
            try:
                with open(meta) as f:
                    data = json.load(f)
                self.best_metric = data["metric"]
                saved_mode = data.get("mode", "min")
                if saved_mode != mode:
                    raise ValueError(
                        f"checkpoint dir {directory} was written with "
                        f"mode={saved_mode!r}, reopened with {mode!r} — "
                        "the persisted best metric would be compared in "
                        "the wrong direction"
                    )
            except (json.JSONDecodeError, KeyError):
                # a kill mid-write leaves a truncated file; treat as no
                # prior best rather than refusing to start
                self.best_metric = None

    def path(self, which: str) -> str:
        return os.path.join(self.directory, which + ".npz")

    def _is_better(self, metric: float) -> bool:
        if not math.isfinite(metric):
            # NaN must never become "best": accepted once, no finite
            # metric ever compares better and best-saving wedges
            return False
        if self.best_metric is None or not math.isfinite(self.best_metric):
            return True
        return metric < self.best_metric if self.mode == "min" else metric > self.best_metric

    def _write(self, name: str, flat: Dict[str, np.ndarray]) -> None:
        path = self.path(name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)

    def _write_json(self, name: str, obj) -> None:
        meta = os.path.join(self.directory, name)
        tmp = meta + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, meta)  # atomic: no truncated json on kill

    def _sync(self) -> None:
        if self.group is not None:
            sync_hosts(self.group)

    def save_latest(self, state: TrainState) -> None:
        if self.writer:
            self._write("latest", state.arrays(with_optimizer=True))
            self._write_json("progress.json", {"step": int(state.step)})
        self._sync()

    def save_epoch(self, state: TrainState, metric: float, epoch: int,
                   latest_every: int = 1) -> bool:
        """Per-epoch best/latest saves with at most one device fetch: the
        full state when the `latest` cadence is due (serving both files),
        else only the inference slice when `best` improved.  Returns
        whether `best` improved."""
        improved = self._is_better(float(metric))
        due = latest_every <= 1 or (epoch + 1) % latest_every == 0
        if not improved and not due:
            return False
        if due:
            self.last_latest_epoch = epoch
        if improved:
            self.best_metric = float(metric)
        if self.writer:
            self._save(state, improved, due)
        self._sync()
        return improved

    def _save(self, state: TrainState, improved: bool, due: bool) -> None:
        if due:
            full = state.arrays(with_optimizer=True)
            infer = {k: v for k, v in full.items() if not k.startswith("opt_state/")}
        else:
            full = None
            infer = state.arrays(with_optimizer=False)
        if improved:
            self._write("best", infer)
            self._write_json("best_metric.json",
                             {"metric": self.best_metric, "mode": self.mode})
        if full is not None:
            self._write("latest", full)
            self._write_json("progress.json", {"step": int(full["step"])})

    def restore(self, state: TrainState, which: str = "best") -> TrainState:
        """Load `which` into ``state`` in place (the model, the step, and for
        `latest` the Adam moments); returns it."""
        with np.load(self.path(which)) as f:
            state.load_arrays({k: f[k] for k in f.files})
        return state

    def has(self, which: str = "best") -> bool:
        return os.path.exists(self.path(which))
