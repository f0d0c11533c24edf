"""U-Net training CLI.

Counterpart of icsg3d_tpu/apps/train_unet.py (reference train_unet.py;
defaults: batch 10, lr 3e-6, 50 epochs), with every flag of the JAX CLI
plus the port's ``--device`` (default cuda; raises without CUDA).  On the
card the U-Net computes in bfloat16 over float32 parameters; on the CPU in
float32.

- Class weights: inverse frequency over the non-rotated training rows, the
  background class zeroed (train_unet.py:114-119), recorded in
  ``<ckpt>/class_weights.json``; ``--resume`` warns when they drifted.
- ``<ckpt>/best.npz`` is what ``generate --unet-ckpt <ckpt>`` and
  ``train_vae --unet-ckpt <ckpt>`` read; ``--resume`` reads ``latest.npz``.
- ``--layout`` is accepted and changes nothing (the port has one layout).
- ``--epoch-scan`` (with ``--resident``) runs each epoch as one program on
  the card: the epoch's permutation is uploaded once, every train and
  eval step is a replay of a CUDA graph captured after one eager warm-up
  step, and the metrics are fetched once (train/graphs.py); the batches
  and updates are ``--resident``'s, so ``--resume`` may switch between
  the two.  On the CPU the same steps run eagerly.  Under
  torchrun over NCCL (one process per card) each rank uploads its block
  of every step's global batch and replays the step with its
  all-reduces (BatchNorm's moments, the gradient, the metrics) inside
  the graph; the values are the per-step loop's.  It prints why it is
  not captured, and runs ``--resident``'s loop, in two cases: a gloo
  group on the card (``--dist-backend gloo``: gloo moves CUDA tensors
  through host memory) and a ``--spatial`` mesh on several cards.
- Plots: the best-val plots go to ``<ckpt>/plots`` (at most one refresh
  per ``--plot-every`` epochs) and the loss curves to ``<ckpt>/loss.png``
  where matplotlib imports; elsewhere the run prints ``plots skipped:
  matplotlib is not installed`` once and trains as before.
- ``--spatial S`` > 1 shards every 3x3x3 conv in depth over a (data, S)
  mesh of the ``--device`` list (the JAX CLI's ``--layout ndcs --spatial
  S``): ``--device cuda`` is every visible card, ``--device
  cuda:0,cuda:0`` a 1x2 mesh on one card, ``--device cpu,cpu`` one on the
  CPU.  The model, BatchNorm and the losses stay on the first device.
- Data parallelism across processes (the JAX CLI's data mesh axis): under
  ``python -m torch.distributed.run --nproc-per-node N`` each process
  trains on its block of rows of every global batch on its own card
  (``--device cuda`` is ``cuda:$LOCAL_RANK``), with global BatchNorm
  moments, gradients and metrics; ``--batch-size`` must divide by N times
  the mesh's data rows.  ``--dist-backend gloo --device cuda:0`` puts
  several ranks on one card.  Rank 0 writes the checkpoints,
  class_weights.json, history and plots.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from icsg3d_torch.apps import common
from icsg3d_torch.config import UNetConfig
from icsg3d_torch.data.class_weights import inverse_frequency_weights
from icsg3d_torch.data.splits import data_split
from icsg3d_torch.data.store import BatchIterator, GridDataset
from icsg3d_torch.parallel import distributed
from icsg3d_torch.train.checkpoints import CheckpointManager
from icsg3d_torch.train.unet import create_unet_state, prepare_unet_batch, train_unet


def main(argv=None):
    p = argparse.ArgumentParser(description="Train the 3D U-Net segmenter")
    p.add_argument("--data", required=True)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--lr", type=float, default=3e-6)
    p.add_argument("--d", type=int, default=None,
                   help="grid resolution; default: read from the dataset")
    p.add_argument("--num-classes", type=int, default=95)
    p.add_argument("--nrot", type=int, default=10)
    p.add_argument("--split-frac", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--layout", default="ndhwc", choices=["ndhwc", "ndcs"],
                   help="accepted for flag parity with icsg3d_tpu; the port "
                        "has one layout (NDHWC) and ignores it")
    p.add_argument("--spatial", type=int, default=1,
                   help="spatial mesh axis size: shards grid depth over this "
                        "many mesh cells of the --device list (halo-exchanged "
                        "depth-VALID conv kernels)")
    p.add_argument("--no-class-weights", action="store_true")
    p.add_argument("--ship-dtype", default="float16",
                   choices=("float32", "float16"),
                   help="host->device dtype of density grids (cast to "
                        "float32 on the device)")
    p.add_argument("--epoch-scan", action="store_true",
                   help="run each resident epoch as replays of a captured "
                        "train and eval step on the card: one permutation "
                        "upload and one metrics fetch per epoch (under torchrun "
                        "over NCCL too, each rank on its rows), the batches "
                        "of --resident (requires --resident)")
    p.add_argument("--resident", action="store_true",
                   help="keep the whole train/val split on the device and "
                        "gather batches by index (requires --nrot 0)")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="save the latest checkpoint every N epochs (best is "
                        "always saved)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --ckpt")
    p.add_argument("--plot-every", type=int, default=10,
                   help="min epochs between best-val plot refreshes")
    p.add_argument("--ckpt", default="checkpoints/unet")
    common.add_device_flag(p)
    common.add_dist_flag(p)
    args = p.parse_args(argv)
    group = common.init_distributed(args)
    device, mesh = common.spatial_mesh(args, p)
    if args.epoch_scan and not args.resident:
        p.error("--epoch-scan requires --resident")
    # non-rotated datasets rebuild the coordinate channels on the device;
    # rotated grids must ship their permuted coordinates
    device_coords = args.nrot == 0
    if args.resident and not device_coords:
        p.error("--resident requires --nrot 0: rotated samples carry "
                "axis-permuted coordinate channels that cannot rebuild "
                "on the device")

    ds = GridDataset(args.data)
    args.d = common.resolve_grid_d(args.d, ds)
    train_ids, val_ids = data_split(
        ds.ids, n=args.samples, frac=args.split_frac, n_rot=args.nrot
    )
    cfg = UNetConfig(num_classes=args.num_classes, layout=args.layout,
                     dtype=common.compute_dtype(device))
    state = create_unet_state(cfg, args.lr, args.seed, device, spatial_mesh=mesh,
                              group=group)
    model = state.model
    resuming = bool(args.resume and common.weights_path(args.ckpt, "latest"))
    if resuming:
        CheckpointManager(args.ckpt, group=group).restore(state, "latest")
        print(f"resumed from {args.ckpt}/latest at step {state.step}")
        # epochs actually in this checkpoint: finish_history truncates any prior
        # history beyond it
        args._resumed_epochs = state.step // max(
            1, len(train_ids) // args.batch_size
        )

    # inverse-frequency weights over the training split's non-rotated rows,
    # background zeroed (train_unet.py:114-119)
    if args.no_class_weights:
        class_weights, n_weight_rows = None, 0
    else:
        rows = ds.rows([i for i in train_ids if "_rot_" not in i])
        species = np.asarray(ds.arrays["species"][rows])
        class_weights = inverse_frequency_weights(species, args.num_classes)
        class_weights[0] = 0.0
        n_weight_rows = len(rows)

    # the weighted loss value scales with these weights (they depend on the
    # data build): record them beside the checkpoint, and warn on --resume
    # when a rebuilt dataset changed them
    cw_path = os.path.join(args.ckpt, "class_weights.json")
    cw_list = None if class_weights is None else [float(w) for w in class_weights]
    if resuming and os.path.exists(cw_path):
        with open(cw_path) as f:
            prev = json.load(f).get("class_weights")
        if prev is not None and cw_list is not None and not np.allclose(
            prev, cw_list, rtol=1e-6
        ):
            rel = float(np.max(np.abs(np.array(prev) - np.array(cw_list))
                               / np.maximum(np.abs(np.array(prev)), 1e-12)))
            print(
                f"WARNING: class weights recomputed from {args.data} differ "
                f"from the vector this checkpoint was trained with (max rel "
                f"diff {rel:.3g}) — weighted losses will NOT be comparable "
                f"to earlier epochs; compare the 'ce' (unweighted) metric "
                f"instead"
            )
    if distributed.process_index() == 0:
        os.makedirs(args.ckpt, exist_ok=True)
        with open(cw_path, "w") as f:
            json.dump({"class_weights": cw_list, "num_classes": args.num_classes,
                       "data": args.data, "n_weight_samples": n_weight_rows}, f)

    fields = (("density", "lattice", "species") if device_coords
              else ("density", "coords", "species"))
    plots = common.plot_dir(args)
    run = dict(epochs=args.epochs, class_weights=class_weights,
               checkpoint_dir=args.ckpt, latest_every=args.ckpt_every,
               plot_dir=plots, plot_min_interval=args.plot_every)
    if args.resident:
        def split_host(ids):
            rows = np.array([ds.index[i] for i in ids])
            raw = {k: np.asarray(ds.arrays[k][rows]) for k in fields}
            return prepare_unet_batch(raw, args.num_classes, device_coords=True,
                                      ship_dtype=args.ship_dtype)

        state, history = train_unet(
            model, state, None, None,
            resident_data=(split_host(train_ids), split_host(val_ids)),
            epoch_scan=args.epoch_scan, batch_size=args.batch_size,
            shuffle_seed=args.seed + state.step, **run,
        )
        common.finish_history(args, history, plots=plots is not None)
        return history

    def batches(ids, shuffle, seed):
        # ONE iterator shared across epochs: its rng advances on every
        # __iter__, so each epoch sees a fresh permutation
        it = BatchIterator(ds, ids, args.batch_size, fields=fields,
                           shuffle=shuffle, seed=seed)

        def gen():
            for b in it:
                yield prepare_unet_batch(b, args.num_classes,
                                         device_coords=device_coords,
                                         ship_dtype=args.ship_dtype)

        return gen

    state, history = train_unet(
        model, state,
        # fold resume progress into the shuffle seed: --resume runs would
        # otherwise replay the same permutation sequence
        batches(train_ids, True, args.seed + state.step),
        batches(val_ids, False, 0),
        **run,
    )
    common.finish_history(args, history, plots=plots is not None)
    return history


if __name__ == "__main__":
    try:
        main()
    finally:
        distributed.shutdown()
