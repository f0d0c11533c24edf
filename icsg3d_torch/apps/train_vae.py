"""Conditional DFC-VAE training CLI.

Counterpart of icsg3d_tpu/apps/train_vae.py (reference train_vae.py;
defaults: batch 20, lr 5e-4, 250 epochs, alpha=0.5, beta=3e-4), with every
flag of the JAX CLI plus the port's ``--device`` (default cuda; raises
without CUDA).  On the card the models compute in bfloat16 over float32
parameters; on the CPU in float32.

- ``--unet-ckpt`` and ``--resume`` read the port's checkpoints
  (train/checkpoints.py: ``<dir>/best.npz``, ``<dir>/latest.npz``) or an
  ``.npz`` exported from a Flax checkpoint; an Orbax directory raises.
- ``--layout`` is accepted and changes nothing (the port has one layout).
  ``--epoch-scan`` runs the resident per-step loop.
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
  several ranks on one card.  Rank 0 writes the checkpoints, history and
  plots.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from icsg3d_torch.apps import common
from icsg3d_torch.config import GridSpec, UNetConfig, VAEConfig
from icsg3d_torch.data.binning import bin_and_encode
from icsg3d_torch.data.splits import data_split
from icsg3d_torch.data.store import BatchIterator, GridDataset
from icsg3d_torch.parallel import distributed
from icsg3d_torch.train.checkpoints import CheckpointManager
from icsg3d_torch.train.vae import (
    create_vae_state,
    prepare_vae_batch,
    train_vae,
    true_feature_cache_bytes,
)

# The JAX CLI's gate on the true-feature cache (apps/train_vae.py:196).
CACHE_GATE_BYTES = 12e9


def main(argv=None):
    p = argparse.ArgumentParser(description="Train the conditional DFC-VAE")
    p.add_argument("--data", required=True)
    p.add_argument("--unet-ckpt", default=None,
                   help="U-Net weights for the DFC loss: a checkpoint dir of "
                        "the port's trainer (best.npz) or an exported .npz")
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--epochs", type=int, default=250)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--d", type=int, default=None,
                   help="grid resolution; default: read from the dataset")
    p.add_argument("--latent", type=int, default=256)
    p.add_argument("--filters", default="16,32,64,128",
                   help="comma-separated encoder filter blocks; the grid is "
                        "halved once per block, so small --d needs fewer")
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--beta", type=float, default=3e-4)
    p.add_argument("--kld-floor", type=float, default=0.0,
                   help="free-bits floor on the per-sample KLD (nats): the "
                        "beta term becomes beta*max(kld, floor); 0 = off")
    p.add_argument("--cond-bins", type=int, default=10)
    p.add_argument("--cond-repeat", type=int, default=1,
                   help="channel-repeat of the condition block; 4 "
                        "reproduces the reference's Keras tile quirk")
    p.add_argument("--num-classes", type=int, default=95)
    p.add_argument("--nrot", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--layout", default="ndhwc", choices=["ndhwc", "ndcs"],
                   help="accepted for flag parity with icsg3d_tpu; the port "
                        "has one layout (NDHWC) and ignores it")
    p.add_argument("--spatial", type=int, default=1,
                   help="spatial mesh axis size: shards grid depth over this "
                        "many mesh cells of the --device list (halo-exchanged "
                        "depth-VALID conv kernels)")
    p.add_argument("--remat-perceptual", action="store_true",
                   help="recompute the recon-side frozen perceptual forward "
                        "in the backward pass (torch.utils.checkpoint)")
    p.add_argument("--ship-dtype", default="float16",
                   choices=("float32", "float16"),
                   help="host->device dtype of density grids (cast to "
                        "float32 on the device)")
    p.add_argument("--cache-true-features", action="store_true",
                   help="compute the frozen U-Net's true-grid perceptual taps "
                        "once for the resident train split and gather them "
                        "per batch (requires --resident and --unet-ckpt)")
    p.add_argument("--epoch-scan", action="store_true",
                   help="accepted for flag parity (requires --resident): runs "
                        "the resident per-step loop, with identical batches "
                        "and noise")
    p.add_argument("--resident", action="store_true",
                   help="keep the whole train/val split on the device and "
                        "gather batches by index (requires --nrot 0)")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="save the latest checkpoint every N epochs (best is "
                        "always saved)")
    p.add_argument("--plot-every", type=int, default=1,
                   help="min epochs between best-val plot refreshes")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --ckpt")
    p.add_argument("--ckpt", default="checkpoints/vae")
    p.add_argument("--verbose-startup", action="store_true",
                   help="print per-stage startup timings")
    common.add_device_flag(p)
    common.add_dist_flag(p)
    args = p.parse_args(argv)
    group = common.init_distributed(args)
    device, mesh = common.spatial_mesh(args, p)

    t_start = time.time()

    def mark(stage):
        if args.verbose_startup:
            print(f"[startup] {stage}: {time.time() - t_start:.1f}s", flush=True)

    ds = GridDataset(args.data)
    args.d = common.resolve_grid_d(args.d, ds)
    train_ids, val_ids = data_split(ds.ids, n=args.samples, n_rot=args.nrot)
    mark("dataset open + split")

    dtype = common.compute_dtype(device)
    grid = GridSpec(d=args.d)
    cfg = VAEConfig(
        grid=grid, latent_dim=args.latent, alpha=args.alpha, beta=args.beta,
        kld_floor=args.kld_floor,
        cond_bins=args.cond_bins, filters=common.parse_filters(args.filters),
        layout=args.layout, cond_repeat=args.cond_repeat, dtype=dtype,
    )
    state = create_vae_state(cfg, args.lr, args.seed, device, spatial_mesh=mesh,
                             group=group)
    model = state.model
    mark("vae init")
    # an Orbax `latest` directory raises with the export hint
    if args.resume and common.weights_path(args.ckpt, "latest"):
        CheckpointManager(args.ckpt, group=group).restore(state, "latest")
        print(f"resumed from {args.ckpt}/latest at step {state.step}")
        # epochs actually in this checkpoint: finish_history truncates any prior
        # history beyond it
        args._resumed_epochs = state.step // max(
            1, len(train_ids) // args.batch_size
        )
        mark("resume restore")

    unet = None
    if args.unet_ckpt:
        unet = common.load_unet(
            UNetConfig(num_classes=args.num_classes, dtype=dtype),
            args.unet_ckpt, grid_d=args.d, device=device,
        )
        mark("unet load")

    _, conds, _ = bin_and_encode(np.asarray(ds.arrays["target"]), args.cond_bins)

    device_coords = args.nrot == 0
    fields = ("density", "lattice") if device_coords else ("density", "coords")

    if args.cache_true_features and not (args.resident and unet):
        p.error("--cache-true-features requires --resident and --unet-ckpt")
    if args.epoch_scan and not args.resident:
        p.error("--epoch-scan requires --resident")

    plots = common.plot_dir(args)
    run = dict(
        epochs=args.epochs, unet=unet, checkpoint_dir=args.ckpt,
        seed=args.seed, plot_dir=plots, latest_every=args.ckpt_every,
        plot_min_interval=args.plot_every, remat_perceptual=args.remat_perceptual,
    )
    if args.resident:
        if not device_coords:
            p.error("--resident requires --nrot 0: rotated samples carry "
                    "axis-permuted coordinate channels that cannot rebuild "
                    "on the device")
        if args.cache_true_features:
            need = true_feature_cache_bytes(model, unet, len(train_ids))
            if need > CACHE_GATE_BYTES:
                p.error(
                    f"--cache-true-features needs {need / 1e9:.1f} GB of "
                    f"device memory for {len(train_ids)} samples (gate: "
                    f"{CACHE_GATE_BYTES / 1e9:g} GB) - use a smaller "
                    "--samples or drop the flag"
                )

        def split_host(ids):
            rows = np.array([ds.index[i] for i in ids])
            return {
                "density": np.asarray(ds.arrays["density"][rows]).astype(
                    np.dtype(args.ship_dtype)
                ),
                "abc": np.asarray(ds.arrays["lattice"][rows, :3], dtype=np.float32),
                "cond": conds[rows].astype(np.float32),
            }

        t_host, v_host = split_host(train_ids), split_host(val_ids)
        mark("resident split materialize")
        state, history = train_vae(
            model, state, None, None, resident_data=(t_host, v_host),
            epoch_scan=args.epoch_scan, batch_size=args.batch_size,
            shuffle_seed=args.seed + state.step,
            cache_true_features=args.cache_true_features, **run,
        )
        common.finish_history(args, history, plots=plots is not None)
        return history

    def batches(ids, shuffle, seed):
        rows_cond = np.stack([conds[ds.index[i]] for i in ids])
        # ONE iterator shared across epochs: its rng advances on every
        # __iter__, so each epoch sees a fresh permutation
        it = BatchIterator(
            ds, ids, args.batch_size, fields=fields,
            shuffle=shuffle, seed=seed, extra={"cond": rows_cond},
        )

        def gen():
            for b in it:
                yield prepare_vae_batch(
                    b, b["cond"], device_coords=device_coords,
                    ship_dtype=args.ship_dtype,
                )

        return gen

    state, history = train_vae(
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
