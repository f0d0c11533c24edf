"""Pipeline inspector: per-sample truth-vs-reconstruction panels.

Counterpart of icsg3d_tpu/apps/view.py (reference view_results.py), run as
``python -m icsg3d_torch.apps.view``, with every flag of the JAX CLI plus
``--device`` (default cuda; raises without CUDA) and ``--seed``.  For
validation samples: the VAE reconstruction with reparameterization noise
and its U-Net segmentation on the device (bfloat16 on the card, float32 on
the CPU), the per-sample MSE and the F1 of the segmentation against the
true species grid, and comparison panels saved as PNGs.

The records are always computed and printed; the panels are drawn where
matplotlib imports (elsewhere the run prints ``plots skipped: matplotlib
is not installed``).  ``--voxels`` asks for the 3D renders and exits with
a usage error where matplotlib does not import, before any model loads.

The noise comes from ``torch.Generator().manual_seed(seed)``, one (1,
latent) draw per sample on the CPU, so the card and the CPU get the same
numbers; JAX draws one ``jax.random.split`` per sample, which
``view_samples(noise=...)`` can take instead.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from icsg3d_torch import viz
from icsg3d_torch.apps import common
from icsg3d_torch.config import GridSpec, PipelineConfig, UNetConfig
from icsg3d_torch.data.binning import bin_and_encode
from icsg3d_torch.data.splits import data_split
from icsg3d_torch.data.store import GridDataset
from icsg3d_torch.ops.metrics import f1_score_from_labels
from icsg3d_torch.ops.segmentation import watershed_clustering


def view_samples(
    vae,
    unet,
    dataset: GridDataset,
    sample_ids,
    conds: np.ndarray,
    output: str,
    pipe: PipelineConfig,
    voxels: bool = False,
    seed: int = 0,
    noise: Optional[Sequence[np.ndarray]] = None,
) -> list[dict]:
    """Render truth-vs-reconstruction panels for each sample id.

    Returns one record per sample: {"id", "mse", "f1"}; saves
    <id>_recon / _true_species / _pred_species / _regions (and with
    ``voxels`` _voxels) PNGs under ``output`` where matplotlib imports.
    ``conds`` holds the dataset's one-hot conditions by row.  ``noise``, if
    given, holds each sample's (1, latent) reparameterization noise in
    order; else it is drawn from a generator seeded with ``seed``.
    """
    if voxels and not viz.available():
        raise ImportError(f"voxels=True draws plots: {viz.PLOTS_SKIPPED}")
    plots = common.plots_available()
    device = next(vae.parameters()).device
    gen = torch.Generator().manual_seed(seed)

    os.makedirs(output, exist_ok=True)
    records = []
    for i, sid in enumerate(sample_ids):
        row = dataset.index[sid]
        x = common.grid_input(
            np.asarray(dataset.arrays["density"][row])[None],
            np.asarray(dataset.arrays["coords"][row])[None],
        )
        cond = conds[row][None].astype(np.float32)
        eps = (torch.tensor(np.asarray(noise[i]), dtype=torch.float32)
               if noise is not None
               else torch.randn((1, vae.cfg.latent_dim), generator=gen))
        with torch.inference_mode():
            recon, _, _, _ = vae(torch.from_numpy(x).to(device),
                                 torch.from_numpy(cond).to(device), eps.to(device))
            # segment_grids' labels and occupancy, from the one U-Net
            # call that also gives the softmax the F1 needs
            soft, sig = unet(recon)
            labels_t = torch.argmax(soft, dim=-1)
            binary_t = (torch.sigmoid(sig[..., 0]) > pipe.binary_threshold).to(torch.int32)
            probs = torch.softmax(soft, dim=-1)
            recon = recon.float().cpu().numpy()
            labels, binary = labels_t.cpu().numpy()[0], binary_t.cpu().numpy()[0]
            mse = float(np.mean((x - recon) ** 2))

            # Per-sample F1 of the reconstruction's segmentation against
            # the true species grid (view_results.py:137), clipped to the
            # model's class range like prepare_unet_batch.
            num_classes = probs.shape[-1]
            true_species = np.minimum(
                np.asarray(dataset.arrays["species"][row]).astype(np.int32),
                num_classes - 1,
            )
            f1 = float(f1_score_from_labels(
                torch.from_numpy(true_species)[None].to(device), probs))

        if plots:
            viz.plot_real_vs_pred(
                x[0], recon[0], os.path.join(output, f"{sid}_recon.png")
            )
            viz.plot_points_3d(
                true_species, os.path.join(output, f"{sid}_true_species.png")
            )
            viz.plot_points_3d(
                np.where(binary > 0, labels, 0),
                os.path.join(output, f"{sid}_pred_species.png"),
            )
            if voxels:
                viz.plot_voxels_duo(
                    x[0, ..., 0], recon[0, ..., 0],
                    os.path.join(output, f"{sid}_voxels.png"),
                )
            try:
                _, _, R = watershed_clustering(
                    recon[0, ..., 0], np.where(binary > 0, labels, 0), binary,
                    return_regions=True,
                )
                viz.plot_points_3d(R, os.path.join(output, f"{sid}_regions.png"))
            except Exception:
                pass
        print(f"{sid}: mse {mse:.5f} f1 {f1:.4f}")
        records.append({"id": sid, "mse": mse, "f1": f1})
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description="Inspect pipeline results")
    p.add_argument("--data", required=True)
    p.add_argument("--vae-ckpt", required=True,
                   help=f".npz of VAE weights (from {common.EXPORT_SCRIPT}) or a "
                        "train_vae --ckpt directory")
    p.add_argument("--unet-ckpt", required=True,
                   help=f".npz of U-Net weights (from {common.EXPORT_SCRIPT}) or a "
                        "train_unet --ckpt directory")
    p.add_argument("--n", type=int, default=5)
    p.add_argument("--split-frac", type=float, default=0.8,
                   help="MUST match the training run's --split-frac, or "
                        "the 'validation' samples overlap the train split")
    p.add_argument("--d", type=int, default=None,
                   help="grid resolution; default: read from the dataset")
    p.add_argument("--num-classes", type=int, default=95)
    p.add_argument("--cond-bins", type=int, default=10)
    common.add_vae_flags(p)
    common.add_device_flag(p)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the reparameterization noise")
    p.add_argument("--output", default="output/view")
    p.add_argument(
        "--voxels", action="store_true",
        help="also save exploded 3D voxel renders (slow; view_results.py "
             "panels; needs matplotlib)",
    )
    args = p.parse_args(argv)
    if args.voxels:
        common.require_plots(p, "--voxels")
    device = common.resolve_device(args.device)

    ds = GridDataset(args.data)
    args.d = common.resolve_grid_d(args.d, ds)
    grid = GridSpec(d=args.d)
    pipe = PipelineConfig(grid=grid)
    _, conds, _ = bin_and_encode(np.asarray(ds.arrays["target"]), args.cond_bins)
    _, val_ids = data_split(ds.ids, frac=args.split_frac, n_rot=0)

    dtype = common.compute_dtype(device)
    vae = common.load_vae(common.vae_config_from_args(args, grid, dtype),
                          args.vae_ckpt, device=device)
    unet = common.load_unet(
        UNetConfig(num_classes=args.num_classes, layout=args.layout, dtype=dtype),
        args.unet_ckpt, grid_d=args.d, device=device,
    )
    return view_samples(
        vae, unet, ds, val_ids[: args.n], conds, args.output, pipe,
        voxels=args.voxels, seed=args.seed,
    )


if __name__ == "__main__":
    main()
