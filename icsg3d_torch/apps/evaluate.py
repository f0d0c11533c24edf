"""Reconstruction-quality evaluation over the validation split.

Counterpart of icsg3d_tpu/apps/evaluate.py (reference eval.py), run as
``python -m icsg3d_torch.apps.evaluate``, with every flag of the JAX CLI
plus ``--device`` (default cuda; raises without CUDA) and ``--seed``.  For
each validation sample: the VAE reconstruction with reparameterization
noise, the lattice from its coordinate channels and the U-Net
segmentation, on the device (bfloat16 on the card, float32 on the CPU);
then on the host the watershed atom extraction and the comparison with the
true atoms: the EMD between predicted and true atom positions, |delta atom
count| and the per-axis lattice-parameter errors.

The noise comes from ``torch.Generator().manual_seed(seed)``, one (batch,
latent) draw per batch on the CPU, so the card and the CPU get the same
numbers; JAX draws it from ``jax.random.split`` per batch, which
``evaluate_reconstructions(noise=...)`` can take instead.  ``--plots DIR``
writes the lattice-parameter parity scatters and error histograms and the
EMD histogram (``save_eval_plots``); it needs matplotlib, and where that
does not import it exits with a usage error before any model loads.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from icsg3d_torch.apps import common
from icsg3d_torch.apps.generate import merge_close_atoms, segment_grids
from icsg3d_torch.config import GridSpec, PipelineConfig, UNetConfig
from icsg3d_torch.data.binning import bin_and_encode
from icsg3d_torch.data.splits import data_split
from icsg3d_torch.data.store import BatchIterator, GridDataset
from icsg3d_torch.ops.emd import earth_movers_distance
from icsg3d_torch.ops.segmentation import watershed_clustering


def _sanitize_nonfinite(obj):
    """Replace non-finite floats with None so json.dump emits valid JSON."""
    if isinstance(obj, float):
        return obj if np.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _sanitize_nonfinite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_sanitize_nonfinite(v) for v in obj]
    return obj


def evaluate_reconstructions(
    vae,
    unet,
    dataset: GridDataset,
    ids: List[str],
    conds: np.ndarray,
    batch_size: int = 10,
    pipe: PipelineConfig = PipelineConfig(),
    seed: int = 0,
    merge_closer_than: float = 0.0,
    noise: Optional[Sequence[np.ndarray]] = None,
) -> Dict:
    """Per-sample EMD / atom-count / lattice errors, means over the split.

    conds: per-id one-hot conditions aligned with ``ids``.  ``noise``, if
    given, holds each batch's (batch_size, latent) reparameterization
    noise in order; else it is drawn from a generator seeded with ``seed``.
    """
    grid = pipe.grid
    device = next(vae.parameters()).device
    latent = vae.cfg.latent_dim
    gen = torch.Generator().manual_seed(seed)

    # True atoms come from the stored site arrays when the dataset carries
    # them (the reference re-parsed each CIF, eval.py:182-190); otherwise
    # from a watershed of the clean ground-truth grids.
    has_sites = "sites" in dataset.arrays and "site_z" in dataset.arrays
    fields = ["density", "coords", "species", "lattice"]
    if has_sites:
        fields += ["sites", "site_z"]
    # Pad the id list to a batch multiple (repeating the tail id) so EVERY
    # sample is evaluated: BatchIterator drops remainders.
    n_real = len(ids)
    pad = (-n_real) % batch_size
    ids = list(ids) + [ids[-1]] * pad
    conds = np.concatenate([conds, np.repeat(conds[-1:], pad, axis=0)])
    it = BatchIterator(
        dataset, ids, batch_size, fields=tuple(fields),
        extra={"cond": conds},
    )
    emds, datoms, dlattice = [], [], []
    l_true_all, l_pred_all = [], []
    n_skipped, first_error = 0, None
    g = 0  # global sample index over the padded id list
    for b, batch in enumerate(it):
        x = common.grid_input(batch["density"], batch["coords"])
        eps = (torch.tensor(np.asarray(noise[b]), dtype=torch.float32)
               if noise is not None
               else torch.randn((batch_size, latent), generator=gen))
        with torch.inference_mode():
            recon, _, _, _ = vae(torch.from_numpy(x).to(device),
                                 torch.from_numpy(batch["cond"]).to(device),
                                 eps.to(device))
            recon, l_pred, dv_pred, labels, binary = (
                t.cpu().numpy() for t in segment_grids(unet, pipe, recon))

        for i in range(len(recon)):
            g += 1
            if g > n_real:
                break  # padded tail repeats of the last sample
            true_l = batch["lattice"][i][:3]
            S_true = batch["species"][i].astype(int)
            try:
                atoms_p, mu_p = watershed_clustering(
                    recon[i, ..., 0],
                    np.where(binary[i] > 0, labels[i], 0),
                    binary[i],
                    max_iters=pipe.watershed_max_iters,
                    wmin=pipe.watershed_wmin,
                    min_convexity=pipe.watershed_min_convexity,
                )
                cart_p = (
                    np.asarray(mu_p) * dv_pred[i]
                    - grid.eps_frac * l_pred[i] + dv_pred[i] / 2.0
                ) if len(mu_p) else np.zeros((0, 3))
                if merge_closer_than > 0 and len(cart_p):
                    atoms_p, cart_p = merge_close_atoms(
                        np.asarray(atoms_p), cart_p, merge_closer_than
                    )

                if has_sites:
                    zt = batch["site_z"][i]
                    cart_t = batch["sites"][i][zt > 0]
                    n_true = int((zt > 0).sum())
                else:
                    atoms_t, mu_t = watershed_clustering(
                        batch["density"][i], S_true, (S_true > 0).astype(int),
                        max_iters=pipe.watershed_max_iters,
                        wmin=pipe.watershed_wmin,
                        min_convexity=pipe.watershed_min_convexity,
                    )
                    dv_true = np.asarray(true_l, np.float64) * (
                        1.0 + 2.0 * grid.eps_frac
                    ) / grid.d
                    cart_t = (
                        np.asarray(mu_t) * dv_true
                        - grid.eps_frac * np.asarray(true_l) + dv_true / 2.0
                    ) if len(mu_t) else np.zeros((0, 3))
                    n_true = len(atoms_t)
                emds.append(earth_movers_distance(cart_p, cart_t))
                datoms.append(abs(len(atoms_p) - n_true))
            except Exception as e:  # noqa: BLE001 — robustness parity (eval.py:193-199)
                n_skipped += 1
                if first_error is None:
                    first_error = repr(e)[:300]
                continue
            dlattice.append(np.abs(l_pred[i] - true_l))
            l_true_all.append(np.asarray(true_l, np.float64))
            l_pred_all.append(np.asarray(l_pred[i], np.float64))

    dlattice = np.asarray(dlattice) if dlattice else np.zeros((0, 3))
    # an EMD is NaN when exactly one of the atom sets is empty (the
    # reference's 0/0); count those separately instead of poisoning the mean
    finite_emds = [e for e in emds if np.isfinite(e)]
    return {
        "mean_emd": (
            float(np.mean(finite_emds)) if finite_emds else float("nan")
        ),
        "n_emd_undefined": len(emds) - len(finite_emds),
        "mean_datoms": float(np.mean(datoms)) if datoms else float("nan"),
        "mean_dlattice": (
            dlattice.mean(axis=0).tolist() if len(dlattice) else [float("nan")] * 3
        ),
        "n_evaluated": len(emds),
        "n_skipped": n_skipped,
        "first_error": first_error,
        "emds": [float(e) for e in emds],
        "datoms": [int(a) for a in datoms],
        "lattice_true": np.asarray(l_true_all).reshape(-1, 3).tolist(),
        "lattice_pred": np.asarray(l_pred_all).reshape(-1, 3).tolist(),
    }


def save_eval_plots(results: Dict, output_dir: str) -> None:
    """Lattice-parameter error histograms and parity scatters plus an EMD
    histogram (icsg3d_tpu/apps/evaluate.py:190-230; reference
    eval.py:230-322)."""
    from icsg3d_torch import viz
    from icsg3d_torch.viz import plt

    os.makedirs(output_dir, exist_ok=True)
    lt = np.asarray(results.get("lattice_true", []), np.float64).reshape(-1, 3)
    lp = np.asarray(results.get("lattice_pred", []), np.float64).reshape(-1, 3)
    for ax_i, name in enumerate("abc"):
        if len(lt):
            viz.plot_parity(
                lt[:, ax_i], lp[:, ax_i],
                os.path.join(output_dir, f"parity_{name}.png"), label=name,
            )
            fig, ax = plt.subplots()
            ax.hist(np.abs(lp[:, ax_i] - lt[:, ax_i]), bins=30)
            ax.set_xlabel(f"|error {name}| (Angstrom)")
            ax.set_ylabel("count")
            fig.savefig(os.path.join(output_dir, f"err_hist_{name}.png"), dpi=120)
            plt.close(fig)
    emds = np.asarray(results.get("emds", []), np.float64)
    if len(emds):
        fig, ax = plt.subplots()
        ax.hist(emds[np.isfinite(emds)], bins=30)
        ax.set_xlabel("EMD (Angstrom)")
        ax.set_ylabel("count")
        fig.savefig(os.path.join(output_dir, "emd_hist.png"), dpi=120)
        plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate VAE reconstructions")
    p.add_argument("--data", required=True)
    p.add_argument("--vae-ckpt", required=True,
                   help=f".npz of VAE weights (from {common.EXPORT_SCRIPT}) or a "
                        "train_vae --ckpt directory")
    p.add_argument("--unet-ckpt", required=True,
                   help=f".npz of U-Net weights (from {common.EXPORT_SCRIPT}) or a "
                        "train_unet --ckpt directory")
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--d", type=int, default=None,
                   help="grid resolution; default: read from the dataset")
    p.add_argument("--num-classes", type=int, default=95)
    p.add_argument("--cond-bins", type=int, default=10)
    common.add_vae_flags(p)
    common.add_device_flag(p)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--split-frac", type=float, default=0.8,
                   help="MUST match the training run's --split-frac, or "
                        "the 'validation' set overlaps the train split")
    p.add_argument("--output", default=None)
    p.add_argument("--plots", default=None,
                   help="directory for error histograms and parity plots "
                        "(needs matplotlib)")
    p.add_argument("--binary-threshold", type=float, default=0.8,
                   help="U-Net occupancy (sigmoid) threshold for the "
                        "extraction mask (generate.py:224 default 0.8)")
    p.add_argument("--merge-closer-than", type=float, default=0.0,
                   help="merge extracted atoms closer than this many "
                        "Angstrom before scoring (0 = off; see "
                        "apps/generate.py merge_close_atoms)")
    p.add_argument("--eval-split", default="val", choices=("val", "train"),
                   help="which split to reconstruct+evaluate.  'train' is "
                        "a DIAGNOSTIC (never a headline number): comparing "
                        "train-split EMD against val-split EMD separates a "
                        "generalization gap from model/post-processing "
                        "saturation")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the reparameterization noise")
    args = p.parse_args(argv)
    if args.plots:
        common.require_plots(p, "--plots")
    device = common.resolve_device(args.device)

    ds = GridDataset(args.data)
    args.d = common.resolve_grid_d(args.d, ds)
    grid = GridSpec(d=args.d)
    pipe = PipelineConfig(grid=grid, cond_bins=args.cond_bins,
                          binary_threshold=args.binary_threshold)
    _, conds, _ = bin_and_encode(np.asarray(ds.arrays["target"]), args.cond_bins)
    # validation split without rotations (eval.py:130-142)
    train_ids, val_ids = data_split(
        ds.ids, n=args.samples, frac=args.split_frac, n_rot=0
    )
    if args.eval_split == "train":
        val_ids = train_ids
    conds_val = conds[[ds.index[sid] for sid in val_ids]]

    dtype = common.compute_dtype(device)
    vae = common.load_vae(
        common.vae_config_from_args(args, grid, dtype), args.vae_ckpt,
        device=device,
    )
    unet = common.load_unet(
        UNetConfig(num_classes=args.num_classes, layout=args.layout,
                   dtype=dtype),
        args.unet_ckpt, grid_d=args.d, device=device,
    )
    results = evaluate_reconstructions(
        vae, unet, ds, val_ids, conds_val,
        batch_size=args.batch_size, pipe=pipe, seed=args.seed,
        merge_closer_than=args.merge_closer_than,
    )
    summary = {
        k: v for k, v in results.items()
        if k in ("mean_emd", "mean_datoms", "mean_dlattice", "n_evaluated",
                 "n_emd_undefined", "n_skipped", "first_error")
    }
    # sanitize stdout too: NaN means (zero evaluated samples) would print
    # non-standard JSON tokens that break `... | jq` consumers
    print(json.dumps(_sanitize_nonfinite(summary), indent=1))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(_sanitize_nonfinite(results), f, indent=1)
    if args.plots:
        save_eval_plots(results, args.plots)
    return results


if __name__ == "__main__":
    main()
