"""Latent-space interpolation between two compounds.

Counterpart of icsg3d_tpu/apps/interpolate.py (reference interpolate.py),
run as ``python -m icsg3d_torch.apps.interpolate``, with every flag of the
JAX CLI plus ``--device`` (default cuda; raises without CUDA).  Encode two
samples (a pair, or per condition bin with ``--sweep-conds``), interpolate
linearly in z, decode ``--ninterps`` steps in one batch, and save each
strip (the raw endpoint grids around the decoded steps) as ``.npy``, the
sweep's pairs as ``sweep.json``, and slice plots.  The models compute in
bfloat16 on the card and in float32 on the CPU; the numpy arithmetic
between encode and decode is the JAX CLI's.

The ``.npy`` strips and ``sweep.json`` are always written; the PNGs where
matplotlib imports (elsewhere the run prints ``plots skipped: matplotlib
is not installed``).  ``--voxels`` asks for the 3D renders and exits with
a usage error where matplotlib does not import, before any model loads.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from icsg3d_torch import viz
from icsg3d_torch.apps import common
from icsg3d_torch.config import GridSpec
from icsg3d_torch.data.binning import bin_and_encode
from icsg3d_torch.data.store import GridDataset


def _encode(vae, x: np.ndarray, cond: np.ndarray) -> np.ndarray:
    """Posterior means (float32 numpy) of grids x under conditions cond."""
    device = next(vae.parameters()).device
    with torch.inference_mode():
        z, _ = vae.encode(torch.from_numpy(np.ascontiguousarray(x)).to(device),
                          torch.from_numpy(np.ascontiguousarray(cond)).to(device))
    return z.float().cpu().numpy()


def _decode(vae, z: np.ndarray, cond: np.ndarray) -> np.ndarray:
    """Decoded grids (float32 numpy) of latents z under conditions cond."""
    device = next(vae.parameters()).device
    with torch.inference_mode():
        out = vae.decode(torch.from_numpy(np.ascontiguousarray(z)).to(device),
                         torch.from_numpy(np.ascontiguousarray(cond)).to(device))
    return out.float().cpu().numpy()


def interpolate_latents(
    vae,
    x_a: np.ndarray,
    cond_a: np.ndarray,
    x_b: np.ndarray,
    cond_b: np.ndarray,
    n_interps: int = 10,
) -> np.ndarray:
    """Decode a linear path between the posterior means of two samples,
    the condition interpolated along with z.

    Returns (n_interps + 2, d, d, d, C): the raw endpoint grids a/b frame
    the decoded steps, matching the reference's [a, interps..., b] strip
    (interpolate.py:49,60-62) and the sweep mode.
    """
    z_a = _encode(vae, x_a[None], cond_a[None].astype(np.float32))[0]
    z_b = _encode(vae, x_b[None], cond_b[None].astype(np.float32))[0]

    ts = np.linspace(0.0, 1.0, n_interps)[:, None].astype(np.float32)
    zs = (1.0 - ts) * z_a + ts * z_b
    conds = (1.0 - ts) * cond_a[None] + ts * cond_b[None]
    out = _decode(vae, zs, conds.astype(np.float32))
    return np.concatenate([x_a[None], out, x_b[None]], axis=0)


def interpolate_sweep(
    vae,
    dataset,
    bin_idx: np.ndarray,
    n_bins: int,
    n_interps: int = 10,
    seed: int = 0,
):
    """Per-condition-bin interpolation sweep (interpolate.py:47-64,107-110).

    For each condition bin: pick two samples of that bin with
    ``np.random.default_rng(seed).choice`` (one generator over the bins, as
    the JAX CLI draws), encode both under the bin's fixed one-hot, decode
    ``n_interps`` linear latent steps under the same condition, and
    concatenate the raw endpoint grids a/b onto the strip: one
    (n_interps + 2, d, d, d, C) row per bin.  Bins with fewer than two
    samples are skipped.

    Returns (rows, row_meta): rows is a list of arrays, row_meta a list of
    {"bin", "a", "b"} dicts.
    """
    rng = np.random.default_rng(seed)
    ids = np.asarray(dataset.ids)

    rows, row_meta = [], []
    for b in range(n_bins):
        members = np.flatnonzero(bin_idx == b)
        if len(members) < 2:
            continue
        ia, ib = rng.choice(members, 2, replace=False)
        cond = np.eye(n_bins, dtype=np.float32)[b]
        sel = np.array([ia, ib])
        x = common.grid_input(
            np.asarray(dataset.arrays["density"][sel]),
            np.asarray(dataset.arrays["coords"][sel]),
        )
        z_a, z_b = _encode(vae, x, np.stack([cond, cond]))
        ts = np.linspace(0.0, 1.0, n_interps)[:, None].astype(np.float32)
        zs = (1.0 - ts) * z_a + ts * z_b
        conds = np.repeat(cond[None], n_interps, axis=0)
        mids = _decode(vae, zs, conds)
        rows.append(np.concatenate([x[:1], mids, x[1:]], axis=0))
        row_meta.append({"bin": b, "a": str(ids[ia]), "b": str(ids[ib])})
    return rows, row_meta


def _save_voxel_row(grids, path):
    """Row of exploded 3D voxel renders (interpolate.py:174-202 3D mode)."""
    from icsg3d_torch.viz import plt

    n = len(grids)
    fig = plt.figure(figsize=(2.5 * n, 2.5))
    for i, g in enumerate(grids):
        ax = fig.add_subplot(1, n, i + 1, projection="3d")
        viz.plot_voxels_3d(np.asarray(g), resample_d=12, ax=ax)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def _save_strip(grids, stem: str, plots: bool, voxels: bool) -> None:
    """``<stem>.npy``, and with plots ``<stem>.png`` (and ``<stem>_3d.png``
    with voxels)."""
    np.save(stem + ".npy", grids)
    if plots:
        viz.plot_interpolation(grids, stem + ".png")
        if voxels:
            _save_voxel_row(grids, stem + "_3d.png")


def main(argv=None):
    p = argparse.ArgumentParser(description="Interpolate between compounds")
    p.add_argument("--data", required=True)
    p.add_argument("--vae-ckpt", required=True,
                   help=f".npz of VAE weights (from {common.EXPORT_SCRIPT}) or a "
                        "train_vae --ckpt directory")
    p.add_argument("--a", help="first sample id (pair mode)")
    p.add_argument("--b", help="second sample id (pair mode)")
    p.add_argument(
        "--sweep-conds", action="store_true",
        help="reference parity mode: one interpolation strip per condition "
             "bin, random same-bin pair under the bin's fixed one-hot, raw "
             "endpoints included (interpolate.py:47-64,107-110)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ninterps", type=int, default=10)
    p.add_argument("--d", type=int, default=None,
                   help="grid resolution; default: read from the dataset")
    p.add_argument("--cond-bins", type=int, default=10)
    common.add_vae_flags(p)
    common.add_device_flag(p)
    p.add_argument("--output", default="output/interpolation")
    p.add_argument(
        "--voxels", action="store_true",
        help="also save a row of exploded 3D voxel renders "
             "(interpolate.py:174-202 3D mode; needs matplotlib)",
    )
    args = p.parse_args(argv)
    if args.voxels:
        common.require_plots(p, "--voxels")
    if not args.sweep_conds and (not args.a or not args.b):
        p.error("pair mode needs --a and --b (or use --sweep-conds)")
    device = common.resolve_device(args.device)

    ds = GridDataset(args.data)
    args.d = common.resolve_grid_d(args.d, ds)
    grid = GridSpec(d=args.d)
    bin_idx, conds, _ = bin_and_encode(
        np.asarray(ds.arrays["target"]), args.cond_bins
    )
    vae = common.load_vae(
        common.vae_config_from_args(args, grid, common.compute_dtype(device)),
        args.vae_ckpt, device=device,
    )
    plots = common.plots_available()
    os.makedirs(args.output, exist_ok=True)

    if args.sweep_conds:
        rows, row_meta = interpolate_sweep(
            vae, ds, bin_idx, args.cond_bins, n_interps=args.ninterps,
            seed=args.seed,
        )
        for row, meta in zip(rows, row_meta):
            _save_strip(row, os.path.join(args.output,
                                          f"interpolation_bin{meta['bin']}"),
                        plots, args.voxels)
        with open(os.path.join(args.output, "sweep.json"), "w") as f:
            json.dump(row_meta, f, indent=1)
        print(
            f"wrote {len(rows)} condition-bin strips "
            f"({args.ninterps}+2 steps each) -> {args.output}"
        )
        return rows, row_meta

    ia, ib = ds.index[args.a], ds.index[args.b]
    x_a = common.grid_input(
        np.asarray(ds.arrays["density"][ia])[None],
        np.asarray(ds.arrays["coords"][ia])[None],
    )[0]
    x_b = common.grid_input(
        np.asarray(ds.arrays["density"][ib])[None],
        np.asarray(ds.arrays["coords"][ib])[None],
    )[0]
    grids = interpolate_latents(vae, x_a, conds[ia], x_b, conds[ib], args.ninterps)
    _save_strip(grids, os.path.join(args.output, "interpolation"), plots,
                args.voxels)
    print(f"wrote {args.ninterps}+2 interpolation frames -> {args.output}")
    return grids


if __name__ == "__main__":
    main()
