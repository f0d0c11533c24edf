"""End-to-end generation: sample latents around a base compound, decode,
segment, extract atoms, emit structures/CIFs.

Counterpart of icsg3d_tpu/apps/generate.py, run as
``python -m icsg3d_torch.apps.generate``.  It takes every flag of the JAX
CLI (``--layout`` is accepted and ignored) plus ``--device`` (default
``cuda``; raises when CUDA is unavailable, never falls back to the CPU).
The models compute in bfloat16 on the card and in float32 on the CPU.
Weights come from ``.npz`` files exported with tools/export_flax_npz.py.

- ``--fused``: decode -> U-Net segment -> device atom extraction
  (ops/extract.py, method "binary") -> Cartesian coordinates, per batch on
  the device.
- default: decode + segment on the device, then the host watershed
  (ops/segmentation.py) per sample.

Latents come from ``np.random.default_rng(seed)`` exactly as in the JAX
CLI, so both draw the same samples; every batch runs at the full
``batch_size`` shape and the tail is sliced afterwards.  CGCNN property
prediction is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from icsg3d_torch.apps import common
from icsg3d_torch.config import GridSpec, PipelineConfig, UNetConfig
from icsg3d_torch.crystal.cif import write_cif
from icsg3d_torch.crystal.structure import Structure
from icsg3d_torch.ops.extract import extract_atoms
from icsg3d_torch.ops.grid import to_lattice_params, to_voxel_params, voxel_to_cartesian
from icsg3d_torch.ops.segmentation import watershed_clustering


def _decode_segment(vae, unet, pipe: PipelineConfig, z, cond):
    M = vae.decode(z, cond)
    lattice = to_lattice_params(M[..., 1:], pipe.grid)
    dv = to_voxel_params(lattice, pipe.grid)
    soft, sig = unet(M)
    # argmax over logits == argmax over softmax
    labels = torch.argmax(soft, dim=-1)
    binary = (torch.sigmoid(sig[..., 0]) > pipe.binary_threshold).to(torch.int32)
    return M, lattice, dv, labels, binary


def decode_and_segment_fn(vae, unet, pipe: PipelineConfig):
    """decode latents -> segment -> lattice params, on the models' device."""

    @torch.inference_mode()
    def fn(z, cond):
        return _decode_segment(vae, unet, pipe, z, cond)

    return fn


def fused_generate_fn(vae, unet, pipe: PipelineConfig, max_atoms: int = 64):
    """The whole generation step on the device: decode -> U-Net segment ->
    binary atom extraction -> voxel->Cartesian coordinates."""
    grid = pipe.grid

    @torch.inference_mode()
    def fn(z, cond):
        M, lattice, dv, labels, binary = _decode_segment(vae, unet, pipe, z, cond)
        # method "binary", one erosion level, majority vote over all
        # classes: the settings of the JAX fused path
        atoms, mu, valid = extract_atoms(
            torch.where(binary > 0, labels, 0), binary,
            max_atoms=max_atoms, erosion_levels=1,
            vote_classes=unet.cfg.num_classes,
        )
        cart = voxel_to_cartesian(mu, lattice[:, None, :], dv[:, None, :], grid)
        return lattice, atoms, cart, valid

    return fn


def merge_close_atoms(atoms: np.ndarray, cart: np.ndarray, cutoff: float):
    """Merge atoms closer than ``cutoff`` Angstrom into their centroid.

    Single-linkage clustering; the merged atom takes the cluster's
    most-common species and mean position.  cutoff <= 0 is the identity.
    """
    n = len(atoms)
    if cutoff <= 0 or n <= 1:
        return np.asarray(atoms), np.asarray(cart)
    cart = np.asarray(cart, np.float64)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    d2 = ((cart[:, None, :] - cart[None, :, :]) ** 2).sum(-1)
    for i in range(n):
        for j in range(i + 1, n):
            if d2[i, j] < cutoff * cutoff:
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[rj] = ri
    clusters: Dict[int, List[int]] = {}
    for i in range(n):
        clusters.setdefault(find(i), []).append(i)
    za, ca = [], []
    for members in clusters.values():
        zs = [int(atoms[m]) for m in members]
        za.append(max(set(zs), key=zs.count))
        ca.append(cart[members].mean(axis=0))
    return np.asarray(za), np.asarray(ca)


def _structure_fields(lattice, atoms_raw, cart_raw, cutoff, pipe):
    """Post-extraction fields for ONE merge cutoff: {structure, atoms,
    coords, formula, valid}."""
    za, ca = merge_close_atoms(
        np.asarray(atoms_raw).astype(int), cart_raw, cutoff
    )
    structure = Structure.from_cartesian(
        lattice, za, ca, angles=pipe.cell_angles,
    )
    return {
        "structure": structure,
        "atoms": np.asarray(za, int).tolist(),
        "coords": np.asarray(ca).tolist(),
        "formula": structure.reduced_formula,
        "valid": bool(structure.is_valid()),
    }


def _apply_cutoffs(rec, lattice, atoms_raw, cart_raw, pipe,
                   merge_closer_than, merge_sweep):
    """Mutate ``rec`` with the primary cutoff's fields, plus a
    ``by_cutoff`` dict when ``merge_sweep`` lists extra cutoffs."""
    rec.update(
        _structure_fields(lattice, atoms_raw, cart_raw, merge_closer_than, pipe)
    )
    if merge_sweep:
        rec["by_cutoff"] = {}
        for c in merge_sweep:
            if c == merge_closer_than:
                entry = {k: rec[k] for k in
                         ("structure", "atoms", "coords", "formula", "valid")}
            else:
                entry = _structure_fields(lattice, atoms_raw, cart_raw, c, pipe)
            rec["by_cutoff"][f"{c:g}"] = entry


def _encode_base(vae, base_density, base_coords, base_cond, device):
    """Posterior mean of the base compound (float32 numpy) and its
    (1, cond_bins) condition."""
    x_base = common.grid_input(base_density[None], base_coords[None])
    cond = np.asarray(base_cond, np.float32)[None]
    with torch.inference_mode():
        z_mu, _ = vae.encode(
            torch.from_numpy(x_base).to(device), torch.from_numpy(cond).to(device)
        )
    return z_mu.float().cpu().numpy()[0], cond


def _latent_batches(z_mu, cond, n_samples, batch_size, var, seed, device):
    """Yield (n, z, cond_b): full-shape batches from default_rng(seed),
    exactly as the JAX CLI draws them; n is the batch's live rows."""
    rng = np.random.default_rng(seed)
    n_batches = max(1, int(np.ceil(n_samples / batch_size)))
    for b in range(n_batches):
        n = min(batch_size, n_samples - b * batch_size)
        if n <= 0:
            break
        z = rng.normal(z_mu, np.sqrt(var), size=(batch_size, len(z_mu))).astype(
            np.float32
        )
        cond_b = np.repeat(cond, batch_size, axis=0)
        yield n, torch.from_numpy(z).to(device), torch.from_numpy(cond_b).to(device)


def generate_structures_fused(
    vae,
    unet,
    base_density: np.ndarray,
    base_coords: np.ndarray,
    base_cond: np.ndarray,
    n_samples: int = 100,
    batch_size: int = 20,
    var: float = 0.5,
    pipe: PipelineConfig = PipelineConfig(),
    seed: int = 0,
    max_atoms: int = 64,
    merge_closer_than: float = 0.0,
    merge_sweep: Optional[Sequence[float]] = None,
) -> List[Dict]:
    """Fast-path generation: the fused device step per batch, then host
    wrapping of the extracted atoms into Structures."""
    device = next(vae.parameters()).device
    step = fused_generate_fn(vae, unet, pipe, max_atoms)
    z_mu, cond = _encode_base(vae, base_density, base_coords, base_cond, device)
    records: List[Dict] = []
    for n, z, cond_b in _latent_batches(
        z_mu, cond, n_samples, batch_size, var, seed, device
    ):
        lattice, atoms, cart, valid = (t.cpu().numpy()[:n] for t in step(z, cond_b))
        for i in range(n):
            rec: Dict = {"lattice": lattice[i].tolist(), "valid": False}
            sel = valid[i]
            try:
                if sel.any():
                    _apply_cutoffs(rec, lattice[i], atoms[i][sel], cart[i][sel],
                                   pipe, merge_closer_than, merge_sweep)
            except Exception as e:  # noqa: BLE001 — a degenerate decode
                # (e.g. ~zero lattice span -> singular cell matrix) costs one
                # sample, not the run (reference generate.py:246-248)
                rec["error"] = repr(e)[:200]
            records.append(rec)
    return records


def generate_structures(
    vae,
    unet,
    base_density: np.ndarray,
    base_coords: np.ndarray,
    base_cond: np.ndarray,
    n_samples: int = 100,
    batch_size: int = 20,
    var: float = 0.5,
    pipe: PipelineConfig = PipelineConfig(),
    seed: int = 0,
    keep_grids: bool = False,
    merge_closer_than: float = 0.0,
    merge_sweep: Optional[Sequence[float]] = None,
) -> List[Dict]:
    """Sample around the base compound's posterior mean, decode and segment
    on the device, and split atoms with the host watershed.

    Returns one record per sample: {structure, lattice, atoms, coords,
    valid, formula}.  keep_grids=True carries the decoded density
    (float16) and segmented species (uint8) grids on each record.
    """
    grid = pipe.grid
    device = next(vae.parameters()).device
    step = decode_and_segment_fn(vae, unet, pipe)
    z_mu, cond = _encode_base(vae, base_density, base_coords, base_cond, device)
    records: List[Dict] = []
    for n, z, cond_b in _latent_batches(
        z_mu, cond, n_samples, batch_size, var, seed, device
    ):
        M, lattice, dv, labels, binary = (
            t.cpu().numpy()[:n] for t in step(z, cond_b)
        )
        for i in range(n):
            rec: Dict = {"lattice": lattice[i].tolist(), "valid": False}
            if keep_grids:
                rec["density_grid"] = M[i, ..., 0].astype(np.float16)
                sg = np.where(binary[i] > 0, labels[i], 0)
                rec["species_grid"] = sg.astype(
                    np.uint8 if sg.max(initial=0) < 256 else np.uint16
                )
            try:
                atoms, mu = watershed_clustering(
                    M[i, ..., 0],
                    np.where(binary[i] > 0, labels[i], 0),
                    binary[i],
                    max_iters=pipe.watershed_max_iters,
                    wmin=pipe.watershed_wmin,
                    min_convexity=pipe.watershed_min_convexity,
                )
                if len(atoms) == 0:
                    records.append(rec)
                    continue
                cart = (
                    np.asarray(mu) * dv[i]
                    - grid.eps_frac * lattice[i]
                    + dv[i] / 2.0
                )
                _apply_cutoffs(rec, lattice[i], atoms, cart, pipe,
                               merge_closer_than, merge_sweep)
            except Exception as e:  # watershed robustness (generate.py:246-248)
                rec["error"] = str(e)
            records.append(rec)
    return records


def annotate_records(
    records: Sequence[Dict], base_target: float, target: str
) -> None:
    """Per-sample composition stats, mutated in place (generate.py:288-296):
    average Pauling electronegativity, charge balance, and percent
    deviation of a predicted target property from the base compound's."""
    from icsg3d_torch.crystal.elements import (
        average_electronegativity,
        is_charge_balanced,
    )

    for r in records:
        if r.get("atoms"):
            r["electronegativity"] = average_electronegativity(r["atoms"])
            r["charge_balanced"] = int(is_charge_balanced(r["atoms"]))
        for entry in (r.get("by_cutoff") or {}).values():
            if entry.get("atoms"):
                entry["charge_balanced"] = int(is_charge_balanced(entry["atoms"]))
        pred_target = (r.get("properties") or {}).get(target)
        if pred_target is not None and base_target != 0:
            r["target_diff_pct"] = abs((pred_target - base_target) / base_target)


def _write_results_csv(rows: Sequence[Dict], path: str) -> None:
    """Flat CSV of the per-sample records (reference results.csv)."""
    import csv

    flat = []
    for r in rows:
        fr = {k: v for k, v in r.items() if k != "properties"}
        fr.update(r.get("properties") or {})
        for k, v in fr.items():
            if isinstance(v, (list, tuple, dict)):
                fr[k] = json.dumps(v)
        flat.append(fr)
    cols: List[str] = []
    for fr in flat:
        for k in fr:
            if k not in cols:
                cols.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(flat)


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate crystal structures")
    p.add_argument("--data", required=True, help="packed GridDataset dir")
    p.add_argument("--base", required=True, help="base sample id")
    p.add_argument("--vae-ckpt", required=True,
                   help=f".npz of VAE weights (from {common.EXPORT_SCRIPT})")
    p.add_argument("--unet-ckpt", required=True,
                   help=f".npz of U-Net weights (from {common.EXPORT_SCRIPT})")
    p.add_argument("--cgcnn-ckpt", default=None,
                   help="dir per property: name=dir,... (not ported yet)")
    p.add_argument("--nsamples", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--var", type=float, default=0.5)
    p.add_argument("--d", type=int, default=None,
                   help="grid resolution; default: read from the dataset")
    p.add_argument("--num-classes", type=int, default=95)
    p.add_argument("--target", default="formation_energy_per_atom")
    p.add_argument("--cond-bins", type=int, default=10)
    common.add_vae_flags(p)
    common.add_device_flag(p)
    p.add_argument("--binary-threshold", type=float, default=0.8,
                   help="U-Net occupancy (sigmoid) threshold for the "
                        "extraction mask (generate.py:224 default 0.8)")
    p.add_argument("--merge-closer-than", default="0",
                   help="merge extracted atoms closer than this many "
                        "Angstrom into their centroid (0 = off); a comma "
                        "list (e.g. 0,0.7) sweeps every cutoff in one run")
    p.add_argument("--output", default="output/generated")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--fused", action="store_true",
        help="extract atoms on the device (binary method) instead of the "
             "per-sample host watershed",
    )
    p.add_argument(
        "--save-grids", action="store_true",
        help="save each sample's decoded density and segmented species "
             "grids as .npy (host path only)",
    )
    args = p.parse_args(argv)
    if args.save_grids and args.fused:
        p.error("--save-grids requires the host path (drop --fused): the "
                "fused step keeps grids on the device")
    if args.cgcnn_ckpt:
        raise NotImplementedError(
            "--cgcnn-ckpt: CGCNN is not ported yet; run property prediction "
            "with python -m icsg3d_tpu.apps.generate"
        )
    try:
        merge_cutoffs = [
            float(x) for x in str(args.merge_closer_than).split(",") if x != ""
        ]
    except ValueError:
        p.error(f"--merge-closer-than must be a float or comma list of "
                f"floats, got {args.merge_closer_than!r}")
    if not merge_cutoffs:
        merge_cutoffs = [0.0]
    device = common.resolve_device(args.device)

    from icsg3d_torch.data.binning import bin_and_encode
    from icsg3d_torch.data.store import GridDataset

    ds = GridDataset(args.data)
    args.d = common.resolve_grid_d(args.d, ds)
    grid = GridSpec(d=args.d)
    pipe = PipelineConfig(grid=grid, cond_bins=args.cond_bins,
                          binary_threshold=args.binary_threshold)
    _, conds, _ = bin_and_encode(np.asarray(ds.arrays["target"]), args.cond_bins)

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

    if args.base not in ds.index:
        p.error(f"--base {args.base!r} is not an id in {args.data} "
                f"(e.g. {ds.ids[0]!r})")
    row = ds.index[args.base]
    gen_fn = generate_structures_fused if args.fused else generate_structures
    records = gen_fn(
        vae, unet,
        np.asarray(ds.arrays["density"][row]),
        np.asarray(ds.arrays["coords"][row]),
        conds[row],
        n_samples=args.nsamples,
        batch_size=args.batch_size,
        var=args.var,
        pipe=pipe,
        seed=args.seed,
        merge_closer_than=merge_cutoffs[0],
        merge_sweep=merge_cutoffs if len(merge_cutoffs) > 1 else None,
        **({"keep_grids": True} if args.save_grids else {}),
    )

    annotate_records(records, float(ds.arrays["target"][row]), args.target)

    os.makedirs(os.path.join(args.output, "cifs"), exist_ok=True)
    if args.save_grids:
        os.makedirs(os.path.join(args.output, "grids"), exist_ok=True)
    n_valid = n_balanced = 0
    sweep_counts = {f"{c:g}": {"valid": 0, "balanced": 0}
                    for c in merge_cutoffs[1:]}
    for key in sweep_counts:
        os.makedirs(os.path.join(args.output, "cifs", f"m{key}"), exist_ok=True)
    rows = []
    for i, r in enumerate(records):
        if r.get("valid"):
            n_valid += 1
            path = os.path.join(args.output, "cifs", f"gen-{i}.cif")
            write_cif(r["structure"], path)
            r["cif"] = path
        for key, entry in (r.get("by_cutoff") or {}).items():
            if key not in sweep_counts:
                continue  # primary cutoff already counted above
            if entry.get("valid"):
                sweep_counts[key]["valid"] += 1
                path = os.path.join(args.output, "cifs", f"m{key}", f"gen-{i}.cif")
                write_cif(entry["structure"], path)
                entry["cif"] = path
            sweep_counts[key]["balanced"] += entry.get("charge_balanced", 0)
        if args.save_grids and "density_grid" in r:
            np.save(os.path.join(args.output, "grids", f"gen-{i}_density.npy"),
                    r["density_grid"])
            np.save(os.path.join(args.output, "grids", f"gen-{i}_species.npy"),
                    r["species_grid"])
        n_balanced += r.get("charge_balanced", 0)
        row = {
            k: v for k, v in r.items()
            if k not in ("structure", "density_grid", "species_grid")
        }
        if "by_cutoff" in row:
            row["by_cutoff"] = {
                key: {k: v for k, v in entry.items() if k != "structure"}
                for key, entry in row["by_cutoff"].items()
            }
        rows.append(row)
    with open(os.path.join(args.output, "results.json"), "w") as f:
        json.dump(rows, f, indent=1)
    _write_results_csv(rows, os.path.join(args.output, "results.csv"))
    print(
        f"generated {len(records)} samples, {n_valid} valid structures "
        f"({n_balanced} charge-balanced) -> {args.output}"
    )
    for key, c in sweep_counts.items():
        print(
            f"  merge-closer-than {key}: {c['valid']} valid structures "
            f"({c['balanced']} charge-balanced)"
        )
    return records


if __name__ == "__main__":
    main()
