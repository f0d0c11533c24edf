"""Dataset builder: CIF directory (or synthetic) -> packed GridDataset.

Counterpart of icsg3d_tpu/apps/voxelize.py (reference create_matrices.py),
with every flag of the JAX CLI plus the port's ``--device`` (default cuda;
raises without CUDA):

- CIF parsing stays on the host (crystal/cif.py, no pymatgen), each file
  under a 120 s parse budget (utils/timeout.py);
- multi-process sharding strides the files by the ``torch.distributed``
  rank and world size when a process group is initialised (else 0 and 1),
  the functional replacement for the MPI rank stride
  (create_matrices.py:107), with the filesystem as the sink;
- voxelization runs on the card: one launch of the voxelizer kernel per
  chunk of structures (data/voxel_build.py);
- rotation augmentations are exact 90-degree grid rotations.

Each process writes ``part-<k>/``; single-process runs write the dataset
directly.  ``merge_parts`` combines the parts.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np

from icsg3d_torch.apps import common
from icsg3d_torch.config import GridSpec, VoxelizerConfig
from icsg3d_torch.crystal.cif import read_cif
from icsg3d_torch.data.store import FIELDS, GridDataset
from icsg3d_torch.data.voxel_build import voxelize_structures

__all__ = ["voxelize_structures", "build_from_cifs", "merge_parts", "main"]


def _process_stride():
    """(rank, world size) of an initialised torch.distributed group, else
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def build_from_cifs(
    cif_dir: str,
    out_dir: str,
    targets_csv: Optional[str] = None,
    target_column: str = "formation_energy_per_atom",
    cfg: VoxelizerConfig = VoxelizerConfig(),
    n_rot: int = 0,
    seed: int = 0,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    device="cuda",
) -> GridDataset:
    """Parse + voxelize every .cif in a directory into a packed dataset.

    Multi-process: each process takes files where i % process_count ==
    process_index and writes ``part-<index>/`` under out_dir.
    """
    rank, world = _process_stride()
    pidx = process_index if process_index is not None else rank
    pcount = process_count if process_count is not None else world

    target_map: Dict[str, float] = {}
    if targets_csv:
        import csv

        n_bad = 0
        with open(targets_csv) as f:
            for row in csv.DictReader(f):
                key = row.get("task_id") or row.get("id") or row.get("material_id")
                if key is None or row.get(target_column) in (None, ""):
                    continue
                try:
                    target_map[key] = float(row[target_column])
                except ValueError:  # "N/A"/"null" cells must not kill the build
                    n_bad += 1
        if n_bad:
            print(f"targets csv: skipped {n_bad} non-numeric "
                  f"{target_column!r} cells", flush=True)
        if not target_map:
            raise ValueError(
                f"no usable targets in {targets_csv} (id column must be "
                f"task_id/id/material_id; target column {target_column!r})"
            )

    from icsg3d_torch.utils.timeout import TimeoutError_, run_with_timeout

    files = sorted(f for f in os.listdir(cif_dir) if f.endswith(".cif"))
    structures, ids, targets = [], [], []
    for i, fname in enumerate(files):
        if i % pcount != pidx:
            continue  # create_matrices.py:107 rank stride
        sid = fname[: -len(".cif")]
        try:
            # 120 s parse budget like the reference's func_timeout guard
            # around create_crystal (utils.py:147)
            s = run_with_timeout(read_cif, 120.0, os.path.join(cif_dir, fname))
        except (Exception, TimeoutError_):
            continue  # skip malformed files (create_matrices.py:211-214)
        structures.append(s)
        ids.append(sid)
        targets.append(target_map.get(sid, np.nan) if target_map else 0.0)

    if target_map:
        # a CIF missing from the CSV must not train with a fake 0.0 label
        missing = {i for i, t in enumerate(targets) if np.isnan(t)}
        if missing:
            print(f"targets csv: dropping {len(missing)} structures with "
                  "no target row", flush=True)
            keep = [i for i in range(len(ids)) if i not in missing]
            structures = [structures[i] for i in keep]
            ids = [ids[i] for i in keep]
            targets = [targets[i] for i in keep]

    out_ids, arrays = voxelize_structures(
        structures, ids, targets, cfg=cfg, n_rot=n_rot, seed=seed, device=device
    )
    dest = out_dir if pcount == 1 else os.path.join(out_dir, f"part-{pidx}")
    return GridDataset.write(dest, out_ids, arrays)


def merge_parts(out_dir: str) -> GridDataset:
    """Combine part-<k>/ datasets written by a multi-process run."""
    parts = sorted(d for d in os.listdir(out_dir) if d.startswith("part-"))
    if not parts:
        if os.path.exists(os.path.join(out_dir, "ids.json")):
            return GridDataset(out_dir)  # single-process build, no parts
        raise FileNotFoundError(
            f"no part-* datasets (and no merged dataset) under {out_dir}"
        )
    dsets = [GridDataset(os.path.join(out_dir, p), mmap=False) for p in parts]
    ids: List[str] = []
    arrays: Dict[str, np.ndarray] = {}
    for field in FIELDS:
        have = [field in d.arrays for d in dsets]
        if all(have):
            arrays[field] = np.concatenate([d.arrays[field] for d in dsets])
        elif any(have):
            print(f"merge_parts: dropping field {field!r} — present in "
                  f"{sum(have)}/{len(dsets)} parts", flush=True)
    for d in dsets:
        ids.extend(d.ids)
    return GridDataset.write(out_dir, ids, arrays)


def main(argv=None):
    p = argparse.ArgumentParser(description="Build a voxel-grid dataset")
    p.add_argument("--cifs", default=None, help="directory of .cif files")
    p.add_argument("--targets-csv", default=None)
    p.add_argument("--target", default="formation_energy_per_atom")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic structures instead of CIFs")
    p.add_argument("--kinds", default="perovskite",
                   help="synthetic kinds, comma-separated")
    p.add_argument("--out", required=True)
    p.add_argument("--d", type=int, default=32)
    p.add_argument("--nrot", type=int, default=10)
    p.add_argument("--sigma-frac", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    common.add_device_flag(p)
    args = p.parse_args(argv)
    device = common.resolve_device(args.device)

    cfg = VoxelizerConfig(grid=GridSpec(d=args.d), sigma_frac=args.sigma_frac)
    if args.synthetic:
        from icsg3d_torch.data.synthetic import build_dataset

        ds = build_dataset(
            args.out, n=args.synthetic, seed=args.seed, cfg=cfg,
            n_rot=args.nrot, kinds=tuple(args.kinds.split(",")), device=device,
        )
    elif args.cifs:
        ds = build_from_cifs(
            args.cifs, args.out, targets_csv=args.targets_csv,
            target_column=args.target, cfg=cfg, n_rot=args.nrot,
            seed=args.seed, device=device,
        )
    else:
        p.error("one of --cifs or --synthetic is required")
    print(f"wrote {len(ds)} samples -> {args.out}")
    return ds


if __name__ == "__main__":
    main()
