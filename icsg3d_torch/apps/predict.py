"""Standalone CGCNN property prediction for CIF files.

Counterpart of icsg3d_tpu/apps/predict.py (reference cgcnn/utils.py
evaluate_cgcnn_from_cif), with every flag of the JAX CLI plus the port's
``--device`` (default cuda; raises without CUDA).  Each property's weights
load once (``--ckpt name=weights,...``: an .npz or a directory of the
port's trainer), and prediction is batched over all inputs in input order.

The CGCNN's masked batch-norm takes its statistics from the LIVE batch at
inference (there are no moving averages), so a structure's predicted value
depends slightly on which other structures share its batch: keep the
batch composition fixed when comparing runs.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

from icsg3d_torch.apps import common
from icsg3d_torch.config import CGCNNConfig
from icsg3d_torch.crystal.cif import read_cif
from icsg3d_torch.data.graphs import featurize_batch


def predict_from_cifs(
    cif_paths: List[str],
    property_checkpoints: Dict[str, str],
    cfg: CGCNNConfig = CGCNNConfig(),
    batch_size: int = 32,
    device="cuda",
) -> List[Dict]:
    """Per-CIF dict of predicted properties (an ``error`` instead for
    unparseable files and structures outside 1..max_atoms sites)."""
    spec = cfg.graph_spec()
    records: List[Dict] = []
    structures, rows = [], []
    for path in cif_paths:
        rec = {"cif": path}
        try:
            s = read_cif(path)
            if not (0 < len(s) <= spec.max_atoms):
                raise ValueError(f"{len(s)} sites (max {spec.max_atoms})")
            rec["formula"] = s.reduced_formula
            rows.append(len(records))
            structures.append(s)
        except Exception as e:  # noqa: BLE001 — one bad CIF is one record
            rec["error"] = str(e)
        records.append(rec)

    if structures:
        graphs = featurize_batch(structures, spec)
        for prop, ckpt in property_checkpoints.items():
            model = common.load_cgcnn(cfg, ckpt, device=device)
            preds = common.cgcnn_predict(model, graphs, batch_size)
            for row, p in zip(rows, preds):
                records[row].setdefault("properties", {})[prop] = float(p)
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description="CGCNN property prediction")
    p.add_argument("cifs", nargs="+", help=".cif files or directories")
    p.add_argument(
        "--ckpt", required=True,
        help="property weights: name=weights[,name=weights...], each an .npz "
             f"(from {common.EXPORT_SCRIPT}) or a train_cgcnn --ckpt directory",
    )
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--output", default=None)
    common.add_device_flag(p)
    args = p.parse_args(argv)
    device = common.resolve_device(args.device)

    paths: List[str] = []
    for c in args.cifs:
        if os.path.isdir(c):
            paths.extend(
                os.path.join(c, f) for f in sorted(os.listdir(c))
                if f.endswith(".cif")
            )
        else:
            paths.append(c)

    prop_ckpts = common.parse_property_checkpoints(args.ckpt, p, "--ckpt")
    records = predict_from_cifs(paths, prop_ckpts, batch_size=args.batch_size,
                                device=device)
    out = json.dumps(records, indent=1)
    print(out)
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
    return records


if __name__ == "__main__":
    main()
