"""CGCNN property-regression training CLI.

Counterpart of icsg3d_tpu/apps/train_cgcnn.py (reference train_cgcnn.py;
defaults: batch 32, lr 1e-3, 60 epochs, MSE loss, best-val-MAE
checkpointing), with every flag of the JAX CLI plus the port's
``--device`` (default cuda; raises without CUDA).  The model computes in
float32 on every device.  Graphs are featurized once up front on the host
from CIFs (``--cifs`` + ``--targets-csv``) or synthetic structures
(``--synthetic N``), then batches stream from the packed arrays: a
persistent batch rng seeded with ``seed + 1 + step`` (so a ``--resume``
does not replay the permutations), remainders dropped.

``<ckpt>/best.npz`` is what ``predict --ckpt`` and ``generate
--cgcnn-ckpt`` read; ``--resume`` reads ``latest.npz``.

Data parallelism across processes (the JAX CLI's data mesh axis): under
``python -m torch.distributed.run --nproc-per-node N`` each process trains
on its block of rows of every batch on its own card (``--device cuda`` is
``cuda:$LOCAL_RANK``), with global masked-BN statistics, gradients and
metrics.  ``--batch-size`` must divide by N (the data axis: one device
per process), with the JAX CLI's message.  ``--dist-backend gloo --device
cuda:0`` puts several ranks on one card.  Rank 0 writes the checkpoints
and the history.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from icsg3d_torch.apps import common
from icsg3d_torch.config import CGCNNConfig
from icsg3d_torch.data.graphs import featurize_batch
from icsg3d_torch.parallel import distributed
from icsg3d_torch.train.checkpoints import CheckpointManager
from icsg3d_torch.train.cgcnn import create_cgcnn_state, train_cgcnn


def graph_arrays_from_cifs(cif_dir, targets_csv, target_column, spec):
    """Graphs and targets of the CIFs in ``cif_dir`` that ``targets_csv``
    gives a ``target_column`` value for (keyed by task_id, id or
    material_id); unreadable CIFs and structures outside 1..max_atoms are
    skipped."""
    from icsg3d_torch.crystal.cif import read_cif

    target_map = {}
    with open(targets_csv) as f:
        for row in csv.DictReader(f):
            key = row.get("task_id") or row.get("id") or row.get("material_id")
            if key and row.get(target_column) not in (None, ""):
                target_map[key] = float(row[target_column])

    structures, targets = [], []
    for fname in sorted(os.listdir(cif_dir)):
        if not fname.endswith(".cif"):
            continue
        sid = fname[: -len(".cif")]
        if sid not in target_map:
            continue
        try:
            s = read_cif(os.path.join(cif_dir, fname))
        except Exception:  # noqa: BLE001 — a bad CIF costs one sample
            continue
        if 0 < len(s) <= spec.max_atoms:
            structures.append(s)
            targets.append(target_map[sid])
    graphs = featurize_batch(structures, spec)
    graphs["target"] = np.asarray(targets, np.float32)
    return graphs


def graph_arrays_synthetic(n, seed, spec, prop="formation_energy"):
    """Graphs of ``n`` synthetic perovskite/rocksalt structures with a
    deterministic pseudo property as the target."""
    from icsg3d_torch.data import synthetic

    target_fn = {
        "formation_energy": synthetic.synthetic_target,
        "band_gap": synthetic.synthetic_band_gap,
    }[prop]
    structures = synthetic.random_structures(
        n, seed=seed, kinds=("perovskite", "rocksalt")
    )
    graphs = featurize_batch(structures, spec)
    graphs["target"] = np.asarray(
        [target_fn(s) for s in structures], np.float32
    )
    return graphs


def main(argv=None):
    p = argparse.ArgumentParser(description="Train the CGCNN regressor")
    p.add_argument("--cifs", default=None)
    p.add_argument("--targets-csv", default=None)
    p.add_argument("--target", default="formation_energy_per_atom")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument(
        "--synthetic-property", default="formation_energy",
        choices=("formation_energy", "band_gap"),
        help="which deterministic pseudo property the synthetic graphs "
             "regress — train one checkpoint per property for generate's "
             "multi-property --cgcnn-ckpt",
    )
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--split-frac", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="save the latest checkpoint every N epochs (best is "
                        "always saved)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --ckpt")
    p.add_argument("--ckpt", default="checkpoints/cgcnn")
    common.add_device_flag(p)
    common.add_dist_flag(p)
    args = p.parse_args(argv)
    group = common.init_distributed(args)
    device = common.resolve_device(args.device)

    cfg = CGCNNConfig()
    spec = cfg.graph_spec()
    if args.synthetic:
        graphs = graph_arrays_synthetic(
            args.synthetic, args.seed, spec, prop=args.synthetic_property
        )
    elif args.cifs and args.targets_csv:
        graphs = graph_arrays_from_cifs(
            args.cifs, args.targets_csv, args.target, spec
        )
    else:
        p.error("need --synthetic N or --cifs + --targets-csv")

    n = len(graphs["target"])
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(n)
    cut = int(args.split_frac * n)
    train_idx, val_idx = order[:cut], order[cut:]

    def batches(idx, shuffle=False, seed_offset=0):
        # persistent rng: each epoch (each gen() call) draws a new
        # permutation; seed_offset folds in resume progress so chunked
        # --resume runs do not replay the same permutation sequence
        brng = np.random.default_rng(args.seed + 1 + seed_offset)

        def gen():
            order = brng.permutation(len(idx)) if shuffle else np.arange(len(idx))
            for s in range(0, len(idx) - args.batch_size + 1, args.batch_size):
                sel = idx[order[s: s + args.batch_size]]
                yield {k: v[sel] for k, v in graphs.items()}

        return gen

    common.check_data_axis(args, p, 1)
    state = create_cgcnn_state(cfg, args.lr, args.seed, device, group=group)
    if args.resume and common.weights_path(args.ckpt, "latest"):
        CheckpointManager(args.ckpt, group=group).restore(state, "latest")
        print(f"resumed from {args.ckpt}/latest at step {state.step}")
        # epochs actually in this checkpoint: finish_history truncates any
        # prior history beyond it
        args._resumed_epochs = state.step // max(
            1, len(train_idx) // args.batch_size
        )
    state, history = train_cgcnn(
        state.model, state,
        batches(train_idx, shuffle=True, seed_offset=state.step),
        batches(val_idx),
        epochs=args.epochs, checkpoint_dir=args.ckpt,
        latest_every=args.ckpt_every,
    )
    common.finish_history(args, history, metric="mae")
    return history


if __name__ == "__main__":
    try:
        main()
    finally:
        distributed.shutdown()
