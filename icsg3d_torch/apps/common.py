"""Shared helpers for the port's CLIs: flags, device choice and model
loading.  Counterpart of icsg3d_tpu/apps/common.py.

Weights come from a flat ``.npz``: one exported from a Flax checkpoint
(tools/export_flax_npz.py), or a checkpoint directory of the port's own
trainer, read through its ``best.npz``.  The port cannot read Orbax
directories.  Without a checkpoint the models start from a seeded fresh
init, with the same warning as the JAX CLIs when a checkpoint directory
holds none.

Data parallelism across processes: launched by ``python -m
torch.distributed.run`` (torchrun), a trainer or the dataset build joins
its process group first (``init_distributed``); ``--device cuda`` is then
this process's card, ``cuda:$LOCAL_RANK``.  Rank 0 alone writes the
history and the plots.
"""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from icsg3d_torch.config import CGCNNConfig, UNetConfig, VAEConfig
from icsg3d_torch.models import CGCNN, ConditionalDFCVAE, UNet3D
from icsg3d_torch.parallel import distributed
from icsg3d_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh
from icsg3d_torch.weights import load_flax_variables, load_npz, model_variables

EXPORT_SCRIPT = "tools/export_flax_npz.py"


def parse_filters(spec: str) -> Tuple[int, ...]:
    """Parse a comma-separated ``--filters`` flag ("16,32,64") to a tuple."""
    try:
        filters = tuple(int(t) for t in spec.split(",") if t.strip())
    except ValueError:
        raise SystemExit(f"--filters must be comma-separated ints, got {spec!r}")
    if not filters or any(f <= 0 for f in filters):
        raise SystemExit(
            f"--filters must name at least one positive block size, got {spec!r}"
        )
    return filters


def resolve_grid_d(arg_d, dataset) -> int:
    """Reconcile a --d flag with the dataset's grid resolution: None adopts
    the dataset's d; a conflicting value is a hard error."""
    ds_d = int(dataset.d)
    if arg_d is None:
        return ds_d
    if int(arg_d) != ds_d:
        raise SystemExit(
            f"--d {arg_d} does not match the dataset's grid resolution "
            f"{ds_d} (from {dataset.path}); drop --d to use the "
            "dataset's value"
        )
    return int(arg_d)


def add_vae_flags(parser) -> None:
    """The VAE-checkpoint geometry flags shared by every consuming CLI."""
    parser.add_argument(
        "--latent", type=int, default=256,
        help="latent dim the VAE checkpoint was trained with",
    )
    parser.add_argument(
        "--filters", default="16,32,64,128",
        help="comma-separated VAE filter blocks of the checkpoint",
    )
    parser.add_argument(
        "--layout", default="ndhwc", choices=["ndhwc", "ndcs"],
        help="accepted for flag parity with icsg3d_tpu; the port has one "
             "layout (NDHWC) and ignores it",
    )
    parser.add_argument(
        "--cond-repeat", type=int, default=1,
        help="channel-repeat of the condition block; 4 reproduces the "
             "reference's Keras tile quirk (44-channel encoder input)",
    )


def add_device_flag(parser) -> None:
    """The port-only ``--device`` flag."""
    parser.add_argument(
        "--device", default="cuda",
        help="torch device; 'cuda' raises when CUDA is unavailable, "
             "'cpu' runs the plain PyTorch versions of the kernels in float32. "
             "The trainers take a comma-separated list: the first is the lead "
             "device (the model and every unsharded op), the list the "
             "--spatial mesh's devices ('cuda' alone: every visible card); "
             "repeat one to put several mesh cells on it (cuda:0,cuda:0). "
             "Under torchrun 'cuda' is this process's card, cuda:$LOCAL_RANK",
    )


def add_dist_flag(parser) -> None:
    """The port-only ``--dist-backend`` flag of the CLIs that torchrun can
    launch."""
    parser.add_argument(
        "--dist-backend", default=None, choices=("nccl", "gloo"),
        help="torch.distributed backend under torchrun (default: nccl on "
             "CUDA, gloo on the CPU); gloo lets several ranks share one card "
             "(--device cuda:0 on every rank), which NCCL refuses",
    )


def resolve_device(name: str) -> torch.device:
    """The torch device for ``name``; never silently falls back to the CPU.
    Under a launcher a bare ``cuda`` is this process's card,
    ``cuda:$LOCAL_RANK``, which must be visible: ranks are never stacked on
    one card unless a card is named."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available here; pass --device cpu "
            "to run the plain PyTorch path on the CPU"
        )
    rank = distributed.local_rank()
    if dev.type == "cuda" and dev.index is None and rank is not None:
        if rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"--device {name} under a launcher is cuda:{rank} (LOCAL_RANK), "
                f"but {torch.cuda.device_count()} card(s) are visible; name a "
                "card (e.g. --device cuda:0 --dist-backend gloo) to put several "
                "ranks on one"
            )
        dev = torch.device("cuda", rank)
    return dev


def resolve_devices(spec: str) -> Tuple[torch.device, Optional[List[torch.device]]]:
    """A trainer's ``--device`` list: (the lead device, the mesh's devices).
    The devices are None for a plain ``cuda`` outside a launcher, which
    means every visible card (``make_mesh``'s default)."""
    names = [n.strip() for n in spec.split(",") if n.strip()]
    if not names:
        raise ValueError(f"--device names no device: {spec!r}")
    devices = [resolve_device(n) for n in names]
    every_card = names == ["cuda"] and distributed.local_rank() is None
    return devices[0], None if every_card else devices


def init_distributed(args):
    """Join the process group of a launcher (torchrun) for a CLI with
    ``--device`` and ``--dist-backend``; returns it, or None for a process
    no launcher started.  The lead device is resolved first, so a missing
    card raises before any rendezvous; with CUDA it becomes the current
    card.  The backend defaults to NCCL for a card and gloo for the CPU."""
    lead, _ = resolve_devices(args.device)
    if not distributed.launched():
        return None
    if lead.type == "cuda":
        torch.cuda.set_device(lead)
    return distributed.initialize(
        backend=args.dist_backend or ("nccl" if lead.type == "cuda" else "gloo"))


def check_data_axis(args, parser, n_data: int) -> None:
    """``--batch-size`` must split over the data axis: the processes times
    ``n_data``, each process's own mesh rows (as JAX's data axis spans
    every device of every host)."""
    n = distributed.process_count() * n_data
    if args.batch_size % n:
        parser.error(
            f"--batch-size {args.batch_size} must be divisible by the "
            f"data mesh axis ({n} devices)"
        )


def spatial_mesh(args, parser) -> Tuple[torch.device, Optional[Mesh]]:
    """The lead device and the conv mesh of a trainer's ``--device`` and
    ``--spatial`` (icsg3d_tpu/apps/train_vae.py:129-138): a (data, spatial)
    mesh for ``--spatial`` > 1; None for ``--spatial 1``, where the model
    runs on the lead device alone.  The data axis (the processes times the
    mesh's data rows) must divide ``--batch-size``."""
    lead, devices = resolve_devices(args.device)
    if args.spatial <= 1:
        check_data_axis(args, parser, 1)
        return lead, None
    try:
        mesh = make_mesh(n_spatial=args.spatial, devices=devices)
    except ValueError as e:
        raise ValueError(
            f"--spatial {args.spatial} with --device {args.device}: {e}; repeat a "
            "device to put several mesh cells on it, e.g. --device cuda:0,cuda:0 "
            "(or cpu,cpu)"
        ) from e
    check_data_axis(args, parser, mesh.shape[DATA_AXIS])
    return lead, mesh


def compute_dtype(device: torch.device) -> str:
    """Models compute in bfloat16 on the card and in float32 on the CPU,
    whose plain path exists for checks against the reference (bf16 buys
    nothing there)."""
    return "bfloat16" if device.type == "cuda" else "float32"


def vae_config_from_args(args, grid, dtype: str = "bfloat16") -> VAEConfig:
    return VAEConfig(
        grid=grid, cond_bins=args.cond_bins, latent_dim=args.latent,
        filters=parse_filters(args.filters),
        layout=getattr(args, "layout", "ndhwc"),
        cond_repeat=getattr(args, "cond_repeat", 1),
        dtype=dtype,
    )


def weights_path(path: Optional[str], which: str = "best") -> Optional[str]:
    """The ``.npz`` to load for a ``--*-ckpt`` value, or None for a fresh
    init: a file as it is; a checkpoint directory of the port's trainer
    through its ``<which>.npz``.  An Orbax checkpoint directory raises:
    export it first."""
    if not path:
        return None
    if os.path.isfile(path):
        return path
    if os.path.isdir(path):
        own = os.path.join(path, which + ".npz")
        if os.path.isfile(own):
            return own
        if any(os.path.exists(os.path.join(path, which + suf))
               for suf in ("", ".new", ".old")):
            raise ValueError(
                f"{path!r} is an Orbax checkpoint directory, which the port "
                f"cannot read; export it to .npz where JAX is installed: "
                f"python {EXPORT_SCRIPT} --vae-ckpt/--unet-ckpt/--cgcnn-ckpt "
                f"{path} ..."
            )
        print(
            f"warning: checkpoint dir {path!r} has no {which!r} checkpoint; "
            "using fresh weights",
            file=sys.stderr,
        )
        return None
    if path.endswith(".npz"):
        raise FileNotFoundError(f"weights file {path!r} does not exist")
    return None


def _finish(model, path, device):
    if path is not None:
        load_flax_variables(model, model_variables(load_npz(path)))
    return model.to(device).eval()


def load_vae(cfg: VAEConfig, checkpoint: Optional[str],
             device="cuda", seed: int = 0) -> ConditionalDFCVAE:
    """VAE with weights from ``checkpoint`` (.npz), else a seeded init, on
    ``device`` (raises when it is CUDA and CUDA is unavailable)."""
    device = resolve_device(str(device))
    path = weights_path(checkpoint)
    gen = torch.Generator().manual_seed(seed)
    return _finish(ConditionalDFCVAE(cfg, gen), path, device)


def load_unet(cfg: UNetConfig, checkpoint: Optional[str], grid_d: int = 32,
              device="cuda", seed: int = 0) -> UNet3D:
    """U-Net with weights from ``checkpoint`` (.npz), else a seeded init, on
    ``device`` (raises when it is CUDA and CUDA is unavailable).
    ``grid_d`` is kept for signature parity: the U-Net is fully
    convolutional, so its weights do not depend on it."""
    device = resolve_device(str(device))
    path = weights_path(checkpoint)
    gen = torch.Generator().manual_seed(seed)
    return _finish(UNet3D(cfg, gen), path, device)


def load_cgcnn(cfg: CGCNNConfig, checkpoint: Optional[str], device="cuda",
               seed: int = 0, which: str = "best") -> CGCNN:
    """CGCNN with weights from ``checkpoint`` (an .npz, or a checkpoint
    directory of the port's trainer), else a seeded init, on ``device``
    (raises when it is CUDA and CUDA is unavailable).  It computes in
    ``cfg.dtype`` (float32) on every device."""
    device = resolve_device(str(device))
    path = weights_path(checkpoint, which)
    gen = torch.Generator().manual_seed(seed)
    return _finish(CGCNN(cfg, gen), path, device)


def cgcnn_predict(model: CGCNN, graphs, batch_size: int = 32) -> np.ndarray:
    """(n,) predictions for featurized graphs (data/graphs.featurize_batch),
    in input order, one slice of ``batch_size`` graphs at a time as in the
    JAX package (icsg3d_tpu/apps/predict.py:64-81).  The masked BN uses the
    live batch's statistics, so another batching changes the numbers."""
    device = next(model.parameters()).device
    keys = ("atom_fea", "nbr_dist", "nbr_idx", "atom_mask")
    n = len(graphs["atom_fea"])
    preds = []
    with torch.inference_mode():
        for s0 in range(0, n, batch_size):
            args = [torch.from_numpy(np.ascontiguousarray(graphs[k][s0:s0 + batch_size]))
                    .to(device) for k in keys]
            preds.append(model(*args).float().cpu().numpy())
    return np.concatenate(preds)


def parse_property_checkpoints(value: str, parser, flag: str):
    """``name=dir[,name=dir...]`` -> {name: dir}; a malformed value is a
    parser error, as in icsg3d_tpu/apps/generate.py:561-570."""
    try:
        return dict(kv.split("=", 1) for kv in value.split(",") if kv.strip())
    except ValueError:
        parser.error(f"{flag} must be name=dir[,name=dir...], got {value!r}")


def grid_input(density: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """(B,d,d,d) + (B,d,d,d,3) -> (B,d,d,d,4) model input."""
    return np.concatenate(
        [density[..., None].astype(np.float32), coords.astype(np.float32)],
        axis=-1,
    )


def plots_available() -> bool:
    """Whether matplotlib imports here; where it does not, prints that the
    plots are skipped (the run writes its data without its PNGs)."""
    from icsg3d_torch import viz

    if viz.available():
        return True
    print(viz.PLOTS_SKIPPED)
    return False


def plot_dir(args) -> Optional[str]:
    """A trainer CLI's best-val plot directory, ``<args.ckpt>/plots``, where
    matplotlib imports (``plots_available``) and on rank 0; elsewhere
    None."""
    if distributed.process_index() != 0:
        return None
    return os.path.join(args.ckpt, "plots") if plots_available() else None


def require_plots(parser, flag: str) -> None:
    """An explicit request for plots (``flag``) where matplotlib does not
    import is a usage error, raised before any model loads."""
    from icsg3d_torch import viz

    if not viz.available():
        parser.error(f"{flag} draws plots, and matplotlib is not installed")


def finish_history(args, history, metric: str = "loss", plots: bool = False):
    """Write ``<args.ckpt>/history.json`` for a trainer CLI: on ``--resume``
    appended to the earlier run's, truncated to the epochs its checkpoint
    holds (``args._resumed_epochs``); with ``plots`` also the loss curves,
    ``<args.ckpt>/loss.png``.  Prints the best validation ``metric``.  In a
    process group rank 0 writes, and every rank waits for it."""
    if distributed.process_index() == 0:
        _write_history(args, history, metric, plots)
    distributed.sync_hosts()


def _write_history(args, history, metric, plots):
    os.makedirs(args.ckpt, exist_ok=True)
    hist_path = os.path.join(args.ckpt, "history.json")
    if args.resume and os.path.exists(hist_path):
        try:
            with open(hist_path) as f:
                prev = json.load(f)
            done = getattr(args, "_resumed_epochs", None)
            if done is not None:
                prev = prev[:done]
            history = prev + history
        except (ValueError, OSError):
            pass  # unreadable prior history: keep this run's alone
    if plots:
        from icsg3d_torch import viz

        viz.plot_losses([h["train"][metric] for h in history],
                        [h["val"][metric] for h in history],
                        os.path.join(args.ckpt, "loss.png"))
    with open(hist_path, "w") as f:
        json.dump(history, f, indent=1)
    if history:
        print(f"done; best val {metric} "
              f"{min(h['val'][metric] for h in history):.4f} -> {args.ckpt}")
    else:
        print(f"done; 0 epochs ran -> {args.ckpt}")
