"""Shared helpers for the port's CLIs: flags, device choice and model
loading.  Counterpart of icsg3d_tpu/apps/common.py.

Weights come from a flat ``.npz`` exported from a Flax checkpoint
(tools/export_flax_npz.py); the port cannot read Orbax directories.
Without a checkpoint the models start from a seeded fresh init, with the
same warning as the JAX CLIs when a checkpoint directory holds none.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from icsg3d_torch.config import UNetConfig, VAEConfig
from icsg3d_torch.models import ConditionalDFCVAE, UNet3D
from icsg3d_torch.weights import load_flax_variables, load_npz

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
             "'cpu' runs the plain PyTorch versions of the kernels in float32",
    )


def resolve_device(name: str) -> torch.device:
    """The torch device for ``name``; never silently falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available here; pass --device cpu "
            "to run the plain PyTorch path on the CPU"
        )
    return dev


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
    init.  An Orbax checkpoint directory raises: export it first."""
    if not path:
        return None
    if os.path.isfile(path):
        return path
    if os.path.isdir(path):
        if any(os.path.exists(os.path.join(path, which + suf))
               for suf in ("", ".new", ".old")):
            raise ValueError(
                f"{path!r} is an Orbax checkpoint directory, which the port "
                f"cannot read; export it to .npz where JAX is installed: "
                f"python {EXPORT_SCRIPT} --vae-ckpt/--unet-ckpt {path} ..."
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
        load_flax_variables(model, load_npz(path))
    return model.to(device).eval()


def load_vae(cfg: VAEConfig, checkpoint: Optional[str],
             device="cpu", seed: int = 0) -> ConditionalDFCVAE:
    """VAE with weights from ``checkpoint`` (.npz), else a seeded init."""
    path = weights_path(checkpoint)
    gen = torch.Generator().manual_seed(seed)
    return _finish(ConditionalDFCVAE(cfg, gen), path, device)


def load_unet(cfg: UNetConfig, checkpoint: Optional[str], grid_d: int = 32,
              device="cpu", seed: int = 0) -> UNet3D:
    """U-Net with weights from ``checkpoint`` (.npz), else a seeded init.
    ``grid_d`` is kept for signature parity: the U-Net is fully
    convolutional, so its weights do not depend on it."""
    path = weights_path(checkpoint)
    gen = torch.Generator().manual_seed(seed)
    return _finish(UNet3D(cfg, gen), path, device)


def grid_input(density: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """(B,d,d,d) + (B,d,d,d,3) -> (B,d,d,d,4) model input."""
    return np.concatenate(
        [density[..., None].astype(np.float32), coords.astype(np.float32)],
        axis=-1,
    )
