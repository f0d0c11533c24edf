"""Export icsg3d_tpu model weights to the flat .npz that icsg3d_torch reads.

The machine that runs the PyTorch port has no JAX and cannot read Orbax
checkpoints, so weights cross over as a numpy ``.npz`` keyed by Flax path
("params/encoder/Conv_0/kernel", "batch_stats/decoder/output_bn/mean").
Run this where JAX is installed:

    python tools/export_flax_npz.py \\
        --vae-ckpt checkpoints/vae --vae-out vae.npz \\
        --unet-ckpt checkpoints/unet --unet-out unet.npz \\
        --cgcnn-ckpt checkpoints/cgcnn --cgcnn-out cgcnn.npz

The geometry flags must match the checkpoints (defaults: the production
32^3 grid, VAE filters 16,32,64,128, latent 256, 10 condition bins,
95 U-Net classes; the CGCNN has the JAX package's one configuration).  A
checkpoint path with no ``best`` checkpoint exports
the JAX package's fresh init (key 0) with a warning, as its CLIs do.
Then pass the files to ``python -m icsg3d_torch.apps.generate --vae-ckpt
vae.npz --unet-ckpt unet.npz [--cgcnn-ckpt formation_energy_per_atom=cgcnn.npz]
...`` or ``python -m icsg3d_torch.apps.predict --ckpt name=cgcnn.npz ...``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    from icsg3d_torch.weights import save_npz
    from icsg3d_tpu.apps import common
    from icsg3d_tpu.config import CGCNNConfig, GridSpec, UNetConfig

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--vae-ckpt", default=None, help="Orbax checkpoint dir")
    p.add_argument("--vae-out", default=None, help=".npz to write")
    p.add_argument("--unet-ckpt", default=None, help="Orbax checkpoint dir")
    p.add_argument("--unet-out", default=None, help=".npz to write")
    p.add_argument("--cgcnn-ckpt", default=None, help="Orbax checkpoint dir")
    p.add_argument("--cgcnn-out", default=None, help=".npz to write")
    p.add_argument("--which", default="best", help="checkpoint name")
    p.add_argument("--d", type=int, default=32)
    p.add_argument("--num-classes", type=int, default=95)
    p.add_argument("--cond-bins", type=int, default=10)
    common.add_vae_flags(p)
    args = p.parse_args(argv)
    if not (args.vae_out or args.unet_out or args.cgcnn_out):
        p.error("give --vae-out, --unet-out and/or --cgcnn-out")

    grid = GridSpec(d=args.d)
    if args.vae_out:
        _, variables = common.load_vae(
            common.vae_config_from_args(args, grid), args.vae_ckpt, args.which
        )
        save_npz(args.vae_out, variables)
        print(f"wrote {args.vae_out}")
    if args.unet_out:
        _, variables = common.load_unet(
            UNetConfig(num_classes=args.num_classes), args.unet_ckpt,
            grid_d=args.d, which=args.which,
        )
        save_npz(args.unet_out, variables)
        print(f"wrote {args.unet_out}")
    if args.cgcnn_out:
        _, variables = common.load_cgcnn(CGCNNConfig(), args.cgcnn_ckpt, args.which)
        save_npz(args.cgcnn_out, variables)
        print(f"wrote {args.cgcnn_out}")


if __name__ == "__main__":
    main()
