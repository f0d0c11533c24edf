"""Training of the port: train state, checkpoints, and the DFC-VAE and
U-Net steps and epoch loops (counterpart of icsg3d_tpu/train; CGCNN not
ported yet)."""

from icsg3d_torch.train.unet import (
    create_unet_state,
    make_unet_steps,
    prepare_unet_batch,
    train_unet,
)
from icsg3d_torch.train.vae import (
    create_vae_state,
    make_vae_steps,
    prepare_vae_batch,
    train_vae,
)
