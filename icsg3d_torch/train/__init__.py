"""Training of the port: train state, checkpoints, and the DFC-VAE, U-Net
and CGCNN steps and epoch loops (counterpart of icsg3d_tpu/train)."""

from icsg3d_torch.train.cgcnn import (
    create_cgcnn_state,
    make_cgcnn_steps,
    train_cgcnn,
)
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
