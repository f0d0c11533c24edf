"""PyTorch models with Flax-named parameters (see weights.py): eval mode,
and the VAE's training mode with batch-statistics BatchNorm."""

from icsg3d_torch.models.unet import UNet3D
from icsg3d_torch.models.vae import ConditionalDFCVAE, Decoder, Encoder
