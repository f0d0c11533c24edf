"""Eval-mode PyTorch models with Flax-named parameters (see weights.py)."""

from icsg3d_torch.models.unet import UNet3D
from icsg3d_torch.models.vae import ConditionalDFCVAE, Decoder, Encoder
