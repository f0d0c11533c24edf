"""PyTorch models with Flax-named parameters (see weights.py): eval mode,
and the VAE's training mode with batch-statistics BatchNorm; the CGCNN
property regressor."""

from icsg3d_torch.models.cgcnn import CGCNN
from icsg3d_torch.models.unet import UNet3D
from icsg3d_torch.models.vae import ConditionalDFCVAE, Decoder, Encoder
