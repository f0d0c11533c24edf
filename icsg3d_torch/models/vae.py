"""Conditional deep-feature-consistent VAE over voxel grids.

Counterpart of icsg3d_tpu/models/vae.py (reference LatticeDFCVAE,
vae/lattice_vae.py:69-270), with the same submodule names as the Flax tree
so weights.py maps checkpoints mechanically:

- Encoder: condition one-hot broadcast over the grid and appended after the
  x channels (``cond_repeat`` copies); blocks Conv(3^3) -> BN ->
  LeakyReLU(0.3) -> MaxPool(2) with filters (16, 32, 64, 128);
  Conv(4) -> LeakyReLU; flatten in NDHWC order -> Dense(latent, relu);
  f32 Dense heads z_mean and z_log_var.
- Decoder: Dense over concat(z, cond) -> reshape (B, s, s, s, c0); blocks
  Conv -> BN -> LeakyReLU with reversed filters and 2x nearest upsampling
  between; an f32 output head Conv -> BN -> ReLU.

In eval mode every 3x3x3 conv block is one fused kernel call
(models/layers.conv_block); ``train=True`` runs the differentiable conv and
batch-statistics BN (updating the running statistics).  The DFC loss is in
train/vae.py.

``spatial_mesh`` (a parallel/mesh.Mesh, default None) shards every 3x3x3
conv in depth where the mesh divides it: the blocks, the encoder's last
conv and the output head (icsg3d_tpu/models/vae.py:49, 104-108, 194-197,
236-239).  BatchNorm, pools, upsampling and the dense layers stay global.

``group`` (a torch.distributed process group, default None) makes every
training BatchNorm take the global batch's moments across the data-parallel
processes (models/layers.BatchNorm.train_forward).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from icsg3d_torch.config import VAEConfig
from icsg3d_torch.models.layers import (
    BatchNorm,
    Conv3d,
    Dense,
    broadcast_condition,
    conv_block,
    leaky_relu,
    max_pool_3d,
    upsample_3d,
)
from icsg3d_torch.parallel.mesh import Mesh


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig(),
                 generator: Optional[torch.Generator] = None,
                 spatial_mesh: Optional[Mesh] = None, group=None):
        super().__init__()
        self.cfg = cfg
        self.spatial_mesh = spatial_mesh
        self.group = group
        cin = cfg.grid.channels + cfg.cond_bins * cfg.cond_repeat
        for i, f in enumerate(cfg.filters):
            self.add_module(f"Conv_{i}", Conv3d(cin, f, generator=generator))
            self.add_module(f"BatchNorm_{i}",
                            BatchNorm(f, cfg.bn_epsilon, cfg.bn_momentum))
            cin = f
        n = len(cfg.filters)
        self.add_module(f"Conv_{n}", Conv3d(cin, 4, generator=generator))
        s = cfg.grid.d // 2 ** n
        self.Dense_0 = Dense(s ** 3 * 4, cfg.latent_dim, generator)
        self.z_mean = Dense(cfg.latent_dim, cfg.latent_dim, generator)
        self.z_log_var = Dense(cfg.latent_dim, cfg.latent_dim, generator)

    def forward(self, x: torch.Tensor, cond: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, d, d, d, C); cond: (B, cond_bins) one-hot.

        Returns (z_mean, z_log_var), both (B, latent_dim) float32.
        """
        cfg = self.cfg
        dtype = _dtype(cfg.dtype)
        x = x.to(dtype)
        cnd = broadcast_condition(cond.to(dtype), x.shape[1:4], cfg.cond_repeat)
        x = torch.cat([x, cnd], dim=-1)
        for i in range(len(cfg.filters)):
            x = conv_block(
                x, getattr(self, f"Conv_{i}"), getattr(self, f"BatchNorm_{i}"),
                order="bn_act", act="leaky", slope=cfg.leaky_slope, train=train,
                mesh=self.spatial_mesh, group=self.group,
            )
            x = max_pool_3d(x)
        x = getattr(self, f"Conv_{len(cfg.filters)}").diff(x, self.spatial_mesh)
        x = leaky_relu(x, cfg.leaky_slope)
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.Dense_0(x, dtype)).float()
        return self.z_mean(x, torch.float32), self.z_log_var(x, torch.float32)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig(),
                 generator: Optional[torch.Generator] = None,
                 spatial_mesh: Optional[Mesh] = None, group=None):
        super().__init__()
        self.cfg = cfg
        self.spatial_mesh = spatial_mesh
        self.group = group
        # d / 2^(len-1) seed grid: (4,4,4,4) at the reference defaults
        self.start = cfg.grid.d // 2 ** (len(cfg.filters) - 1)
        self.c0 = max(cfg.latent_dim // self.start ** 3, 1)
        self.Dense_0 = Dense(
            cfg.latent_dim + cfg.cond_bins, self.start ** 3 * self.c0, generator
        )
        cin = self.c0
        for i, f in enumerate(reversed(cfg.filters)):
            self.add_module(f"Conv_{i}", Conv3d(cin, f, generator=generator))
            self.add_module(f"BatchNorm_{i}",
                            BatchNorm(f, cfg.bn_epsilon, cfg.bn_momentum))
            cin = f
        self.decoder_output = Conv3d(cin, cfg.grid.channels, generator=generator)
        self.output_bn = BatchNorm(cfg.grid.channels, cfg.bn_epsilon,
                                   cfg.bn_momentum)

    def forward(self, z: torch.Tensor, cond: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """z: (B, latent_dim); cond: (B, cond_bins).  Returns the f32
        (B, d, d, d, channels) grid."""
        cfg = self.cfg
        dtype = _dtype(cfg.dtype)
        s = self.start
        x = torch.cat([z, cond], dim=-1).to(dtype)
        x = self.Dense_0(x, dtype).reshape(x.shape[0], s, s, s, self.c0)
        n = len(cfg.filters)
        for i in range(n):
            x = conv_block(
                x, getattr(self, f"Conv_{i}"), getattr(self, f"BatchNorm_{i}"),
                order="bn_act", act="leaky", slope=cfg.leaky_slope, train=train,
                mesh=self.spatial_mesh, group=self.group,
            )
            if i < n - 1:
                x = upsample_3d(x)
        # the output head runs in float32 (BN + ReLU clamp outputs >= 0,
        # vae/lattice_vae.py:225-226)
        return conv_block(
            x.float(), self.decoder_output, self.output_bn,
            order="bn_act", act="relu", out_dtype=torch.float32, train=train,
            mesh=self.spatial_mesh, group=self.group,
        )


class ConditionalDFCVAE(nn.Module):
    """Encoder + reparameterized sample + decoder; ``encode``/``decode`` as
    in the Flax module.  Setting ``spatial_mesh`` or ``group`` sets the
    encoder's and the decoder's."""

    def __init__(self, cfg: VAEConfig = VAEConfig(),
                 generator: Optional[torch.Generator] = None,
                 spatial_mesh: Optional[Mesh] = None, group=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, generator, spatial_mesh, group)
        self.decoder = Decoder(cfg, generator, spatial_mesh, group)

    @property
    def spatial_mesh(self) -> Optional[Mesh]:
        return self.encoder.spatial_mesh

    @spatial_mesh.setter
    def spatial_mesh(self, mesh: Optional[Mesh]) -> None:
        self.encoder.spatial_mesh = self.decoder.spatial_mesh = mesh

    @property
    def group(self):
        return self.encoder.group

    @group.setter
    def group(self, group) -> None:
        self.encoder.group = self.decoder.group = group

    def forward(self, x, cond, eps, train: bool = False):
        """Full VAE pass (vae.py:275-283) with the reparameterization noise
        ``eps`` (B, latent_dim) passed in.  Returns (reconstruction,
        z_mean, z_log_var, z)."""
        z_mean, z_log_var = self.encoder(x, cond, train=train)
        z = reparameterize(z_mean, z_log_var, eps)
        recon = self.decoder(z, cond, train=train)
        return recon, z_mean, z_log_var, z

    def encode(self, x, cond):
        return self.encoder(x, cond)

    def decode(self, z, cond):
        return self.decoder(z, cond)


def reparameterize(z_mean, z_log_var, eps):
    """z = mu + exp(log_var / 2) * eps (vae/lattice_vae.py:53-66), with the
    noise passed in: torch's and JAX's generators give different numbers."""
    return z_mean + torch.exp(0.5 * z_log_var) * eps


def sample_prior(model: ConditionalDFCVAE, n_samples: int, cond=None,
                 var: float = 1.0, generator: Optional[torch.Generator] = None,
                 z=None, bins=None):
    """Decode z ~ N(0, var) under given (or random) condition bins
    (icsg3d_tpu/models/vae.py:298-312; reference sample_vae,
    vae/lattice_vae.py:349-357, minus its cond tiling bug).

    z (n, latent_dim) and the bins (n,) are drawn on the CPU from
    ``generator``, z first, so every device decodes the same numbers;
    ``z`` (already scaled) and ``bins`` passed in replace the draws, and
    ``cond`` (n, cond_bins) replaces the one-hot of the bins.  Returns
    (z, decoded grids) on the model's device.
    """
    cfg = model.cfg
    device = next(model.parameters()).device
    if z is None:
        z = torch.randn((n_samples, cfg.latent_dim), generator=generator) * var ** 0.5
    if cond is None:
        if bins is None:
            bins = torch.randint(0, cfg.cond_bins, (n_samples,), generator=generator)
        cond = torch.nn.functional.one_hot(torch.as_tensor(bins).long(),
                                           cfg.cond_bins).float()
    z = torch.as_tensor(z, dtype=torch.float32).to(device)
    cond = torch.as_tensor(cond, dtype=torch.float32).to(device)
    with torch.inference_mode():
        return z, model.decode(z, cond)
