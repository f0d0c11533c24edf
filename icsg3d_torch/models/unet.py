"""3D U-Net species segmenter (eval and training modes) and its
perceptual taps.

Counterpart of icsg3d_tpu/models/unet.py (reference AtomUnet,
unet/unet.py:272-355): a 3-level encoder-decoder over (B, d, d, d, 4) grids
with skip concats ``[skip, x]`` and two f32 1x1x1 heads, ``head_soft``
(num_classes logits) and ``head_sig`` (occupancy logit).  Channel plan:

    enc L1: c1=32,  c2=64     -> pool
    enc L2: c3=64,  c4=128    -> pool
    enc L3: c5=128, c6=256    -> pool
    bottom: c7=512, c8=512    -> up, concat c6
    dec L3: c9=512, c10=256   -> up, concat c4
    dec L2: c11=256, c12=128  -> up, concat c2
    dec L1: c13=128, c14=128  -> heads

Each conv -> ReLU -> BN block of the eval forward is one fused kernel
call; ``train=True`` runs each block as the differentiable conv (epilogue
``bias``; K1 as dx and K2 in the backward), ReLU, then batch-statistics BN,
which updates the running statistics.  The heads are f32 1x1x1 convs, plain
matmuls, in both modes.
``unet_features`` is the DFC-VAE's feature extractor: convs 1..max(taps)
only, returning the post-ReLU, pre-BN activations of the tap convs.

``spatial_mesh`` (a parallel/mesh.Mesh, default None) shards each block's
conv in depth where the mesh divides it (icsg3d_tpu/models/unet.py:46-48,
101-104); BatchNorm, pools, upsampling and the 1x1x1 heads stay global.
``unet_features`` never shards: the frozen perceptual U-Net gets no mesh
in the JAX package either (apps/train_vae.py:166-171).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from icsg3d_torch.config import UNetConfig
from icsg3d_torch.models.layers import (
    BatchNorm,
    Conv3d,
    conv_block,
    max_pool_3d,
    upsample_3d,
)
from icsg3d_torch.ops.conv import conv3d_same_diff
from icsg3d_torch.parallel.mesh import Mesh


class UNet3D(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig(),
                 generator: Optional[torch.Generator] = None,
                 spatial_mesh: Optional[Mesh] = None):
        super().__init__()
        self.cfg = cfg
        self.spatial_mesh = spatial_mesh
        plan = []  # (cin, cout) per conv, in graph order
        ch = cfg.in_channels
        skips = []
        for f1, f2 in cfg.enc_filters:
            plan += [(ch, f1), (f1, f2)]
            skips.append(f2)
            ch = f2
        b1, b2 = cfg.bottom_filters
        plan += [(ch, b1), (b1, b2)]
        ch = b2
        for (f1, f2), skip in zip(cfg.dec_filters, reversed(skips)):
            plan += [(skip + ch, f1), (f1, f2)]
            ch = f2
        for i, (cin, cout) in enumerate(plan, start=1):
            self.add_module(f"conv{i}", Conv3d(cin, cout, generator=generator))
            self.add_module(f"bn{i}", BatchNorm(cout, cfg.bn_epsilon,
                                                cfg.bn_momentum))
        self.n_convs = len(plan)
        self.head_soft = Conv3d(ch, cfg.num_classes, 1, generator)
        self.head_sig = Conv3d(ch, 1, 1, generator)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, D, H, W, C) density+coordinate grid; ``train`` selects
        batch-statistics BN (unet/unet.py:276-278).

        Returns (soft_logits (B,D,H,W,num_classes), sig_logits (B,D,H,W,1)),
        both float32.
        """
        cfg = self.cfg
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
        x = x.to(dtype)
        idx = 0

        def block(h):
            nonlocal idx
            idx += 1
            return conv_block(
                h, getattr(self, f"conv{idx}"), getattr(self, f"bn{idx}"),
                order="relu_bn", act="relu", train=train, mesh=self.spatial_mesh,
            )

        skips = []
        for _ in cfg.enc_filters:
            x = block(block(x))
            skips.append(x)
            x = max_pool_3d(x)
        x = block(block(x))
        for _, skip in zip(cfg.dec_filters, reversed(skips)):
            x = upsample_3d(x)
            x = torch.cat([skip, x.to(skip.dtype)], dim=-1)
            x = block(block(x))
        return self.head_soft.pointwise(x), self.head_sig.pointwise(x)


def unet_features(unet: UNet3D, x: torch.Tensor,
                  taps: Sequence[int]) -> List[torch.Tensor]:
    """Post-ReLU, pre-BN activations of the given conv indices (1-based),
    in the U-Net's compute dtype (unet.py:114-117, 216-229).

    Runs convs 1..max(taps) only, with running-statistics BN.  The fused
    ``relu_affine`` epilogue would hide the tapped tensor, so each conv
    here is the differentiable conv (epilogue ``bias``), then ReLU and the
    BN affine in torch: under ``no_grad`` (the true grid) nothing is kept,
    and on the reconstruction the gradient reaches the input through the
    convs' input gradient alone (the U-Net's parameters are frozen).
    """
    cfg = unet.cfg
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
    max_conv = max(taps)
    feats = {}
    x = x.to(dtype)
    idx = 0

    def block(h):
        nonlocal idx
        idx += 1
        conv = getattr(unet, f"conv{idx}")
        h = torch.relu(conv3d_same_diff(h, conv.kernel, conv.bias))
        if idx in taps:
            feats[idx] = h
        return getattr(unet, f"bn{idx}").eval_forward(h)

    skips = []
    for _ in cfg.enc_filters:
        for _ in range(2):
            x = block(x)
            if idx >= max_conv:
                return [feats[i] for i in taps]
        skips.append(x)
        x = max_pool_3d(x)
    for _ in range(2):
        x = block(x)
        if idx >= max_conv:
            return [feats[i] for i in taps]
    for _, skip in zip(cfg.dec_filters, reversed(skips)):
        x = torch.cat([skip, upsample_3d(x).to(skip.dtype)], dim=-1)
        for _ in range(2):
            x = block(x)
            if idx >= max_conv:
                return [feats[i] for i in taps]
    raise ValueError(f"taps {tuple(taps)} reach past the U-Net's {idx} convs")
