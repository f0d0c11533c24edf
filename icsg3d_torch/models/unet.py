"""3D U-Net species segmenter, eval mode.

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

Each conv -> ReLU -> BN block is one fused kernel call.  The ``max_conv``
truncation and the perceptual taps serve training and are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


class UNet3D(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
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
            self.add_module(f"bn{i}", BatchNorm(cout, cfg.bn_epsilon))
        self.n_convs = len(plan)
        self.head_soft = Conv3d(ch, cfg.num_classes, 1, generator)
        self.head_sig = Conv3d(ch, 1, 1, generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, D, H, W, C) density+coordinate grid.

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
                order="relu_bn", act="relu",
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
