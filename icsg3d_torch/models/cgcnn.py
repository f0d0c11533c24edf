"""Crystal graph convolutional network for property regression.

Counterpart of icsg3d_tpu/models/cgcnn.py (reference cgcnn/cgcnn.py:21-160):
gather neighbour features, concat [self, neighbour, bond], one gated linear
unit (sigmoid filter x softplus core), masked batch-norm, residual softplus
update, masked global mean pool, Dense(128, softplus), Dense(1).

The modules keep Flax's names so weights.py maps a Flax tree mechanically:
``CGCNN`` holds ``Dense_0`` (93 -> 64), ``CrystalGraphConv_0`` ...
``CrystalGraphConv_{n_conv-1}``, ``Dense_1`` (64 -> 128) and ``Dense_2``
(128 -> 1); ``CrystalGraphConv`` holds ``Dense_0`` (2F + bond width -> 2F)
and the parameters ``gamma1``, ``beta1``, ``gamma2``, ``beta2``.

The reference's masked batch-norm is replicated exactly
(cgcnn/cgcnn.py:76-98): one scalar mean and variance over the whole masked
tensor, in f32, with count-nonzero denominators (exact zeros in real
entries are not counted), and the second variance divided by the
count_nonzero of the squared differences (sic).  The counts are integers,
so no gradient flows through them.  Batch statistics at train AND
inference time; there are no running buffers.

The products are plain f32 matmuls (the JAX package computes them outside
any Pallas kernel); on the card they stay f32, without TF32.  ``softplus``
is Flax's ``logaddexp(x, 0)``, not torch's thresholded form.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from icsg3d_torch.config import CGCNNConfig
from icsg3d_torch.data.graphs import gaussian_expand
from icsg3d_torch.models.layers import Dense
from icsg3d_torch.models.vae import _dtype


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Flax's softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _masked_batch_stats(x, mask, count_from_values: bool = True):
    """Reference masked-BN statistics (cgcnn/cgcnn.py:79-81).

    mu = sum(x) / count_nonzero(x); var = sum((x-mu)^2 * mask) / denom, with
    denom count_nonzero(x), or count_nonzero of the squared differences for
    the second BN.  x is already masked (zeros at padding).
    """
    x = x.float()
    mask = mask.float()
    count = torch.clamp(torch.count_nonzero(x).float(), min=1.0)
    mu = torch.sum(x) / count
    diff_sq = torch.square(x - mu) * mask
    if count_from_values:
        denom = count
    else:
        denom = torch.clamp(torch.count_nonzero(diff_sq).float(), min=1.0)
    return mu, torch.sum(diff_sq) / denom


def max_pool(x: torch.Tensor, activation=None) -> torch.Tensor:
    """Global node-wise max pool (reference MaxPooling, cgcnn/cgcnn.py:106-122),
    unmasked as in the reference; unused by CGCNN, kept for parity."""
    pooled = torch.amax(x, dim=1)
    return activation(pooled) if activation is not None else pooled


def masked_mean_pool(x: torch.Tensor) -> torch.Tensor:
    """Masked mean pool (reference MeanPooling, cgcnn/cgcnn.py:125-142):
    sum over atoms / count of atoms with a nonzero feature-row sum."""
    row_nonzero = torch.count_nonzero(torch.sum(x, dim=-1), dim=1).float()
    return torch.sum(x, dim=1) / torch.clamp(row_nonzero, min=1.0)[:, None]


class CrystalGraphConv(nn.Module):
    """One crystal-graph convolution with GLU gating and masked BN."""

    def __init__(self, atom_fea_len: int, nbr_fea_len: int,
                 bn_epsilon: float = 1e-5, dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nbr_fea_len = nbr_fea_len
        self.bn_epsilon = bn_epsilon
        self.dtype = _dtype(dtype)
        f2 = 2 * atom_fea_len
        self.Dense_0 = Dense(f2 + nbr_fea_len, f2, generator)
        self.gamma1 = nn.Parameter(torch.ones(f2))
        self.beta1 = nn.Parameter(torch.zeros(f2))
        self.gamma2 = nn.Parameter(torch.ones(atom_fea_len))
        self.beta2 = nn.Parameter(torch.zeros(atom_fea_len))

    def forward(self, atom_fea, nbr_fea, nbr_idx, atom_mask):
        """atom_fea: (B, N, F); nbr_fea: (B, N, M, Fb); nbr_idx: (B, N, M)
        int; atom_mask: (B, N) float.  Returns (B, N, F)."""
        if nbr_fea.shape[-1] != self.nbr_fea_len:
            raise ValueError(
                f"bond features are {nbr_fea.shape[-1]}-wide, config "
                f"says {self.nbr_fea_len}"
            )
        B, N, F = atom_fea.shape
        M = nbr_idx.shape[-1]

        # the neighbours' features: a gather over (B, N*M) rows, whose
        # backward is a scatter-add (padded rows and repeated neighbours
        # accumulate)
        idx = nbr_idx.reshape(B, N * M, 1).long().expand(B, N * M, F)
        atom_nbr_fea = torch.gather(atom_fea, 1, idx).reshape(B, N, M, F)
        self_fea = atom_fea[:, :, None, :].expand(B, N, M, F)
        total = torch.cat([self_fea, atom_nbr_fea, nbr_fea], dim=-1)

        gated = self.Dense_0(total, self.dtype)
        edge_mask = atom_mask[:, :, None, None]  # padding atoms contribute 0
        gated = gated * edge_mask

        mu1, var1 = _masked_batch_stats(gated, edge_mask.expand(gated.shape),
                                        count_from_values=True)
        gated = (gated - mu1) / torch.sqrt(var1 + self.bn_epsilon) * self.gamma1 \
            + self.beta1
        gated = gated * edge_mask

        nbr_filter, nbr_core = torch.chunk(gated, 2, dim=-1)
        summed = torch.sum(torch.sigmoid(nbr_filter) * softplus(nbr_core), dim=2)
        node_mask = atom_mask[:, :, None]
        summed = summed * node_mask

        mu2, var2 = _masked_batch_stats(summed, node_mask.expand(summed.shape),
                                        count_from_values=False)
        summed = (summed - mu2) / torch.sqrt(var2 + self.bn_epsilon) * self.gamma2 \
            + self.beta2
        summed = summed * node_mask

        return softplus(atom_fea + summed) * node_mask


class CGCNN(nn.Module):
    """Full property-regression model (cgcnn/cgcnn.py:145-160)."""

    def __init__(self, cfg: CGCNNConfig = CGCNNConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.spec = cfg.graph_spec()
        self.dtype = _dtype(cfg.dtype)
        self.Dense_0 = Dense(cfg.atom_input_dim, cfg.atom_fea_len, generator)
        for i in range(cfg.n_conv):
            setattr(self, f"CrystalGraphConv_{i}", CrystalGraphConv(
                cfg.atom_fea_len, self.spec.num_bond_features, cfg.bn_epsilon,
                cfg.dtype, generator))
        self.Dense_1 = Dense(cfg.atom_fea_len, cfg.hidden_dim, generator)
        self.Dense_2 = Dense(cfg.hidden_dim, 1, generator)

    def forward(self, atom_fea, nbr_dist, nbr_idx, atom_mask):
        """atom_fea: (B, N, 93) element features; nbr_dist: (B, N, M) raw
        distances in Angstrom; nbr_idx: (B, N, M); atom_mask: (B, N).

        Returns (B,) predicted property values.
        """
        dt = self.dtype
        nbr_fea = gaussian_expand(nbr_dist, self.spec).to(dt)
        x = self.Dense_0(atom_fea.to(dt), dt)
        for i in range(self.cfg.n_conv):
            conv = getattr(self, f"CrystalGraphConv_{i}")
            x = conv(x, nbr_fea, nbr_idx, atom_mask)
        pooled = softplus(masked_mean_pool(x))
        h = softplus(self.Dense_1(pooled.to(dt), dt))
        out = self.Dense_2(h.float(), torch.float32)
        return out[:, 0]
