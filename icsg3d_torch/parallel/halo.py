"""Depth sharding of the 3x3x3 conv with a one-plane halo exchange.

Counterpart of icsg3d_tpu/parallel/halo.py.  ``conv_sharded`` is
``conv_ndcs_sharded`` (halo.py:63-94): B splits over the mesh's ``data``
axis and D over ``spatial``; each cell's slab is padded with its
neighbours' edge planes (zeros at the global ends) and the depth-VALID
conv kernel runs once per cell on it, which together is exactly the
global SAME conv.

The exchange is built only from differentiable slicing, ``cat`` and
``.to``, so autograd carries the halo planes' cotangents back to the
neighbours' slabs and sums the per-cell weight gradients: what JAX's
transposed ``ppermute`` and shard_map's ``psum`` do (halo.py:63-73).  One
process drives every cell; a device may hold several cells (mesh.py).

``spatial_shard_conv3d`` (halo.py:97-129, a demonstration) is not ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from icsg3d_torch.ops.conv import conv3d_valid, conv3d_valid_diff
from icsg3d_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS, Mesh


def halo_exchange(slabs: Sequence[torch.Tensor], halo: int = 1,
                  axis: int = 1) -> List[torch.Tensor]:
    """Pad each of one mesh row's depth slabs, in order, with ``halo``
    planes of its neighbours on ``axis`` (zeros at the two global ends).

    Each result is a new tensor on its own slab's device: cells that share
    a device never share storage.
    """
    for s in slabs:
        if halo > s.shape[axis]:
            raise ValueError(
                f"halo {halo} exceeds the per-shard extent {s.shape[axis]} on "
                f"axis {axis}: one exchange can only fetch the immediate "
                "neighbor's planes — use fewer shards or a smaller kernel"
            )
    out = []
    for i, s in enumerate(slabs):
        n = s.shape[axis]
        lo = (slabs[i - 1].narrow(axis, slabs[i - 1].shape[axis] - halo, halo).to(s.device)
              if i > 0 else torch.zeros_like(s.narrow(axis, 0, halo)))
        hi = (slabs[i + 1].narrow(axis, 0, halo).to(s.device)
              if i + 1 < len(slabs) else torch.zeros_like(s.narrow(axis, n - halo, halo)))
        out.append(torch.cat([lo, s, hi], dim=axis))
    return out


def mesh_divides(x: torch.Tensor, mesh: Mesh) -> bool:
    """Whether ``conv_sharded`` can split x (B, D, ...): whole shards only,
    as shard_map needs (models/layers.py:134-149 of the JAX package)."""
    return (x.shape[0] % mesh.shape[DATA_AXIS] == 0
            and x.shape[1] % mesh.shape[SPATIAL_AXIS] == 0)


def conv_sharded(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    mesh: Mesh,
    *,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    epilogue: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
    slope: float = 0.3,
) -> torch.Tensor:
    """Depth-sharded Conv3D(3x3x3, SAME) of x (B, D, H, W, Cin) over
    ``mesh``; the result (B, D, H, W, Cout) is on x's device.

    ``epilogue=None`` runs the differentiable conv + bias
    (``conv3d_valid_diff``: training, and the encoder's last conv); an
    epilogue name runs the fused eval form (``conv3d_valid`` with scale,
    shift, out_dtype and slope as in ``ops.conv.conv3d_same``).  The batch
    must divide by the ``data`` axis and the depth by ``spatial``.
    """
    if not mesh_divides(x, mesh):
        raise ValueError(f"x {tuple(x.shape)} does not split over mesh {mesh.shape}")
    n_data, n_spatial = mesh.devices.shape
    rows = []
    for i, xb in enumerate(x.chunk(n_data, dim=0)):
        devs = mesh.devices[i]
        slabs = halo_exchange([s.to(d) for s, d in zip(xb.chunk(n_spatial, dim=1), devs)])
        outs = []
        for s, d in zip(slabs, devs):
            if epilogue is None:
                y = conv3d_valid_diff(s, w.to(d), bias.to(d))
            else:
                y = conv3d_valid(
                    s, w.to(d), bias.to(d),
                    scale=None if scale is None else scale.to(d),
                    shift=None if shift is None else shift.to(d),
                    epilogue=epilogue, out_dtype=out_dtype, slope=slope,
                )
            outs.append(y.to(x.device))
        rows.append(torch.cat(outs, dim=1))
    return torch.cat(rows, dim=0)
