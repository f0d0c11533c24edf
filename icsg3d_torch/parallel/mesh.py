"""The (data, spatial) device mesh of the depth-sharded conv.

Counterpart of icsg3d_tpu/parallel/mesh.py.  The JAX package builds a
``jax.sharding.Mesh`` that one process drives (single controller); the
port's mesh is the same grid of devices as plain torch devices, and one
process drives it too: ``parallel/halo.conv_sharded`` splits a global
tensor into per-cell slabs, moves each to its cell's device, and brings
the results back.  Everything else of a model stays on its lead device.

A device may appear in the mesh more than once, as JAX's virtual CPU
devices let one host hold a mesh: ``[cpu] * 8`` is a 4x2 mesh for the CPU
tests, ``[cuda:0, cuda:0]`` a 1x2 mesh on one card.

Not ported: the GSPMD placement helpers ``batch_sharding``, ``replicated``
and ``shard_batch`` (mesh.py:61-90).  They name shardings of a global
array for XLA's partitioner; torch has no such array, and the port places
each slab itself.  Data parallelism across processes (NCCL) is not ported
either (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


class Mesh:
    """A (n_data, n_spatial) grid of torch devices with the axis names
    ``("data", "spatial")``.  ``devices[i, j]`` is cell (i, j)'s device."""

    axis_names = (DATA_AXIS, SPATIAL_AXIS)

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D grid, got {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _visible_cards():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: CUDA is not available here; name the mesh's devices "
            "(e.g. devices=[torch.device('cpu')] * 2)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_data: int = -1,
    n_spatial: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A (data, spatial) mesh over ``devices`` (default: every visible CUDA
    card; raises where CUDA is missing, never falls back to the CPU).

    n_data=-1 uses all remaining devices on the data axis.  The first
    ``n_data * n_spatial`` devices fill the grid row by row.
    """
    devices = [torch.device(d) for d in
               (devices if devices is not None else _visible_cards())]
    if n_spatial < 1:
        raise ValueError(f"n_spatial must be >= 1, got {n_spatial}")
    if n_data == -1:
        n_data = len(devices) // n_spatial
    if n_data < 1 or n_data * n_spatial > len(devices):
        # n_data can reach 0 via the -1 sentinel when n_spatial exceeds
        # the device count: an empty 0 x n mesh must not build silently
        raise ValueError(
            f"mesh {n_data}x{n_spatial} needs {max(n_data, 1) * n_spatial} "
            f"devices, have {len(devices)}"
        )
    grid = np.empty((n_data, n_spatial), dtype=object)
    for i, d in enumerate(devices[: n_data * n_spatial]):
        grid[i // n_spatial, i % n_spatial] = d
    return Mesh(grid)
