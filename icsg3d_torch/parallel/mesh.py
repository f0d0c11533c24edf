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

Data parallelism across processes: JAX's data axis spans every device of
every host, and ``shard_batch`` (mesh.py:77-90) lays the global batch's row
blocks over it.  The port runs one process per card (parallel/distributed.py),
so its data axis is the processes of a torch.distributed group times each
process's own mesh; ``shard_batch`` here gives a process its block of rows
of the global batch, which every process builds alike.  Not ported: the
GSPMD placement helpers ``batch_sharding`` and ``replicated``
(mesh.py:61-74), which name shardings of a global array for XLA's
partitioner; torch has no such array.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from icsg3d_torch.parallel.distributed import group_rank, group_size

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


def shard_batch(batch, group):
    """This process's rows of a global batch (a dict of arrays or tensors,
    or one of them): rank r of W takes the contiguous rows [r*B/W,
    (r+1)*B/W), as ``P("data")`` lays row blocks over the data axis in
    device order.  Rank-0 leaves (a scalar) are not split, as JAX
    replicates them.  ``group`` None (a single process) returns the batch
    as it is; a batch that W does not divide raises."""
    rank, world = group_rank(group), group_size(group)
    if world == 1:
        return batch

    def rows(x):
        if np.ndim(x) == 0:
            return x
        if len(x) % world:
            raise ValueError(f"a batch of {len(x)} rows does not split over "
                             f"{world} processes")
        k = len(x) // world
        return x[rank * k:(rank + 1) * k]

    return ({k: rows(v) for k, v in batch.items()} if isinstance(batch, dict)
            else rows(batch))
