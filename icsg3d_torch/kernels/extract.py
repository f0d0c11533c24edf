"""The device extraction's two loops as Hopper kernels, and their loader.

E1 replaces the ``lax.while_loop`` of ``icsg3d_tpu/ops/extract.py::
connected_components_same_value`` (extract.py:104): min-index labels of
6-connected, same-valued, nonzero components.  E2 replaces the one of
``nearest_seed_labels`` (extract.py:221): the multi-source BFS that
relabels each foreground voxel to its nearest seed inside its region,
ties to the first arrival in the plain version's sweep order.

Both kernels (``icsg3d_torch/csrc/extract.cu``) run a whole loop in one
launch: one block per sample iterates until its sample has converged,
with a block-wide convergence flag that the host never reads, where the
plain versions (``ops/extract.py``'s ``*_reference``) launch dozens of
small kernels and read "has anything changed" on the host every round.
What bounds them is rounds x the latency of one pass over the sample's
grid, not the bytes (8 per voxel for E1, 14 for E2), so the sample's
state sits in the block's shared memory where it fits (``state_path``:
32^3, the generation grid, does for both) and in device memory, which the
L2 holds, above that; in shared memory E2's state is XOR-swizzled by row
(``state_index``) so that a warp's walks along the contiguous axis fall
in 32 banks.  E1 updates labels in place with a pointer jump (any schedule
reaches the unique fixed point, so its passes are fewer than the plain
version's rounds); E2 repeats the plain version's six Jacobi sweeps per
round, one thread walking each line against the sweep's shift
(``SWEEPS``, ``line_starts``), so its labels and rounds are the plain
version's.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``icsg3d_torch/_build/`` on first use (kernels/_nvcc.py), loaded with
ctypes.  Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from icsg3d_torch.kernels._nvcc import PKG, build_library

SOURCE = PKG / "csrc" / "extract.cu"

# E2's sweeps in the order of a round: (axis of the (d0, d1, d2) grid,
# shift).  Bit k of a voxel's neighbour byte belongs to sweep k.
SWEEPS = ((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1))
MAX_VOXELS = 0x7FFFFFF0  # per sample: labels, n_vox and the round cap fit an int
SMEM_MAX = 232448  # dynamic shared memory a block may have (bytes)
# shared-memory bytes of state per voxel: E1 int32 labels + neighbour
# byte; E2 int32 labels + uint16 distances + neighbour byte
SMEM_PER_VOXEL = {"cc": 5, "bfs": 7}

# Incremented once per kernel launch, never by the plain versions.
launches_cc = 0
launches_bfs = 0

_lib = None


def reset_launches() -> None:
    global launches_cc, launches_bfs
    launches_cc = 0
    launches_bfs = 0


def build() -> Path:
    """Compile ``csrc/extract.cu`` for sm_90a; returns the library path."""
    return build_library(SOURCE, "libextract")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.extract_cc.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.extract_cc.restype = ctypes.c_int
        lib.extract_bfs.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.extract_bfs.restype = ctypes.c_int
        _lib = lib
    return _lib


def state_path(kind: str, n_vox: int) -> str:
    """Where kernel ``kind`` ("cc" or "bfs") keeps a sample's state of
    ``n_vox`` voxels: "shared" (shared memory) or "global" (device
    memory); the twin of ``cc_in_smem``/``bfs_in_smem`` in the source.
    E2's shared distances are uint16, so that path also needs n_vox <=
    65535."""
    fits = SMEM_PER_VOXEL[kind] * n_vox <= SMEM_MAX
    if kind == "bfs":
        fits = fits and n_vox <= 65535
    return "shared" if fits else "global"


def state_index(shape, path: str) -> np.ndarray:
    """Where E2 keeps voxel v's state, for every flat index v of a (d0, d1,
    d2) grid: row r = i0 * d1 + i1, column c = i2, at r * d2 + (c ^ (r &
    sw)), sw the largest power of two dividing d2 (at most 32) less one in
    shared memory, 0 in device memory (the twin of the kernel's ``at``)."""
    d0, d1, d2 = shape
    low = d2 & -d2
    sw = min(low, 32) - 1 if path == "shared" else 0
    v = np.arange(d0 * d1 * d2)
    r, c = v // d2, v % d2
    return r * d2 + (c ^ (r & sw))


def line_starts(shape, axis: int) -> np.ndarray:
    """The flat index of the first voxel of each line along ``axis`` of a
    (d0, d1, d2) grid, in the order of the kernel's line index (line l's
    voxels are start + i * stride(axis), i < shape[axis])."""
    d0, d1, d2 = shape
    lines = np.arange(d0 * d1 * d2 // shape[axis])
    if axis == 0:
        return lines
    if axis == 1:
        i0 = lines // d2
        return i0 * d1 * d2 + (lines - i0 * d2)
    return lines * d2


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"the extraction kernels need CUDA tensors; {name} is on "
                         f"{t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the grid on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _grid(t: torch.Tensor, name: str):
    if t.dim() != 4 or min(t.shape) < 1:
        raise ValueError(f"{name} must be a non-empty (N, d0, d1, d2) grid, got "
                         f"{tuple(t.shape)}")
    n, d0, d1, d2 = t.shape
    if d0 * d1 * d2 > MAX_VOXELS:
        raise ValueError(f"{name}: {d0 * d1 * d2} voxels per sample, the kernels "
                         f"take at most {MAX_VOXELS}")
    return n, d0, d1, d2


def connected_components_cuda(species: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """E1 on a (N, d0, d1, d2) contiguous int32 CUDA grid: returns (labels,
    int32 like ``species``: each 6-connected, same-valued, nonzero
    component's smallest flat index, background n_vox; rounds, (N,) int32
    passes each sample took, -1 if it hit the cap).  One launch, counted in
    ``launches_cc``; nothing is read back to the host.  Raises on anything
    else; never falls back."""
    global launches_cc
    _check("species", species, torch.int32, species.shape, species.device)
    n, d0, d1, d2 = _grid(species, "species")
    dev = species.device
    labels = torch.empty_like(species)
    bits = torch.empty(species.shape, dtype=torch.uint8, device=dev)
    rounds = torch.empty(n, dtype=torch.int32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.extract_cc(species.data_ptr(), labels.data_ptr(), bits.data_ptr(),
                             rounds.data_ptr(), n, d0, d1, d2, stream)
    if err != 0:
        raise RuntimeError(f"extract_cc kernel launch failed: CUDA error {err}")
    launches_cc += 1
    return labels, rounds


def nearest_seed_labels_cuda(seeds: torch.Tensor, cc_labels: torch.Tensor,
                             fg: torch.Tensor, seed_labels: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E2: ``seeds`` and ``fg`` (N, d0, d1, d2) bool, ``cc_labels`` and
    ``seed_labels`` (None: each seed's flat index) int32, all contiguous on
    one CUDA device.  Returns (labels int32: each foreground voxel's
    nearest seed's label within its cc region, ties to the plain version's
    first arrival, n_vox for background and unreached voxels; rounds, (N,)
    int32 rounds each sample ran, the plain version's schedule, -1 if it
    hit the cap).  One launch, counted in ``launches_bfs``.  Raises on
    anything else; never falls back."""
    global launches_bfs
    dev = cc_labels.device
    _check("cc_labels", cc_labels, torch.int32, cc_labels.shape, dev)
    n, d0, d1, d2 = _grid(cc_labels, "cc_labels")
    _check("seeds", seeds, torch.bool, cc_labels.shape, dev)
    _check("fg", fg, torch.bool, cc_labels.shape, dev)
    if seed_labels is not None:
        _check("seed_labels", seed_labels, torch.int32, cc_labels.shape, dev)
    labels = torch.empty_like(cc_labels)
    dist = torch.empty_like(cc_labels)
    bits = torch.empty(cc_labels.shape, dtype=torch.uint8, device=dev)
    rounds = torch.empty(n, dtype=torch.int32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.extract_bfs(
            seeds.data_ptr(), cc_labels.data_ptr(), fg.data_ptr(),
            None if seed_labels is None else seed_labels.data_ptr(),
            labels.data_ptr(), dist.data_ptr(), bits.data_ptr(), rounds.data_ptr(),
            n, d0, d1, d2, stream)
    if err != 0:
        raise RuntimeError(f"extract_bfs kernel launch failed: CUDA error {err}")
    launches_bfs += 1
    return labels, rounds
