"""The device extraction's two loops as Hopper kernels, their plan and
their loader.

E1 replaces the ``lax.while_loop`` of ``icsg3d_tpu/ops/extract.py::
connected_components_same_value`` (extract.py:104): min-index labels of
6-connected, same-valued, nonzero components.  E2 replaces the one of
``nearest_seed_labels`` (extract.py:221): the multi-source BFS that
relabels each foreground voxel to its nearest seed inside its region,
ties to the first arrival in the plain version's sweep order.

Both kernels (``icsg3d_torch/csrc/extract.cu``) run a whole loop in one
launch, where the plain versions (``ops/extract.py``'s ``*_reference``)
launch dozens of small kernels and read "has anything changed" on the
host every round.  What bounds them is rounds x the latency of one round,
not bytes, so each sample gets a thread-block cluster of C CTAs
(``plan``): the sample is cut along axis 0 into C slabs, one per CTA,
each slab's state in its CTA's shared memory (``state_index``), a voxel
across the cut read through distributed shared memory, and the
convergence flag an OR over the cluster that the host never reads.  C
is the smallest size whose CTAs hold the sample's state, grown while the
batch's clusters still run at once, so a small batch spreads over many
SMs; a grid whose state does not fit 16 CTAs keeps it in device memory
(``path == "global"``).  E1 is a lock-free union-find (parents always
point to smaller indices, so each root is its component's least index,
the plain version's label; ``rounds`` counts merge passes, 1 unless its
check found a lost link).  E2 repeats the plain version's six Jacobi
sweeps per round (``SWEEPS``) as per-voxel two-phase updates over chunks
of ``THREADS * GROUP * VOXELS`` slots, run against the sweep's shift
(each thread a group of 4 consecutive slots, read with vector loads); a
round
begins by copying the planes across both cuts into halos, so it takes
two cluster barriers.  Its labels and rounds are the plain version's.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``icsg3d_torch/_build/`` on first use (kernels/_nvcc.py), loaded with
ctypes.  Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from icsg3d_torch.kernels._nvcc import PKG, build_library

SOURCE = PKG / "csrc" / "extract.cu"

# E2's sweeps in the order of a round: (axis of the (d0, d1, d2) grid,
# shift).  Bit k of a voxel's neighbour byte belongs to sweep k.
SWEEPS = ((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1))
MAX_VOXELS = 0x7FFFFFF0  # per sample: labels, n_vox and the round cap fit an int
THREADS = 1024  # threads per CTA (NT in the source)
VOXELS = 4  # E2: a thread's group of consecutive slots (V)
GROUP = 2  # E2: groups a thread holds between a chunk's reads and writes (G)
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is a non-portable cluster size
SMEM_PER_CTA = 232448  # shared memory one CTA may have (bytes)
FLAG_BYTES = 2 * 16 * 4  # every CTA's convergence flag, two rounds by parity

# Incremented once per kernel launch, never by the plain versions.
launches_cc = 0
launches_bfs = 0

_lib = None


class Plan(NamedTuple):
    cluster: int  # CTAs per sample, one slab of shape[0] // cluster planes each
    path: str  # "shared": the state in the CTAs' shared memory; "global": device memory
    smem_bytes_per_cta: int
    dist_bytes: int  # E2's bytes per distance (2 or 4); 0 for E1


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
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.extract_cc.argtypes = [vp] * 4 + [ci] * 7 + [vp]
        lib.extract_cc.restype = ci
        lib.extract_bfs.argtypes = [vp] * 8 + [ci] * 8 + [vp]
        lib.extract_bfs.restype = ci
        lib.extract_max_active_clusters.argtypes = [ci] * 5 + [ctypes.POINTER(ci)]
        lib.extract_max_active_clusters.restype = ci
        _lib = lib
    return _lib


def _a16(b: int) -> int:
    return (b + 15) // 16 * 16


def dist_bytes(kind: str, n_vox: int, path: str = "shared") -> int:
    """E2's bytes per distance: uint16 in shared memory while n_vox (the
    unreached value) fits, else int32; 0 for E1 ("cc")."""
    if kind == "cc":
        return 0
    return 2 if path == "shared" and n_vox <= 65535 else 4


def smem_bytes(kind: str, shape, cluster: int, path: str = "shared") -> int:
    """Shared memory per CTA of kernel ``kind`` ("cc" E1, "bfs" E2) when a
    (d0, d1, d2) sample is cut into ``cluster`` slabs: the twin of
    ``cc_smem``/``bfs_smem`` in the source.  E1: flags, int32 parents and
    a neighbour byte per voxel; E2: flags, int32 labels, distances and a
    neighbour byte per voxel, and with more than one slab two halo planes
    of labels and distances.  On the device-memory path only the flags."""
    if path == "global":
        return FLAG_BYTES
    d0, d1, d2 = shape
    slab, plane = d0 * d1 * d2 // cluster, d1 * d2
    if kind == "cc":
        return FLAG_BYTES + _a16(4 * slab) + _a16(slab)
    db = dist_bytes(kind, d0 * d1 * d2)
    b = FLAG_BYTES + _a16(4 * slab) + _a16(db * slab) + _a16(slab)
    if cluster > 1:
        b += 2 * (_a16(4 * plane) + _a16(db * plane))
    return b


def plan(kind: str, batch: int, shape, max_active_clusters: Callable[[int, int, str], int],
         cluster: Optional[int] = None) -> Plan:
    """The launch plan of kernel ``kind`` ("cc" E1, "bfs" E2) on ``batch``
    samples of a (d0, d1, d2) grid.

    Cluster sizes are the powers of two 1..16 dividing d0.  The plan takes
    the smallest whose CTAs each hold their slab's state within
    ``SMEM_PER_CTA`` and which the card can run at all, then grows it
    while ``batch`` clusters of the next size still run at once, so that a
    small batch spreads over the card's SMs.  ``max_active_clusters(c,
    smem_bytes, path)`` is how many clusters of c CTAs the card runs at
    once (on the card ``cudaOccupancyMaxActiveClusters``; tests pass a
    model).  No size holding the state: the device-memory path, its size
    grown the same way from 1.  ``cluster`` forces the size (it must divide
    d0; the path is then "shared" if it holds the state)."""
    if kind not in ("cc", "bfs"):
        raise ValueError(f"kind must be 'cc' or 'bfs', got {kind!r}")
    d0, d1, d2 = (int(s) for s in shape)
    n_vox = d0 * d1 * d2
    sizes = [c for c in CLUSTER_SIZES if d0 % c == 0]

    def on_chip(c):
        s = smem_bytes(kind, shape, c)
        return s <= SMEM_PER_CTA and max_active_clusters(c, s, "shared") >= 1

    def make(c, path):
        return Plan(c, path, smem_bytes(kind, shape, c, path), dist_bytes(kind, n_vox, path))

    if cluster is not None:
        if cluster not in sizes:
            raise ValueError(f"cluster {cluster} must be one of {CLUSTER_SIZES} dividing "
                             f"d0 = {d0}")
        return make(cluster, "shared" if on_chip(cluster) else "global")
    fits = [c for c in sizes if on_chip(c)]
    path = "shared" if fits else "global"
    pool = fits or [c for c in sizes
                    if max_active_clusters(c, smem_bytes(kind, shape, c, path), path) >= 1]
    if not pool:
        raise ValueError(f"no cluster size runs {kind} on a {shape} grid")
    chosen = pool[0]
    for c in pool[1:]:
        if max_active_clusters(c, smem_bytes(kind, shape, c, path), path) < batch:
            break
        chosen = c
    return make(chosen, path)


@functools.lru_cache(maxsize=None)
def _active(kind: str, cluster: int, smem: int, path: str, db: int, device: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = load().extract_max_active_clusters(
            0 if kind == "cc" else 1, cluster, int(path == "shared"), smem, db,
            ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed for {kind} at cluster "
                           f"{cluster}, {smem} B: CUDA error {err}")
    return out.value


def max_active_clusters(kind: str, n_vox: int, device) -> Callable[[int, int, str], int]:
    """The card's ``max_active_clusters`` for ``plan``: queried once per
    (cluster size, shared memory, path) and device, then cached."""
    index = device if isinstance(device, int) else torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return lambda c, smem, path: _active(kind, c, smem, path,
                                         dist_bytes(kind, n_vox, path), index)


@functools.lru_cache(maxsize=256)
def _launch_plan(kind: str, batch: int, shape, device: int, cluster: Optional[int]) -> Plan:
    n_vox = shape[0] * shape[1] * shape[2]
    return plan(kind, batch, shape, max_active_clusters(kind, n_vox, device), cluster)


def launch_plan(kind: str, grid: torch.Tensor, cluster: Optional[int] = None) -> Plan:
    """The plan the wrappers launch with for the (N, d0, d1, d2) CUDA
    tensor ``grid``; made once per kind, batch, shape, device and forced
    size (the plan's Python would otherwise cost each call tens of
    microseconds, the time of a kernel)."""
    n, d0, d1, d2 = grid.shape
    index = grid.device.index
    index = torch.cuda.current_device() if index is None else index
    return _launch_plan(kind, n, (d0, d1, d2), index, cluster)


def state_index(shape, cluster: int) -> Tuple[np.ndarray, np.ndarray]:
    """Where the kernels keep voxel v's state, for every flat index v of a
    (d0, d1, d2) grid cut into ``cluster`` slabs: (CTA rank, slot), rank
    v // slab and slot v % slab, slab = d0 d1 d2 / cluster (the twin of
    the kernels' ``first`` and ``vl``).  Thread t of a CTA holds slots c0
    + j * THREADS + t, so a warp's lanes hold consecutive slots."""
    d0, d1, d2 = shape
    slab = d0 * d1 * d2 // cluster
    v = np.arange(d0 * d1 * d2)
    return v // slab, v % slab


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


def connected_components_cuda(species: torch.Tensor, *, cluster: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E1 on a (N, d0, d1, d2) contiguous int32 CUDA grid: returns (labels,
    int32 like ``species``: each 6-connected, same-valued, nonzero
    component's smallest flat index, background n_vox; rounds, (N,) int32
    merge passes each sample took, -1 if it hit the cap).  ``cluster``
    forces ``plan``'s cluster size.  One launch, counted in
    ``launches_cc``; nothing is read back to the host.  Raises on anything
    else, and on a refused launch; never falls back."""
    global launches_cc
    _check("species", species, torch.int32, species.shape, species.device)
    n, d0, d1, d2 = _grid(species, "species")
    dev = species.device
    p = launch_plan("cc", species, cluster)
    labels = torch.empty_like(species)
    bits = (torch.empty(species.shape, dtype=torch.uint8, device=dev)
            if p.path == "global" else None)
    rounds = torch.empty(n, dtype=torch.int32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.extract_cc(species.data_ptr(), labels.data_ptr(),
                             None if bits is None else bits.data_ptr(), rounds.data_ptr(),
                             n, d0, d1, d2, p.cluster, int(p.path == "shared"),
                             p.smem_bytes_per_cta, stream)
    if err != 0:
        raise RuntimeError(f"extract_cc kernel launch failed on {p}: CUDA error {err}")
    launches_cc += 1
    return labels, rounds


def nearest_seed_labels_cuda(seeds: torch.Tensor, cc_labels: torch.Tensor,
                             fg: torch.Tensor, seed_labels: Optional[torch.Tensor] = None,
                             *, cluster: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E2: ``seeds`` and ``fg`` (N, d0, d1, d2) bool, ``cc_labels`` and
    ``seed_labels`` (None: each seed's flat index) int32, all contiguous on
    one CUDA device.  Returns (labels int32: each foreground voxel's
    nearest seed's label within its cc region, ties to the plain version's
    first arrival, n_vox for background and unreached voxels; rounds, (N,)
    int32 rounds each sample ran, the plain version's schedule, -1 if it
    hit the cap).  ``cluster`` forces ``plan``'s cluster size.  One launch,
    counted in ``launches_bfs``.  Raises on anything else, and on a
    refused launch; never falls back."""
    global launches_bfs
    dev = cc_labels.device
    _check("cc_labels", cc_labels, torch.int32, cc_labels.shape, dev)
    n, d0, d1, d2 = _grid(cc_labels, "cc_labels")
    _check("seeds", seeds, torch.bool, cc_labels.shape, dev)
    _check("fg", fg, torch.bool, cc_labels.shape, dev)
    if seed_labels is not None:
        _check("seed_labels", seed_labels, torch.int32, cc_labels.shape, dev)
    p = launch_plan("bfs", cc_labels, cluster)
    labels = torch.empty_like(cc_labels)
    dist = bits = None
    if p.path == "global":  # distances, then each CTA's halos: 4 planes of int32
        dist = torch.empty(n * d0 * d1 * d2 + 4 * n * p.cluster * d1 * d2,
                           dtype=torch.int32, device=dev)
        bits = torch.empty(cc_labels.shape, dtype=torch.uint8, device=dev)
    rounds = torch.empty(n, dtype=torch.int32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.extract_bfs(
            seeds.data_ptr(), cc_labels.data_ptr(), fg.data_ptr(),
            None if seed_labels is None else seed_labels.data_ptr(),
            labels.data_ptr(), None if dist is None else dist.data_ptr(),
            None if bits is None else bits.data_ptr(), rounds.data_ptr(),
            n, d0, d1, d2, p.cluster, int(p.path == "shared"), p.smem_bytes_per_cta,
            p.dist_bytes, stream)
    if err != 0:
        raise RuntimeError(f"extract_bfs kernel launch failed on {p}: CUDA error {err}")
    launches_bfs += 1
    return labels, rounds
