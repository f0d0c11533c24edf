"""Device atom extraction, method "binary", batched over a leading dim.

Counterpart of the production path of icsg3d_tpu/ops/extract.py (the
``extract_atoms(..., method="binary")`` that ``apps/generate.py --fused``
runs): a device mirror of the reference's host pipeline.

1. Connected components of the BINARY occupancy mask by min-label
   propagation over the 6 face neighbors (rolls + wheres).
2. ``erosion_levels`` rounds of marker-erosion splitting: a region whose
   eroded mask holds >= 2 cores of >= ``wmin`` voxels is BFS-relabeled to
   its nearest core (watershed.py:98-111).
3. Regions of < ``min_voxels`` voxels dropped; the largest ``max_atoms``
   become atom slots; per-region majority-vote species and centroids by
   membership-matrix matmuls.

Each ``lax.while_loop`` of the JAX version is a Python loop here, with one
host sync per round to test for convergence.  A batch iterates until every
sample has converged; a converged sample is a fixed point of the round, so
the extra rounds leave it unchanged and batching does not alter results.
Shapes below: ``(N, d0, d1, d2)`` grids, int32 labels where each region's
label is the smallest flat voxel index it holds and background is n_vox.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _flat_index(shape, device) -> torch.Tensor:
    n = shape[0] * shape[1] * shape[2]
    return torch.arange(n, dtype=torch.int32, device=device).reshape(shape)


def _wrapped_row(shape, axis: int, shift: int, device) -> torch.Tensor:
    """Mask of the row a roll by ``shift`` (+-1) along grid ``axis`` wrapped
    around; broadcasts against (N, d0, d1, d2)."""
    d = shape[axis]
    idx = torch.arange(d, device=device)
    edge = idx == 0 if shift == 1 else idx == d - 1
    view = [1, 1, 1]
    view[axis] = d
    return edge.reshape(view)


def _neighbor_min_labels(labels, species, big):
    """Min over the 6 face neighbors' labels, restricted to same species;
    out-of-bounds and different-species neighbors contribute ``big``."""
    out = labels
    shape = labels.shape[1:]
    for axis in range(3):
        for shift in (1, -1):
            lab_n = torch.roll(labels, shift, dims=axis + 1)
            spe_n = torch.roll(species, shift, dims=axis + 1)
            edge = _wrapped_row(shape, axis, shift, labels.device)
            valid = (spe_n == species) & ~edge
            out = torch.minimum(out, torch.where(valid, lab_n, big))
    return out


def connected_components_same_value(species: torch.Tensor) -> torch.Tensor:
    """CC labels of nonzero-valued int grids (N, d0, d1, d2); background
    (0) -> n_vox.  Each component's label is its smallest flat index."""
    shape = species.shape[1:]
    n_vox = shape[0] * shape[1] * shape[2]
    big = torch.tensor(n_vox, dtype=torch.int32, device=species.device)
    species = species.to(torch.int32)
    fg = species > 0
    labels = torch.where(fg, _flat_index(shape, species.device), big)
    while True:
        new = torch.where(fg, _neighbor_min_labels(labels, species, big), big)
        if not bool((new != labels).any()):
            return new
        labels = new


def erode6(fg: torch.Tensor) -> torch.Tensor:
    """Binary erosion with the 6-neighbor ball(1) element (watershed.py:27-33)."""
    out = fg
    for axis in range(3):
        for shift in (1, -1):
            n = torch.roll(fg, shift, dims=axis + 1)
            edge = _wrapped_row(fg.shape[1:], axis, shift, fg.device)
            out = out & n & ~edge
    return out


def nearest_seed_labels(seeds, cc_labels, fg, seed_labels=None):
    """Relabel each foreground voxel to its nearest seed's label.

    Multi-source BFS (6-connectivity) restricted to each voxel's own
    ``cc_labels`` region; equidistant ties resolve by the fixed neighbor
    visit order, as in the JAX version.  Background and unreached voxels
    get n_vox.  ``seed_labels`` defaults to each seed's flat index.
    """
    shape = seeds.shape[1:]
    n_vox = shape[0] * shape[1] * shape[2]
    dev = seeds.device
    big = torch.tensor(n_vox, dtype=torch.int32, device=dev)
    if seed_labels is None:
        seed_labels = _flat_index(shape, dev).expand(seeds.shape)
    lab = torch.where(seeds & fg, seed_labels.to(torch.int32), big)
    dist = torch.where(seeds & fg, torch.zeros_like(big), big)
    while True:
        new_lab, new_dist = lab, dist
        for axis in range(3):
            for shift in (1, -1):
                lab_n = torch.roll(new_lab, shift, dims=axis + 1)
                dist_n = torch.roll(new_dist, shift, dims=axis + 1)
                cc_n = torch.roll(cc_labels, shift, dims=axis + 1)
                edge = _wrapped_row(shape, axis, shift, dev)
                valid = fg & ~edge & (cc_n == cc_labels) & (lab_n != big)
                cand = torch.where(valid, dist_n + 1, big)
                better = cand < new_dist
                new_lab = torch.where(better, lab_n, new_lab)
                new_dist = torch.where(better, cand, new_dist)
        changed = bool((new_dist != dist).any())
        lab, dist = new_lab, new_dist
        if not changed:
            return lab


def top_regions_by_size(
    labels_flat: torch.Tensor, k: int, min_size: int, n_vox: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-``k`` region labels by voxel count for each row of
    ``labels_flat`` (N, n_vox), by sort + run-length ranking.

    Returns (top_labels (N, k) int32 — n_vox for empty slots,
             top_sizes (N, k) float32,
             valid (N, k) bool — region exists with >= min_size voxels).
    Slots are size-descending; equal sizes keep the smaller label first
    (a stable sort, as ``lax.top_k`` prefers the earlier position).
    """
    n = labels_flat.shape[0]
    dev = labels_flat.device
    s, _ = torch.sort(labels_flat, dim=-1)
    iota = torch.arange(n_vox, dtype=torch.int32, device=dev)
    is_start = torch.cat(
        [torch.ones((n, 1), dtype=torch.bool, device=dev), s[:, 1:] != s[:, :-1]],
        dim=-1,
    )
    start_idx = torch.where(is_start, iota, n_vox)
    # suffix min of start_idx, shifted: the next run start strictly after i
    suffmin = torch.flip(torch.cummin(torch.flip(start_idx, (-1,)), -1).values, (-1,))
    nxt = torch.cat(
        [suffmin[:, 1:], torch.full((n, 1), n_vox, dtype=suffmin.dtype, device=dev)],
        dim=-1,
    )
    run_len = (nxt - iota).to(torch.float32)
    score = torch.where(
        is_start & (s < n_vox) & (run_len >= min_size), run_len,
        torch.tensor(float("-inf"), device=dev),
    )
    k_eff = min(k, n_vox)
    top_sizes, top_pos = torch.sort(score, dim=-1, descending=True, stable=True)
    top_sizes, top_pos = top_sizes[:, :k_eff], top_pos[:, :k_eff]
    valid = torch.isfinite(top_sizes)
    top_labels = torch.where(valid, torch.gather(s, 1, top_pos), n_vox).to(torch.int32)
    top_sizes = torch.where(valid, top_sizes, 0.0)
    if k_eff < k:
        pad = k - k_eff
        top_labels = torch.cat(
            [top_labels, torch.full((n, pad), n_vox, dtype=torch.int32, device=dev)], 1
        )
        top_sizes = torch.cat([top_sizes, torch.zeros((n, pad), device=dev)], 1)
        valid = torch.cat([valid, torch.zeros((n, pad), dtype=torch.bool, device=dev)], 1)
    return top_labels, top_sizes, valid


def split_by_erosion_cores(labels, eroded, fg, wmin: int = 8, max_cores: int = 128):
    """One level of the reference's marker split: regions of ``labels``
    whose eroded mask holds >= 2 cores of >= wmin voxels are BFS-relabeled
    to their nearest core; other regions are untouched.  Only the
    ``max_cores`` largest cores can act as markers."""
    shape = labels.shape[1:]
    n = labels.shape[0]
    n_vox = shape[0] * shape[1] * shape[2]
    cores = connected_components_same_value(eroded.to(torch.int32))
    cores_f = cores.reshape(n, -1)
    lab_f = labels.reshape(n, -1)
    fg_f = fg.reshape(n, -1)

    core_labels, _, core_ok = top_regions_by_size(cores_f, max_cores, wmin, n_vox)
    m_core = (cores_f[:, :, None] == core_labels[:, None, :]) & core_ok[:, None, :]
    valid_core_v = m_core.any(dim=-1)
    # each valid core's region = labels at the core's root voxel
    root = torch.clamp(core_labels, max=n_vox - 1).long()
    core_region = torch.where(core_ok, torch.gather(lab_f, 1, root), n_vox)
    cores_in_region = (
        (lab_f[:, :, None] == core_region[:, None, :]) & core_ok[:, None, :]
    ).sum(dim=-1)
    region_splits = fg_f & (cores_in_region >= 2)
    # seeds: valid-core voxels of splitting regions keep their core label;
    # every voxel of a non-splitting region is its own seed (region label)
    seed = fg_f & torch.where(region_splits, valid_core_v, True)
    seed_labels = torch.where(region_splits, cores_f, lab_f)
    return nearest_seed_labels(
        seed.reshape(labels.shape), labels, fg, seed_labels.reshape(labels.shape)
    )


def extract_atoms(
    species: torch.Tensor,   # (N, d, d, d) int labels (0 = background)
    mask: torch.Tensor,      # (N, d, d, d) binary occupancy
    max_atoms: int = 64,
    min_voxels: int = 4,
    erosion_levels: int = 1,
    wmin: int = 8,
    vote_classes: int = 95,
):
    """Fixed-shape atom extraction over a batch of grids: the JAX
    ``extract_atoms(density, species, mask, method="binary", ...)``, whose
    density input the binary method never reads.

    Returns (atoms (N, max_atoms) int32 — 0 for empty slots,
             centroids (N, max_atoms, 3) float32 voxel coordinates,
             valid (N, max_atoms) bool).
    """
    n = species.shape[0]
    shape = species.shape[1:]
    n_vox = shape[0] * shape[1] * shape[2]
    dev = species.device
    fg = mask > 0
    spec = torch.where(fg, species.to(torch.int32), 0)
    lab3 = connected_components_same_value(fg.to(torch.int32))
    er = fg
    for _ in range(erosion_levels):
        er = erode6(er)
        lab3 = split_by_erosion_cores(lab3, er, fg, wmin=wmin)
    spec_f = spec.reshape(n, -1)
    fg_f = fg.reshape(n, -1)
    labels = torch.where(fg_f, lab3.reshape(n, -1), n_vox)
    top_idx, _, slot_valid = top_regions_by_size(labels, max_atoms, min_voxels, n_vox)

    # voxel -> slot membership, reduced by matmuls (exact: 0/1 and small
    # integer operands, f32 accumulation)
    match = (labels[:, :, None] == top_idx[:, None, :]) & slot_valid[:, None, :]
    mf_t = match.to(torch.float32).transpose(1, 2)       # (N, max_atoms, n_vox)
    g = torch.meshgrid(
        *(torch.arange(s, dtype=torch.float32, device=dev) for s in shape),
        indexing="ij",
    )
    coords = torch.stack([c.reshape(-1) for c in g], dim=-1)   # (n_vox, 3)
    slot_counts = mf_t.sum(dim=-1)                       # (N, max_atoms)
    centroids = (mf_t @ coords) / torch.clamp(slot_counts[..., None], min=1.0)

    # majority-vote species per region over nonzero classes
    # (watershed.py:158-167); out-of-range labels vote for nothing
    classes = torch.arange(vote_classes, dtype=torch.int32, device=dev)
    onehot = (spec_f[:, :, None] == classes).to(torch.float32)
    votes = mf_t @ onehot                                # (N, max_atoms, classes)
    votes[:, :, 0] = 0.0
    atoms = torch.where(
        slot_valid & (votes.amax(dim=-1) > 0), votes.argmax(dim=-1), 0
    ).to(torch.int32)
    valid = slot_valid & (slot_counts > 0) & (atoms > 0)
    atoms = torch.where(valid, atoms, 0)
    centroids = torch.where(valid[..., None], centroids, 0.0)
    return atoms, centroids, valid
