# Verbatim copy of icsg3d_tpu/ops/segmentation.py.
"""Atom extraction from segmented grids: recursive watershed clustering.

Host-side reimplementation of the reference's watershed.py with the same
algorithmic contract, built on scipy (this environment has no skimage):

1. connected-component labeling of the binary occupancy grid (6-connected,
   same-value connectivity like skimage.measure.label — watershed.py:56);
2. per-component convexity test: nonzero voxels / convex-hull voxels
   (watershed.py:81-87); convex blobs are single atoms;
3. non-convex blobs: erode, then connected components of the eroded cores
   become the split regions; the one-voxel rim eroded away is dropped with
   the background (the reference's marker flood re-attaches the rim only
   for its label-1 blob, watershed.py:98-111 — a divergence measured at
   0.0%% atom-count difference over the generated population,
   tools/validate_watershed.py);
4. recursion up to max_iters while (nonzero voxels)/wmin exceeds the object
   count (watershed.py:123-144);
5. per-region majority-vote species and centroid means
   (watershed.py:158-189) — with the grid size taken from the arrays, not
   hardcoded 32 (fixes watershed.py:178-180).

``watershed_flood`` (a vectorized Meyer-family priority flood) is exported
for callers that need a real marker flood; the production pipeline above
does not, because its markers already cover every voxel.
"""

from __future__ import annotations

from typing import List

import numpy as np
from scipy import ndimage


def ball(radius: int = 1) -> np.ndarray:
    """Euclidean ball structuring element (skimage.morphology.ball)."""
    r = int(radius)
    g = np.mgrid[-r : r + 1, -r : r + 1, -r : r + 1]
    return (np.sum(g**2, axis=0) <= r * r).astype(np.uint8)


_FACE = ndimage.generate_binary_structure(3, 1)  # 6-connectivity


def label_same_value(arr: np.ndarray, connectivity: int = 1) -> np.ndarray:
    """Connected components where neighbors with the SAME nonzero value
    connect (skimage.measure.label semantics on int arrays)."""
    struct = ndimage.generate_binary_structure(3, connectivity)
    out = np.zeros(arr.shape, dtype=np.int32)
    next_label = 0
    for v in np.unique(arr):
        if v == 0:
            continue
        lab, n = ndimage.label(arr == v, structure=struct)
        out[lab > 0] = lab[lab > 0] + next_label
        next_label += n
    return out


def erosion(arr: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Grayscale erosion matching skimage.morphology.erosion on {0, v} arrays."""
    return ndimage.grey_erosion(arr, footprint=kernel)


def dilation(arr: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    return ndimage.grey_dilation(arr, footprint=kernel)


def watershed_flood(elevation: np.ndarray, markers: np.ndarray) -> np.ndarray:
    """Marker-based watershed: flood basins from markers in elevation order.

    Lower elevations flood first (Meyer flooding, the algorithm family of
    skimage.segmentation.watershed); 6-connectivity; every reachable voxel
    ends in some basin.  Fully vectorized: each round claims the
    lowest-elevation frontier voxels via a label dilation.  Fast when the
    elevation takes few distinct values (each round claims whole level
    sets; a per-voxel Python priority queue measured 3 orders of magnitude
    slower on such inputs) — but on CONTINUOUS elevation fields with ~all-
    distinct values the rounds degenerate toward one voxel each and a heap
    flood wins instead (tools/validate_watershed.py keeps one).  Non-
    finite elevations flood last, as +inf (a NaN used to stall the
    frontier forever).  Tie-breaking among equal-elevation frontier voxels
    takes the max neighboring label (the classical implementation uses
    queue order); the split surfaces can differ by one voxel on exactly-
    equidistant boundaries.
    """
    elevation = np.where(np.isfinite(elevation), elevation, np.inf)
    out = markers.astype(np.int64).copy()
    while True:
        unlabeled = out == 0
        if not unlabeled.any():
            break
        grown = ndimage.grey_dilation(out, footprint=_FACE)
        frontier = unlabeled & (grown > 0)
        if not frontier.any():
            break  # disconnected voxels stay 0
        emin = elevation[frontier].min()
        take = frontier & (elevation <= emin)
        out[take] = grown[take]
    return out


_CONVEXITY_EXACT_MAX = 512  # exact voxel counting below this size


def convexity(mask: np.ndarray) -> float:
    """nonzero(mask) / voxels-in-convex-hull (watershed.py:81-82).

    Small regions use exact voxel-in-hull counting (Delaunay membership,
    matching skimage.convex_hull_image semantics).  Large regions use the
    hull VOLUME as the denominator — find_simplex over the bounding box is
    O(bbox * simplices) and measured 46 s on a 15k-voxel blob, while the
    volume ratio gives the same accept/split decision at the 0.8 threshold
    (hull volume and hull voxel count differ by a surface term that
    vanishes for large blobs).
    """
    pts = np.argwhere(mask != 0)
    n = len(pts)
    if n == 0:
        return 1.0
    if n <= 4:
        return 1.0  # too few voxels to be non-convex
    try:
        if n > _CONVEXITY_EXACT_MAX:
            from scipy.spatial import ConvexHull

            hull = ConvexHull(pts)
            # lattice points inside a convex body ~ volume + area/2
            # (Ehrhart surface term); without it the ratio overshoots by
            # ~n^(-1/3) and misclassifies mid-size dumbbells as convex
            hull_voxels = hull.volume + hull.area / 2.0 + 1.0
            return n / max(hull_voxels, 1.0)

        from scipy.spatial import Delaunay

        hull = Delaunay(pts)
    except Exception:
        return 1.0  # degenerate (coplanar/collinear) sets are convex
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    grid = np.mgrid[
        lo[0] : hi[0] + 1, lo[1] : hi[1] + 1, lo[2] : hi[2] + 1
    ].reshape(3, -1).T
    inside = hull.find_simplex(grid) >= 0
    hull_voxels = int(inside.sum())
    return n / max(hull_voxels, 1)


def _crop(a: np.ndarray, bbox) -> np.ndarray:
    return a[bbox[0] : bbox[3], bbox[1] : bbox[4], bbox[2] : bbox[5]]


def _bbox_of(mask: np.ndarray):
    idx = np.argwhere(mask)
    lo = idx.min(axis=0)
    hi = idx.max(axis=0) + 1
    return (lo[0], lo[1], lo[2], hi[0], hi[1], hi[2])


def segment_nuclei(
    binary: np.ndarray,
    species: np.ndarray,
    intensity: np.ndarray,
    wmin: int = 8,
    it: int = 1,
    max_iters: int = 5,
    min_convexity: float = 0.8,
) -> np.ndarray:
    """Recursive watershed segmentation (watershed.py:40-155).

    Returns R: integer region labels, 0 = background.
    """
    R = np.zeros(binary.shape, dtype=np.float64)
    binary = binary.astype(int)

    labels = label_same_value(binary, connectivity=1)
    seg_classes, seg_counts = np.unique(labels, return_counts=True)
    keep = [
        c for c, n in zip(seg_classes, seg_counts) if n > 3 and c != 0
    ]  # tiny blobs dropped (watershed.py:58-61)

    for cl in keep:
        mask = labels == cl
        bbox = _bbox_of(mask)
        binary_bbox = _crop(np.where(mask, labels, 0), bbox)
        intensity_bbox = _crop(np.where(mask, intensity, 0), bbox)
        species_bbox = _crop(np.where(mask, species, 0), bbox)

        conv = convexity(binary_bbox)
        if conv >= min_convexity:
            max_class = np.max(R)
            region = _crop(R, bbox)
            region[:] = np.where(binary_bbox == cl, max_class + 1, region)
            continue

        # markers from eroded foreground; background marker = 1
        kernel = ball(1)
        fg = erosion(binary_bbox, kernel)
        markers = label_same_value(fg.astype(int), connectivity=1) + 1
        # Rim divergence (quantified at population scale by
        # tools/validate_watershed.py): every non-foreground voxel here is
        # pre-marked background, so the eroded one-voxel rim is dropped
        # with the background basin for EVERY blob.  The reference zeroes
        # its "unknown" dilated-minus-eroded rim only when the blob's label
        # value is 1 (watershed.py:100-108, label-valued grids), flooding
        # that one blob's rim into the nearest basin and dropping all
        # others' — same centroids/species either way (the rim is a
        # symmetric one-voxel shell), slightly different region sizes.

        # No flood step: label_same_value assigns EVERY voxel a marker
        # (rim and background land in basin 1), so a flood would return
        # the markers unchanged — the effective algorithm here is
        # erosion-core connected components, with the one-voxel rim
        # dropped alongside the background basin (see rim note above;
        # 0.0%% population divergence vs the reference-faithful heap
        # flood on generated samples, tools/validate_watershed.py)
        wss = markers.astype(np.int64).copy()
        wss[wss == 1] = 0  # background basin
        max_class = np.max(R)
        wss = np.where(wss != 0, wss + max_class - 1, 0)  # compact labels
        nclasses = len(np.unique(wss)) - 1

        if int(np.count_nonzero(wss) / wmin) > nclasses and it < max_iters:
            Rp = segment_nuclei(
                wss, species_bbox, intensity_bbox,
                wmin=wmin, it=it + 1, max_iters=max_iters,
                min_convexity=min_convexity,
            )
            max_class = np.max(R)
            Rp = np.where(Rp != 0, Rp + max_class, 0)
            region = _crop(R, bbox)
            region[:] = np.where(Rp != 0, Rp, region)
        else:
            region = _crop(R, bbox)
            region[:] = np.where(wss != 0, wss, region)

    return R


def majority_vote(seg_img: np.ndarray, R: np.ndarray, cl) -> int:
    """Most frequent nonzero species inside region cl (watershed.py:158-167)."""
    values = seg_img[(R == cl)].astype(int)
    values = values[values != 0]
    if len(values) == 0:
        return 0
    unique, counts = np.unique(values, return_counts=True)
    return int(unique[np.argmax(counts)])


def centroids(seg_img: np.ndarray, R: np.ndarray):
    """Region centroids (voxel coordinates) + majority species
    (watershed.py:169-189; grid size from the array, not hardcoded)."""
    atoms: List[int] = []
    means: List[np.ndarray] = []
    for cl in np.unique(R):
        if cl == 0:
            continue
        specie = majority_vote(seg_img, R, cl)
        if specie == 0:
            continue
        pts = np.argwhere(R == cl).astype(float)
        atoms.append(specie)
        means.append(pts.mean(axis=0))
    return atoms, means


def watershed_clustering(
    M: np.ndarray,
    S: np.ndarray,
    Sb: np.ndarray,
    max_iters: int = 5,
    wmin: int = 8,
    min_convexity: float = 0.8,
    return_regions: bool = False,
):
    """Atoms (z numbers) + voxel-space centroids from density/species grids.

    Reference: watershed_clustering (watershed.py:192-203).
    """
    M = np.asarray(M).squeeze()
    S = np.asarray(S).squeeze()
    Sb = np.asarray(Sb).squeeze()
    R = segment_nuclei(
        Sb, S, M, wmin=wmin, max_iters=max_iters, min_convexity=min_convexity
    )
    atoms, means = centroids(S, R)
    if return_regions:
        return np.array(atoms), np.array(means), R
    return np.array(atoms), np.array(means)
