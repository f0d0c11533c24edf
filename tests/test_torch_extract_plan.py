"""The extraction kernels' schedules and plan, replayed in numpy: no GPU,
no JAX.

The kernels (``icsg3d_torch/csrc/extract.cu``) run only on the card
(``tests/test_torch_cuda.py``); here what makes their labels the plain
versions' (``icsg3d_torch/ops/extract.py``'s ``*_reference``) is checked,
at every cluster size ``kernels/extract.plan`` may pick (1, 2, 4, 8, 16
slabs along axis 0, those dividing d0):

- (a) E1, connected components: the kernel's union-find (first parents
  from each warp's run starts along axis 2, unions over the axis-1 edges
  whose twin at v - 1 is absent, every entry to its root, the same over
  the axis-0 edges; atomicMin links that retry from what they found,
  path-halving finds, compression to the roots, a check of every face
  edge) gives the plain version's labels bitwise in
  one merge pass, in the kernel's order and in seeded orders whose
  groups of unions all read their roots before any links (the races of a
  warp's lanes);
- (b) E2, the nearest-seed BFS: the kernel's per-voxel two-phase sweeps
  in ``kernels/extract.SWEEPS`` order, chunks of THREADS x GROUP slots
  run against the sweep's shift, slabs reading the plane across each cut
  from a halo copied before the sweep, give the plain version's labels
  and, sample by sample, its round count over the batch (also with small
  chunks, so that every grid here has several);
- (c) the plan: its cluster sizes and paths at the generation grid
  (32^3 at batch 1, 4, 20, 128) and at 64^3 and 96^3 against a model of
  the card's active clusters, every CTA's shared memory within 232,448
  bytes, a 64^3 sample's state on chip for both kernels, the slabs
  covering every voxel once, and a warp's reads free of bank conflicts.

Cases: the blob fixtures of tests/test_torch_extract.py, the adversarial
masks (empty, full, a one-voxel-wide snake, a multi-valued grid,
equidistant seeds), a non-cubic grid, the adversarial masks at 16^3 (all
five cluster sizes), and a bounded hypothesis search over random masks.
The case builders here are shared with tests/test_torch_extract.py (JAX
parity) and tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from icsg3d_torch.kernels import extract as kext
from icsg3d_torch.ops import extract as textract

torch.set_num_threads(1)

THREADS, GROUP = kext.THREADS, kext.GROUP
# clusters an H100 SXM (132 SMs) runs at once by cluster size, as
# cudaOccupancyMaxActiveClusters reports for both kernels (one 1024-thread
# CTA per SM, a cluster within one GPC), whatever the shared memory
H100_ACTIVE = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


def card(cluster, smem, path):
    """The plan's ``max_active_clusters`` on the modelled card."""
    return H100_ACTIVE[cluster] if smem <= kext.SMEM_PER_CTA else 0


def sizes(d0):
    """The cluster sizes the plan may take for a grid of d0 planes."""
    return [c for c in kext.CLUSTER_SIZES if d0 % c == 0]


# ---------------------------------------------------------------- cases

def gaussian_blob(d, center, sigma=1.5):
    g = np.mgrid[:d, :d, :d].astype(float)
    d2 = sum((g[i] - center[i]) ** 2 for i in range(3))
    return np.exp(-d2 / (2 * sigma**2))


def _single_blob():
    M = gaussian_blob(16, (8, 8, 8))
    Sb = (M > 0.1).astype(np.int32)
    return M, np.where(Sb, 26, 0), Sb


def _two_blobs():
    M = gaussian_blob(20, (5, 5, 5)) + gaussian_blob(20, (14, 14, 14))
    Sb = (M > 0.1).astype(np.int32)
    return M, np.where(Sb, 8, 0), Sb


def _dumbbell():
    M = gaussian_blob(26, (8, 13, 13), 2.0) + gaussian_blob(26, (17, 13, 13), 2.0)
    Sb = (M > 0.08).astype(np.int32)
    return M, np.where(Sb, 13, 0), Sb


def _species_confused():
    M = gaussian_blob(24, (12, 12, 12), 3.0)
    Sb = (M > 0.08).astype(np.int32)
    S = np.where(Sb, 26, 0)
    rng = np.random.default_rng(0)
    S[(rng.random(S.shape) < 0.3) & (Sb > 0)] = 25
    return M, S, Sb


def _empty():
    z = np.zeros((8, 8, 8))
    return z, z.astype(np.int32), z.astype(np.int32)


# (density, species, binary mask) of one sample, the extraction fixtures
BLOB_CASES = {
    "single_blob": _single_blob,
    "two_blobs": _two_blobs,
    "dumbbell": _dumbbell,
    "species_confused": _species_confused,
    "empty": _empty,
}


def snake(shape):
    """A one-voxel-wide path through a (d0, d1, d2) grid, the longest
    geodesic it holds: rows along axis 2 at even (i0, i1), joined end to
    end, each plane joined to the next at its last row."""
    d0, d1, d2 = shape
    m = np.zeros(shape, bool)
    cur = [0, 0, 0]
    m[0, 0, 0] = True

    def go(axis, to):
        while cur[axis] != to:
            cur[axis] += 1 if to > cur[axis] else -1
            m[tuple(cur)] = True

    rows = list(range(0, d1, 2))
    for p, i0 in enumerate(range(0, d0, 2)):
        go(0, i0)
        for i1 in (rows if p % 2 == 0 else rows[::-1]):
            go(1, i1)
            go(2, d2 - 1 if cur[2] == 0 else 0)
    return m


def blob_masks(n, shape, seed, thr=0.3):
    """n binary masks of a few Gaussian blobs each (decoded-grid-like)."""
    rng = np.random.default_rng(seed)
    g = np.mgrid[:shape[0], :shape[1], :shape[2]].astype(np.float32)
    out = np.zeros((n,) + tuple(shape), np.float32)
    for i in range(n):
        for c in rng.uniform(0, np.array(shape), (int(rng.integers(3, 9)), 3)):
            out[i] += np.exp(-((g - c[:, None, None, None]) ** 2).sum(0) / 3.0)
    return out > thr


def tie_case(shape=(9, 11, 9)):
    """A box of foreground with two seeds the same distance from its
    middle plane: every voxel there is a tie that the sweep order breaks."""
    fg = np.zeros(shape, bool)
    fg[1:-1, 1:-1, 1:-1] = True
    seeds = np.zeros(shape, bool)
    mid, c1, c2 = (s // 2 for s in shape)
    seeds[2, c1, c2] = seeds[2 * mid - 2, c1, c2] = True  # mid -+ (mid - 2)
    return fg, seeds


def adversarial(d=None, shape=None):
    """The adversarial grids, one sample each: name -> (E1 operand int32,
    E2 seeds bool, or None for the erosion split's seeds; the full grid
    is seeded at two opposite corners, the snake at one end).  ``d`` None:
    small non-cubic shapes for the CPU; an int: d^3 (the card's 32) for
    all but the non-cubic grid, which stays (9, 12, 15); ``shape`` (d0,
    d1, d2) likewise."""
    shp = ((lambda s: s) if d is None and shape is None
           else (lambda s: tuple(shape) if shape else (d, d, d)))
    rng = np.random.default_rng(7)
    fg_tie, seeds_tie = tie_case(shp((9, 11, 9)))
    corners = np.zeros(shp((6, 7, 8)), bool)
    corners[0, 0, 0] = corners[-1, -1, -1] = True
    start = np.zeros(shp((7, 8, 9)), bool)
    start[0, 0, 0] = True  # one end of the snake
    return {
        "empty": (np.zeros(shp((6, 7, 8)), np.int32), None),
        "full": (np.ones(shp((6, 7, 8)), np.int32), corners),
        "snake": (snake(shp((7, 8, 9))).astype(np.int32), start),
        "multi": (rng.integers(0, 4, shp((6, 7, 8))).astype(np.int32), None),
        "tie": (fg_tie.astype(np.int32), seeds_tie),
        "noncubic": (blob_masks(1, (9, 12, 15), 3)[0].astype(np.int32), None),
    }


def bfs_operands(species, seeds=None):
    """The E2 operands the extraction builds from an E1 operand (N, d0, d1,
    d2): fg = species > 0, cc its plain-version components, and either the
    given seeds with their flat indices as labels, or the erosion split's
    seeds and labels (``erosion_split_seeds``).  Torch tensors on the
    species' device: (seeds, cc, fg, seed_labels or None)."""
    fg = species > 0
    cc = textract.connected_components_reference(species)
    if seeds is not None:
        return seeds, cc, fg, None
    cores = textract.connected_components_reference(
        textract.erode6(fg).to(torch.int32))
    seed, seed_labels = textract.erosion_split_seeds(cc, cores, fg)
    return seed, cc, fg, seed_labels


# ---------------------------------------------------------------- replays

def _strides(shape):
    return (shape[1] * shape[2], shape[2], 1)


def cc_neighbours(sp):
    """Each voxel's same-valued, nonzero face neighbours inside the grid,
    in the kernel's bit order (-i0, +i0, -i1, +i1, -i2, +i2): (n, 6) flat
    indices, -1 where the bit is clear."""
    shape = sp.shape
    flat = sp.reshape(-1)
    idx = np.arange(flat.size).reshape(shape)
    out = -np.ones((flat.size, 6), np.int64)
    for axis in range(3):
        for j, step in enumerate((-1, 1)):
            nb = np.full(shape, -1)
            src = [slice(None)] * 3
            dst = [slice(None)] * 3
            if step < 0:
                dst[axis], src[axis] = slice(1, None), slice(None, -1)
            else:
                dst[axis], src[axis] = slice(None, -1), slice(1, None)
            nb[tuple(dst)] = idx[tuple(src)]
            ok = (nb >= 0) & (sp > 0)
            ok &= np.where(nb >= 0, flat[np.maximum(nb, 0)], -1) == sp
            out[:, 2 * axis + j] = np.where(ok, nb, -1).reshape(-1)
    return out


def cc_first_parents(sp, cluster):
    """E1's parents after init, and its neighbour bytes: per slab, a warp
    holds 32 consecutive slots; a voxel whose -i2 neighbour is of its run
    links to the last run start at or below its lane, or, with none, to
    the voxel before the warp's first; a run start links to itself,
    background to n."""
    n = sp.size
    bits = ((cc_neighbours(sp) >= 0) << np.arange(6)).sum(1)
    run = (bits & 16) != 0
    v = np.arange(n)
    slab = n // cluster
    lane = (v % slab) % 32
    start = np.where(run, -1, v)
    last = np.empty(n, np.int64)
    for r in range(cluster):
        seg = start[r * slab:(r + 1) * slab]
        pad = np.concatenate([seg, np.full(-slab % 32, -1)]).reshape(-1, 32)
        last[r * slab:(r + 1) * slab] = np.maximum.accumulate(pad, 1).reshape(-1)[:slab]
    par = np.where(run, np.where(last >= 0, last, v - lane - 1), v)
    return np.where(sp.reshape(-1) > 0, par, n), bits


def _find(par, x):
    """The kernel's find: path halving."""
    while True:
        p = par[x]
        if p == x:
            return x
        g = par[p]
        if g == p:
            return p
        par[x] = g
        x = g


def _link(par, a, b):
    """The kernel's union from the roots (a, b) it read: atomicMin of the
    larger under the smaller, retrying from what it found."""
    while a != b:
        if a < b:
            a, b = b, a
        old = par[a]
        par[a] = min(old, b)
        if old == a:
            return
        a, b = _find(par, old), _find(par, b)


def replay_cc(sp, cluster=1, rng=None, max_group=64):
    """E1 on one (d0, d1, d2) grid cut into ``cluster`` slabs.  ``rng``
    None: each stage's unions in the kernel's order (slot by slot, the
    slabs side by side); else a seeded order cut into random groups whose
    unions all read their roots before any of them links.  The first merge
    pass unites the axis-1 edges, stores every entry's root, then unites
    the axis-0 edges.  Returns (labels, merge passes)."""
    n = sp.size
    d0, d1, d2 = sp.shape
    par, bits = cc_first_parents(sp, cluster)
    v = np.arange(n)
    twin = np.where(bits & 16, bits[np.maximum(v - 1, 0)], 0)
    stages = [[(v[(bits & 4) & ~twin & 4 > 0], d2)], [(v[(bits & 1) & ~twin & 1 > 0], d1 * d2)]]
    slab = n // cluster

    def unite_all(edges):
        pairs = np.concatenate([np.stack([a, a - e], 1) for a, e in edges])
        if rng is None:
            pairs = pairs[np.argsort(pairs[:, 0] % slab, kind="stable")]
            groups = [pairs[i:i + 1] for i in range(len(pairs))]
        else:
            pairs = pairs[rng.permutation(len(pairs))]
            cuts = np.cumsum(rng.integers(1, max_group + 1, len(pairs)))
            groups = np.split(pairs, cuts[cuts < len(pairs)])
        for grp in groups:
            roots = [(_find(par, a), _find(par, b)) for a, b in grp]
            for a, b in roots:
                _link(par, a, b)

    passes = 0
    while True:
        passes += 1
        for i, edges in enumerate(stages):
            if i:  # every entry to its root before the next stage
                for x in np.nonzero(par < n)[0]:
                    par[x] = _find(par, x)
            unite_all(edges)
        fg = par < n
        par = np.where(fg, [_find(par, x) if f else n for x, f in zip(v, fg)], n)
        nbrs = cc_neighbours(sp)[:, (0, 2, 4)]
        bad = ((nbrs >= 0) & (par[np.maximum(nbrs, 0)] != par[:, None])).any(1)
        if not bad.any():
            return par.reshape(sp.shape), passes
        stages = [[(v[bits & m > 0], e) for m, e in ((16, 1), (4, d2), (1, d1 * d2))]]
        assert passes <= n + 2


def bfs_bits(cc, fg):
    """Bit k of a voxel: it may receive in sweep k (fg, the neighbour
    inside the grid and of its cc region), the kernel's neighbour byte."""
    shape = cc.shape
    strides = _strides(shape)
    flat_cc = cc.reshape(-1)
    idx = np.arange(cc.size).reshape(shape)
    bits = np.zeros(cc.size, np.uint8)
    for k, (axis, shift) in enumerate(kext.SWEEPS):
        inside = idx % (strides[axis] * shape[axis]) // strides[axis]
        inside = inside > 0 if shift == 1 else inside < shape[axis] - 1
        u = np.where(inside, idx - shift * strides[axis], 0).reshape(-1)
        ok = fg.reshape(-1) & inside.reshape(-1) & (flat_cc[u] == flat_cc)
        bits |= ok.astype(np.uint8) << k
    return bits


def replay_bfs(seeds, cc, fg, seed_labels=None, cluster=1, threads=THREADS, group=GROUP):
    """E2's rounds on one (d0, d1, d2) grid cut into ``cluster`` slabs, as
    the kernel runs them: a round begins by copying the planes across each
    slab's cuts, the lower neighbour's last (sweep 0's halo) and the upper
    neighbour's first (sweep 1's, as it was before sweep 0, which decides
    sweep 1 alike); then per sweep, chunks of threads x group slots, in
    the order against the shift, each read whole before it is written (the
    slabs side by side).  Returns (labels, rounds)."""
    shape = cc.shape
    n = cc.size
    s0 = shape[1] * shape[2]
    slab = n // cluster
    strides = _strides(shape)
    s = (seeds & fg).reshape(-1)
    lab0 = np.arange(n) if seed_labels is None else seed_labels.reshape(-1)
    lab = np.where(s, lab0, n).astype(np.int64).reshape(cluster, slab)
    dist = np.where(s, 0, n).astype(np.int64).reshape(cluster, slab)
    bits = bfs_bits(cc, fg).reshape(cluster, slab)
    chunk = threads * group * kext.VOXELS
    chunks = -(-slab // chunk)
    rounds = 0
    while True:
        rounds += 1
        fell = False
        lo_l, lo_d, hi_l, hi_d = (np.full((cluster, s0), -1) for _ in range(4))  # -1: never read
        lo_l[1:], lo_d[1:] = lab[:-1, -s0:], dist[:-1, -s0:]
        hi_l[:-1], hi_d[:-1] = lab[1:, :s0], dist[1:, :s0]
        for k, (axis, shift) in enumerate(kext.SWEEPS):
            off = -shift * strides[axis]
            hl, hd = (lo_l, lo_d) if shift == 1 else (hi_l, hi_d)
            for c in (range(chunks - 1, -1, -1) if shift == 1 else range(chunks)):
                vl = np.arange(c * chunk, min((c + 1) * chunk, slab))
                ok = ((bits[:, vl] >> k) & 1).astype(bool)
                ul = vl + off
                halo = (ul < 0) | (ul >= slab)
                hi = np.clip(np.where(ul < 0, ul + s0, ul - slab), 0, s0 - 1)
                uc = np.clip(ul, 0, slab - 1)
                du = np.where(halo, hd[:, hi], dist[:, uc])
                lu = np.where(halo, hl[:, hi], lab[:, uc])
                assert (du[ok] >= 0).all()  # a receiving voxel's neighbour exists
                upd = ok & (du + 1 < dist[:, vl]) & (lu != n)
                dist[:, vl] = np.where(upd, du + 1, dist[:, vl])
                lab[:, vl] = np.where(upd, lu, lab[:, vl])
                fell |= bool(upd.any())
        if not fell:
            return lab.reshape(shape), rounds
        assert rounds <= n + 2


# ---------------------------------------------------------------- checks

def _check_cc(species, seeds=(0, 1), clusters=None):
    """E1's replays against the plain version on (N, d0, d1, d2) int32, at
    every cluster size (or ``clusters``), in the kernel's order and in
    seeded racing orders."""
    t = torch.from_numpy(np.ascontiguousarray(species, np.int32))
    ref, rounds = textract.connected_components_reference(t, return_rounds=True)
    ref = ref.numpy()
    for b in range(species.shape[0]):
        for c in clusters or sizes(species.shape[1]):
            for seed in (None,) + tuple(seeds):
                rng = None if seed is None else np.random.default_rng(seed)
                got, passes = replay_cc(species[b], c, rng)
                np.testing.assert_array_equal(got, ref[b])
                assert passes == 1 <= rounds
    return ref


def _check_bfs(seeds, cc, fg, seed_labels, clusters=None, small=True):
    """E2's replays against the plain version, labels and rounds, at every
    cluster size (or ``clusters``); ``small`` also with chunks of 64
    slots (several per slab on every grid here)."""
    ref, rounds = textract.nearest_seed_labels_reference(
        seeds, cc, fg, seed_labels, return_rounds=True)
    for c in clusters or sizes(cc.shape[1]):
        for threads, group in ((THREADS, GROUP),) + (((8, 2),) if small else ()):
            per_sample = []
            for b in range(cc.shape[0]):
                got, r = replay_bfs(
                    seeds[b].numpy(), cc[b].numpy(), fg[b].numpy(),
                    None if seed_labels is None else seed_labels[b].numpy(),
                    c, threads, group)
                np.testing.assert_array_equal(got, ref[b].numpy())
                per_sample.append(r)
            assert max(per_sample) == rounds
    return rounds


@pytest.mark.parametrize("name", sorted(BLOB_CASES))
def test_schedules_match_plain_on_blob_fixtures(name):
    _, _, Sb = BLOB_CASES[name]()
    species = Sb[None].astype(np.int32)
    _check_cc(species)
    fg = torch.from_numpy(species) > 0
    _check_cc(textract.erode6(fg).to(torch.int32).numpy())
    _check_bfs(*bfs_operands(torch.from_numpy(species)))


def test_schedules_match_plain_on_species_grid():
    """E1 on the multi-valued species grid of the species_confused fixture."""
    _, S, _ = BLOB_CASES["species_confused"]()
    _check_cc(S[None].astype(np.int32))


@pytest.mark.parametrize("name", sorted(adversarial()))
def test_schedules_match_plain_on_adversarial_masks(name):
    grid, seeds = adversarial()[name]
    _check_cc(grid[None])
    t = torch.from_numpy(grid[None])
    ops = bfs_operands(t, None if seeds is None else torch.from_numpy(seeds[None]))
    rounds = _check_bfs(*ops)
    if name == "snake":  # a sweep moves the front one voxel: >= 6 per round
        assert rounds >= -(-(int(grid.sum()) - 1) // 6) + 1


@pytest.mark.parametrize("name", sorted(adversarial(shape=(16, 6, 7))))
def test_schedules_match_plain_at_every_cluster_size(name):
    """The adversarial grids 16 planes deep (the non-cubic one stays
    9x12x15): one to sixteen slabs of 16 to 1 planes, every cut crossed."""
    grid, seeds = adversarial(shape=(16, 6, 7))[name]
    _check_cc(grid[None], seeds=(0,))
    t = torch.from_numpy(grid[None])
    ops = bfs_operands(t, None if seeds is None else torch.from_numpy(seeds[None]))
    _check_bfs(*ops, small=name != "snake")  # the snake's ~100 rounds: kernel chunks


def test_tie_is_decided_by_the_sweep_order():
    """Both seeds reach the middle plane at the same distance; the first
    arrival in the sweep order wins, and the replay keeps that order."""
    fg, seeds = tie_case()
    mid = fg.shape[0] // 2
    i0 = np.flatnonzero(seeds.any(axis=(1, 2)))
    assert i0.tolist() == [2, 2 * mid - 2] and fg[2 * mid - 2].any()
    t = [torch.from_numpy(a[None]) for a in (seeds, fg)]
    cc = textract.connected_components_reference(t[1].to(torch.int32))
    lab = textract.nearest_seed_labels_reference(t[0], cc, t[1])[0].numpy()
    owners = set(np.unique(lab[mid][fg[mid]]).tolist())
    assert owners <= set(np.flatnonzero(seeds).tolist()) and len(owners) >= 1
    got, _ = replay_bfs(seeds, cc[0].numpy(), fg)
    np.testing.assert_array_equal(got, lab)


def test_batch_of_masks_per_sample_rounds():
    """A batch of decoded-like masks: each sample stops on its own, and the
    largest per-sample count is the batched plain version's."""
    species = blob_masks(3, (12, 10, 14), 5).astype(np.int32)
    _check_cc(species, seeds=(3,))
    _check_bfs(*bfs_operands(torch.from_numpy(species)))


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 4, 5), (8, 8, 8), (7, 1, 9),
                                   (32, 32, 32), (16, 64, 3)])
def test_slabs_cover_every_voxel_once(shape):
    """Every cluster size's slabs hold each voxel once, whole planes each,
    in consecutive slots (``state_index``)."""
    n = shape[0] * shape[1] * shape[2]
    for c in sizes(shape[0]):
        rank, slot = kext.state_index(shape, c)
        slab = n // c
        assert slab * c == n and slab % (shape[1] * shape[2]) == 0
        np.testing.assert_array_equal(np.sort(rank * slab + slot), np.arange(n))
        np.testing.assert_array_equal(np.bincount(rank, minlength=c), np.full(c, slab))
        i0 = np.arange(n) // (shape[1] * shape[2])
        np.testing.assert_array_equal(rank, i0 // (shape[0] // c))


def _phase_conflicts(slots, elem, vector):
    """Bank conflicts of one warp's access: lane l reads ``vector``
    elements of ``elem`` bytes from slot ``slots[l]`` on, served in phases
    of 128 bytes' worth of lanes; the largest number of distinct words any
    bank serves in one phase (1: conflict-free)."""
    width = elem * vector
    per_phase = max(1, 128 // width)
    worst = 1
    for p in range(0, len(slots), per_phase):
        banks = {}
        for sl in slots[p:p + per_phase]:
            for b in range(sl * elem // 4, (sl * elem + width - 1) // 4 + 1):
                banks.setdefault(b % 32, set()).add(b)
        worst = max([worst] + [len(w) for w in banks.values()])
    return worst


@pytest.mark.parametrize("shape", [(32, 32, 32), (3, 4, 5), (2, 3, 48), (4, 5, 64),
                                   (16, 7, 8), (1, 1, 1)])
def test_state_layout_is_a_bijection_without_bank_conflicts(shape):
    """E2's sweeps: lane l of a warp holds the group of VOXELS slots from
    4 l (plus the warp's base, a multiple of 128), and reads its bits (a
    32-bit word), its distances and, where the shift is a multiple of 4,
    its neighbours' distances in the slab or a halo as one vector each:
    2- and 4-byte distances alike, no bank serves two words of an array in
    a phase.  (Where a plane is not a multiple of 128 slots, a warp on a
    slab's first or last plane splits one read over the slab and a halo.)"""
    d0, d1, d2 = shape
    n = d0 * d1 * d2
    s0 = d1 * d2
    strides = _strides(shape)
    V = kext.VOXELS
    for c in sizes(d0):
        rank, slot = kext.state_index(shape, c)
        slab = n // c
        assert (rank * slab + slot == np.arange(n)).all()
        for k, (axis, shift) in enumerate(kext.SWEEPS):
            off = -shift * strides[axis]
            for w in range(0, min(slab, 4096), 32 * V):
                own = np.arange(w, min(w + 32 * V, slab), V)  # each lane's first slot
                assert (own % V == 0).all()
                reads = [(own, 1, V), (own, 2, V), (own, 4, V)]
                if off % V == 0:
                    ul = own + off
                    halo = (ul < 0) | (ul >= slab)
                    if c == 1:  # no halo: those groups have no neighbour, and read nothing
                        ul = ul[~halo]
                    at = np.where(ul < 0, ul + s0, np.where(ul >= slab, ul - slab, ul))
                    assert (at % V == 0).all()
                    for part in (ul < 0, (ul >= 0) & (ul < slab), ul >= slab):
                        reads += [(at[part], 2, V), (at[part], 4, V)]
                for slots, elem, vector in reads:
                    assert _phase_conflicts(slots, elem, vector) == 1, (c, k, w, elem)


def test_state_path_limits():
    """The plan's path: a 32^3 and a 64^3 sample on chip for both kernels,
    a 96^3 one in device memory; the largest slab each CTA holds."""
    for kind in ("cc", "bfs"):
        for d, path in ((32, "shared"), (64, "shared"), (96, "global")):
            assert kext.plan(kind, 4, (d, d, d), card).path == path, (kind, d)
    # E1 5 bytes a voxel, E2 7 (uint16 distances while n <= 65535) or 9
    assert kext.smem_bytes("cc", (46464, 1, 1), 1) == kext.SMEM_PER_CTA
    assert kext.smem_bytes("cc", (46465, 1, 1), 1) > kext.SMEM_PER_CTA
    assert kext.smem_bytes("bfs", (33184, 1, 1), 1) <= kext.SMEM_PER_CTA
    assert kext.smem_bytes("bfs", (33185, 1, 1), 1) > kext.SMEM_PER_CTA
    assert kext.dist_bytes("bfs", 65535) == 2 and kext.dist_bytes("bfs", 65536) == 4
    assert kext.dist_bytes("bfs", 100, "global") == 4 and kext.dist_bytes("cc", 100) == 0
    assert kext.smem_bytes("cc", (96, 96, 96), 16, "global") == kext.FLAG_BYTES
    assert kext.smem_bytes("bfs", (96, 96, 96), 16, "global") == kext.FLAG_BYTES


# (kind, batch, shape) -> (cluster, path) on the modelled card: the
# generation grid at view's, evaluate's and generate's batches and
# bench.py's 128, one and four 64^3 samples, and 96^3
PLAN_CASES = [
    ("bfs", 1, (32, 32, 32), 16, "shared"),
    ("bfs", 4, (32, 32, 32), 16, "shared"),
    ("bfs", 20, (32, 32, 32), 4, "shared"),
    ("bfs", 128, (32, 32, 32), 1, "shared"),
    ("cc", 1, (32, 32, 32), 16, "shared"),
    ("cc", 20, (32, 32, 32), 4, "shared"),
    ("cc", 128, (32, 32, 32), 1, "shared"),
    ("bfs", 1, (64, 64, 64), 16, "shared"),
    ("bfs", 4, (64, 64, 64), 16, "shared"),
    ("bfs", 20, (64, 64, 64), 16, "shared"),
    ("cc", 4, (64, 64, 64), 16, "shared"),
    ("cc", 20, (64, 64, 64), 8, "shared"),
    ("bfs", 1, (96, 96, 96), 16, "global"),
    ("cc", 1, (96, 96, 96), 16, "global"),
    ("bfs", 2, (9, 12, 15), 1, "shared"),
]


@pytest.mark.parametrize("kind,batch,shape,cluster,path", PLAN_CASES,
                         ids=[f"{k}-{b}x{s[0]}" for k, b, s, _, _ in PLAN_CASES])
def test_plan_choices(kind, batch, shape, cluster, path):
    p = kext.plan(kind, batch, shape, card)
    assert (p.cluster, p.path) == (cluster, path)
    assert shape[0] % p.cluster == 0
    assert p.smem_bytes_per_cta == kext.smem_bytes(kind, shape, p.cluster, p.path)
    assert p.smem_bytes_per_cta <= kext.SMEM_PER_CTA
    n = shape[0] * shape[1] * shape[2]
    assert p.dist_bytes == (0 if kind == "cc" else 2 if n <= 65535 and path == "shared"
                            else 4)


@pytest.mark.parametrize("kind", ["cc", "bfs"])
@pytest.mark.parametrize("batch", [1, 3, 20, 128, 1000])
def test_plan_fits_shared_memory(kind, batch):
    """At every grid 1..80 planes deep (and wider ones), the plan's size
    divides d0, its CTAs hold their slab within 232,448 bytes on the shared
    path, no smaller size would, and the batch's clusters run at once
    unless even the smallest size cannot."""
    for d in list(range(1, 81)) + [96, 128]:
        for shape in ((d, d, d), (d, 12, 15)):
            p = kext.plan(kind, batch, shape, card)
            assert shape[0] % p.cluster == 0 and p.cluster in kext.CLUSTER_SIZES
            on = [c for c in sizes(d)
                  if kext.smem_bytes(kind, shape, c) <= kext.SMEM_PER_CTA]
            if p.path == "shared":
                assert p.smem_bytes_per_cta <= kext.SMEM_PER_CTA
                assert on and p.cluster >= on[0]
                assert p.cluster == on[0] or card(p.cluster, 0, "shared") >= batch
            else:
                assert not on
            bigger = [c for c in sizes(d) if c > p.cluster]
            if bigger and p.cluster > (on[0] if on else 1):
                assert card(bigger[0], 0, p.path) < batch


def test_plan_keeps_64_cubed_on_chip():
    """One 64^3 sample's state lies in its cluster's shared memory for both
    kernels (E1 5 bytes a voxel, E2 9 with int32 distances) at batch 1 to
    4, at the smallest sizes that hold it: 8 CTAs for E1, 16 for E2."""
    for kind, least in (("cc", 8), ("bfs", 16)):
        for batch in (1, 2, 4):
            p = kext.plan(kind, batch, (64, 64, 64), card)
            assert p.path == "shared" and p.cluster >= least
            assert p.smem_bytes_per_cta * p.cluster >= (5 if kind == "cc" else 9) * 64 ** 3
        assert kext.smem_bytes(kind, (64, 64, 64), least) <= kext.SMEM_PER_CTA
        assert kext.smem_bytes(kind, (64, 64, 64), least // 2) > kext.SMEM_PER_CTA


def test_plan_forced_and_refused_sizes():
    """A forced size is kept (its path follows whether it holds the state);
    a size that does not divide d0, or a card that runs no cluster, is
    refused."""
    assert kext.plan("bfs", 4, (32, 32, 32), card, cluster=1) == kext.Plan(
        1, "shared", kext.smem_bytes("bfs", (32, 32, 32), 1), 2)
    assert kext.plan("bfs", 4, (64, 64, 64), card, cluster=4).path == "global"
    assert kext.plan("cc", 4, (64, 64, 64), card, cluster=8).path == "shared"
    with pytest.raises(ValueError, match="dividing"):
        kext.plan("cc", 1, (12, 12, 12), card, cluster=8)
    with pytest.raises(ValueError, match="no cluster size"):
        kext.plan("cc", 1, (8, 8, 8), lambda c, s, p: 0)
    with pytest.raises(ValueError, match="kind"):
        kext.plan("bfs2", 1, (8, 8, 8), card)


@st.composite
def random_grids(draw):
    shape = tuple(draw(st.integers(1, 6)) for _ in range(3))
    n = draw(st.integers(1, 2))
    p = draw(st.floats(0.0, 1.0))
    values = draw(st.integers(1, 3))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    grid = np.where(rng.random((n,) + shape) < p,
                    rng.integers(1, values + 1, (n,) + shape), 0).astype(np.int32)
    seeds = rng.random((n,) + shape) < draw(st.floats(0.0, 0.3))
    labels = rng.integers(0, 2 * grid[0].size + 1, (n,) + shape).astype(np.int32)
    return grid, seeds, labels, seed


@settings(max_examples=40, deadline=None)
@given(random_grids())
def test_schedules_match_plain_on_random_masks(case):
    grid, seeds, labels, seed = case
    _check_cc(grid, seeds=(seed,))
    fg = torch.from_numpy(grid) > 0
    cc = textract.connected_components_reference(torch.from_numpy(grid))
    # any seed labels, n_vox among them: a seed labelled n_vox spreads nothing
    _check_bfs(torch.from_numpy(seeds), cc, fg, torch.from_numpy(labels))
    _check_bfs(*bfs_operands(fg.to(torch.int32)))
