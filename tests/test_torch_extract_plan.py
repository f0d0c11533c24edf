"""The extraction kernels' schedules, replayed in numpy: no GPU, no JAX.

The kernels (``icsg3d_torch/csrc/extract.cu``) run only on the card
(``tests/test_torch_cuda.py``); here what makes their labels the plain
versions' (``icsg3d_torch/ops/extract.py``'s ``*_reference``) is checked:

- (a) E1, connected components: the kernel's in-place passes with a
  pointer jump, applied in seeded orders (every voxel order and grouping
  of simultaneous reads that a block's warps could take, and the
  kernel's own strided order), give the plain version's labels bitwise,
  in no more passes than its rounds (so the kernel's round cap of
  n_vox + 2 never bites);
- (b) E2, the nearest-seed BFS: the kernel's line walks (one thread per
  line along the sweep's axis, against the shift, the pre-sweep value
  carried), sweep by sweep in ``kernels/extract.SWEEPS``'s order from
  ``kernels/extract.line_starts``, give the plain version's labels and,
  sample by sample, its round count over the batch;
- (c) the lines of every axis cover each voxel once, and the state of a
  32^3 sample (the generation grid) lies in shared memory for both
  kernels, a 64^3 one in device memory.

Cases: the blob fixtures of tests/test_torch_extract.py, the adversarial
masks (empty, full, a one-voxel-wide snake, a multi-valued grid,
equidistant seeds), a non-cubic grid, and a bounded hypothesis search
over random masks.  The case builders here are shared with
tests/test_torch_extract.py (JAX parity) and tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from icsg3d_torch.kernels import extract as kext
from icsg3d_torch.ops import extract as textract

torch.set_num_threads(1)

NT = 1024  # the kernels' threads per block (csrc/extract.cu)


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


def adversarial(d=None):
    """The adversarial grids, one sample each: name -> (E1 operand int32,
    E2 seeds bool, or None for the erosion split's seeds; the full grid
    is seeded at two opposite corners, the snake at one end).  ``d`` None:
    small non-cubic shapes for the CPU; an int: d^3 (the card's 32) for
    all but the non-cubic grid, which stays (9, 12, 15)."""
    shp = (lambda s: s) if d is None else (lambda s: (d, d, d))
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


def replay_cc(sp, rng=None, max_group=64):
    """E1's passes on one (d0, d1, d2) grid.  ``rng`` None: the kernel's
    own order (thread t takes v = t, t + NT, ...; a warp's 32 voxels read
    together); else each pass a random voxel order cut into random groups
    whose reads all happen before their writes.  Returns (labels, passes)."""
    n = sp.size
    lab = np.where(sp.reshape(-1) > 0, np.arange(n), n)
    nbrs = cc_neighbours(sp)
    active = np.nonzero((nbrs >= 0).any(1))[0]
    passes = 0
    while True:
        passes += 1
        wrote = False
        if rng is None:
            key = (active % NT) // 32 + (active // NT) * (NT // 32)
            groups = [active[key == g] for g in np.unique(key)]
        else:
            order = rng.permutation(active)
            cuts = np.cumsum(rng.integers(1, max_group + 1, order.size))
            groups = np.split(order, cuts[cuts < order.size])
        for grp in groups:
            own = lab[grp]
            nb = nbrs[grp]
            best = np.minimum(own, np.where(nb >= 0, lab[np.maximum(nb, 0)], n).min(1))
            best = np.where(best < n, np.minimum(best, lab[np.minimum(best, n - 1)]), best)
            w = best < own
            lab[grp[w]] = best[w]
            wrote |= bool(w.any())
        if not wrote:
            return lab.reshape(sp.shape), passes
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


def replay_bfs(seeds, cc, fg, seed_labels=None):
    """E2's rounds on one (d0, d1, d2) grid, as the kernel runs them.
    Returns (labels, rounds)."""
    shape = cc.shape
    n = cc.size
    strides = _strides(shape)
    s = (seeds & fg).reshape(-1)
    lab0 = np.arange(n) if seed_labels is None else seed_labels.reshape(-1)
    lab = np.where(s, lab0, n).astype(np.int64)
    dist = np.where(s, 0, n).astype(np.int64)
    bits = bfs_bits(cc, fg)
    rounds = 0
    while True:
        rounds += 1
        fell = False
        for k, (axis, shift) in enumerate(kext.SWEEPS):
            L, stv = shape[axis], strides[axis]
            starts = kext.line_starts(shape, axis)
            steps = range(L - 1, 0, -1) if shift == 1 else range(0, L - 1)
            dv = dist[starts + (L - 1 if shift == 1 else 0) * stv]
            for i in steps:
                v = starts + i * stv
                u = v - shift * stv
                du, lu = dist[u], lab[u]
                ok = ((bits[v] >> k) & 1).astype(bool) & (lu != n) & (du + 1 < dv)
                dist[v[ok]] = du[ok] + 1
                lab[v[ok]] = lu[ok]
                fell |= bool(ok.any())
                dv = du
        if not fell:
            return lab.reshape(shape), rounds
        assert rounds <= n + 2


# ---------------------------------------------------------------- checks

def _check_cc(species, seeds=(0, 1, 2)):
    """E1's replays against the plain version on (N, d0, d1, d2) int32."""
    t = torch.from_numpy(np.ascontiguousarray(species, np.int32))
    ref, rounds = textract.connected_components_reference(t, return_rounds=True)
    ref = ref.numpy()
    for b in range(species.shape[0]):
        for seed in (None,) + tuple(seeds):
            rng = None if seed is None else np.random.default_rng(seed)
            got, passes = replay_cc(species[b], rng)
            np.testing.assert_array_equal(got, ref[b])
            assert 1 <= passes <= rounds
    return ref


def _check_bfs(seeds, cc, fg, seed_labels):
    """E2's replay against the plain version, labels and rounds."""
    ref, rounds = textract.nearest_seed_labels_reference(
        seeds, cc, fg, seed_labels, return_rounds=True)
    per_sample = []
    for b in range(cc.shape[0]):
        got, r = replay_bfs(seeds[b].numpy(), cc[b].numpy(), fg[b].numpy(),
                            None if seed_labels is None else seed_labels[b].numpy())
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
                                   (32, 32, 32), (5, 64, 3)])
def test_lines_cover_every_voxel_once(shape):
    strides = _strides(shape)
    n = shape[0] * shape[1] * shape[2]
    for axis in range(3):
        starts = kext.line_starts(shape, axis)
        assert starts.size == n // shape[axis]
        assert (starts % (strides[axis] * shape[axis]) // strides[axis] == 0).all()
        every = (starts[:, None] + np.arange(shape[axis]) * strides[axis]).reshape(-1)
        np.testing.assert_array_equal(np.sort(every), np.arange(n))


@pytest.mark.parametrize("shape", [(32, 32, 32), (3, 4, 5), (2, 3, 48), (4, 5, 64),
                                   (6, 7, 8), (1, 1, 1)])
def test_swizzled_state_is_a_bijection_without_bank_conflicts(shape):
    """E2's shared-memory layout holds every voxel once, each row within
    its own slots; at d2 = 32 the 32 lines a warp walks fall in 32 banks
    at every step, for the int32 labels, the uint16 distances and the
    neighbour bytes alike, along every axis."""
    d0, d1, d2 = shape
    n = d0 * d1 * d2
    for path in ("shared", "global"):
        at = kext.state_index(shape, path)
        np.testing.assert_array_equal(np.sort(at), np.arange(n))
        np.testing.assert_array_equal(at // d2, np.arange(n) // d2)
    if d2 != 32:
        return
    at = kext.state_index(shape, "shared")
    strides = _strides(shape)
    for axis in range(3):
        starts = kext.line_starts(shape, axis)
        for warp in range(0, min(starts.size, 256), 32):
            lines = starts[warp:warp + 32]
            for i in range(shape[axis]):
                slot = at[lines + i * strides[axis]]
                for size in (4, 2, 1):  # bytes per element
                    banks = (slot * size // 4) % 32
                    words = slot * size // 4
                    # lanes sharing a bank read one word (a broadcast)
                    per_bank = {}
                    for b, w in zip(banks, words):
                        per_bank.setdefault(b, set()).add(w)
                    assert max(len(w) for w in per_bank.values()) == 1, (axis, i, size)


def test_state_path_limits():
    assert kext.state_path("cc", 32 ** 3) == kext.state_path("bfs", 32 ** 3) == "shared"
    assert kext.state_path("cc", 64 ** 3) == kext.state_path("bfs", 64 ** 3) == "global"
    assert 5 * 46489 <= kext.SMEM_MAX < 5 * 46490
    assert kext.state_path("cc", 46489) == "shared" != kext.state_path("cc", 46490)
    assert kext.state_path("bfs", 33206) == "shared" != kext.state_path("bfs", 33207)


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
