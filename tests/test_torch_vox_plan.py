"""The voxelizer kernel K4's exact logic on the CPU: no GPU, no JAX.

The kernel (``icsg3d_torch/csrc/voxelize.cu``) runs only on the card
(``tests/test_torch_cuda.py``); here what makes its species grid exact is
checked and replayed in numpy:

- (a) ``kernels/voxelize.label_thresholds``, the twin of the setup
  kernel's per-site threshold T: ``d2 < T`` must equal ``sqrt(d2) <
  radius`` at T - 1 ulp, T, T + 1 ulp and radius^2, for many radii and
  label fractions, and invalid sites must never be within;
- (b) a numpy replay of the kernel's species logic (sites packed valid
  first, d2 in the plain version's rounding order, the exact f32 sum that
  encodes how many sites are within and which, and the tie walk that
  picks the first site whose rounded square root equals that of the
  least d2) against ``voxelize_reference``, bitwise, on random synthetic
  structures, the repo's real CIFs, interleaved pads, and crafted
  structures where a square-root tie or a labelling radius decides a
  voxel;
- (c) the main kernel's thread tiling (``kernels/voxelize.tile``) covers
  every voxel exactly once, with aligned float4 stores where d % 4 == 0.
"""

import os

import numpy as np
import pytest
import torch

from icsg3d_torch.kernels import voxelize as kv

torch.set_num_threads(1)

EPS = 0.25
REAL_CIFS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                         "real_cifs")
F32 = np.float32


def _ulp_steps(x, n):
    """x moved n representable f32 values up (n > 0) or down."""
    x = np.asarray(x, F32)
    for _ in range(abs(n)):
        x = np.nextafter(x, F32(np.inf) if n > 0 else F32(0))
    return x


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("label_frac", [0.0, 0.6, 1.0, 1.5])
def test_label_threshold_is_the_sqrt_test(label_frac):
    rng = np.random.default_rng(int(label_frac * 10))
    sigma = np.concatenate([
        rng.uniform(0.2, 3.0, 20000), rng.uniform(1e-7, 1e-3, 500),
        np.exp(rng.uniform(-30, 30, 2000)), [1e-6, 1.0, 2.0, 0.5, 3.0e19, 1e30],
    ]).astype(F32)
    mask = (rng.random(sigma.size) < 0.8).astype(F32)
    mask[:4] = [1, 1, 0, -1]
    T = kv.label_thresholds(sigma, mask, label_frac)
    assert T.dtype == np.float32 and T.shape == sigma.shape
    valid = mask > 0
    assert (T[~valid] == -1).all()
    rad = np.maximum(sigma, F32(1e-6)) * F32(label_frac)
    with np.errstate(over="ignore"):
        probes = [_ulp_steps(T, -1), T, _ulp_steps(T, 1), rad * rad]
    for x in probes:
        x = np.where(x < 0, F32(0), x)
        within = np.sqrt(x) < rad
        assert np.array_equal((x < T)[valid], within[valid])
        assert not (x < T)[~valid].any()  # invalid: never within
    # T is the least such f32: it reaches the radius, its predecessor not
    tv, rv = T[valid], rad[valid]
    assert (tv >= 0).all() and (np.sqrt(tv) >= rv).all()
    below = _ulp_steps(tv, -1)
    assert ((tv == 0) | (np.sqrt(below) < rv)).all()
    if label_frac == 0.0:
        assert (tv == 0).all()
    else:  # rad^2 rounded is not always T: the nextafter steps matter
        with np.errstate(over="ignore"):
            assert (rv * rv != tv).any()


# ---------------------------------------------------------------- (b)

def _d2(v, s):
    """d2 of voxel centres v (..., 3) and one site s (3,) in the kernel's and
    the plain version's f32 rounding order."""
    vx, vy, vz = (np.asarray(v[..., a], F32) for a in range(3))
    x, y, c = (F32(t) for t in s)
    v2 = (vx * vx + vy * vy) + vz * vz
    n2 = (x * x + y * y) + c * c
    cross = (vx * x + vy * y) + vz * c
    return np.maximum((v2 + n2) - F32(2) * cross, F32(0))


def _sqrt_class_end(h_least):
    """The kernel's sqrt_class_end: 2u, u the least f32 above d2 = h / 2
    whose rounded square root exceeds that of d2."""
    x = F32(0.5) * h_least
    r = np.sqrt(x)
    u = np.nextafter(x, F32(np.inf))
    while True:
        same = (np.sqrt(u) == r) & (u < np.inf)
        if not same.any():
            return F32(2) * u
        u = np.where(same, np.nextafter(u, F32(np.inf)), u)


def replay_species(sites, z, sigma, mask, abc, d, label_frac):
    """The kernel's species logic in numpy: returns (species (B, d, d, d),
    voxels that took the tie walk, voxels whose closest site by least d2
    alone differs from the tie walk's).

    As the kernel: the valid sites packed in order; per pair h = raw + |raw|
    = 2 max(d2, 0) against 2T; per voxel ``win``, the f32 sum over the
    sites within of 1 + p / 2048 (p the packed index), which is exact: 0
    for none, 1 + p / 2048 for one (decoded from its bits), >= 2 for two
    or more.  Those walk the sites twice: the least h, then the first site
    whose h lies below the end of the least d2's square-root class."""
    B = mask.shape[0]
    ax = kv.voxel_axes(torch.from_numpy(abc), d, EPS).numpy()
    T2 = F32(2) * kv.label_thresholds(sigma, mask, label_frac)
    out = np.zeros((B, d, d, d), F32)
    walked = differs = 0
    for b in range(B):
        vx = ax[b, 0][:, None, None]
        vy = ax[b, 1][None, :, None]
        vz = ax[b, 2][None, None, :]
        v2 = (vx * vx + vy * vy) + vz * vz
        win = np.zeros((d, d, d), F32)
        packed = np.flatnonzero(mask[b] > 0)  # valid sites, in order
        hs = []
        for p, s in enumerate(packed):
            x, y, c = sites[b, s]
            n2 = (x * x + y * y) + c * c
            raw = (v2 + n2) - F32(2) * ((vx * x + vy * y) + vz * c)
            h = raw + np.abs(raw)
            win = win + (h < T2[b, s]).astype(F32) * F32(1 + p / 2048)
            hs.append((z[b, s], h))
        one = (win > 0) & (win < 2)
        bits = win.view(np.int32)
        only = packed[np.where(one, (bits - 0x3F800000) >> 12, 0)]
        sp = np.where(one, z[b][only], F32(0))
        tie = win >= 2
        best = np.full((d, d, d), np.inf, F32)
        for _, h in hs:
            best = np.minimum(best, h)
        lim = np.where(tie, _sqrt_class_end(best), F32(-1))
        by_d2 = np.zeros((d, d, d), F32)
        found_d2 = ~tie
        for zs, h in hs:
            hit = h < lim
            sp = np.where(hit, zs, sp)
            lim = np.where(hit, F32(-1), lim)
            hit_d2 = ~found_d2 & (h == best)
            by_d2[hit_d2] = zs
            found_d2 |= hit_d2
        assert (lim[tie] == -1).all()  # every tie voxel found its site
        out[b] = sp
        walked += int(tie.sum())
        differs += int((tie & (sp != by_d2)).sum())
    return out, walked, differs


def _pack(structures, site_pad):
    from icsg3d_torch.ops.voxelize import pad_sites

    rows = []
    for s in structures:
        N, zz, r = s.site_arrays()
        cart = N * np.asarray(s.lattice.abc, np.float64)
        rows.append((*pad_sites(cart, zz, r, site_pad), np.array(s.lattice.abc, F32)))
    return [np.stack([r[i] for r in rows]) for i in range(5)]


def crafted_batch(d=8):
    """Structures where the square-root tie and the labelling radius decide
    voxels, as (sites, z, sigma, mask, abc) float32, 6 sites each:

    0. a pad (mask 0) first, then sites A (index 1) and B (index 2) at
       d2 values from one voxel with one rounded square root, B's d2 the
       smaller, both inside their radii: the reference takes A (lowest
       index among equal distances), an argmin over d2 would take B; an
       invalid site with a weight (mask -1) after them;
    1. sites whose radius equals the distance to one voxel exactly (so
       that voxel is outside), or one ulp more (inside), with sigma chosen
       where rad^2 rounded differs from the threshold T.
    """
    rng = np.random.default_rng(8)
    abc = np.full(3, 4.0, F32)
    ax = kv.voxel_axes(torch.from_numpy(abc[None]), d, EPS)[0].numpy()
    v = np.array([ax[0, 1], ax[1, 1], ax[2, 1]], F32)  # near the origin: fine d2
    S = 6
    sites = np.zeros((2, S, 3), F32)
    z = np.zeros((2, S), F32)
    sigma = np.ones((2, S), F32)
    mask = np.zeros((2, S), F32)

    a = (v + np.array([1.2, 0.3, -0.4], F32)).astype(F32)
    dA = _d2(v, a)
    for _ in range(100000):
        u = rng.normal(size=3)
        bpos = (v + u / np.linalg.norm(u) * np.sqrt(np.float64(dA))).astype(F32)
        dB = _d2(v, bpos)
        if dB < dA and np.sqrt(dB) == np.sqrt(dA):
            break
    else:
        raise AssertionError("no square-root tie found")
    sites[0, 1], sites[0, 2] = a, bpos
    sites[0, 3] = v + np.array([-0.5, 1.0, 0.2], F32)
    z[0, 1:4] = [26.0, 8.0, 17.0]
    sigma[0, 1:4] = [2.5, 2.5, 0.7]
    mask[0, 1:3] = 1.0
    mask[0, 3] = -1.0  # invalid but weighted: density only

    # 1: radii on a voxel's distance, where rad^2 rounded is not T
    w = np.array([ax[0, 3], ax[1, 4], ax[2, 2]], F32)
    placed = 0
    for _ in range(100000):
        s = (w + rng.uniform(-1.5, 1.5, 3)).astype(F32)
        d2 = _d2(w, s)
        dist = np.sqrt(d2)
        if dist < 0.5 or (placed % 2 == 0 and not dist * dist > d2):
            continue  # even sites: radius == distance, where d2 < rad^2
        sites[1, placed] = s
        sigma[1, placed] = dist if placed % 2 == 0 else np.nextafter(dist, F32(np.inf))
        z[1, placed] = 10.0 + placed
        mask[1, placed] = 1.0
        placed += 1
        if placed == 4:
            break
    abcs = np.stack([abc, abc])
    return sites, z, sigma, mask, abcs


def _real_cifs():
    from icsg3d_torch.crystal.cif import read_cif

    out = []
    for f in sorted(os.listdir(REAL_CIFS)):
        if f.endswith(".cif"):
            try:
                s = read_cif(os.path.join(REAL_CIFS, f))
            except Exception:  # the build skips files that do not parse
                continue
            if 0 < len(s) <= 40:
                out.append(s)
    return out


def _inputs(kind):
    from icsg3d_torch.data.synthetic import random_structures

    if kind == "synthetic":
        return _pack(random_structures(12, seed=3, kinds=("perovskite", "rocksalt")), 16)
    if kind == "real":
        return _pack(_real_cifs(), 40)
    if kind == "interleaved":  # pads between real sites, and a weighted invalid one
        arrs = _pack(random_structures(4, seed=5, kinds=("rocksalt",)), 12)
        perm = np.random.default_rng(5).permutation(12)
        arrs = [a[:, perm] if a.ndim >= 2 and a.shape[1] == 12 else a for a in arrs]
        pad = np.flatnonzero(arrs[3][0] == 0)[0]
        arrs[3][0, pad], arrs[1][0, pad] = -1.0, 9.0  # invalid, weight 9
        return arrs
    return list(crafted_batch())


def _reference_species(arrs, d, label_frac):
    return kv.voxelize_reference(*(torch.from_numpy(np.ascontiguousarray(a))
                                   for a in arrs), d, EPS, label_frac)[1].numpy()


@pytest.mark.parametrize("kind", ["synthetic", "real", "interleaved", "crafted"])
@pytest.mark.parametrize("label_frac", [0.0, 0.6, 1.0, 1.5])
def test_species_replay_equals_reference(kind, label_frac):
    arrs = _inputs(kind)
    d = 8
    got, walked, _ = replay_species(*arrs, d, label_frac)
    ref = _reference_species(arrs, d, label_frac)
    assert np.array_equal(got, ref)
    if label_frac == 0.0:
        assert walked == 0 and not ref.any()
    if label_frac == 1.5 and kind != "crafted":
        assert walked > 0  # the tie walk ran


def test_crafted_cases_bite():
    """The crafted voxels decide what they are built for: the square-root tie
    (an argmin over d2 alone would differ) and the radius test (rad^2
    rounded in place of T would differ)."""
    arrs = crafted_batch()
    sites, z, sigma, mask, abc = arrs
    _, walked, differs = replay_species(*arrs, 8, 1.0)
    assert walked > 0 and differs > 0
    ref = _reference_species(arrs, 8, 1.0)
    assert ref[0, 1, 1, 1] == 26.0  # A, not B
    # structure 1: the d2 < rad^2 test would disagree with the reference
    ax = kv.voxel_axes(torch.from_numpy(abc), 8, EPS).numpy()
    w = np.array([ax[1, 0, 3], ax[1, 1, 4], ax[1, 2, 2]], F32)
    rad = np.maximum(sigma[1], F32(1e-6))
    T = kv.label_thresholds(sigma[1], mask[1], 1.0)
    wrong = 0
    for s in range(4):
        d2 = _d2(w, sites[1, s])
        assert (d2 < T[s]) == (np.sqrt(d2) < rad[s])
        assert (np.sqrt(d2) < rad[s]) == (s % 2 == 1)
        wrong += (d2 < rad[s] * rad[s]) != (np.sqrt(d2) < rad[s])
    assert wrong > 0


# ---------------------------------------------------------------- (c)

@pytest.mark.parametrize("d", [1, 3, 5, 16, 32, 33, 64])
def test_tile_covers_every_voxel_once(d):
    qd, tpc, blocks = kv.tile(d)
    assert qd == -(-d // 4) and tpc * kv.QUADS_PER_THREAD >= qd
    assert (tpc - 1) * kv.QUADS_PER_THREAD < qd  # no thread without a quad
    t = np.arange(blocks * kv.THREADS)
    assert (t < d * d * tpc).sum() == d * d * tpc <= t.size
    t = t[t < d * d * tpc]
    col, r = t // tpc, t % tpc
    i, j = col // d, col % d
    hits = np.zeros(d ** 3, np.int64)
    for h in range(kv.QUADS_PER_THREAD):
        k0 = 4 * (r + h * tpc)
        live = k0 < d
        if d % 4 == 0:  # float4 stores: 16-byte aligned offsets
            assert ((((i * d + j) * d + k0)[live]) % 4 == 0).all()
        for u in range(4):
            k = k0 + u
            ok = k < d
            np.add.at(hits, ((i * d + j) * d + k)[ok], 1)
    assert (hits == 1).all()
