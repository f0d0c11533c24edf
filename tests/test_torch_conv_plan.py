"""The bf16 forward/dx kernel's decomposition (``kernels/conv3d.plan``) on the
CPU: no GPU, no JAX.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
here its plan is checked at every forward, dx and VALID shape
``chip_smoke.py`` launches, and replayed in numpy -- the tiles of rows,
planes and column segments, each (kd, channel chunk) window as the TMA box
lands it (zero outside A, zero past the box), each tap's view at its offset
into the window, the weight tiles as read from w itself (the flipped tap
for dx), and the store of the kept positions -- against the plain versions
``conv3d_same_reference``, ``conv3d_valid_reference``,
``conv3d_dx_reference`` and ``conv3d_dx_valid_reference``.  Tolerance:
exact equality on small-integer operands (every product and sum is exact
in f32 and f64).
"""

import os
import sys

import numpy as np
import pytest
import torch

from icsg3d_torch.kernels import conv3d as k

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its shape tables; it imports nothing at load)

_OFF = {"same": 0, "valid": 1, "full": -1}


def _smoke_shapes():
    """(B, D_out, H, W, K, N, mode, dx) of every bf16 forward, dx and VALID
    launch chip_smoke checks."""
    out = set()
    fwd = [(chip_smoke.BATCH, s) for s in chip_smoke.CONV_SHAPES + chip_smoke.TRAIN_FWD_SHAPES]
    fwd += [(chip_smoke.UNET_BATCH, s) for s in chip_smoke.UNET_FWD_SHAPES]
    fwd += [(chip_smoke.EVAL_BATCH, s) for s in chip_smoke.CONV_SHAPES]
    for batch, (_, cin, cout, e, _, idt, _) in fwd:
        if idt == "bf16":
            out.add((batch, e, e, e, cin, cout, "same", False))
    dx = [(chip_smoke.BATCH, s) for s in chip_smoke.DX_SHAPES]
    dx += [(chip_smoke.UNET_BATCH, s) for s in chip_smoke.UNET_DX_NEW]
    for batch, (_, cin, cout, e, dt) in dx:
        if dt == "bf16":
            out.add((batch, e, e, e, cout, cin, "same", True))
    s = chip_smoke.SPATIAL
    for shapes, batch in ((chip_smoke.VAE_CONVS, chip_smoke.BATCH),
                          (chip_smoke.UNET_TRAIN, chip_smoke.UNET_BATCH)):
        for i, (_, cin, cout, e, dt) in enumerate(shapes):
            if dt == "bf16":
                out.add((batch, e // s, e, e, cin, cout, "valid", False))
                if i > 0:
                    out.add((batch, e // s + 2, e, e, cout, cin, "full", True))
    return sorted(out)


SMOKE = _smoke_shapes()


def _plan(shape):
    B, D_out, H, W, kk, n, mode, dx = shape
    return k.plan(B, D_out, H, W, kk, n, _OFF[mode], dx)


@pytest.mark.parametrize("shape", SMOKE, ids=[
    f"{s[6]}{'-dx' if s[7] else ''}-{s[4]}to{s[5]}@{s[2]}-d{s[1]}-b{s[0]}" for s in SMOKE])
def test_plan_limits_and_coverage_at_smoke_shapes(shape):
    B, D_out, H, W, kk, n, mode, dx = shape
    p = _plan(shape)
    assert p.smem <= k.SMEM_MAX and 2 <= p.nb <= k.MAX_WEIGHT_STAGES
    assert 1 <= p.blocks < 2 ** 31
    assert p.kc in (16, 32, 64) and p.nc * p.kc >= p.k_p >= kk and p.k_p % 8 == 0
    assert p.bn in ((16, 32, 64, 96, 128) if dx else (64, 128))
    assert p.pitch <= k.MAX_BOX and p.rows + 2 <= k.MAX_BOX and p.nd <= k.MAX_BOX
    # the tile's kept positions fit its mt sub-tiles
    assert p.nd * (p.rows + 2) * p.pitch - 2 * p.pitch <= 64 * p.mt <= 64 * k.MAX_MT
    assert p.nd == 1 or (p.rows == H and p.nseg == 1)
    # the M tiles cover every output position exactly once
    count = np.zeros((B, D_out, H, W), np.int32)
    for t in range(p.m_tiles):
        b, d0, h0, c0 = p.tile_origin(t)
        count[b, d0:d0 + p.nd, h0:h0 + p.rows, c0:c0 + p.seg_w] += 1
    assert (count == 1).all()


def test_plan_picks_wide_tiles_at_the_unet_shapes():
    """The wide U-Net forwards at batch 10 take 128-channel N tiles with 3-4
    m64 sub-tiles of whole rows (7 rows of a 32-wide plane, 8 of a 16-wide
    one) or of three stacked 8x8 planes, one column segment."""
    for cin, cout, e, rows, nd in ((192, 128, 32, 7, 1), (128, 128, 32, 7, 1),
                                   (384, 256, 16, 8, 1), (768, 512, 8, 8, 3)):
        p = k.plan(10, e, e, e, cin, cout, 0, False)
        assert (p.bn, p.rows, p.nd, p.nseg, p.kc) == (128, rows, nd, 1, 64), (cin, cout)
        assert p.mt >= 3


def _replay(a, w, mode, dx):
    """The kernel's arithmetic, in float64 numpy, from ``plan``: per M tile
    and N tile, per kd and channel chunk, the window box (zero outside A
    and past the box) and per tap the window viewed from its offset times
    the tap's weight tile; then the kept positions stored.  Returns the
    conv sum (no bias) and the plan."""
    B, D, H, W, kk = a.shape
    cin, cout = w.shape[3], w.shape[4]
    n = cin if dx else cout
    off = _OFF[mode]
    p = k.plan(B, D - 2 * off, H, W, kk, n, off, dx)
    ap = np.zeros(a.shape[:4] + (p.nc * p.kc,))
    ap[..., :kk] = a
    w27 = w.reshape(27, cin, cout)
    out = np.zeros((B, p.D_out, H, W, n))
    written = np.zeros((B, p.D_out, H, W, n), np.int32)
    P, R, nd = p.pitch, p.rows, p.nd
    # window position -> (plane j, row r, column c) of the box, or none
    pos = np.arange(p.window)
    j, rem = np.divmod(pos, (R + 2) * P)
    r, c = np.divmod(rem, P)
    in_box = j < nd
    # tile position -> kept output (plane, row, column)
    q = np.arange(p.mt * 64)
    qj, qrem = np.divmod(q, (R + 2) * P)
    qr, qc = np.divmod(qrem, P)
    for t in range(p.m_tiles):
        b, d0, h0, c0 = p.tile_origin(t)
        keep = ((qj < nd) & (qr < R) & (qc < p.seg_w) & (d0 + qj < p.D_out)
                & (h0 + qr < H) & (c0 + qc < W))
        for nt in range(p.n_tiles):
            n0 = nt * p.bn
            ns = np.arange(n0, min(n0 + p.bn, n))
            acc = np.zeros((p.mt * 64, len(ns)))
            for kd in range(3):
                plane, row, col = d0 + off + kd - 1 + j, h0 - 1 + r, c0 - 1 + c
                ok = in_box & (plane >= 0) & (plane < D) & (row >= 0) & (row < H) \
                    & (col >= 0) & (col < W)
                for ch in range(0, p.nc * p.kc, p.kc):
                    win = np.zeros((p.window, p.kc))
                    win[ok] = ap[b, plane[ok], row[ok], col[ok], ch:ch + p.kc]
                    ks = np.arange(ch, ch + p.kc)
                    for tap in range(9):
                        wt = np.zeros((p.kc, len(ns)))
                        if dx:  # B[co][ci] = w[26 - tap][ci][co]
                            m = ks < cout
                            wt[m] = w27[26 - (kd * 9 + tap)][np.ix_(ns, ks[m])].T
                        else:   # B[ci][co] = w[tap][ci][co]
                            m = ks < cin
                            wt[m] = w27[kd * 9 + tap][np.ix_(ks[m], ns)]
                        o = p.tap_offsets[tap]
                        acc += win[o:o + p.mt * 64] @ wt
            qb = (b, d0 + qj[keep], h0 + qr[keep], c0 + qc[keep])
            out[qb[0], qb[1], qb[2], qb[3], n0:n0 + len(ns)] = acc[keep]
            written[qb[0], qb[1], qb[2], qb[3], n0:n0 + len(ns)] += 1
    assert (written == 1).all()  # every output element stored once
    return out, p


def _reference(a, w, mode, dx):
    at, wt = torch.from_numpy(a.astype(np.float32)), torch.from_numpy(w.astype(np.float32))
    if dx:
        fn = k.conv3d_dx_valid_reference if mode == "full" else k.conv3d_dx_reference
        return fn(at, wt).numpy()
    zero = torch.zeros(w.shape[4])
    fn = k.conv3d_valid_reference if mode == "valid" else k.conv3d_same_reference
    return fn(at, wt, zero).numpy()


REPLAY_CASES = [
    # (B, D of A, H, W, Cin, Cout)
    (2, 3, 3, 1, 4, 8),        # W 1
    (1, 4, 2, 2, 14, 16),      # W 2, Cin 14 padded to 16
    (2, 4, 4, 4, 16, 32),      # stacked whole planes
    (1, 5, 3, 5, 4, 20),       # W 5, odd H and D
    (1, 3, 7, 33, 16, 24),     # W 33: rows of a 34-position pitch
    (1, 3, 3, 128, 32, 16),    # W 128
    (1, 3, 2, 300, 192, 72),   # W 300: column segments, 3 chunks of 64
    (1, 4, 5, 8, 72, 136),     # two N tiles, a ragged chunk
]


# the passes the port launches: the SAME forward and dx, the VALID
# forward, and the full-window dx
PASSES = [("same", False), ("same", True), ("valid", False), ("full", True)]


@pytest.mark.parametrize("mode,dx", PASSES, ids=["same", "same-dx", "valid", "full-dx"])
@pytest.mark.parametrize("case", REPLAY_CASES, ids=[
    f"b{c[0]}d{c[1]}h{c[2]}w{c[3]}-{c[4]}x{c[5]}" for c in REPLAY_CASES])
def test_plan_replay_matches_reference(case, mode, dx):
    """All three depth windows, exactly on small integers."""
    B, D, H, W, cin, cout = case
    rng = np.random.default_rng(hash((case, mode, dx)) % 2 ** 32)
    if mode == "valid":
        D += 2
    a = rng.integers(-3, 4, (B, D, H, W, cout if dx else cin)).astype(np.float64)
    w = rng.integers(-2, 3, (3, 3, 3, cin, cout)).astype(np.float64)
    got, p = _replay(a, w, mode, dx)
    ref = _reference(a, w, mode, dx)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_plan_splits_rows_wider_than_a_box():
    """W = 300 (pitch 301 > 256) takes column segments of pitch seg_w + 2;
    W = 255 at 64 channels still fits one segment."""
    p = k.plan(1, 2, 2, 300, 192, 128, 0, False)
    assert p.nseg >= 2 and p.pitch == p.seg_w + 2 <= k.MAX_BOX
    p = k.plan(1, 2, 2, 255, 64, 64, 0, True)
    assert p.nseg == 1 and p.pitch == 256


def test_describe_reports_the_plan():
    d = k.describe((10, 32, 32, 32, 192), 128, torch.bfloat16)
    p = k.plan(10, 32, 32, 32, 192, 128, 0, False)
    assert d["path"] == "wgmma+tma" and (d["bn"], d["mt"], d["blocks"]) == (p.bn, p.mt, p.blocks)
    assert k.describe((20, 32, 32, 32, 16), 4, torch.float32)["path"] == "fma+window"
    d = k.describe((10, 18, 32, 32, 128), 192, torch.bfloat16, "full", dx=True)
    assert d["blocks"] == k.plan(10, 20, 32, 32, 128, 192, -1, True).blocks


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 4, 4, 4, 8, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 3, 8, 8, dtype=torch.bfloat16)
    b = torch.zeros(8)
    for fn, args in ((k.conv3d_same_cuda, (x, w, b)), (k.conv3d_valid_cuda, (x, w, b)),
                     (k.conv3d_dx_cuda, (x, w)), (k.conv3d_dx_valid_cuda, (x, w))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
