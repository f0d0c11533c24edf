"""The f32 kernels' decompositions on the CPU: no GPU, no JAX.

``kernels/conv3d.fma_plan`` (the f32 window kernel: forward, dx, VALID,
full-window dx) and ``kernels/conv3d_dw.fma_plan`` (the f32 sliding-window
weight gradient, SAME and VALID) are what the VAE's f32 output head runs
on the card.  The kernels themselves run only there
(``tests/test_torch_cuda.py``); here each plan is checked at every f32
shape ``chip_smoke.py`` launches and at ragged ones (W = 1 ... 300, ragged
rows, planes and channel tiles), and replayed in numpy -- per block, the
x window as the kernel stages it (zero outside the input), each thread's
taps read from inside that window, the weights from w itself (the flipped
tap for dx), the split ranges walked in order and summed in split order
-- against the plain versions.  Tolerance: exact equality on
small-integer operands (every product and sum is exact in f32 and f64).
"""

import os
import sys

import numpy as np
import pytest
import torch

from icsg3d_torch.kernels import conv3d as k
from icsg3d_torch.kernels import conv3d_dw as kdw

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its shape tables; it imports nothing at load)

_OFF = {"same": 0, "valid": 1, "full": -1}
SM_REGS = 65_536


def _smoke_f32_shapes():
    """(B, D_out, H, W, K, N, mode, dx) of every f32 forward, dx, VALID and
    full-window dx launch chip_smoke checks."""
    out = set()
    for batch, shapes in ((chip_smoke.BATCH, chip_smoke.CONV_SHAPES + chip_smoke.TRAIN_FWD_SHAPES),
                          (chip_smoke.UNET_BATCH, chip_smoke.UNET_FWD_SHAPES),
                          (chip_smoke.EVAL_BATCH, chip_smoke.CONV_SHAPES)):
        for _, cin, cout, e, _, idt, _ in shapes:
            if idt == "f32":
                out.add((batch, e, e, e, cin, cout, "same", False))
    s = chip_smoke.SPATIAL
    for shapes, batch in ((chip_smoke.VAE_CONVS, chip_smoke.BATCH),
                          (chip_smoke.UNET_TRAIN, chip_smoke.UNET_BATCH)):
        for _, cin, cout, e, dt in shapes:
            if dt == "f32":
                out.add((batch, e, e, e, cout, cin, "same", True))
                out.add((batch, e // s, e, e, cin, cout, "valid", False))
                out.add((batch, e // s + 2, e, e, cout, cin, "full", True))
    return sorted(out)


SMOKE = _smoke_f32_shapes()


def test_smoke_has_the_f32_head_in_every_pass():
    modes = {(m, dx) for *_, m, dx in SMOKE}
    assert modes == {("same", False), ("same", True), ("valid", False), ("full", True)}
    assert {(s[4], s[5]) for s in SMOKE} == {(16, 4), (4, 16)}


def _check_conv_plan(p: k.FmaPlan):
    assert 1 <= p.threads <= k.FMA_MAX_THREADS and p.threads == p.seg_w * p.rg * p.ng
    assert p.smem <= k.SMEM_MAX and p.blocks_per_sm >= 1
    assert p.threads * p.regs * p.blocks_per_sm <= SM_REGS and p.regs <= 255
    assert p.kc in k.FMA_KC and (p.kc == 4 or p.kc < 2 * p.k) and p.bn <= k.FMA_MAX_BN
    assert p.cs % 4 == 0 and p.cs >= p.kc
    assert p.seg_w <= k.FMA_MAX_THREADS and p.nseg == -(-p.W // p.seg_w)
    assert 1 <= p.blocks < 2 ** 31 and p.n_tiles <= 65535
    # the staging's float-reciprocal decode is exact below 2^21 elements
    assert 27 * p.kc * p.bn < 2 ** 21 and 3 * (p.rows + 2) * p.pitch * p.kc < 2 ** 21


@pytest.mark.parametrize("shape", SMOKE, ids=[
    f"{s[6]}{'-dx' if s[7] else ''}-{s[4]}to{s[5]}@{s[2]}-d{s[1]}-b{s[0]}" for s in SMOKE])
def test_conv_plan_limits_and_coverage_at_smoke_shapes(shape):
    B, D_out, H, W, kk, n, mode, dx = shape
    p = k.fma_plan(B, D_out, H, W, kk, n, _OFF[mode], dx)
    _check_conv_plan(p)
    # the M tiles and the threads' rows x columns cover every output once
    count = np.zeros((B, D_out, H, W), np.int32)
    for t in range(p.m_tiles):
        b, d, h0, c0 = p.tile_origin(t)
        count[b, d, h0:h0 + p.rows, c0:c0 + p.seg_w] += 1
    assert (count == 1).all()
    cols, rows, groups = zip(*(p.thread_role(t) for t in range(p.threads)))
    assert sorted(set(cols)) == list(range(p.seg_w))
    assert sorted(set(rows)) == list(range(0, p.rows, p.rt))
    assert sorted(set(groups)) == list(range(p.ng))


def _replay_conv(a, w, mode, dx):
    """The f32 window kernel's arithmetic from ``fma_plan``, in float64
    numpy: per block and N tile, per chunk of kc channels the x window
    [3][rows + 2][kc][pitch] (zero outside A) and the weights [27][kc][bn]
    from w's own layout; each thread's RT x CT outputs summed over its
    taps' window reads; the kept outputs stored.  Returns the conv sum (no
    bias) and the plan."""
    B, D, H, W, kk = a.shape
    cin, cout = w.shape[3], w.shape[4]
    n = cin if dx else cout
    off = _OFF[mode]
    p = k.fma_plan(B, D - 2 * off, H, W, kk, n, off, dx)
    w27 = w.reshape(27, cin, cout)
    out = np.zeros((B, p.D_out, H, W, n))
    written = np.zeros(out.shape, np.int32)
    roles = np.array([p.thread_role(t) for t in range(p.threads)])
    tc, tr0, tg = roles[:, 0], roles[:, 1], roles[:, 2]
    ri = np.arange(p.rt)
    for t in range(p.m_tiles):
        b, d, h0, c0 = p.tile_origin(t)
        for nt in range(p.n_tiles):
            n0 = nt * p.bn
            acc = np.zeros((p.threads, p.rt, p.ct))
            for k0 in range(0, kk, p.kc):
                win = np.zeros((3, p.rows + 2, p.kc, p.pitch))
                hh = h0 - 1 + np.arange(p.rows + 2)
                cc = c0 - 1 + np.arange(p.pitch)
                ch = k0 + np.arange(p.kc)
                ok_h, ok_c, ok_k = (hh >= 0) & (hh < H), (cc >= 0) & (cc < W), ch < kk
                for kd in range(3):
                    dd = d + off + kd - 1
                    if 0 <= dd < D:
                        blk = a[b, dd][np.ix_(hh[ok_h], cc[ok_c], ch[ok_k])]
                        win[kd][np.ix_(ok_h, ok_k, ok_c)] = blk.transpose(0, 2, 1)
                wt = np.zeros((27, p.kc, p.bn))
                nn = n0 + np.arange(p.bn)
                for tap in range(27):
                    for i, c in enumerate(ch):
                        for j, m in enumerate(nn):
                            if c < kk and m < n:
                                wt[tap, i, j] = (w27[26 - tap, m, c] if dx
                                                 else w27[tap, c, m])
                for kd in range(3):
                    for kh in range(3):
                        for kw in range(3):
                            r = tr0[:, None] + kh + ri[None, :]      # (threads, rt)
                            col = tc + kw                           # (threads,)
                            assert r.max() < p.rows + 2 and col.max() < p.pitch
                            xs = win[kd][r, :, col[:, None]]        # (threads, rt, kc)
                            cols = tg[:, None] * p.ct + np.arange(p.ct)[None, :]
                            ws = wt[kd * 9 + kh * 3 + kw][:, cols].transpose(1, 0, 2)
                            acc += np.einsum("trk,tkc->trc", xs, ws)
            for tid in range(p.threads):
                c = c0 + tc[tid]
                for i in range(p.rt):
                    h = h0 + tr0[tid] + i
                    for j in range(p.ct):
                        m = n0 + tg[tid] * p.ct + j
                        if c < W and h < H and m < n:
                            out[b, d, h, c, m] = acc[tid, i, j]
                            written[b, d, h, c, m] += 1
    assert (written == 1).all()  # every output element stored once
    return out, p


def _conv_reference(a, w, mode, dx):
    at, wt = torch.from_numpy(a.astype(np.float32)), torch.from_numpy(w.astype(np.float32))
    if dx:
        fn = k.conv3d_dx_valid_reference if mode == "full" else k.conv3d_dx_reference
        return fn(at, wt).numpy()
    zero = torch.zeros(w.shape[4])
    fn = k.conv3d_valid_reference if mode == "valid" else k.conv3d_same_reference
    return fn(at, wt, zero).numpy()


CONV_CASES = [
    # (B, D of the output, H, W, Cin, Cout)
    (2, 3, 3, 1, 16, 4),       # W 1
    (1, 2, 5, 2, 16, 4),       # W 2, ragged rows
    (3, 1, 6, 5, 4, 16),       # ragged B*D, odd H and W
    (1, 2, 4, 33, 16, 4),      # W 33
    (1, 2, 3, 130, 4, 16),     # W 130: two column segments
    (1, 1, 2, 300, 16, 4),     # W 300: three segments
    (1, 2, 3, 7, 14, 16),      # Cin 14: a ragged chunk
    (1, 2, 3, 6, 32, 64),      # two N tiles or wide channel groups
    (2, 2, 9, 4, 3, 9),        # odd channel counts: scalar loads, padded N
]
PASSES = [("same", False), ("same", True), ("valid", False), ("full", True)]


@pytest.mark.parametrize("mode,dx", PASSES, ids=["same", "same-dx", "valid", "full-dx"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[
    f"b{c[0]}d{c[1]}h{c[2]}w{c[3]}-{c[4]}x{c[5]}" for c in CONV_CASES])
def test_conv_plan_replay_matches_reference(case, mode, dx):
    """All three depth windows, forward and dx, exactly on small integers."""
    B, D, H, W, cin, cout = case
    rng = np.random.default_rng([*case, PASSES.index((mode, dx))])
    D_in = D + 2 * _OFF[mode]
    if D_in < 1:
        D_in, D = 1, 1 - 2 * _OFF[mode]
    a = rng.integers(-3, 4, (B, D_in, H, W, cout if dx else cin)).astype(np.float64)
    w = rng.integers(-2, 3, (3, 3, 3, cin, cout)).astype(np.float64)
    got, p = _replay_conv(a, w, mode, dx)
    _check_conv_plan(p)
    ref = _conv_reference(a, w, mode, dx)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_conv_plan_keeps_rows_whole_and_picks_the_head_tile():
    """Rows up to 128 columns stay whole (one segment); the head at batch
    20 takes whole 32-column rows, 4 input channels per staged chunk."""
    for W in (1, 33, 128):
        assert k.fma_plan(2, 2, 4, W, 16, 4, 0, False).nseg == 1
    assert k.fma_plan(1, 1, 2, 300, 16, 4, 0, False).nseg == 3
    p = k.fma_plan(20, 32, 32, 32, 16, 4, 0, False)
    assert (p.seg_w, p.nseg, p.kc) == (32, 1, 4)
    p = k.fma_plan(20, 32, 32, 32, 4, 16, 0, True)
    assert p.seg_w == 32 and p.nc == 1


def test_conv_describe_reports_the_f32_tile():
    d = k.describe((20, 32, 32, 32, 16), 4, torch.float32)
    p = k.fma_plan(20, 32, 32, 32, 16, 4, 0, False)
    assert d["path"] == "fma+window"
    assert (d["rows"], d["bn"], d["kc"], d["threads"], d["blocks"]) == (
        p.rows, p.bn, p.kc, p.threads, p.blocks)
    d = k.describe((20, 18, 32, 32, 4), 16, torch.float32, "full", dx=True)
    assert d["blocks"] == k.fma_plan(20, 20, 32, 32, 4, 16, -1, True).blocks


# -- K2's f32 plan ------------------------------------------------------------

def _smoke_f32_dw_shapes():
    """(B, D of g, H, W, Cin, Cout, off) of every f32 dW chip_smoke checks."""
    out = []
    for shapes, batch in ((chip_smoke.VAE_CONVS, chip_smoke.BATCH),
                          (chip_smoke.UNET_TRAIN, chip_smoke.UNET_BATCH)):
        for _, cin, cout, e, dt in shapes:
            if dt == "f32":
                out.append((batch, e, e, e, cin, cout, 0))
                out.append((batch, e // chip_smoke.SPATIAL, e, e, cin, cout, 1))
    return out


DW_SMOKE = _smoke_f32_dw_shapes()


def _check_dw_plan(p: kdw.DwFmaPlan):
    assert p.ct in kdw.FMA_CT and 1 <= p.ci_t <= min(p.cin, kdw.FMA_MAX_CI)
    assert p.smem <= kdw.SMEM_MAX and p.blocks_per_sm >= 1
    assert p.threads * p.regs * p.blocks_per_sm <= SM_REGS
    gx, gy = p.grid
    assert 1 <= gx < 2 ** 31 and 1 <= gy <= 65535
    assert 4 * p.ws_elems <= kdw.WS_MAX_BYTES
    assert p.xr >= (p.W + 2) * p.ci_t and p.xr % 32 == p.ci_t % 32
    assert p.ps >= (p.rows + 2) * p.xr and p.ps % 32 == 3 * p.ci_t % 32
    # the splits walk every chunk once, in increasing order, none empty
    ranges = p.split_ranges
    assert ranges[0][0] == 0 and ranges[-1][1] == p.chunks
    assert all(lo < hi for lo, hi in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    # the chunks cover every g row of every (b, d) plane once
    count = np.zeros((p.B, p.D, p.H), np.int32)
    for c in range(p.chunks):
        b, d, h0 = p.chunk_origin(c)
        count[b, d, h0:h0 + p.rows] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape", DW_SMOKE, ids=[
    f"{'valid' if s[6] else 'same'}-{s[4]}x{s[5]}@{s[2]}-b{s[0]}" for s in DW_SMOKE])
def test_dw_plan_limits_and_coverage_at_smoke_shapes(shape):
    p = kdw.fma_plan(*shape)
    _check_dw_plan(p)
    # the head's plan fills the card: at least one block per SM
    assert p.grid[0] * p.grid[1] >= kdw.SMS


def _replay_dw(x, g, off):
    """The f32 sliding-window kernel's arithmetic from ``fma_plan``, in
    float64 numpy: per split and channel tile, its chunks in order, each
    staged as the x window [3][rows + 2][W + 2][ci_t] (zero outside x) and
    the g tile [rows][W][ct]; thread (kd, kh, ci) adds window row r + kh,
    columns kw .. kw + W - 1, times g row r, into dW[kd, kh, kw]; the
    split slices summed in split order."""
    B, D, H, W, cout = g.shape
    cin = x.shape[4]
    p = kdw.fma_plan(B, D, H, W, cin, cout, off)
    roles = np.array([p.thread_role(t) for t in range(p.threads)])
    tkd, tkh, tci = roles[:, 0], roles[:, 1], roles[:, 2]
    ws = np.zeros((p.splits, 27, cin, cout))
    for s, (lo, hi) in enumerate(p.split_ranges):
        for tile in range(p.grid[0]):
            ci0 = (tile % p.ci_tiles) * p.ci_t
            co0 = (tile // p.ci_tiles) * p.ct
            acc = np.zeros((p.threads, 3, p.ct))
            for c in range(lo, hi):
                b, d, h0 = p.chunk_origin(c)
                win = np.zeros((3, p.rows + 2, W + 2, p.ci_t))
                gt = np.zeros((p.rows, W, p.ct))
                hh = h0 - 1 + np.arange(p.rows + 2)
                chs = ci0 + np.arange(p.ci_t)
                ok_h, ok_c = (hh >= 0) & (hh < H), chs < cin
                for kd in range(3):
                    dd = d + off + kd - 1
                    if 0 <= dd < D + 2 * off:
                        win[kd][np.ix_(np.nonzero(ok_h)[0], np.arange(1, W + 1),
                                       np.nonzero(ok_c)[0])] = \
                            x[b, dd][np.ix_(hh[ok_h], np.arange(W), chs[ok_c])]
                gr = h0 + np.arange(p.rows)
                cos = co0 + np.arange(p.ct)
                ok_r, ok_o = gr < H, cos < cout
                gt[np.ix_(ok_r, np.arange(W), ok_o)] = g[b, d][np.ix_(gr[ok_r], np.arange(W),
                                                                     cos[ok_o])]
                for r in range(min(p.rows, H - h0)):
                    xrow = win[tkd, r + tkh, :, tci]              # (threads, W + 2)
                    for kw in range(3):
                        acc[:, kw] += xrow[:, kw:kw + W] @ gt[r]
            for tid in range(p.threads):
                ci = ci0 + tci[tid]
                for kw in range(3):
                    for j in range(p.ct):
                        if ci < cin and co0 + j < cout:
                            tap = tkd[tid] * 9 + tkh[tid] * 3 + kw
                            ws[s, tap, ci, co0 + j] = acc[tid, kw, j]
    dw = np.zeros((27, cin, cout))
    for s in range(p.splits):
        dw += ws[s]
    return dw.reshape(3, 3, 3, cin, cout), p


DW_CASES = [
    # (B, D of g, H, W, Cin, Cout)
    (2, 3, 3, 1, 16, 4),       # W 1
    (3, 1, 5, 2, 16, 4),       # ragged B*D and rows
    (1, 2, 4, 33, 16, 4),      # W 33
    (1, 1, 3, 130, 16, 4),     # W 130
    (1, 1, 2, 300, 16, 4),     # W 300
    (2, 2, 3, 5, 14, 16),      # Cin 14: scalar x loads
    (1, 2, 3, 6, 32, 64),      # several output tiles
    (2, 2, 5, 4, 3, 9),        # odd channel counts
    (1, 1, 4, 4, 72, 4),       # two input-channel tiles
]


@pytest.mark.parametrize("off", [0, 1], ids=["same", "valid"])
@pytest.mark.parametrize("case", DW_CASES, ids=[
    f"b{c[0]}d{c[1]}h{c[2]}w{c[3]}-{c[4]}x{c[5]}" for c in DW_CASES])
def test_dw_plan_replay_matches_reference(case, off):
    B, D, H, W, cin, cout = case
    rng = np.random.default_rng([*case, off])
    x = rng.integers(-3, 4, (B, D + 2 * off, H, W, cin)).astype(np.float64)
    g = rng.integers(-3, 4, (B, D, H, W, cout)).astype(np.float64)
    got, p = _replay_dw(x, g, off)
    _check_dw_plan(p)
    fn = kdw.conv3d_dw_valid_reference if off else kdw.conv3d_dw_reference
    ref = fn(torch.from_numpy(x.astype(np.float32)), torch.from_numpy(g.astype(np.float32)))
    np.testing.assert_array_equal(got, ref.numpy())


def test_dw_plan_splits_wide_rows_into_column_segments():
    """A row too wide for the window (W = 1000 at 16 input channels) runs
    as column segments, each launch seeing one halo column per side; the
    replayed segments' dW, summed in order, is the exact dW."""
    p = kdw.fma_plan(1, 1, 2, 1000, 16, 4, 0)
    assert p.segments > 1 and p.W == p.seg_w + 2 and p.smem <= kdw.SMEM_MAX
    assert (p.segments - 1) * p.seg_w < 1000 <= p.segments * p.seg_w
    assert kdw.fma_plan(1, 1, 2, 33, 16, 4, 0).segments == 1
    rng = np.random.default_rng(5)
    x = rng.integers(-3, 4, (1, 1, 2, 1000, 16)).astype(np.float32)
    g = rng.integers(-3, 4, (1, 1, 2, 1000, 4)).astype(np.float32)
    got = np.zeros((3, 3, 3, 16, 4))
    for xs, gs in kdw.column_segments(torch.from_numpy(x), torch.from_numpy(g), p.seg_w):
        part, q = _replay_dw(xs.numpy().astype(np.float64), gs.numpy().astype(np.float64), 0)
        assert q.segments == 1 and q.W == p.W
        got += part
    ref = kdw.conv3d_dw_reference(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_array_equal(got, ref.numpy())


def test_dw_plan_splits_many_chunks_and_writes_one_split_directly():
    """The head at batch 20 splits its chunks over hundreds of blocks
    (workspace summed in order); a plan of one split writes dW itself."""
    p = kdw.fma_plan(20, 32, 32, 32, 16, 4, 0)
    assert p.splits >= kdw.SMS and not p.direct and p.ws_elems == p.splits * 27 * 16 * 4
    p = kdw.fma_plan(1, 1, 1, 1, 16, 4, 0)
    assert p.splits == 1 and p.direct and p.ws_elems == 0


def test_dw_describe_reports_the_f32_tile():
    d = kdw.describe((20, 32, 32, 32, 16), (20, 32, 32, 32, 4), torch.float32)
    p = kdw.fma_plan(20, 32, 32, 32, 16, 4, 0)
    assert d["path"] == "fma+slide" and d["splits"] == p.splits
    assert (d["ci_t"], d["ct"], d["rows"], d["ws_bytes"]) == (p.ci_t, p.ct, p.rows,
                                                              4 * p.ws_elems)
    d = kdw.describe((20, 18, 32, 32, 16), (20, 16, 32, 32, 4), torch.float32, 1)
    assert d["splits"] == kdw.fma_plan(20, 16, 32, 32, 16, 4, 1).splits
