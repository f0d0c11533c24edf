"""The bf16 weight-gradient kernel's decomposition (``kernels/conv3d_dw.plan``)
on the CPU: no GPU, no JAX.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
here its plan is checked at every shape ``chip_smoke.py`` launches, and
replayed in numpy -- the padded g positions, the x window with its halo
and guard, each tap's offset into it, the channel tiles and the split sum
in split order -- against the plain versions ``conv3d_dw_reference`` and
``conv3d_dw_valid_reference``.  Tolerance: max |replay - reference| <=
1e-6 * max |reference| on Gaussian operands (f32 sums in another order),
and exact equality on small-integer operands (every product and sum is
exact in f32).
"""

import os
import sys

import numpy as np
import pytest
import torch

from icsg3d_torch.kernels import conv3d_dw as kdw

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its shape tables; it imports nothing at load)


def _smoke_shapes():
    """(B, D of g, H, W, Cin, Cout, off) of every bf16 dW chip_smoke checks,
    SAME and VALID (a 1 x SPATIAL mesh slab)."""
    out = []
    for shapes, batch in ((chip_smoke.VAE_CONVS, chip_smoke.BATCH),
                          (chip_smoke.UNET_TRAIN, chip_smoke.UNET_BATCH)):
        for _, cin, cout, e, dt in shapes:
            if dt == "bf16":
                out.append((batch, e, e, e, cin, cout, 0))
                out.append((batch, e // chip_smoke.SPATIAL, e, e, cin, cout, 1))
    return out


SMOKE = _smoke_shapes()


@pytest.mark.parametrize("shape", SMOKE, ids=[
    f"{'valid' if s[6] else 'same'}-{s[4]}x{s[5]}@{s[2]}-b{s[0]}" for s in SMOKE])
def test_plan_limits_and_coverage_at_smoke_shapes(shape):
    B, D, H, W, cin, cout, off = shape
    p = kdw.plan(B, D, H, W, cin, cout, off)
    gx, gy, gz = p.grid
    assert 1 <= gx < 2 ** 31 and gy == 3 and 1 <= gz <= 65535
    assert p.smem <= kdw.SMEM_MAX
    assert 4 * p.ws_elems <= kdw.WS_MAX_BYTES
    assert p.direct == (p.ws_elems == 0)
    assert p.kc % 16 == 0 and p.kc >= p.rows * p.pitch and 1 <= p.rows <= H
    assert max(p.tap_offsets) + p.kc == p.lx  # the last tap's view ends the window
    # the split ranges cover the chunks exactly once, none empty
    ranges = p.split_ranges
    assert ranges[0][0] == 0 and ranges[-1][1] == p.chunks
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    # the chunks cover every g row of every (b, d) plane exactly once
    count = np.zeros((B, D, H), np.int32)
    for c in range(p.chunks):
        b, d, h0 = p.chunk_origin(c)
        count[b, d, h0:h0 + p.rows] += 1
    assert (count == 1).all()
    # the channel tiles cover (Cin_p, Cout_p) exactly once
    m_ch, n_ch = (p.cout_p, p.cin_p) if p.swap else (p.cin_p, p.cout_p)
    assert (p.m_tiles - 1) * 64 < m_ch <= p.m_tiles * 64
    assert (p.n_tiles - 1) * p.bn < n_ch <= p.n_tiles * p.bn


@pytest.mark.parametrize("off", [0, 1], ids=["same", "valid"])
def test_plan_split_rule_fills_the_card(off):
    """Every SAME U-Net shape at batch 10 launches blocks for at least 72%
    of the 132 SMs (one block each; the half-depth VALID slabs have half
    the chunks to split); in both modes the four widest (conv11-14) split
    K, and conv7-10 take one split, writing dW directly: their tiles alone
    give 96-288 blocks, and a second split costs its workspace traffic."""
    for name, cin, cout, e, _ in chip_smoke.UNET_TRAIN:
        d = e // chip_smoke.SPATIAL if off else e
        p = kdw.plan(chip_smoke.UNET_BATCH, d, e, e, cin, cout, off)
        if not off:
            assert p.grid[0] * p.grid[1] * p.grid[2] >= 0.72 * kdw.SMS, name
        if name in ("unet.conv11", "unet.conv12", "unet.conv13", "unet.conv14"):
            assert p.splits > 1, name
        if name in ("unet.conv7", "unet.conv8", "unet.conv9", "unet.conv10"):
            assert p.direct, name


def _replay(x, g, off):
    """The wrapper's and the kernel's arithmetic, in float64 numpy, from
    ``plan``: the column segments (``column_segments``) summed in order,
    each segment replayed by ``_replay_launch``."""
    B, D, H, W, cout = g.shape
    p = kdw.plan(B, D, H, W, x.shape[4], cout, off)
    if p.segments == 1:
        return _replay_launch(x, g, off, p)
    parts = [_replay_launch(xs.numpy(), gs.numpy(), off, p)[0]
             for xs, gs in kdw.column_segments(torch.from_numpy(x), torch.from_numpy(g),
                                               p.seg_w)]
    assert len(parts) == p.segments
    dw = parts[0]
    for part in parts[1:]:
        dw = dw + part
    return dw, p


def _replay_launch(x, g, off, p):
    """One launch of plan ``p``, in float64 numpy: per split, per channel
    tile, per chunk and kd, the staged g chunk and x window, then per tap
    the window slice at its offset times the chunk; the splits summed in
    order."""
    B, D, H, W, cout = g.shape
    cin = x.shape[4]
    assert (B, D, H, W, cin, cout) == (p.B, p.D, p.H, p.W, p.cin, p.cout)
    P, Dx = p.pitch, D + 2 * off
    xp = np.zeros(x.shape[:4] + (p.cin_p,))
    xp[..., :cin] = x
    gp = np.zeros(g.shape[:4] + (p.cout_p,))
    gp[..., :cout] = g
    # g chunk positions q -> (row, col); x window positions -> (row - 1, col)
    q = np.arange(p.kc)
    gr, gc = q // P, q % P
    s = np.arange(p.lx) - 1
    xr, xc = np.where(s >= 0, s // P, -1), np.where(s >= 0, s % P, P - 1)
    ws = np.zeros((p.splits, 27, p.cin_p, p.cout_p))
    written = np.zeros((p.splits, 27, p.cin_p, p.cout_p), np.int32)
    m_ch = p.cout_p if p.swap else p.cin_p
    for si, (c0, c1) in enumerate(p.split_ranges):
        for mt in range(p.m_tiles):
            for nt in range(p.n_tiles):
                m = np.arange(mt * 64, min(mt * 64 + 64, m_ch))
                n = np.arange(nt * p.bn, min(nt * p.bn + p.bn, p.cin_p if p.swap else p.cout_p))
                ci, co = (n, m) if p.swap else (m, n)
                for kd in range(3):
                    acc = np.zeros((9, len(ci), len(co)))
                    for c in range(c0, c1):
                        b, d, h0 = p.chunk_origin(c)
                        ok = (gr < p.rows) & (h0 + gr < H) & (gc < W)
                        gch = np.zeros((p.kc, len(co)))
                        gch[ok] = gp[b, d, (h0 + gr)[ok], gc[ok]][:, co]
                        win = np.zeros((p.lx, len(ci)))
                        xd = d + kd - 1 + off
                        if 0 <= xd < Dx:
                            h = h0 + xr - 1
                            ok = (s >= 0) & (xc < W) & (h >= 0) & (h < H)
                            win[ok] = xp[b, xd, h[ok], xc[ok]][:, ci]
                        for t in range(9):
                            o = p.tap_offsets[kd * 9 + t]
                            acc[t] += win[o:o + p.kc].T @ gch
                    for t in range(9):
                        ws[si, kd * 9 + t][np.ix_(ci, co)] = acc[t]
                        written[si, kd * 9 + t][np.ix_(ci, co)] += 1
    assert (written == 1).all()  # every workspace element written once
    dw = np.zeros((27, p.cin_p, p.cout_p))
    for si in range(p.splits):  # the second pass: split order
        dw += ws[si]
    return dw[:, :cin, :cout].reshape(3, 3, 3, cin, cout), p


REPLAY_CASES = [
    # (B, D of g, H, W, Cin, Cout)
    (2, 2, 2, 2, 4, 40),
    (2, 4, 4, 4, 14, 4),
    (2, 8, 8, 8, 24, 40),
    (2, 3, 5, 7, 14, 40),     # W != H, ragged rows and chunks
    (2, 4, 8, 6, 24, 4),
    (2, 2, 4, 2, 4, 4),
    (1, 3, 9, 8, 72, 24),     # two M tiles, not swapped
]


@pytest.mark.parametrize("off", [0, 1], ids=["same", "valid"])
@pytest.mark.parametrize("case", REPLAY_CASES, ids=[
    f"b{c[0]}d{c[1]}h{c[2]}w{c[3]}-{c[4]}x{c[5]}" for c in REPLAY_CASES])
def test_plan_replay_matches_reference(case, off):
    B, D, H, W, cin, cout = case
    rng = np.random.default_rng(hash(case) % 2 ** 32 + off)
    x = rng.standard_normal((B, D + 2 * off, H, W, cin)).astype(np.float32)
    g = rng.standard_normal((B, D, H, W, cout)).astype(np.float32)
    ref_fn = kdw.conv3d_dw_valid_reference if off else kdw.conv3d_dw_reference
    ref = ref_fn(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    got, _ = _replay(x.astype(np.float64), g.astype(np.float64), off)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    # small integers: every product and partial sum is exact in f32 and f64
    xi = rng.integers(-3, 4, x.shape).astype(np.float32)
    gi = rng.integers(-3, 4, g.shape).astype(np.float32)
    ref = ref_fn(torch.from_numpy(xi), torch.from_numpy(gi)).numpy()
    got, _ = _replay(xi.astype(np.float64), gi.astype(np.float64), off)
    np.testing.assert_array_equal(got, ref)


WIDE_ROW_CASES = [
    # (B, D of g, H, W, Cin, Cout): rows too wide for one launch's window
    (1, 2, 2, 112, 128, 128),
    (1, 2, 2, 128, 128, 128),
    (1, 2, 3, 112, 192, 128),
    (1, 2, 2, 128, 192, 128),
]


@pytest.mark.parametrize("off", [0, 1], ids=["same", "valid"])
@pytest.mark.parametrize("case", WIDE_ROW_CASES, ids=[
    f"w{c[3]}-{c[4]}x{c[5]}" for c in WIDE_ROW_CASES])
def test_plan_splits_wide_rows_and_replays_them(case, off):
    """W >= 112 with both channel sides >= 64: the plan splits the row into
    column segments (each launch fits shared memory), and the segments'
    summed replay equals the plain version exactly on small integers."""
    B, D, H, W, cin, cout = case
    p = kdw.plan(B, D, H, W, cin, cout, off)
    assert p.segments >= 2 and p.smem <= kdw.SMEM_MAX and p.tma
    assert (p.segments - 1) * p.seg_w < W <= p.segments * p.seg_w
    rng = np.random.default_rng(W + cin + off)
    x = rng.integers(-3, 4, (B, D + 2 * off, H, W, cin)).astype(np.float32)
    g = rng.integers(-3, 4, (B, D, H, W, cout)).astype(np.float32)
    ref_fn = kdw.conv3d_dw_valid_reference if off else kdw.conv3d_dw_reference
    ref = ref_fn(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    got, _ = _replay(x.astype(np.float64), g.astype(np.float64), off)
    np.testing.assert_array_equal(got, ref)


def test_plan_splits_a_long_k_and_replays_it():
    """A shape whose plan takes several splits: the fixed-order sum of the
    slices equals the reference."""
    B, D, H, W, cin, cout = 2, 8, 16, 16, 8, 8
    p = kdw.plan(B, D, H, W, cin, cout, 0)
    assert p.splits > 1 and not p.direct
    rng = np.random.default_rng(11)
    x = rng.integers(-3, 4, (B, D, H, W, cin)).astype(np.float32)
    g = rng.integers(-3, 4, (B, D, H, W, cout)).astype(np.float32)
    got, _ = _replay(x.astype(np.float64), g.astype(np.float64), 0)
    ref = kdw.conv3d_dw_reference(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_plan_roles_and_padding():
    """Small Cin goes on wgmma's N (Cout on M); channels pad to 8; a row
    too wide for shared memory is split into column segments that fit."""
    p = kdw.plan(10, 32, 32, 32, 4, 32, 0)   # U-Net conv1
    assert p.swap and p.bn == 8 and p.cin_p == 8 and p.m_tiles == 1
    p = kdw.plan(20, 32, 32, 32, 14, 16, 0)  # VAE encoder Conv_0
    assert not p.swap and p.cin_p == 16 and p.bn == 16
    p = kdw.plan(20, 2, 2, 2, 128, 4, 0)     # VAE encoder Conv_4
    assert not p.swap and p.cout_p == 8 and p.bn == 8 and p.m_tiles == 2
    p = kdw.plan(10, 8, 8, 8, 768, 512, 0)   # U-Net conv9: one split, dW direct
    assert p.direct and p.ws_elems == 0
    p = kdw.plan(1, 1, 1, 4000, 64, 64, 0)
    assert p.segments > 1 and p.W == p.seg_w + 2 and p.smem <= kdw.SMEM_MAX
    assert (p.segments - 1) * p.seg_w < 4000 <= p.segments * p.seg_w


def test_describe_reports_path_and_workspace():
    d = kdw.describe((20, 32, 32, 32, 16), (20, 32, 32, 32, 4), torch.float32)
    assert d["path"] == "fma+slide" and d["ws_bytes"] == 4 * d["splits"] * 27 * 16 * 4
    d = kdw.describe((10, 32, 32, 32, 192), (10, 32, 32, 32, 128), torch.bfloat16)
    p = kdw.plan(10, 32, 32, 32, 192, 128, 0)
    assert d["path"] == "wgmma+tma" and d["ws_bytes"] == 4 * p.ws_elems
    assert d["splits"] == p.splits


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 2, 2, 2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kdw.conv3d_dw_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        kdw.conv3d_dw_valid_cuda(x, x[:, :0])


def test_build_tag_covers_headers_and_flags(tmp_path):
    """A kernel library is named by a hash of its source, every header
    beside it and the nvcc flags: editing any of them names a new build."""
    from icsg3d_torch.kernels._nvcc import build_tag

    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    bare = build_tag(src)
    assert build_tag(src) == bare
    assert build_tag(src, ("-Xptxas", "-v")) != bare
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    with_header = build_tag(src)
    assert with_header != bare
    header.write_text("// v2\n")
    assert build_tag(src) != with_header
