"""Weight gradient of the 3x3x3 conv, SAME or depth-VALID: the Hopper
kernel, its launch plan, its loader, and its plain PyTorch versions.

Replaces the Pallas TPU kernel K2, ``icsg3d_tpu/ops/lowc_conv.py::
_dw_kernel`` (launched by ``conv3d_lowc_ndcs_dw``, lowc_conv.py:372-434):

    dW[dd, dh, dw, ci, co] = sum over (b, d, h, w) of
        x[b, d+dd-1, h+dh-1, w+dw-1, ci] * g[b, d, h, w, co]

with x zero outside the grid, f32 out in the DHWIO layout of the conv's
kernel parameter.  The bf16 kernel (``icsg3d_torch/csrc/conv3d_dw.cu``)
runs K over g's positions on a plane padded to a row pitch of W + 1 (g
zero at the pad column), so each of the 27 taps reads the staged x
window at a constant offset: chunks of ``rows`` g rows of one (b, d)
plane are staged once (by TMA where both channel tiles are 64 wide, else
by cp.async) and feed the nine taps of one kd on wgmma.  K is
split across blocks into an f32 workspace that a second pass sums in a
fixed order (deterministic).  ``plan`` is that decomposition in Python:
the wrapper launches from it, and ``tests/test_torch_dw_plan.py`` replays
it in numpy.  f32 operands (the VAE's f32 output head) run on an FMA
kernel.  See the note in the .cu file for what bounds it.

The VALID mode (``conv3d_dw_valid_cuda``, K2's ``depth_valid``,
lowc_conv.py:380-387) takes x as a halo-padded depth slab of D + 2 planes
and g with D: the per-shard dW of a depth-sharded conv (parallel/halo.py).
The split-K ranges run over g's chunks.  Counters: ``launches`` (SAME),
``launches_valid`` (VALID).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from icsg3d_torch.kernels._nvcc import PKG, build_library

SOURCE = PKG / "csrc" / "conv3d_dw.cu"

# The H100's streaming multiprocessors; the bf16 kernel runs one block of
# three warpgroups per SM, so the split rule fills 132 block slots.
SMS = 132
SMEM_MAX = 232_448 - 1024         # dynamic shared memory a block may ask for
STAGES = 4                        # bf16 ring: chunks in flight + in use
KC_TARGET = 144                   # g positions per staged chunk, about
MIN_CHUNKS = 4                    # chunks per split, at least
WS_MAX_BYTES = 32 << 20           # the split-K workspace, at most
MAX_SPLITS = 64
# The split rule's cost model: a block (one per SM) works through its
# chunks' stage bytes at about this rate (H100, the U-Net's 128->128 conv
# at 32^3 on the TMA path: 233 chunks of 46 KB in 0.483 ms), and the
# workspace crosses device memory at about this rate.
STAGE_BYTES_PER_S = 22e9
WS_BYTES_PER_S = 2.5e12
_BN_CHOICES = (8, 16, 32, 64)     # wgmma N of the narrow channel side
_FMA_TILE = {4: (128, 4), 16: (32, 16)}  # f32: column threads -> (rows, cols)
_FMA_TARGET_BLOCKS = 8 * SMS
_FMA_BK = 32

# Incremented once per kernel launch, never by the plain version.
launches = 0
launches_valid = 0

_lib = None


def reset_launches() -> None:
    global launches, launches_valid
    launches = launches_valid = 0


def build(flags=(), verbose: bool = False) -> Path:
    """Compile ``csrc/conv3d_dw.cu`` for sm_90a; returns the library path."""
    return build_library(SOURCE, "libconv3d_dw", flags, verbose)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.conv3d_dw_bf16.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 + [ctypes.c_void_p])
        lib.conv3d_dw_f32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.conv3d_dw_bf16.restype = lib.conv3d_dw_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class DwPlan:
    """The bf16 kernel's decomposition of one weight gradient.

    Channels are padded to multiples of 8 (``cin_p``, ``cout_p``).  The
    wide channel side sits on wgmma's M (tiles of 64), the other on N
    (tiles of ``bn``); ``swap`` puts Cout on M (small Cin); ``tma`` (64
    channels on both sides) stages by TMA, else by cp.async.  K runs over
    ``chunks``: ``rows`` g rows of one (b, d) plane at the row pitch
    ``pitch`` = W + 1, ``kc`` positions (a multiple of wgmma's K of 16,
    g zero past the rows and at column W).  The x window of a chunk is
    ``lx`` positions of one x plane at the same pitch, window position 0
    being the zero guard one before row h0 - 1; tap (kd, kh, kw) reads it
    from ``tap_offsets[tap] = kh*pitch + kw`` on, plane d + kd - 1 + off.
    Grid (m_tiles * n_tiles, 3 kd, splits); split s sums chunks
    ``split_ranges[s]`` into its slice of ``ws_elems`` f32 (none when
    ``direct``: one split and no channel padding write dW itself).

    A row too wide for shared memory is split into ``segments`` column
    segments of ``seg_w`` g columns each; the geometry above is then that
    of one segment's launch, of width ``W`` = ``seg_w`` + 2: the x segment
    carries one halo column on each side (zero at the grid's edges) and the
    g segment is zero in those two columns, so each launch gives the exact
    dW of its columns and the wrapper sums them in segment order.
    """

    B: int
    D: int
    H: int
    W: int
    cin: int
    cout: int
    off: int
    cin_p: int
    cout_p: int
    swap: bool
    bn: int
    tma: bool
    m_tiles: int
    n_tiles: int
    pitch: int
    rows: int
    kc: int
    lx: int
    chunks: int
    per: int
    splits: int
    smem: int
    ws_elems: int
    direct: bool
    segments: int = 1
    seg_w: int = 0

    @property
    def grid(self):
        return (self.m_tiles * self.n_tiles, 3, self.splits)

    @property
    def row_blocks(self) -> int:
        return _ceil(self.H, self.rows)

    @property
    def tap_offsets(self):
        return tuple(kh * self.pitch + kw
                     for kd in range(3) for kh in range(3) for kw in range(3))

    @property
    def split_ranges(self):
        return [(s * self.per, min((s + 1) * self.per, self.chunks))
                for s in range(self.splits)]

    def chunk_origin(self, c: int):
        """Chunk c's g plane and first row: (b, d, h0)."""
        bd, rb = divmod(c, self.row_blocks)
        b, d = divmod(bd, self.D)
        return b, d, rb * self.rows

    @property
    def path(self) -> str:
        return "wgmma+tma" if self.tma else "wgmma+cp.async"


def _stage_bytes(x_ch: int, g_ch: int, kc: int, lx: int, tma: bool) -> int:
    """One ring stage: x window and g chunk.  TMA: 128-byte rows, the window
    rounded up to whole 1024-byte swizzle atoms; cp.async: 16 bytes per 8
    channels, each channel group's positions padded to 1 mod 8."""
    if tma:
        return 128 * (_ceil(lx, 8) * 8 + kc)
    return 16 * (x_ch // 8 * (lx + (9 - lx % 8) % 8) + g_ch // 8 * (kc + 1))


@functools.lru_cache(maxsize=1024)
def plan(B: int, D: int, H: int, W: int, cin: int, cout: int, off: int) -> DwPlan:
    """The bf16 kernel's launch plan for x (B, D + 2*off, H, W, cin) and g
    (B, D, H, W, cout).  A row too wide for shared memory is split into the
    fewest column segments whose launches fit (see ``DwPlan``)."""
    p = _launch_plan(B, D, H, W, cin, cout, off)
    if p is not None:
        return dataclasses.replace(p, seg_w=W)
    for segments in range(2, W + 1):
        seg_w = _ceil(W, segments)
        p = _launch_plan(B, D, H, seg_w + 2, cin, cout, off)
        if p is not None:
            return dataclasses.replace(p, segments=_ceil(W, seg_w), seg_w=seg_w)
    raise ValueError(f"conv3d_dw: no column segment of a row of width {W} fits")


def _launch_plan(B, D, H, W, cin, cout, off):
    """One launch's plan at row width W, or None if a row does not fit in
    shared memory."""
    cin_p, cout_p = _ceil(cin, 8) * 8, _ceil(cout, 8) * 8
    swap = cin_p < 64 and cout_p > cin_p
    m_ch, n_ch = (cout_p, cin_p) if swap else (cin_p, cout_p)
    bn = next(n for n in _BN_CHOICES if n >= min(n_ch, 64))
    x_ch, g_ch = (bn, 64) if swap else (64, bn)
    pitch = W + 1
    tma = bn == 64 and not swap and pitch <= 256
    rows = max(1, min(H, KC_TARGET // pitch))
    while True:
        kc = _ceil(rows * pitch, 16) * 16
        lx = kc + 2 * pitch + 2
        smem = STAGES * _stage_bytes(x_ch, g_ch, kc, lx, tma) + (1024 if tma else 0)
        if smem <= SMEM_MAX or rows == 1:
            break
        rows -= 1
    if smem > SMEM_MAX:
        return None
    m_tiles, n_tiles = _ceil(m_ch, 64), _ceil(n_ch, bn)
    chunks = B * D * _ceil(H, rows)
    tiles = m_tiles * n_tiles * 3
    per_split = 27 * cin_p * cout_p
    padded = cin_p != cin or cout_p != cout
    s_max = max(1, min(chunks // MIN_CHUNKS, WS_MAX_BYTES // (4 * per_split), MAX_SPLITS))
    t_chunk = _stage_bytes(x_ch, g_ch, kc, lx, tma) / STAGE_BYTES_PER_S

    def cost(s):
        """(estimated seconds, splits): the block waves times a block's
        chunks, plus the workspace written, read and summed into dW."""
        per = _ceil(chunks, s)
        s = _ceil(chunks, per)
        t = _ceil(tiles * s, SMS) * per * t_chunk
        if s > 1 or padded:
            t += 4 * per_split * (2 * s + 1) / WS_BYTES_PER_S
        return t, s

    splits = min((cost(s) for s in range(1, s_max + 1)))[1]
    per = _ceil(chunks, splits)
    direct = splits == 1 and not padded
    return DwPlan(B, D, H, W, cin, cout, off, cin_p, cout_p, swap, bn, tma, m_tiles,
                  n_tiles, pitch, rows, kc, lx, chunks, per, splits, smem,
                  0 if direct else splits * per_split, direct)


def _fma_splits(vox: int, cin: int, cout: int) -> int:
    """f32 head: how many blocks share the voxel axis, enough for
    ``_FMA_TARGET_BLOCKS`` over the tiles, at most one per 32 voxels."""
    rows, cols = _FMA_TILE[4 if cout <= 4 else 16]
    tiles = _ceil(27 * cin, rows) * _ceil(cout, cols)
    return max(1, min(_ceil(_FMA_TARGET_BLOCKS, tiles), _ceil(vox, _FMA_BK)))


def describe(x_shape, g_shape, dtype: torch.dtype, off: int = 0) -> dict:
    """What one launch runs, for a report: the path (``wgmma`` or ``fma``),
    the split count and the workspace bytes."""
    B, D, H, W, cout = g_shape
    cin = x_shape[4]
    if dtype == torch.float32:
        splits = _fma_splits(B * D * H * W, cin, cout)
        return {"path": "fma", "splits": splits, "ws_bytes": 4 * splits * 27 * cin * cout}
    p = plan(B, D, H, W, cin, cout, off)
    return {"path": p.path, "splits": p.splits, "ws_bytes": 4 * p.ws_elems,
            "swap": p.swap, "bn": p.bn, "rows": p.rows, "kc": p.kc, "smem": p.smem}


def conv3d_dw_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the weight-gradient kernel on CUDA tensors.

    x: (B, D, H, W, Cin) conv input; g: (B, D, H, W, Cout) cotangent; both
    contiguous, one dtype, bf16 or f32.  Returns dW (3, 3, 3, Cin, Cout)
    float32.  Raises on anything else; never falls back.
    """
    global launches
    dw = _launch(x, g, 0, "conv3d_dw_cuda")
    launches += 1
    return dw


def conv3d_dw_valid_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient of the depth-VALID conv on CUDA tensors: x (B,
    D + 2, H, W, Cin) the halo-padded slab, g (B, D, H, W, Cout).  Returns
    dW (3, 3, 3, Cin, Cout) float32; checks as in ``conv3d_dw_cuda``."""
    global launches_valid
    dw = _launch(x, g, 1, "conv3d_dw_valid_cuda")
    launches_valid += 1
    return dw


def _pad_channels(t: torch.Tensor, to: int) -> torch.Tensor:
    """t with its channels zero-padded to ``to`` (16-byte voxel rows)."""
    return t if t.shape[-1] == to else torch.nn.functional.pad(t, (0, to - t.shape[-1]))


def _launch(x, g, off, name):
    """One launch with x's depth window offset by ``off`` planes (x has
    g's depth + 2*off planes)."""
    if not (x.is_cuda and g.is_cuda):
        raise ValueError(f"{name} needs CUDA tensors")
    if (x.dim() != 5 or g.dim() != 5 or x.shape[0] != g.shape[0]
            or x.shape[1] != g.shape[1] + 2 * off or x.shape[2:4] != g.shape[2:4]):
        raise ValueError(
            f"want x (B,D{' + 2' if off else ''},H,W,Cin) and g (B,D,H,W,Cout), got "
            f"{tuple(x.shape)} and {tuple(g.shape)}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16) or g.dtype != x.dtype:
        raise ValueError(
            f"x and g must share dtype float32 or bfloat16, got {x.dtype}, {g.dtype}"
        )
    if g.device != x.device:
        raise ValueError(f"g is on {g.device}, x on {x.device}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("x and g must be contiguous")
    if min(g.shape) == 0 or x.shape[4] == 0:
        raise ValueError(f"{name}: empty operand {tuple(x.shape)}, {tuple(g.shape)}")
    B, D, H, W, cout = g.shape
    cin = x.shape[4]
    lib = load()
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.float32:
            splits = _fma_splits(B * D * H * W, cin, cout)
            ws = torch.empty(splits * 27 * cin * cout, dtype=torch.float32, device=x.device)
            err = lib.conv3d_dw_f32(x.data_ptr(), g.data_ptr(), ws.data_ptr(),
                                    dw.data_ptr(), B, D, H, W, cin, cout, splits, off,
                                    stream)
        else:
            p = plan(B, D, H, W, cin, cout, off)
            xp, gp = _pad_channels(x, p.cin_p), _pad_channels(g, p.cout_p)
            if p.segments == 1:
                err = _launch_bf16(lib, p, xp, gp, dw, stream)
            else:
                err, total = 0, None
                for xs, gs in column_segments(xp, gp, p.seg_w):
                    part = torch.empty_like(dw)
                    err = err or _launch_bf16(lib, p, xs, gs, part, stream)
                    total = part if total is None else total.add_(part)
                dw.copy_(total)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return dw


def column_segments(x, g, seg_w: int):
    """x (.., W, C) and g cut into column segments of ``seg_w`` g columns:
    each x segment with one halo column on each side (zero at the grid's
    edges), each g segment zero-padded to the same seg_w + 2 columns (zero
    in its first and last).  The SAME dW of each pair is exactly the dW of
    its g columns; their sum over the segments is the whole dW."""
    F = torch.nn.functional
    W = g.shape[3]
    xw = F.pad(x, (0, 0, 1, seg_w + 1))  # x column c at c + 1
    for c0 in range(0, W, seg_w):
        n = min(seg_w, W - c0)
        yield (xw[:, :, :, c0:c0 + seg_w + 2].contiguous(),
               F.pad(g[:, :, :, c0:c0 + n], (0, 0, 1, seg_w + 1 - n)).contiguous())


def _launch_bf16(lib, p: DwPlan, x, g, dw, stream) -> int:
    """One bf16 launch of plan ``p`` (its row width p.W) into dw."""
    ws = dw if p.direct else torch.empty(p.ws_elems, dtype=torch.float32, device=x.device)
    B, D, H, W = g.shape[:4]
    return lib.conv3d_dw_bf16(
        x.data_ptr(), g.data_ptr(), ws.data_ptr(), dw.data_ptr(),
        B, D, H, W, p.cin_p, p.cout_p, p.cin, p.cout, p.off, p.rows, p.kc,
        p.splits, p.per, int(p.swap), p.bn, stream)


def conv3d_dw_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: for each of the 27 taps, the f32 product
    of the tap-shifted, zero-padded x (voxels x Cin) with g (voxels x
    Cout), on the same (x.dtype) operands.

    On CUDA tensors it serves as the oracle for the kernel, so it turns
    TF32 off for cuBLAS matmuls (``torch.backends.cuda.matmul.allow_tf32 =
    False``): TF32 keeps about three decimal digits.
    """
    return _reference(x, g, 1)


def conv3d_dw_valid_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain version of ``conv3d_dw_valid_cuda``: ``conv3d_dw_reference``
    without the depth pad (x has g's depth + 2 planes)."""
    return _reference(x, g, 0)


def _reference(x, g, depth_pad):
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    B, D, H, W, cout = g.shape
    cin = x.shape[4]
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1, depth_pad, depth_pad))
    gf = g.float().reshape(-1, cout)
    dw = torch.empty((27, cin, cout), dtype=torch.float32, device=x.device)
    for tap in range(27):
        dd, dh, dwi = tap // 9, (tap // 3) % 3, tap % 3
        xs = xp[:, dd:dd + D, dh:dh + H, dwi:dwi + W].reshape(-1, cin)
        dw[tap] = xs.t() @ gf
    return dw.reshape(3, 3, 3, cin, cout)
