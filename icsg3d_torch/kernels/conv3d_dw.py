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
it in numpy.  f32 operands (the VAE's f32 output head) run on an f32
sliding-window kernel on the CUDA cores (exact f32 products, no TF32):
a block stages one chunk's x window and g rows once, each thread owns a
(kd, kh, input channel) and slides three x values along each g row;
``fma_plan`` decides the channel tiles, rows per chunk and splits, and
``tests/test_torch_fma_plan.py`` replays it in numpy.  See the note in the
.cu file for what bounds them.

The VALID mode (``conv3d_dw_valid_cuda``, K2's ``depth_valid``,
lowc_conv.py:380-387) takes x as a halo-padded depth slab of D + 2 planes
and g with D: the per-shard dW of a depth-sharded conv (parallel/halo.py).
The split-K ranges run over g's chunks.  Counters: ``launches`` (SAME),
``launches_valid`` (VALID).

Capture: the workspace comes from torch's allocator, both passes run on
torch's current stream with no sync, the plan and TMA descriptors are
fixed on the host and the shared-memory limit is set once per shape
(csrc/smem_limit.cuh), so after one launch at a shape it may be captured
in a CUDA graph (train/graphs.py).
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
# The f32 sliding-window kernel: output channels per block (its
# instantiations), input channels per block (9 threads each), and one
# SM's budget for the plan's occupancy estimate.
FMA_CT = (4, 8, 16)
FMA_REGS = {4: 55, 8: 56, 16: 91}  # registers per thread (ptxas -v, sm_90a build)
FMA_MAX_CI = 64
SM_SMEM = 233_472                 # shared memory of one SM (228 KB)
SM_THREADS, SM_BLOCKS, SM_REGS = 2048, 32, 65_536
_FMA_CHUNK_CLOCKS = 300           # a chunk's two barriers (its loads overlap the last)
_CLOCK_HZ = 1.755e9               # H100 SXM boost clock, for the workspace term
_SPLIT_SUM_CLOCKS = 60            # reduce_splits_kernel: one thread's serial add per split

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
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
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


def _pad32(v: int, want: int) -> int:
    """The least v' >= v with v' = want (mod 32)."""
    return v + (want - v) % 32


@dataclass(frozen=True)
class DwFmaPlan:
    """The f32 kernel's decomposition of one weight gradient.

    A block owns ``ci_t`` input channels (9 threads each: (kd, kh, ci),
    ci fastest) x ``ct`` output channels; grid (``ci_tiles`` *
    ``co_tiles``, ``splits``), the input-channel tile fastest.  K runs
    over ``chunks`` of ``rows`` g rows of one (b, d) plane, in the order
    of ``chunk_origin``; split s walks chunks ``split_ranges[s]`` in
    increasing order.  A chunk's x window is 3 planes (d + off - 1 ..) x
    (rows + 2) rows (from h0 - 1) x (W + 2) columns (from -1) x ci_t
    channels, at row stride ``xr`` and plane stride ``ps`` (floats); its g
    tile rows x W x ct; two such stages, the next chunk loading (cp.async)
    while this one is summed.  Thread (kd, kh, ci) adds x at window column w +
    kw of row r + kh, plane kd, times g at (r, w) into dW[kd, kh, kw].
    ``ws_elems`` f32 of workspace (0 when ``direct``: one split writes dW
    itself).  A row too wide for shared memory runs as ``segments``
    column segments of ``seg_w`` g columns, each a launch of width ``W`` =
    ``seg_w`` + 2, as in ``DwPlan``.
    """

    B: int
    D: int
    H: int
    W: int
    cin: int
    cout: int
    off: int
    ci_t: int
    ct: int
    rows: int
    per: int
    splits: int
    segments: int = 1
    seg_w: int = 0

    @property
    def ci_tiles(self) -> int:
        return _ceil(self.cin, self.ci_t)

    @property
    def co_tiles(self) -> int:
        return _ceil(self.cout, self.ct)

    @property
    def grid(self):
        return (self.ci_tiles * self.co_tiles, self.splits)

    @property
    def threads(self) -> int:
        return 9 * self.ci_t

    @property
    def row_blocks(self) -> int:
        return _ceil(self.H, self.rows)

    @property
    def chunks(self) -> int:
        return self.B * self.D * self.row_blocks

    @property
    def xr(self) -> int:
        return _pad32((self.W + 2) * self.ci_t, self.ci_t % 32)

    @property
    def ps(self) -> int:
        return _pad32((self.rows + 2) * self.xr, 3 * self.ci_t % 32)

    @property
    def stage(self) -> int:
        """Floats of one of the two stages: the g tile, then the x window,
        rounded up to 16 bytes."""
        return _ceil(self.rows * self.W * self.ct + 3 * self.ps, 4) * 4

    @property
    def smem(self) -> int:
        return 2 * 4 * self.stage

    @property
    def direct(self) -> bool:
        return self.splits == 1

    @property
    def ws_elems(self) -> int:
        return 0 if self.direct else self.splits * 27 * self.cin * self.cout

    @property
    def regs(self) -> int:
        """Registers a thread takes (``FMA_REGS``), in units of 8."""
        return _ceil(FMA_REGS[self.ct], 8) * 8

    @property
    def blocks_per_sm(self) -> int:
        warps = _ceil(self.threads, 32)
        return min(SM_BLOCKS, SM_THREADS // (32 * warps), SM_SMEM // (self.smem + 1024),
                   SM_REGS // (32 * warps * self.regs))

    @property
    def split_ranges(self):
        return [(s * self.per, min((s + 1) * self.per, self.chunks))
                for s in range(self.splits)]

    def chunk_origin(self, c: int):
        """Chunk c's g plane and first row: (b, d, h0)."""
        bd, rb = divmod(c, self.row_blocks)
        b, d = divmod(bd, self.D)
        return b, d, rb * self.rows

    def thread_role(self, tid: int):
        """Thread tid's (kd, kh, ci) within its tile."""
        u, ci = divmod(tid, self.ci_t)
        return u // 3, u % 3, ci


def _dw_fma_clocks(p: DwFmaPlan) -> float:
    """A rough cost of plan ``p`` in SM clocks: the busiest SM's blocks
    times one block's chunks -- each the larger of its FMA issue (4 warp
    instructions per clock) and its shared loads (one wavefront per clock),
    plus its staging and latency shared among the resident blocks -- over
    a latency-hiding factor (full at 16 resident warps), plus the
    workspace written and summed."""
    warps = _ceil(p.threads, 32)
    pos = p.rows * p.W
    fma = warps * pos * 3 * p.ct
    lds = warps * pos * (1 + p.ct / 4)
    vx = 4 if p.cin % 4 == 0 and p.ci_t % 4 == 0 else 1
    vg = 4 if p.cout % 4 == 0 else 1
    stage = (3 * (p.rows + 2) * (p.W + 2) * p.ci_t / vx + pos * p.ct / vg) / 32 * 8
    blocks = p.grid[0] * p.grid[1]
    resident = min(p.blocks_per_sm, _ceil(blocks, SMS))
    chunk = max(fma / 4, lds) + stage / 4 + _FMA_CHUNK_CLOCKS / resident
    t = _ceil(blocks, SMS) * p.per * chunk / min(1.0, resident * warps / 16)
    if not p.direct:  # the workspace's bytes, and the split sum's serial adds
        t += 4 * 27 * p.cin * p.cout * (2 * p.splits + 1) / WS_BYTES_PER_S * _CLOCK_HZ
        t += p.splits * _SPLIT_SUM_CLOCKS
    return t


@functools.lru_cache(maxsize=1024)
def fma_plan(B: int, D: int, H: int, W: int, cin: int, cout: int, off: int) -> DwFmaPlan:
    """The f32 kernel's launch plan for x (B, D + 2*off, H, W, cin) and g
    (B, D, H, W, cout).  A row too wide for shared memory is split into the
    fewest column segments whose launches fit (see ``DwFmaPlan``)."""
    p = _fma_launch_plan(B, D, H, W, cin, cout, off)
    if p is not None:
        return dataclasses.replace(p, seg_w=W)
    for segments in range(2, W + 1):
        seg_w = _ceil(W, segments)
        p = _fma_launch_plan(B, D, H, seg_w + 2, cin, cout, off)
        if p is not None:
            return dataclasses.replace(p, segments=_ceil(W, seg_w), seg_w=seg_w)
    raise ValueError(f"conv3d_dw: no f32 column segment of a row of width {W} fits")


def _fma_launch_plan(B, D, H, W, cin, cout, off):
    """One launch's plan at row width W, or None if no tile fits: over the
    channel tiles and rows per chunk whose shared memory fits, and the
    split counts that fill the card's block slots once (the SMs times the
    blocks each holds, over the tiles; at most the chunks, 65,535 and a 32
    MB workspace) or 1/2, 1/4 or 1/8 of them (fewer splits to sum), the
    plan with the least ``_dw_fma_clocks``."""
    cis = sorted({min(cin, FMA_MAX_CI)} | {c for c in (4, 8, 16, 32) if c < cin})
    best = None
    for ct in FMA_CT:
        for ci_t in cis:
            for rows in range(1, H + 1):
                p = DwFmaPlan(B, D, H, W, cin, cout, off, ci_t, ct, rows, 1, 1)
                if p.smem > SMEM_MAX or p.blocks_per_sm < 1:
                    break
                tiles = p.ci_tiles * p.co_tiles
                s_max = max(1, min(p.chunks, 65535,
                                   WS_MAX_BYTES // (4 * 27 * cin * cout)))
                fill = max(1, min(s_max, _ceil(SMS * p.blocks_per_sm, tiles)))
                for splits in sorted({max(1, fill // f) for f in (1, 2, 4, 8)}):
                    per = _ceil(p.chunks, splits)
                    q = DwFmaPlan(B, D, H, W, cin, cout, off, ci_t, ct, rows, per,
                                  _ceil(p.chunks, per))
                    key = (_dw_fma_clocks(q), q.splits)
                    if best is None or key < best[0]:
                        best = (key, q)
    return None if best is None else best[1]


def describe(x_shape, g_shape, dtype: torch.dtype, off: int = 0) -> dict:
    """What one launch runs, for a report: the path (``wgmma+tma``,
    ``wgmma+cp.async`` or the f32 ``fma+slide``), the split count, the
    workspace bytes and the plan's tile."""
    B, D, H, W, cout = g_shape
    cin = x_shape[4]
    if dtype == torch.float32:
        p = fma_plan(B, D, H, W, cin, cout, off)
        return {"path": "fma+slide", "splits": p.splits, "ws_bytes": 4 * p.ws_elems,
                "ci_t": p.ci_t, "ct": p.ct, "rows": p.rows, "per": p.per, "smem": p.smem,
                "threads": p.threads, "segments": p.segments}
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
            p, one = fma_plan(B, D, H, W, cin, cout, off), _launch_f32
        else:
            p, one = plan(B, D, H, W, cin, cout, off), _launch_bf16
            x, g = _pad_channels(x, p.cin_p), _pad_channels(g, p.cout_p)
        if p.segments == 1:
            err = one(lib, p, x, g, dw, stream)
        else:
            err, total = 0, None
            for xs, gs in column_segments(x, g, p.seg_w):
                part = torch.empty_like(dw)
                err = err or one(lib, p, xs, gs, part, stream)
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


def _launch_f32(lib, p: DwFmaPlan, x, g, dw, stream) -> int:
    """One f32 launch of plan ``p`` (its row width p.W) into dw."""
    ws = dw if p.direct else torch.empty(p.ws_elems, dtype=torch.float32, device=x.device)
    B, D, H, W = g.shape[:4]
    return lib.conv3d_dw_f32(
        x.data_ptr(), g.data_ptr(), ws.data_ptr(), dw.data_ptr(), B, D, H, W, p.cin,
        p.cout, p.off, p.ci_t, p.ct, p.rows, p.splits, p.per, stream)


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
