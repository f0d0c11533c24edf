"""3x3x3 conv with a fused epilogue, SAME or depth-VALID: the Hopper kernel,
its launch plan, its build and loader, and its plain PyTorch versions.

Replaces two Pallas TPU kernels of the JAX package:

- K1 forward, ``icsg3d_tpu/ops/lowc_conv.py::_kernel`` (conv + bias; the
  spatial-major conv behind ``SpatialMajorConv`` under ``--layout ndcs``);
- K3, ``icsg3d_tpu/ops/pallas_conv.py::_conv_kernel`` (conv + folded
  inference BN + ReLU), whose epilogue is what every eval-mode conv block
  of the VAE and the U-Net computes.

The bf16 kernel (``icsg3d_torch/csrc/conv3d.cu``) runs on wgmma: for each
kd, an implicit GEMM whose M is the output positions of a tile of rows (or
of whole small planes) at a row pitch P, N the output channels and K the
input channels.  One TMA box stages a tile's x window (its rows and one
halo row on each side, from column -1, 128/64/32-byte-swizzled rows of
64/32/16 channels) once per channel chunk, and all 9 (kh, kw) taps read it
as views shifted by kh*P + kw positions; TMA's zero fill gives the pads,
halos and depth edges.  The weights are read per tap in w's own (27, Cin,
Cout) layout.  ``plan`` decides the tiles, rows, planes, column segments
and ring depth; the wrapper launches from it and
``tests/test_torch_conv_plan.py`` replays it in numpy.  f32 input (the
VAE's f32 output head) runs on an f32 window kernel on the CUDA cores
(exact f32 products, no TF32): a block stages its tile's x window once
per chunk of input channels, each thread reuses its column's window
values across the three kh taps and each weight across its rows;
``fma_plan`` decides that tile and ``tests/test_torch_fma_plan.py``
replays it in numpy.  See the note in the .cu file for what bounds them.

Epilogues (``acc`` = conv sum + bias, all in f32):

=============  =================================  ==========================
name           formula                            serves
=============  =================================  ==========================
bias           acc                                VAE encoder's last conv
affine_leaky   leaky(scale*acc + shift, slope)    VAE conv blocks
relu_affine    scale*relu(acc) + shift            U-Net blocks (conv->ReLU->BN)
affine_relu    relu(scale*acc + shift)            K3; VAE output head (f32)
=============  =================================  ==========================

The same kernel computes K1 run as dx, the input gradient of the conv
(``icsg3d_tpu/ops/lowc_conv.py:549-567``): a SAME conv of the cotangent
with spatially flipped, channel-swapped weights and zero bias
(``conv3d_dx_cuda``), which the bf16 kernel reads from w itself (the
flipped tap's (Cin, Cout) matrix as its K-major B).

Depth modes (K1's ``depth_valid``, lowc_conv.py:224-231, 573-633), for the
halo-padded slabs of a depth-sharded conv (parallel/halo.py):

- VALID, ``conv3d_valid_cuda``: x has D + 2 planes, the output D; every
  epilogue;
- full, ``conv3d_dx_valid_cuda``: the input gradient of a VALID conv, all
  D + 2 input planes (halos included) from the D-plane cotangent, without
  materialising the cotangent zero-padded by 2 planes.

Launch counters (each binding its own): ``launches`` and
``launches_by_epilogue`` (SAME forwards), ``launches_dx`` (SAME dx),
``launches_valid`` and ``launches_valid_by_epilogue`` (VALID forwards),
``launches_dx_valid`` (full-window dx).

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``icsg3d_torch/_build/`` on first use (kernels/_nvcc.py), loaded with
ctypes (plain C interface).  Nothing is imported or built when this module
is imported.

Capture: a launch allocates through torch, runs on torch's current stream
and never syncs; its plan and TMA descriptors are fixed on the host from
the operands' addresses, and its shared-memory limit is set once per shape
(csrc/smem_limit.cuh), so after one launch at a shape it may be captured in
a CUDA graph whose pool keeps those addresses (train/graphs.py).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from icsg3d_torch.kernels._nvcc import PKG, build_library

EPILOGUES = ("bias", "affine_leaky", "relu_affine", "affine_relu")

SOURCE = PKG / "csrc" / "conv3d.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Incremented once per kernel launch, never by the plain version: SAME
# forward launches (in total and by epilogue), SAME input-gradient launches,
# and the same for the depth-VALID forward and its full-window dx.
launches = 0
launches_by_epilogue = {e: 0 for e in EPILOGUES}
launches_dx = 0
launches_valid = 0
launches_valid_by_epilogue = {e: 0 for e in EPILOGUES}
launches_dx_valid = 0

# Depth offset of the window per mode (csrc/conv3d.cu): output plane d
# reads input planes d + off - 1 .. d + off + 1.
_DEPTH_OFF = {"same": 0, "valid": 1, "full": -1}

# The H100: streaming multiprocessors (one block of the bf16 kernel each)
# and the dynamic shared memory a block may ask for (227 KB less 1 KB for
# the kernel's mbarriers); the kernel's ring and tile limits.
SMS = 132
SMEM_MAX = 232_448 - 1024
MAX_WINDOWS = 4                   # x windows in the ring, at most
MAX_WEIGHT_STAGES = 8             # weight tiles (one tap each) in the ring
MAX_MT = 4                        # m64 sub-tiles per block tile
MAX_BOX = 256                     # TMA box extent per dimension
_BN_FWD = (64, 128)               # the forward's MN-major B: 64-channel atoms
_BN_DX = (16, 32, 64, 96, 128)   # 96: Cin 192 in two tiles

_lib = None


def reset_launches() -> None:
    global launches, launches_dx, launches_valid, launches_dx_valid
    launches = launches_dx = launches_valid = launches_dx_valid = 0
    for e in EPILOGUES:
        launches_by_epilogue[e] = 0
        launches_valid_by_epilogue[e] = 0


def build(flags=(), verbose: bool = False) -> Path:
    """Compile ``csrc/conv3d.cu`` for sm_90a; returns the library path."""
    return build_library(SOURCE, "libconv3d", flags, verbose)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.conv3d_f32.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 17 + [ctypes.c_float, ctypes.c_void_p])
        lib.conv3d_bf16.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 21 + [ctypes.c_float, ctypes.c_void_p])
        lib.conv3d_f32.restype = lib.conv3d_bf16.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class ConvPlan:
    """The bf16 kernel's decomposition of one conv launch.

    A (the conv input, or the cotangent for ``dx``) has ``k`` channels,
    padded to ``k_p`` (a multiple of 8) and read in ``nc`` chunks of ``kc``
    (16, 32 or 64); the output has ``n`` channels in tiles of ``bn``.  A
    block tile is ``rows`` rows of ``nd`` planes (nd > 1 only for whole
    planes) of one column segment of ``seg_w`` columns, at the row pitch
    ``pitch`` (W + 1 for one segment, seg_w + 2 for several): output
    position q = (j*(rows + 2) + r)*pitch + c of the tile is plane d0 + j,
    row h0 + r, column c0 + c, kept where r < rows, c < seg_w and inside
    the grid.  Its x window, per (kd, chunk), is the box of kc channels x
    pitch columns from c0 - 1 x (rows + 2) rows from h0 - 1 x nd planes
    from d0 + off + kd - 1 (zero outside A), laid out at the same pitch;
    tap (kh, kw) reads it from ``tap_offsets[3*kh + kw]`` = kh*pitch + kw
    on, for ``mt`` * 64 positions.  Grid: ``blocks`` = m_tiles * n_tiles,
    the N tile fastest; ``nw`` window and ``nb`` weight stages; ``smem``
    bytes (the rings, or the f32 accumulator tile the epilogue parks there
    if larger).
    """

    B: int
    D_out: int
    H: int
    W: int
    k: int
    n: int
    off: int
    dx: bool
    k_p: int
    kc: int
    nc: int
    bn: int
    mt: int
    rows: int
    nd: int
    seg_w: int
    pitch: int
    nw: int
    nb: int
    smem: int

    @property
    def nseg(self) -> int:
        return _ceil(self.W, self.seg_w)

    @property
    def row_tiles(self) -> int:
        return _ceil(self.H, self.rows)

    @property
    def plane_tiles(self) -> int:
        return _ceil(self.D_out, self.nd)

    @property
    def n_tiles(self) -> int:
        return _ceil(self.n, self.bn)

    @property
    def m_tiles(self) -> int:
        return self.B * self.plane_tiles * self.row_tiles * self.nseg

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def tap_offsets(self):
        return tuple(kh * self.pitch + kw for kh in range(3) for kw in range(3))

    @property
    def window(self) -> int:
        """Window positions a tile reads: its mt*64 and the largest tap
        offset past them."""
        return self.mt * 64 + 2 * self.pitch + 2

    def tile_origin(self, t: int):
        """M tile t's (b, d0, h0, c0)."""
        t, seg = divmod(t, self.nseg)
        t, rt = divmod(t, self.row_tiles)
        b, pt = divmod(t, self.plane_tiles)
        return b, pt * self.nd, rt * self.rows, seg * self.seg_w


def _stage_bytes(window: int, kc: int, bn: int):
    """Ring stages in whole 1024-byte swizzle atoms: an x window of rows of
    2*kc bytes, and one tap's weight tile of kc x bn."""
    return _ceil(_ceil(window, 8) * 8 * 2 * kc, 1024) * 1024, _ceil(2 * kc * bn, 1024) * 1024


def _step_clocks(mt: int, bn: int, kc: int, xbox: int) -> float:
    """A rough cost of one tap step of one block, in SM clocks: the larger
    of the dense bf16 products (4096 flop per clock), wgmma's shared-memory
    reads (96 bytes per clock) and the step's staged bytes from L2 (64
    bytes per clock), plus a fixed handoff."""
    mma = mt * 64 * bn * kc * 2 / 4096
    smem = mt * (kc // 16) * (2048 + 32 * bn) / 96
    load = (2 * kc * bn + xbox / 9) / 64
    return max(mma, smem, load) + 64


@functools.lru_cache(maxsize=4096)
def plan(B: int, D_out: int, H: int, W: int, k: int, n: int, off: int, dx: bool) -> ConvPlan:
    """The bf16 kernel's launch plan for A (B, D_out + 2*off, H, W, k) to an
    output (B, D_out, H, W, n).  Takes the fewest column segments that fit
    a TMA box and shared memory, then the tile (rows, planes, BN) with the
    least estimated time: block waves over the SMs times the steps of a
    block (``_step_clocks``).  Never raises for a shape the kernel runs."""
    k_p = _ceil(k, 8) * 8
    kc = 16 if k_p <= 16 else 32 if k_p <= 32 else 64
    nc = _ceil(k_p, kc)
    choices = _BN_DX if dx else _BN_FWD
    bns = {next((b for b in choices if b >= min(n, 128)), choices[-1])}
    bns |= {b for b in choices if 64 <= b < n}
    for nseg in range(1, W + 1):
        seg_w = _ceil(W, nseg)
        if nseg > 1 and _ceil(W, seg_w) != nseg:
            continue
        pitch = W + 1 if nseg == 1 else seg_w + 2
        if pitch > MAX_BOX:
            continue
        best = None
        for rows in range(1, min(H, MAX_BOX - 2) + 1):
            if rows * pitch > MAX_MT * 64:
                break
            whole = rows == H and nseg == 1
            for nd in range(1, (min(D_out, MAX_BOX) if whole else 1) + 1):
                mv = nd * (rows + 2) * pitch - 2 * pitch
                if mv > MAX_MT * 64:
                    break
                mt = _ceil(mv, 64)
                window = mt * 64 + 2 * pitch + 2
                m_tiles = B * _ceil(D_out, nd) * _ceil(H, rows) * nseg
                xbox = 2 * kc * pitch * (rows + 2) * nd
                for bn in sorted(bns):
                    xs, ws = _stage_bytes(window, kc, bn)
                    # windows: as many as fit beside 8 (else 2) weight stages
                    free = SMEM_MAX - 1024
                    nw = max(2, min(MAX_WINDOWS, (free - MAX_WEIGHT_STAGES * ws) // xs))
                    nb = min(MAX_WEIGHT_STAGES, (free - nw * xs) // ws)
                    if nb < 2 or mt * 64 * (bn + 8) * 4 > free:
                        continue
                    blocks = m_tiles * _ceil(n, bn)
                    cost = _ceil(blocks, SMS) * 27 * nc * _step_clocks(mt, bn, kc, xbox)
                    key = (cost, blocks, -bn)
                    if best is None or key < best[0]:
                        park = mt * 64 * (bn + 8) * 4  # the epilogue's f32 tile
                        smem = max(nw * xs + nb * ws, park) + 1024
                        best = (key, ConvPlan(B, D_out, H, W, k, n, off,
                                              bool(dx), k_p, kc, nc, bn, mt, rows, nd,
                                              seg_w, pitch, nw, nb, smem))
        if best is not None:
            return best[1]
    raise ValueError(f"conv3d: no tile of a row of width {W} fits")  # not reached


# The f32 window kernel (``conv3d_f32_kernel``): the rows and output
# channels a thread owns (RT, CT in the .cu file), its registers (ptxas -v,
# sm_90a build), its limits, and one SM's budget, for the plan's occupancy
# estimate.
FMA_RT = FMA_CT = 4
FMA_REGS = 79
# threads per block: more, smaller blocks per SM hid the shared loads'
# latency better in an H100 sweep of the head's tiles (the kernel takes 256)
FMA_MAX_THREADS = 128
FMA_KC = (4, 8, 16, 32)           # input channels per staged chunk
FMA_MAX_BN = 64                   # output channels per block
SM_SMEM = 233_472                 # shared memory of one SM (228 KB)
SM_THREADS, SM_BLOCKS, SM_REGS = 2048, 32, 65_536
_FMA_CHUNK_CLOCKS = 1500          # a chunk's global loads and two barriers


@dataclass(frozen=True)
class FmaPlan:
    """The f32 kernel's decomposition of one conv launch.

    A (the conv input, or the cotangent for ``dx``) has ``k`` channels,
    read in chunks of ``kc`` (4, 8, 16 or 32); the output has ``n``
    channels in tiles of ``bn`` = ``ct`` * ``ng``.  A block tile is
    ``rows`` = ``rt`` * ``rg`` rows x ``seg_w`` columns of one (b, d)
    plane: thread ``tid`` owns column ``tid % seg_w``, rows ``rt`` *
    (``tid // seg_w % rg``) on, and channel group ``tid // (seg_w * rg)``
    (``ct`` channels); ``rt`` = ``ct`` = 4.  Per chunk the block stages
    its x window, 3 planes (d + off - 1 ..) x (rows + 2) rows (from h0 -
    1) x ``pitch`` = seg_w + 2 columns (from c0 - 1) x kc channels at a
    column stride of ``cs`` floats, zero outside A, and the chunk's
    weights (27 x kc x bn) from w itself (the flipped tap for dx).  Grid:
    ``m_tiles`` blocks (column segment fastest, then row tile, plane,
    batch) x ``n_tiles``; ``smem`` bytes of shared memory.
    """

    B: int
    D_out: int
    H: int
    W: int
    k: int
    n: int
    off: int
    dx: bool
    rg: int
    ng: int
    seg_w: int
    kc: int

    rt = FMA_RT
    ct = FMA_CT

    @property
    def rows(self) -> int:
        return self.rt * self.rg

    @property
    def bn(self) -> int:
        return self.ct * self.ng

    @property
    def pitch(self) -> int:
        return self.seg_w + 2

    @property
    def nc(self) -> int:
        return _ceil(self.k, self.kc)

    @property
    def nseg(self) -> int:
        return _ceil(self.W, self.seg_w)

    @property
    def row_tiles(self) -> int:
        return _ceil(self.H, self.rows)

    @property
    def n_tiles(self) -> int:
        return _ceil(self.n, self.bn)

    @property
    def m_tiles(self) -> int:
        return self.B * self.D_out * self.row_tiles * self.nseg

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def threads(self) -> int:
        return self.seg_w * self.rg * self.ng

    @property
    def cs(self) -> int:
        """The window's column stride: kc, or kc + 4 from 8 channels on (a
        warp's 16-byte reads of 32 neighbouring columns on distinct banks)."""
        return 4 if self.kc == 4 else self.kc + 4

    @property
    def smem(self) -> int:
        return 4 * (27 * self.kc * self.bn + 3 * (self.rows + 2) * self.pitch * self.cs)

    @property
    def regs(self) -> int:
        """Registers a thread takes, in the allocation's units of 8."""
        return _ceil(FMA_REGS, 8) * 8

    @property
    def blocks_per_sm(self) -> int:
        warps = _ceil(self.threads, 32)
        return min(SM_BLOCKS, SM_THREADS // (32 * warps), SM_SMEM // (self.smem + 1024),
                   SM_REGS // (32 * warps * self.regs))

    def tile_origin(self, t: int):
        """M tile t's (b, d, h0, c0)."""
        t, seg = divmod(t, self.nseg)
        t, rtile = divmod(t, self.row_tiles)
        b, d = divmod(t, self.D_out)
        return b, d, rtile * self.rows, seg * self.seg_w

    def thread_role(self, tid: int):
        """Thread tid's (column, first row, channel group) in its tile."""
        u, c = divmod(tid, self.seg_w)
        grp, rg = divmod(u, self.rg)
        return c, rg * self.rt, grp


def _fma_clocks(p: FmaPlan) -> float:
    """A rough cost of plan ``p`` in SM clocks: the busiest SM's blocks
    times one block's clocks -- the larger of its FMA issue (4 warp
    instructions per clock) and its shared-memory wavefronts (one per
    clock: 4 for a warp's float4 window read, 1 for a broadcast), plus its
    staging and per-chunk latency shared among the resident blocks -- over
    a latency-hiding factor (full at 32 resident warps)."""
    warps = _ceil(p.threads, 32)
    bps = p.blocks_per_sm
    k4 = _ceil(p.k, 4) * 4  # channels summed, in fours
    fma = warps * 27 * k4 * p.rt * p.ct
    lds = warps * k4 / 4 * 9 * (4 * (p.rt + 2) + 3 * p.ct)
    vec = 4 if p.k % 4 == 0 else 1
    stage = p.nc * (3 * (p.rows + 2) * p.pitch * p.kc / vec + 27 * p.kc * p.bn) / 32 * 6
    resident = min(bps, _ceil(p.blocks, SMS))
    block = max(fma / 4, lds) + stage / 4 + p.nc * _FMA_CHUNK_CLOCKS / resident
    return _ceil(p.blocks, SMS) * block / min(1.0, resident * warps / 32)


@functools.lru_cache(maxsize=4096)
def fma_plan(B: int, D_out: int, H: int, W: int, k: int, n: int, off: int,
             dx: bool) -> FmaPlan:
    """The f32 kernel's launch plan for A (B, D_out + 2*off, H, W, k) to an
    output (B, D_out, H, W, n): rows of at most ``FMA_MAX_THREADS``
    columns whole (wider ones in the fewest segments), and over the channel
    groups and row groups that fit ``FMA_MAX_THREADS`` and the chunk widths
    whose shared memory fits, the plan with the least ``_fma_clocks``
    (then the fewest blocks).  Never raises for a shape the kernel runs."""
    kcs = [c for c in FMA_KC if c == 4 or c < 2 * k]
    seg_w = _ceil(W, _ceil(W, FMA_MAX_THREADS))  # whole rows up to 128 columns
    best = None
    for ng in range(1, min(_ceil(n, FMA_CT), FMA_MAX_BN // FMA_CT) + 1):
        for rg in range(1, _ceil(H, FMA_RT) + 1):
            if seg_w * rg * ng > FMA_MAX_THREADS:
                break
            for kc in kcs:
                p = FmaPlan(B, D_out, H, W, k, n, off, bool(dx), rg, ng, seg_w, kc)
                if p.smem > SMEM_MAX or p.blocks_per_sm < 1:
                    break
                key = (_fma_clocks(p), p.blocks)
                if best is None or key < best[0]:
                    best = (key, p)
    if best is None:
        raise ValueError(f"conv3d: no f32 tile fits ({k} -> {n} channels)")
    return best[1]


def describe(a_shape, n: int, dtype: torch.dtype, mode: str = "same",
             dx: bool = False) -> dict:
    """What one launch runs, for a report: the path (``wgmma+tma``, or the
    f32 ``fma+window``) and its plan's tile."""
    B, D, H, W, k = a_shape
    off = _DEPTH_OFF[mode]
    if dtype == torch.float32:
        p = fma_plan(B, D - 2 * off, H, W, k, n, off, dx)
        return {"path": "fma+window", "rows": p.rows, "bn": p.bn, "segments": p.nseg,
                "kc": p.kc, "threads": p.threads, "smem": p.smem, "blocks": p.blocks}
    p = plan(B, D - 2 * off, H, W, k, n, off, dx)
    return {"path": "wgmma+tma", "bn": p.bn, "mt": p.mt, "rows": p.rows, "nd": p.nd,
            "segments": p.nseg, "kc": p.kc, "nw": p.nw, "nb": p.nb, "smem": p.smem,
            "blocks": p.blocks}


def _check_channels(t: Optional[torch.Tensor], cout: int, name: str, x):
    if t is None:
        raise ValueError(f"{name} is required for this epilogue")
    if t.shape != (cout,) or t.dtype != torch.float32 or t.device != x.device:
        raise ValueError(
            f"{name} must be float32 ({cout},) on {x.device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_operands(x: torch.Tensor, w: torch.Tensor, name: str):
    """Raise unless x (B,D,H,W,C) and w (3,3,3,Cin,Cout) are contiguous
    CUDA tensors of one supported dtype on one device; the caller checks
    which side of w the channel C matches."""
    if not x.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(
            f"want x (B,D,H,W,C) and w (3,3,3,Cin,Cout), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(
            f"x and w must share dtype float32 or bfloat16, got {x.dtype}, {w.dtype}"
        )
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")


def _launch(a, w, bias, scale, shift, epilogue, out_dtype, slope, mode, dx):
    """One kernel launch: A (B,D,H,W,K) -> (B,D_out,H,W,N) with D_out = D
    (``mode`` "same"), D - 2 ("valid") or D + 2 ("full"); the forward of w
    (N = Cout) or, with ``dx``, the input gradient (A the cotangent, N =
    Cin, the flipped taps)."""
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    B, D, H, W, k = a.shape
    cin, cout = w.shape[3], w.shape[4]
    n = cin if dx else cout
    off = _DEPTH_OFF[mode]
    d_out = D - 2 * off
    if d_out < 1:
        raise ValueError(f"a {mode} conv of {D} planes has no output plane")
    lib = load()
    out = torch.empty((B, d_out, H, W, n), dtype=out_dtype, device=a.device)
    sc = scale.data_ptr() if scale is not None else None
    sh = shift.data_ptr() if shift is not None else None
    epi = EPILOGUES.index(epilogue)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if a.dtype == torch.float32:
            p = fma_plan(B, d_out, H, W, k, n, off, bool(dx))
            err = lib.conv3d_f32(
                a.data_ptr(), w.data_ptr(), bias.data_ptr(), sc, sh, out.data_ptr(),
                B, D, d_out, off, H, W, k, n, cin, cout, int(p.dx), p.rg, p.ng, p.seg_w,
                p.kc, int(out_dtype == torch.float32), epi, float(slope), stream)
        else:
            p = plan(B, d_out, H, W, k, n, off, bool(dx))
            a = _aligned(_pad_channels(a, p.k_p))
            wt = _aligned(_pad_channels(w.reshape(27, cin, cout), _ceil(cout, 8) * 8))
            err = lib.conv3d_bf16(
                a.data_ptr(), wt.data_ptr(), bias.data_ptr(), sc, sh, out.data_ptr(),
                B, D, d_out, off, H, W, p.k_p, n, cin, wt.shape[2], int(p.dx), p.kc,
                p.bn, p.mt, p.rows, p.nd, p.seg_w, p.nw, p.nb,
                int(out_dtype == torch.float32), epi, float(slope), stream)
    if err != 0:
        raise RuntimeError(f"conv3d kernel launch failed ({mode}): CUDA error {err}")
    return out


def _pad_channels(t: torch.Tensor, to: int) -> torch.Tensor:
    """t with its last dimension zero-padded to ``to`` (16-byte TMA rows)."""
    return t if t.shape[-1] == to else F.pad(t, (0, to - t.shape[-1]))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it if its storage does not start 16-byte aligned (a
    TMA tensor map's base must)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def conv3d_same_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    epilogue: str = "bias",
    out_dtype: Optional[torch.dtype] = None,
    slope: float = 0.3,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors.

    x: (B, D, H, W, Cin) contiguous, bf16 or f32; w: (3, 3, 3, Cin, Cout)
    contiguous in x.dtype; bias/scale/shift: (Cout,) contiguous f32.
    Returns a new (B, D, H, W, Cout) tensor in ``out_dtype`` (default
    x.dtype).  Raises on anything else; never falls back.
    """
    global launches
    out = _forward(x, w, bias, scale, shift, epilogue, out_dtype, slope, "same",
                   "conv3d_same_cuda")
    launches += 1
    launches_by_epilogue[epilogue] += 1
    return out


def conv3d_valid_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    epilogue: str = "bias",
    out_dtype: Optional[torch.dtype] = None,
    slope: float = 0.3,
) -> torch.Tensor:
    """The depth-VALID conv on CUDA tensors: x (B, D + 2, H, W, Cin) is a
    depth slab padded with its two halo planes, the result (B, D, H, W,
    Cout) its slice of the global SAME conv.  Arguments and checks as in
    ``conv3d_same_cuda``; every epilogue."""
    global launches_valid
    out = _forward(x, w, bias, scale, shift, epilogue, out_dtype, slope, "valid",
                   "conv3d_valid_cuda")
    launches_valid += 1
    launches_valid_by_epilogue[epilogue] += 1
    return out


def _forward(x, w, bias, scale, shift, epilogue, out_dtype, slope, mode, name):
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; choose from {EPILOGUES}")
    _check_operands(x, w, name)
    cin, cout = w.shape[3], w.shape[4]
    if x.shape[4] != cin:
        raise ValueError(f"w has Cin={cin}, x has {x.shape[4]}")
    _check_channels(bias, cout, "bias", x)
    if epilogue != "bias":
        _check_channels(scale, cout, "scale", x)
        _check_channels(shift, cout, "shift", x)
    return _launch(x, w, bias, scale, shift, epilogue, out_dtype or x.dtype, slope, mode,
                   False)


def conv3d_dx_cuda(
    g: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """K1 run as dx: the input gradient of the SAME conv with weights w.

    g: (B, D, H, W, Cout) cotangent, contiguous, bf16 or f32; w: (3, 3, 3,
    Cin, Cout) contiguous in g.dtype.  Returns (B, D, H, W, Cin) in
    ``out_dtype`` (default g.dtype): the same kernel on the flipped,
    channel-swapped weights (``_flip_w``, lowc_conv.py:518-521) with zero
    bias, which the kernel reads from w itself: tap t's weights are w's
    (Cin, Cout) matrix of tap 26 - t, Cout (its K) contiguous.
    """
    global launches_dx
    out = _dx(g, w, out_dtype, "same", "conv3d_dx_cuda")
    launches_dx += 1
    return out


def conv3d_dx_valid_cuda(
    g: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """The input gradient of the depth-VALID conv with weights w: g (B, D,
    H, W, Cout) -> dx (B, D + 2, H, W, Cin), every input plane of the
    halo-padded slab.  The kernel's full depth window (offset -1) on the
    flipped weights does what lowc_conv.py:609-623 does on a cotangent
    zero-padded by 2 planes, without writing that pad."""
    global launches_dx_valid
    out = _dx(g, w, out_dtype, "full", "conv3d_dx_valid_cuda")
    launches_dx_valid += 1
    return out


def _dx(g, w, out_dtype, mode, name):
    _check_operands(g, w, name)
    cin, cout = w.shape[3], w.shape[4]
    if g.shape[4] != cout:
        raise ValueError(f"w has Cout={cout}, g has {g.shape[4]}")
    zero = torch.zeros(cin, dtype=torch.float32, device=g.device)
    return _launch(g, w, zero, None, None, "bias", out_dtype or g.dtype, 0.0, mode, True)


def apply_epilogue(y, epilogue, scale=None, shift=None, slope: float = 0.3):
    """The kernel's epilogue in torch, on an f32 ``y`` = conv + bias."""
    if epilogue == "bias":
        return y
    if epilogue == "affine_leaky":
        y = y * scale + shift
        return torch.where(y >= 0, y, slope * y)
    if epilogue == "relu_affine":
        return torch.relu(y) * scale + shift
    if epilogue == "affine_relu":
        return torch.relu(y * scale + shift)
    raise ValueError(f"unknown epilogue {epilogue!r}; choose from {EPILOGUES}")


def conv3d_same_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    epilogue: str = "bias",
    out_dtype: Optional[torch.dtype] = None,
    slope: float = 0.3,
) -> torch.Tensor:
    """The plain PyTorch version: F.conv3d in f32 on the same (x.dtype)
    operands, the epilogue in f32, then a cast to ``out_dtype``.

    On CUDA tensors it serves as the oracle for the kernel, so it turns
    TF32 off for cuDNN convolutions and cuBLAS matmuls
    (``torch.backends.cudnn.allow_tf32 = False``,
    ``torch.backends.cuda.matmul.allow_tf32 = False``): TF32 keeps about
    three decimal digits, too few to check an f32 output against.
    """
    return _reference(x, w, bias, scale, shift, epilogue, out_dtype, slope, 1)


def conv3d_valid_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    epilogue: str = "bias",
    out_dtype: Optional[torch.dtype] = None,
    slope: float = 0.3,
) -> torch.Tensor:
    """The plain version of ``conv3d_valid_cuda``: as
    ``conv3d_same_reference`` with F.conv3d's ``padding=(0, 1, 1)``, so x
    (B, D + 2, H, W, Cin) gives (B, D, H, W, Cout)."""
    return _reference(x, w, bias, scale, shift, epilogue, out_dtype, slope, 0)


def _reference(x, w, bias, scale, shift, epilogue, out_dtype, slope, depth_pad):
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; choose from {EPILOGUES}")
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out_dtype = out_dtype or x.dtype
    xf = x.float().permute(0, 4, 1, 2, 3)
    wf = w.to(x.dtype).float().permute(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    y = F.conv3d(xf, wf, padding=(depth_pad, 1, 1)).permute(0, 2, 3, 4, 1)
    y = y + bias.float()
    if epilogue != "bias":
        scale, shift = scale.float(), shift.float()
    y = apply_epilogue(y, epilogue, scale, shift, slope)
    return y.to(out_dtype).contiguous()


def flip_weights(w: torch.Tensor) -> torch.Tensor:
    """Weights of the input-gradient conv: spatial flip + channel swap,
    (3, 3, 3, Cin, Cout) -> (3, 3, 3, Cout, Cin) (lowc_conv.py:518-521)."""
    return w.flip((0, 1, 2)).transpose(3, 4)


def conv3d_dx_reference(
    g: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """The plain version of ``conv3d_dx_cuda``: ``conv3d_same_reference`` of
    the cotangent with the flipped, channel-swapped weights, zero bias."""
    zero = torch.zeros(w.shape[3], dtype=torch.float32, device=g.device)
    return conv3d_same_reference(g, flip_weights(w), zero, out_dtype=out_dtype)


def conv3d_dx_valid_reference(
    g: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """The plain version of ``conv3d_dx_valid_cuda``: the cotangent
    zero-padded by 2 planes on each side, then ``conv3d_valid_reference``
    with the flipped, channel-swapped weights and zero bias
    (lowc_conv.py:609-623)."""
    zero = torch.zeros(w.shape[3], dtype=torch.float32, device=g.device)
    gp = F.pad(g, (0, 0, 0, 0, 0, 0, 2, 2))
    return conv3d_valid_reference(gp, flip_weights(w), zero, out_dtype=out_dtype)
