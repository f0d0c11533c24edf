// Weight gradient of the 3x3x3 stride-1 convolution on NDHWC activations,
// SAME in H and W and SAME or VALID in depth, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel K2 of icsg3d_tpu:
//   icsg3d_tpu/ops/lowc_conv.py::_dw_kernel (launched by conv3d_lowc_ndcs_dw),
//   with its depth_valid mode (lowc_conv.py:380-387)
// Its TPU forms (the roll-based 9-tap scatter of g, the 128-lane aprons, the
// sublane channel padding, and the f32 output block kept resident across a
// sequential grid) are not carried over.  Read as 27 GEMMs that share K:
//   dW[tap][ci][co] = sum_v x[shift(v, tap)][ci] * g[v][co],
// K = B*D*H*W voxels of g, x zero outside the grid.  In depth, g's plane d
// reads x's plane d + off + kd - 1: off = 0 for SAME, off = 1 for VALID (x
// is a halo-padded slab of D + 2 planes, the per-shard dW of a
// depth-sharded conv).  dW comes out f32 in the DHWIO layout (3,3,3,Cin,Cout).
//
// What bounds it on this card: at the wide U-Net shapes the products
// (2*27*Cin*Cout per voxel, 0.44 ms of dense bf16 at 192->128 on 32^3 x 10)
// outweigh the bytes of x and g read once (0.06 ms); the small shapes are
// bound by bytes and launch.  So the kernel must (a) read each x and g
// element into shared memory a few times, not once per tap, and (b) keep
// the tensor cores busy on wgmma.
//
// The bf16 design:
// 1. Tap-sharing layout.  K runs over g's positions on each plane padded to
//    a row pitch P = W + 1 (g zero at column W).  A chunk is R rows of one
//    (b, d) plane: KC positions (R*P rounded up to wgmma's K of 16, g zero
//    past the rows).  Its x window is one x plane at the same pitch,
//    position 0 a zero guard before row h0 - 1, so tap (kh, kw) reads the
//    window from kh*P + kw on: a constant offset, whatever the chunk, and
//    the pad column and the guard are the zeros that SAME padding needs.
//    A block loads the g chunk and the x window once per stage and issues
//    the wgmmas of the 9 taps of its kd (a grid dimension) on them.
// 2. Staging and loads, two ways.  (a) TMA, where both channel tiles are
//    64 wide (Cin, Cout >= 64: the U-Net's conv3-14, the VAE's 64/128
//    convs): one 5-D tensor-map box each for the x window (columns -1..W-1,
//    rows h0-1..h0+R: the left pad and the halo come from the box's
//    out-of-bounds zero fill, so do the depth edges, and a box never
//    crosses a batch element) and the g chunk (columns 0..W), landing
//    128-byte-swizzled as [position][64 channels], completion on an
//    mbarrier per stage.  A tap's shift is one 128-byte row; the wgmma
//    descriptor (128B swizzle, MN-major, SBO 1024 B) may start at any row
//    because the swizzle follows the absolute address bits.  (b) cp.async,
//    for the narrow tiles: [channel/8][position][8 channels], one 16-byte
//    row per position, so a tap's shift is a 16-byte offset and every view
//    is a no-swizzle MN-major operand (LBO 128 B along K, SBO between
//    channel groups, whose stride is 1 mod 8 rows: conflict-free writes).
//    Either way 4 ring stages with 2 chunks in flight; the x window
//    re-reads 2P + 2 halo positions per KC (1.5x at edge 32, from L2).
//    TMA matters: with 16-byte cp.async for every tile the loads bounded
//    the wide convs (128->128 on 32^3 x 10 took 0.97 ms; with TMA 0.51 ms,
//    H100 80GB HBM3 at 700 W, chip_smoke.py).
// 3. Roles.  wgmma's M of 64 takes the wide channel side: Cin (tiles of
//    64) when Cin >= 64 or Cin >= Cout, else Cout (small Cin: 4, 16, 32 go
//    on N, as narrow as 8, so Cin 4 pads to 8, not to 64).  N tile BN in
//    {8, 16, 32, 64}.  The wrapper pads channels to multiples of 8 (Cin 14
//    and 4, Cout 4): 16-byte voxel rows for cp.async and TMA strides.
// 4. Budget.  Three warpgroups, one per kh, each own the 3 kw taps of the
//    block's kd: 3 m64nBN f32 accumulators, 96 registers a thread at BN 64,
//    so one block of 384 threads per SM (142-168 registers).  A stage at
//    edge 32 (R = 4, KC 144, 64 + 64 channels) holds 27 KB of x and 18 KB
//    of g; 4 stages = 182 KB of the 227 KB.  Larger R would cut the halo
//    share but leave fewer stages (3 stages of R = 7 measured slower); the
//    3 taps per warpgroup are what the accumulator registers allow at BN
//    64, and m64n64 with both operands in shared memory reads 128 B per
//    clock, the SM's shared-memory rate at the tensor cores' peak.
// 5. Split-K without atomics.  Grid (M tiles * N tiles, 3, splits); split s
//    sums a contiguous range of chunks into its own f32 slice of a
//    workspace, and a second kernel sums the slices in split order: the same
//    bits on every run.  The split count (kernels/conv3d_dw.py::plan)
//    minimises an estimate of block waves times chunks per block plus the
//    workspace traffic, with the workspace at most 32 MB; one split without
//    channel padding writes dW directly.
// f32 operands (the VAE's output head: x 16 channels, g 4, at 32^3) run on
// the f32 sliding-window kernel below: exact f32 FMAs on the CUDA cores
// (TF32 would miss the 1e-3 bound), bound at the head by the f32 FMA rate
// (2*27*16*4 flop per voxel: 0.034 ms at batch 20 at 66.9 TFLOP/s), so it
// stages each chunk's x window once and reuses every x value across the
// three kw taps in registers; split-K over chunks as above.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (icsg3d_torch/kernels/conv3d_dw.py does this).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "smem_limit.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// bf16 wgmma kernel

constexpr int WG = 128;          // threads per warpgroup
constexpr int NTB = 3 * WG;      // one warpgroup per kh
constexpr int STAGES = 4;        // ring buffers
constexpr int AHEAD = 2;         // chunks loading while one is multiplied
// dynamic shared memory a block may ask for: the H100's 227 KB less 1 KB
// for the kernel's static shared memory (its mbarriers)
constexpr int SMEM_MAX = 232448 - 1024;

// A no-swizzle, MN-major shared-memory operand: 8-position core matrices of
// 128 contiguous bytes, the next 8 positions (K) 128 bytes on, the next 8
// channels (M or N) ``mn_stride`` bytes on.
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t addr, uint32_t mn_stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((mn_stride >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// D(64 x N, f32) += A(64 x 16) * B(16 x N), both bf16 MN-major in shared
// memory (the transpose flags 1, 1).
template <int N> struct Wgmma;
template <> struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

// A 128-byte-swizzled, MN-major shared-memory operand of 64 channels: one
// 128-byte row per position (as TMA's SWIZZLE_128B box lands it in a
// 1024-byte-aligned buffer), 8-row groups 1024 bytes apart along K.
// ``addr`` may start at any row: the swizzle follows the absolute address
// bits, as TMA wrote them, so the base offset stays 0 (a base offset of
// (addr >> 7) & 7 gave wrong products on the H100).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ULL << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ULL << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One box of a 5-D tensor map (coordinates innermost first) into shared
// memory, completing ``bar``'s transaction bytes; out-of-bounds reads zero.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

struct Geom {
  int D, H, W, Dx, off;    // g's planes, rows, columns; x's planes; depth offset
  int P, R, KC, LX, RB;    // pitch, rows per chunk, chunk and window positions, chunks per plane
  int XS, GS;              // staged positions per channel group of x and of g
  int cin_p, cout_p;       // channel strides of x and g (multiples of 8)
  int n_tiles, per, nchunks;
  float invP;
};

// Grid (m_tiles * n_tiles, 3 kd, splits), NTB threads, dynamic shared memory
// STAGES * (x window + g chunk) (+ 1 KB for alignment).  Block (tile, kd, s)
// sums chunks [s*per, min((s+1)*per, nchunks)) into out[s] (27, cin_p,
// cout_p).  TMA (64-channel tiles on both sides, not swapped): the x window
// and the g chunk are one TMA box each, 128-byte-swizzled [position][64
// channels]; else 16-byte cp.async rows staged [channel/8][position][8].
template <int BN, bool SWAP, bool TMA>
__global__ void __launch_bounds__(NTB, 1)
conv3d_dw_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                       float* __restrict__ out, const Geom p,
                       const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmg) {
  static_assert(!TMA || (BN == 64 && !SWAP), "the TMA path stages 64-channel tiles");
  constexpr int XG = (SWAP ? BN : 64) / 8;  // channel groups of x per tile
  constexpr int GG = (SWAP ? 64 : BN) / 8;  // of g
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES];  // TMA: chunk landed

  const int tid = threadIdx.x, wg = tid / WG, kd = blockIdx.y;
  const int m0 = (blockIdx.x / p.n_tiles) * 64, n0 = (blockIdx.x % p.n_tiles) * BN;
  const int cx0 = SWAP ? n0 : m0, cg0 = SWAP ? m0 : n0;
  const int xg_n = min(XG, (p.cin_p - cx0) / 8), gg_n = min(GG, (p.cout_p - cg0) / 8);
  const int c_begin = blockIdx.z * p.per;
  const int n = max(min(c_begin + p.per, p.nchunks) - c_begin, 0);
  const int xbytes = TMA ? p.XS * 128 : XG * p.XS * 16;
  const int stage_bytes = xbytes + (TMA ? p.GS * 128 : GG * p.GS * 16);
  const uint32_t sbase = TMA ? (smem_addr(smem) + 1023) & ~1023u : smem_addr(smem);

  if constexpr (TMA) {
    // positions no box writes (the guard's neighbours past the window, g
    // past the chunk's rows) must read zero: clear the ring once
    uint4* z = reinterpret_cast<uint4*>(smem + (sbase - smem_addr(smem)));
    for (int i = tid; i < STAGES * stage_bytes / 16; i += NTB) z[i] = make_uint4(0, 0, 0, 0);
    if (tid == 0) {
      for (int i = 0; i < STAGES; ++i) mbar_init(smem_addr(&full[i]));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  // Stage chunk c_begin + it: the x window and the g chunk, zero where the
  // position has no voxel.  (cp.async: channel groups past the tile's
  // channels are left unloaded; they only reach outputs never stored.)
  auto load = [&](int it) {
    const uint32_t sx = sbase + (it % STAGES) * stage_bytes, sg = sx + xbytes;
    const int c = c_begin + it;
    const int bd = c / p.RB, h0 = (c - bd * p.RB) * p.R;
    const int b = bd / p.D, d = bd - b * p.D;
    const int xd = d + kd - 1 + p.off;
    if constexpr (TMA) {
      if (tid == 0) {
        const uint32_t bar = smem_addr(&full[it % STAGES]);
        mbar_expect_tx(bar, (2 * p.R + 2) * p.P * 128);
        // x: rows h0-1 .. h0+R, columns -1 .. W-1 (window position 0 is the
        // zero at column -1); g: rows h0 .. h0+R-1, columns 0 .. W
        tma_load_5d(sx, &tmx, bar, cx0, -1, h0 - 1, xd, b);
        tma_load_5d(sg, &tmg, bar, cg0, 0, h0, d, b);
      }
    } else {
      const bool plane = xd >= 0 && xd < p.Dx;
      const bf16* xp =
          x + (static_cast<long long>(b) * p.Dx + (plane ? xd : 0)) * p.H * p.W * p.cin_p + cx0;
      for (int i = tid; i < p.LX * XG; i += NTB) {
        const int pos = i / XG, grp = i % XG;
        if (grp >= xg_n) continue;
        const int s = pos - 1;  // window position 0 is the guard
        const int r = s >= 0 ? __float2int_rz((s + 0.5f) * p.invP) : -1;
        const int col = s - r * p.P, h = h0 + r - 1;
        const bool ok = plane && s >= 0 && col < p.W && h >= 0 && h < p.H;
        const bf16* src =
            ok ? xp + (static_cast<long long>(h) * p.W + col) * p.cin_p + grp * 8 : x;
        cp_async16(sx + (grp * p.XS + pos) * 16, src, ok ? 16 : 0);
      }
      const bf16* gp = g + static_cast<long long>(bd) * p.H * p.W * p.cout_p + cg0;
      for (int i = tid; i < p.KC * GG; i += NTB) {
        const int q = i / GG, grp = i % GG;
        if (grp >= gg_n) continue;
        const int r = __float2int_rz((q + 0.5f) * p.invP);
        const int col = q - r * p.P, h = h0 + r;
        const bool ok = r < p.R && h < p.H && col < p.W;
        const bf16* src =
            ok ? gp + (static_cast<long long>(h) * p.W + col) * p.cout_p + grp * 8 : g;
        cp_async16(sg + (grp * p.GS + q) * 16, src, ok ? 16 : 0);
      }
      cp_async_commit();
    }
  };

  float acc[3][BN / 2];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[t][e] = 0.f;
  auto fence_acc = [&]() {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) fence_operand(acc[t][e]);
  };

#pragma unroll
  for (int i = 0; i < AHEAD; ++i) {
    if (i < n) load(i);
    else if (!TMA) cp_async_commit();
  }
  const uint32_t xstride = p.XS * 16, gstride = p.GS * 16;
  const int tap0 = wg * p.P;  // kh * P: this warpgroup's row of taps
  for (int it = 0; it < n; ++it) {
    if constexpr (TMA) {
      mbar_wait(smem_addr(&full[it % STAGES]), (it / STAGES) & 1);
    } else {
      cp_async_wait<AHEAD - 1>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    // chunk it has landed for every thread, and every warpgroup has retired
    // its wgmmas of chunk it - 2, whose buffer the next load refills
    __syncthreads();
    if (it + AHEAD < n) load(it + AHEAD);
    else if (!TMA) cp_async_commit();

    const uint32_t sx = sbase + (it % STAGES) * stage_bytes, sg = sx + xbytes;
    fence_acc();
    wgmma_fence();
    for (int j = 0; j < p.KC; j += 16) {
      const uint64_t dg = TMA ? sw128_desc(sg + j * 128) : mn_major_desc(sg + j * 16, gstride);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const uint64_t dx = TMA ? sw128_desc(sx + (j + tap0 + kw) * 128)
                                : mn_major_desc(sx + (j + tap0 + kw) * 16, xstride);
        if (SWAP)
          Wgmma<BN>::mma(acc[kw], dg, dx);
        else
          Wgmma<BN>::mma(acc[kw], dx, dg);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc();
  }
  wgmma_wait<0>();
  fence_acc();

  // accumulator layout of m64nN: warp w of the group holds rows 16w..16w+15,
  // lane l rows l/4 and l/4 + 8, columns 8j + 2(l%4) + {0, 1}
  float* o = out + static_cast<long long>(blockIdx.z) * 27 * p.cin_p * p.cout_p;
  const int lane = tid % 32, row0 = m0 + 16 * ((tid % WG) / 32) + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const int tap = kd * 9 + wg * 3 + kw;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int m = row0 + 8 * ((e >> 1) & 1), nn = col0 + 8 * (e >> 2) + (e & 1);
      const int ci = SWAP ? nn : m, co = SWAP ? m : nn;
      if (ci < p.cin_p && co < p.cout_p)
        o[(static_cast<long long>(tap) * p.cin_p + ci) * p.cout_p + co] = acc[kw][e];
    }
  }
}

template <int BN, bool SWAP, bool TMA>
cudaError_t launch_wgmma(const bf16* x, const bf16* g, float* out, const Geom& p, dim3 grid,
                         int smem, const CUtensorMap& tmx, const CUtensorMap& tmg,
                         cudaStream_t s) {
  auto kern = conv3d_dw_wgmma_kernel<BN, SWAP, TMA>;
  static int allowed[kSmemLimitDevices] = {};  // this instantiation's limits
  const cudaError_t err = allow_dynamic_smem(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  kern<<<grid, NTB, smem, s>>>(x, g, out, p, tmx, tmg);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled looked up through the runtime API (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(f);
  }
  return fn;
}

// A bf16 NDHWC tensor (B, Dn, H, W, C) as a 5-D map read in boxes of 64
// channels x (W + 1) columns x ``rows`` rows of one plane, 128-byte swizzled.
bool tensor_map(CUtensorMap* map, const void* base, int B, int Dn, int H, int W, int C,
                int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)Dn,
                              (cuuint64_t)B};
  const cuuint64_t row = 2ULL * C;
  const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * Dn};
  const cuuint32_t box[5] = {64, (cuuint32_t)(W + 1), (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// f32 sliding-window kernel (the f32 output head: x 16 channels, g 4; any
// f32 (Cin, Cout)).  Exact f32 products on the CUDA cores, no TF32.
//
// A block owns a tile of CI input channels x CT output channels and walks
// its split's chunks in order; a chunk is R g rows of one (b, d) plane.
// Per chunk it stages, once, the x window -- 3 planes (d + off - 1 ..) x
// (R + 2) rows (from h0 - 1) x (W + 2) columns (from -1) x CI channels,
// zero outside x, as [plane][row][column][channel] at padded strides XR
// (row) and PS (plane) -- and the g tile, [row][column][CT channels], by
// cp.async into one of two stages, so the next chunk loads while this one
// is summed.  The staging decodes its indices with float reciprocals
// (fdiv): no integer division, no 64-bit arithmetic per element.  Thread (kd, kh, ci) keeps
// 3 kw x CT accumulators and walks each g row with a sliding window of
// three x values in registers: per position one x load (lanes on
// consecutive channels; XR = CI and PS = 3*CI mod 32 make the 9 (kd, kh)
// groups of a warp hit distinct banks) and CT/4 float4 broadcasts of g
// feed 3*CT FMAs (12 for 2 loads at the head).  Split s writes its own
// slice of the workspace (or dW itself when there is one split), and
// reduce_splits_kernel sums the slices in split order: the same bits on
// every run.  The tile, R and the splits come from
// icsg3d_torch/kernels/conv3d_dw.py::fma_plan; the entry checks them.

constexpr int FT_MAX = 576;  // threads per block, at most (9 x 64 channels)

struct FGeom {
  int D, H, W, Cin, Cout, off, Dx;
  int CI, R, RB, XR, PS, SB, nchunks, per, ci_tiles, vx, vg;
  int xrow, civ, ctv;                        // staged loads per x row, per column; per g column
  float inv_xrow, inv_rows, inv_civ, inv_ctv, inv_W;
};

// a / b for 0 <= a < 2^21, from inv = 1/b: floor((a + 0.5) * inv) is exact
// there (the product's error, below (a + 0.5)/b * 2^-23, stays under the
// 0.5/b margin to the next integer).
__device__ __forceinline__ int fdiv(int a, float inv) {
  return __float2int_rz((static_cast<float>(a) + 0.5f) * inv);
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// Stage chunk cidx into one buffer: g tile [R][W][CT] at gsm, x window
// [3][R + 2][W + 2][CI] at strides PS, XR at xsm, by cp.async (16 bytes
// with vx / vg 4, else 4), zero-filled outside x and g.
template <int CT>
__device__ __forceinline__ void dw_f32_stage(const float* __restrict__ x,
                                             const float* __restrict__ g, float* gsm,
                                             float* xsm, const FGeom& p, int cidx, int ci0,
                                             int co0) {
  const int T = blockDim.x, tid = threadIdx.x, rows = p.R + 2;
  const int bd = cidx / p.RB, h0 = (cidx - bd * p.RB) * p.R;
  const int b = bd / p.D, d = bd - b * p.D;
  const int xn = 3 * rows * p.xrow;
  for (int i = tid; i < xn; i += T) {
    const int pr = fdiv(i, p.inv_xrow), e = i - pr * p.xrow;
    const int pk = fdiv(pr, p.inv_rows), r = pr - pk * rows;
    const int j = fdiv(e, p.inv_civ), c = (e - j * p.civ) * p.vx;
    const int dd = d + p.off + pk - 1, hh = h0 - 1 + r, ww = j - 1, cc = ci0 + c;
    const bool in = dd >= 0 && dd < p.Dx && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W &&
                    cc < p.Cin;
    const float* src =
        in ? x + ((((size_t)b * p.Dx + dd) * p.H + hh) * p.W + ww) * p.Cin + cc : x;
    const unsigned dst = smem_addr(xsm + pk * p.PS + r * p.XR + j * p.CI + c);
    if (p.vx == 4)
      cp_async16(dst, src, in ? 16 : 0);
    else
      cp_async4(dst, src, in ? 4 : 0);
  }
  const int gn = p.R * p.W * p.ctv;
  for (int i = tid; i < gn; i += T) {
    const int pos = fdiv(i, p.inv_ctv), c = (i - pos * p.ctv) * p.vg;
    const int r = fdiv(pos, p.inv_W), ww = pos - r * p.W;
    const int hh = h0 + r, cc = co0 + c;
    const bool in = hh < p.H && cc < p.Cout;
    const float* src =
        in ? g + ((((size_t)b * p.D + d) * p.H + hh) * p.W + ww) * p.Cout + cc : g;
    const unsigned dst = smem_addr(gsm + pos * CT + c);
    if (p.vg == 4)
      cp_async16(dst, src, in ? 16 : 0);
    else
      cp_async4(dst, src, in ? 4 : 0);
  }
}

template <int CT>
__global__ void __launch_bounds__(FT_MAX)
conv3d_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ ws, const FGeom p) {
  extern __shared__ __align__(16) float fsm[];  // two stages of p.SB floats
  const int tid = threadIdx.x;
  const int ci0 = (blockIdx.x % p.ci_tiles) * p.CI, co0 = (blockIdx.x / p.ci_tiles) * CT;
  const int ci = tid % p.CI, kh = (tid / p.CI) % 3, kd = tid / (3 * p.CI);
  const int gfl = p.R * p.W * CT;  // the g tile's floats; the x window follows

  float acc[3][CT];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[kw][j] = 0.f;

  // chunks in order, the next one loading while this one is summed
  const int cbeg = blockIdx.y * p.per;
  const int cend = min(cbeg + p.per, p.nchunks);
  if (cbeg < cend) dw_f32_stage<CT>(x, g, fsm, fsm + gfl, p, cbeg, ci0, co0);
  cp_async_commit();
  for (int cidx = cbeg, buf = 0; cidx < cend; ++cidx, buf ^= 1) {
    if (cidx + 1 < cend) {
      float* next = fsm + (buf ^ 1) * p.SB;
      dw_f32_stage<CT>(x, g, next, next + gfl, p, cidx + 1, ci0, co0);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const float* gsm = fsm + buf * p.SB;
    const float* xsm = gsm + gfl;
    const int h0 = (cidx % p.RB) * p.R;
    const int rn = min(p.R, p.H - h0);
    for (int r = 0; r < rn; ++r) {
      const float* xr = xsm + kd * p.PS + (r + kh) * p.XR + ci;
      const float4* gr = reinterpret_cast<const float4*>(gsm + r * p.W * CT);
      float xa = xr[0], xb = xr[p.CI];
#pragma unroll 3
      for (int w = 0; w < p.W; ++w) {
        const float xc = xr[(w + 2) * p.CI];
        float gv[CT];
#pragma unroll
        for (int q = 0; q < CT / 4; ++q) {
          const float4 v = gr[w * (CT / 4) + q];
          gv[4 * q] = v.x;
          gv[4 * q + 1] = v.y;
          gv[4 * q + 2] = v.z;
          gv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          acc[0][j] = fmaf(xa, gv[j], acc[0][j]);
          acc[1][j] = fmaf(xb, gv[j], acc[1][j]);
          acc[2][j] = fmaf(xc, gv[j], acc[2][j]);
        }
        xa = xb;
        xb = xc;
      }
    }
    __syncthreads();
  }

  if (ci0 + ci >= p.Cin) return;
  float* out = ws + (size_t)blockIdx.y * 27 * p.Cin * p.Cout;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    float* o = out + ((size_t)(kd * 9 + kh * 3 + kw) * p.Cin + ci0 + ci) * p.Cout + co0;
#pragma unroll
    for (int j = 0; j < CT; ++j)
      if (co0 + j < p.Cout) o[j] = acc[kw][j];
  }
}

template <int CT>
cudaError_t launch_dw_f32(const float* x, const float* g, float* ws, const FGeom& p, dim3 grid,
                          int threads, int smem, cudaStream_t s) {
  auto kern = conv3d_dw_f32_kernel<CT>;
  static int allowed[kSmemLimitDevices] = {};  // this instantiation's limits
  const cudaError_t err = allow_dynamic_smem(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, s>>>(x, g, ws, p);
  return cudaGetLastError();
}
// dw[tap][ci][co] = sum over s of ws[s][tap][ci][co] for ci < cin, co <
// cout, the slices (27, cin_p, cout_p) taken in increasing s (deterministic).
__global__ void __launch_bounds__(256)
reduce_splits_kernel(const float* __restrict__ ws, float* __restrict__ dw, int cin, int cout,
                     int cin_p, int cout_p, int splits) {
  const long long n = 27LL * cin * cout, slice = 27LL * cin_p * cout_p;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long t = i / cout;
    const int co = (int)(i - t * cout), ci = (int)(t % cin), tap = (int)(t / cin);
    const float* src = ws + ((long long)tap * cin_p + ci) * cout_p + co;
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += src[k * slice];
    dw[i] = s;
  }
}

cudaError_t reduce(const float* ws, float* dw, int cin, int cout, int cin_p, int cout_p,
                   int splits, cudaStream_t s) {
  const long long n = 27LL * cin * cout;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  reduce_splits_kernel<<<blocks, 256, 0, s>>>(ws, dw, cin, cout, cin_p, cout_p, splits);
  return cudaGetLastError();
}

}  // namespace

// bf16: x (B, D + 2*off, H, W, cin_p), g (B, D, H, W, cout_p), channels
// padded to multiples of 8 (16-byte aligned rows); dw f32 (3, 3, 3, cin,
// cout).  The launch plan of icsg3d_torch/kernels/conv3d_dw.py::plan: rows
// g rows per chunk of kc positions (a multiple of 16, >= rows * (W + 1)),
// splits splits of per chunks each (none empty), swap (Cout on wgmma's M),
// bn (8, 16, 32 or 64); bn 64 not swapped (W < 256) loads by TMA.  ws: f32
// splits * 27 * cin_p * cout_p, or ws == dw (one split, no padding: the
// kernel writes dw itself).  Returns cudaGetLastError() after the launches
// (0 = launched); allocates nothing and does not synchronise.
extern "C" int conv3d_dw_bf16(const void* x, const void* g, void* ws, void* dw, int B, int D,
                              int H, int W, int cin_p, int cout_p, int cin, int cout, int off,
                              int rows, int kc, int splits, int per, int swap, int bn,
                              void* stream) {
  const long long rb = rows > 0 ? (H + rows - 1) / rows : 0;
  const long long nchunks = (long long)B * D * rb;
  const bool direct = ws == dw;
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0 || cin_p % 8 ||
      cout_p % 8 || cin > cin_p || cout > cout_p || (off != 0 && off != 1) || rows <= 0 ||
      rows > H || kc % 16 || kc < rows * (W + 1) || splits <= 0 || splits > 65535 ||
      per <= 0 || (long long)splits * per < nchunks || (long long)(splits - 1) * per >= nchunks ||
      nchunks >= (1LL << 31) || (direct && (splits != 1 || cin != cin_p || cout != cout_p)) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(g) % 16)
    return (int)cudaErrorInvalidValue;
  const bool tma = bn == 64 && !swap && W + 1 <= 256 && rows + 2 <= 256;
  Geom p;
  p.D = D; p.H = H; p.W = W; p.off = off; p.Dx = D + 2 * off;
  p.P = W + 1; p.R = rows; p.KC = kc; p.LX = kc + 2 * p.P + 2; p.RB = (int)rb;
  // TMA: whole 1024-byte swizzle atoms; cp.async: 1 mod 8 rows of 16 bytes
  // between channel groups (conflict-free writes)
  p.XS = tma ? (p.LX + 7) / 8 * 8 : p.LX + (9 - p.LX % 8) % 8;
  p.GS = tma ? kc : kc + 1;
  p.cin_p = cin_p; p.cout_p = cout_p; p.per = per; p.nchunks = (int)nchunks;
  p.invP = 1.f / p.P;
  const int m_ch = swap ? cout_p : cin_p, n_ch = swap ? cin_p : cout_p;
  const int x_ch = swap ? bn : 64, g_ch = swap ? 64 : bn;
  const long long smem =
      16LL * STAGES * (x_ch / 8 * (long long)p.XS + g_ch / 8 * (long long)p.GS) + (tma ? 1024 : 0);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int m_tiles = (m_ch + 63) / 64;
  p.n_tiles = (n_ch + bn - 1) / bn;
  dim3 grid(m_tiles * p.n_tiles, 3, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto gb = static_cast<const bf16*>(g);
  float* out = static_cast<float*>(ws);
  const int sm = (int)smem;
  CUtensorMap tmx, tmg;
  memset(&tmx, 0, sizeof tmx);
  memset(&tmg, 0, sizeof tmg);
  if (tma && !(tensor_map(&tmx, x, B, p.Dx, H, W, cin_p, rows + 2) &&
               tensor_map(&tmg, g, B, D, H, W, cout_p, rows)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  switch (bn * 2 + (swap ? 1 : 0)) {
    case 16: err = launch_wgmma<8, false, false>(xb, gb, out, p, grid, sm, tmx, tmg, s); break;
    case 17: err = launch_wgmma<8, true, false>(xb, gb, out, p, grid, sm, tmx, tmg, s); break;
    case 32: err = launch_wgmma<16, false, false>(xb, gb, out, p, grid, sm, tmx, tmg, s); break;
    case 33: err = launch_wgmma<16, true, false>(xb, gb, out, p, grid, sm, tmx, tmg, s); break;
    case 64: err = launch_wgmma<32, false, false>(xb, gb, out, p, grid, sm, tmx, tmg, s); break;
    case 65: err = launch_wgmma<32, true, false>(xb, gb, out, p, grid, sm, tmx, tmg, s); break;
    case 128:
      err = tma ? launch_wgmma<64, false, true>(xb, gb, out, p, grid, sm, tmx, tmg, s)
                : launch_wgmma<64, false, false>(xb, gb, out, p, grid, sm, tmx, tmg, s);
      break;
    case 129: err = launch_wgmma<64, true, false>(xb, gb, out, p, grid, sm, tmx, tmg, s); break;
    default: break;
  }
  if (err != cudaSuccess || direct) return (int)err;
  return (int)reduce(out, static_cast<float*>(dw), cin, cout, cin_p, cout_p, splits, s);
}

// f32: x (B, D + 2*off, H, W, Cin), g (B, D, H, W, Cout); dw f32 (3, 3, 3,
// Cin, Cout).  The plan of icsg3d_torch/kernels/conv3d_dw.py::fma_plan: ci_t
// input channels (<= 64) and ct output channels (4, 8 or 16) per block,
// rows g rows per chunk, splits splits of per chunks each (none empty).
// ws: f32 splits * 27 * Cin * Cout, or ws == dw (one split: the kernel
// writes dw itself); else one reduction sums the slices into dw in split
// order.  Returns cudaGetLastError() after the launches (0 = launched);
// cudaErrorInvalidValue for a plan or shape it does not take.  Allocates
// nothing and does not synchronise.
extern "C" int conv3d_dw_f32(const void* x, const void* g, void* ws, void* dw, int B, int D,
                             int H, int W, int Cin, int Cout, int off, int ci_t, int ct,
                             int rows, int splits, int per, void* stream) {
  const long long rb = rows > 0 ? (H + rows - 1) / rows : 0;
  const long long nchunks = (long long)B * D * rb;
  const bool direct = ws == dw;
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || (off != 0 && off != 1) ||
      ci_t < 1 || ci_t > 64 || ci_t > Cin || (ct != 4 && ct != 8 && ct != 16) || rows < 1 ||
      rows > H || splits < 1 || splits > 65535 || per < 1 ||
      (long long)splits * per < nchunks || (long long)(splits - 1) * per >= nchunks ||
      nchunks >= (1LL << 31) || (direct && splits != 1) ||
      (long long)B * (D + 2 * off) * H * W * Cin >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  FGeom p;
  p.D = D; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.off = off; p.Dx = D + 2 * off;
  p.CI = ci_t; p.R = rows; p.RB = (int)rb; p.nchunks = (int)nchunks; p.per = per;
  p.ci_tiles = (Cin + ci_t - 1) / ci_t;
  // row and plane strides with XR = CI and PS = 3*CI (mod 32): the lanes
  // of a warp, (kd, kh, ci) with ci fastest, read distinct banks
  auto pad = [](long long v, long long want) { return v + (((want - v) % 32) + 32) % 32; };
  const long long xr = pad((long long)(W + 2) * ci_t, ci_t % 32);
  const long long ps = pad((rows + 2) * xr, (3 * ci_t) % 32);
  p.XR = (int)xr; p.PS = (int)ps;
  p.vx = Cin % 4 == 0 && ci_t % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? 4 : 1;
  p.vg = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 ? 4 : 1;
  p.civ = ci_t / p.vx; p.xrow = (W + 2) * p.civ; p.ctv = ct / p.vg;
  p.inv_xrow = 1.f / p.xrow; p.inv_rows = 1.f / (rows + 2); p.inv_civ = 1.f / p.civ;
  p.inv_ctv = 1.f / p.ctv; p.inv_W = 1.f / W;
  // a stage: the g tile, then the x window, rounded to 16 bytes; two stages
  const long long sb = ((long long)rows * W * ct + 3 * ps + 3) / 4 * 4;
  p.SB = (int)sb;
  const long long smem = 8 * sb;
  const long long xn = 3LL * (rows + 2) * p.xrow, gn = (long long)rows * W * p.ctv;
  const long long tiles = p.ci_tiles * (long long)((Cout + ct - 1) / ct);
  if (smem > SMEM_MAX || xn >= (1 << 21) || gn >= (1 << 21) || sb >= (1 << 28) ||
      tiles >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  auto xf = static_cast<const float*>(x);
  auto gf = static_cast<const float*>(g);
  const dim3 grid((unsigned)tiles, (unsigned)splits);
  const int threads = 9 * ci_t, sm = (int)smem;
  cudaError_t err = cudaErrorInvalidValue;
  switch (ct) {
    case 4: err = launch_dw_f32<4>(xf, gf, wsf, p, grid, threads, sm, s); break;
    case 8: err = launch_dw_f32<8>(xf, gf, wsf, p, grid, threads, sm, s); break;
    case 16: err = launch_dw_f32<16>(xf, gf, wsf, p, grid, threads, sm, s); break;
    default: break;
  }
  if (err != cudaSuccess || direct) return (int)err;
  return (int)reduce(wsf, static_cast<float*>(dw), Cin, Cout, Cin, Cout, splits, s);
}
