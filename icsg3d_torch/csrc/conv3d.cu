// 3x3x3 stride-1 convolution on NDHWC activations, SAME in H and W and
// SAME, VALID or "full" in depth, with a fused per-channel epilogue, for
// NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of icsg3d_tpu:
//   K1 forward  icsg3d_tpu/ops/lowc_conv.py::_kernel       (conv + bias),
//               with its depth_valid mode (lowc_conv.py:224-231), and run
//               on flipped weights as the input gradient (:549-567, 601-623)
//   K3          icsg3d_tpu/ops/pallas_conv.py::_conv_kernel (conv + folded
//               inference BN + activation)
// The TPU forms (spatial-major layout, 128-lane aprons, tap packing, VMEM
// depth blocks) are not carried over.
//
// Depth window: output plane d reads input planes d + off + kd (kd in
// -1..1) of an input with D_in planes, zero outside [0, D_in):
//   SAME   D_in = D_out,     off =  0
//   VALID  D_in = D_out + 2, off = +1  (a halo-padded depth slab: the
//          per-shard conv of a depth-sharded SAME conv)
//   full   D_in = D_out - 2, off = -1  (the input gradient of a VALID conv:
//          every input plane, halos included, from the unpadded cotangent)
//
// What bounds it on this card: at the U-Net's widths (Cin 64..768) the conv
// does 27*Cout multiply-adds per input element it reads, far above the
// H100's ~295 flop/byte ridge, so the ceiling is tensor-core throughput,
// which only wgmma reaches.  The bf16 design:
// 1. Tap-sharing windows.  For one kd the conv is an implicit GEMM with M
//    the output positions of a tile at a row pitch P, N the output channels
//    and K the input channels.  A tile is R rows of one (b, d) plane (or nd
//    whole planes of one batch element, stacked at R + 2 rows each), of one
//    column segment.  Its x window is one TMA box: kc channels x P columns
//    from column c0 - 1 x (R + 2) rows from row h0 - 1 x nd planes from
//    plane d0 + off + kd - 1, landing as [position][kc channels] rows of
//    2*kc bytes, swizzled at that width.  Output position q of the tile
//    reads tap (kh, kw) at window position q + kh*P + kw: every tap is the
//    window viewed from a constant row on, so one staged window feeds 9
//    taps.  TMA's out-of-bounds zero fill gives the left pad, the halo
//    rows and the depth edges (B is its own tensor-map dimension, so a box
//    never crosses a batch element); with one segment P = W + 1 and window
//    column W doubles as the right pad of row h and the left pad of row
//    h + 1; with several, P = Ws + 2.  Outputs at columns >= Ws, at the two
//    halo rows of a stacked plane and past the grid are computed and
//    dropped at the store.  Window positions past the box are zeroed once.
// 2. wgmma.  A is the window view, K-major (any row may start a view: the
//    swizzle follows the absolute address bits, as TMA wrote them, so the
//    descriptor's base offset stays 0); B is the weights in w's own (27,
//    Cin, Cout) layout, staged by TMA per tap: the forward reads 64-channel
//    Cout rows (MN-major, 128B swizzle), the input gradient reads the
//    flipped tap's rows as K-major (Cout contiguous).  No transposed or
//    flipped copy of the weights is made.
// 3. Roles.  One producer warpgroup (one thread issues every TMA load) and
//    two consumer warpgroups (setmaxnreg 40 / 232).  A block tile is mt
//    m64 sub-tiles (mt <= 4, alternating between the consumers, each with
//    at most 2 m64nBN f32 accumulators: 128 registers at BN 128) x BN
//    output channels.  Rings of nw (2-4) windows and nb (<= 8) weight tiles
//    (one tap of one kc-channel chunk each), each slot with a full and an
//    empty mbarrier; a consumer warp releases a step's slots once its
//    warpgroup's wgmma group of the next step is issued and the step's own
//    group has retired (wgmma.wait_group 1).  The consumer loop is
//    instantiated per sub-tile count and the warpgroup index is made
//    warp-uniform (__shfl_sync): ptxas serialises (C7520) a wgmma under a
//    condition it cannot prove uniform.  Ring slots and parities are
//    stepped, not divided out: the producer is one thread, and its per-step
//    arithmetic is on the consumers' critical path.
// 4. Any shape.  Channel counts not a multiple of 8 are padded in the
//    wrapper (16-byte TMA strides); kc is 16, 32 or 64 (the A channel
//    count rounded up, TMA zero fill past it) so narrow channels waste at
//    most a factor 2 of the K work; N tiles of 16-128 (96 for Cin 192; the forward's
//    MN-major B takes 64 or 128).  Rows wider than a box (P <= 256) or
//    than shared memory split into column segments.  The launch plan
//    (tile rows, planes, segments, mt, BN, ring depth) comes from
//    icsg3d_torch/kernels/conv3d.py::plan; the kernel only checks it.
// 5. The fused epilogue.  The accumulators are parked in shared memory (over
//    the rings, now unread) and each consumer warp stores one kept tile row
//    at a time, its outputs contiguous, the epilogue applied in f32 before
//    the single store.  No atomics, no split K: two launches give the same
//    bits.
//
// f32 input (the VAE's f32 output head, 16 -> 4 at 32^3) runs on the f32
// window kernel below (conv3d_f32_kernel): exact f32 FMAs on the CUDA cores,
// since the head is held to 1e-4 and TF32 keeps three digits.  At the head
// the conv does 2*27*16*4 flop per 80 bytes of x and y, so the ceiling is
// the f32 FMA rate (66.9 TFLOP/s: 0.034 ms at batch 20), not the memory
// (0.016 ms); the kernel reuses each staged window value across the three
// kh taps in registers and each weight across a thread's RT rows.  Output
// bf16 or f32, every epilogue, every depth window.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (icsg3d_torch/kernels/conv3d.py does this).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "smem_limit.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Epilogue { kBias = 0, kAffineLeaky = 1, kReluAffine = 2, kAffineRelu = 3 };

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float epilogue(float acc, int co, const float* bias,
                                          const float* scale, const float* shift,
                                          int epi, float slope) {
  float v = acc + bias[co];
  switch (epi) {
    case kAffineLeaky:
      v = scale[co] * v + shift[co];
      return v >= 0.f ? v : slope * v;
    case kReluAffine:
      return scale[co] * fmaxf(v, 0.f) + shift[co];
    case kAffineRelu:
      return fmaxf(scale[co] * v + shift[co], 0.f);
    default:
      return v;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// bf16 wgmma kernel

constexpr int WG = 128;         // threads per warpgroup
constexpr int NTW = 3 * WG;     // a producer warpgroup, two consumer warpgroups
constexpr int MI = 2;           // m64 sub-tiles a consumer warpgroup may own
constexpr int MAX_NW = 4;       // x windows in the ring, at most
constexpr int MAX_NB = 8;       // weight tiles in the ring, at most
// dynamic shared memory a block may ask for: the H100's 227 KB less 1 KB
// for the kernel's static shared memory (its mbarriers)
constexpr int SMEM_MAX = 232448 - 1024;

struct Geom {
  int D_out, off, H, W, N;
  int kc, nc;                 // A channels per chunk (16, 32 or 64), chunks
  int P, R, nd, Ws;           // pitch; rows and planes per tile; columns per segment
  int nseg, row_tiles, plane_tiles, n_tiles, mt;
  int nw, nb, xstride, wstride;  // window and weight ring depths; stage strides (bytes)
  int xbox_bytes;             // bytes of one window box
  int out_f32, epi;
  float slope;
};

// A K-major operand of rows of row_bytes (32, 64 or 128: kc = 16, 32 or 64
// bf16) swizzled at that width, 8-row groups 8 rows apart.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : (row_bytes == 64 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ULL << 16) |
         (static_cast<uint64_t>((8 * row_bytes) >> 4) << 32) | (layout << 62);
}

// An MN-major, 128-byte-swizzled operand: K rows of 64 channels (128 B),
// 8-row K groups 1024 B apart, 64-channel atoms ``atom`` bytes apart.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, uint32_t atom) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((atom >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ULL << 62);
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
// Keep the accumulators in registers across the asynchronous wgmmas.
template <int BN>
__device__ __forceinline__ void fence_acc(float (&acc)[MI][BN / 2]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) fence_operand(acc[i][e]);
}

// D(64 x N, f32) += A(64 x 16) * B(16 x N): A K-major, B K-major (TB 0) or
// MN-major (TB 1), both bf16 in shared memory.
template <int N, int TB> struct Wgmma;
template <> struct Wgmma<16, 0> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<32, 0> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<64, 0> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<96, 0> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<128, 0> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<64, 1> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Wgmma<128, 1> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// One arrival per warp: lane 0's, predicated inside the asm (a branch on
// the lane would look divergent to ptxas around the wgmmas).
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 l;\nmov.u32 l, %%laneid;\nsetp.eq.u32 p, l, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar)
      : "memory");
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
// One box of a tensor map (coordinates innermost first) into shared memory,
// completing ``bar``'s transaction bytes; out-of-bounds elements read zero.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Two channels of one output position: the epilogue, then one paired store
// where both channels exist and the pair is aligned, else one each.
template <typename TOut>
__device__ __forceinline__ void store_pair(TOut* o, int co, int N, float v0, float v1,
                                           const float* bias, const float* scale,
                                           const float* shift, int epi, float slope) {
  if (co >= N) return;
  const float a = epilogue(v0, co, bias, scale, shift, epi, slope);
  if (co + 1 >= N) {
    o[co] = from_float<TOut>(a);
    return;
  }
  const float c = epilogue(v1, co + 1, bias, scale, shift, epi, slope);
  if (N % 2 == 0) {
    if constexpr (sizeof(TOut) == 4)
      *reinterpret_cast<float2*>(o + co) = make_float2(a, c);
    else
      *reinterpret_cast<__nv_bfloat162*>(o + co) = __floats2bfloat162_rn(a, c);
  } else {
    o[co] = from_float<TOut>(a);
    o[co + 1] = from_float<TOut>(c);
  }
}

// A consumer warpgroup's K loop over the (kd, chunk) windows and their 9
// taps, issuing NSUB m64 sub-tiles' wgmmas per tap (positions 128*i on from
// ``xsub``, the warpgroup's first sub-tile in window 0).  Barriers as laid
// out by the kernel: xfull, xempty (MAX_NW each), wfull, wempty (MAX_NB
// each) from ``bar0``; lane 0 of every consumer warp arrives on the empty
// barriers.
template <int BN, bool DX, int NSUB>
__device__ __forceinline__ void mainloop(float (&acc)[MI][BN / 2], const Geom& p, uint32_t xsub,
                                         uint32_t wring, uint32_t bar0) {
  const uint32_t rowb = p.kc * 2;
  const int ksteps = p.kc / 16, nkc = 3 * p.nc;
  // ring slots and the parity of their current use, stepped without division
  int xs = 0, xpar = 0, ws = 0, wpar = 0, xprev = 0, wprev = 0;
  for (int k = 0; k < nkc; ++k) {
    mbar_wait(bar0 + 8 * xs, xpar);
    const uint32_t xa = xsub + xs * p.xstride;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      mbar_wait(bar0 + 8 * (2 * MAX_NW + ws), wpar);
      const uint32_t wa = wring + ws * p.wstride;
      const uint32_t xv = xa + ((tap / 3) * p.P + tap % 3) * rowb;
      fence_acc<BN>(acc);
      wgmma_fence();
      for (int ks = 0; ks < ksteps; ++ks) {
        const uint64_t db = DX ? kmajor_desc(wa + ks * 32, rowb)
                               : mnmajor_desc(wa + ks * 2048, p.kc * 128);
#pragma unroll
        for (int i = 0; i < NSUB; ++i)
          Wgmma<BN, DX ? 0 : 1>::mma(acc[i], kmajor_desc(xv + i * 128 * rowb + ks * 32, rowb), db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // this warpgroup's wgmmas of the step before have retired
      fence_acc<BN>(acc);
      if (k > 0 || tap > 0) {  // release the step before's weights (and window)
        mbar_arrive_lane0(bar0 + 8 * (2 * MAX_NW + MAX_NB + wprev));
        if (tap == 0) mbar_arrive_lane0(bar0 + 8 * (MAX_NW + xprev));
      }
      wprev = ws;
      if (++ws == p.nb) ws = 0, wpar ^= 1;
    }
    xprev = xs;
    if (++xs == p.nw) xs = 0, xpar ^= 1;
  }
}

// Grid: one block per (M tile, N tile), the N tile fastest; NTW threads;
// dynamic shared memory: the larger of the rings (nw * xstride + nb *
// wstride) and the parked accumulators (mt*64 x (BN + 8) f32), + 1 KB.
// BN: output channels per tile; DX: the input gradient (B K-major, the
// flipped tap), else the forward (B MN-major).
template <int BN, bool DX>
__global__ void __launch_bounds__(NTW, 1)
conv3d_wgmma_kernel(const float* __restrict__ bias, const float* __restrict__ scale,
                    const float* __restrict__ shift, void* __restrict__ out, const Geom p,
                    const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_w) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * MAX_NW + 2 * MAX_NB];
  // the warpgroup index, made visibly warp-uniform for the compiler (a
  // divergent-looking branch around wgmma makes ptxas serialise them)
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t xring = base, wring = base + p.nw * p.xstride;
  const uint32_t bar0 = smem_addr(bars);
  const auto xfull = [&](int s) { return bar0 + 8 * s; };
  const auto xempty = [&](int s) { return bar0 + 8 * (MAX_NW + s); };
  const auto wfull = [&](int s) { return bar0 + 8 * (2 * MAX_NW + s); };
  const auto wempty = [&](int s) { return bar0 + 8 * (2 * MAX_NW + MAX_NB + s); };

  int t = blockIdx.x;
  const int nt = t % p.n_tiles;
  t /= p.n_tiles;
  const int seg = t % p.nseg;
  t /= p.nseg;
  const int rt = t % p.row_tiles;
  t /= p.row_tiles;
  const int pt = t % p.plane_tiles, b = t / p.plane_tiles;
  const int n0 = nt * BN, c0 = seg * p.Ws, h0 = rt * p.R, d0 = pt * p.nd;

  {  // window positions no box writes (past its end) must read zero
    uint4* z = reinterpret_cast<uint4*>(smem + (base - smem_addr(smem)));
    for (int i = tid; i < p.nw * p.xstride / 16; i += NTW) z[i] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int s = 0; s < p.nw; ++s) {
      mbar_init(xfull(s), 1);
      mbar_init(xempty(s), 8);  // the consumer warps
    }
    for (int s = 0; s < p.nb; ++s) {
      mbar_init(wfull(s), 1);
      mbar_init(wempty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int nkc = 3 * p.nc;  // (kd, channel chunk) pairs, kd outer
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const uint32_t wbytes = p.kc * BN * 2;
      int xs = 0, xpar = 0, ws = 0, wpar = 0, kd = 0, ch = 0;
      for (int k = 0; k < nkc; ++k) {
        if (k >= p.nw) mbar_wait(xempty(xs), xpar ^ 1);  // its last use released
        mbar_expect_tx(xfull(xs), p.xbox_bytes);
        tma_load_5d(xring + xs * p.xstride, &tma_a, xfull(xs), ch, c0 - 1, h0 - 1,
                    d0 + p.off + kd - 1, b);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          if (9 * k + tap >= p.nb) mbar_wait(wempty(ws), wpar ^ 1);
          mbar_expect_tx(wfull(ws), wbytes);
          const uint32_t dst = wring + ws * p.wstride;
          if constexpr (DX) {  // B[co][ci] = w[26 - tap][ci][co]: rows of ci, co contiguous
            tma_load_3d(dst, &tma_w, wfull(ws), ch, n0, 26 - (kd * 9 + tap));
          } else {  // B[ci][co] = w[tap][ci][co]: 64-channel co atoms of kc rows
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_3d(dst + j * p.kc * 128, &tma_w, wfull(ws), n0 + 64 * j, ch, kd * 9 + tap);
          }
          if (++ws == p.nb) ws = 0, wpar ^= 1;
        }
        if (++xs == p.nw) xs = 0, xpar ^= 1;
        if ((ch += p.kc) == p.nc * p.kc) ch = 0, ++kd;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1, lane = tid % 32, warp = (tid % WG) / 32;
    const uint32_t rowb = p.kc * 2;
    float acc[MI][BN / 2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[i][e] = 0.f;

    // this warpgroup's sub-tiles are cw and cw + 2 (of mt): one copy of the
    // main loop per count, so no wgmma sits under a runtime condition
    const int nsub = (p.mt - cw + 1) / 2;
    if (nsub == 2)
      mainloop<BN, DX, 2>(acc, p, xring + cw * 64 * rowb, wring, bar0);
    else if (nsub == 1)
      mainloop<BN, DX, 1>(acc, p, xring + cw * 64 * rowb, wring, bar0);
    else
      mainloop<BN, DX, 0>(acc, p, xring + cw * 64 * rowb, wring, bar0);
    wgmma_wait<0>();
    fence_acc<BN>(acc);

    // Epilogue through shared memory (the rings are no longer read once
    // both consumer warpgroups have retired their wgmmas): each thread
    // parks its accumulators at compile-time indices, then the consumer
    // warps store the kept rows, each row's outputs contiguous.  Accumulator layout of m64nN: warp w of
    // the group holds rows 16w..16w+15, lane l rows l/4 and l/4 + 8,
    // columns 8j + 2(l%4) + {0, 1}.
    constexpr int LD = BN + 8;  // floats per parked row (bank shift 8)
    float* tile = reinterpret_cast<float*>(smem + (base - smem_addr(smem)));
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (cw + 2 * i < p.mt) {
        const int row = (cw + 2 * i) * 64 + 16 * warp + lane / 4;
#pragma unroll
        for (int e = 0; e < BN / 2; e += 2) {
          const int r = row + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + 2 * (lane % 4);
          *reinterpret_cast<float2*>(tile + r * LD + col) = make_float2(acc[i][e], acc[i][e + 1]);
        }
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    // one kept tile row (plane j, row r) per warp; its lanes over columns
    // and channel pairs, G lanes (a power of two) per column
    const int npairs = (min(BN, p.N - n0) + 1) / 2, ncol = min(p.Ws, p.W - c0);
    int lg = 0;
    while ((1 << lg) < npairs && lg < 5) ++lg;
    for (int rr = 4 * cw + warp; rr < p.nd * p.R; rr += 8) {
      const int j = rr / p.R, r = rr - j * p.R, d = d0 + j, h = h0 + r;
      if (d >= p.D_out || h >= p.H) continue;
      const float* row = tile + (j * (p.R + 2) + r) * p.P * LD;
      const long long o0 = ((static_cast<long long>(b) * p.D_out + d) * p.H + h) * p.W + c0;
      for (int c = lane >> lg; c < ncol; c += 32 >> lg) {
        for (int pr = lane & ((1 << lg) - 1); pr < npairs; pr += 1 << lg) {
          const float2 v = *reinterpret_cast<const float2*>(row + c * LD + 2 * pr);
          const long long o = (o0 + c) * p.N;
          if (p.out_f32)
            store_pair(static_cast<float*>(out) + o, n0 + 2 * pr, p.N, v.x, v.y, bias, scale,
                       shift, p.epi, p.slope);
          else
            store_pair(static_cast<bf16*>(out) + o, n0 + 2 * pr, p.N, v.x, v.y, bias, scale,
                       shift, p.epi, p.slope);
        }
      }
    }
  }
}

template <int BN, bool DX>
cudaError_t launch_wgmma(const float* bias, const float* scale, const float* shift, void* out,
                         const Geom& p, unsigned grid, int smem, const CUtensorMap& ta,
                         const CUtensorMap& tw, cudaStream_t s) {
  auto kern = conv3d_wgmma_kernel<BN, DX>;
  static int allowed[kSmemLimitDevices] = {};  // this instantiation's limits
  const cudaError_t err = allow_dynamic_smem(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  kern<<<grid, NTW, smem, s>>>(bias, scale, shift, out, p, ta, tw);
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

// A bf16 tensor of ``rank`` dimensions (innermost first, each row of dims[0]
// elements) read in boxes of ``box``, swizzled at ``swizzle_bytes`` (32, 64
// or 128, the box's inner extent in bytes).
bool tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                const cuuint32_t* box, int swizzle_bytes) {
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return false;
  cuuint64_t strides[4];
  cuuint64_t s = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = s *= dims[i];
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle sw = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// f32 window kernel (the VAE's f32 output head; any f32 conv)
//
// Exact f32 products on the CUDA cores (no TF32: the head is held to 1e-4
// of its plain version).  A block computes one output tile: R rows x Ws
// columns of one (b, d) plane x BN output channels.  Per chunk of kc input
// channels (4, 8, 16 or 32) it stages, once, the tile's x window -- 3
// planes x (R + 2) rows x (Ws + 2) columns x kc channels, zero outside A
// (pads, halo rows, depth edges, channels past K) -- as
// [plane][row][column][channel] at a column stride CS (kc, or kc + 4 from
// 8 on, so that a warp's 16-byte reads of 32 neighbouring columns hit
// distinct banks), by cp.async with its zero fill (16 bytes a copy when K
// is a multiple of 4), every copy in flight before one wait; and the
// chunk's weights as [tap][channel][BN] straight from w's own (27, Cin,
// Cout) layout (dx reads the flipped tap, w[26 - tap][n][k], by index: no
// transposed or flipped copy).  A thread owns one column, RT = 4
// consecutive rows and CT = 4 output channels: for each (kd, 4 channels,
// kw) it loads the RT + 2 window float4s of its column once and uses them
// for the three kh taps, with the weights as warp-uniform float4
// broadcasts: 12*RT*CT = 192 FMAs for RT + 2 + 3*CT = 18 shared loads.
// (Tiles of 8 rows or 8-16 channels a thread take 127-128 registers, and
// none was clearly faster at the head's shapes on the H100.)
// No atomics and no split sum: two launches give the same bits.  The tile (row groups, channel groups, Ws, kc) comes
// from icsg3d_torch/kernels/conv3d.py::fma_plan; the entry checks it.

constexpr int FT_MAX = 256;  // threads per block, at most
constexpr int RT = 4;        // rows a thread owns
constexpr int CT = 4;        // output channels a thread owns

struct FGeom {
  int D_in, D_out, off, H, W, K, N, w_cin, w_cout, dx;
  int R, RG, Ws, P, kc, lkc, CS, BN, nseg, row_tiles, vec, epi;
  int row_elems;         // copies per window row: P*kc/4 with vec, else P*kc
  float slope;
  float inv_row, inv_rows, inv_bn;  // reciprocals of row_elems, R + 2, BN
};

// a / b for 0 <= a < 2^21, from inv = 1/b: floor((a + 0.5) * inv) is exact
// there (the product's error, below (a + 0.5)/b * 2^-23, stays under the
// 0.5/b margin to the next integer).  No integer division in the staging.
__device__ __forceinline__ int fdiv(int a, float inv) {
  return __float2int_rz((static_cast<float>(a) + 0.5f) * inv);
}

// cp.async of 16 or 4 bytes; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void f32_cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void f32_cp_async4(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

template <int Q> __device__ __forceinline__ float lane_of(const float4& v) {
  return Q == 0 ? v.x : Q == 1 ? v.y : Q == 2 ? v.z : v.w;
}

// acc[i][j] += x[i + KH][Q] * w[j] over a thread's RT rows and CT
// channels, w the CT weights of channel Q at wq (a float4 broadcast).
template <int KH, int Q>
__device__ __forceinline__ void f32_tap(float (&acc)[RT][CT], const float4 (&xv)[RT + 2],
                                        const float* wq) {
  const float4 t = *reinterpret_cast<const float4*>(wq);
  const float wv[CT] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float xi = lane_of<Q>(xv[i + KH]);
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(xi, wv[j], acc[i][j]);
  }
}

// One (kd, kh, kw) tap over 4 input channels: wt the tap's [4][BN] weights.
template <int KH>
__device__ __forceinline__ void f32_tap4(float (&acc)[RT][CT], const float4 (&xv)[RT + 2],
                                         const float* wt, int bn) {
  f32_tap<KH, 0>(acc, xv, wt);
  f32_tap<KH, 1>(acc, xv, wt + bn);
  f32_tap<KH, 2>(acc, xv, wt + 2 * bn);
  f32_tap<KH, 3>(acc, xv, wt + 3 * bn);
}

template <typename TOut>
__global__ void __launch_bounds__(FT_MAX)
conv3d_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ scale,
                  const float* __restrict__ shift, TOut* __restrict__ out, const FGeom p) {
  extern __shared__ __align__(16) float fsm[];
  float* wsm = fsm;                         // [27][kc][BN]
  float* xsm = fsm + 27 * p.kc * p.BN;      // [3][R + 2][P][CS]
  const int T = blockDim.x, tid = threadIdx.x;
  const int rows = p.R + 2;
  const int cs4 = p.CS >> 2, rs4 = p.P * cs4;  // float4s per column, per window row

  // block -> (b, d, row tile, column segment); blockIdx.y -> N tile
  int t = blockIdx.x;
  const int seg = t % p.nseg;
  t /= p.nseg;
  const int rtile = t % p.row_tiles;
  t /= p.row_tiles;
  const int d = t % p.D_out, b = t / p.D_out;
  const int h0 = rtile * p.R, c0 = seg * p.Ws, n0 = blockIdx.y * p.BN;
  // thread -> (column, first of its RT rows, channel group)
  const int c = tid % p.Ws, u = tid / p.Ws;
  const int r0 = (u % p.RG) * RT, grp = u / p.RG;

  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += p.kc) {
    // the x window: every copy issued, then one wait
    const int total = 3 * rows * p.row_elems;
    for (int i = tid; i < total; i += T) {
      const int pr = fdiv(i, p.inv_row), e = i - pr * p.row_elems;
      const int kd = fdiv(pr, p.inv_rows), r = pr - kd * rows;
      int j, ci;
      if (p.vec) {
        j = e >> (p.lkc - 2);
        ci = (e & ((p.kc >> 2) - 1)) << 2;
      } else {
        j = e >> p.lkc;
        ci = e & (p.kc - 1);
      }
      const int dd = d + p.off + kd - 1, hh = h0 - 1 + r, cc = c0 - 1 + j, kk = k0 + ci;
      const bool in = dd >= 0 && dd < p.D_in && hh >= 0 && hh < p.H && cc >= 0 && cc < p.W &&
                      kk < p.K;
      const float* src =
          in ? x + ((((size_t)b * p.D_in + dd) * p.H + hh) * p.W + cc) * p.K + kk : x;
      const unsigned dst = smem_addr(xsm + (pr * p.P + j) * p.CS + ci);
      if (p.vec)
        f32_cp_async16(dst, src, in ? 16 : 0);
      else
        f32_cp_async4(dst, src, in ? 4 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    // the chunk's weights: B[tap][ci][n] = w[tap][k0 + ci][n0 + n] (forward)
    // or w[26 - tap][n0 + n][k0 + ci] (dx), zero past K and N
    const int wn = 27 * p.kc * p.BN;
    for (int i = tid; i < wn; i += T) {
      const int q = fdiv(i, p.inv_bn), n = i - q * p.BN;
      const int ci = q & (p.kc - 1), tap = q >> p.lkc;
      const int kk = k0 + ci, nn = n0 + n;
      float v = 0.f;
      if (kk < p.K && nn < p.N)
        v = p.dx ? __ldg(w + ((26 - tap) * p.w_cin + nn) * p.w_cout + kk)
                 : __ldg(w + (tap * p.w_cin + kk) * p.w_cout + nn);
      wsm[i] = v;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    const int kn4 = (min(p.kc, p.K - k0) + 3) >> 2;
    const float4* xw = reinterpret_cast<const float4*>(xsm);
    for (int kd = 0; kd < 3; ++kd) {
      for (int c4 = 0; c4 < kn4; ++c4) {
        const float4* xc = xw + (kd * rows + r0) * rs4 + c * cs4 + c4;
        const float* wc = wsm + (kd * 9 * p.kc + 4 * c4) * p.BN + grp * CT;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          float4 xv[RT + 2];
#pragma unroll
          for (int i = 0; i < RT + 2; ++i) xv[i] = xc[i * rs4 + kw * cs4];
          const int tap = p.kc * p.BN;  // floats per tap
          f32_tap4<0>(acc, xv, wc + kw * tap, p.BN);
          f32_tap4<1>(acc, xv, wc + (3 + kw) * tap, p.BN);
          f32_tap4<2>(acc, xv, wc + (6 + kw) * tap, p.BN);
        }
      }
    }
    __syncthreads();
  }

  const int cc = c0 + c;
  if (cc >= p.W) return;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int hh = h0 + r0 + i;
    if (hh >= p.H) break;
    TOut* o = out + ((((size_t)b * p.D_out + d) * p.H + hh) * p.W + cc) * p.N;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int n = n0 + grp * CT + j;
      if (n < p.N)
        o[n] = from_float<TOut>(epilogue(acc[i][j], n, bias, scale, shift, p.epi, p.slope));
    }
  }
}

template <typename TOut>
cudaError_t launch_f32(const float* x, const float* w, const float* bias, const float* scale,
                       const float* shift, void* out, const FGeom& p, dim3 grid,
                       int threads, int smem, cudaStream_t s) {
  auto kern = conv3d_f32_kernel<TOut>;
  static int allowed[kSmemLimitDevices] = {};  // this instantiation's limits
  const cudaError_t err = allow_dynamic_smem(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, s>>>(x, w, bias, scale, shift, static_cast<TOut*>(out), p);
  return cudaGetLastError();
}

}  // namespace

// bf16: a (B, D_in, H, W, K) the conv input (forward) or the cotangent
// (dx), K a multiple of 8; w (3, 3, 3, w_cin, w_cout) bf16, w_cout a
// multiple of 8 (padded with zero channels); out (B, D_out, H, W, N), N =
// Cout (forward, N <= w_cout) or w_cin (dx).  off as in ``conv3d`` below.
// The launch plan of icsg3d_torch/kernels/conv3d.py::plan: kc A channels
// per chunk (16, 32, 64), bn output channels per tile (forward 64 or 128;
// dx 16, 32, 64, 96 or 128), mt m64 sub-tiles per tile (1..4), rows per tile,
// nd planes per tile (nd > 1 only with rows == H and one segment), seg_w
// output columns per segment, nw window-ring and nb weight-ring stages.
// out_f32: 1 for f32
// output, 0 for bf16.  Returns cudaGetLastError() after the launch (0 =
// launched); cudaErrorInvalidValue for a plan or shape it does not take.
// Allocates nothing and does not synchronise.
extern "C" int conv3d_bf16(const void* a, const void* w, const void* bias, const void* scale,
                           const void* shift, void* out, int B, int D_in, int D_out, int off,
                           int H, int W, int K, int N, int w_cin, int w_cout, int dx, int kc,
                           int bn, int mt, int rows, int nd, int seg_w, int nw, int nb,
                           int out_f32,
                           int epi, float slope, void* stream) {
  const int nseg = seg_w > 0 ? (W + seg_w - 1) / seg_w : 0;
  const int P = nseg == 1 ? W + 1 : seg_w + 2;
  const bool bn_ok =
      dx ? (bn == 16 || bn == 32 || bn == 64 || bn == 96 || bn == 128) : (bn == 64 || bn == 128);
  if (B <= 0 || D_out <= 0 || D_in <= 0 || H <= 0 || W <= 0 || off < -1 || off > 1 ||
      D_in != D_out + 2 * off || K <= 0 || K % 8 || N <= 0 || w_cin <= 0 || w_cout <= 0 ||
      w_cout % 8 || (dx ? (N != w_cin || K != w_cout) : (K < w_cin || N > w_cout)) ||
      (kc != 16 && kc != 32 && kc != 64) || (kc < 64 && K > kc) || !bn_ok || mt < 1 ||
      mt > 2 * MI || rows < 1 || rows > H || rows + 2 > 256 || nd < 1 || nd > 256 ||
      (nd > 1 && (rows != H || nseg != 1)) || seg_w < 1 || seg_w > W || P > 256 ||
      (long long)nd * (rows + 2) * P - 2 * P > 64LL * mt || nw < 2 || nw > MAX_NW ||
      nb < 2 || nb > MAX_NB ||
      epi < 0 || epi > 3 || (epi != 0 && (!scale || !shift)) ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  Geom p;
  p.D_out = D_out; p.off = off; p.H = H; p.W = W; p.N = N;
  p.kc = kc; p.nc = (K + kc - 1) / kc;
  p.P = P; p.R = rows; p.nd = nd; p.Ws = seg_w; p.nseg = nseg;
  p.row_tiles = (H + rows - 1) / rows; p.plane_tiles = (D_out + nd - 1) / nd;
  p.n_tiles = (N + bn - 1) / bn; p.mt = mt; p.nw = nw; p.nb = nb;
  // windows: mt*64 positions and the largest tap offset, in whole 1024-byte
  // swizzle atoms; weight tiles likewise
  const long long xpos = ((long long)mt * 64 + 2 * P + 2 + 7) / 8 * 8;
  p.xstride = (int)((xpos * kc * 2 + 1023) / 1024 * 1024);
  p.wstride = (kc * bn * 2 + 1023) / 1024 * 1024;
  p.xbox_bytes = kc * 2 * P * (rows + 2) * nd;
  p.out_f32 = out_f32 ? 1 : 0; p.epi = epi; p.slope = slope;
  // the rings, or the accumulators parked for the epilogue if larger
  const long long ring = (long long)nw * p.xstride + (long long)nb * p.wstride;
  const long long park = 64LL * mt * (bn + 8) * 4;
  const long long smem = (ring > park ? ring : park) + 1024;
  const long long grid = (long long)B * p.plane_tiles * p.row_tiles * nseg * p.n_tiles;
  if (smem > SMEM_MAX || grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;

  CUtensorMap ta, tw;
  memset(&ta, 0, sizeof ta);
  memset(&tw, 0, sizeof tw);
  const cuuint64_t adims[5] = {(cuuint64_t)K, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D_in,
                               (cuuint64_t)B};
  const cuuint32_t abox[5] = {(cuuint32_t)kc, (cuuint32_t)P, (cuuint32_t)(rows + 2),
                              (cuuint32_t)nd, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)w_cout, (cuuint64_t)w_cin, 27};
  const cuuint32_t wbox_fwd[3] = {64, (cuuint32_t)kc, 1};
  const cuuint32_t wbox_dx[3] = {(cuuint32_t)kc, (cuuint32_t)bn, 1};
  if (!tensor_map(&ta, a, 5, adims, abox, kc * 2) ||
      !tensor_map(&tw, w, 3, wdims, dx ? wbox_dx : wbox_fwd, dx ? kc * 2 : 128))
    return (int)cudaErrorInvalidValue;

  const float* bs = static_cast<const float*>(bias);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = (unsigned)grid;
  const int sm = (int)smem;
  cudaError_t err = cudaErrorInvalidValue;
  switch (bn * 2 + (dx ? 1 : 0)) {
    case 33: err = launch_wgmma<16, true>(bs, sc, sh, out, p, g, sm, ta, tw, s); break;
    case 65: err = launch_wgmma<32, true>(bs, sc, sh, out, p, g, sm, ta, tw, s); break;
    case 129: err = launch_wgmma<64, true>(bs, sc, sh, out, p, g, sm, ta, tw, s); break;
    case 193: err = launch_wgmma<96, true>(bs, sc, sh, out, p, g, sm, ta, tw, s); break;
    case 257: err = launch_wgmma<128, true>(bs, sc, sh, out, p, g, sm, ta, tw, s); break;
    case 128: err = launch_wgmma<64, false>(bs, sc, sh, out, p, g, sm, ta, tw, s); break;
    case 256: err = launch_wgmma<128, false>(bs, sc, sh, out, p, g, sm, ta, tw, s); break;
    default: break;
  }
  return (int)err;
}

// f32: a (B, D_in, H, W, K) the conv input (forward) or the cotangent (dx);
// w (3, 3, 3, w_cin, w_cout) f32 in its own layout; bias, scale, shift:
// (N,) f32; out (B, D_out, H, W, N), N = w_cout (forward, K = w_cin) or
// w_cin (dx, K = w_cout), f32 (out_f32 1) or bf16 (0).  off as in
// ``conv3d_bf16``.  The tile of icsg3d_torch/kernels/conv3d.py::fma_plan:
// rg row groups and ng channel groups per block, seg_w columns per
// segment, kc channels per staged chunk (4, 8, 16 or 32); at most
// 256 threads (seg_w * rg * ng) and SMEM_MAX bytes.  epi: see Epilogue;
// scale and shift may be null for epi == 0.  Returns cudaGetLastError()
// after the launch (0 = launched); cudaErrorInvalidValue for a tile or
// shape it does not take.  Allocates nothing and does not synchronise.
extern "C" int conv3d_f32(const void* a, const void* w, const void* bias, const void* scale,
                          const void* shift, void* out, int B, int D_in, int D_out, int off,
                          int H, int W, int K, int N, int w_cin, int w_cout, int dx, int rg,
                          int ng, int seg_w, int kc, int out_f32, int epi,
                          float slope, void* stream) {
  int lkc = 0;
  while (lkc < 6 && (1 << lkc) < kc) ++lkc;
  const long long threads = (long long)seg_w * rg * ng;
  if (B <= 0 || D_out <= 0 || D_in <= 0 || H <= 0 || W <= 0 || off < -1 || off > 1 ||
      D_in != D_out + 2 * off || K <= 0 || N <= 0 ||
      (dx ? (N != w_cin || K != w_cout) : (K != w_cin || N != w_cout)) ||
      (long long)B * D_in * H * W * K >= (1LL << 31) ||
      (long long)B * D_out * H * W * N >= (1LL << 31) || kc < 4 || kc > 32 ||
      (1 << lkc) != kc || rg < 1 || ng < 1 || seg_w < 1 || seg_w > W || threads > FT_MAX ||
      epi < 0 || epi > 3 || (epi != 0 && (!scale || !shift)))
    return (int)cudaErrorInvalidValue;
  FGeom p;
  p.D_in = D_in; p.D_out = D_out; p.off = off; p.H = H; p.W = W; p.K = K; p.N = N;
  p.w_cin = w_cin; p.w_cout = w_cout; p.dx = dx ? 1 : 0;
  p.R = RT * rg; p.RG = rg; p.Ws = seg_w; p.P = seg_w + 2; p.kc = kc; p.lkc = lkc;
  p.CS = kc == 4 ? 4 : kc + 4;
  p.BN = CT * ng; p.nseg = (W + seg_w - 1) / seg_w; p.row_tiles = (H + p.R - 1) / p.R;
  p.vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  p.row_elems = p.P * kc / (p.vec ? 4 : 1);
  p.epi = epi; p.slope = slope;
  p.inv_row = 1.f / p.row_elems; p.inv_rows = 1.f / (p.R + 2); p.inv_bn = 1.f / p.BN;
  const long long wfl = 27LL * kc * p.BN, xfl = 3LL * (p.R + 2) * p.P * p.CS;
  const long long smem = 4 * (wfl + xfl);
  const long long grid = (long long)B * D_out * p.row_tiles * p.nseg;
  const long long n_tiles = (N + p.BN - 1) / p.BN;
  // the staging decode (fdiv) is exact below 2^21 elements
  if (smem > SMEM_MAX || wfl >= (1 << 21) || 3 * (p.R + 2) * (long long)p.row_elems >= (1 << 21) ||
      grid >= (1LL << 31) || n_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  const float* wf = static_cast<const float*>(w);
  const float* bs = static_cast<const float*>(bias);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g((unsigned)grid, (unsigned)n_tiles);
  const cudaError_t err =
      out_f32 ? launch_f32<float>(af, wf, bs, sc, sh, out, p, g, (int)threads, (int)smem, s)
              : launch_f32<__nv_bfloat16>(af, wf, bs, sc, sh, out, p, g, (int)threads,
                                          (int)smem, s);
  return (int)err;
}
