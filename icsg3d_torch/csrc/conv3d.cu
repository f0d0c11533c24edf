// 3x3x3 stride-1 SAME convolution on NDHWC activations, with a fused
// per-channel epilogue, for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of icsg3d_tpu:
//   K1 forward  icsg3d_tpu/ops/lowc_conv.py::_kernel       (conv + bias)
//   K3          icsg3d_tpu/ops/pallas_conv.py::_conv_kernel (conv + folded
//               inference BN + activation)
// The TPU forms (spatial-major layout, 128-lane aprons, tap packing, VMEM
// depth blocks) are not carried over; this is an implicit GEMM:
//   M = B*D*H*W output voxels, N = Cout, K = 27*Cin,
//   out[m, co] = epi( sum_{tap, ci} x[shift(m, tap), ci] * wt[tap, co, ci] )
// with SAME zero padding done by predicated (zero-filling) loads at all six
// faces and f32 accumulation.  Weights arrive K-contiguous per output
// channel, wt = (27, Cout, Cin), so both operands load as 16-byte rows.
//
// What bounds it on this card: at the U-Net's widths (Cin 64..768) the conv
// does 27*Cout multiply-adds per input element it reads, far above the
// H100's ~295 flop/byte ridge, so the ceiling is tensor-core throughput.
// This kernel feeds mma.sync (not wgmma, which alone reaches the full rate)
// from a 3-stage cp.async ring: 16-byte zero-fill copies of the tap-shifted
// activation rows and of the weights land in shared memory while the
// previous stages' fragments (ldmatrix) go through the tensor cores.  A
// 128x64 block tile reuses every activation element for 64 output channels
// and every weight for 128 voxels; no im2col buffer is written to device
// memory; the folded-BN epilogue is applied to the f32 accumulator before
// the single store, so a conv block is one pass.  Channel counts that are
// not a multiple of 8 (Cin = 4, 14) take scalar predicated loads into the
// same ring and walk K = 27*Cin flat, so their K chunks span taps instead
// of padding each tap to 32 channels; K and N tails are masked.
//
// Types: bf16 input runs on mma.sync.m16n8k16 bf16 tensor cores; f32 input
// (the VAE's f32 output head) runs on a plain f32 FMA kernel, with a
// 16-channel-wide tile for Cout <= 16.  Output bf16 or f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (icsg3d_torch/kernels/conv3d.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block (8 warps), both kernels
constexpr int BM = 128;  // voxels per block tile
constexpr int BN = 64;   // output channels per block tile
constexpr int BK = 32;   // reduction chunk (input channels of one tap)

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

// Per-block voxel coordinates of the BM output rows (-1 past M).
struct RowInfo {
  int vox[BM];
  short d[BM], h[BM], w[BM];

  __device__ void fill(int m0, int M, int D, int H, int W) {
    for (int r = threadIdx.x; r < BM; r += NT) {
      const int m = m0 + r;
      vox[r] = m < M ? m : -1;
      w[r] = m % W;
      h[r] = (m / W) % H;
      d[r] = (m / (W * H)) % D;
    }
  }
  // The voxel row r reads at tap offset (kd, kh, kw), or -1 outside the grid.
  __device__ __forceinline__ int src(int r, int kd, int kh, int kw, int delta,
                                     int D, int H, int W) const {
    const int v = vox[r];
    const int dd = d[r] + kd, hh = h[r] + kh, ww = w[r] + kw;
    const bool in = v >= 0 && dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W;
    return in ? v + delta : -1;
  }
};

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel: 8 warps as 4 (M) x 2 (N), each a 32x32 sub-tile.

constexpr int STAGES = 3;
constexpr int LDS = BK + 8;  // 80-byte rows: 16-byte aligned, conflict-free ldmatrix

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// kVec: Cin % 8 == 0 and 16-byte aligned operands -> cp.async 16-byte rows;
// otherwise scalar predicated loads.
template <typename TOut, bool kVec>
__global__ void __launch_bounds__(NT)
conv3d_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                  const float* __restrict__ bias, const float* __restrict__ scale,
                  const float* __restrict__ shift, TOut* __restrict__ out,
                  int B, int D, int H, int W, int Cin, int Cout, int epi, float slope) {
  __shared__ __align__(16) __nv_bfloat16 sA[STAGES][BM][LDS];  // [voxel][k]
  __shared__ __align__(16) __nv_bfloat16 sB[STAGES][BN][LDS];  // [cout][k]
  __shared__ RowInfo rows;

  const int M = B * D * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  rows.fill(m0, M, D, H, W);
  __syncthreads();

  // kVec: K steps are (tap, BK-channel chunk) pairs.  Scalar: K = 27*Cin
  // is walked flat, so a chunk spans taps and small Cin wastes no MMA work.
  const int nchunk = (Cin + BK - 1) / BK;
  const int nk = kVec ? 27 * nchunk : (27 * Cin + BK - 1) / BK;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  auto load_stage = [&](int buf, int ks) {
    if constexpr (kVec) {
      const int tap = ks / nchunk, c0 = (ks % nchunk) * BK;
      const int kd = tap / 9 - 1, kh = (tap / 3) % 3 - 1, kw = tap % 3 - 1;
      const int delta = (kd * H + kh) * W + kw;
#pragma unroll
      for (int i = 0; i < BM * BK / 8 / NT; ++i) {  // 2 A rows of 8 per thread
        const int c = tid + i * NT;
        const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        const int s = c0 + kc < Cin ? rows.src(r, kd, kh, kw, delta, D, H, W) : -1;
        const __nv_bfloat16* p = s >= 0 ? x + (long long)s * Cin + c0 + kc : x;
        cp_async16(&sA[buf][r][kc], p, s >= 0 ? 16 : 0);
      }
      {  // 1 B row of 8 per thread
        const int n = tid / (BK / 8), kc = (tid % (BK / 8)) * 8;
        const int co = n0 + n, ci = c0 + kc;
        const bool ok = co < Cout && ci < Cin;
        const __nv_bfloat16* p = ok ? wt + ((long long)tap * Cout + co) * Cin + ci : wt;
        cp_async16(&sB[buf][n][kc], p, ok ? 16 : 0);
      }
    } else {
      // every thread keeps one k column (NT % BK == 0): one (tap, ci) per stage
      const int k = tid % BK, kf = ks * BK + k;
      const int tap = kf / Cin, ci = kf - tap * Cin;
      const bool kok = kf < 27 * Cin;
      const int kd = tap / 9 - 1, kh = (tap / 3) % 3 - 1, kw = tap % 3 - 1;
      const int delta = (kd * H + kh) * W + kw;
#pragma unroll 4
      for (int i = 0; i < BM * BK / NT; ++i) {
        const int r = (tid + i * NT) / BK;
        const int s = kok ? rows.src(r, kd, kh, kw, delta, D, H, W) : -1;
        sA[buf][r][k] = s >= 0 ? x[(long long)s * Cin + ci] : zero;
      }
#pragma unroll 4
      for (int i = 0; i < BN * BK / NT; ++i) {
        const int co = n0 + (tid + i * NT) / BK;
        sB[buf][co - n0][k] =
            kok && co < Cout ? wt[((long long)tap * Cout + co) * Cin + ci] : zero;
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage ks landed; stage ks-1's buffer is free
    const int nxt = ks + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt);
    cp_async_commit();

    const int buf = ks % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], &sA[buf][wm * 32 + mi * 16 + lane % 16][kk + (lane / 16) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, &sB[buf][wn * 32 + nj * 16 + lane % 8 + (lane / 16) * 8]
                          [kk + ((lane / 8) % 2) * 8]);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + mi * 16 + g + (e >> 1) * 8;
        const int co = n0 + wn * 32 + ni * 8 + tq * 2 + (e & 1);
        if (m < M && co < Cout)
          out[(long long)m * Cout + co] =
              from_float<TOut>(epilogue(acc[mi][ni][e], co, bias, scale, shift, epi, slope));
      }
}

// ---------------------------------------------------------------------------
// f32 FMA kernel: 16 x 16 threads, each 8 voxels x TN channels strided by
// 16, so a block covers BM voxels x 16*TN channels (TN = 1 for Cout <= 16,
// the VAE's 16->4 output head).  K = 27*Cin is walked flat.

template <typename TOut, int TN>
__global__ void __launch_bounds__(NT)
conv3d_fma_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                  const float* __restrict__ bias, const float* __restrict__ scale,
                  const float* __restrict__ shift, TOut* __restrict__ out,
                  int B, int D, int H, int W, int Cin, int Cout, int epi, float slope) {
  constexpr int FBN = 16 * TN;
  __shared__ float sA[BM][BK + 1];   // [voxel][k]
  __shared__ float sB[FBN][BK + 1];  // [cout][k]
  __shared__ RowInfo rows;

  const int M = B * D * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * FBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  rows.fill(m0, M, D, H, W);
  __syncthreads();

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = (27 * Cin + BK - 1) / BK;
  for (int ks = 0; ks < nk; ++ks) {
    // every thread keeps one k column (NT % BK == 0): one (tap, ci) per step
    const int k = tid % BK, kf = ks * BK + k;
    const int tap = kf / Cin, ci = kf - tap * Cin;
    const bool kok = kf < 27 * Cin;
    const int kd = tap / 9 - 1, kh = (tap / 3) % 3 - 1, kw = tap % 3 - 1;
    const int delta = (kd * H + kh) * W + kw;
#pragma unroll 4
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int r = (tid + i * NT) / BK;
      const int s = kok ? rows.src(r, kd, kh, kw, delta, D, H, W) : -1;
      sA[r][k] = s >= 0 ? x[(long long)s * Cin + ci] : 0.f;
    }
    for (int n = tid / BK; n < FBN; n += NT / BK) {
      const int co = n0 + n;
      sB[n][k] = kok && co < Cout ? wt[((long long)tap * Cout + co) * Cin + ci] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[TN];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sA[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sB[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = m0 + ty + 16 * i;
      const int co = n0 + tx + 16 * j;
      if (m < M && co < Cout)
        out[(long long)m * Cout + co] =
            from_float<TOut>(epilogue(acc[i][j], co, bias, scale, shift, epi, slope));
    }
}

template <typename TOut>
void launch_mma(const void* x, const void* wt, const float* bias, const float* scale,
                const float* shift, void* out, int B, int D, int H, int W, int Cin,
                int Cout, int epi, float slope, cudaStream_t stream) {
  const long long M = (long long)B * D * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  const bool vec = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto wb = static_cast<const __nv_bfloat16*>(wt);
  auto o = static_cast<TOut*>(out);
  if (vec)
    conv3d_mma_kernel<TOut, true><<<grid, NT, 0, stream>>>(xb, wb, bias, scale, shift, o, B,
                                                           D, H, W, Cin, Cout, epi, slope);
  else
    conv3d_mma_kernel<TOut, false><<<grid, NT, 0, stream>>>(xb, wb, bias, scale, shift, o, B,
                                                            D, H, W, Cin, Cout, epi, slope);
}

template <typename TOut>
void launch_fma(const void* x, const void* wt, const float* bias, const float* scale,
                const float* shift, void* out, int B, int D, int H, int W, int Cin,
                int Cout, int epi, float slope, cudaStream_t stream) {
  const long long M = (long long)B * D * H * W;
  const unsigned mt = (unsigned)((M + BM - 1) / BM);
  auto xf = static_cast<const float*>(x);
  auto wf = static_cast<const float*>(wt);
  auto o = static_cast<TOut*>(out);
  if (Cout <= 16)
    conv3d_fma_kernel<TOut, 1><<<dim3(mt, (Cout + 15) / 16), NT, 0, stream>>>(
        xf, wf, bias, scale, shift, o, B, D, H, W, Cin, Cout, epi, slope);
  else
    conv3d_fma_kernel<TOut, 4><<<dim3(mt, (Cout + 63) / 64), NT, 0, stream>>>(
        xf, wf, bias, scale, shift, o, B, D, H, W, Cin, Cout, epi, slope);
}

}  // namespace

// x: (B, D, H, W, Cin); wt: (27, Cout, Cin) in x's dtype; bias, scale,
// shift: (Cout,) f32; out: (B, D, H, W, Cout).  dtype codes: 0 = float32,
// 1 = bfloat16.  epi: see Epilogue; scale and shift may be null for
// epi == 0.  Returns cudaGetLastError() after the launch (0 = launched).
// Allocates nothing and does not synchronise.
extern "C" int conv3d_same(const void* x, const void* wt, const void* bias,
                           const void* scale, const void* shift, void* out,
                           int B, int D, int H, int W, int Cin, int Cout,
                           int in_dtype, int out_dtype, int epi, float slope,
                           void* stream) {
  const long long M = (long long)B * D * H * W;
  if (M <= 0 || M >= (1LL << 31) || Cin <= 0 || Cout <= 0 || epi < 0 ||
      epi > 3 || ((epi != 0) && (!scale || !shift)))
    return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 1)
    launch_mma<__nv_bfloat16>(x, wt, b, sc, sh, out, B, D, H, W, Cin, Cout, epi, slope, s);
  else if (in_dtype == 1 && out_dtype == 0)
    launch_mma<float>(x, wt, b, sc, sh, out, B, D, H, W, Cin, Cout, epi, slope, s);
  else if (in_dtype == 0 && out_dtype == 0)
    launch_fma<float>(x, wt, b, sc, sh, out, B, D, H, W, Cin, Cout, epi, slope, s);
  else if (in_dtype == 0 && out_dtype == 1)
    launch_fma<__nv_bfloat16>(x, wt, b, sc, sh, out, B, D, H, W, Cin, Cout, epi, slope, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
