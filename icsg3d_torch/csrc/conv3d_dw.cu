// Weight gradient of the 3x3x3 stride-1 convolution on NDHWC activations,
// SAME in H and W and SAME or VALID in depth, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel K2 of icsg3d_tpu:
//   icsg3d_tpu/ops/lowc_conv.py::_dw_kernel (launched by conv3d_lowc_ndcs_dw),
//   with its depth_valid mode (lowc_conv.py:380-387)
// Its TPU forms (the roll-based 9-tap scatter of g, the 128-lane aprons, the
// sublane channel padding, and the f32 output block kept resident across a
// sequential grid) are not carried over.  Read as a GEMM:
//   dW[tap, ci, co] = sum_v x[shift(v, tap), ci] * g[v, co]
//   M = 27*Cin rows (tap, ci), N = Cout, K = B*D*H*W voxels of g,
// with x zero outside the grid (padding by predicated zero-fill loads).
// In depth, g's plane d reads x's plane d + off + kd: off = 0 for SAME (x
// has g's D planes), off = 1 for VALID (x is a halo-padded slab of D + 2
// planes, the per-shard dW of a depth-sharded conv).  The split-K voxel
// ranges always index g's voxels.
// dW comes out f32 in the DHWIO layout (3, 3, 3, Cin, Cout) = (M, N).
//
// What bounds it on this card: K is long (655,360 voxels at the 32^3 convs
// of a batch of 20) and M*N small (as few as 378 x 16), so the work is a
// few GFLOP over tens of MB: at bf16 the bound is the bytes of x and g,
// read once.  Two things follow.  (1) M*N alone gives a handful of blocks,
// so K is split across blocks: grid (M tiles, N tiles, splits), each block
// reducing a contiguous voxel range into its own f32 slice of a workspace,
// and a second kernel sums the slices in a fixed order -- deterministic,
// no atomics, the same bits on every run.  (2) Each block streams its
// voxel range once through shared memory: a 3-stage cp.async ring of
// 16-byte zero-fill copies (Cin % 8 == 0 and Cout % 8 == 0) lands x rows
// as A^T [voxel][tap,ci] and g rows as B [voxel][co], both in their
// natural NDHWC order, and ldmatrix.trans turns them into mma.sync
// m16n8k16 bf16 fragments with f32 accumulation.  An M tile holds BM/Cin
// taps, so each voxel chunk of x is fetched once per M tile (up to 27 times
// for small Cin), from L2, rather than once into a halo'd shared-memory
// slab: that, the index math of the scalar paths, and mma.sync in place of
// wgmma are what a later, faster kernel changes.
// Cin 4 and 14 and Cout 4 take scalar predicated loads into the same ring.
// The f32 output head (x 16 channels, g 4 channels) runs on an f32 FMA
// kernel with the same split-K structure.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (icsg3d_torch/kernels/conv3d_dw.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;     // threads per block (4 warps), all kernels
constexpr int BM = 64;      // (tap, ci) rows per block tile
constexpr int BN = 32;      // output channels per block tile
constexpr int BK = 32;      // voxels per pipeline stage
constexpr int STAGES = 3;
constexpr int LDA = BM + 8;  // 144-byte rows: 16-byte aligned, conflict-free ldmatrix
constexpr int LDB = BN + 8;  // 80-byte rows

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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// The x voxel that voxel v of g's (B, D, H, W) grid reads at tap (0..26),
// with x's planes offset by ``off`` (x has D + 2*off planes), or -1 outside
// x (or past the block's voxel range, v >= vend).
__device__ __forceinline__ long long shifted(long long v, long long vend, int tap,
                                             int D, int H, int W, int off) {
  if (v >= vend) return -1;
  const int kd = tap / 9 - 1, kh = (tap / 3) % 3 - 1, kw = tap % 3 - 1;
  const long long hw = (long long)W * H, q = v / hw;
  const long long b = q / D;
  const int w = (int)(v % W), h = (int)((v / W) % H), d = (int)(q - b * D);
  const int dd = d + off + kd, hh = h + kh, ww = w + kw;
  if (dd < 0 || dd >= D + 2 * off || hh < 0 || hh >= H || ww < 0 || ww >= W) return -1;
  // x's index: ((b*(D + 2*off) + dd)*H + hh)*W + ww
  return v + ((long long)kd * H + kh) * W + kw + off * (2 * b + 1) * hw;
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel: 4 warps as 2 (M) x 2 (N), each a 32x16 sub-tile.
// Block (mt, nt, s) sums voxels [s*chunk, min((s+1)*chunk, K)) into
// ws[s][M][N] (rows < M, cols < N only).

template <bool kVec>
__global__ void __launch_bounds__(NT)
conv3d_dw_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                     float* __restrict__ ws, int B, int D, int H, int W, int Cin, int Cout,
                     int off, long long chunk) {
  __shared__ __align__(16) __nv_bfloat16 sA[STAGES][BK][LDA];  // [voxel][(tap, ci)]
  __shared__ __align__(16) __nv_bfloat16 sB[STAGES][BK][LDB];  // [voxel][co]

  const int M = 27 * Cin;
  const long long K = (long long)B * D * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long vbeg = (long long)blockIdx.z * chunk;
  const long long vend = vbeg + chunk < K ? vbeg + chunk : K;
  const int nk = vend > vbeg ? (int)((vend - vbeg + BK - 1) / BK) : 0;
  const int tid = threadIdx.x;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  auto load_stage = [&](int buf, int ks) {
    const long long kb = vbeg + (long long)ks * BK;
    if constexpr (kVec) {
#pragma unroll
      for (int i = 0; i < BK * BM / 8 / NT; ++i) {  // 2 A chunks of 8 rows per thread
        const int c = tid + i * NT;
        const int k = c / (BM / 8), mc = (c % (BM / 8)) * 8;
        const int row = m0 + mc;
        long long s = -1;
        int ci = 0;
        if (row < M) {
          const int tap = row / Cin;
          ci = row - tap * Cin;
          s = shifted(kb + k, vend, tap, D, H, W, off);
        }
        const __nv_bfloat16* p = s >= 0 ? x + s * Cin + ci : x;
        cp_async16(&sA[buf][k][mc], p, s >= 0 ? 16 : 0);
      }
      {  // 1 B chunk of 8 channels per thread
        const int k = tid / (BN / 8), nc = (tid % (BN / 8)) * 8;
        const long long v = kb + k;
        const bool ok = v < vend && n0 + nc < Cout;
        const __nv_bfloat16* p = ok ? g + v * Cout + n0 + nc : g;
        cp_async16(&sB[buf][k][nc], p, ok ? 16 : 0);
      }
    } else {
      // every thread keeps one tile column (NT % BM == 0)
      const int mcol = tid % BM, row = m0 + mcol;
      const int tap = row < M ? row / Cin : 0, ci = row - tap * Cin;
#pragma unroll 4
      for (int k = tid / BM; k < BK; k += NT / BM) {
        const long long s = row < M ? shifted(kb + k, vend, tap, D, H, W, off) : -1;
        sA[buf][k][mcol] = s >= 0 ? x[s * Cin + ci] : zero;
      }
      const int ncol = tid % BN, co = n0 + ncol;
#pragma unroll 4
      for (int k = tid / BN; k < BK; k += NT / BN) {
        const long long v = kb + k;
        sB[buf][k][ncol] = v < vend && co < Cout ? g[v * Cout + co] : zero;
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % 2, wn = warp / 2;
  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
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
      // A^T is stored [k][m]: the four 8x8 blocks (k0-7|k8-15) x (m0-7|m8-15)
      // transpose into a0 (m0-7,k0-7), a1 (m8-15,k0-7), a2 (m0-7,k8-15),
      // a3 (m8-15,k8-15).  B is stored [k][n]: blocks (k0-7,n0-7),
      // (k8-15,n0-7), (k0-7,n8-15), (k8-15,n8-15) give b[0][0], b[0][1],
      // b[1][0], b[1][1].
      uint32_t a[2][4], b[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(a[mi], &sA[buf][kk + (lane & 7) + ((lane >> 4) & 1) * 8]
                                    [wm * 32 + mi * 16 + ((lane >> 3) & 1) * 8]);
      {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &sB[buf][kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                                [wn * 16 + ((lane >> 4) & 1) * 8]);
        b[0][0] = r[0];
        b[0][1] = r[1];
        b[1][0] = r[2];
        b[1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();

  float* out = ws + (long long)blockIdx.z * M * Cout;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + mi * 16 + gq + (e >> 1) * 8;
        const int co = n0 + wn * 16 + ni * 8 + tq * 2 + (e & 1);
        if (m < M && co < Cout) out[(long long)m * Cout + co] = acc[mi][ni][e];
      }
}

// ---------------------------------------------------------------------------
// f32 FMA kernel: TX column threads x (NT / TX) row threads, 4 rows each, so
// a block tile is (4 * NT / TX) rows x TX channels (TX = 4 for Cout <= 4,
// the VAE's 16->4 output head; 16 otherwise).

template <int TX>
__global__ void __launch_bounds__(NT)
conv3d_dw_fma_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ ws, int B, int D, int H, int W, int Cin, int Cout,
                     int off, long long chunk) {
  constexpr int TY = NT / TX, FBM = 4 * TY;
  __shared__ float sA[BK][FBM];
  __shared__ float sB[BK][TX];

  const int M = 27 * Cin;
  const long long K = (long long)B * D * H * W;
  const int m0 = blockIdx.x * FBM;
  const int n0 = blockIdx.y * TX;
  const long long vbeg = (long long)blockIdx.z * chunk;
  const long long vend = vbeg + chunk < K ? vbeg + chunk : K;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;

  const int mcol = tid % FBM, row = m0 + mcol;
  const int tap = row < M ? row / Cin : 0, ci = row - tap * Cin;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long kb = vbeg; kb < vend; kb += BK) {
    for (int k = tid / FBM; k < BK; k += NT / FBM) {
      const long long s = row < M ? shifted(kb + k, vend, tap, D, H, W, off) : -1;
      sA[k][mcol] = s >= 0 ? x[s * Cin + ci] : 0.f;
    }
    for (int k = tid / TX; k < BK; k += NT / TX) {
      const long long v = kb + k;
      sB[k][tx] = v < vend && n0 + tx < Cout ? g[v * Cout + n0 + tx] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float b = sB[k][tx];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = fmaf(sA[k][ty + TY * r], b, acc[r]);
    }
    __syncthreads();
  }

  float* out = ws + (long long)blockIdx.z * M * Cout;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty + TY * r, co = n0 + tx;
    if (m < M && co < Cout) out[(long long)m * Cout + co] = acc[r];
  }
}

// dw[i] = sum over s of ws[s][i], s in increasing order (deterministic).
__global__ void __launch_bounds__(256)
reduce_splits_kernel(const float* __restrict__ ws, float* __restrict__ dw, long long n,
                     int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[k * n + i];
    dw[i] = s;
  }
}

// Voxels per split for ``splits`` splits of K = B*D*H*W voxels: a multiple
// of the pipeline depth BK.
long long chunk_voxels(long long K, int splits) {
  const long long per = (K + splits - 1) / splits;
  return (per + BK - 1) / BK * BK;
}

}  // namespace

// x: (B, D + 2*off, H, W, Cin); g: (B, D, H, W, Cout), both in one dtype
// (0 = f32, 1 = bf16); off: 0 (SAME) or 1 (VALID); ws: f32 workspace of
// splits * 27*Cin * Cout; dw: f32 (27*Cin, Cout) = (3, 3, 3, Cin, Cout).
// Every range of chunk_voxels(K, splits) of g's K = B*D*H*W voxels writes
// its slice of ws (zeros past K), then one reduction sums the slices into
// dw.  Returns cudaGetLastError() after the two launches (0 = launched).
// Allocates nothing and does not synchronise.
extern "C" int conv3d_dw(const void* x, const void* g, void* ws, void* dw, int B, int D,
                         int H, int W, int Cin, int Cout, int dtype, int splits, int off,
                         void* stream) {
  const long long K = (long long)B * D * H * W;
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || K >= (1LL << 40) || Cin <= 0 ||
      Cout <= 0 || splits <= 0 || (dtype != 0 && dtype != 1) || (off != 0 && off != 1))
    return (int)cudaErrorInvalidValue;
  const long long chunk = chunk_voxels(K, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  const int M = 27 * Cin;
  if (dtype == 1) {
    dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN, splits);
    const bool vec = Cin % 8 == 0 && Cout % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 16 == 0;
    auto xb = static_cast<const __nv_bfloat16*>(x);
    auto gb = static_cast<const __nv_bfloat16*>(g);
    if (vec)
      conv3d_dw_mma_kernel<true><<<grid, NT, 0, s>>>(xb, gb, wsf, B, D, H, W, Cin, Cout, off,
                                                      chunk);
    else
      conv3d_dw_mma_kernel<false><<<grid, NT, 0, s>>>(xb, gb, wsf, B, D, H, W, Cin, Cout, off,
                                                      chunk);
  } else {
    auto xf = static_cast<const float*>(x);
    auto gf = static_cast<const float*>(g);
    if (Cout <= 4) {
      dim3 grid((M + 4 * (NT / 4) - 1) / (4 * (NT / 4)), (Cout + 3) / 4, splits);
      conv3d_dw_fma_kernel<4><<<grid, NT, 0, s>>>(xf, gf, wsf, B, D, H, W, Cin, Cout, off,
                                                     chunk);
    } else {
      dim3 grid((M + 4 * (NT / 16) - 1) / (4 * (NT / 16)), (Cout + 15) / 16, splits);
      conv3d_dw_fma_kernel<16><<<grid, NT, 0, s>>>(xf, gf, wsf, B, D, H, W, Cin, Cout, off,
                                                     chunk);
    }
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)M * Cout;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  reduce_splits_kernel<<<blocks, 256, 0, s>>>(wsf, static_cast<float*>(dw), n, splits);
  return (int)cudaGetLastError();
}
