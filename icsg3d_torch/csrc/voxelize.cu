// Fused Gaussian voxelization of a batch of crystal structures, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel K4 of icsg3d_tpu:
//   icsg3d_tpu/ops/pallas_voxelize.py::_kernel (launched by voxelize_pallas)
// and the XLA composite that the JAX dataset build actually runs,
//   icsg3d_tpu/ops/voxelize.py::voxelize (vmapped by voxelize_batch).
// For every voxel v of a d^3 grid and the sites s of its structure:
//   d2      = max(|v|^2 + |s|^2 - 2 v.s, 0)
//   density = (2 pi)^-1.5 * sum_s exp(-d2 / (2 sigma_s^2)) * z_s / sigma_s^3 * mask_s
//   species = the conflict rule of the reference (utils.py:120-131): inside
//             exactly one labelling radius (sqrt(d2) < sigma_s * label_frac,
//             mask_s > 0) -> that site's z; inside two or more -> z of the
//             globally closest valid site (lowest index on ties); else 0.
//
// What bounds it on this card: the output, two f32 grids (8 bytes per
// voxel), against a few dozen operations and one exponential per
// site-voxel pair.  At the build's chunk of 256 structures at 32^3 with
// ~6.5 real sites each, the 67 MB written at 3.35 TB/s (20 us) is the
// bound; the f32 operations (66.9 TFLOP/s) and the exponentials (16 per SM
// per clock) take a few us each.  What the kernel spends is instructions
// issued per pair -- doubling the sites doubles its time -- so the design
// cuts those:
//
// - Two kernels per call.  voxelize_sites_kernel (one block per
//   structure, one thread per site) computes every per-site constant once
//   per structure -- (sx, sy, sz, |s|^2) and (-log2(e) / (4 sigma^2),
//   z / sigma^3 * mask, 2T, z) as two 16-byte rows -- packs the valid
//   sites (mask > 0) first in their own order, then the invalid sites that
//   still carry a density weight, and writes the structure's voxel-centre
//   coordinates per axis.  Inert sites (not valid, weight 0) are dropped.
// - voxelize_kernel: a thread owns QPT quads of 4 k voxels of one (i, j)
//   column (k = 4 (r + h tpc) + u), decoded once per thread.  Per site it
//   forms vx*sx + vy*sy once for its 4*QPT voxels, and |v|^2 of each voxel
//   comes from vx^2 + vy^2 computed once per column.  Per pair that
//   leaves, in the plain version's rounding order: cross = cxy + vz*sz,
//   raw = fma(-2, cross, v2 + |s|^2) (2*cross is exact, so one rounding,
//   as the subtraction), h = raw + |raw| = 2 max(d2, 0) (an FP32 add, not
//   a min), the density term ex2.approx(h * scale) FMA'd into the sum,
//   and the labelling test h < 2T accumulated as win += (h < 2T) * (1 +
//   p / 2048), p the packed index: exact in f32, 0 for no site within,
//   1 + p / 2048 for one (its bits decode p), >= 2 for two or more.
// - Results leave as one float4 per grid per quad (when d % 4 == 0;
//   scalar stores for the ragged rest).
//
// Exactness of the species (bitwise the plain version's,
// kernels/voxelize.py::voxelize_reference):
// - The labelling test.  sqrt_rn is monotone on f32 x >= 0, so
//   sqrt_rn(x) < rad holds exactly when x < T, T the least f32 with
//   sqrt_rn(T) >= rad (label_threshold: rad^2 rounded, then a few
//   nextafter steps checked with __fsqrt_rn; T = 0 for rad = 0, inf for
//   rad = inf); and d2 < T exactly when 2 d2 < 2T.
//   kernels/voxelize.py::label_thresholds is its numpy twin.
// - The closest site.  The reference takes argmin over sqrt(d2), first
//   index on ties, and two f32 d2 values can share one rounded square
//   root, so an argmin over d2 alone is not the same.  The main loop
//   keeps no minimum; a voxel inside two or more radii takes the tie walk
//   (one walk for all such voxels of a thread): the least h over the
//   valid sites, then the first site whose h lies below the end of the
//   least d2's square-root class (sqrt_class_end) -- that is, the first
//   site whose sqrt_rn(d2) equals the least one: the reference's winner.
// The density sums valid sites first in site order (then any weighted
// invalid ones) with an FMA per term and exp as ex2.approx; the reference
// is a matvec in another order: within rtol 2e-4 / atol 1e-6.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, PR 8): the site
// loop issues 11.06 SASS instructions per site-voxel pair (the first K4
// kernel: 53.50; tools/k4_sass.py), 72 registers, no spills.  The chunk
// of 256 structures at 32^3 takes about 0.050 ms of device time (main
// 0.047 + setup 0.004; chip_smoke.py), 0.40 of the byte bound.  What
// holds it is the site loop's instruction issue, not the bytes: in
// ablations on the card, doubling the sites doubled the time and dropping
// the stores moved it little.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (icsg3d_torch/kernels/voxelize.py does this).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;          // threads per block of the main kernel
constexpr int QPT = 2;           // quads of 4 k voxels per thread
constexpr int V = 4 * QPT;       // voxels per thread
constexpr int MAX_SITES = 1024;  // shared memory: 32 bytes per site
constexpr int MAX_D = 512;
constexpr float LOG2E = 1.44269504088896340736f;

// Workspace, f32 words: B x 4 header (valid sites, valid + weighted
// invalid sites, two unused) | B x S x 8 site rows | B x 3 x d axis
// coordinates.
__device__ inline size_t rows_offset(int B) { return (size_t)4 * B; }
__device__ inline size_t axis_offset(int B, int S) {
  return rows_offset(B) + (size_t)8 * B * S;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The least f32 t >= 0 with sqrt_rn(t) >= rad, for rad >= 0: then for
// every f32 x >= 0, sqrt_rn(x) < rad exactly when x < t.
__device__ float label_threshold(float rad) {
  float t = __fmul_rn(rad, rad);
  while (t > 0.f && __fsqrt_rn(nextafterf(t, 0.f)) >= rad) t = nextafterf(t, 0.f);
  while (__fsqrt_rn(t) < rad) t = nextafterf(t, INFINITY);
  return t;
}

// One block per structure, one thread per site (blockDim = S rounded up
// to a warp).  Writes the structure's header, its packed site rows and its
// voxel-centre axes into the workspace.
__global__ void __launch_bounds__(MAX_SITES)
voxelize_sites_kernel(const float* __restrict__ sites, const float* __restrict__ z,
                      const float* __restrict__ sigma, const float* __restrict__ mask,
                      const float* __restrict__ abc, float* __restrict__ ws, int S, int d,
                      float eps, float one_plus_2eps, float label_frac) {
  __shared__ int warp_valid[MAX_SITES / 32], warp_extra[MAX_SITES / 32];
  const int b = blockIdx.x, B = gridDim.x, s = threadIdx.x;
  const int lane = s & 31, warp = s >> 5, warps = blockDim.x >> 5;
  const long long so = (long long)b * S + s;
  bool valid = false, extra = false;
  float4 geo, par;
  if (s < S) {
    const float x = sites[3 * so], y = sites[3 * so + 1], c = sites[3 * so + 2];
    const float n2 =
        __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(c, c));
    const float sg = fmaxf(sigma[so], 1e-6f);
    const float m = mask[so], zs = z[so];
    const float two_s2 = __fmul_rn(__fmul_rn(2.f, sg), sg);
    const float w = __fmul_rn(__fdiv_rn(zs, __fmul_rn(__fmul_rn(sg, sg), sg)), m);
    valid = m > 0.f;
    extra = !valid && w != 0.f;  // density only
    geo = make_float4(x, y, c, n2);
    // the main loop works on h = 2 d2: exponent scale and threshold doubled
    // and halved exactly
    par = make_float4(__fmul_rn(__fdiv_rn(-LOG2E, two_s2), 0.5f), w,
                      valid ? __fmul_rn(2.f, label_threshold(__fmul_rn(sg, label_frac))) : -1.f,
                      zs);
  }
  const unsigned bv = __ballot_sync(0xffffffffu, valid),
                 be = __ballot_sync(0xffffffffu, extra);
  if (lane == 0) {
    warp_valid[warp] = __popc(bv);
    warp_extra[warp] = __popc(be);
  }
  __syncthreads();
  int pv = 0, tv = 0, pe = 0, te = 0;  // before this warp / in all
  for (int w = 0; w < warps; ++w) {
    pv += w < warp ? warp_valid[w] : 0;
    pe += w < warp ? warp_extra[w] : 0;
    tv += warp_valid[w];
    te += warp_extra[w];
  }
  const unsigned lower = (1u << lane) - 1u;
  float4* rows = reinterpret_cast<float4*>(ws + rows_offset(B)) + (size_t)b * 2 * S;
  if (valid || extra) {  // valid sites in site order, then the weighted invalid ones
    const int at = valid ? pv + __popc(bv & lower) : tv + pe + __popc(be & lower);
    rows[2 * at] = geo;
    rows[2 * at + 1] = par;
  }
  if (s == 0) {
    int* head = reinterpret_cast<int*>(ws) + 4 * b;
    head[0] = tv;
    head[1] = tv + te;
  }
  // voxel centres per axis, in the op order of ops/voxelize.py:35-56:
  // lo + step * i + dv / 2 with lo = -l*eps, step = (l + l*eps - lo) / d,
  // dv = l * (1 + 2 eps) / d
  float* axis = ws + axis_offset(B, S) + (size_t)b * 3 * d;
  const float fd = (float)d;
  for (int t = s; t < 3 * d; t += blockDim.x) {
    const int ax = t / d, i = t - ax * d;
    const float l = abc[3 * b + ax];
    const float lo = __fmul_rn(-l, eps);
    const float hi = __fadd_rn(l, __fmul_rn(l, eps));
    const float step = __fdiv_rn(__fsub_rn(hi, lo), fd);
    const float dv = __fdiv_rn(__fmul_rn(l, one_plus_2eps), fd);
    axis[t] = __fadd_rn(__fadd_rn(lo, __fmul_rn(step, (float)i)), __fmul_rn(dv, 0.5f));
  }
}

// h = 2 max(d2, 0) of one pair, d2 in the plain version's rounding order,
// from the site's cxy = vx*sx + vy*sy, the voxel's vz and |v|^2, and the
// site's (sz, |s|^2).  raw + |raw| doubles exactly (or gives +0), so h / 2
// is the plain version's clamped d2 bit for bit; the clamp costs an FP32
// add, not a min.
__device__ __forceinline__ float pair_h(float cxy, float vz, float v2, float sz, float n2) {
  const float raw = __fmaf_rn(-2.f, __fadd_rn(cxy, __fmul_rn(vz, sz)), __fadd_rn(v2, n2));
  return __fadd_rn(raw, fabsf(raw));
}

// For the least h = 2 d2 of a voxel: 2u, u the least f32 above d2 whose
// sqrt_rn exceeds sqrt_rn(d2).  Every d2' >= d2 then has sqrt_rn(d2') ==
// sqrt_rn(d2) exactly when 2 d2' < 2u (sqrt_rn is monotone).
__device__ float sqrt_class_end(float h_least) {
  const float x = __fmul_rn(0.5f, h_least);
  const float r = __fsqrt_rn(x);
  float u = nextafterf(x, INFINITY);
  while (__fsqrt_rn(u) == r && u < INFINITY) u = nextafterf(u, INFINITY);
  return __fmul_rn(2.f, u);
}

// win, a voxel's sum over the sites within of 1 + p / 2048 (p the packed
// index < 1024), is exact in f32: 0 for none, 1 + p / 2048 for one (its
// bits are 0x3f800000 + (p << 12)), >= 2 for two or more.
constexpr float WITHIN_STEP = 1.f / 2048.f;

__global__ void __launch_bounds__(NT)
voxelize_kernel(const float* __restrict__ ws, float* __restrict__ density,
                float* __restrict__ species, int S, int d, int tpc, float norm) {
  extern __shared__ float4 rows_s[];  // S x (sx, sy, sz, |s|^2), (scale/2, w, 2T, z)
  __shared__ int2 head_s;
  const int b = blockIdx.y, B = gridDim.y;
  // every load here is independent of the others: the rows (all S of
  // them, not the header's count), the header, the voxels' axes
  const float4* rows = reinterpret_cast<const float4*>(ws + rows_offset(B)) + (size_t)b * 2 * S;
  for (int t = threadIdx.x; t < 2 * S; t += NT) rows_s[t] = rows[t];
  if (threadIdx.x == 0) head_s = reinterpret_cast<const int2*>(ws)[2 * b];

  const int t = min(blockIdx.x * NT + threadIdx.x, d * d * tpc - 1);
  const int col = t / tpc, r = t - col * tpc;  // column (i, j), its r-th thread
  const int i = col / d, j = col - i * d;
  const float* axis = ws + axis_offset(B, S) + (size_t)b * 3 * d;
  const float vx = axis[i], vy = axis[d + j];
  // voxel h*4 + u is k = 4 * (r + h * tpc) + u; k >= d (ragged quads) is
  // computed on the last voxel's centre and not stored
  float vz[V], v2[V], acc[V], win[V];
#pragma unroll
  for (int q = 0; q < V; ++q) vz[q] = axis[2 * d + min(4 * (r + (q / 4) * tpc) + q % 4, d - 1)];
  __syncthreads();
  if (blockIdx.x * NT + threadIdx.x >= d * d * tpc) return;
  const int n_valid = head_s.x, n = head_s.y;
  const float vxy2 = __fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy));
#pragma unroll
  for (int q = 0; q < V; ++q) {
    v2[q] = __fadd_rn(vxy2, __fmul_rn(vz[q], vz[q]));
    acc[q] = 0.f;
    win[q] = 0.f;
  }
  float enc = 1.f;  // 1 + s / 2048
#pragma unroll 2
  for (int s = 0; s < n_valid; ++s) {
    const float4 g = rows_s[2 * s], c = rows_s[2 * s + 1];
    const float cxy = __fadd_rn(__fmul_rn(vx, g.x), __fmul_rn(vy, g.y));
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float h = pair_h(cxy, vz[q], v2[q], g.z, g.w);
      acc[q] = __fmaf_rn(ex2_approx(__fmul_rn(h, c.x)), c.y, acc[q]);
      win[q] = __fmaf_rn(h < c.z ? 1.f : 0.f, enc, win[q]);
    }
    enc = __fadd_rn(enc, WITHIN_STEP);
  }
  for (int s = n_valid; s < n; ++s) {  // weighted invalid sites: density only
    const float4 g = rows_s[2 * s], c = rows_s[2 * s + 1];
    const float cxy = __fadd_rn(__fmul_rn(vx, g.x), __fmul_rn(vy, g.y));
#pragma unroll
    for (int q = 0; q < V; ++q)
      acc[q] = __fmaf_rn(ex2_approx(__fmul_rn(pair_h(cxy, vz[q], v2[q], g.z, g.w), c.x)),
                         c.y, acc[q]);
  }

  float sp[V];
  bool tie = false;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    sp[q] = 0.f;
    if (win[q] > 0.f && win[q] < 2.f)  // one site within: its z
      sp[q] = rows_s[2 * ((__float_as_int(win[q]) - 0x3f800000) >> 12) + 1].w;
    tie |= win[q] >= 2.f;
    acc[q] = __fmul_rn(norm, acc[q]);
  }
  if (tie) {
    // The tie walk, for the thread's voxels inside two or more radii at
    // once: the least h over the valid sites, then the first site in its
    // square-root class -- the reference's argmin over sqrt(d2), first
    // index on ties.
    float lim[V];
#pragma unroll
    for (int q = 0; q < V; ++q) lim[q] = INFINITY;
    for (int s = 0; s < n_valid; ++s) {
      const float4 g = rows_s[2 * s];
      const float cxy = __fadd_rn(__fmul_rn(vx, g.x), __fmul_rn(vy, g.y));
#pragma unroll
      for (int q = 0; q < V; ++q) lim[q] = fminf(lim[q], pair_h(cxy, vz[q], v2[q], g.z, g.w));
    }
#pragma unroll
    for (int q = 0; q < V; ++q) lim[q] = win[q] >= 2.f ? sqrt_class_end(lim[q]) : -1.f;
    for (int s = 0; s < n_valid; ++s) {
      const float4 g = rows_s[2 * s];
      const float zs = rows_s[2 * s + 1].w;
      const float cxy = __fadd_rn(__fmul_rn(vx, g.x), __fmul_rn(vy, g.y));
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const bool hit = pair_h(cxy, vz[q], v2[q], g.z, g.w) < lim[q];
        sp[q] = hit ? zs : sp[q];
        lim[q] = hit ? -1.f : lim[q];
      }
    }
  }
  const long long o = ((long long)b * d + i) * d * d + (long long)j * d;
#pragma unroll
  for (int h = 0; h < QPT; ++h) {
    const int k0 = 4 * (r + h * tpc);
    if (k0 >= d) break;
    if ((d & 3) == 0) {  // o + k0 is a multiple of 4: 16-byte aligned
      *reinterpret_cast<float4*>(density + o + k0) =
          make_float4(acc[4 * h], acc[4 * h + 1], acc[4 * h + 2], acc[4 * h + 3]);
      *reinterpret_cast<float4*>(species + o + k0) =
          make_float4(sp[4 * h], sp[4 * h + 1], sp[4 * h + 2], sp[4 * h + 3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k0 + u < d) {
          density[o + k0 + u] = acc[4 * h + u];
          species[o + k0 + u] = sp[4 * h + u];
        }
    }
  }
}

}  // namespace

// sites (B, S, 3), z/sigma/mask (B, S), abc (B, 3): f32, contiguous.
// workspace: 4 B + 8 B S + 3 B d f32 words, 16-byte aligned.  density and
// species: f32 (B, d, d, d).  tpc = threads per column = ceil(ceil(d / 4)
// / QPT).  eps = grid eps_frac, one_plus_2eps = f32(1 + 2 eps), norm =
// f32((2 pi)^-1.5).  Launches the per-structure setup and then the main
// kernel on ``stream``; returns cudaGetLastError() after them (0 =
// launched).  Allocates nothing and does not synchronise.
extern "C" int voxelize(const void* sites, const void* z, const void* sigma,
                        const void* mask, const void* abc, void* workspace, void* density,
                        void* species, int B, int S, int d, int tpc, float eps,
                        float one_plus_2eps, float label_frac, float norm, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || S > MAX_SITES || d <= 0 || d > MAX_D ||
      !(label_frac >= 0.f) || tpc != ((d + 3) / 4 + QPT - 1) / QPT)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  voxelize_sites_kernel<<<B, (S + 31) / 32 * 32, 0, st>>>(
      static_cast<const float*>(sites), static_cast<const float*>(z),
      static_cast<const float*>(sigma), static_cast<const float*>(mask),
      static_cast<const float*>(abc), ws, S, d, eps, one_plus_2eps, label_frac);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((d * d * tpc + NT - 1) / NT, B);
  voxelize_kernel<<<grid, NT, (size_t)S * 2 * sizeof(float4), st>>>(
      ws, static_cast<float*>(density), static_cast<float*>(species), S, d, tpc, norm);
  return (int)cudaGetLastError();
}
