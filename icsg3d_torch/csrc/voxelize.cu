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
// The TPU forms are dropped: the 128-lane site padding, the 2048-voxel tiles,
// the MXU matmuls for the cross term and the reduction.  Here the batch is a
// grid axis (grid = (voxel tiles, B)), one thread owns one voxel, and a block
// stages its structure's sites in shared memory with the per-site constants
// precomputed (|s|^2, -1/(2 sigma^2), z/sigma^3*mask, the labelling radius,
// z).  One loop over the sites keeps in registers the density sum, the count
// of sites within, the first site within, and the running minimum distance
// with its index; nothing of size voxels x sites touches device memory.
// Sites that are inert (mask 0: zero weight, never within, never closest)
// are skipped, and the loop ends after the last site with a nonzero mask
// (pad_sites packs real sites first).
//
// What bounds it on this card: the work per voxel is a few dozen f32
// operations and one exponential per real site, the output is two f32 grids
// (8 bytes per voxel).  At the build's chunk of 256 structures at 32^3 with
// ~6 real sites each, the 67 MB of output over 3.35 TB/s (20 us) is above
// the f32 operations over 66.9 TFLOP/s and the exponentials over the SFU
// rate (a few us each): the bound is the bytes written.  This kernel runs
// near ten times that bound on an H100 (PERF.md): what limits it is the
// instructions issued per site-voxel pair (the IEEE square root, the
// accurate expf, the rounding intrinsics) and the integer index math per
// voxel, not the bytes.  Handing a block more voxels, to spread its staging,
// did not move the time.  A faster kernel would run the labelling test on d2
// against a per-site threshold (the least f32 whose rounded square root
// reaches the radius), which is the same test bit for bit, and take square
// roots only where the closest site decides.
//
// Numerics: the distance is evaluated in exactly the plain version's
// operation order with explicit round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn, __fsub_rn, __fsqrt_rn), so nvcc's FMA contraction cannot change
// a rounding: the species grid, which compares distances, is bitwise the
// plain version's (kernels/voxelize.py::voxelize_reference).  The closest
// site is chosen on sqrt(d2), as the reference's argmin over distances does
// (two d2 values may round to one distance; the lower index wins).  The
// density sums in site order with expf and a precomputed reciprocal, within
// the plain version's matvec to a relative 2e-4.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (icsg3d_torch/kernels/voxelize.py does this).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;          // threads (voxels) per block
constexpr int MAX_SITES = 1024;  // shared memory: 32 bytes per site
constexpr int MAX_D = 512;       // shared memory: 12 bytes per axis point

__global__ void __launch_bounds__(NT)
voxelize_kernel(const float* __restrict__ sites, const float* __restrict__ z,
                const float* __restrict__ sigma, const float* __restrict__ mask,
                const float* __restrict__ abc, float* __restrict__ density,
                float* __restrict__ species, int S, int d, float eps,
                float one_plus_2eps, float label_frac, float norm) {
  extern __shared__ float4 smem[];
  float4* geo = smem;                                   // S x (sx, sy, sz, |s|^2)
  float4* par = smem + S;                               // S x (-1/(2s^2), w, radius, z)
  float* axis = reinterpret_cast<float*>(smem + 2 * S);  // 3 x d voxel-centre coordinates
  __shared__ int n_eff;

  const int b = blockIdx.y;
  if (threadIdx.x == 0) n_eff = 0;
  __syncthreads();

  const long long so = (long long)b * S;
  for (int s = threadIdx.x; s < S; s += NT) {
    const float x = sites[3 * (so + s)], y = sites[3 * (so + s) + 1],
                c = sites[3 * (so + s) + 2];
    const float n2 =
        __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(c, c));
    const float sg = fmaxf(sigma[so + s], 1e-6f);
    const float m = mask[so + s], zs = z[so + s];
    const float two_s2 = __fmul_rn(__fmul_rn(2.f, sg), sg);
    const float w = __fmul_rn(__fdiv_rn(zs, __fmul_rn(__fmul_rn(sg, sg), sg)), m);
    // a radius < 0 marks an invalid site (mask <= 0): never within, never
    // closest; label_frac >= 0 keeps every valid radius >= 0
    const float rad = m > 0.f ? __fmul_rn(sg, label_frac) : -1.f;
    geo[s] = make_float4(x, y, c, n2);
    par[s] = make_float4(__fdiv_rn(-1.f, two_s2), w, rad, zs);
    if (m != 0.f) atomicMax(&n_eff, s + 1);
  }
  // voxel centres per axis, in the op order of ops/voxelize.py:35-56:
  // lo + step * i + dv / 2 with lo = -l*eps, step = (l + l*eps - lo) / d,
  // dv = l * (1 + 2 eps) / d
  const float fd = (float)d;
  for (int t = threadIdx.x; t < 3 * d; t += NT) {
    const int ax = t / d, i = t - ax * d;
    const float l = abc[3 * b + ax];
    const float lo = __fmul_rn(-l, eps);
    const float hi = __fadd_rn(l, __fmul_rn(l, eps));
    const float step = __fdiv_rn(__fsub_rn(hi, lo), fd);
    const float dv = __fdiv_rn(__fmul_rn(l, one_plus_2eps), fd);
    axis[t] = __fadd_rn(__fadd_rn(lo, __fmul_rn(step, (float)i)), __fmul_rn(dv, 0.5f));
  }
  __syncthreads();

  const int nv = d * d * d;
  const int v = blockIdx.x * NT + threadIdx.x;
  if (v >= nv) return;
  const int i = v / (d * d), j = (v / d) % d, k = v % d;
  const float vx = axis[i], vy = axis[d + j], vz = axis[2 * d + k];
  const float v2 =
      __fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)), __fmul_rn(vz, vz));

  float acc = 0.f, best = INFINITY;
  int n_within = 0, first = -1, best_i = -1;
  const int n = n_eff;
  for (int s = 0; s < n; ++s) {
    const float4 p = par[s];
    if (p.y == 0.f && p.z < 0.f) continue;  // inert (mask 0): the same for every thread
    const float4 g = geo[s];
    const float cross =
        __fadd_rn(__fadd_rn(__fmul_rn(vx, g.x), __fmul_rn(vy, g.y)), __fmul_rn(vz, g.z));
    const float d2 = fmaxf(__fsub_rn(__fadd_rn(v2, g.w), __fmul_rn(2.f, cross)), 0.f);
    acc = __fadd_rn(acc, __fmul_rn(expf(__fmul_rn(d2, p.x)), p.y));
    const float dist = __fsqrt_rn(d2);
    if (dist < p.z) {
      if (n_within == 0) first = s;
      ++n_within;
    }
    if (p.z >= 0.f && dist < best) {
      best = dist;
      best_i = s;
    }
  }
  const long long o = (long long)b * nv + v;
  density[o] = __fmul_rn(norm, acc);
  species[o] = n_within >= 2 ? par[best_i].w : (n_within == 1 ? par[first].w : 0.f);
}

}  // namespace

// sites (B, S, 3), z/sigma/mask (B, S), abc (B, 3): f32, contiguous.
// density and species: f32 (B, d, d, d).  eps = grid eps_frac,
// one_plus_2eps = f32(1 + 2 eps), norm = f32((2 pi)^-1.5).  One launch for
// the whole batch.  Returns cudaGetLastError() after it (0 = launched).
// Allocates nothing and does not synchronise.
extern "C" int voxelize(const void* sites, const void* z, const void* sigma,
                        const void* mask, const void* abc, void* density, void* species,
                        int B, int S, int d, float eps, float one_plus_2eps,
                        float label_frac, float norm, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || S > MAX_SITES || d <= 0 || d > MAX_D ||
      !(label_frac >= 0.f))
    return (int)cudaErrorInvalidValue;
  const int nv = d * d * d;
  const size_t smem = (size_t)S * 2 * sizeof(float4) + (size_t)3 * d * sizeof(float);
  dim3 grid((nv + NT - 1) / NT, B);
  voxelize_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sites), static_cast<const float*>(z),
      static_cast<const float*>(sigma), static_cast<const float*>(mask),
      static_cast<const float*>(abc), static_cast<float*>(density),
      static_cast<float*>(species), S, d, eps, one_plus_2eps, label_frac, norm);
  return (int)cudaGetLastError();
}
