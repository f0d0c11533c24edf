// The device extraction's two loops, each run to convergence on the card,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the two lax.while_loops of icsg3d_tpu/ops/extract.py that the
// fused generation (apps/generate.py --fused) runs inside one XLA program:
//   E1  connected_components_same_value, its while_loop at extract.py:104
//   E2  nearest_seed_labels, its while_loop at extract.py:221
// The port ran each round of those loops from the host, dozens of small
// launches and one host read of "has anything changed" per round
// (ops/extract.py's *_reference functions).  Here one launch runs the whole
// loop: one block per sample iterates until its own sample has converged,
// the convergence flag a block-wide __syncthreads_or that only the device
// reads.  A converged sample is a fixed point of the round, so a sample
// stopping on its own gives what the batched host loop gives.
//
// What bounds them: a round is a pass over the sample's grid, so the time
// is rounds x the latency of one pass, not the 8 (E1) or 14 (E2) bytes per
// voxel that must be read and written once.  One block per sample keeps
// the loop inside one SM with no grid-wide barrier, and the sample's state
// sits where a pass's dependent loads are quickest:
// - in shared memory when it fits the 227 KB a block may have: E1's int32
//   labels and neighbour bytes (5 bytes per voxel) up to 46,489 voxels,
//   E2's int32 labels, uint16 distances and neighbour bytes (7 bytes per
//   voxel) up to 33,206 -- 32^3, the generation grid, fits both;
// - else in device memory (int32 distances for E2), which the 50 MB L2
//   holds for a batch of a few 64^3 samples; a pass there waits on L2
//   latency at every step of a line.
// Making a pass faster (clusters or several blocks per sample, so that a
// small batch fills more than batch-many SMs) is later work.
//
// E1 (cc_kernel).  Labels: each 6-connected, same-valued, nonzero
// component gets its smallest flat index i0*d1*d2 + i1*d2 + i2; background
// gets n.  That fixed point is unique, so any schedule of monotone updates
// reaches it: a pass sets label[v] = min(label[v], labels of v's
// same-valued face neighbours, label[label[v]]) in place (the last term a
// pointer jump: label[v] is a voxel of v's component, whose own label is
// no larger).  Threads read neighbours that other threads may be writing;
// every value read is some label of the component, never below its least
// index, so a stale read only costs a pass.  A pass in which no thread
// wrote read only settled values: every voxel is at most its neighbours'
// label, the component's labels are equal, and equal to its least index.
// The labels are therefore bitwise the plain version's; the pass count is
// not its round count (in-place updates and jumps take fewer).
//
// E2 (bfs_kernel).  The ties are not unique (the strict cand < dist keeps
// the first arrival), so E2 repeats the plain version's schedule exactly:
// a round is six sweeps in the order (axis 0, +1), (axis 0, -1), (axis 1,
// +1), (axis 1, -1), (axis 2, +1), (axis 2, -1); each sweep reads what the
// previous one left, and within a sweep every voxel reads its neighbour's
// value from before the sweep (Jacobi).  One thread owns a whole line
// along the sweep's axis and walks it against the shift (a +1 sweep,
// where v reads v - 1, walks downward; a -1 sweep upward), so the
// neighbour it reads has not been updated yet, and its pre-sweep value is
// carried to the next step as that voxel's own.  The predicate
//   fg[v] & ~edge & (cc[u] == cc[v]) & (label[u] != n)
// is built once as six bits per voxel, less the label test.  A round ends
// with "did any distance fall", as the plain version's "has any distance
// changed" (distances only fall).  So each sample runs the plain version's
// rounds, and the largest per-sample count is its count over the batch.
//
// Both loops stop after n + 2 rounds at most (neither can need more:
// a distance or a Jacobi label front moves at least one voxel per round);
// the sample's round count is then written as -1, which the callers that
// read it treat as a failure.  No round is ever read by the host.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (icsg3d_torch/kernels/extract.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int NT = 1024;         // threads per block; one block per sample
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may have

// Shared memory per sample of each kernel's state, and whether it fits.
static long long cc_smem(long long n) { return 5 * n; }
static long long bfs_smem(long long n) { return 7 * n; }
static bool cc_in_smem(long long n) { return cc_smem(n) <= SMEM_MAX; }
static bool bfs_in_smem(long long n) { return bfs_smem(n) <= SMEM_MAX && n <= 65535; }

// E1: one block per sample.  species (N, d0, d1, d2) int32; labels the
// same shape; bits a byte per voxel of workspace; rounds (N,).  kShared:
// the labels and bits live in shared memory, the labels copied out at the
// end; else they live in `labels` and `bits`.
template <bool kShared>
__global__ void __launch_bounds__(NT, 1)
cc_kernel(const int* __restrict__ species, int* labels, uint8_t* bits,
          int* __restrict__ rounds, int d0, int d1, int d2, int max_rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = d0 * d1 * d2;
  const int s0 = d1 * d2;
  const size_t base = (size_t)blockIdx.x * (size_t)n;
  const int* sp = species + base;
  int* lab = kShared ? reinterpret_cast<int*>(smem) : labels + base;
  uint8_t* nb = kShared ? smem + (size_t)4 * n : bits + base;

  // same-valued, nonzero face neighbours inside the grid, as six bits
  for (int v = threadIdx.x; v < n; v += NT) {
    const int s = sp[v];
    const int i0 = v / s0, r = v - i0 * s0, i1 = r / d2, i2 = r - i1 * d2;
    uint8_t m = 0;
    if (s > 0) {
      if (i0 > 0 && sp[v - s0] == s) m |= 1;
      if (i0 < d0 - 1 && sp[v + s0] == s) m |= 2;
      if (i1 > 0 && sp[v - d2] == s) m |= 4;
      if (i1 < d1 - 1 && sp[v + d2] == s) m |= 8;
      if (i2 > 0 && sp[v - 1] == s) m |= 16;
      if (i2 < d2 - 1 && sp[v + 1] == s) m |= 32;
    }
    nb[v] = m;
    lab[v] = s > 0 ? v : n;
  }
  __syncthreads();

  int round = 0;
  for (;;) {
    ++round;
    int wrote = 0;
    for (int v = threadIdx.x; v < n; v += NT) {
      const int m = nb[v];
      if (m == 0) continue;  // background, or a component of one voxel
      const int own = lab[v];
      int best = own;
      if (m & 1) best = min(best, lab[v - s0]);
      if (m & 2) best = min(best, lab[v + s0]);
      if (m & 4) best = min(best, lab[v - d2]);
      if (m & 8) best = min(best, lab[v + d2]);
      if (m & 16) best = min(best, lab[v - 1]);
      if (m & 32) best = min(best, lab[v + 1]);
      if (best < n) best = min(best, lab[best]);
      if (best < own) {
        lab[v] = best;
        wrote = 1;
      }
    }
    if (!__syncthreads_or(wrote)) break;
    if (round >= max_rounds) {
      round = -1;
      break;
    }
  }
  if (kShared)
    for (int v = threadIdx.x; v < n; v += NT) labels[base + v] = lab[v];
  if (threadIdx.x == 0) rounds[blockIdx.x] = round;
}

// E2: one block per sample.  seeds, fg (N, d0, d1, d2) bytes (0/1);
// cc, seed_labels (nullable: each voxel's flat index), labels int32; dist
// int32 and bits a byte per voxel of workspace; rounds (N,).  kShared: the
// labels, distances (Dist = uint16_t, n <= 65535) and bits live in shared
// memory, the labels copied out at the end; else in `labels`, `dist`
// (Dist = int) and `bits`.
//
// The state is indexed by (row r = i0 * d1 + i1, column c = i2) at
// r * d2 + (c ^ (r & sw)).  In shared memory sw is the largest power of
// two dividing d2 (at most 32) less one: a warp's 32 threads walk 32
// consecutive rows along axis 2, and the swizzle puts their columns in 32
// different banks (32-way conflicts without it, on 2 of the 6 sweeps);
// the walks along axes 0 and 1 read 32 consecutive columns of one row,
// a permutation of them with it.  In device memory sw = 0: the plain
// flat index.
template <typename Dist, bool kShared>
__global__ void __launch_bounds__(NT, 1)
bfs_kernel(const uint8_t* __restrict__ seeds, const int* __restrict__ cc,
           const uint8_t* __restrict__ fg, const int* __restrict__ seed_labels,
           int* labels, int* dist, uint8_t* bits, int* __restrict__ rounds,
           int d0, int d1, int d2, int max_rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = d0 * d1 * d2;
  const int s0 = d1 * d2;
  const size_t base = (size_t)blockIdx.x * (size_t)n;
  const int* c = cc + base;
  int* lab = kShared ? reinterpret_cast<int*>(smem) : labels + base;
  Dist* dis = kShared ? reinterpret_cast<Dist*>(smem + (size_t)4 * n)
                      : reinterpret_cast<Dist*>(dist + base);
  uint8_t* nb = kShared ? smem + (size_t)6 * n : bits + base;
  const int low = d2 & -d2;
  const int sw = kShared ? (low < 32 ? low : 32) - 1 : 0;
  auto at = [=](int r, int col) { return r * d2 + (col ^ (r & sw)); };

  // bit k: v may receive in sweep k (fg[v], the neighbour inside the grid
  // and of v's cc region); the initial labels and distances
  for (int v = threadIdx.x; v < n; v += NT) {
    const int r = v / d2, i2 = v - r * d2, i0 = r / d1, i1 = r - i0 * d1;
    const bool f = fg[base + v] != 0;
    const int cv = c[v];
    uint8_t m = 0;
    if (f) {
      if (i0 > 0 && c[v - s0] == cv) m |= 1;       // (axis 0, +1): u = v - e0
      if (i0 < d0 - 1 && c[v + s0] == cv) m |= 2;  // (axis 0, -1): u = v + e0
      if (i1 > 0 && c[v - d2] == cv) m |= 4;
      if (i1 < d1 - 1 && c[v + d2] == cv) m |= 8;
      if (i2 > 0 && c[v - 1] == cv) m |= 16;
      if (i2 < d2 - 1 && c[v + 1] == cv) m |= 32;
    }
    const int p = at(r, i2);
    nb[p] = m;
    const bool s = f && seeds[base + v] != 0;
    lab[p] = s ? (seed_labels ? seed_labels[base + v] : v) : n;
    dis[p] = static_cast<Dist>(s ? 0 : n);
  }
  __syncthreads();

  int round = 0;
  for (;;) {
    ++round;
    int fell = 0;
    for (int k = 0; k < 6; ++k) {
      const int axis = k >> 1;
      const int L = axis == 0 ? d0 : axis == 1 ? d1 : d2;
      const int lines = n / L;
      const int bit = 1 << k;
      // the walk's direction: a +1 sweep (v reads v - e) walks down from
      // the far end, a -1 sweep (v reads v + e) up from the near end, so
      // the neighbour read is always the walk's next voxel, not yet updated
      const int dir = (k & 1) ? 1 : -1;
      const int dr = axis == 0 ? d1 : axis == 1 ? 1 : 0;
      const int dc = axis == 2 ? 1 : 0;
      for (int line = threadIdx.x; line < lines; line += NT) {
        // (row, column) of the line's voxel with the axis coordinate 0
        int r, col;
        if (axis == 0) {
          r = line / d2;
          col = line - r * d2;
        } else if (axis == 1) {
          const int i0 = line / d2;
          col = line - i0 * d2;
          r = i0 * d1;
        } else {
          r = line;
          col = 0;
        }
        if (dir < 0) {
          r += (L - 1) * dr;
          col += (L - 1) * dc;
        }
        int pv = at(r, col);
        int dv = dis[pv];
        for (int i = 0; i < L - 1; ++i) {
          r += dir * dr;
          col += dir * dc;
          const int pu = at(r, col);
          const int du = dis[pu];
          const int lu = lab[pu];
          if ((nb[pv] & bit) && lu != n && du + 1 < dv) {
            dis[pv] = static_cast<Dist>(du + 1);
            lab[pv] = lu;
            fell = 1;
          }
          pv = pu;
          dv = du;  // the neighbour's value before this sweep: its own next
        }
      }
      __syncthreads();
    }
    if (!__syncthreads_or(fell)) break;
    if (round >= max_rounds) {
      round = -1;
      break;
    }
  }
  if (kShared)
    for (int v = threadIdx.x; v < n; v += NT) {
      const int r = v / d2;
      labels[base + v] = lab[at(r, v - r * d2)];
    }
  if (threadIdx.x == 0) rounds[blockIdx.x] = round;
}

static bool bad_grid(int batch, int d0, int d1, int d2) {
  if (batch <= 0 || d0 <= 0 || d1 <= 0 || d2 <= 0) return true;
  const long long n = (long long)d0 * d1 * d2;
  return n > 0x7ffffff0LL;  // labels, n and n + 2 fit an int
}

extern "C" int extract_cc(const void* species, void* labels, void* bits, void* rounds,
                          int batch, int d0, int d1, int d2, void* stream) {
  if (bad_grid(batch, d0, d1, d2)) return (int)cudaErrorInvalidValue;
  const int n = d0 * d1 * d2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(species);
  int* lab = static_cast<int*>(labels);
  uint8_t* nb = static_cast<uint8_t*>(bits);
  int* r = static_cast<int*>(rounds);
  if (cc_in_smem(n)) {
    const int bytes = (int)cc_smem(n);
    cudaError_t err = cudaFuncSetAttribute(
        cc_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    cc_kernel<true><<<batch, NT, bytes, st>>>(sp, lab, nb, r, d0, d1, d2, n + 2);
  } else {
    cc_kernel<false><<<batch, NT, 0, st>>>(sp, lab, nb, r, d0, d1, d2, n + 2);
  }
  return (int)cudaGetLastError();
}

extern "C" int extract_bfs(const void* seeds, const void* cc, const void* fg,
                           const void* seed_labels, void* labels, void* dist, void* bits,
                           void* rounds, int batch, int d0, int d1, int d2, void* stream) {
  if (bad_grid(batch, d0, d1, d2)) return (int)cudaErrorInvalidValue;
  const int n = d0 * d1 * d2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* sd = static_cast<const uint8_t*>(seeds);
  const int* c = static_cast<const int*>(cc);
  const uint8_t* f = static_cast<const uint8_t*>(fg);
  const int* sl = static_cast<const int*>(seed_labels);
  int* lab = static_cast<int*>(labels);
  int* dis = static_cast<int*>(dist);
  uint8_t* nb = static_cast<uint8_t*>(bits);
  int* r = static_cast<int*>(rounds);
  if (bfs_in_smem(n)) {
    const int bytes = (int)bfs_smem(n);
    cudaError_t err = cudaFuncSetAttribute(
        bfs_kernel<uint16_t, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    bfs_kernel<uint16_t, true><<<batch, NT, bytes, st>>>(sd, c, f, sl, lab, dis, nb, r,
                                                         d0, d1, d2, n + 2);
  } else {
    bfs_kernel<int, false><<<batch, NT, 0, st>>>(sd, c, f, sl, lab, dis, nb, r,
                                                 d0, d1, d2, n + 2);
  }
  return (int)cudaGetLastError();
}
