// The device extraction's two loops, each run to convergence on the card,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the two lax.while_loops of icsg3d_tpu/ops/extract.py that the
// fused generation (apps/generate.py --fused) runs inside one XLA program:
//   E1  connected_components_same_value, its while_loop at extract.py:104
//   E2  nearest_seed_labels, its while_loop at extract.py:221
// The plain versions (ops/extract.py's *_reference) launch dozens of small
// kernels per round and read "has anything changed" on the host; here one
// launch runs the whole loop, and no flag ever reaches the host.
//
// What bounds them: rounds x the latency of one round, not bytes.  The
// bytes that must move are 8 (E1) or 10-14 (E2) per voxel, read or written
// once, a few microseconds for a batch; a round is a pass over the sample's
// state in which every voxel waits on its neighbours' values, closed by
// barriers.  So the design cuts the work and the barriers of a round, and
// the number of rounds where the answer allows it:
//
// - A thread-block cluster of C CTAs per sample (C = 1..16, the plan of
//   kernels/extract.py::plan).  The sample is cut along axis 0 into C slabs
//   of d0 / C planes, one per CTA, and each CTA keeps its slab's state in
//   its own shared memory; a 64^3 sample (2.4 MB of E2 state) fits 16
//   CTAs' 227 KB each.  A voxel across the cut is read from the
//   neighbouring CTA's shared memory (distributed shared memory,
//   cluster.map_shared_rank).  The cluster barrier (~0.7 us on the H100,
//   a CTA barrier ~0.05 us) is used only where a phase reads across a cut,
//   and not at all in a cluster of one.  A round's "has anything changed"
//   is an OR over the cluster: each CTA stores its own flag into every
//   peer's shared memory, and after one cluster barrier each reads its
//   own copies.  So a small batch (view, evaluate, one 64^3 sample)
//   spreads over many SMs, and a round costs a pass over a slab, not over
//   a sample.  Grids whose state does not fit 16 CTAs keep it in device
//   memory (the plan's "global" path): the same code with the arrays in
//   device memory and only the flags in shared memory.  At C = 1 the
//   kernels are the same code with a cluster of one.
//
// - E1 (cc_kernel): a lock-free union-find, in place of label propagation
//   whose passes grow with a component's diameter.  Labels: each
//   6-connected, same-valued, nonzero component gets its smallest flat
//   index i0*d1*d2 + i1*d2 + i2; background gets n.  Every parent link
//   points to a smaller index (parent[v] <= v), so a root is the least
//   index of its tree, and once a component is one tree its root is the
//   component's least index: the labels are bitwise the plain version's.
//   init:     each warp's 32 consecutive voxels link to the start of their
//             run along axis 2 (a ballot), the warp's first voxel to v - 1;
//   merge:    union over the axis-1 face edges, every entry stored to
//             its root, then union over the axis-0 edges: the larger root
//             linked under the smaller by atomicMin (a failed link retries
//             from the value it found), finds halving their path; an edge
//             whose twin at v - 1 exists joins nothing new and is skipped,
//             so a solid run unites once per axis;
//   compress: passes of pointer jumping, each voxel writing only its own
//             entry, until every parent is a root;
//   check:    every face edge's two labels equal, or another merge pass
//             (over every edge) runs.  `rounds` counts merge passes: 1
//             unless the check found a link that a race lost.
//
// - E2 (bfs_kernel): the plain version's schedule, exactly, since its ties
//   are not unique (the strict cand < dist keeps the first arrival): six
//   sweeps per round in the order (axis 0, +1), (axis 0, -1), (axis 1, +1),
//   (axis 1, -1), (axis 2, +1), (axis 2, -1); each sweep reads what the
//   previous one left, and within a sweep every voxel reads its neighbour's
//   value from before the sweep (Jacobi); a round ends when no distance
//   fell.  A sweep is a pure map of the pre-sweep state, so in place of a
//   line walk (L dependent steps, each waiting on the last store) each
//   thread takes G groups of V = 4 consecutive voxels of a chunk of
//   NT * G * V slots: it reads their bits (one word), their distances and
//   their neighbours' (one vector load each where the shift is a multiple
//   of 4; along axis 2 three neighbours are the group's own) for all its
//   groups, decides, __syncthreads, writes the updates.  Chunks run in the
//   order against the sweep's shift, so a later chunk never reads a voxel
//   an earlier one wrote.  A warp's lanes hold consecutive groups: no bank
//   conflicts, no swizzle.  Across the cuts a round begins by copying both
//   neighbouring planes into halos, so that a round takes two cluster
//   barriers (see bfs_kernel).  The predicate fg[v] & ~edge & (cc[u] ==
//   cc[v]) & (label[u] != n) is built once as six bits per voxel, less the
//   label test.  Each sample runs the plain version's rounds, and the
//   largest per-sample count is its count over the batch.
//
// Both loops stop after n + 2 rounds at most (neither can need more); the
// sample's round count is then written as -1, which the callers that read
// it treat as a failure.  No round is ever read by the host.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (icsg3d_torch/kernels/extract.py does this).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int NT = 1024;        // threads per CTA
constexpr int V = 4;            // E2: a thread's group of consecutive voxels
constexpr int G = 2;            // E2: groups a thread holds between a chunk's reads and writes
constexpr int MAX_CLUSTER = 16;
constexpr int FLAG_BYTES = 2 * MAX_CLUSTER * 4;  // every CTA's "anything changed", by parity

static __host__ __device__ __forceinline__ size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// The shared memory one CTA's slab of slab_n voxels needs (the twin of
// kernels/extract.py::smem_bytes; a plan that gives less is refused):
//   E1: flags | parent int32[slab_n] | bits uint8[slab_n]
//   E2: flags | labels int32[slab_n] | dist Dist[slab_n] | bits uint8[slab_n]
//       | lower halo labels int32[plane], dist Dist[plane] | upper halo the
//       same  (halos if C > 1)
// On the device-memory path only the flags are.
static size_t cc_smem(size_t slab_n, bool shared) {
  return FLAG_BYTES + (shared ? align16(4 * slab_n) + align16(slab_n) : 0);
}
static size_t bfs_smem(size_t slab_n, size_t plane, int cluster, int dist_bytes, bool shared) {
  size_t b = FLAG_BYTES;
  if (!shared) return b;
  b += align16(4 * slab_n) + align16(dist_bytes * slab_n) + align16(slab_n);
  if (cluster > 1) b += 2 * (align16(4 * plane) + align16(dist_bytes * plane));
  return b;
}

// A barrier over the cluster; over the CTA alone when the cluster is one
// CTA (a cluster barrier costs ~0.7 us on the H100 even then, a CTA
// barrier ~0.05 us).
__device__ __forceinline__ void cluster_sync(cg::cluster_group& cl, int C) {
  if (C > 1) cl.sync();
  else __syncthreads();
}

// OR of x over every thread of the cluster, returned to all of them.  Each
// CTA's OR is stored into every peer's flags[parity][rank] before the
// cluster barrier, so that after it the flags are read locally.  The
// parity alternates, so a CTA's next store cannot overtake a peer's read
// of this one (a second barrier lies between).
__device__ __forceinline__ int cluster_any(cg::cluster_group& cl, int* flags, int& parity,
                                           int C, int rank, int x) {
  const int mine = __syncthreads_or(x);
  if (C == 1) return mine;
  int* slot = flags + parity * MAX_CLUSTER;
  if ((int)threadIdx.x < C) *cl.map_shared_rank(slot + rank, threadIdx.x) = mine;
  cl.sync();
  int any = 0;
  for (int r = 0; r < C; ++r) any |= static_cast<volatile int*>(slot)[r];
  parity ^= 1;
  return any;
}

// E1: a cluster of C CTAs per sample (blockIdx.x / C), CTA r owning the
// flat indices [r * slab_n, (r + 1) * slab_n).  species (N, d0, d1, d2)
// int32; labels the same shape; bits a byte per voxel of workspace (device-
// memory path only); rounds (N,).  kShared: the parents and bits live in
// the CTAs' shared memory, the labels copied out at the end; else in
// `labels` and `bits`.
template <bool kShared>
__global__ void __launch_bounds__(NT, 1)
cc_kernel(const int* __restrict__ species, int* labels, uint8_t* bits,
          int* __restrict__ rounds, int d0, int d1, int d2, int C, int max_rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const int n = d0 * d1 * d2;
  const int s0 = d1 * d2;
  const int slab_n = n / C;
  const int first = rank * slab_n;
  const size_t base = (size_t)(blockIdx.x / C) * (size_t)n;
  const int* sp = species + base;
  int* flags = reinterpret_cast<int*>(smem);
  volatile int* par = kShared ? reinterpret_cast<int*>(smem + FLAG_BYTES)
                              : labels + base + first;
  uint8_t* nb = kShared ? smem + FLAG_BYTES + align16(4 * (size_t)slab_n)
                        : bits + base + first;
  const float inv_slab = 1.0f / (float)slab_n;

  // the parent entry of voxel v (a flat index of the sample), wherever it lives
  auto pp = [&](int v) -> volatile int* {
    if (!kShared || C == 1) return par + (v - first);
    int r = __float2int_rz((float)v * inv_slab);
    if (r * slab_n > v) --r;
    else if ((r + 1) * slab_n <= v) ++r;
    volatile int* p = par + (v - r * slab_n);
    if (r == rank) return p;
    return cl.map_shared_rank(const_cast<int*>(p), r);
  };
  auto find = [&](int x) -> int {
    for (;;) {
      volatile int* px = pp(x);
      const int p = *px;
      if (p == x) return x;
      const int g = *pp(p);
      if (g == p) return p;
      *px = g;  // path halving: x skips to its grandparent, an ancestor
      x = g;
    }
  };
  auto unite = [&](int a, int b) {
    for (;;) {
      a = find(a);
      b = find(b);
      if (a == b) return;
      if (a < b) {
        const int t = a;
        a = b;
        b = t;
      }
      // link the larger root under the smaller; if a was linked meanwhile,
      // what it pointed to (old) must still meet b
      const int old = atomicMin(const_cast<int*>(pp(a)), b);
      if (old == a) return;
      a = old;
    }
  };

  // init: same-valued, nonzero face neighbours inside the grid as six bits
  // (-i0, +i0, -i1, +i1, -i2, +i2), and each voxel's first parent: the
  // start of its run along axis 2 within its warp's 32 consecutive voxels,
  // or, where the run begins before the warp's first voxel, that voxel's
  // predecessor (same row, same slab).
  for (int b0 = 0; b0 < slab_n; b0 += NT) {
    const int vl = b0 + tid;
    const bool in = vl < slab_n;
    const int v = first + vl;
    int s = 0;
    unsigned m = 0;
    if (in) {
      s = sp[v];
      const int i0 = v / s0, r = v - i0 * s0, i1 = r / d2, i2 = r - i1 * d2;
      if (s > 0) {
        if (i0 > 0 && sp[v - s0] == s) m |= 1;
        if (i0 < d0 - 1 && sp[v + s0] == s) m |= 2;
        if (i1 > 0 && sp[v - d2] == s) m |= 4;
        if (i1 < d1 - 1 && sp[v + d2] == s) m |= 8;
        if (i2 > 0 && sp[v - 1] == s) m |= 16;
        if (i2 < d2 - 1 && sp[v + 1] == s) m |= 32;
      }
    }
    const unsigned run = __ballot_sync(0xffffffffu, (m & 16) != 0);
    if (in) {
      const int lane = tid & 31;
      int p;
      if (s <= 0) {
        p = n;  // background
      } else if (!(m & 16)) {
        p = v;
      } else {
        const unsigned starts = ~run & ((2u << lane) - 1u);
        p = starts ? v - lane + (31 - __clz(starts)) : v - lane - 1;
      }
      par[vl] = p;
      nb[vl] = (uint8_t)m;
    }
  }
  cluster_sync(cl, C);

  int round = 0, parity = 0;
  for (;;) {
    ++round;
    if (round == 1) {
      // merge, first within each plane: v - 1 shares v's root after init
      // wherever bit 16 is set, so an edge whose twin at v - 1 exists is
      // implied by that twin's (and by the run of v's neighbour across it)
      for (int vl = tid; vl < slab_n; vl += NT) {
        const unsigned m = nb[vl];
        if ((m & 4) && !((m & 16) && (nb[vl - 1] & 4))) unite(first + vl, first + vl - d2);
      }
      __syncthreads();
      // then every entry to its root (a compression store, as a find's),
      // so that the unions across planes start from flat planes: without
      // it, unions running at once link the run roots into chains as long
      // as the component is wide, which every later find walks
      for (int vl = tid; vl < slab_n; vl += NT) {
        const int p = par[vl];
        if (p == n || p == first + vl) continue;
        const int r = find(p);
        if (r != p) par[vl] = r;
      }
      __syncthreads();
      for (int vl = tid; vl < slab_n; vl += NT) {
        const unsigned m = nb[vl];
        if ((m & 1) && !((m & 16) && (nb[vl - 1] & 1))) unite(first + vl, first + vl - s0);
      }
    } else {  // a link was lost: every edge again
      for (int vl = tid; vl < slab_n; vl += NT) {
        const unsigned m = nb[vl];
        const int v = first + vl;
        if (m & 16) unite(v, v - 1);
        if (m & 4) unite(v, v - d2);
        if (m & 1) unite(v, v - s0);
      }
    }
    cluster_sync(cl, C);
    // compress: passes of pointer jumping (up to four hops each); a voxel
    // writes only its own entry, so a root once written stays
    for (;;) {
      int moved = 0;
      for (int vl = tid; vl < slab_n; vl += NT) {
        const int p = par[vl];
        if (p == n) continue;
        int q = *pp(p);
        if (q == p) continue;
        for (int h = 0; h < 3; ++h) {
          const int g = *pp(q);
          if (g == q) break;
          q = g;
        }
        par[vl] = q;
        moved = 1;
      }
      if (!cluster_any(cl, flags, parity, C, rank, moved)) break;
    }
    // check: every backward face edge joins equal labels
    int bad = 0;
    for (int vl = tid; vl < slab_n; vl += NT) {
      const unsigned m = nb[vl];
      if (!(m & 21u)) continue;
      const int l = par[vl];
      if ((m & 16) && par[vl - 1] != l) bad = 1;
      if ((m & 4) && par[vl - d2] != l) bad = 1;
      if ((m & 1) && *pp(first + vl - s0) != l) bad = 1;
    }
    if (!cluster_any(cl, flags, parity, C, rank, bad)) break;
    if (round >= max_rounds) {
      round = -1;
      break;
    }
  }
  if (kShared)
    for (int vl = tid; vl < slab_n; vl += NT) labels[base + first + vl] = par[vl];
  if (rank == 0 && tid == 0) rounds[blockIdx.x / C] = round;
  cluster_sync(cl, C);  // no CTA leaves while a peer may still read its shared memory
}

// E2: a cluster of C CTAs per sample, slabs as E1's.  seeds, fg (N, d0,
// d1, d2) bytes (0/1); cc, seed_labels (nullable: each voxel's flat index),
// labels int32; rounds (N,).  kShared: the labels, distances (Dist =
// uint16_t when n <= 65535, else int) and bits live in shared memory with
// the halos, the labels copied out at the end.  Else Dist = int, the
// labels live in `labels`, the distances in work[0, N n), the bits in
// `bits`, and CTA b's halos in the 4 plane-sized int runs from
// work[N n + 4 b plane].
//
// Across the cuts (C > 1) a round begins, after the cluster barrier that
// ended the last, by copying the two planes across this slab's cuts into
// halos: the lower neighbour's last plane, which sweep 0 reads, and the
// upper neighbour's first, which sweep 1 reads.  The upper one is as it
// was before sweep 0, yet sweep 1 decides as it would on the plane sweep
// 0 left: sweep 0 lowers an upper voxel w only to d(u) + 1 from this
// slab's voxel u below it, which cannot then lower u; and it lowers w
// only if d(w) > d(u) + 1, so w's old value cannot lower u either.  One
// more cluster barrier, and the six sweeps run on this CTA alone.
template <typename Dist, bool kShared>
__global__ void __launch_bounds__(NT, 1)
bfs_kernel(const uint8_t* __restrict__ seeds, const int* __restrict__ cc,
           const uint8_t* __restrict__ fg, const int* __restrict__ seed_labels,
           int* labels, int* work, uint8_t* bits, int* __restrict__ rounds,
           int batch, int d0, int d1, int d2, int C, int max_rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const int n = d0 * d1 * d2;
  const int s0 = d1 * d2;
  const int slab_n = n / C;
  const int first = rank * slab_n;
  const size_t base = (size_t)(blockIdx.x / C) * (size_t)n;
  const int* c = cc + base;
  int* flags = reinterpret_cast<int*>(smem);
  int *lab, *lo_lab, *hi_lab;
  Dist *dis, *lo_dis, *hi_dis;
  uint8_t* nb;
  if constexpr (kShared) {
    unsigned char* p = smem + FLAG_BYTES;
    lab = reinterpret_cast<int*>(p);
    p += align16(4 * (size_t)slab_n);
    dis = reinterpret_cast<Dist*>(p);
    p += align16(sizeof(Dist) * (size_t)slab_n);
    nb = p;
    p += align16((size_t)slab_n);
    lo_lab = reinterpret_cast<int*>(p);
    p += align16(4 * (size_t)s0);
    lo_dis = reinterpret_cast<Dist*>(p);
    p += align16(sizeof(Dist) * (size_t)s0);
    hi_lab = reinterpret_cast<int*>(p);
    p += align16(4 * (size_t)s0);
    hi_dis = reinterpret_cast<Dist*>(p);
  } else {
    lab = labels + base + first;
    dis = reinterpret_cast<Dist*>(work + base + first);
    nb = bits + base + first;
    int* h = work + (size_t)batch * n + (size_t)blockIdx.x * 4 * s0;
    lo_lab = h;
    lo_dis = reinterpret_cast<Dist*>(h + s0);
    hi_lab = h + 2 * s0;
    hi_dis = reinterpret_cast<Dist*>(h + 3 * s0);
  }
  // the same array of CTA r's slab
  auto peer = [&](auto* p, int r) {
    if constexpr (kShared) return cl.map_shared_rank(p, r);
    else return p + (ptrdiff_t)(r - rank) * slab_n;
  };

  // bit k: v may receive in sweep k (fg[v], the neighbour inside the grid
  // and of v's cc region); the initial labels and distances
  for (int vl = tid; vl < slab_n; vl += NT) {
    const int v = first + vl;
    const int i0 = v / s0, r = v - i0 * s0, i1 = r / d2, i2 = r - i1 * d2;
    const bool f = fg[base + v] != 0;
    const int cv = c[v];
    unsigned m = 0;
    if (f) {
      if (i0 > 0 && c[v - s0] == cv) m |= 1;       // (axis 0, +1): u = v - e0
      if (i0 < d0 - 1 && c[v + s0] == cv) m |= 2;  // (axis 0, -1): u = v + e0
      if (i1 > 0 && c[v - d2] == cv) m |= 4;
      if (i1 < d1 - 1 && c[v + d2] == cv) m |= 8;
      if (i2 > 0 && c[v - 1] == cv) m |= 16;
      if (i2 < d2 - 1 && c[v + 1] == cv) m |= 32;
    }
    nb[vl] = (uint8_t)m;
    const bool s = f && seeds[base + v] != 0;
    lab[vl] = s ? (seed_labels ? seed_labels[base + v] : v) : n;
    dis[vl] = static_cast<Dist>(s ? 0 : n);
  }
  cluster_sync(cl, C);

  // a voxel's distance and label, wherever slot ul lies: below the slab
  // (the lower halo), above it (the upper halo) or in it
  auto dist_at = [&](int ul) -> int {
    return ul < 0 ? (int)lo_dis[ul + s0] : ul >= slab_n ? (int)hi_dis[ul - slab_n] : (int)dis[ul];
  };
  auto lab_at = [&](int ul) -> int {
    return ul < 0 ? lo_lab[ul + s0] : ul >= slab_n ? hi_lab[ul - slab_n] : lab[ul];
  };
  // four distances from slot p on: one vector load in shared memory (p a
  // multiple of 4, the arrays 16-byte aligned), else four loads
  auto dist4 = [&](const Dist* p, bool vector, int (&o)[V]) {
    if constexpr (kShared && sizeof(Dist) == 2) {
      if (vector) {
        const uint2 w = *reinterpret_cast<const uint2*>(p);
        o[0] = w.x & 0xffff, o[1] = w.x >> 16, o[2] = w.y & 0xffff, o[3] = w.y >> 16;
        return;
      }
    } else if constexpr (kShared) {
      if (vector) {
        const int4 w = *reinterpret_cast<const int4*>(p);
        o[0] = w.x, o[1] = w.y, o[2] = w.z, o[3] = w.w;
        return;
      }
    }
#pragma unroll
    for (int x = 0; x < V; ++x) o[x] = (int)p[x];
  };

  const int chunk = NT * G * V;
  const int chunks = (slab_n + chunk - 1) / chunk;
  int round = 0, parity = 0;
  for (;;) {
    ++round;
    int fell = 0;
    if (C > 1) {
      for (int i = tid; i < s0; i += NT) {
        if (rank > 0) {
          const volatile int* pl = peer(lab, rank - 1);
          const volatile Dist* pd = peer(dis, rank - 1);
          lo_lab[i] = pl[slab_n - s0 + i];
          lo_dis[i] = pd[slab_n - s0 + i];
        }
        if (rank < C - 1) {
          const volatile int* pl = peer(lab, rank + 1);
          const volatile Dist* pd = peer(dis, rank + 1);
          hi_lab[i] = pl[i];
          hi_dis[i] = pd[i];
        }
      }
      cluster_sync(cl, C);  // every boundary plane copied before any changes
    }
    for (int k = 0; k < 6; ++k) {
      const int axis = k >> 1;
      const bool fwd = (k & 1) == 0;  // a +1 sweep: v reads u = v - e
      const int e = axis == 0 ? s0 : axis == 1 ? d2 : 1;
      const int off = fwd ? -e : e;
      // the four neighbours of a group are a group too (one vector load)
      // when the shift is a multiple of 4; along axis 2 three of them are
      // the group's own voxels
      const bool vec = kShared && off % V == 0;
      // chunks against the shift: a +1 sweep reads lower indices, so it
      // runs the chunks from the top down, and a -1 sweep from the bottom up
      for (int ci = 0; ci < chunks; ++ci) {
        const int c0 = (fwd ? chunks - 1 - ci : ci) * chunk;
        // all of a chunk's loads are issued before any of its compares
        unsigned want[G];  // bit 8 x: voxel x of group j may receive in this sweep
        int own[G][V], du[G][V], nl[G][V];
        unsigned upd = 0;  // bit j * V + x: du[j][x] + 1 and nl[j][x] are its new state
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int vl = c0 + (j * NT + tid) * V;  // the thread's group of 4 slots
          unsigned w = 0;
          if (vl < slab_n) {
            if constexpr (kShared) {
              w = *reinterpret_cast<const uint32_t*>(nb + vl);
            } else {
#pragma unroll
              for (int x = 0; x < V; ++x)
                w |= (unsigned)(vl + x < slab_n ? nb[vl + x] : 0) << (8 * x);
            }
            if (slab_n - vl < V) w &= (1u << (8 * (slab_n - vl))) - 1u;
          }
          want[j] = (w >> k) & 0x01010101u;
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (!want[j]) continue;
          const int vl = c0 + (j * NT + tid) * V;
          dist4(dis + vl, kShared, own[j]);
          if (vec) {
            const int ul = vl + off;
            dist4(ul < 0 ? lo_dis + ul + s0 : ul >= slab_n ? hi_dis + (ul - slab_n) : dis + ul,
                  true, du[j]);
          } else if (off == -1) {
            du[j][0] = vl > 0 ? (int)dis[vl - 1] : n;
            du[j][1] = own[j][0], du[j][2] = own[j][1], du[j][3] = own[j][2];
          } else if (off == 1) {
            du[j][0] = own[j][1], du[j][1] = own[j][2], du[j][2] = own[j][3];
            du[j][3] = vl + V < slab_n ? (int)dis[vl + V] : n;
          } else {
#pragma unroll
            for (int x = 0; x < V; ++x)
              du[j][x] = (want[j] >> (8 * x)) & 1u ? dist_at(vl + x + off) : n;
          }
        }
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
          for (int x = 0; x < V; ++x)
            if (((want[j] >> (8 * x)) & 1u) && du[j][x] + 1 < own[j][x]) {
              const int lu = lab_at(c0 + (j * NT + tid) * V + x + off);
              if (lu != n) {
                nl[j][x] = lu;
                upd |= 1u << (j * V + x);
              }
            }
        __syncthreads();
        if (upd) {
#pragma unroll
          for (int j = 0; j < G; ++j)
#pragma unroll
            for (int x = 0; x < V; ++x)
              if ((upd >> (j * V + x)) & 1u) {
                const int vl = c0 + (j * NT + tid) * V + x;
                dis[vl] = static_cast<Dist>(du[j][x] + 1);
                lab[vl] = nl[j][x];
              }
          fell = 1;
        }
      }
      __syncthreads();
    }
    if (!cluster_any(cl, flags, parity, C, rank, fell)) break;
    if (round >= max_rounds) {
      round = -1;
      break;
    }
  }
  if (kShared)
    for (int vl = tid; vl < slab_n; vl += NT) labels[base + first + vl] = lab[vl];
  if (rank == 0 && tid == 0) rounds[blockIdx.x / C] = round;
  cluster_sync(cl, C);  // no CTA leaves while a peer may still read its shared memory
}

// ---------------------------------------------------------------- host

static bool bad_plan(int batch, int d0, int d1, int d2, int cluster) {
  if (batch <= 0 || d0 <= 0 || d1 <= 0 || d2 <= 0) return true;
  const long long n = (long long)d0 * d1 * d2;
  if (n > 0x7ffffff0LL) return true;  // labels, n and n + 2 fit an int
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 && cluster != 16)
    return true;
  return d0 % cluster != 0 || (long long)batch * cluster > 0x7fffffffLL;
}

template <typename K>
static cudaError_t prepare(K* kernel, int cluster, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(int blocks, int cluster, int smem, cudaStream_t st) : cfg{} {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename K>
static int active_clusters(K* kernel, int cluster, int smem, int* out) {
  cudaError_t err = prepare(kernel, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  Launch l(cluster, cluster, smem, 0);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &l.cfg);
}

// How many clusters of `cluster` CTAs with `smem` bytes of shared memory
// each the card runs at once, for kernel `kind` (0 E1, 1 E2) on the path
// `shared` (1) or device memory (0) with E2's distances of `dist_bytes`.
extern "C" int extract_max_active_clusters(int kind, int cluster, int shared, int smem,
                                           int dist_bytes, int* out) {
  if (kind == 0)
    return shared ? active_clusters(cc_kernel<true>, cluster, smem, out)
                  : active_clusters(cc_kernel<false>, cluster, smem, out);
  if (!shared) return active_clusters(bfs_kernel<int, false>, cluster, smem, out);
  return dist_bytes == 2 ? active_clusters(bfs_kernel<uint16_t, true>, cluster, smem, out)
                         : active_clusters(bfs_kernel<int, true>, cluster, smem, out);
}

// E1 on the plan (cluster, shared, smem) of kernels/extract.py::plan;
// refuses (cudaErrorInvalidValue) a plan it cannot run.
extern "C" int extract_cc(const void* species, void* labels, void* bits, void* rounds,
                          int batch, int d0, int d1, int d2, int cluster, int shared,
                          int smem, void* stream) {
  if (bad_plan(batch, d0, d1, d2, cluster)) return (int)cudaErrorInvalidValue;
  const int n = d0 * d1 * d2;
  const size_t need = cc_smem((size_t)(n / cluster), shared);
  if ((size_t)smem < need || (!shared && bits == nullptr)) return (int)cudaErrorInvalidValue;
  Launch l(batch * cluster, cluster, smem, static_cast<cudaStream_t>(stream));
  auto* k = shared ? cc_kernel<true> : cc_kernel<false>;
  cudaError_t err = prepare(k, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&l.cfg, k, static_cast<const int*>(species),
                           static_cast<int*>(labels), static_cast<uint8_t*>(bits),
                           static_cast<int*>(rounds), d0, d1, d2, cluster, n + 2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// E2 on the plan (cluster, shared, smem, dist_bytes); `dist` is the
// device-memory path's workspace (N n + 4 N cluster plane int32), unused
// on the shared path.
extern "C" int extract_bfs(const void* seeds, const void* cc, const void* fg,
                           const void* seed_labels, void* labels, void* dist, void* bits,
                           void* rounds, int batch, int d0, int d1, int d2, int cluster,
                           int shared, int smem, int dist_bytes, void* stream) {
  if (bad_plan(batch, d0, d1, d2, cluster)) return (int)cudaErrorInvalidValue;
  const int n = d0 * d1 * d2;
  if (dist_bytes != 2 && dist_bytes != 4) return (int)cudaErrorInvalidValue;
  if ((dist_bytes == 2 && (!shared || n > 65535)) || (!shared && (!dist || !bits)))
    return (int)cudaErrorInvalidValue;
  const size_t need =
      bfs_smem((size_t)(n / cluster), (size_t)d1 * d2, cluster, dist_bytes, shared);
  if ((size_t)smem < need) return (int)cudaErrorInvalidValue;
  Launch l(batch * cluster, cluster, smem, static_cast<cudaStream_t>(stream));
  auto* k = !shared ? bfs_kernel<int, false>
                    : dist_bytes == 2 ? bfs_kernel<uint16_t, true> : bfs_kernel<int, true>;
  cudaError_t err = prepare(k, cluster, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&l.cfg, k, static_cast<const uint8_t*>(seeds),
                           static_cast<const int*>(cc), static_cast<const uint8_t*>(fg),
                           static_cast<const int*>(seed_labels), static_cast<int*>(labels),
                           static_cast<int*>(dist), static_cast<uint8_t*>(bits),
                           static_cast<int*>(rounds), batch, d0, d1, d2, cluster, n + 2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
