// Free-space carve: octant wavefront sweeps of K scans and the free test.
//
// Replaces fiesta_tpu/ops/pallas/carve.py octant_free_sweep_pallas (:76);
// computes carve_free_mask_batch's free mask (raycast.py:526-598) directly
// in the canonical [K, BX, BY, BZ] layout.
//
// Geometry.  Each scan's box splits into octant cones by the dominant axis
// of the voxel's offset from the sensor (largest magnitude, ties x > y > z).
// For each orientation o (scan axis x, y or z) and direction (forward: the
// half-space d_o <= 0, walked from index 0 up; reverse: d_o > 0, walked
// from the top down) a wavefront carries the max observation range from
// the far end toward the sensor.  At each slab the carry moves through the
// (up to) four cells bracketing each cell's line of sight (taps with
// offsets floor(o2/d), floor(o3/d)), then takes the max with the seeds of
// the slab that lie in the wavefront's own octant and sign.  The free test
// runs on the new carry for the voxels in the wavefront's half-space, with
// the plain version's arithmetic: r2 = (dx*dx + dy*dy) + dz*dz, each op
// rounded (built with -fmad=false; __f*_rn spell it out).
//
// Design.  A wavefront's seeds and free test lie only in its own
// half-space, so it walks only that: the forward one while
// float(idx) - po <= 0, the reverse one while float(idx) - po > 0, decided
// by the free test's own f32 expression (f32 subtraction is monotonic, so
// each is a prefix or suffix of the axis).  Each orientation then visits
// each voxel exactly once, and the dependent steps are the longest
// wavefront's (about half the axis for a sensor mid-box).
//
// One cluster of CS thread blocks per wavefront (K * 3 orientations * 2
// directions = 18 at K = 3), all wavefronts in one launch: the carry plane
// (C2 x C3 cells) lives in shared memory, split by rows into one band per
// block, double-buffered.  Each step copies the neighbour blocks' edge
// rows of the previous carry into the band's halo rows (distributed
// shared memory, one read per cell of the two rows), so that every tap is
// a local shared-memory load; one cluster barrier separates slab steps.
// The tap offsets floor(o2/d) and floor(o3/d) depend on the row or the
// column alone, so each step's two divisions per row and column are
// tabled during the step before, and so are the next slab's seeds (into
// registers, their loads overlapping the barrier).  A launch ahead of the
// sweep zeroes the mask; the sweep stores only 1s (voxels free in several
// orientations get the same byte).  Two launches per call, no scratch in
// device memory.
//
// Bound: operations — each voxel is visited once per orientation (3
// visits), ~20 f32 ops each, against the f32 rate without FMA; the bytes
// (seeds f32 in, 45 MB at cow scale; the u8 mask out, 11 MB) come close.
// What holds it far above that is the chain of dependent steps (116 at
// cow scale), each a pass of 2-6 cells per thread with four dependent
// shared-memory taps, a halo copy and a cluster barrier; the 1024-thread
// blocks spill a few registers (ptxas -v).

#include <cooperative_groups.h>

#include <initializer_list>

#include "fiesta_kernels.cuh"

namespace cg = cooperative_groups;

struct CarveShape {
  int K, BX, BY, BZ;
  float res, inv_res, min2, max2;
};

namespace {

constexpr int kCarveThreads = 1024;
constexpr int kCarveCells = 8;  // cells per thread and step, at most

// scan axis length A and carry plane (C2 rows, C3 columns) of orientation
// o: x: (y, z); y: (x, z); z: (x, y)
__host__ __device__ inline void orient_dims(const CarveShape& g, int o,
                                            int& A, int& C2, int& C3) {
  A = o == 0 ? g.BX : (o == 1 ? g.BY : g.BZ);
  C2 = o == 0 ? g.BY : g.BX;
  C3 = o == 2 ? g.BY : g.BZ;
}

// Floats of dynamic shared memory a block needs with clusters of cs (two
// carry bands of R x C3 with a halo row on each side, and two tables of
// R + C3 tap offsets), and the most cells of a band.
size_t sweep_smem_floats(const CarveShape& g, int cs, size_t* cells) {
  size_t most = 0;
  *cells = 0;
  for (int o = 0; o < 3; ++o) {
    int A, C2, C3;
    orient_dims(g, o, A, C2, C3);
    const size_t R = (C2 + cs - 1) / cs;
    const size_t need = 2 * (R + 2) * C3 + 2 * (R + C3);
    most = need > most ? need : most;
    *cells = R * C3 > *cells ? R * C3 : *cells;
  }
  return most;
}

}  // namespace

__global__ void carve_zero(uint8_t* __restrict__ mask, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n16 = n / 16;
  for (long long i = tid; i < n16; i += stride)
    reinterpret_cast<uint4*>(mask)[i] = make_uint4(0, 0, 0, 0);
  for (long long i = n16 * 16 + tid; i < n; i += stride) mask[i] = 0;
}

// Whether a wavefront in direction dir walks slab idx: inside the axis
// and in its half-space, by the free test's own f32 expression.
__device__ __forceinline__ bool walks(int dir, int idx, int A, float pa) {
  if (idx < 0 || idx >= A) return false;
  const float dax = __fsub_rn((float)idx, pa);
  return dir == 0 ? dax <= 0.f : dax > 0.f;
}

// Tap offset floor(o / d) as an int, clamped to [-3, 2]: the taps only
// test it against -2 .. 1, and a clamped value fails the same tests.
__device__ __forceinline__ int tap_offset(float o, float d) {
  return (int)fminf(fmaxf(floorf(__fdiv_rn(o, d)), -3.f), 2.f);
}

// Voxel offset (within the scan), and the offsets from the sensor in x,
// y, z, of cell (i2, i3) of slab idx in orientation o.
struct CellGeom {
  int s2, s3, sa;  // voxel strides of the rows, columns and slabs
  float pa, pr, pc;  // the sensor along the slabs, rows and columns
  int o;
  __device__ __forceinline__ int voxel(int i2, int i3, int idx) const {
    return i2 * s2 + i3 * s3 + idx * sa;
  }
  __device__ __forceinline__ void offsets(int i2, int i3, float da,
                                          float& dx, float& dy,
                                          float& dz) const {
    const float dr = __fsub_rn((float)i2, pr);
    const float dc = __fsub_rn((float)i3, pc);
    dx = o == 0 ? da : dr;
    dy = o == 0 ? dr : (o == 1 ? da : dc);
    dz = o == 2 ? da : dc;
  }
  // whether the voxel lies in the orientation's octant cone (dominant
  // axis by magnitude, ties x > y > z)
  __device__ __forceinline__ bool in_octant(float dx, float dy,
                                            float dz) const {
    const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
    const bool octx = adx >= ady && adx >= adz;
    const bool octy = !octx && ady >= adz;
    return o == 0 ? octx : (o == 1 ? octy : (!octx && !octy));
  }
};

// This thread's seeds of slab idx (0 outside the octant), into registers:
// all loads issue before any is used.
__device__ __forceinline__ void fetch_seeds(float (&sv)[kCarveCells],
                                            const float* __restrict__ kseeds,
                                            const CellGeom& q,
                                            const int (&cell)[kCarveCells],
                                            int lo, int ncell, int idx) {
  const float da = __fsub_rn((float)idx, q.pa);
#pragma unroll
  for (int j = 0; j < kCarveCells; ++j) {
    const int i2 = lo + (cell[j] >> 16), i3 = cell[j] & 0xffff;
    float dx, dy, dz;
    q.offsets(i2, i3, da, dx, dy, dz);
    sv[j] = threadIdx.x + j * kCarveThreads < ncell && q.in_octant(dx, dy, dz)
                ? kseeds[q.voxel(i2, i3, idx)]
                : 0.f;
  }
}

// Grid (CS, K * 6), clusters of (CS, 1, 1): cluster y is the wavefront
// w = (k * 3 + o) * 2 + dir, block r of it holds carry rows [r R, r R + R)
// (at most kCarveThreads * kCarveCells cells, whose row and column each
// thread keeps in registers).  Outside the anonymous namespace, so that
// the profiler lists it by name.
__global__ void __launch_bounds__(kCarveThreads)
    carve_sweep(const float* __restrict__ seeds, const float* __restrict__ po,
                CarveShape g, uint8_t* __restrict__ free_mask) {
  extern __shared__ float carve_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int w = blockIdx.y;
  const int dir = w & 1, o = (w >> 1) % 3, k = w / 6;
  int A, C2, C3;
  orient_dims(g, o, A, C2, C3);
  const int R = (C2 + cs - 1) / cs;
  const int lo = rank * R;
  const int nrows = max(0, min(R, C2 - lo));
  const int ncell = nrows * C3;
  // [2][(R + 2) * C3] carry bands (rows 1 .. R this block's, rows 0 and
  // R + 1 the neighbours' edge rows), then [2][R] row and [2][C3] column
  // tap offsets
  const int bs = (R + 2) * C3;
  float* band = carve_smem;
  int* tab = reinterpret_cast<int*>(carve_smem + 2 * bs);
  const float* prev =
      rank > 0 ? cluster.map_shared_rank(carve_smem, rank - 1) : nullptr;
  const float* next = rank < cs - 1
                          ? cluster.map_shared_rank(carve_smem, rank + 1)
                          : nullptr;

  const float p0 = po[3 * k + 0], p1 = po[3 * k + 1], p2 = po[3 * k + 2];
  // voxel strides and sensor offsets of the slabs, rows and columns: x
  // (y, z); y (x, z); z (x, y)
  const int sx = g.BY * g.BZ, sy = g.BZ;
  const CellGeom q{o == 0 ? sy : sx, o == 2 ? sy : 1,
                   o == 0 ? sx : (o == 1 ? sy : 1),
                   o == 0 ? p0 : (o == 1 ? p1 : p2), o == 0 ? p1 : p0,
                   o == 2 ? p1 : p2, o};
  uint8_t* mask = free_mask + (size_t)k * g.BX * sx;
  const float* kseeds = seeds + (size_t)k * g.BX * sx;
  int cell[kCarveCells];  // l2 << 16 | i3 of this thread's cells
#pragma unroll
  for (int j = 0; j < kCarveCells; ++j) {
    const int c = threadIdx.x + j * kCarveThreads;
    cell[j] = (c / C3) << 16 | (c % C3);
  }
  // this step's seeds: fetched during the step before, so that their
  // loads overlap the cluster barrier
  float sv[kCarveCells];
  if (walks(dir, dir == 0 ? 0 : A - 1, A, q.pa))
    fetch_seeds(sv, kseeds, q, cell, lo, ncell, dir == 0 ? 0 : A - 1);

  for (int s = 0;; ++s) {
    const int idx = dir == 0 ? s : A - 1 - s;
    if (!walks(dir, idx, A, q.pa)) break;
    const float da = __fsub_rn((float)idx, q.pa);
    const int cur = s & 1, old = cur ^ 1;
    float* carry = band + cur * bs + C3;
    float* mine = band + old * bs;
    const int* rows_tab = tab + cur * (R + C3);
    const int* cols_tab = rows_tab + R;
    if (s > 0) {
      // the neighbours' edge rows of the previous carry into the halo
      // rows, one distributed shared memory read each
      for (int i = threadIdx.x; i < 2 * C3; i += blockDim.x) {
        if (i < C3 && prev)
          mine[i] = prev[old * bs + R * C3 + i];
        else if (i >= C3 && next)
          mine[(R + 1) * C3 + i - C3] = next[old * bs + i];
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < kCarveCells; ++j) {
      if (threadIdx.x + j * kCarveThreads >= ncell) break;
      const int l2 = cell[j] >> 16, i3 = cell[j] & 0xffff, i2 = lo + l2;
      // propagate: max over the taps bracketing the line of sight, the
      // rows d2 and columns d3 in {b, b + 1} within -1 .. 1
      float tap = 0.f;
      if (s > 0) {
        const int b2 = rows_tab[l2], b3 = cols_tab[i3];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int d2 = b2 + u, j2 = i2 + d2;
          if (d2 < -1 || d2 > 1 || j2 < 0 || j2 >= C2) continue;
          // row j2 of the previous carry, or a neighbour's edge row
          const float* row = mine + (l2 + 1 + d2) * C3;
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int d3 = b3 + v, j3 = i3 + d3;
            if (d3 < -1 || d3 > 1 || j3 < 0 || j3 >= C3) continue;
            tap = fmaxf(tap, row[j3]);
          }
        }
      }
      // every visited voxel lies in the wavefront's half-space; its seed
      // is in sv if it lies in the octant too
      const float W = fmaxf(sv[j], tap);
      carry[l2 * C3 + i3] = W;
      float dx, dy, dz;
      q.offsets(i2, i3, da, dx, dy, dz);
      const float r2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float wv = __fmul_rn(__fsub_rn(W, g.res), g.inv_res);
      if (W > g.res && r2 >= g.min2 && r2 <= g.max2 && r2 < __fmul_rn(wv, wv))
        mask[q.voxel(i2, i3, idx)] = 1;
    }

    const int nidx = dir == 0 ? s + 1 : A - 2 - s;
    if (walks(dir, nidx, A, q.pa))
      fetch_seeds(sv, kseeds, q, cell, lo, ncell, nidx);
    // the next step's tap offsets, into the other table
    const float d = fmaxf(fabsf(__fsub_rn((float)nidx, q.pa)), 0.5f);
    int* ntab = tab + old * (R + C3);
    for (int i = threadIdx.x; i < nrows + C3; i += blockDim.x) {
      if (i < nrows)
        ntab[i] = tap_offset(__fsub_rn((float)(lo + i), q.pr), d);
      else
        ntab[R + i - nrows] =
            tap_offset(__fsub_rn((float)(i - nrows), q.pc), d);
    }
    // this step's bands and the next step's tables are complete and
    // visible to the whole cluster; no block reads a band past the last
    // step's barrier, so every block may then exit
    cluster.sync();
  }
}

namespace {

constexpr int kShapeSlots = 4;

// Per device: whether the sweep may take clusters above 8 blocks and
// all the shared memory a block can have, and the cluster size chosen
// for the last few shapes (one query per device and shape).
struct DeviceState {
  bool ready;
  int next_slot;
  struct {
    int K, BX, BY, BZ, cs;
  } shapes[kShapeSlots];
};
DeviceState g_devices[kFiestaMaxDevices];
bool g_smem_ready[kFiestaMaxDevices];

// The sweep's launch with clusters of cs (`attr` holds the cluster
// dimension); `cells`: the most cells of a band.
cudaLaunchConfig_t sweep_config(const CarveShape& g, int cs,
                                cudaStream_t stream,
                                cudaLaunchAttribute* attr, size_t* cells) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 6 * g.K);
  cfg.blockDim = dim3(kCarveThreads);
  cfg.dynamicSmemBytes = sweep_smem_floats(g, cs, cells) * sizeof(float);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of the sweep the card holds at once with clusters of cs; 0 if
// a band has more cells than a block's threads take, or the size is
// refused.
int active_clusters(const CarveShape& g, int cs) {
  cudaLaunchAttribute attr;
  size_t cells;
  const cudaLaunchConfig_t cfg = sweep_config(g, cs, 0, &attr, &cells);
  int n = 0;
  if (cells > (size_t)kCarveThreads * kCarveCells) return 0;
  if (cudaOccupancyMaxActiveClusters(&n, carve_sweep, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a fault
    return 0;
  }
  return n;
}

// The cluster size of the sweep: the largest of 8, 4, 2, 1 whose clusters
// all fit on the card at once, else the size (up to 16, non-portable) that
// fits the most; 0 if no size fits a band in shared memory.
cudaError_t cluster_size(const CarveShape& g, int* cs) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  DeviceState* st =
      device < kFiestaMaxDevices ? &g_devices[device] : nullptr;
  if (!st || !st->ready) {
    err = fiesta_allow_max_smem(carve_sweep, g_smem_ready);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          carve_sweep, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (st) st->ready = true;
  }
  if (st)
    for (const auto& e : st->shapes)
      if (e.cs && e.K == g.K && e.BX == g.BX && e.BY == g.BY &&
          e.BZ == g.BZ) {
        *cs = e.cs;
        return cudaSuccess;
      }
  int best = 0, best_n = 0;
  for (int c : {8, 4, 2, 1}) {
    const int n = active_clusters(g, c);
    if (n >= 6 * g.K) {
      best = c;
      break;
    }
    if (n > best_n) best = c, best_n = n;
  }
  if (!best && active_clusters(g, 16) > 0) best = 16;
  *cs = best;
  if (st && best) {
    auto& e = st->shapes[st->next_slot];
    st->next_slot = (st->next_slot + 1) % kShapeSlots;
    e.K = g.K, e.BX = g.BX, e.BY = g.BY, e.BZ = g.BZ, e.cs = best;
  }
  return cudaSuccess;
}

}  // namespace

// The sweep's cluster size for K boxes of BX x BY x BZ on the current
// device (0: no size fits), or a negative CUDA error.
FIESTA_EXPORT int fiesta_carve_cluster_size(int K, int BX, int BY, int BZ) {
  const CarveShape g{K, BX, BY, BZ, 0.f, 0.f, 0.f, 0.f};
  int cs;
  const cudaError_t err = cluster_size(g, &cs);
  return err == cudaSuccess ? cs : -(int)err;
}

// free_mask: K*BX*BY*BZ u8, 16-byte aligned, written whole.
FIESTA_EXPORT int fiesta_carve(const float* seeds, const float* po, int K,
                               int BX, int BY, int BZ, float res,
                               float inv_res, float min2, float max2,
                               uint8_t* free_mask, cudaStream_t stream) {
  const CarveShape g{K, BX, BY, BZ, res, inv_res, min2, max2};
  int cs;
  cudaError_t err = cluster_size(g, &cs);
  if (err != cudaSuccess) return (int)err;
  if (!cs) return (int)cudaErrorInvalidConfiguration;
  const long long n = (long long)K * BX * BY * BZ;
  carve_zero<<<fiesta_blocks(n / 16 + 1, 256), 256, 0, stream>>>(free_mask,
                                                                 n);
  FIESTA_LAUNCH_CHECK();
  cudaLaunchAttribute attr;
  size_t cells;
  const cudaLaunchConfig_t cfg = sweep_config(g, cs, stream, &attr, &cells);
  err = cudaLaunchKernelEx(&cfg, carve_sweep, seeds, po, g, free_mask);
  if (err != cudaSuccess) return (int)err;
  FIESTA_LAUNCH_CHECK();
  return 0;
}
