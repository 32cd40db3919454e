// In-place saturating add of K carve boxes into the u8 hit/miss counters.
//
// Replaces fiesta_tpu/ops/pallas/boxadd.py box_add_inplace (:101):
// cnt[s_k : s_k + box] (+)= box_k, saturating at 255, for each scan k in
// order.  The K boxes of a tick overlap in the grid, so each grid row along
// z has ONE owner: the lowest k whose box covers the row's (x, y).  Boxes
// are axis-aligned, so that choice holds for every byte of the row, and the
// owner adds every covering box's bytes in scan order with __vaddus4, a
// per-byte min(a + b, 255): the sequential saturating adds of the contract.
//
// A warp takes a unit of 8 box rows along y of one (k, x) slab (the unit's
// rows are consecutive in the box and, when the boxes span the whole z
// extent, in the grid too).  The warp decides once, from the starts in
// shared memory, whether every box holds either all of the unit's rows or
// none of them.  If so, the unit is skipped as a whole when a lower k holds
// it; otherwise, when every covering box spans the grid's z extent and the
// unit starts 16-byte aligned in the grid and in each covering box, its
// bytes move as 16-byte words (the cow and demo ticks: y starts and box
// extents are multiples of 8).  Any other unit (an unaligned placement, a
// z start other than 0, a box edge inside the unit) walks its rows one by
// one, deciding each row's owner, and adds bytes.  The starts never leave
// the device; voxels outside the grid are skipped.  No division per
// element: the warp's (k, x, unit) come from its index, once.
//
// Bound: bytes.  The boxes' hit and miss bytes read once (2 per box voxel
// and scan) and each grid voxel of the boxes' union read and written once
// in each counter (4 per union voxel): ~37 MB for the cow tick's 3 boxes of
// 216x216x80, which nearly coincide (chip_smoke.py counts the union).

#include "fiesta_kernels.cuh"

namespace {

constexpr int kUnitRows = 8;        // box rows along y a warp takes at once
constexpr int kBoxaddThreads = 256;

__device__ __forceinline__ uint4 sat_add(uint4 a, uint4 b) {
  return make_uint4(__vaddus4(a.x, b.x), __vaddus4(a.y, b.y),
                    __vaddus4(a.z, b.z), __vaddus4(a.w, b.w));
}

}  // namespace

__global__ void __launch_bounds__(kBoxaddThreads)
    boxadd_kernel(uint8_t* __restrict__ hit, uint8_t* __restrict__ miss,
                  const int* __restrict__ starts,
                  const uint8_t* __restrict__ box_hit,
                  const uint8_t* __restrict__ box_miss, int k, int bx,
                  int by, int bz, int gx, int gy, int gz, int units) {
  extern __shared__ int st[];  // [k][3] box corners
  for (int i = threadIdx.x; i < 3 * k; i += blockDim.x) st[i] = starts[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp >= k * bx * units) return;
  const int slab = warp / units, kk = slab / bx;
  const int X = st[3 * kk] + slab % bx;
  const int y0 = warp % units * kUnitRows, rows = min(kUnitRows, by - y0);
  const int Y0 = st[3 * kk + 1] + y0;
  if (X < 0 || X >= gx) return;
  auto holds_x = [&](int j) {
    return X >= st[3 * j] && X < st[3 * j] + bx;
  };
  auto row_base = [&](int j, int Y) {  // box j's byte at grid z = 0
    return (((long long)j * bx + X - st[3 * j]) * by + Y - st[3 * j + 1]) *
               bz - st[3 * j + 2];
  };

  // the unit's cover, decided once: every box holds all rows or none
  bool uniform = true, lower = false, vec = Y0 >= 0 && Y0 + rows <= gy &&
      bz == gz && rows * gz % 16 == 0 &&
      (((uintptr_t)hit | (uintptr_t)miss | (uintptr_t)box_hit |
        (uintptr_t)box_miss) & 15) == 0;
  const long long gbase = ((long long)X * gy + Y0) * gz;
  vec = vec && gbase % 16 == 0;
  for (int j = 0; j < k; ++j) {
    if (!holds_x(j)) continue;
    const int sy = st[3 * j + 1];
    const int lo = max(Y0, sy), hi = min(Y0 + rows, sy + by);
    if (lo >= hi) continue;
    uniform = uniform && lo == Y0 && hi == Y0 + rows;
    lower = lower || j < kk;
    vec = vec && st[3 * j + 2] == 0 && row_base(j, Y0) % 16 == 0;
  }
  if (uniform && lower) return;  // a lower k owns every row of the unit

  if (uniform && vec) {
    const int words = rows * gz / 16;
    for (int w = lane; w < words; w += 32) {
      uint4* gh = (uint4*)(hit + gbase) + w;
      uint4* gm = (uint4*)(miss + gbase) + w;
      uint4 h = *gh, m = *gm;
      for (int j = kk; j < k; ++j) {
        const int sy = st[3 * j + 1];
        if (!holds_x(j) || Y0 < sy || Y0 >= sy + by) continue;
        const long long b = row_base(j, Y0);
        h = sat_add(h, ((const uint4*)(box_hit + b))[w]);
        m = sat_add(m, ((const uint4*)(box_miss + b))[w]);
      }
      *gh = h;
      *gm = m;
    }
    return;
  }

  // row by row: each row's owner, then its bytes
  for (int r = 0; r < rows; ++r) {
    const int Y = Y0 + r;
    if (Y < 0 || Y >= gy) continue;
    auto holds = [&](int j) {
      return holds_x(j) && Y >= st[3 * j + 1] && Y < st[3 * j + 1] + by;
    };
    bool owned = true;
    for (int j = 0; j < kk && owned; ++j) owned = !holds(j);
    if (!owned) continue;
    int zlo = gz, zhi = 0;  // the covering boxes' z span inside the grid
    for (int j = kk; j < k; ++j)
      if (holds(j)) {
        zlo = min(zlo, max(st[3 * j + 2], 0));
        zhi = max(zhi, min(st[3 * j + 2] + bz, gz));
      }
    const long long g0 = ((long long)X * gy + Y) * gz;
    for (int z = zlo + lane; z < zhi; z += 32) {
      int h = hit[g0 + z], m = miss[g0 + z];
      bool any = false;
      for (int j = kk; j < k; ++j) {
        const int lz = z - st[3 * j + 2];
        if (!holds(j) || lz < 0 || lz >= bz) continue;
        const long long b = row_base(j, Y) + z;
        h = min(h + box_hit[b], 255);
        m = min(m + box_miss[b], 255);
        any = true;
      }
      if (any) {
        hit[g0 + z] = (uint8_t)h;
        miss[g0 + z] = (uint8_t)m;
      }
    }
  }
}

FIESTA_EXPORT int fiesta_boxadd(uint8_t* hit, uint8_t* miss,
                                const int* starts, const uint8_t* box_hit,
                                const uint8_t* box_miss, int k, int bx,
                                int by, int bz, int gx, int gy, int gz,
                                cudaStream_t stream) {
  const int units = (by + kUnitRows - 1) / kUnitRows;
  const long long warps = (long long)k * bx * units;
  const size_t smem = 3 * (size_t)k * sizeof(int);
  if (smem > 48 * 1024 || warps * 32 > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (warps == 0) return 0;
  const int per_block = kBoxaddThreads / 32;
  const unsigned blocks = (unsigned)((warps + per_block - 1) / per_block);
  boxadd_kernel<<<blocks, kBoxaddThreads, smem, stream>>>(
      hit, miss, starts, box_hit, box_miss, k, bx, by, bz, gx, gy, gz,
      units);
  FIESTA_LAUNCH_CHECK();
  return 0;
}
