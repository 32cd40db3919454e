// In-place saturating add of K carve boxes into the u8 hit/miss counters.
//
// Replaces fiesta_tpu/ops/pallas/boxadd.py box_add_inplace (:101):
// cnt[s_k : s_k + box] (+)= box_k, saturating at 255, for each scan k in
// order.  The K boxes of a tick overlap in the grid, so one thread per
// (k, box voxel) writing its own sum would race.  Instead every grid voxel
// of the boxes' union has ONE owner: the thread of the lowest k whose box
// covers it.  The owner sums the increments of every box covering the
// voxel and saturates once, min(a + sum, 255), which equals the sequential
// saturating adds because the increments are nonnegative.  Other threads
// of a covered voxel return at once.  Any box placement inside the grid
// works (no alignment rule: that was a Mosaic DMA constraint); voxels
// outside the grid are skipped.
//
// Bound: bytes.  The boxes' hit and miss bytes read once (2 per box voxel
// and scan) and each grid voxel of the boxes' union read and written once
// in each counter (4 per union voxel).  At cow scale the 3 boxes of
// 216x216x80 (3.73 M voxels each) of a tick nearly coincide (chip_smoke.py
// counts the union from the tick's corners).  Threads run along the box's
// z rows, so grid and box accesses are coalesced.

#include "fiesta_kernels.cuh"

__global__ void boxadd_kernel(uint8_t* __restrict__ hit,
                              uint8_t* __restrict__ miss,
                              const int* __restrict__ starts,
                              const uint8_t* __restrict__ box_hit,
                              const uint8_t* __restrict__ box_miss, int k,
                              int bx, int by, int bz, int gx, int gy,
                              int gz) {
  extern __shared__ int st[];  // [k][3] box corners
  for (int i = threadIdx.x; i < 3 * k; i += blockDim.x) st[i] = starts[i];
  __syncthreads();
  const long long nb = (long long)bx * by * bz;
  const long long total = nb * k;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int kk = (int)(e / nb);
    const long long r = e % nb;
    const int z = (int)(r % bz), y = (int)((r / bz) % by),
              x = (int)(r / ((long long)bz * by));
    const int X = st[3 * kk] + x, Y = st[3 * kk + 1] + y,
              Z = st[3 * kk + 2] + z;
    if (X < 0 || X >= gx || Y < 0 || Y >= gy || Z < 0 || Z >= gz) continue;
    bool owned = true;
    for (int j = 0; j < kk && owned; ++j) {
      const int lx = X - st[3 * j], ly = Y - st[3 * j + 1],
                lz = Z - st[3 * j + 2];
      owned = !(lx >= 0 && lx < bx && ly >= 0 && ly < by && lz >= 0 &&
                lz < bz);
    }
    if (!owned) continue;
    int sh = box_hit[e], sm = box_miss[e];
    for (int j = kk + 1; j < k; ++j) {
      const int lx = X - st[3 * j], ly = Y - st[3 * j + 1],
                lz = Z - st[3 * j + 2];
      if (lx >= 0 && lx < bx && ly >= 0 && ly < by && lz >= 0 && lz < bz) {
        const long long b = j * nb + ((long long)lx * by + ly) * bz + lz;
        sh += box_hit[b];
        sm += box_miss[b];
      }
    }
    const long long gi = ((long long)X * gy + Y) * gz + Z;
    hit[gi] = (uint8_t)min(hit[gi] + sh, 255);
    miss[gi] = (uint8_t)min(miss[gi] + sm, 255);
  }
}

FIESTA_EXPORT int fiesta_boxadd(uint8_t* hit, uint8_t* miss,
                                const int* starts, const uint8_t* box_hit,
                                const uint8_t* box_miss, int k, int bx,
                                int by, int bz, int gx, int gy, int gz,
                                cudaStream_t stream) {
  const int threads = 256;
  const long long total = (long long)k * bx * by * bz;
  const size_t smem = 3 * (size_t)k * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  boxadd_kernel<<<fiesta_blocks(total, threads), threads, smem, stream>>>(
      hit, miss, starts, box_hit, box_miss, k, bx, by, bz, gx, gy, gz);
  FIESTA_LAUNCH_CHECK();
  return 0;
}
