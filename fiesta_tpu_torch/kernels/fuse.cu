// One-pass occupancy fusion drain.
//
// Replaces fiesta_tpu/ops/pallas/fuse.py fuse_counts_pallas (:72), global and
// windowed.  Per voxel: the vote (a hit iff 2*hit >= miss), one clamped
// log-odds step where the voxel was observed (miss > 0 and, in local-update
// mode, inside the inclusive voxel window), seen |= observed,
// the u8 occupancy after the step, and zeroed counters; per grid: the
// observed, inserted and deleted counts.  The f32 step is one IEEE add
// (built with -fmad=false) then the clamp, as the plain version computes it.
//
// Bound: bytes.  15 bytes per voxel (log-odds, seen, hit, miss read; new
// log-odds, seen, occupancy and two zeroed counters written): 192 MB at cow
// scale.  Each thread takes four consecutive voxels (one 16-byte f32 load,
// 4-byte u8 loads), so every access is a coalesced vector access.  The
// window costs each group of four voxels the (x, y, z) of its first voxel,
// one pair of 32-bit divisions (64-bit only past 2^31 voxels); the other
// three step z, carrying into y and x.  A group within one z row (every
// group when gz % 4 == 0, as at both presets) shares (x, y), so a group
// outside the window's x or y range takes no per-voxel test.  The bounds
// are read once per thread; the global drain is a separate instantiation
// without any of this.  The three counts are integer sums, exact in any
// order: per-block sums of warp-shuffle partials, then one atomicAdd per
// block and count into a zeroed i32[3].

#include "fiesta_kernels.cuh"

struct FuseParams {
  float l_hit, l_miss, cmin, cmax, thr;
  int occ_is_eq;
  int gy, gz;            // grid extents, for a voxel's (x, y, z)
};

// (x, y, z) of flat voxel index i, in the index type I (unsigned 32-bit
// below 2^31 voxels): one division pair.
template <class I>
__device__ __forceinline__ void fuse_coords(I i, const FuseParams& p, int& x,
                                            int& y, int& z) {
  const I yz = (I)p.gy * (I)p.gz;
  const I xq = i / yz;
  const I r = i - xq * yz;
  const I yq = r / (I)p.gz;
  x = (int)xq;
  y = (int)yq;
  z = (int)(r - yq * (I)p.gz);
}

// Inclusive window [x0, y0, z0, x1, y1, z1] test of voxel (x, y, z).
__device__ __forceinline__ bool fuse_in_window(int x, int y, int z,
                                               const int* w) {
  return x >= w[0] && x <= w[3] && y >= w[1] && y <= w[4] && z >= w[2] &&
         z <= w[5];
}

// Bit j (j < 4) set when voxel i0 + j lies in the window: the first
// voxel's (x, y, z), then z steps, carrying into y and x.
template <class I>
__device__ __forceinline__ unsigned fuse_group_in_window(I i0, const int* w,
                                                         const FuseParams& p) {
  int x, y, z;
  fuse_coords(i0, p, x, y, z);
  unsigned mask = 0;
  if (z + 3 < p.gz) {  // one z row: the four voxels share (x, y)
    if (x < w[0] || x > w[3] || y < w[1] || y > w[4]) return 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mask |= (unsigned)(z + j >= w[2] && z + j <= w[5]) << j;
    return mask;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mask |= (unsigned)fuse_in_window(x, y, z, w) << j;
    if (++z == p.gz) {
      z = 0;
      if (++y == p.gy) {
        y = 0;
        ++x;
      }
    }
  }
  return mask;
}

__device__ __forceinline__ bool fuse_occ(float lo, const FuseParams& p) {
  return p.occ_is_eq ? lo == p.thr : lo > p.thr;
}

// One voxel: returns the new log-odds and sets its output bytes and counts.
__device__ __forceinline__ float fuse_voxel(float lo, unsigned seen,
                                            unsigned hit, unsigned miss,
                                            bool in_win, const FuseParams& p,
                                            unsigned& seen_o, unsigned& occ_o,
                                            int& n_obs, int& n_ins,
                                            int& n_del) {
  const bool obs = miss > 0 && in_win;
  const bool is_hit = 2 * hit >= miss;
  float nw = __fadd_rn(lo, is_hit ? p.l_hit : p.l_miss);
  nw = fminf(fmaxf(nw, p.cmin), p.cmax);
  nw = obs ? nw : lo;
  const bool before = fuse_occ(lo, p), after = fuse_occ(nw, p);
  seen_o = seen | (unsigned)obs;
  occ_o = after;
  n_obs += obs;
  n_ins += after && !before;
  n_del += !after && before;
  return nw;
}

// I: the index type of the window's coordinates (unused by the global
// drain).
template <bool Windowed, class I = unsigned>
__global__ void fuse_kernel(const float* __restrict__ lo,
                            const uint8_t* __restrict__ seen,
                            const uint8_t* __restrict__ hit,
                            const uint8_t* __restrict__ miss,
                            float* __restrict__ lo_o,
                            uint8_t* __restrict__ seen_o,
                            uint8_t* __restrict__ occ_o,
                            uint8_t* __restrict__ hit_o,
                            uint8_t* __restrict__ miss_o,
                            int* __restrict__ counts,
                            const int* __restrict__ window, long long n,
                            FuseParams p) {
  int w[6] = {0, 0, 0, 0, 0, 0};
  if constexpr (Windowed)
    for (int a = 0; a < 6; ++a) w[a] = window[a];
  int n_obs = 0, n_ins = 0, n_del = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long groups = n / 4;
  for (long long g = first; g < groups; g += stride) {
    const float4 l4 = reinterpret_cast<const float4*>(lo)[g];
    const uchar4 s4 = reinterpret_cast<const uchar4*>(seen)[g];
    const uchar4 h4 = reinterpret_cast<const uchar4*>(hit)[g];
    const uchar4 m4 = reinterpret_cast<const uchar4*>(miss)[g];
    unsigned so[4], oo[4];
    float4 r;
    unsigned in = 0xf;
    if constexpr (Windowed) in = fuse_group_in_window((I)(4 * g), w, p);
    r.x = fuse_voxel(l4.x, s4.x, h4.x, m4.x, in & 1, p, so[0], oo[0], n_obs,
                     n_ins, n_del);
    r.y = fuse_voxel(l4.y, s4.y, h4.y, m4.y, in & 2, p, so[1], oo[1], n_obs,
                     n_ins, n_del);
    r.z = fuse_voxel(l4.z, s4.z, h4.z, m4.z, in & 4, p, so[2], oo[2], n_obs,
                     n_ins, n_del);
    r.w = fuse_voxel(l4.w, s4.w, h4.w, m4.w, in & 8, p, so[3], oo[3], n_obs,
                     n_ins, n_del);
    reinterpret_cast<float4*>(lo_o)[g] = r;
    reinterpret_cast<uchar4*>(seen_o)[g] =
        make_uchar4(so[0], so[1], so[2], so[3]);
    reinterpret_cast<uchar4*>(occ_o)[g] =
        make_uchar4(oo[0], oo[1], oo[2], oo[3]);
    reinterpret_cast<uchar4*>(hit_o)[g] = make_uchar4(0, 0, 0, 0);
    reinterpret_cast<uchar4*>(miss_o)[g] = make_uchar4(0, 0, 0, 0);
  }
  // the n % 4 tail voxels, one per thread of the first block
  if (blockIdx.x == 0 && threadIdx.x < n - groups * 4) {
    const long long i = groups * 4 + threadIdx.x;
    bool in = true;
    if constexpr (Windowed) {
      int x, y, z;
      fuse_coords((I)i, p, x, y, z);
      in = fuse_in_window(x, y, z, w);
    }
    unsigned so, oo;
    lo_o[i] = fuse_voxel(lo[i], seen[i], hit[i], miss[i], in, p, so, oo,
                         n_obs, n_ins, n_del);
    seen_o[i] = so;
    occ_o[i] = oo;
    hit_o[i] = 0;
    miss_o[i] = 0;
  }

  for (int off = 16; off > 0; off >>= 1) {
    n_obs += __shfl_down_sync(0xffffffffu, n_obs, off);
    n_ins += __shfl_down_sync(0xffffffffu, n_ins, off);
    n_del += __shfl_down_sync(0xffffffffu, n_del, off);
  }
  __shared__ int part[3][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part[0][warp] = n_obs;
    part[1][warp] = n_ins;
    part[2][warp] = n_del;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int s = 0;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) s += part[threadIdx.x][w];
    if (s) atomicAdd(counts + threadIdx.x, s);
  }
}

FIESTA_EXPORT int fiesta_fuse(const float* lo, const uint8_t* seen,
                              const uint8_t* hit, const uint8_t* miss,
                              float* lo_o, uint8_t* seen_o, uint8_t* occ_o,
                              uint8_t* hit_o, uint8_t* miss_o, int* counts,
                              const int* window, int gx, int gy, int gz,
                              float l_hit, float l_miss, float cmin,
                              float cmax, float thr, int occ_is_eq,
                              cudaStream_t stream) {
  // window: device int[6] inclusive bounds, or null for the global drain
  const int threads = 256;
  const long long n = (long long)gx * gy * gz;
  const FuseParams p{l_hit, l_miss, cmin, cmax, thr, occ_is_eq, gy, gz};
  const unsigned blocks = fiesta_blocks((n + 3) / 4, threads);
  if (window && n < (1LL << 31))
    fuse_kernel<true, unsigned><<<blocks, threads, 0, stream>>>(
        lo, seen, hit, miss, lo_o, seen_o, occ_o, hit_o, miss_o, counts,
        window, n, p);
  else if (window)
    fuse_kernel<true, unsigned long long><<<blocks, threads, 0, stream>>>(
        lo, seen, hit, miss, lo_o, seen_o, occ_o, hit_o, miss_o, counts,
        window, n, p);
  else
    fuse_kernel<false><<<blocks, threads, 0, stream>>>(
        lo, seen, hit, miss, lo_o, seen_o, occ_o, hit_o, miss_o, counts,
        window, n, p);
  FIESTA_LAUNCH_CHECK();
  return 0;
}
