// Exact truncated EDT passes.
//
// fiesta_edt_binary replaces fiesta_tpu/ops/pallas/edt.py
// _binary_pass_pallas (:195); fiesta_edt_minplus replaces
// _minplus_pass_pallas (:105).  The EDT (truncated_edt_d2) runs the binary
// pass once along axis 0, then the min-plus pass along axes 1 and 2.
//
// Binary pass.  On a 0 / INF column, the first min-plus pass equals the
// squared L1 distance to the nearest seed on the column.  The TPU kernel
// gets it from O(log t) doubling shifts; here it is the two-sweep 1-D
// distance transform, with the input clamped to t_local + 1 as the TPU
// kernel clamps it: every distance <= t_local comes out exact, every other
// one reads as "far".  A block holds tc whole columns as an [A][tc] tile
// in shared memory (one row of 32 columns is 128 contiguous bytes, so the
// load is coalesced), and splits each column into segments, one per
// thread.  Each thread sweeps its segment from "far" both ways (the
// distance at its last row from below, at its first row from above);
// after a barrier it takes the carries of the other segments and sweeps
// forward (in place) and backward, writing d^2, the raw d or the sentinel
// as it goes: a warp writes one 128-byte row a step.  The sweep is
// fiesta_binary_sweep (fiesta_kernels.cuh), shared with the closest binary
// pass.  A tile with no value
// below t_local + 1 writes the sentinel without sweeping (the TPU
// kernel's all-far skip).  Bound: bytes (one i32 read and one i32 write
// per voxel; 102 MB at cow scale).

// Min-plus pass.  out[i] = min(f[i], min_{1<=k<=t} min(f[i-k], f[i+k]) + k^2)
// with INF beyond the column ends and 0 <= f <= INF, along any axis of a
// contiguous volume viewed as [outer, A, inner]: tc whole columns per
// block as an [A][tc + 1] tile in shared memory (the pad column keeps the
// load's and the window's accesses free of bank conflicts), loaded and
// stored coalesced (fiesta_kernels.cuh's element order).  Each voxel's
// window is bounded, exactly, from both sides:
//   * below by k0, the distance along the column to the nearest value
//     below INF: every offset k < k0 reads INF on both sides, and
//     INF + k^2 > INF >= acc cannot win.  k0 comes from two sweeps of the
//     column split into segments, one per thread (each thread's segment
//     ends, a barrier, then its carries from the other segments), and is
//     kept in the tile word's top 11 bits (capped: a smaller k0 is still
//     a lower bound);
//   * above by the first k with k^2 >= acc: every candidate at offset k
//     is >= k^2, since f >= 0.  The loop takes four offsets a turn, their
//     loads independent (an offset past the stop cannot win, one past t
//     reads INF), and tests the stop between turns.
// A voxel with k0 > t keeps f[i] with no loop.  Warps take 32 neighbouring
// columns at one row, whose bounds are alike.  A strided axis (inner > 1)
// writes results from registers in the load's order; a contiguous one
// stages them in a second tile.  Each block computes its columns' base
// addresses once (no 64-bit division per element).  Bound: bytes, one
// i32 read and one i32 write per voxel (102 MB at cow scale), against an
// exact O(A) pass (a lower envelope, ~24 int32 operations per voxel of a
// column holding a value below INF).  What holds it above that: the
// window loop, whose warps run their slowest lane (about twice the mean
// offsets per voxel on axis 1), and the load, k0 and store phases.

#include "fiesta_kernels.cuh"

#define EDT_INF (1 << 20)

namespace {

constexpr int kBinaryThreads = 512;
constexpr int kMinplusThreads = 256;
constexpr unsigned kValMask = (1u << 21) - 1;  // f <= EDT_INF = 2^20
constexpr int kK0Shift = 21;
constexpr int kK0Cap = (1 << 11) - 1;
constexpr int kNone = 1 << 20;  // no value below INF on that side
constexpr int kWindowUnroll = 4;
bool g_binary_ready[kFiestaMaxDevices];
bool g_minplus_ready[kFiestaMaxDevices];

// Shared memory of a binary block of tc columns: the tile and the
// segments' carries.
size_t binary_smem(int A, int tc) {
  const int segs = kBinaryThreads / tc;
  return ((size_t)A * tc + 2 * (size_t)segs * tc) * sizeof(int);
}

// Columns per min-plus block, sized by its tiles alone.
int minplus_tile_cols(int A, bool staged) {
  return fiesta_fit_tile_cols([A, staged](int tc) {
    return (long long)A * (tc + 1) * sizeof(int) * (staged ? 2 : 1);
  });
}

size_t minplus_smem(int A, int tc, bool staged) {
  const int segs = kMinplusThreads / tc;
  return ((size_t)A * (tc + 1) * (staged ? 2 : 1) + 2 * (size_t)segs * tc) *
             sizeof(int) +
         tc * sizeof(long long);
}

}  // namespace

__global__ void __launch_bounds__(kBinaryThreads)
    edt_binary_kernel(const int* __restrict__ f, int* __restrict__ out,
                      int A, long long inner, int tc, int tl, int far_value,
                      int square) {
  extern __shared__ int binary_sm[];
  const int cap = tl + 1;
  const int segs = blockDim.x / tc;
  int* tile = binary_sm;            // [A][tc]: min(f, cap)
  int* up = tile + A * tc;          // [segs][tc]: at the segment's last row
  int* down = up + segs * tc;       // [segs][tc]: at its first row
  const long long col0 = (long long)blockIdx.x * tc;
  const int cols = (int)min((long long)tc, inner - col0);
  const int total = A * tc;

  int near = 0;
#pragma unroll 4
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int i = e / tc, c = e % tc;
    const int v = c < cols ? min(f[i * inner + col0 + c], cap) : cap;
    near |= v < cap;
    tile[e] = v;
  }
  if (!__syncthreads_or(near)) {
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int i = e / tc, c = e % tc;
      if (c < cols) out[i * inner + col0 + c] = far_value;
    }
    return;
  }

  // thread (seg, c) sweeps one segment of tile column c
  const int c = threadIdx.x % tc, seg = threadIdx.x / tc;
  int* o = out + col0 + c;
  fiesta_binary_sweep(tile + c, tc, A, cap, up, down, tc, c, seg, segs,
                      [&](int i, int, int h) {
                        if (c < cols)
                          o[i * inner] =
                              h > tl ? far_value : (square ? h * h : h);
                      });
}

__global__ void __launch_bounds__(kMinplusThreads)
    edt_minplus_kernel(const int* __restrict__ f, int* __restrict__ out,
                       long long outer, int A, long long inner, int tc,
                       int tl) {
  extern __shared__ long long sm[];
  const int pitch = tc + 1;
  const int segs = blockDim.x / tc;
  long long* base = sm;                       // [tc]: address of row 0
  unsigned* tile = (unsigned*)(base + tc);    // [A][pitch]: f | k0 << 21
  int* first = (int*)(tile + A * pitch);      // [segs][tc]
  int* last = first + segs * tc;              // [segs][tc]
  int* res = last + segs * tc;                // [A][pitch], inner == 1
  const long long ncols = outer * inner;
  const long long col0 = (long long)blockIdx.x * tc;
  const int total = A * tc;

  for (int c = threadIdx.x; c < tc; c += blockDim.x)
    base[c] = col0 + c < ncols ? fiesta_col_addr(col0 + c, 0, A, inner) : -1;
  __syncthreads();
  int near = 0;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int i, c;
    fiesta_tile_pos(e, A, tc, inner, i, c);
    const int v = base[c] >= 0 ? f[base[c] + i * inner] : EDT_INF;
    near |= v < EDT_INF;
    tile[i * pitch + c] = (unsigned)v;
  }
  const bool any_near = __syncthreads_or(near);
  if (any_near) {
    // k0: thread (seg, c) sweeps rows [r0, r1) of tile column c
    const int c = threadIdx.x % tc, seg = threadIdx.x / tc;
    const int len = (A + segs - 1) / segs;
    const int r0 = min(A, seg * len), r1 = min(A, r0 + len);
    int fn = -1, ln = -1;
    for (int i = r0; i < r1; ++i)
      if ((tile[i * pitch + c] & kValMask) < EDT_INF) {
        if (fn < 0) fn = i;
        ln = i;
      }
    first[seg * tc + c] = fn;
    last[seg * tc + c] = ln;
    __syncthreads();
    int lp = -kNone, nn = A + kNone;  // nearest rows in the other segments
    for (int j = 0; j < seg; ++j)
      if (last[j * tc + c] >= 0) lp = last[j * tc + c];
    for (int j = segs - 1; j > seg; --j)
      if (first[j * tc + c] >= 0) nn = first[j * tc + c];
    for (int i = r0; i < r1; ++i) {
      const unsigned v = tile[i * pitch + c] & kValMask;
      if (v < EDT_INF) lp = i;
      tile[i * pitch + c] = v | (unsigned)min(i - lp, kK0Cap) << kK0Shift;
    }
    for (int i = r1 - 1; i >= r0; --i) {
      const unsigned w = tile[i * pitch + c];
      if ((w & kValMask) < EDT_INF) nn = i;
      const int k0 = min((int)(w >> kK0Shift), min(nn - i, kK0Cap));
      tile[i * pitch + c] = (w & kValMask) | (unsigned)k0 << kK0Shift;
    }
  }
  __syncthreads();

  // c fastest, so a warp reads 32 consecutive shared words; for a strided
  // axis this is also the load's order
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int i = e / tc, c = e % tc;
    const unsigned* col = tile + c;
    const unsigned w = col[i * pitch];
    int acc = (int)(w & kValMask);
    // an all-far tile keeps its values: k0 was not swept there
    const int k1 = any_near ? max(1, (int)(w >> kK0Shift)) : tl + 1;
    for (int k = k1; k <= tl && k * k < acc; k += kWindowUnroll) {
#pragma unroll
      for (int u = 0; u < kWindowUnroll; ++u) {
        const int kk = k + u;
        const int lo = kk <= tl && i - kk >= 0
                           ? (int)(col[(i - kk) * pitch] & kValMask)
                           : EDT_INF;
        const int hi = kk <= tl && i + kk < A
                           ? (int)(col[(i + kk) * pitch] & kValMask)
                           : EDT_INF;
        acc = min(acc, min(lo, hi) + kk * kk);
      }
    }
    if (inner != 1) {
      if (base[c] >= 0) out[base[c] + i * inner] = acc;
    } else {
      res[i * pitch + c] = acc;
    }
  }
  if (inner != 1) return;
  __syncthreads();
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int i, c;
    fiesta_tile_pos(e, A, tc, inner, i, c);
    if (base[c] >= 0) out[base[c] + i] = res[i * pitch + c];
  }
}

FIESTA_EXPORT int fiesta_edt_binary(const int* f, int* out, int A,
                                    long long inner, int tl, int far_value,
                                    int square, cudaStream_t stream) {
  const cudaError_t err =
      fiesta_allow_max_smem(edt_binary_kernel, g_binary_ready);
  if (err != cudaSuccess) return (int)err;
  const int tc =
      fiesta_fit_tile_cols([A](int tc) { return binary_smem(A, tc); });
  const long long blocks = (inner + tc - 1) / tc;
  edt_binary_kernel<<<(unsigned)blocks, kBinaryThreads, binary_smem(A, tc),
                      stream>>>(f, out, A, inner, tc, tl, far_value, square);
  FIESTA_LAUNCH_CHECK();
  return 0;
}

FIESTA_EXPORT int fiesta_edt_minplus(const int* f, int* out,
                                     long long outer, int A,
                                     long long inner, int tl,
                                     cudaStream_t stream) {
  const cudaError_t err =
      fiesta_allow_max_smem(edt_minplus_kernel, g_minplus_ready);
  if (err != cudaSuccess) return (int)err;
  const bool staged = inner == 1;
  const int tc = minplus_tile_cols(A, staged);
  const long long blocks = (outer * inner + tc - 1) / tc;
  edt_minplus_kernel<<<(unsigned)blocks, kMinplusThreads,
                       minplus_smem(A, tc, staged), stream>>>(
      f, out, outer, A, inner, tc, tl);
  FIESTA_LAUNCH_CHECK();
  return 0;
}
