// The wide closest split as it ran before its redesign, for measurement
// only: no package path builds this file (kernels.SOURCES omits it);
// chip_smoke.py builds it with kernels.build_variants and times it beside
// closest.cu's closest_split_wide_kernel<T> on the same inputs.
//
// The kernel is closest.cu's bounded body (closest_bounded_pass) on 64-bit
// words with the split's two accumulators: a block holds tc whole columns
// of long long words in shared memory, tc the widest under 200 KB
// (fiesta_fit_tile_cols), 512 threads, each thread a segment of rows of one
// column; the segments' first and last near rows give lp, a backward
// sweep the u8 k0p (254: farther, 255: none).  It exports the same C
// symbols as closest.cu's wide split (fiesta_closest_split_wide,
// fiesta_closest_split_wide_residency) so that kernels._closest_split_wide
// and kernels.closest_split_wide_residency launch and describe it through
// their `lib` argument; the tile-word, chunk-row arguments are ignored.
//
// FIESTA_SPLIT_STOP 1 stops the pass after the load, storing the all-far
// word; 2 after the carries (the segments' near rows and the k0p sweep).

#include "fiesta_kernels.cuh"

#ifndef FIESTA_SPLIT_STOP
#define FIESTA_SPLIT_STOP 0
#endif

namespace {

constexpr int kBoundedThreads = 512;
constexpr int kBoundedUnroll = 4;
constexpr int kK0Far = 254;             // farther k0p is stored as this
constexpr unsigned char kK0None = 255;  // no value below cap above the row
bool g_split_wide_ready[kFiestaMaxDevices];

__host__ __device__ int bounded_pitch(int tc, bool staged) {
  return staged ? tc + 1 : tc;
}

size_t bounded_smem(int A, int tc, bool staged) {
  const int segs = kBoundedThreads / tc;
  const size_t words =
      (size_t)A * bounded_pitch(tc, staged) * (staged ? 2 : 1);
  return tc * sizeof(long long) + words * sizeof(long long) +
         2 * (size_t)segs * tc * sizeof(int) + (size_t)A * tc;
}

int parent_tile_cols(int A, bool staged) {
  return fiesta_fit_tile_cols(
      [A, staged](int tc) { return bounded_smem(A, tc, staged); });
}

}  // namespace

using W = long long;

__device__ __forceinline__ W split_word(W acc_n, W acc_p, int s, int cap) {
  const W vn = acc_n >> s, vp = acc_p >> s;
  const bool use_p = vp < vn;  // strict: ties go to the negative side
  const W val = min(min(vn, vp), (W)cap);
  return (val << (s + 1)) | ((W)use_p << s) |
         ((use_p ? acc_p : acc_n) & (((W)1 << s) - 1));
}

__device__ __forceinline__ W bounded_side(const W* col, int pitch, int i,
                                          int dir, int k0, int kmax, int s,
                                          W acc) {
  for (int k = k0; k <= kmax && ((W)(k * k) << s) < acc;
       k += kBoundedUnroll) {
#pragma unroll
    for (int u = 0; u < kBoundedUnroll; ++u) {
      const int kq = min(k + u, kmax);
      acc = min(acc, col[(i + dir * kq) * pitch] + ((W)(kq * kq) << s));
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kBoundedThreads)
    closest_split_wide_parent_kernel(const W* __restrict__ f,
                                     W* __restrict__ out, long long outer,
                                     int A, long long inner, int tc, int tl,
                                     int s, int cap) {
  extern __shared__ long long bounded_sm[];
  const bool staged = inner == 1;
  const int pitch = bounded_pitch(tc, staged);
  const int segs = blockDim.x / tc;
  long long* base = bounded_sm;                // [tc]: address of row 0
  W* tile = (W*)(base + tc);                   // [A][pitch]: the words
  W* res = tile + A * pitch;                   // [A][pitch], inner == 1
  int* first = (int*)(res + (staged ? A * pitch : 0));  // [segs][tc]
  int* last = first + segs * tc;               // [segs][tc]
  unsigned char* k0p = (unsigned char*)(last + segs * tc);  // [A][tc]
  const W fill = (W)cap << s;
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
    const W w = base[c] >= 0 ? f[base[c] + i * inner] : fill;
    near |= (w >> s) < cap;
    tile[i * pitch + c] = w;
  }
  const bool any_near = __syncthreads_or(near) && FIESTA_SPLIT_STOP != 1;

  // thread (seg, c) owns rows [r0, r1) of tile column c
  const int c = threadIdx.x % tc, seg = threadIdx.x / tc;
  const int len = (A + segs - 1) / segs;
  const int r0 = min(A, seg * len), r1 = min(A, r0 + len);
  const W* col = tile + c;
  int lp = -1;  // the nearest row below i with a value below cap (-1: none)
  if (any_near) {
    int fn = -1, ln = -1;
    for (int i = r0; i < r1; ++i)
      if ((col[i * pitch] >> s) < cap) {
        if (fn < 0) fn = i;
        ln = i;
      }
    first[seg * tc + c] = fn;
    last[seg * tc + c] = ln;
    __syncthreads();
    int nn = A;  // the nearest row above i with a value below cap (A: none)
    for (int j = 0; j < seg; ++j)
      if (last[j * tc + c] >= 0) lp = last[j * tc + c];
    for (int j = segs - 1; j > seg; --j)
      if (first[j * tc + c] >= 0) nn = first[j * tc + c];
    for (int i = r1 - 1; i >= r0; --i) {
      k0p[i * tc + c] =
          nn == A ? kK0None : (unsigned char)min(nn - i, kK0Far);
      if ((col[i * pitch] >> s) < cap) nn = i;
    }
  }

  for (int i = r0; i < r1; ++i) {
    const W w = col[i * pitch];
    W acc_n = w, acc_p = w;
    if (any_near && FIESTA_SPLIT_STOP == 2) {
      if (lp + k0p[i * tc + c] == -7) acc_n = 0;  // keeps the carries live
      if ((w >> s) < cap) lp = i;
    } else if (any_near) {
      if (lp >= 0)
        acc_n = bounded_side(col, pitch, i, -1, i - lp, min(tl, i), s, acc_n);
      const int kp = k0p[i * tc + c];
      if (kp != kK0None)
        acc_p = bounded_side(col, pitch, i, 1, kp, min(tl, A - 1 - i), s,
                             acc_p);
      if ((w >> s) < cap) lp = i;
    }
    const W word = split_word(acc_n, acc_p, s, cap);
    if (staged)
      res[i * pitch + c] = word;
    else if (base[c] >= 0)
      out[base[c] + i * inner] = word;
  }
  if (!staged) return;
  __syncthreads();
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int i, cc;
    fiesta_tile_pos(e, A, tc, inner, i, cc);
    if (base[cc] >= 0) out[base[cc] + i] = res[i * pitch + cc];
  }
}

FIESTA_EXPORT int fiesta_closest_split_wide(const W* f, W* out,
                                            long long outer, int A,
                                            long long inner, int tl, int s,
                                            int cap, int wb, int rows,
                                            cudaStream_t stream) {
  (void)wb, (void)rows;
  const cudaError_t err = fiesta_allow_max_smem(
      closest_split_wide_parent_kernel, g_split_wide_ready);
  if (err != cudaSuccess) return (int)err;
  const bool staged = inner == 1;
  const int tc = parent_tile_cols(A, staged);
  const long long blocks = (outer * inner + tc - 1) / tc;
  closest_split_wide_parent_kernel<<<(unsigned)blocks, kBoundedThreads,
                                     bounded_smem(A, tc, staged), stream>>>(
      f, out, outer, A, inner, tc, tl, s, cap);
  FIESTA_LAUNCH_CHECK();
  return 0;
}

// closest.cu's residency report, for the parent's launch: out = {threads,
// shared bytes, resident blocks an SM, registers a thread, local (spill)
// bytes a thread, word bytes (8), columns, rows a block (A)}.
FIESTA_EXPORT int fiesta_closest_split_wide_residency(int A, long long inner,
                                                      int tl, int wb,
                                                      int rows, int* out) {
  (void)tl, (void)wb, (void)rows;
  const bool staged = inner == 1;
  const int tc = parent_tile_cols(A, staged);
  const size_t smem = bounded_smem(A, tc, staged);
  cudaError_t err = fiesta_allow_max_smem(closest_split_wide_parent_kernel,
                                          g_split_wide_ready);
  int blocks = 0;
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, closest_split_wide_parent_kernel, kBoundedThreads, smem);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, closest_split_wide_parent_kernel);
  if (err != cudaSuccess) return (int)err;
  const int vals[8] = {kBoundedThreads, (int)smem, blocks, attr.numRegs,
                       (int)attr.localSizeBytes, 8, tc, A};
  for (int k = 0; k < 8; ++k) out[k] = vals[k];
  return 0;
}
