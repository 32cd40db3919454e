// Shared by the port's CUDA sources: C export macro, launch check, the
// error-string export every library carries for its Python wrapper, the
// column-tile addressing of the windowed passes and the binary passes'
// segmented sweep.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define FIESTA_EXPORT extern "C" __attribute__((visibility("default")))

// Return the launch error, if any, to the Python wrapper (which raises): a
// refused launch never runs, and a later synchronise does not report it.
#define FIESTA_LAUNCH_CHECK()                                   \
  do {                                                          \
    cudaError_t fiesta_err_ = cudaGetLastError();               \
    if (fiesta_err_ != cudaSuccess) return (int)fiesta_err_;    \
  } while (0)

FIESTA_EXPORT const char* fiesta_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Grid for a grid-stride elementwise loop over n items.
static inline unsigned fiesta_blocks(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  const long long cap = 132LL * 32;  // 32 blocks per SM on an H100
  return (unsigned)(b < 1 ? 1 : (b > cap ? cap : b));
}

constexpr int kFiestaMaxDevices = 64;

// Lift `kernel`'s cap on dynamic shared memory to the device's opt-in
// maximum (needed above 48 KB), once per device: `ready` holds the
// kernel's per-device flags.  The launch's own size still sets occupancy.
template <class Kernel>
static cudaError_t fiesta_allow_max_smem(Kernel kernel,
                                         bool (&ready)[kFiestaMaxDevices]) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kFiestaMaxDevices && ready[device]) return cudaSuccess;
  int optin;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && device < kFiestaMaxDevices) ready[device] = true;
  return err;
}

// Column tiles of a contiguous volume viewed as [outer, A, inner], walked
// along A (the EDT and closest passes): a block holds tc whole columns as
// an [A][tc] tile in shared memory.
//
// Element e of a tile -> (row i, tile column c), in memory order: along
// `inner` when columns are strided, along the column when inner == 1, so
// loads and stores through this order are coalesced either way.
__device__ __forceinline__ void fiesta_tile_pos(int e, int A, int tc,
                                                long long inner, int& i,
                                                int& c) {
  if (inner == 1) {
    i = e % A;
    c = e / A;
  } else {
    i = e / tc;
    c = e % tc;
  }
}

// Address of row i of column `col` (col = outer index * inner + inner
// index).
__device__ __forceinline__ long long fiesta_col_addr(long long col, int i,
                                                     int A,
                                                     long long inner) {
  return ((col / inner) * A + i) * inner + col % inner;
}

// Columns per block: 32 (one warp-wide row) while the block's shared
// memory, `smem(tc)` bytes, fits in 200 KB; fewer for very long columns.
template <class Smem>
static int fiesta_fit_tile_cols(Smem smem) {
  int tc = 32;
  while (tc > 1 && smem(tc) > 200 * 1024) tc /= 2;
  return tc;
}

// The segmented two-sweep of the binary passes (edt.cu's
// edt_binary_kernel, closest.cu's closest_binary_kernel): the 1-D distance
// transform of one tile column, split into `segs` segments of `len` rows,
// one per thread.  `col` points at row 0 of the thread's column (rows
// `pitch` apart), holding 0 at a seed and `cap` elsewhere; distances come
// out clamped at `cap`.  Each thread sweeps its segment from "none" both
// ways (g at its last row into `up`, h at its first into `down`, both
// [segs][tc]); after a barrier, which every thread of the block must
// reach, it takes the carries of the segments below and above, sweeps
// forward keeping g, the distance to the nearest seed at or before row i,
// in the tile, then backward calling `emit(i, g, d)` with d = min(g, h),
// the distance to the nearest seed on either side: a warp emits one row
// of neighbouring columns a step.
template <class T, class Emit>
__device__ __forceinline__ void fiesta_binary_sweep(T* col, int pitch, int A,
                                                    int cap, int* up,
                                                    int* down, int tc, int c,
                                                    int seg, int segs,
                                                    Emit emit) {
  const int len = (A + segs - 1) / segs;
  const int r0 = min(A, seg * len), r1 = min(A, r0 + len);
  int g = cap, h = cap;  // the segment alone: g at row r1 - 1, h at row r0
  for (int i = r0; i < r1; ++i) {
    const int v = col[i * pitch];
    g = min(g + 1, v);
    h = min(h, v + (i - r0));
  }
  up[seg * tc + c] = g;
  down[seg * tc + c] = h;
  __syncthreads();
  g = cap;  // at row r0 - 1, from the segments below
  for (int j = 0; j < seg; ++j)
    g = min(g + min(A, j * len + len) - min(A, j * len), up[j * tc + c]);
  h = cap;  // at row r1, from the segments above
  for (int j = segs - 1; j > seg; --j)
    h = min(h + min(A, j * len + len) - min(A, j * len), down[j * tc + c]);
  for (int i = r0; i < r1; ++i) {
    g = min(g + 1, (int)col[i * pitch]);
    col[i * pitch] = (T)g;
  }
  for (int i = r1 - 1; i >= r0; --i) {
    const int gi = col[i * pitch];
    h = min(h + 1, gi);
    emit(i, gi, h);
  }
}
