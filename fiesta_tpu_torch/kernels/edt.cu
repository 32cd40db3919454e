// Exact truncated EDT passes.
//
// fiesta_edt_binary replaces fiesta_tpu/ops/pallas/edt.py
// _binary_pass_pallas (:195); fiesta_edt_minplus replaces
// _minplus_pass_pallas (:105).  The EDT (truncated_edt_d2) runs the binary
// pass once along axis 0, then the min-plus pass along axes 1 and 2.
//
// Binary pass.  On a 0 / INF column, the first min-plus pass equals the
// squared L1 distance to the nearest seed on the column.  The TPU kernel
// gets it from O(log t) doubling shifts; here one thread walks its column
// forward then backward (the two-sweep 1-D distance transform), with the
// input clamped to t_local + 1 as the TPU kernel clamps it: every distance
// <= t_local comes out exact, every other one reads as "far".  Bound:
// bytes (one i32 read and one i32 write per voxel; 102 MB at cow scale).
// Neighbouring threads own neighbouring columns, so every step of the walk
// is one coalesced row access.
//
// Min-plus pass.  out[i] = min(f[i], min_{1<=k<=t} min(f[i-k], f[i+k]) + k^2)
// with INF beyond the column ends, along any axis of a contiguous volume
// viewed as [outer, A, inner], through the shared column-tile kernel
// (fiesta_kernels.cuh: tc whole columns per block in shared memory,
// coalesced loads and stores); the window loop is skipped when every value
// of the tile is far, as the TPU kernel skips an all-far block.
// This brute-force window does 3 int32 ops per offset pair per voxel; an
// exact O(A) pass (lower envelope, or a convex min-plus convolution where
// the window is shorter than the column) needs ~24 per voxel, so the bound
// is bytes: one i32 read and one i32 write per voxel, 102 MB at cow scale.

#include "fiesta_kernels.cuh"

#define EDT_INF (1 << 20)

__global__ void edt_binary_kernel(const int* __restrict__ f,
                                  int* __restrict__ out, int A,
                                  long long inner, int tl, int far_value,
                                  int square) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= inner) return;
  const int cap = tl + 1;
  int g = cap;  // forward: distance to the nearest seed at or before i
  for (int i = 0; i < A; ++i) {
    const long long at = (long long)i * inner + c;
    g = min(min(f[at], cap), g + 1);
    out[at] = g;
  }
  int h = cap;  // backward: min over both sides
  for (int i = A - 1; i >= 0; --i) {
    const long long at = (long long)i * inner + c;
    h = min(out[at], h + 1);
    out[at] = h > tl ? far_value : (square ? h * h : h);
  }
}

// The min-plus pass's prologue and window for fiesta_tile_window_kernel.
struct EdtMinplus {
  int tl;
  int fill;  // EDT_INF: beyond the column ends
  __device__ int load(int raw, int, int& near) const {
    near |= raw < EDT_INF;
    return raw;
  }
  __device__ int window(const int* col, int i, int A, int tc,
                        bool any_near) const {
    if (!any_near) return EDT_INF;
    int acc = col[i * tc];
    for (int k = 1; k <= tl; ++k) {
      const int lo = i - k >= 0 ? col[(i - k) * tc] : EDT_INF;
      const int hi = i + k < A ? col[(i + k) * tc] : EDT_INF;
      acc = min(acc, min(lo, hi) + k * k);
    }
    return acc;
  }
};

FIESTA_EXPORT int fiesta_edt_binary(const int* f, int* out, int A,
                                    long long inner, int tl, int far_value,
                                    int square, cudaStream_t stream) {
  const int threads = 128;
  const long long blocks = (inner + threads - 1) / threads;
  edt_binary_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      f, out, A, inner, tl, far_value, square);
  FIESTA_LAUNCH_CHECK();
  return 0;
}

FIESTA_EXPORT int fiesta_edt_minplus(const int* f, int* out,
                                     long long outer, int A,
                                     long long inner, int tl,
                                     cudaStream_t stream) {
  return fiesta_tile_window(EdtMinplus{tl, EDT_INF}, f, out, outer, A, inner,
                            stream);
}
