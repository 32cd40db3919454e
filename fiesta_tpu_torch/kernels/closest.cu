// The three packed passes of the closest-obstacle transform.
//
// fiesta_closest_binary replaces fiesta_tpu/ops/pallas/edt.py
// _binary_packed_pallas (:614), fiesta_closest_window _window_packed_pallas
// (:703) and fiesta_closest_split _split_packed_pallas (:773).  Each pass
// runs along one axis of a contiguous volume viewed as [outer, A, inner],
// so the transform runs pass 1 along the plan's axis a, pass 2 along b and
// pass 3 along c of the natural [X, Y, Z] grid with no transposes between.
// Words are packed as value << shift | payload; integer min on the words is
// min on the value with the smaller payload winning ties, exactly as on the
// TPU.
//
// Binary pass (payload a*, the source row).  The TPU kernel runs log-t
// doubling steps; here one thread walks its column forward then backward
// (distances g and h to the nearest seed at or before / at or after, each
// clamped at L + 1 with L = t_local + 1) and writes the word the doubling
// steps produce, in closed form:
//   * D = min(g, h) <= t_local: value D (or D^2), payload the lower seed
//     index at distance D (i - g when g == D, else i + h);
//   * else the value is L (cap or the caller's sentinel after the
//     epilogue) and the payload is the smallest index among the voxel's own
//     word and a seed exactly L below it, which only the doubling steps can
//     reach when their total reach exceeds t_local (`reach_ok`): i - L if
//     reach_ok and g == L, else i.  Out-of-range neighbours (value L plus a
//     shift, payload 0) never tie at value L.
// Bound: bytes (u8 in, i32 out: 5 bytes per voxel, 64 MB at cow scale).
//
// Window pass (payload b* << ba | a*) and split pass (two half-window
// accumulators, one output word val << (s+1) | sign << s | pay) run on the
// shared column-tile kernel (fiesta_kernels.cuh): tc whole columns per
// block in shared memory, coalesced loads and stores, the window pass's
// repack as the load's prologue, the brute-force window from shared
// memory.  Out-of-range neighbours read cap << s with payload 0.  A tile
// whose every value equals cap is all far: the centre wins every
// comparison (a neighbour or the fill adds k^2 >= 1 to the value), so the
// window loop is skipped and the epilogue gives exactly what the loop
// would.  Bound: bytes (one i32 read and write per voxel, 102 MB
// at cow scale) against the cheapest exact O(A) pass; the brute-force
// window does 3 (window) or 4 (split) int32 operations per offset.

#include "fiesta_kernels.cuh"

__global__ void closest_binary_kernel(const uint8_t* __restrict__ occ,
                                      int* __restrict__ out, long long outer,
                                      int A, long long inner, int tl, int ba,
                                      int far_value, int reach_ok,
                                      int square) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= outer * inner) return;
  const long long base = (col / inner) * A * inner + col % inner;
  const int L = tl + 1, clampv = tl + 2;
  int g = clampv;  // forward: distance to the nearest seed at or before i
  for (int i = 0; i < A; ++i) {
    const long long at = base + (long long)i * inner;
    g = occ[at] ? 0 : min(g + 1, clampv);
    out[at] = g;
  }
  int h = clampv;  // backward: distance to the nearest seed at or after i
  for (int i = A - 1; i >= 0; --i) {
    const long long at = base + (long long)i * inner;
    g = out[at];
    h = g == 0 ? 0 : min(h + 1, clampv);
    const int d = min(g, h);
    int word;
    if (d <= tl) {
      const int pay = g == d ? i - g : i + h;
      word = ((square ? d * d : d) << ba) | pay;
    } else {
      const int pay = reach_ok && g == L ? i - L : i;
      word = (far_value << ba) | pay;
    }
    out[at] = word;
  }
}

// Window pass: the prologue repacks v << s | i << ba | a*, the window keeps
// one accumulator and the epilogue clamps the value to cap.
struct ClosestWindow {
  int tl, ba, s, cap;
  int fill;  // cap << s, payload 0: beyond the column ends
  __device__ int load(int raw, int i, int& near) const {
    const int v = raw >> ba;
    near |= v != cap;
    return (v << s) | (i << ba) | (raw & ((1 << ba) - 1));
  }
  __device__ int window(const int* col, int i, int A, int tc,
                        bool any_near) const {
    int acc = col[i * tc];
    if (any_near) {
      for (int k = 1; k <= tl; ++k) {
        const int lo = i - k >= 0 ? col[(i - k) * tc] : fill;
        const int hi = i + k < A ? col[(i + k) * tc] : fill;
        acc = min(acc, min(lo, hi) + ((k * k) << s));
      }
    }
    return (min(acc >> s, cap) << s) | (acc & ((1 << s) - 1));
  }
};

// Split pass: two half-window accumulators, one output word.
struct ClosestSplit {
  int tl, s, cap;
  int fill;  // cap << s, payload 0: beyond the column ends
  __device__ int load(int raw, int, int& near) const {
    near |= (raw >> s) != cap;
    return raw;
  }
  __device__ int window(const int* col, int i, int A, int tc,
                        bool any_near) const {
    int acc_n = col[i * tc], acc_p = acc_n;
    if (any_near) {
      for (int k = 1; k <= tl; ++k) {
        const int kk = (k * k) << s;
        acc_n = min(acc_n, (i - k >= 0 ? col[(i - k) * tc] : fill) + kk);
        acc_p = min(acc_p, (i + k < A ? col[(i + k) * tc] : fill) + kk);
      }
    }
    const int vn = acc_n >> s, vp = acc_p >> s;
    const int use_p = vp < vn;  // strict: ties go to the negative side
    const int val = min(min(vn, vp), cap);
    const int pay = (use_p ? acc_p : acc_n) & ((1 << s) - 1);
    return (val << (s + 1)) | (use_p << s) | pay;
  }
};

FIESTA_EXPORT int fiesta_closest_binary(const uint8_t* occ, int* out,
                                        long long outer, int A,
                                        long long inner, int tl, int ba,
                                        int far_value, int reach_ok,
                                        int square, cudaStream_t stream) {
  const int threads = 128;
  const long long blocks = (outer * inner + threads - 1) / threads;
  closest_binary_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      occ, out, outer, A, inner, tl, ba, far_value, reach_ok, square);
  FIESTA_LAUNCH_CHECK();
  return 0;
}

FIESTA_EXPORT int fiesta_closest_window(const int* f, int* out,
                                        long long outer, int A,
                                        long long inner, int tl, int ba,
                                        int s, int cap,
                                        cudaStream_t stream) {
  return fiesta_tile_window(ClosestWindow{tl, ba, s, cap, cap << s}, f, out,
                            outer, A, inner, stream);
}

FIESTA_EXPORT int fiesta_closest_split(const int* f, int* out,
                                       long long outer, int A,
                                       long long inner, int tl, int s,
                                       int cap, cudaStream_t stream) {
  return fiesta_tile_window(ClosestSplit{tl, s, cap, cap << s}, f, out,
                            outer, A, inner, stream);
}
