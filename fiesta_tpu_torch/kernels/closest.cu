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
// doubling steps; here each column's words come in closed form from g and
// h, the distances to the nearest seed at or before / at or after row i,
// each clamped at L + 1 with L = t_local + 1:
//   * D = min(g, h) <= t_local: value D (or D^2), payload the lower seed
//     index at distance D (i - g when g == D, else i + h);
//   * else the value is L (cap or the caller's sentinel after the
//     epilogue) and the payload is the smallest index among the voxel's own
//     word and a seed exactly L below it, which only the doubling steps can
//     reach when their total reach exceeds t_local (`reach_ok`): i - L if
//     reach_ok and g == L, else i.  Out-of-range neighbours (value L plus a
//     shift, payload 0) never tie at value L.
// A block holds tc whole columns of the u8 occupancy as an [A][tc] tile in
// shared memory, 0 at a seed and L + 1 elsewhere: a u8 tile while
// t_local <= 253, else u16 (L + 1 < 2^16 for every packed plan).  When
// the tile's columns are contiguous in every row (cow: inner = 32 000), a
// warp loads rows as 4-byte words; otherwise bytes in fiesta_tile_pos's
// coalesced order.  A tile with no seed writes far << ba | i row by row
// (the TPU kernel's none_occ branch).  Otherwise fiesta_binary_sweep
// (fiesta_kernels.cuh, shared with the EDT binary pass) runs one segment
// of one column a thread: the segments' own sweeps, a barrier, the
// carries, a forward sweep keeping g in the tile, and a backward sweep
// that forms each word from (g, D) (D == h wherever g > D) and writes it:
// a warp writes one 128-byte row of 32 columns a step (the plans' a axis
// is never contiguous).  Each block computes its columns' base addresses
// once.
// Bound: bytes (u8 in, i32 out: 5 bytes per voxel, 64 MB at cow scale).
//
// Window pass (payload b* << ba | a*) and split pass (two half-window
// accumulators, one output word val << (s+1) | sign << s | pay): one
// kernel body, closest_bounded_pass, over the pass (WindowPass: the
// repack v << s | i << ba | a* as the load, one accumulator, the value
// clamped at cap; SplitPass: the words as they come, one accumulator a
// side).  Each side's window is bounded exactly.  Inputs are <= cap, so a
// neighbour whose value is cap (or the fill beyond a column end, cap << s
// with payload 0) adds k^2 >= 1 to a value >= the centre's and never wins:
//   * side n starts at k0n, the distance to the nearest row below i whose
//     value is below cap, and side p at k0p, the nearest row above i
//     (none: the side keeps what it has).  Both come from a segmented
//     two-sweep pass over each tile column, one segment per thread (the
//     segment's first and last such rows, a barrier, carries from the
//     other segments); k0n is carried as the thread walks its rows
//     upward and k0p is kept in a u8 side array (capped at 254, a lower
//     bound; 255 for none), since the words have no spare bits;
//   * each side stops at the first k with (k^2 << s) >= acc: a candidate
//     at offset k is a whole word >= k^2 << s, so it cannot be below acc,
//     and a tie leaves the word as it is.  The split bounds its sides
//     independently, so each accumulator is exact and the strict vp < vn
//     (ties to n) is that of the brute-force window.  The window pass has
//     one accumulator: side p starts from what side n left, a min over a
//     set that still holds every candidate that can win, so it is exact
//     and stops sooner.
// Offsets go four a turn with independent loads (an offset past the
// side's reach re-reads its last one).  A tile with no value below cap
// skips the sweeps and the loops (the window then writes the repack).
// Warps take 32 neighbouring columns row by row, so their bounds are
// alike.  A strided axis (the split at cow: inner = 80) writes results
// from registers; a contiguous one (the window at cow and demo, along z)
// stages them in a tile of pitch tc + 1.  Each block computes its
// columns' base addresses once.  Bound: bytes (one i32 read and write per
// voxel, 102 MB at cow scale) against the cheapest exact O(A) pass; what
// holds them above that: the window loops (the offsets per voxel follow
// the distance to the nearest obstacle), the sweeps, and divergence within
// a warp.
//
// Wide forms (closest_binary_wide, closest_window_wide,
// closest_split_wide).  Where the packed word misses int32, the JAX
// package runs the two-word transform of fiesta_tpu/ops/pallas/edt.py
// (_binary_pair_xla :966, _window_pair_xla :994, _split_pair_xla :1020,
// XLA, no Pallas kernel): value and payload in separate words, min'd
// lexicographically.  That min is integer min on the 64-bit word
// val << shift | payload (payload < 2^s, s = ba + bb <= 31, val <= 2t^2 + 1
// < 2^31, so every word and sentinel lies below 2^62), so the wide passes
// are the binary and window kernels above instantiated on a long long
// word: the same bodies, tiles of 8-byte words in shared memory, no
// transposes.  The wide binary pass equals the doubling pair pass: its -s
// step's result feeding its +s step adds only candidates at value + 2s,
// which never win.
//
// The wide split (closest_split_wide_kernel<T>) has a body of its own,
// sized for residency rather than width: the bounded body's whole column
// of 8-byte words (119 KB at 800 rows of 16 columns) left one 512-thread
// block an SM, with nothing to hide its load -> sweep -> window -> store
// sequence behind.  Here:
//   * tile words of T = u32 where the plan allows, else u64.  Inputs are
//     <= cap, so a tile word is <= cap << s | (2^s - 1), and a side only
//     adds k^2 << s with k <= kmax <= tl: every word it compares is at
//     most ((cap + tl^2 + 1) << s) - 1.  The wrapper narrows when
//     (cap + tl^2 + 1) << s <= 2^32 (kernels.split_wide_word_bits); the
//     words are then the i64 words' values, so their order is the same,
//     and the output word, val << (s+1) | sign << s | pay, is formed in
//     64 bits at the store.  800x800x80 at t = 100 (s = 17): 2.62e9, u32;
//     1600x1600x80 (s = 18): 5.24e9, u64;
//   * 256 threads of 16 columns (128-byte rows of i64 in and out), each
//     thread one column's rows c0 + g, c0 + g + 16, ... so a warp reads
//     two neighbouring rows of the tile per step, free of bank conflicts;
//   * the column in chunks of `rows` output rows, each loaded with tl
//     rows of halo either side (a side reaches at most tl rows): shared
//     memory no longer grows with the column.  The launcher picks the
//     chunk (split_tiles) for four resident blocks an SM in
//     u32 (54 KB a block) and three in u64 (72 KB); a column that fits
//     is one chunk without halo (800 rows in u32: 53 KB, four blocks,
//     32 warps an SM);
//   * the carries that cross rows, lp (the nearest row below with a value
//     below cap) and k0p's nn (the nearest above), come from a bit mask
//     of the chunk's near rows a column (set as the chunk loads): a
//     thread finds lp and nn at its first row by scanning the mask, then
//     moves lp over the 16 rows since its last and nn past each near row
//     it reaches.  A near row beyond the halo is beyond tl and would add
//     nothing, so the chunk's own rows decide.
// The tie rule, the two accumulators, the kmax clamp of the unrolled
// taps, k0p's 254/255 codes and the all-far skip are the bounded body's.
//
// Closest decode (closest_decode; port-only: _reconstruct_closest,
// fiesta_tpu/ops/pallas/edt.py:871, is XLA).  One pass over the split
// pass's word (i32 packed, i64 wide): val, sign, b*, a* unpacked; c* =
// c +- round(sqrt(val - da^2 - db^2)) with the f32 conversion and root
// correctly rounded and the rounding half to even (rintf's, as torch.round
// and jnp.round; roundf would differ at dc2 = k^2 + k, k >= 2048); d2 =
// val where val <= t^2, else INF_D2; the closest as the packed i32 grid or
// three i16 planes, -1 where undefined.  Voxel coordinates come from the
// linear index by multiply-high division; each thread takes four voxels a
// block-width apart, so every load and store is coalesced with four loads
// in flight.  Bound: bytes (12 a voxel from an i32 word into d2 and the
// packed grid: 154 MB at cow scale).

#include "fiesta_kernels.cuh"

namespace {

constexpr int kBinaryThreads = 512;
bool g_binary_ready_u8[kFiestaMaxDevices];
bool g_binary_ready_u16[kFiestaMaxDevices];
bool g_binary_wide_ready_u8[kFiestaMaxDevices];
bool g_binary_wide_ready_u16[kFiestaMaxDevices];

// Shared memory of a binary block of tc columns with a tile of `tb`-byte
// elements: base addresses, the segments' carries and the tile.
size_t binary_smem(int A, int tc, int tb) {
  const int segs = kBinaryThreads / tc;
  return tc * sizeof(long long) + 2 * (size_t)segs * tc * sizeof(int) +
         (size_t)A * tc * tb;
}

int binary_tile_cols(int A, int tb) {
  return fiesta_fit_tile_cols([=](int tc) { return binary_smem(A, tc, tb); });
}

}  // namespace

// The binary pass's body: T the tile's element, W the output word (int for
// packed plans, long long for wide ones).
template <class T, class W>
__device__ __forceinline__ void closest_binary_body(
    const uint8_t* __restrict__ occ, W* __restrict__ out, long long outer,
    int A, long long inner, int tc, int tl, int ba, int far_value,
    int reach_ok, int square) {
  extern __shared__ long long binary_sm[];
  const int segs = blockDim.x / tc;
  long long* base = binary_sm;            // [tc]: address of row 0
  int* up = (int*)(base + tc);            // [segs][tc]
  int* down = up + segs * tc;             // [segs][tc]
  T* tile = (T*)(down + segs * tc);       // [A][tc]
  const int cap = tl + 2, L = tl + 1;
  const long long ncols = outer * inner;
  const long long col0 = (long long)blockIdx.x * tc;
  const int total = A * tc;
  const W far = (W)far_value << ba;

  for (int c = threadIdx.x; c < tc; c += blockDim.x)
    base[c] = col0 + c < ncols ? fiesta_col_addr(col0 + c, 0, A, inner) : -1;
  __syncthreads();
  unsigned near = 0;
  if (inner % tc == 0 && inner % 4 == 0 && tc % 4 == 0 &&
      ((uintptr_t)occ & 3) == 0) {
    // every row of the tile is tc contiguous bytes: 4-byte words, a warp
    // reading whole rows, four loads in flight a thread
    const int wpr = tc / 4, q = threadIdx.x % wpr, step = blockDim.x / wpr;
    const uint8_t* src = occ + base[0] + 4 * q;
#pragma unroll 4
    for (int i = threadIdx.x / wpr; i < A; i += step) {
      const unsigned w = *(const unsigned*)(src + i * inner);
      near |= w;
      T* row = tile + i * tc + 4 * q;
      if constexpr (sizeof(T) == 1) {  // four tile bytes in one store
        *(unsigned*)row = ~__vcmpne4(w, 0u) & (0x01010101u * cap);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          row[b] = (T)((w >> (8 * b)) & 0xff ? 0 : cap);
      }
    }
  } else {
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      int i, c;
      fiesta_tile_pos(e, A, tc, inner, i, c);
      const int o = base[c] >= 0 ? occ[base[c] + i * inner] : 0;
      near |= o;
      tile[i * tc + c] = (T)(o ? 0 : cap);
    }
  }
  if (!__syncthreads_or(near != 0)) {  // no seed: far << ba | i
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      int i, c;
      fiesta_tile_pos(e, A, tc, inner, i, c);
      if (base[c] >= 0) out[base[c] + i * inner] = far | i;
    }
    return;
  }

  // thread (seg, c) sweeps one segment of tile column c
  const int c = threadIdx.x % tc, seg = threadIdx.x / tc;
  fiesta_binary_sweep(
      tile + c, tc, A, cap, up, down, tc, c, seg, segs,
      [&](int i, int g, int d) {
        if (base[c] >= 0)
          out[base[c] + i * inner] =
              d <= tl ? ((W)(square ? d * d : d) << ba) |
                            (g == d ? i - g : i + d)
                      : far | (reach_ok && g == L ? i - L : i);
      });
}

template <class T>
__global__ void __launch_bounds__(kBinaryThreads)
    closest_binary_kernel(const uint8_t* __restrict__ occ,
                          int* __restrict__ out, long long outer, int A,
                          long long inner, int tc, int tl, int ba,
                          int far_value, int reach_ok, int square) {
  closest_binary_body<T, int>(occ, out, outer, A, inner, tc, tl, ba,
                              far_value, reach_ok, square);
}

template <class T>
__global__ void __launch_bounds__(kBinaryThreads)
    closest_binary_wide_kernel(const uint8_t* __restrict__ occ,
                               long long* __restrict__ out, long long outer,
                               int A, long long inner, int tc, int tl,
                               int ba, int far_value, int reach_ok,
                               int square) {
  closest_binary_body<T, long long>(occ, out, outer, A, inner, tc, tl, ba,
                                    far_value, reach_ok, square);
}

namespace {

constexpr int kBoundedThreads = 512;
constexpr int kBoundedUnroll = 4;
constexpr int kK0Far = 254;             // farther k0p is stored as this
constexpr unsigned char kK0None = 255;  // no value below cap above the row
bool g_window_ready[kFiestaMaxDevices];
bool g_split_ready[kFiestaMaxDevices];
bool g_window_wide_ready[kFiestaMaxDevices];

// Row pitch of the tile: tc, so that lanes on different rows still use
// different banks, or tc + 1 when the column is contiguous (inner == 1),
// so that the load, which walks a column, is free of bank conflicts.
__host__ __device__ int bounded_pitch(int tc, bool staged) {
  return staged ? tc + 1 : tc;
}

// Shared memory of a bounded-pass block of tc columns of `wb`-byte words:
// base addresses, the tile (and the result tile when staged), the
// segments' rows, the u8 k0p.
size_t bounded_smem(int A, int tc, bool staged, int wb) {
  const int segs = kBoundedThreads / tc;
  const size_t words =
      (size_t)A * bounded_pitch(tc, staged) * (staged ? 2 : 1);
  return tc * sizeof(long long) + words * wb +
         2 * (size_t)segs * tc * sizeof(int) + (size_t)A * tc;
}

}  // namespace

// Window pass: the load repacks raw = v << ba | a* into
// v << s | i << ba | a*; one accumulator for both sides, whose value the
// output clamps at cap.
template <class W>
struct WindowPass {
  int s, cap, ba;
  static constexpr bool kShared = true;
  __device__ W load(W raw, int i) const {
    return ((raw >> ba) << s) | ((W)i << ba) | (raw & (((W)1 << ba) - 1));
  }
  __device__ W word(W, W acc) const {
    return (min(acc >> s, (W)cap) << s) | (acc & (((W)1 << s) - 1));
  }
};

// Split pass: the words as they come; two half-window accumulators, one
// output word val << (s+1) | sign << s | pay.
template <class W>
struct SplitPass {
  int s, cap;
  static constexpr bool kShared = false;
  __device__ W load(W w, int) const { return w; }
  __device__ W word(W acc_n, W acc_p) const {
    const W vn = acc_n >> s, vp = acc_p >> s;
    const bool use_p = vp < vn;  // strict: ties go to the negative side
    const W val = min(min(vn, vp), (W)cap);
    return (val << (s + 1)) | ((W)use_p << s) |
           ((use_p ? acc_p : acc_n) & (((W)1 << s) - 1));
  }
};

// min(acc, col[i + dir * k] + (k^2 << s)) over k = k0, k0 + 1, ... while
// k <= kmax and (k^2 << s) < acc, four offsets a turn with independent
// loads (an offset past kmax re-reads kmax's).
template <class W>
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

// The body of both bounded passes along A of an [outer, A, inner] volume
// of W words: `pass.load` forms the tile words, `pass.word` the output
// from the two sides' accumulators (one shared accumulator when
// Pass::kShared).
template <class W, class Pass>
__device__ __forceinline__ void closest_bounded_pass(
    const Pass& pass, const W* __restrict__ f, W* __restrict__ out,
    long long outer, int A, long long inner, int tc, int tl) {
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
  const int s = pass.s, cap = pass.cap;
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
    const W w = base[c] >= 0 ? pass.load(f[base[c] + i * inner], i) : fill;
    near |= (w >> s) < cap;
    tile[i * pitch + c] = w;
  }
  const bool any_near = __syncthreads_or(near);

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
    if (any_near) {
      if (lp >= 0)
        acc_n = bounded_side(col, pitch, i, -1, i - lp, min(tl, i), s, acc_n);
      // The window pass starts side p from the acc that side n left: the
      // result is a min over a set that still holds every candidate that
      // can win, so it is exact, and side p stops sooner.  The split
      // keeps its sides apart: its word needs each side's own minimum.
      if (Pass::kShared) acc_p = acc_n;
      const int kp = k0p[i * tc + c];
      if (kp != kK0None)
        acc_p = bounded_side(col, pitch, i, 1, kp, min(tl, A - 1 - i), s,
                             acc_p);
      if ((w >> s) < cap) lp = i;
    }
    const W word = pass.word(acc_n, acc_p);
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

__global__ void __launch_bounds__(kBoundedThreads)
    closest_window_kernel(const int* __restrict__ f, int* __restrict__ out,
                          long long outer, int A, long long inner, int tc,
                          int tl, WindowPass<int> pass) {
  closest_bounded_pass(pass, f, out, outer, A, inner, tc, tl);
}

__global__ void __launch_bounds__(kBoundedThreads)
    closest_split_kernel(const int* __restrict__ f, int* __restrict__ out,
                         long long outer, int A, long long inner, int tc,
                         int tl, SplitPass<int> pass) {
  closest_bounded_pass(pass, f, out, outer, A, inner, tc, tl);
}

__global__ void __launch_bounds__(kBoundedThreads)
    closest_window_wide_kernel(const long long* __restrict__ f,
                               long long* __restrict__ out, long long outer,
                               int A, long long inner, int tc, int tl,
                               WindowPass<long long> pass) {
  closest_bounded_pass(pass, f, out, outer, A, inner, tc, tl);
}

namespace {

constexpr int kSplitThreads = 256;
constexpr int kSplitCols = 16;     // 128-byte rows of i64 in and out
constexpr int kSplitMinRows = 64;  // fewest output rows of a chunk
bool g_split_wide_ready_u32[kFiestaMaxDevices];
bool g_split_wide_ready_u64[kFiestaMaxDevices];

// Resident blocks an SM each tile word's kernel is built for, and the
// shared memory a block may take for them of an H100's 228 KB (1 KB a
// block reserved): four blocks of 256 threads (64 registers a thread) and
// 54 KB in u32, three (80 registers) and 72 KB in u64.
template <class T>
struct SplitWide {
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 3;
  static constexpr size_t kSmem = sizeof(T) == 4 ? 54 * 1024 : 72 * 1024;
};

// Buffer rows of a chunk of `rows` output rows: tl rows of halo either
// side, within the column; a column of one chunk has no halo.
__host__ __device__ int split_span(int A, int rows, int tl) {
  return rows >= A || rows + 2 * tl >= A ? A : rows + 2 * tl;
}

// Shared memory of a wide-split block: base addresses, the [span][tc]
// tile of `wb`-byte words and the [tc][span / 32] near masks.
size_t split_smem(int span, int tc, int wb) {
  return tc * sizeof(long long) + (size_t)span * tc * wb +
         (size_t)tc * ((span + 31) / 32) * sizeof(unsigned);
}

// Columns `tc` and chunk rows `rows` of a wide-split block along a column
// of A rows at reach tl on `wb`-byte tile words: kSplitCols columns and
// the column in one chunk where the block fits its SplitWide budget; else
// chunks of equal rows with tl rows of halo either side, as few as the
// budget allows; where a chunk would hold fewer than kSplitMinRows rows,
// the whole column with fewer columns while it needs more than 200 KB
// (the bounded body's rule).
void split_tiles(int A, int tl, int wb, int& tc, int& rows) {
  const size_t budget = wb == 4 ? SplitWide<unsigned>::kSmem
                                : SplitWide<unsigned long long>::kSmem;
  tc = kSplitCols;
  rows = A;
  if (split_smem(A, tc, wb) <= budget) return;
  // the most buffer rows within the budget: 8 + span * (wb + 1/8) bytes a
  // column, less a mask word's rounding
  int span = (int)((budget - 12 * tc) * 8 / (tc * (8 * wb + 1)));
  while (split_smem(span + 1, tc, wb) <= budget) ++span;
  while (split_smem(span, tc, wb) > budget) --span;
  if (span - 2 * tl >= kSplitMinRows) {
    const int chunks = (A + span - 2 * tl - 1) / (span - 2 * tl);
    rows = (A + chunks - 1) / chunks;
    return;
  }
  while (tc > 1 && split_smem(A, tc, wb) > 200 * 1024) tc /= 2;
}

}  // namespace

// The highest row in [from, to) whose bit is set in the mask `m`, or -1.
__device__ __forceinline__ int last_near(const unsigned* m, int from,
                                         int to) {
  while (to > from) {
    const int w = (to - 1) >> 5, w0 = w << 5;
    unsigned bits = m[w] & (0xffffffffu >> (31 - ((to - 1) & 31)));
    if (from > w0) bits &= 0xffffffffu << (from - w0);
    if (bits) return w0 + 31 - __clz(bits);
    to = w0;
  }
  return -1;
}

// The lowest row in [from, to) whose bit is set in the mask `m`, or `to`.
__device__ __forceinline__ int first_near(const unsigned* m, int from,
                                          int to) {
  while (from < to) {
    const int w = from >> 5, w0 = w << 5;
    const unsigned bits = m[w] & (0xffffffffu << (from - w0));
    if (bits) return min(w0 + __ffs(bits) - 1, to);
    from = w0 + 32;
  }
  return to;
}

// SplitPass's output word from tile-word accumulators, formed in 64 bits.
template <class T>
__device__ __forceinline__ long long split_word(T acc_n, T acc_p, int s,
                                                int cap) {
  const T vn = acc_n >> s, vp = acc_p >> s;
  const bool use_p = vp < vn;  // strict: ties go to the negative side
  const long long val = (long long)min(min(vn, vp), (T)cap);
  return (val << (s + 1)) | ((long long)use_p << s) |
         (long long)((use_p ? acc_p : acc_n) & (((T)1 << s) - 1));
}

// Puts the tile words w0, w1 of columns cc, cc + 1 (cc even) at row r in
// one store, and their near bits in the masks; returns whether either is
// near.
template <class T>
__device__ __forceinline__ int split_put_pair(T* tile, unsigned* mask,
                                              int tc, int mw, int r, int cc,
                                              T w0, T w1, int s, int cap) {
  if constexpr (sizeof(T) == 4)
    *(uint2*)(tile + r * tc + cc) = make_uint2(w0, w1);
  else
    *(ulonglong2*)(tile + r * tc + cc) = make_ulonglong2(w0, w1);
  int near = 0;
  const unsigned bit = 1u << (r & 31);
  if ((w0 >> s) < (T)cap) {
    near = 1;
    atomicOr(&mask[cc * mw + (r >> 5)], bit);
  }
  if ((w1 >> s) < (T)cap) {
    near = 1;
    atomicOr(&mask[(cc + 1) * mw + (r >> 5)], bit);
  }
  return near;
}

// The wide split along A of an [outer, A, inner] volume of i64 words
// (values <= cap) on tile words T, in chunks of `rows` output rows.
template <class T>
__device__ __forceinline__ void split_wide_body(
    const long long* __restrict__ f, long long* __restrict__ out,
    long long outer, int A, long long inner, int tc, int tl, int s, int cap,
    int rows) {
  extern __shared__ long long split_sm[];
  const int span = split_span(A, rows, tl), mw = (span + 31) / 32;
  long long* base = split_sm;                             // [tc]: row 0
  T* tile = (T*)(base + tc);                              // [span][tc]
  unsigned* mask = (unsigned*)(tile + (size_t)span * tc);  // [tc][mw]
  const int groups = blockDim.x / tc;
  const int c = threadIdx.x % tc, g = threadIdx.x / tc;
  const T fill = (T)cap << s;
  const long long ncols = outer * inner;
  const long long col0 = (long long)blockIdx.x * tc;
  const T* col = tile + c;
  const unsigned* near_rows = mask + c * mw;

  for (int j = threadIdx.x; j < tc; j += blockDim.x)
    base[j] = col0 + j < ncols ? fiesta_col_addr(col0 + j, 0, A, inner) : -1;
  for (int c0 = 0; c0 < A; c0 += rows) {
    // output rows [c0, c1), buffer rows [lo, lo + n): the halo within tl
    const int c1 = min(A, c0 + rows);
    const int lo = max(0, c0 - tl), n = min(A, c1 + tl) - lo;
    __syncthreads();  // the base addresses, or the last chunk's reads
    for (int e = threadIdx.x; e < tc * mw; e += blockDim.x) mask[e] = 0;
    __syncthreads();
    int near = 0;
    if (inner % 2 == 0 && tc % 2 == 0 && ((uintptr_t)f & 15) == 0) {
      // two neighbouring columns a thread, in one slice since inner is
      // even: 16-byte loads, four in flight, and one tile store a pair
      const int pairs = tc / 2, cc = 2 * (threadIdx.x % pairs);
      const int step = blockDim.x / pairs;
      const long long src = base[cc], far = (long long)cap << s;
      for (int r0 = threadIdx.x / pairs; r0 < n; r0 += 4 * step) {
        longlong2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = r0 + u * step;
          v[u] = r < n && src >= 0
                     ? *(const longlong2*)(f + src + (lo + r) * inner)
                     : make_longlong2(far, far);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = r0 + u * step;
          if (r < n)
            near |= split_put_pair(tile, mask, tc, mw, r, cc, (T)v[u].x,
                                   (T)v[u].y, s, cap);
        }
      }
    } else {
#pragma unroll 4
      for (int e = threadIdx.x; e < n * tc; e += blockDim.x) {
        int r, cc;
        fiesta_tile_pos(e, n, tc, inner, r, cc);
        const T w =
            base[cc] >= 0 ? (T)f[base[cc] + (lo + r) * inner] : fill;
        tile[r * tc + cc] = w;
        if ((w >> s) < (T)cap) {
          near = 1;
          atomicOr(&mask[cc * mw + (r >> 5)], 1u << (r & 31));
        }
      }
    }
    const bool any_near = __syncthreads_or(near);

    // thread (g, c): rows c0 + g, c0 + g + groups, ... of tile column c;
    // lp and nn are buffer rows (-1 and n: none)
    const int i0 = c0 + g;
    int lp = -1, nn = n;
    if (any_near && i0 < c1) {
      lp = last_near(near_rows, max(0, i0 - lo - tl), i0 - lo);
      nn = first_near(near_rows, i0 - lo + 1, n);
    }
    for (int i = i0; i < c1; i += groups) {
      const int b = i - lo;
      const T w = col[b * tc];
      T acc_n = w, acc_p = w;
      if (any_near) {
        if (i != i0) {  // the rows since this thread's last one
          const int q = last_near(near_rows, b - groups, b);
          if (q >= 0) lp = q;
          if (nn <= b) nn = first_near(near_rows, b + 1, n);
        }
        const int kp = nn < n ? min(nn - b, kK0Far) : kK0None;
        if (lp >= 0)
          acc_n = bounded_side(col, tc, b, -1, b - lp, min(tl, i), s, acc_n);
        if (kp != kK0None)
          acc_p = bounded_side(col, tc, b, 1, kp, min(tl, A - 1 - i), s,
                               acc_p);
      }
      if (base[c] >= 0)
        out[base[c] + i * inner] = split_word(acc_n, acc_p, s, cap);
    }
  }
}

template <class T>
__global__ void __launch_bounds__(kSplitThreads, SplitWide<T>::kMinBlocks)
    closest_split_wide_kernel(const long long* __restrict__ f,
                              long long* __restrict__ out, long long outer,
                              int A, long long inner, int tc, int tl, int s,
                              int cap, int rows) {
  split_wide_body<T>(f, out, outer, A, inner, tc, tl, s, cap, rows);
}

// One launch of a bounded pass's kernel along A of [outer, A, inner].
template <class W, class Pass>
static int launch_bounded(void (*kernel)(const W*, W*, long long, int,
                                         long long, int, int, Pass),
                          bool (&ready)[kFiestaMaxDevices], const Pass& pass,
                          const W* f, W* out, long long outer, int A,
                          long long inner, int tl, cudaStream_t stream) {
  const cudaError_t err = fiesta_allow_max_smem(kernel, ready);
  if (err != cudaSuccess) return (int)err;
  const bool staged = inner == 1;
  const int wb = sizeof(W);
  const int tc = fiesta_fit_tile_cols(
      [A, staged, wb](int tc) { return bounded_smem(A, tc, staged, wb); });
  const long long blocks = (outer * inner + tc - 1) / tc;
  kernel<<<(unsigned)blocks, kBoundedThreads,
           bounded_smem(A, tc, staged, wb), stream>>>(f, out, outer, A,
                                                      inner, tc, tl, pass);
  FIESTA_LAUNCH_CHECK();
  return 0;
}

template <class T, class W>
static int launch_closest_binary(
    void (*kernel)(const uint8_t*, W*, long long, int, long long, int, int,
                   int, int, int, int),
    bool (&ready)[kFiestaMaxDevices], const uint8_t* occ, W* out,
    long long outer, int A, long long inner, int tl, int ba, int far_value,
    int reach_ok, int square, cudaStream_t stream) {
  const cudaError_t err = fiesta_allow_max_smem(kernel, ready);
  if (err != cudaSuccess) return (int)err;
  const int tc = binary_tile_cols(A, sizeof(T));
  const long long blocks = (outer * inner + tc - 1) / tc;
  kernel<<<(unsigned)blocks, kBinaryThreads, binary_smem(A, tc, sizeof(T)),
           stream>>>(occ, out, outer, A, inner, tc, tl, ba, far_value,
                     reach_ok, square);
  FIESTA_LAUNCH_CHECK();
  return 0;
}

FIESTA_EXPORT int fiesta_closest_binary(const uint8_t* occ, int* out,
                                        long long outer, int A,
                                        long long inner, int tl, int ba,
                                        int far_value, int reach_ok,
                                        int square, cudaStream_t stream) {
  if (tl + 2 <= 0xff)
    return launch_closest_binary<uint8_t>(
        closest_binary_kernel<uint8_t>, g_binary_ready_u8, occ, out, outer,
        A, inner, tl, ba, far_value, reach_ok, square, stream);
  if (tl + 2 <= 0xffff)
    return launch_closest_binary<uint16_t>(
        closest_binary_kernel<uint16_t>, g_binary_ready_u16, occ, out, outer,
        A, inner, tl, ba, far_value, reach_ok, square, stream);
  return (int)cudaErrorInvalidValue;
}

// The wide binary pass (square values only, as the wide transform takes
// them): the same tiles, 64-bit words out.
FIESTA_EXPORT int fiesta_closest_binary_wide(const uint8_t* occ,
                                             long long* out, long long outer,
                                             int A, long long inner, int tl,
                                             int ba, int far_value,
                                             int reach_ok,
                                             cudaStream_t stream) {
  if (tl + 2 <= 0xff)
    return launch_closest_binary<uint8_t>(
        closest_binary_wide_kernel<uint8_t>, g_binary_wide_ready_u8, occ,
        out, outer, A, inner, tl, ba, far_value, reach_ok, 1, stream);
  if (tl + 2 <= 0xffff)
    return launch_closest_binary<uint16_t>(
        closest_binary_wide_kernel<uint16_t>, g_binary_wide_ready_u16, occ,
        out, outer, A, inner, tl, ba, far_value, reach_ok, 1, stream);
  return (int)cudaErrorInvalidValue;
}

// Columns per block of the binary pass for columns of A rows at local
// reach tl.
FIESTA_EXPORT int fiesta_closest_binary_tile_cols(int A, int tl) {
  return binary_tile_cols(A, tl + 2 <= 0xff ? 1 : 2);
}

FIESTA_EXPORT int fiesta_closest_window(const int* f, int* out,
                                        long long outer, int A,
                                        long long inner, int tl, int ba,
                                        int s, int cap,
                                        cudaStream_t stream) {
  return launch_bounded(closest_window_kernel, g_window_ready,
                        WindowPass<int>{s, cap, ba}, f, out, outer, A, inner,
                        tl, stream);
}

FIESTA_EXPORT int fiesta_closest_split(const int* f, int* out,
                                       long long outer, int A,
                                       long long inner, int tl, int s,
                                       int cap, cudaStream_t stream) {
  return launch_bounded(closest_split_kernel, g_split_ready,
                        SplitPass<int>{s, cap}, f, out, outer, A, inner, tl,
                        stream);
}

FIESTA_EXPORT int fiesta_closest_window_wide(const long long* f,
                                             long long* out, long long outer,
                                             int A, long long inner, int tl,
                                             int ba, int s, int cap,
                                             cudaStream_t stream) {
  return launch_bounded(closest_window_wide_kernel, g_window_wide_ready,
                        WindowPass<long long>{s, cap, ba}, f, out, outer, A,
                        inner, tl, stream);
}

template <class T>
static int launch_split_wide(bool (&ready)[kFiestaMaxDevices],
                             const long long* f, long long* out,
                             long long outer, int A, long long inner, int tl,
                             int s, int cap, int rows, cudaStream_t stream) {
  const cudaError_t err =
      fiesta_allow_max_smem(closest_split_wide_kernel<T>, ready);
  if (err != cudaSuccess) return (int)err;
  int tc, auto_rows;
  split_tiles(A, tl, sizeof(T), tc, auto_rows);
  rows = rows ? rows : auto_rows;
  const long long blocks = (outer * inner + tc - 1) / tc;
  closest_split_wide_kernel<T>
      <<<(unsigned)blocks, kSplitThreads,
         split_smem(split_span(A, rows, tl), tc, sizeof(T)), stream>>>(
          f, out, outer, A, inner, tc, tl, s, cap, rows);
  FIESTA_LAUNCH_CHECK();
  return 0;
}

// Whether every word the wide split compares fits u32: ((cap + tl^2 + 1)
// << s) - 1, the largest tile word plus the largest k^2 << s, < 2^32.
static bool split_wide_fits_u32(int tl, int s, int cap) {
  return (((unsigned long long)cap + (unsigned long long)tl * tl + 1) << s) <=
         (1ull << 32);
}

// The rule above as the launcher applies it, for the card test that holds
// it equal to kernels.split_wide_word_bits.
FIESTA_EXPORT int fiesta_closest_split_wide_fits_u32(int tl, int s, int cap) {
  return split_wide_fits_u32(tl, s, cap) ? 1 : 0;
}

// The wide split with tile words of `wb` bytes (the wrapper's
// kernels.split_wide_word_bits; 4 is refused past split_wide_fits_u32),
// in split_tiles' chunks, or chunks of `rows` output rows where rows > 0.
FIESTA_EXPORT int fiesta_closest_split_wide(const long long* f,
                                            long long* out, long long outer,
                                            int A, long long inner, int tl,
                                            int s, int cap, int wb, int rows,
                                            cudaStream_t stream) {
  if (rows < 0) return (int)cudaErrorInvalidValue;
  if (wb == 4 && split_wide_fits_u32(tl, s, cap))
    return launch_split_wide<unsigned>(g_split_wide_ready_u32, f, out, outer,
                                       A, inner, tl, s, cap, rows, stream);
  if (wb == 8)
    return launch_split_wide<unsigned long long>(g_split_wide_ready_u64, f,
                                                 out, outer, A, inner, tl, s,
                                                 cap, rows, stream);
  return (int)cudaErrorInvalidValue;
}

// The wide split's launch for these arguments, as the card runs it: out =
// {threads, shared bytes, resident blocks an SM, registers a thread,
// local (spill) bytes a thread, tile word bytes, columns, chunk rows}.
FIESTA_EXPORT int fiesta_closest_split_wide_residency(int A, long long inner,
                                                      int tl, int wb,
                                                      int rows, int* out) {
  (void)inner;
  int tc, auto_rows;
  split_tiles(A, tl, wb, tc, auto_rows);
  rows = rows ? rows : auto_rows;
  const size_t smem = split_smem(split_span(A, rows, tl), tc, wb);
  const void* fn =
      wb == 4 ? (const void*)closest_split_wide_kernel<unsigned>
              : (const void*)closest_split_wide_kernel<unsigned long long>;
  cudaError_t err =
      wb == 4 ? fiesta_allow_max_smem(closest_split_wide_kernel<unsigned>,
                                      g_split_wide_ready_u32)
              : fiesta_allow_max_smem(
                    closest_split_wide_kernel<unsigned long long>,
                    g_split_wide_ready_u64);
  int blocks = 0;
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, kSplitThreads, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  const int vals[8] = {kSplitThreads, (int)smem, blocks, attr.numRegs,
                       (int)attr.localSizeBytes, wb, tc, rows};
  for (int k = 0; k < 8; ++k) out[k] = vals[k];
  return 0;
}

// ---------------------------------------------------------------------------
// The closest decode
// ---------------------------------------------------------------------------

namespace {

constexpr int kDecodeThreads = 256;
constexpr int kDecodeVoxels = 4;  // a thread's voxels, a block-width apart

// n / d for n < 2^31 by a multiply-high (Granlund-Montgomery, as CUTLASS's
// FastDivmod): m = ceil(2^(31 + l) / d) with l = ceil(log2 d), then
// n / d = umulhi(n, m) >> (l - 1); d == 1 passes n through.
struct FastDiv {
  unsigned d, m;
  int shift;
  explicit FastDiv(unsigned divisor) : d(divisor), m(0), shift(0) {
    if (d > 1) {
      const int l = 32 - __builtin_clz(d - 1);
      m = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
      shift = l - 1;
    }
  }
  __device__ unsigned operator()(unsigned n) const {
    return d == 1 ? n : __umulhi(n, m) >> shift;
  }
};

// Plain division, for grids of 2^31 voxels or more.
struct WideDiv {
  unsigned long long d;
  explicit WideDiv(unsigned long long divisor) : d(divisor) {}
  __device__ unsigned long long operator()(unsigned long long n) const {
    return n / d;
  }
};

struct DecodeParams {
  int gy, gz;           // grid extents along y and z
  int a, b, c;          // the plan's axes
  int ba, bb, s, t2;    // payload bits, shift, t^2
  int x0, inf_d2;       // global x of plane 0; d2's "far"
};

__device__ __forceinline__ int on_axis(int axis, int x, int y, int z) {
  return axis == 0 ? x : (axis == 1 ? y : z);
}

}  // namespace

// Decode one split word at voxel (x, y, z) (x global) into d2 and the
// closest coordinates, written at index v of the packed grid or planes.
template <class W, class I>
__device__ __forceinline__ void decode_voxel(W w, I v, I n, int x, int y,
                                             int z, const DecodeParams& p,
                                             int* __restrict__ d2,
                                             int* __restrict__ packed,
                                             short* __restrict__ planes) {
  const int val = (int)(w >> (p.s + 1));
  if (val > p.t2) {  // no obstacle within t: undefined
    d2[v] = p.inf_d2;
    if (packed) {
      packed[v] = -1;
    } else {
      planes[v] = -1;
      planes[(long long)n + v] = -1;
      planes[2LL * n + v] = -1;
    }
    return;
  }
  d2[v] = val;
  const int sign = (int)(w >> p.s) & 1;
  const int bstar = (int)(w >> p.ba) & ((1 << p.bb) - 1);
  const int astar = (int)w & ((1 << p.ba) - 1);
  // val = da^2 + db^2 + dc^2 exactly where defined, so dc2 >= 0 and fits
  const long long da = on_axis(p.a, x, y, z) - astar;
  const long long db = on_axis(p.b, x, y, z) - bstar;
  const long long dc2 = max(0LL, (long long)val - da * da - db * db);
  const int dc = __float2int_rn(__fsqrt_rn(__int2float_rn((int)dc2)));
  const int ic = on_axis(p.c, x, y, z);
  const int cstar = sign ? ic + dc : ic - dc;
  int cs[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    cs[k] = p.a == k ? astar : (p.b == k ? bstar : cstar);
  if (packed) {
    packed[v] = (cs[0] << 20) | (cs[1] << 10) | cs[2];
  } else {
    planes[v] = (short)cs[0];
    planes[(long long)n + v] = (short)cs[1];
    planes[2LL * n + v] = (short)cs[2];
  }
}

template <class W, class I, class Div>
__global__ void __launch_bounds__(kDecodeThreads)
    closest_decode_kernel(const W* __restrict__ vps, int* __restrict__ d2,
                          int* __restrict__ packed,
                          short* __restrict__ planes, I n, Div div_z,
                          Div div_y, DecodeParams p) {
  const I step = (I)gridDim.x * blockDim.x * kDecodeVoxels;
  for (I first = (I)blockIdx.x * blockDim.x * kDecodeVoxels + threadIdx.x;
       first < n; first += step) {
    W w[kDecodeVoxels];
#pragma unroll
    for (int u = 0; u < kDecodeVoxels; ++u) {
      const I v = first + (I)u * blockDim.x;
      if (v < n) w[u] = vps[v];
    }
#pragma unroll
    for (int u = 0; u < kDecodeVoxels; ++u) {
      const I v = first + (I)u * blockDim.x;
      if (v >= n) break;
      const I row = div_z(v), xq = div_y(row);
      decode_voxel(w[u], v, n, (int)xq + p.x0, (int)(row - xq * p.gy),
                   (int)(v - row * p.gz), p, d2, packed, planes);
    }
  }
}

template <class W, class I, class Div>
static int launch_decode(const W* vps, int* d2, int* packed, short* planes,
                         long long n, const DecodeParams& p,
                         cudaStream_t stream) {
  const unsigned blocks =
      fiesta_blocks((n + kDecodeVoxels - 1) / kDecodeVoxels, kDecodeThreads);
  closest_decode_kernel<W, I, Div><<<blocks, kDecodeThreads, 0, stream>>>(
      vps, d2, packed, planes, (I)n, Div(p.gz), Div(p.gy), p);
  FIESTA_LAUNCH_CHECK();
  return 0;
}

template <class W>
static int decode_any(const W* vps, int* d2, int* packed, short* planes,
                      long long n, const DecodeParams& p,
                      cudaStream_t stream) {
  if (n < (1LL << 31))
    return launch_decode<W, unsigned, FastDiv>(vps, d2, packed, planes, n, p,
                                               stream);
  return launch_decode<W, unsigned long long, WideDiv>(vps, d2, packed,
                                                       planes, n, p, stream);
}

// Decode the split pass's words `vps` [gx, gy, gz] (i32, or i64 when
// `wide`) into d2 and either the packed closest grid (`packed` non-null)
// or the three i16 planes [3, gx, gy, gz].
FIESTA_EXPORT int fiesta_closest_decode(const void* vps, int wide, int* d2,
                                        int* packed, short* planes, int gx,
                                        int gy, int gz, int a, int b, int c,
                                        int ba, int bb, int s, int t2,
                                        int x0, int inf_d2,
                                        cudaStream_t stream) {
  if (!packed == !planes || gy <= 0 || gz <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)gx * gy * gz;
  if (n == 0) return 0;
  const DecodeParams p{gy, gz, a, b, c, ba, bb, s, t2, x0, inf_d2};
  if (wide)
    return decode_any((const long long*)vps, d2, packed, planes, n, p,
                      stream);
  return decode_any((const int*)vps, d2, packed, planes, n, p, stream);
}
