// Bitonic sort of (i32 key, f32 value) pairs, ascending by key.
//
// Replaces fiesta_tpu/ops/pallas/sort.py sort_pairs (:54): the same network
// on the same padded array (n_pad = max(256, next power of two >= n), pad
// keys 0x7fffffff, pad values 0).  Stage (s, j) pairs element i with
// i ^ (1 << j); the pair is ascending where bit s of i is 0, and its two
// elements swap only when the keys are strictly out of order, so a tie keeps
// its pairs where they are.  Every stage is therefore a fixed function of its
// input, and the output (keys and values) is the same whatever the order in
// which one stage's compare-exchanges run: any schedule that applies the
// stages in the network's order equals the plain network bit for bit.
//
// Bound: bytes.  The function reads 8 bytes per pair and writes 8 (2.4 MB at
// the cow splat's 147 456 pairs); the cheapest exact method for the same work
// is a radix sort of the 24-bit keys, a few integer operations per pair and
// pass, far below the bytes' time.  What holds a bitonic network back on this
// card is latency: 171 dependent stages at 2^18, each a few hundred cycles
// of work for an SM, and a fixed cost of a few microseconds per kernel
// launch.  The 2 MB array does not fit one SM's shared memory as it fit the
// TPU's VMEM, so it is cut into tiles of T = 2^t pairs (t = 11: one block's
// 2048 pairs), and the whole network runs in ONE cooperative launch whose
// blocks (at most as many as fit the card at once) take turns of work
// between grid-wide barriers:
//   * the tile sort: each tile through every stage with s <= t;
//   * per level s > t, the strided merge: the stages j = s-1 .. t of that
//     level pair indices that differ only in bits t .. s-1, so a block takes
//     the pairs whose other bits are fixed, as 2^(s-t) rows (bits t .. s-1)
//     of 32 or more contiguous pairs (low bits), and runs the stages in order
//     in shared memory; bit s, the direction, is the same for the whole
//     block.  Past kMergeMaxLogRows stages the level splits, top down, into
//     several such turns;
//   * per level s > t, the tile finish: the stages j < t.
// Inside a tile each thread holds kM consecutive pairs in registers: stages
// j < log2(kM) run in registers, the next five between the lanes of a warp by
// __shfl_xor_sync, and only the longer ones in shared memory with a
// __syncthreads each.  At 2^18 pairs that is one launch and 14 grid barriers
// on the caller's stream (28 launches with the earlier one-stage-per-launch
// schedule), with no host synchronisation.

#include <cooperative_groups.h>

#include "fiesta_kernels.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kLogTile = 11;         // pairs a tile (one block's turn), at most
constexpr int kTile = 1 << kLogTile;
constexpr int kLogM = 2;             // pairs a thread holds in the tiles
constexpr int kM = 1 << kLogM;
constexpr int kThreads = kTile / kM;
constexpr int kMergeMaxLogRows = 7;  // stages per merge turn, at most
constexpr int kMergeLogPairs = 11;   // pairs per merge block where rows allow
constexpr int kMergeMax = 32 << kMergeMaxLogRows;  // pairs, at most: 4096

// Shared-memory slot of tile position e: one word of padding per 32 makes a
// thread's kM consecutive pairs, and 32 consecutive pairs, bank-conflict
// free.
__host__ __device__ constexpr int slot(int e) { return e + (e >> 5); }

// Stages s = s_lo .. s_hi of the tile of 2^log_tile pairs from base; within
// stage s the distances j = min(s, log_tile) - 1 .. 0.  Thread x holds pairs
// x*kM .. x*kM + kM-1 in registers, loaded and stored 16 bytes at a time,
// so bit c >= kLogM of each of them is bit c of its first pair i0.  The
// first turn reads the caller's keys_in[i] for i < n_in, one at a time, and
// the pad beyond; the later ones read and write the scratch k / v in place
// (a block reads and writes only its own tile).
__device__ void tile_stages(const int* keys_in, const float* vals_in,
                            long long n_in, int* k_out, float* v_out,
                            int base, int log_tile, int s_lo, int s_hi,
                            int* sk, float* sv) {
  constexpr int kLaneLo = kLogM, kSmemLo = kLogM + 5;  // first shuffle/smem j
  static_assert(kM == 4, "pairs move as one int4 and one float4 a thread");
  const int e0 = threadIdx.x * kM;
  const int i0 = base + e0;  // global index of this thread's first pair
  int k[kM];
  float v[kM];
  if (keys_in != k_out) {
#pragma unroll
    for (int r = 0; r < kM; ++r) {
      const bool real = i0 + r < n_in;
      k[r] = real ? keys_in[i0 + r] : kSentinel;
      v[r] = real ? vals_in[i0 + r] : 0.f;
    }
  } else {
    const int4 k4 = *reinterpret_cast<const int4*>(k_out + i0);
    const float4 v4 = *reinterpret_cast<const float4*>(v_out + i0);
    k[0] = k4.x, k[1] = k4.y, k[2] = k4.z, k[3] = k4.w;
    v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
  }
  for (int s = s_lo; s <= s_hi; ++s) {
    const int j_top = min(s, log_tile) - 1;
    const bool s_bit = (i0 >> s) & 1;
    if (j_top >= kSmemLo) {
      // Each thread writes and later reads back only its own slots, so the
      // barriers between the stages are the only ones needed.
#pragma unroll
      for (int r = 0; r < kM; ++r) {
        sk[slot(e0 + r)] = k[r];
        sv[slot(e0 + r)] = v[r];
      }
      __syncthreads();
      for (int j = j_top; j >= kSmemLo; --j) {
        // the tile's compare-exchanges, kM / 2 a thread: all keys loaded
        // before any is compared (the pairs are disjoint)
        int lo[kM / 2], kl[kM / 2], kh[kM / 2];
#pragma unroll
        for (int c = 0; c < kM / 2; ++c) {
          const int q = threadIdx.x + c * blockDim.x;
          lo[c] = ((q >> j) << (j + 1)) | (q & ((1 << j) - 1));
          kl[c] = sk[slot(lo[c])];
          kh[c] = sk[slot(lo[c] + (1 << j))];
        }
#pragma unroll
        for (int c = 0; c < kM / 2; ++c) {
          const bool asc = (((base + lo[c]) >> s) & 1) == 0;
          if (asc ? kh[c] < kl[c] : kh[c] > kl[c]) {
            const int a = slot(lo[c]), b = slot(lo[c] + (1 << j));
            sk[a] = kh[c];
            sk[b] = kl[c];
            const float t = sv[a];
            sv[a] = sv[b];
            sv[b] = t;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < kM; ++r) {
        k[r] = sk[slot(e0 + r)];
        v[r] = sv[slot(e0 + r)];
      }
    }
    // Partner in lane ^ 2^(j - kLogM), the same r: each side takes the
    // partner's pair where the network puts it there (the plain version's
    // formulation).  Bits j and s are those of i0 for every r.
    for (int j = min(j_top, kSmemLo - 1); j >= kLaneLo; --j) {
      const int mask = 1 << (j - kLaneLo);
      const bool want_min = (((i0 >> j) & 1) != 0) == s_bit;
#pragma unroll
      for (int r = 0; r < kM; ++r) {
        const int pk = __shfl_xor_sync(0xffffffffu, k[r], mask);
        const float pv = __shfl_xor_sync(0xffffffffu, v[r], mask);
        if (want_min ? pk < k[r] : pk > k[r]) {
          k[r] = pk;
          v[r] = pv;
        }
      }
    }
    // Partner in the same thread, r ^ 2^j: bit s of pair r is that of i0
    // where s >= kLogM, else bit s of r.
#pragma unroll
    for (int j = kLogM - 1; j >= 0; --j) {
      if (j > j_top) continue;
#pragma unroll
      for (int r = 0; r < kM; ++r) {
        if (r & (1 << j)) continue;
        const int r2 = r | (1 << j);
        const bool asc = !(s < kLogM ? (r >> s) & 1 : s_bit);
        const int kl = k[r], kh = k[r2];
        if (asc ? kh < kl : kh > kl) {
          k[r] = kh;
          k[r2] = kl;
          const float t = v[r];
          v[r] = v[r2];
          v[r2] = t;
        }
      }
    }
  }
  *reinterpret_cast<int4*>(k_out + i0) = make_int4(k[0], k[1], k[2], k[3]);
  *reinterpret_cast<float4*>(v_out + i0) =
      make_float4(v[0], v[1], v[2], v[3]);
  __syncthreads();  // the shared memory is the next turn's
}

// Stages (s, j), j = j_hi .. j_lo, of merge level s > j_hi, in place, on
// merge block b: the pairs i0 | row << j_lo | col for every row <
// 2^(j_hi - j_lo + 1) and col < 2^log_c (log_c <= j_lo), where i0 fixes
// bits log_c .. j_lo-1 and the bits above j_hi.  A set closed under i ^ 2^j
// for each of its stages, read and written 2^log_c >= 32 contiguous pairs at
// a time; bit s of every pair is bit s of i0.
__device__ void merge_stages(int* k, float* v, int b, int s, int j_hi,
                             int j_lo, int log_c, int* sk, float* sv) {
  const int log_e = j_hi - j_lo + 1 + log_c;
  const int n_e = 1 << log_e;
  const int mid_bits = j_lo - log_c;
  const int i0 = ((b >> mid_bits) << (j_hi + 1)) |
                 ((b & ((1 << mid_bits) - 1)) << log_c);
  const int col_mask = (1 << log_c) - 1;
  // four consecutive pairs of one row (log_c >= 5) at a time, 16 bytes
  for (int e = 4 * threadIdx.x; e < n_e; e += 4 * blockDim.x) {
    const int i = i0 | ((e >> log_c) << j_lo) | (e & col_mask);
    *reinterpret_cast<int4*>(sk + e) = *reinterpret_cast<const int4*>(k + i);
    *reinterpret_cast<float4*>(sv + e) =
        *reinterpret_cast<const float4*>(v + i);
  }
  __syncthreads();
  const bool asc = ((i0 >> s) & 1) == 0;
  for (int j = j_hi; j >= j_lo; --j) {
    const int lj = j - j_lo + log_c;  // the stage's bit in the block
    // n_e / 2 compare-exchanges, two a thread at a time, keys loaded first
    for (int q0 = threadIdx.x; q0 < n_e / 2; q0 += 2 * blockDim.x) {
      int lo[2], kl[2], kh[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = q0 + c * blockDim.x;
        lo[c] = ((q >> lj) << (lj + 1)) | (q & ((1 << lj) - 1));
        kl[c] = sk[lo[c]];
        kh[c] = sk[lo[c] + (1 << lj)];
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (asc ? kh[c] < kl[c] : kh[c] > kl[c]) {
          const int h = lo[c] + (1 << lj);
          sk[lo[c]] = kh[c];
          sk[h] = kl[c];
          const float t = sv[lo[c]];
          sv[lo[c]] = sv[h];
          sv[h] = t;
        }
      }
    }
    __syncthreads();
  }
  for (int e = 4 * threadIdx.x; e < n_e; e += 4 * blockDim.x) {
    const int i = i0 | ((e >> log_c) << j_lo) | (e & col_mask);
    *reinterpret_cast<int4*>(k + i) = *reinterpret_cast<const int4*>(sk + e);
    *reinterpret_cast<float4*>(v + i) =
        *reinterpret_cast<const float4*>(sv + e);
  }
  __syncthreads();  // the shared memory is the next turn's
}

}  // namespace

// The whole network on 2^log_n pairs, tiles of 2^log_tile (log_tile =
// min(log_n, kLogTile)), blocks of 2^log_tile / kM threads taking turns:
// the tile sort, then per level the merge turns and the tile finish, with a
// grid-wide barrier between dependent turns.  Launched cooperatively.
// Outside the anonymous namespace, so that the profiler lists it by name.
__global__ void __launch_bounds__(kThreads)
    sort_network(const int* keys_in, const float* vals_in, long long n_in,
                 int* k, float* v, int log_n, int log_tile) {
  __shared__ __align__(16) int sk[slot(kMergeMax)];
  __shared__ __align__(16) float sv[slot(kMergeMax)];
  cg::grid_group grid = cg::this_grid();
  const int n_tiles = 1 << (log_n - log_tile);
  for (int b = blockIdx.x; b < n_tiles; b += gridDim.x)
    tile_stages(keys_in, vals_in, n_in, k, v, b << log_tile, log_tile, 1,
                log_tile, sk, sv);
  for (int s = log_tile + 1; s <= log_n; ++s) {
    for (int j_hi = s - 1; j_hi >= log_tile; j_hi -= kMergeMaxLogRows) {
      const int j_lo = max(log_tile, j_hi - kMergeMaxLogRows + 1);
      const int log_rows = j_hi - j_lo + 1;
      const int log_c = min(j_lo, max(5, kMergeLogPairs - log_rows));
      grid.sync();
      for (int b = blockIdx.x; b < 1 << (log_n - log_rows - log_c);
           b += gridDim.x)
        merge_stages(k, v, b, s, j_hi, j_lo, log_c, sk, sv);
    }
    grid.sync();
    for (int b = blockIdx.x; b < n_tiles; b += gridDim.x)
      tile_stages(k, v, 1LL << log_n, k, v, b << log_tile, log_tile, s, s,
                  sk, sv);
  }
}

// Blocks of `threads` the card holds at once, for the cooperative grid; a
// fixed number per device and block size, so it is asked once per device.
static cudaError_t resident_blocks(int threads, long long* out) {
  constexpr int kMaxDevices = 64;
  static long long cached[kMaxDevices][kLogTile - kLogM + 1];
  int device, sms, per_sm;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int log_threads = 0;
  while ((1 << log_threads) < threads) ++log_threads;
  long long* slot = device < kMaxDevices ? &cached[device][log_threads]
                                         : nullptr;
  if (slot && *slot) {
    *out = *slot;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sort_network,
                                                        threads, 0);
  if (err != cudaSuccess) return err;
  *out = (long long)sms * per_sm;
  if (slot) *slot = *out;
  return cudaSuccess;
}

// keys / vals [n] in; k_out / v_out [n_pad] scratch out (sorted, pad last).
// n_pad is a power of two with 256 <= n_pad <= 2^30 and n <= n_pad.
FIESTA_EXPORT int fiesta_sort_pairs(const int* keys, const float* vals,
                                    long long n, int* k_out, float* v_out,
                                    long long n_pad, cudaStream_t stream) {
  int log_n = 0;
  while ((1LL << log_n) < n_pad) ++log_n;
  int log_tile = log_n < kLogTile ? log_n : kLogTile;
  const int threads = (1 << log_tile) / kM;
  // as many blocks as the card holds at once, at most one per tile
  long long resident;
  const cudaError_t err = resident_blocks(threads, &resident);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = n_pad >> log_tile;
  const unsigned blocks =
      (unsigned)(n_tiles < resident ? n_tiles : resident);
  void* args[] = {&keys, &vals, &n, &k_out, &v_out, &log_n, &log_tile};
  return (int)cudaLaunchCooperativeKernel((const void*)sort_network, blocks,
                                          threads, args, 0, stream);
}
