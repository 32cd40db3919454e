// Bitonic sort of (i32 key, f32 value) pairs, ascending by key.
//
// Replaces fiesta_tpu/ops/pallas/sort.py sort_pairs (:54): the same network
// on the same padded array (n_pad = max(256, next power of two >= n), pad
// keys 0x7fffffff, pad values 0).  Stage (s, j) pairs element i with
// i ^ (1 << j); the pair is ascending where bit s of i is 0, and its two
// elements swap only when the keys are strictly out of order, so a tie keeps
// its pairs where they are.  Every stage is therefore a fixed function of its
// input, and the output (keys and values) is the same whatever the order in
// which the stages' compare-exchanges run: this kernel equals the plain
// network bit for bit.
//
// Bound: bytes.  The function reads 8 bytes per pair and writes 8 (2.4 MB at
// the cow splat's 147 456 pairs); the cheapest exact method for the same work
// is a radix sort of the 24-bit keys, a few integer operations per pair and
// pass, far below the bytes' time.  The whole padded array (2 MB at 2^18) does
// not fit one SM's shared memory as it fit the TPU's VMEM, so the network
// runs in three kinds of launch on a padded scratch, in place:
//   * sort_tiles: each block loads a tile of TILE pairs (padding what lies
//     past n) and runs every stage whose distance is below TILE, for
//     s = 1 .. log2(TILE), in shared memory;
//   * sort_global_step: one launch per stage with distance >= TILE, one
//     thread per compare-exchange, straight in device memory;
//   * sort_tiles again, per s > log2(TILE) after its global stages, for the
//     stages j < log2(TILE).
// At 2^18 pairs that is 1 + 21 + 6 = 28 launches on the caller's stream, with
// no host synchronisation.

#include "fiesta_kernels.cuh"

namespace {

constexpr int kLogTile = 12;
constexpr int kTile = 1 << kLogTile;  // 4096 pairs = 32 KB of shared memory
constexpr int kThreads = 1024;
constexpr int kSentinel = 0x7fffffff;

// Compare-exchange of positions lo < hi = lo + d of an ascending (asc) or
// descending pair.
__device__ __forceinline__ void cmp_exchange(int* k, float* v, int lo, int hi,
                                             bool asc) {
  const int kl = k[lo], kh = k[hi];
  if (asc ? kh < kl : kh > kl) {
    k[lo] = kh;
    k[hi] = kl;
    const float t = v[lo];
    v[lo] = v[hi];
    v[hi] = t;
  }
}

// Stages s = s_lo .. s_hi on tiles of `tile` pairs; within stage s the
// distances j = min(s, log_tile) - 1 .. 0.  Reads keys_in[i] for i < n_in and
// the pad beyond; writes the tile to k_out / v_out (which may alias the
// input: each block reads and writes only its own tile).
__global__ void sort_tiles(const int* keys_in, const float* vals_in,
                           long long n_in, int* k_out, float* v_out,
                           int tile, int log_tile, int s_lo, int s_hi) {
  __shared__ int sk[kTile];
  __shared__ float sv[kTile];
  const long long base = (long long)blockIdx.x * tile;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const long long i = base + e;
    const bool real = i < n_in;
    sk[e] = real ? keys_in[i] : kSentinel;
    sv[e] = real ? vals_in[i] : 0.f;
  }
  __syncthreads();
  for (int s = s_lo; s <= s_hi; ++s) {
    for (int j = min(s, log_tile) - 1; j >= 0; --j) {
      const int d = 1 << j;
      for (int q = threadIdx.x; q < tile / 2; q += blockDim.x) {
        const int lo = ((q >> j) << (j + 1)) | (q & (d - 1));
        cmp_exchange(sk, sv, lo, lo + d, (((base + lo) >> s) & 1) == 0);
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    k_out[base + e] = sk[e];
    v_out[base + e] = sv[e];
  }
}

// One stage (s, j) over the whole padded array, one thread per pair.
__global__ void sort_global_step(int* k, float* v, long long n_pairs, int s,
                                 int j) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_pairs) return;
  const long long d = 1LL << j;
  const long long lo = ((q >> j) << (j + 1)) | (q & (d - 1));
  const long long hi = lo + d;
  const int kl = k[lo], kh = k[hi];
  const bool asc = ((lo >> s) & 1) == 0;
  if (asc ? kh < kl : kh > kl) {
    k[lo] = kh;
    k[hi] = kl;
    const float t = v[lo];
    v[lo] = v[hi];
    v[hi] = t;
  }
}

}  // namespace

// keys / vals [n] in; k_out / v_out [n_pad] scratch out (sorted, pad last).
// n_pad is a power of two >= 256 and >= n.
FIESTA_EXPORT int fiesta_sort_pairs(const int* keys, const float* vals,
                                    long long n, int* k_out, float* v_out,
                                    long long n_pad, cudaStream_t stream) {
  int log_n = 0;
  while ((1LL << log_n) < n_pad) ++log_n;
  const int log_tile = log_n < kLogTile ? log_n : kLogTile;
  const int tile = 1 << log_tile;
  const unsigned tiles = (unsigned)(n_pad / tile);
  const int threads = tile / 2 < kThreads ? tile / 2 : kThreads;
  sort_tiles<<<tiles, threads, 0, stream>>>(keys, vals, n, k_out, v_out, tile,
                                            log_tile, 1, log_tile);
  FIESTA_LAUNCH_CHECK();
  const long long n_pairs = n_pad / 2;
  const unsigned step_blocks = (unsigned)((n_pairs + 255) / 256);
  for (int s = log_tile + 1; s <= log_n; ++s) {
    for (int j = s - 1; j >= log_tile; --j) {
      sort_global_step<<<step_blocks, 256, 0, stream>>>(k_out, v_out, n_pairs,
                                                        s, j);
      FIESTA_LAUNCH_CHECK();
    }
    sort_tiles<<<tiles, threads, 0, stream>>>(k_out, v_out, n_pad, k_out,
                                              v_out, tile, log_tile, s, s);
    FIESTA_LAUNCH_CHECK();
  }
  return 0;
}
