// Endpoint splat: zero-fill, scatter-max of packed class+range values,
// decode into carve seeds and the hit / free-endpoint masks.
//
// Replaces fiesta_tpu/ops/pallas/fill.py zeros_f32 (:39) and
// decode_packed_splat (:66), and the XLA scatter-max between them
// (fiesta_tpu/ops/raycast.py:898).  The decode is bit-equal to
// _seeds_from_packed (raycast.py:738-754).
//
// Bound: bytes.  The inputs are 8 bytes per ray (index + value); the
// outputs 6 bytes per box voxel (seeds f32, hit u8, epfree u8) — at cow
// scale 1.2 MB in and 67 MB out, so the dense write of the outputs is the
// whole bound.  Only the voxels a ray touched (at most one per ray, 147 k of
// 11.2 M at cow) hold anything but +0.0 after the scatter, and +0.0 decodes
// to seeds +0.0, hit 0, epfree 0: exactly the zero fill.  So the function
// runs as four launches, each output byte is written once densely, and only
// the rays' voxels are decoded:
//   1. splat_fill: zeros into seeds (the f32 target, fill.py:39), 16-byte
//      stores;
//   2. splat_scatter_max: the packed values into seeds; beside the atomics
//      the same launch zeroes hit and epfree, which then sit in L2 (22.4 MB
//      of the 50 MB at cow) for step 4;
//   3. splat_gather: each ray reads its voxel's maximum into a per-ray
//      scratch;
//   4. splat_write: each ray decodes its gathered value and writes seeds,
//      hit and epfree at its voxel.
// Rays that share a voxel write identical bytes.  Steps 3 and 4 are two
// launches so that no ray reads a voxel another ray has already decoded.
//
// Exactness of the scatter: every packed value is an f32 >= 1000 and the
// target starts at +0.0, so the order of non-negative floats equals the
// order of their int32 bit patterns and an integer atomicMax gives the
// float maximum in any order, duplicate indices included.

#include "fiesta_kernels.cuh"

namespace {

// Zero nbytes at p (16-byte aligned): 16-byte stores, then the byte tail.
__device__ __forceinline__ void zero_bytes(uint8_t* p, long long nbytes,
                                           long long first,
                                           long long stride) {
  const long long n16 = nbytes / 16;
  uint4* p16 = reinterpret_cast<uint4*>(p);
  for (long long q = first; q < n16; q += stride)
    p16[q] = make_uint4(0u, 0u, 0u, 0u);
  for (long long b = n16 * 16 + first; b < nbytes; b += stride) p[b] = 0;
}

}  // namespace

__global__ void splat_fill(float* __restrict__ seeds, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  zero_bytes(reinterpret_cast<uint8_t*>(seeds), 4 * n, first, stride);
}

// Also zeroes the two masks (2n bytes from hit; epfree = hit + n): streaming
// stores beside the scatter's atomics, and the masks then sit in L2 for
// splat_write.
__global__ void splat_scatter_max(const int* __restrict__ lin,
                                  const float* __restrict__ val,
                                  long long n_rays, float* target,
                                  uint8_t* __restrict__ masks, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long r = first; r < n_rays; r += stride) {
    const int j = lin[r];
    if (j >= 0 && (long long)j < n)  // out-of-range = dropped ray
      atomicMax(reinterpret_cast<int*>(target) + j, __float_as_int(val[r]));
  }
  zero_bytes(masks, 2 * n, first, stride);
}

__global__ void splat_gather(const int* __restrict__ lin, long long n_rays,
                             const float* __restrict__ seeds, long long n,
                             float* __restrict__ gathered) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n_rays; r += stride) {
    const int j = lin[r];
    if (j >= 0 && (long long)j < n) gathered[r] = seeds[j];
  }
}

__global__ void splat_write(const int* __restrict__ lin, long long n_rays,
                            const float* __restrict__ gathered, float* seeds,
                            uint8_t* hit, uint8_t* epfree, long long n,
                            float thr) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n_rays; r += stride) {
    const int j = lin[r];
    if (j < 0 || (long long)j >= n) continue;
    const float p = gathered[r];
    const bool h = p >= 2000.f;
    const bool freeish = p >= 1000.f && p < 2000.f;
    const float free_range = __fsub_rn(p, 1000.f);
    seeds[j] = h ? __fsub_rn(p, 2000.f) : (freeish ? free_range : 0.f);
    hit[j] = h;
    epfree[j] = freeish && free_range >= thr;
  }
}

// seeds [n + n_rays]: the first n cells are the scatter target and the seeds
// out, the n_rays after them the per-ray scratch of the gather; masks [2n]:
// hit, then epfree.  seeds and masks start 16-byte aligned.
FIESTA_EXPORT int fiesta_splat(const int* lin, const float* val,
                               long long n_rays, float* seeds, uint8_t* masks,
                               long long n, float thr, cudaStream_t stream) {
  const int threads = 256;
  splat_fill<<<fiesta_blocks(n / 4 + 1, threads), threads, 0, stream>>>(seeds,
                                                                       n);
  FIESTA_LAUNCH_CHECK();
  const long long scatter_items = n_rays > n / 16 ? n_rays : n / 16;
  splat_scatter_max<<<fiesta_blocks(scatter_items + 1, threads), threads, 0,
                      stream>>>(lin, val, n_rays, seeds, masks, n);
  FIESTA_LAUNCH_CHECK();
  if (n_rays > 0) {
    const unsigned blocks = fiesta_blocks(n_rays, threads);
    float* gathered = seeds + n;
    splat_gather<<<blocks, threads, 0, stream>>>(lin, n_rays, seeds, n,
                                                 gathered);
    FIESTA_LAUNCH_CHECK();
    splat_write<<<blocks, threads, 0, stream>>>(lin, n_rays, gathered, seeds,
                                                masks, masks + n, n, thr);
    FIESTA_LAUNCH_CHECK();
  }
  return 0;
}
