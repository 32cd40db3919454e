// The incremental update's occupancy changes: the tick's inserts and the
// bucket resets of its deleted obstacles, in one pass.
//
// Replaces no TPU kernel: in the JAX package the changes
// (fiesta_tpu/ops/esdf.py:224-264 apply_occupancy_changes) are jnp ops that
// XLA fuses.  On the card the same function as plain PyTorch ops
// (ops/esdf._apply_occupancy_changes_plain, with fusion.fuse_counts' insert
// mask before it) took about 25 launches a tick over the whole grid: the
// coordinate grid rebuilt, the closest planes cast, a 64-bit index, a
// gather and the selects.
//
// Per voxel v, as the plain version computes it: v is an insert where the
// given insert mask holds, or, in the drained form, where it is occupied
// after the drain (occ[v]) and the occupancy predicate (log-odds > thr, or
// == thr in deterministic mode) finds its log-odds before the drain free.
// An insert takes d2 = 0 and its own coordinates, x shifted by x_offset
// (the global x of a slab's first plane), truncated to int16.  Then a voxel
// whose closest obstacle is defined (x >= 0) and not occupied in occ, the
// whole grid's occupancy, resets to INF_D2 and -1 coordinates: the
// reference's bucket of a deleted obstacle.  On request a u8 mask: the
// resets, or the resets and inserts (the windowed relaxation's queued
// voxels).  Inputs are left as they are.
//
// Bound: bytes.  In the drained form a voxel reads d2, its three closest
// planes, its occupancy and its old log-odds and writes d2 and the planes:
// 25 bytes, 320 MB at cow scale (12.8 M voxels), 0.096 ms at 3.35 TB/s.  The
// gather at each defined closest obstacle reads the 12.8 MB occupancy,
// which stays in the 50 MB L2.  Each thread takes four consecutive voxels
// (16-byte d2 and log-odds, 8-byte plane and 4-byte mask accesses) where
// the voxel count is a multiple of four and the pointers are aligned, one
// voxel a step elsewhere.  A voxel's coordinates (two divisions) are formed
// only for an insert.

#include "fiesta_kernels.cuh"

constexpr int kChangesThreads = 256;
constexpr int kInfD2 = 1 << 29;  // grid.INF_D2

struct ChangesParams {
  long long yz;     // gy * gz
  int gz;
  int x_offset;     // the global x of the grid's first plane
  float thr;        // the occupancy threshold, drained form
  int occ_is_eq;    // deterministic mode's == thr over > thr
  int drained;      // inserts from the old log-odds, not a mask
  int mask_mode;    // 0: no mask; 1: resets; 2: resets and inserts
};

// Voxel i with its insert flag: d2 and closest (cx, cy, cz) in, the
// changed values out; returns its mask byte.
__device__ __forceinline__ unsigned changes_voxel(long long i, bool ins,
                                                  int& d2, short& cx,
                                                  short& cy, short& cz,
                                                  const uint8_t* occ,
                                                  const ChangesParams& p) {
  if (ins) {
    const long long x = i / p.yz;
    const long long r = i - x * p.yz;
    const long long y = r / p.gz;
    d2 = 0;
    cx = (short)(x + p.x_offset);
    cy = (short)y;
    cz = (short)(r - y * p.gz);
  }
  bool reset = false;
  if (cx >= 0)
    reset = !occ[(long long)cx * p.yz + (long long)cy * p.gz + cz];
  if (reset) {
    d2 = kInfD2;
    cx = cy = cz = -1;
  }
  return p.mask_mode == 2 ? (reset || ins) : reset;
}

__device__ __forceinline__ bool changes_insert(uint8_t occ, float lo,
                                               const ChangesParams& p) {
  return occ && !(p.occ_is_eq ? lo == p.thr : lo > p.thr);
}

// Vec: four voxels a thread with vector accesses (n % 4 == 0, aligned);
// else one voxel a step.
template <bool Vec>
__global__ void __launch_bounds__(kChangesThreads)
    changes_kernel(const int* __restrict__ d2, const short* __restrict__ c,
                   const uint8_t* __restrict__ occ,
                   const uint8_t* __restrict__ ins,
                   const float* __restrict__ lo, int* __restrict__ d2_o,
                   short* __restrict__ c_o, uint8_t* __restrict__ mask_o,
                   long long n, ChangesParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (Vec) {
    for (long long g = first; g < n / 4; g += stride) {
      const int4 d4 = reinterpret_cast<const int4*>(d2)[g];
      const short4 x4 = reinterpret_cast<const short4*>(c)[g];
      const short4 y4 = reinterpret_cast<const short4*>(c + n)[g];
      const short4 z4 = reinterpret_cast<const short4*>(c + 2 * n)[g];
      int d[4] = {d4.x, d4.y, d4.z, d4.w};
      short cx[4] = {x4.x, x4.y, x4.z, x4.w};
      short cy[4] = {y4.x, y4.y, y4.z, y4.w};
      short cz[4] = {z4.x, z4.y, z4.z, z4.w};
      bool is[4];
      if (p.drained) {
        const uchar4 o4 = reinterpret_cast<const uchar4*>(occ)[g];
        const float4 l4 = reinterpret_cast<const float4*>(lo)[g];
        is[0] = changes_insert(o4.x, l4.x, p);
        is[1] = changes_insert(o4.y, l4.y, p);
        is[2] = changes_insert(o4.z, l4.z, p);
        is[3] = changes_insert(o4.w, l4.w, p);
      } else {
        const uchar4 m4 = reinterpret_cast<const uchar4*>(ins)[g];
        is[0] = m4.x;
        is[1] = m4.y;
        is[2] = m4.z;
        is[3] = m4.w;
      }
      unsigned m[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        m[j] = changes_voxel(4 * g + j, is[j], d[j], cx[j], cy[j], cz[j],
                             occ, p);
      reinterpret_cast<int4*>(d2_o)[g] = make_int4(d[0], d[1], d[2], d[3]);
      reinterpret_cast<short4*>(c_o)[g] =
          make_short4(cx[0], cx[1], cx[2], cx[3]);
      reinterpret_cast<short4*>(c_o + n)[g] =
          make_short4(cy[0], cy[1], cy[2], cy[3]);
      reinterpret_cast<short4*>(c_o + 2 * n)[g] =
          make_short4(cz[0], cz[1], cz[2], cz[3]);
      if (p.mask_mode)
        reinterpret_cast<uchar4*>(mask_o)[g] =
            make_uchar4(m[0], m[1], m[2], m[3]);
    }
  } else {
    for (long long i = first; i < n; i += stride) {
      int d = d2[i];
      short cx = c[i], cy = c[n + i], cz = c[2 * n + i];
      const bool is =
          p.drained ? changes_insert(occ[i], lo[i], p) : ins[i] != 0;
      const unsigned m = changes_voxel(i, is, d, cx, cy, cz, occ, p);
      d2_o[i] = d;
      c_o[i] = cx;
      c_o[n + i] = cy;
      c_o[2 * n + i] = cz;
      if (p.mask_mode) mask_o[i] = m;
    }
  }
}

static bool changes_aligned(const void* ptr, unsigned bytes) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// d2 [X,Y,Z] i32 and closest [3,X,Y,Z] i16 in; occ the whole grid's u8
// occupancy (the grid's own where x_offset is 0); ins the u8 insert mask,
// or null with lo, the f32 log-odds before the drain, for the drained form
// (then occ is the grid's own); mask_o null unless mask_mode > 0.
FIESTA_EXPORT int fiesta_changes(const int* d2, const short* c,
                                 const uint8_t* occ, const uint8_t* ins,
                                 const float* lo, int* d2_o, short* c_o,
                                 uint8_t* mask_o, int gx, int gy, int gz,
                                 int x_offset, float thr, int occ_is_eq,
                                 int mask_mode, cudaStream_t stream) {
  const long long n = (long long)gx * gy * gz;
  const ChangesParams p{(long long)gy * gz, gz, x_offset, thr, occ_is_eq,
                        ins == nullptr, mask_mode};
  const bool vec = n % 4 == 0 && changes_aligned(d2, 16) &&
                   changes_aligned(d2_o, 16) && changes_aligned(c, 8) &&
                   changes_aligned(c_o, 8) && changes_aligned(lo, 16) &&
                   changes_aligned(ins, 4) && changes_aligned(occ, 4) &&
                   changes_aligned(mask_o, 4);
  if (vec)
    changes_kernel<true>
        <<<fiesta_blocks(n / 4, kChangesThreads), kChangesThreads, 0,
           stream>>>(d2, c, occ, ins, lo, d2_o, c_o, mask_o, n, p);
  else
    changes_kernel<false>
        <<<fiesta_blocks(n, kChangesThreads), kChangesThreads, 0, stream>>>(
            d2, c, occ, ins, lo, d2_o, c_o, mask_o, n, p);
  FIESTA_LAUNCH_CHECK();
  return 0;
}
