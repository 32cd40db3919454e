// The splat prep: per-ray gates, clip at max range, carve-box placement,
// endpoint or box-exit voxel and the packed class+range value, for all K
// scans of a tick in one launch.
//
// Replaces no TPU kernel: in the JAX package the prep
// (fiesta_tpu/ops/raycast.py:775-877) is jnp ops that XLA fuses.  On the
// card the same function as plain PyTorch ops (ops/raycast.py
// _scanline_splat_prep_plain) issued 232 launches a tick, one per
// elementwise op over the K x P rays, and the tick's host time went to
// enqueueing them.
//
// Per ray, the plain version's arithmetic op for op in f32 (built with
// -fmad=false and IEEE division and square root, so nothing contracts or
// approximates): the optional rotation and translation of sensor-frame
// points as ((px r0 + py r1) + pz r2) + t; the finite, min-ray and max-ray
// gates and the clip; the endpoint voxel floor((c - m) / res); the box-exit
// parameter, distance and voxel for rays that leave the scan's box; the
// packed value 2000 + range (a hit) or 1000 + range (a free seed); the flat
// index k * BX*BY*BZ + lin_w, or K * BX*BY*BZ for a ray that fails the
// gates.  Scalars the plain version takes from Python doubles arrive
// rounded to f32 as PyTorch rounds them (max_ray + res and bx * res summed
// in double, then rounded).  torch.minimum and torch.clamp propagate NaN,
// and float -> int32 is the card's saturating truncation (NaN -> 0), as
// PyTorch's .to(torch.int32) is; int32 differences wrap as PyTorch's do.
// The box-exit terms are computed only for rays outside the box: the plain
// version computes them for every ray and torch.where drops them for the
// others, so the values kept are the same.
//
// The scan is blockIdx.y.  Threads 0-2 of every block place the scan's box
// along one axis each (half-to-even round, the face clamp, the floor to a
// multiple of 8 before the second clamp on aligned grids) into shared
// memory, and block 0 writes starts and po_box; the rays' loads are in
// flight meanwhile.
//
// Bound: bytes.  A ray reads 3 f32 and its valid byte and writes lin
// (i32), val (f32) and rvalid (u8): 22 bytes, 20.3 MB for the cow tick of
// 3 x 307 200 rays, 6.1 us at 3.35 TB/s.  One ray a thread; the rays of a
// warp are neighbours, so the loads and stores coalesce ([K,P,3] points:
// three 4-byte loads 12 bytes apart a thread).

#include "fiesta_kernels.cuh"

namespace {

constexpr int kPrepThreads = 256;

struct PrepParams {
  long long p;            // rays a scan
  long long scan_stride;  // elements between two scans of a component
  int ps;                 // elements between two rays of a component
  int g[3], b[3], ex[3];  // grid, carve box, placement extent min(g, 2r+1)
  int aligned;            // x/y box corners floored to multiples of 8
  int nb, drop;           // BX*BY*BZ, and the dropped rays' index K*nb
  float m[3];             // the map's origin
  float res, min_ray, max_ray, eps, half_res, max_res;
  float bres[3];          // b[j] * res
};

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// torch.clamp(v, min=lo), NaN kept
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.minimum, NaN kept
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// floor(x).to(torch.int32) on the card
__device__ __forceinline__ int floor_i32(float x) { return (int)floorf(x); }

// The exit parameter of ray u from o toward the box's face [lo, hi] along
// one axis (t_axis): the division by a divisor kept off zero.
__device__ __forceinline__ float t_axis(float u, float lo, float hi,
                                        float o, float eps) {
  const float safe = fabsf(u) < eps ? eps : u;
  return u > 0.0f ? (hi - o) / safe : (lo - o) / safe;
}

// The box corner along axis j for the sensor coordinate o (_box_starts);
// also returns the sensor's grid position po_grid.  j must be a constant
// after unrolling: a dynamic index into the parameters would copy them to
// local memory, a thread.
__device__ __forceinline__ int box_start(int j, float o, const PrepParams& p,
                                         float& pg) {
  pg = (o - p.m[j]) / p.res - 0.5f;
  int u = wrap_sub((int)rintf(pg), p.ex[j] / 2);
  u = clamp_int(u, 0, p.g[j] - p.ex[j]);
  if (p.aligned && j < 2) u = (u / 8) * 8;  // u >= 0 here
  return clamp_int(u, 0, p.g[j] - p.b[j]);
}

}  // namespace

__global__ void __launch_bounds__(kPrepThreads)
    prep_kernel(const float* __restrict__ px, const float* __restrict__ py,
                const float* __restrict__ pz,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ origins,
                const float* __restrict__ transforms, PrepParams p,
                int* __restrict__ starts, float* __restrict__ po_box,
                int* __restrict__ lin, float* __restrict__ val,
                uint8_t* __restrict__ rvalid) {
  __shared__ int s_start[3];
  const int k = blockIdx.y;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < p.p;
  const long long e = (long long)k * p.scan_stride + i * p.ps;
  const long long r = (long long)k * p.p + i;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  bool ok = false;
  if (live) {
    x = px[e];
    y = py[e];
    z = pz[e];
    ok = valid[r] != 0;
  }
  // the scan's sensor: the transform's translation, or the given origin
  const float* tf = transforms ? transforms + 16 * k : nullptr;
  const float o0 = tf ? __ldg(tf + 3) : __ldg(origins + 3 * k);
  const float o1 = tf ? __ldg(tf + 7) : __ldg(origins + 3 * k + 1);
  const float o2 = tf ? __ldg(tf + 11) : __ldg(origins + 3 * k + 2);
  const float o[3] = {o0, o1, o2};
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (threadIdx.x == j) {
      float pg;
      const int u = box_start(j, o[j], p, pg);
      s_start[j] = u;
      if (blockIdx.x == 0) {
        starts[3 * k + j] = u;
        po_box[3 * k + j] = pg - (float)u;
      }
    }
  __syncthreads();
  if (!live) return;
  if (tf) {  // sensor frame -> world: ((px r0 + py r1) + pz r2) + t
    float w[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      w[a] = ((x * __ldg(tf + 4 * a) + y * __ldg(tf + 4 * a + 1)) +
              z * __ldg(tf + 4 * a + 2)) +
             __ldg(tf + 4 * a + 3);
    x = w[0];
    y = w[1];
    z = w[2];
  }
  const int sx = s_start[0], sy = s_start[1], sz = s_start[2];

  // length gates and max-ray clipping
  ok = ok && isfinite(x) && isfinite(y) && isfinite(z);
  const float dx = x - o0, dy = y - o1, dz = z - o2;
  const float length = sqrtf(dx * dx + dy * dy + dz * dz);
  const bool rv = ok && length >= p.min_ray;
  const bool is_hit = length <= p.max_ray;
  const float scale =
      is_hit ? 1.0f : p.max_ray / clamp_min_nan(length, p.eps);
  const float cx = o0 + dx * scale, cy = o1 + dy * scale,
              cz = o2 + dz * scale;

  // endpoint voxel in box coordinates
  const int vx = floor_i32((cx - p.m[0]) / p.res);
  const int vy = floor_i32((cy - p.m[1]) / p.res);
  const int vz = floor_i32((cz - p.m[2]) / p.res);
  int vbx = wrap_sub(vx, sx), vby = wrap_sub(vy, sy), vbz = wrap_sub(vz, sz);
  const bool inside = vbx >= 0 && vbx < p.b[0] && vby >= 0 &&
                      vby < p.b[1] && vbz >= 0 && vbz < p.b[2] &&
                      vx >= 0 && vx < p.g[0] && vy >= 0 && vy < p.g[1] &&
                      vz >= 0 && vz < p.g[2];
  float packed;
  if (inside) {
    packed = is_hit ? length + 2000.0f : p.max_res + 1000.0f;
  } else {
    // box-exit clip for a ray that leaves the box
    const float lwx = (float)sx * p.res + p.m[0];
    const float lwy = (float)sy * p.res + p.m[1];
    const float lwz = (float)sz * p.res + p.m[2];
    const float ux = cx - o0, uy = cy - o1, uz = cz - o2;
    float s = min_nan(min_nan(t_axis(ux, lwx, lwx + p.bres[0], o0, p.eps),
                              t_axis(uy, lwy, lwy + p.bres[1], o1, p.eps)),
                      t_axis(uz, lwz, lwz + p.bres[2], o2, p.eps));
    s = isnan(s) ? s : fminf(fmaxf(s, 0.0f), 1.0f);
    const float ulen = sqrtf(ux * ux + uy * uy + uz * uz);
    const float exit_dist = s * ulen - p.half_res;
    const float f = exit_dist / clamp_min_nan(ulen, p.eps);
    vbx = clamp_int(wrap_sub(floor_i32(((o0 + ux * f) - p.m[0]) / p.res), sx),
                    0, p.b[0] - 1);
    vby = clamp_int(wrap_sub(floor_i32(((o1 + uy * f) - p.m[1]) / p.res), sy),
                    0, p.b[1] - 1);
    vbz = clamp_int(wrap_sub(floor_i32(((o2 + uz * f) - p.m[2]) / p.res), sz),
                    0, p.b[2] - 1);
    packed = (exit_dist + p.res) + 1000.0f;
  }
  const int lin_w = vbx * (p.b[1] * p.b[2]) + vby * p.b[2] + vbz;
  lin[r] = rv ? lin_w + k * p.nb : p.drop;
  val[r] = packed;
  rvalid[r] = rv;
}

FIESTA_EXPORT int fiesta_prep(
    const float* px, const float* py, const float* pz, int ps,
    const uint8_t* valid, const float* origins, const float* transforms,
    int k, long long p, int gx, int gy, int gz, int bx, int by, int bz,
    int ex0, int ex1, int ex2, int aligned, float mx, float my, float mz,
    float res, float min_ray, float max_ray, float eps, float half_res,
    float bxr, float byr, float bzr, float max_res, int* starts,
    float* po_box, int* lin, float* val, uint8_t* rvalid,
    cudaStream_t stream) {
  const long long nb = (long long)bx * by * bz;
  const long long blocks = (p + kPrepThreads - 1) / kPrepThreads;
  if (k < 0 || k > 65535 || p < 0 || (ps != 1 && ps != 3) ||
      blocks > INT32_MAX || bx <= 0 || by <= 0 || bz <= 0 ||
      (long long)k * nb >= (1LL << 31) || (k && !transforms && !origins))
    return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  const PrepParams prm{p, ps == 3 ? 3 * p : p, ps,
                       {gx, gy, gz}, {bx, by, bz}, {ex0, ex1, ex2},
                       aligned, (int)nb, (int)(k * nb),
                       {mx, my, mz}, res, min_ray, max_ray, eps, half_res,
                       max_res, {bxr, byr, bzr}};
  // one block at least: it writes the scans' starts and po_box
  prep_kernel<<<dim3((unsigned)(blocks ? blocks : 1), (unsigned)k),
                kPrepThreads, 0, stream>>>(px, py, pz, valid, origins,
                                           transforms, prm, starts, po_box,
                                           lin, val, rvalid);
  FIESTA_LAUNCH_CHECK();
  return 0;
}
