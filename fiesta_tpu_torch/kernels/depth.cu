// Depth images -> camera-frame rays with the temporal consistency filter,
// for all K frames of a tick in one launch.
//
// Replaces no TPU kernel: in the JAX package the conversion
// (fiesta_tpu/ops/depth.py depth_to_cloud_components) is jnp ops that XLA
// fuses.  On the card the same function as plain PyTorch ops, one frame at
// a time, issued 508 launches a demo tick (3 frames of 480x640), most of
// them the 4x4 elimination of last_T^-1 @ T on single elements, and the
// tick's host time went to enqueueing them.
//
// Per pixel, the plain version's arithmetic op for op in f32 (built with
// -fmad=false and IEEE division, so nothing contracts or approximates):
// x = (u - cx) * d / fx, y likewise; valid = isfinite(d), and with the
// filter the margin crop, the [min, max] depth gates, the reprojection
// through rel = last_T^-1 @ T (sums left to right), the image test, the
// nearest previous pixel (truncation toward zero) and |prev - z| < tol.
// Frame i's predecessor is frame i - 1, or prev_depth / prev_transform for
// i = 0; every input exists at launch, so the chain costs nothing.  z is
// the depth itself, which the caller views without a copy.
//
// Bound: bytes.  A pixel reads its depth and, where it survives the gates,
// one previous depth, and writes x, y and valid: 17 bytes, 15.7 MB for the
// demo tick, 4.7 us at 3.35 TB/s.  The frame is blockIdx.y; a thread takes
// four neighbouring pixels with 16-byte loads and stores (4-byte valid
// store) where the frame's pixel count and the pointers allow, else one
// at a time.  One thread of each block solves the frame's rel into shared
// memory, the elimination of ops/depth.py _solve step for step (first
// largest pivot, NaN counting as largest as torch.argmax does, every row
// updated from the pivot row as it was), while the block's depth loads
// are in flight: ~150 f32 operations in registers, cheaper than a second
// launch, but every pixel of the block waits on its latency.  The
// previous-frame gather goes through the read-only path.

#include "fiesta_kernels.cuh"

namespace {

constexpr int kDepthThreads = 256;
constexpr int kDepthPix = 4;  // neighbouring pixels a thread

struct DepthParams {
  float cx, cy, fx, fy, dmin, dmax, tol;
  int h, w, margin, use_filter;
  long long hw;
};

// rel = a^-1 @ b for row-major 4x4 a, b, as ops/depth.py _solve computes
// it in tensor ops: partial pivoting, then back substitution.  Unrolled
// whole, so every entry lives in a register and the 32 loads go out
// together; the row swap is a select per entry.
__device__ __forceinline__ void solve4(const float* __restrict__ a_in,
                                       const float* __restrict__ b_in,
                                       float* rel) {
  float a[4][4], b[4][4];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    a[e / 4][e % 4] = __ldg(a_in + e);
    b[e / 4][e % 4] = __ldg(b_in + e);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // argmax over where(rows >= j, |a[:, j]|, -1): the first largest
    int p = j;
    float best = fabsf(a[j][j]);
#pragma unroll
    for (int i = j + 1; i < 4; ++i) {
      const float c = fabsf(a[i][j]);
      if (!isnan(best) && (isnan(c) || c > best)) {
        best = c;
        p = i;
      }
    }
#pragma unroll
    for (int i = j + 1; i < 4; ++i) {  // rows j and p trade places
      const bool swap = p == i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float ta = a[j][c], tb = b[j][c];
        a[j][c] = swap ? a[i][c] : ta;
        a[i][c] = swap ? ta : a[i][c];
        b[j][c] = swap ? b[i][c] : tb;
        b[i][c] = swap ? tb : b[i][c];
      }
    }
    float f[4], aj[4], bj[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = i > j ? a[i][j] / a[j][j] : 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      aj[c] = a[j][c];
      bj[c] = b[j][c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)  // a - f[:, None] * a[j], row j included
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        a[i][c] = a[i][c] - f[i] * aj[c];
        b[i][c] = b[i][c] - f[i] * bj[c];
      }
  }
  float x[4][4];
#pragma unroll
  for (int i = 3; i >= 0; --i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = b[i][c];
#pragma unroll
      for (int k = i + 1; k < 4; ++k) acc = acc - a[i][k] * x[k][c];
      x[i][c] = acc / a[i][i];
      rel[4 * i + c] = x[i][c];
    }
}

// One pixel (u, v) of depth d: writes x, y and returns valid.
__device__ __forceinline__ bool depth_pixel(float d, int u, int v,
                                            const DepthParams& p,
                                            const float* __restrict__ r,
                                            const float* __restrict__ prev,
                                            float& x, float& y) {
  x = ((float)u - p.cx) * d / p.fx;
  y = ((float)v - p.cy) * d / p.fy;
  bool ok = isfinite(d);
  if (!p.use_filter) return ok;
  if (p.margin > 0)
    ok = ok && u >= p.margin && u < p.w - p.margin && v >= p.margin &&
         v < p.h - p.margin;
  ok = ok && d >= p.dmin && d <= p.dmax;
  if (!ok) return false;  // the rest can only clear it
  const float c0 = r[0] * x + r[1] * y + r[2] * d + r[3];
  const float c1 = r[4] * x + r[5] * y + r[6] * d + r[7];
  const float c2 = r[8] * x + r[9] * y + r[10] * d + r[11];
  const float c3 = r[12] * x + r[13] * y + r[14] * d + r[15];
  const float cz = c2 / c3;
  const float uu = (c0 / c3) * p.fx / cz + p.cx;
  const float vv = (c1 / c3) * p.fy / cz + p.cy;
  if (!(uu >= 0.0f && uu < (float)p.w && vv >= 0.0f && vv < (float)p.h))
    return false;
  const float before = __ldg(prev + (long long)(int)vv * p.w + (int)uu);
  return fabsf(before - cz) < p.tol;
}

}  // namespace

__global__ void __launch_bounds__(kDepthThreads)
    depth_kernel(const float* __restrict__ depths,
                 const float* __restrict__ transforms,
                 const float* __restrict__ prev_depth,
                 const float* __restrict__ prev_transform, DepthParams p,
                 int vec, float* __restrict__ px, float* __restrict__ py,
                 uint8_t* __restrict__ valid) {
  __shared__ float rel[16];
  const int k = blockIdx.y;
  const long long off = (long long)k * p.hw;
  const long long e0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kDepthPix;
  float d[kDepthPix];
  if (vec && e0 < p.hw) {
    const float4 q = *reinterpret_cast<const float4*>(depths + off + e0);
    d[0] = q.x;
    d[1] = q.y;
    d[2] = q.z;
    d[3] = q.w;
  } else {
    for (int j = 0; j < kDepthPix; ++j)
      d[j] = e0 + j < p.hw ? depths[off + e0 + j] : 0.0f;
  }
  const float* prev = nullptr;
  if (p.use_filter) {
    if (threadIdx.x == 0)
      solve4(k ? transforms + 16 * (k - 1) : prev_transform,
             transforms + 16 * k, rel);
    __syncthreads();
    prev = k ? depths + off - p.hw : prev_depth;
  }
  if (e0 >= p.hw) return;
  int v = (int)(e0 / p.w), u = (int)(e0 - (long long)v * p.w);
  float x[kDepthPix], y[kDepthPix];
  bool ok[kDepthPix];
  for (int j = 0; j < kDepthPix; ++j) {
    ok[j] = e0 + j < p.hw &&
            depth_pixel(d[j], u, v, p, rel, prev, x[j], y[j]);
    if (++u == p.w) {
      u = 0;
      ++v;
    }
  }
  if (vec) {
    *reinterpret_cast<float4*>(px + off + e0) =
        make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(py + off + e0) =
        make_float4(y[0], y[1], y[2], y[3]);
    *reinterpret_cast<uint32_t*>(valid + off + e0) =
        (uint32_t)ok[0] | (uint32_t)ok[1] << 8 | (uint32_t)ok[2] << 16 |
        (uint32_t)ok[3] << 24;
    return;
  }
  for (int j = 0; j < kDepthPix; ++j)
    if (e0 + j < p.hw) {
      px[off + e0 + j] = x[j];
      py[off + e0 + j] = y[j];
      valid[off + e0 + j] = ok[j];
    }
}

FIESTA_EXPORT int fiesta_depth(const float* depths, const float* transforms,
                               const float* prev_depth,
                               const float* prev_transform, int k, int h,
                               int w, float cx, float cy, float fx, float fy,
                               float dmin, float dmax, float tol,
                               int use_filter, int margin, float* px,
                               float* py, uint8_t* valid,
                               cudaStream_t stream) {
  const long long hw = (long long)h * w;
  const long long groups = (hw + kDepthPix - 1) / kDepthPix;
  const long long blocks = (groups + kDepthThreads - 1) / kDepthThreads;
  if (k < 0 || k > 65535 || h < 0 || w < 0 || blocks > INT32_MAX ||
      (use_filter && k && (!transforms || !prev_depth || !prev_transform)))
    return (int)cudaErrorInvalidValue;
  if (k == 0 || hw == 0) return 0;
  const DepthParams p{cx, cy, fx, fy, dmin, dmax, tol, h, w, margin,
                      use_filter, hw};
  // every frame starts 16-byte aligned when the pixel count is a multiple
  // of four and the buffers are
  const int vec = hw % kDepthPix == 0 &&
      (((uintptr_t)depths | (uintptr_t)px | (uintptr_t)py) & 15) == 0 &&
      ((uintptr_t)valid & 3) == 0;
  depth_kernel<<<dim3((unsigned)blocks, (unsigned)k), kDepthThreads, 0,
                 stream>>>(depths, transforms, prev_depth, prev_transform, p,
                           vec, px, py, valid);
  FIESTA_LAUNCH_CHECK();
  return 0;
}
