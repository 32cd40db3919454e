// The incremental ESDF's relaxation, swept to its fixpoint in one
// cooperative launch.
//
// Replaces fiesta_tpu/ops/esdf.py relax_to_fixpoint (:187), which has no
// Pallas kernel: XLA fuses each sweep of relax_once (:127) into a few
// passes and runs the loop on the device (lax.while_loop, a device-resident
// "anything changed" predicate).  In plain PyTorch a sweep is about twelve
// elementwise launches per direction (≈ 650 at cow_and_lady's 54), and a
// host loop on "changed" would wait for the device every sweep; this kernel
// runs every sweep of a call inside ONE launch and reads nothing back.
//
// One sweep is the JAX Jacobi sweep: every voxel v reads (d2, closest) from
// one buffer and writes its result to the other.  Its candidates are
// |v - closest[v + d]|^2 (int32) over the directions d, in consideration
// order (every offset of reach <= 2 in the caller's order, then the longer
// axis jumps in the caller's order: the wrapper orders the table), a
// neighbour outside the grid, hidden by the source mask or with an
// undefined closest being skipped; a candidate wins only when strictly
// smaller, so ties go to the first direction in that order.  Where the push
// receiver mask holds, a second pull from the same unchanged state reads
// only push-source neighbours and replaces the first when strictly smaller;
// voxels outside the update mask keep their values.  Masks are u8, null
// when absent.
//
// Sweeps alternate between two buffers (sweep 0 reads the input and writes
// the output; later sweeps ping-pong between the output and a scratch), with
// a grid-wide barrier after each.  "Anything changed" is one device word
// holding the last sweep index (+1) in which some voxel's d2 fell: stamps
// only grow, so it never needs clearing between sweeps, and a block that
// reads a later stamp than its own sweep's knows that its sweep changed
// something (no block starts a sweep unless the one before changed).  The
// loop ends when a sweep changed nothing, or after max_iters sweeps when
// max_iters > 0; the sweep count goes to state[1].  When the last sweep
// wrote the scratch, it is copied into the output.
//
// Bound: operations.  A sweep does about twelve int32 operations per
// direction and voxel (≈ 8.3 G at cow_and_lady's 12.8 M voxels and 54
// directions, ≈ 0.5 ms at the card's int32 rate) against ≈ 25 bytes a
// voxel of state and masks (≈ 0.1 ms).  This first form reads every
// neighbour's closest coordinates through L1/L2 (grid.sync's fences keep the
// ping-pong buffers coherent: no read-only-cache loads of them); tiling the
// reach-2 neighbourhood in shared memory is later work.

#include <cooperative_groups.h>

#include "fiesta_kernels.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDirs = 128;  // directions a call, at most
constexpr int kThreads = 256;

// The direction table, by value in the launch's parameters.
struct RelaxDirs {
  short d[3][kMaxDirs];
  int n;
};

struct RelaxMasks {
  const unsigned char* update;
  const unsigned char* source;
  const unsigned char* push_src;
  const unsigned char* push_recv;
};

// Pull the best candidate for voxel (x, y, z) from its neighbours' closest
// planes `c` (plane stride `plane`), reading only neighbours where `src`
// (if given) is set; `sd` holds the n directions' x, y and z offsets at
// 0, kMaxDirs and 2 * kMaxDirs.
__device__ __forceinline__ void pull(const short* c, int plane,
                                     const unsigned char* __restrict__ src,
                                     int x, int y, int z, int gx, int gy,
                                     int gz, const short* sd, int n,
                                     int& best, short& bx, short& by,
                                     short& bz) {
  const int yz = gy * gz;
  for (int k = 0; k < n; ++k) {
    const int nx = x + sd[k], ny = y + sd[kMaxDirs + k],
              nz = z + sd[2 * kMaxDirs + k];
    if ((unsigned)nx >= (unsigned)gx || (unsigned)ny >= (unsigned)gy ||
        (unsigned)nz >= (unsigned)gz)
      continue;
    const int q = nx * yz + ny * gz + nz;
    if (src && !src[q]) continue;
    const short cx = c[q];
    if (cx < 0) continue;
    const short cy = c[plane + q], cz = c[2 * plane + q];
    const int ex = x - cx, ey = y - cy, ez = z - cz;
    const int cand = ex * ex + ey * ey + ez * ez;
    if (cand < best) {
      best = cand;
      bx = cx;
      by = cy;
      bz = cz;
    }
  }
}

}  // namespace

// Outside the anonymous namespace, so that the profiler lists it by name.
__global__ void __launch_bounds__(kThreads)
    relax_sweeps(const int* d2_in, const short* c_in, int* d2_out,
                 short* c_out, int* d2_scr, short* c_scr, RelaxMasks m,
                 int gx, int gy, int gz, int max_iters, int* state,
                 RelaxDirs dirs) {
  __shared__ short sd[3 * kMaxDirs];
  for (int i = threadIdx.x; i < 3 * kMaxDirs; i += blockDim.x)
    sd[i] = (&dirs.d[0][0])[i];
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0 && threadIdx.x == 0) state[0] = 0;
  __syncthreads();
  grid.sync();
  const int yz = gy * gz, nvox = gx * yz;
  const int stride = gridDim.x * blockDim.x;
  const int n = dirs.n;
  const int* d2r = d2_in;
  const short* cr = c_in;
  int it = 0;
  for (;;) {
    int* d2w = (it & 1) ? d2_scr : d2_out;
    short* cw = (it & 1) ? c_scr : c_out;
    bool changed = false;
    for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < nvox;
         v += stride) {
      const int d0 = d2r[v];
      short bx = cr[v], by = cr[nvox + v], bz = cr[2 * nvox + v];
      int best = d0;
      if (!m.update || m.update[v]) {
        const int x = v / yz, r = v - x * yz, y = r / gz, z = r - y * gz;
        pull(cr, nvox, m.source, x, y, z, gx, gy, gz, sd, n, best, bx, by,
             bz);
        if (m.push_src && m.push_recv[v]) {
          int pb = d0;
          short px = cr[v], py = cr[nvox + v], pz = cr[2 * nvox + v];
          pull(cr, nvox, m.push_src, x, y, z, gx, gy, gz, sd, n, pb, px, py,
               pz);
          if (pb < best) {
            best = pb;
            bx = px;
            by = py;
            bz = pz;
          }
        }
      }
      changed |= best < d0;
      d2w[v] = best;
      cw[v] = bx;
      cw[nvox + v] = by;
      cw[2 * nvox + v] = bz;
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0)
      atomicMax(state, it + 1);
    grid.sync();
    ++it;
    const int last = *(volatile int*)state;
    if (last < it || (max_iters > 0 && it >= max_iters)) break;
    d2r = d2w;
    cr = cw;
  }
  if (!(it & 1)) {  // the last sweep wrote the scratch
    for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < nvox;
         v += stride) {
      d2_out[v] = d2_scr[v];
      c_out[v] = c_scr[v];
      c_out[nvox + v] = c_scr[nvox + v];
      c_out[2 * nvox + v] = c_scr[2 * nvox + v];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) state[1] = it;
}

// Blocks the card holds at once, for the cooperative grid (asked once per
// device).
static cudaError_t resident_blocks(long long* out) {
  static long long cached[kFiestaMaxDevices];
  int device, sms, per_sm;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kFiestaMaxDevices && cached[device]) {
    *out = cached[device];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, relax_sweeps,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  *out = (long long)sms * per_sm;
  if (device < kFiestaMaxDevices) cached[device] = *out;
  return cudaSuccess;
}

// d2 [X,Y,Z] i32 and closest [3,X,Y,Z] i16 in; d2_out / c_out the result,
// d2_scr / c_scr scratch of the same shapes; masks u8 [X,Y,Z] or null (the
// push masks both or neither); dirs [3][ndirs] i16 in consideration order
// (host memory, copied into the launch); state [2] i32 scratch, state[1] the
// sweep count on return.  X*Y*Z < 2^31, every axis < 2^15, ndirs <= 128
// (the wrapper checks).
FIESTA_EXPORT int fiesta_relax(const int* d2_in, const short* c_in,
                               int* d2_out, short* c_out, int* d2_scr,
                               short* c_scr, const unsigned char* update,
                               const unsigned char* source,
                               const unsigned char* push_src,
                               const unsigned char* push_recv, int gx, int gy,
                               int gz, const short* dirs, int ndirs,
                               int max_iters, int* state,
                               cudaStream_t stream) {
  if (ndirs < 0 || ndirs > kMaxDirs || (!push_src != !push_recv))
    return (int)cudaErrorInvalidValue;
  RelaxDirs table = {};
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < ndirs; ++k) table.d[a][k] = dirs[a * ndirs + k];
  table.n = ndirs;
  RelaxMasks m = {update, source, push_src, push_recv};
  long long resident;
  const cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return (int)err;
  const long long nvox = (long long)gx * gy * gz;
  long long blocks = (nvox + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  void* args[] = {&d2_in, &c_in, &d2_out, &c_out, &d2_scr, &c_scr, &m,
                  &gx,    &gy,   &gz,     &max_iters, &state, &table};
  return (int)cudaLaunchCooperativeKernel((const void*)relax_sweeps,
                                          (unsigned)blocks, kThreads, args, 0,
                                          stream);
}
