// The incremental ESDF's relaxation, swept to its fixpoint in one
// cooperative launch: a frontier of tiles, a changed-neighbour pull and a
// shared-memory halo tile.
//
// Replaces fiesta_tpu/ops/esdf.py relax_to_fixpoint (:187), which has no
// Pallas kernel: XLA fuses each sweep of relax_once (:127) into a few
// passes and runs the loop on the device (lax.while_loop, a device-resident
// "anything changed" predicate).  This kernel runs every sweep of a call
// inside ONE launch and reads nothing back.
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
// when absent.  The grid may be an X-slab of a larger one: its first plane
// then sits at global x = x_offset, which the candidates add to the voxel's
// own x (the closest coordinates are global), as
// fiesta_tpu/parallel/sharding.py _relax_once_local does (:141-142);
// bounds and neighbours stay the slab's own.
//
// What a sweep skips.  With fixed masks a sweep maps (d2, closest) to the
// least of its own value and its neighbours' candidates, so once v has
// read a neighbour u, v's d2 stays <= u's candidate until u changes: a
// neighbour that did not change in the sweep before cannot win, not even a
// tie.  Hence (a) only tiles with a neighbour that changed can change, and
// (b) inside them only the candidates of changed neighbours need computing;
// the winners, the tie order and the sweep count stay the dense sweep's.
// The first sweep is dense (its input is no fixpoint).
// - The grid is cut into tiles of 8 x 8 x 16 voxels (z contiguous;
//   RELAX_TILE), each visited by one block of 256 threads, 4 voxels each.
//   A tile in which a voxel lowered in sweep k - 1 raises, by atomicMax,
//   the stamps of every tile that holds a receiver u - d of one of its
//   voxels u, and its own (the host's table of tile offsets,
//   kernels.relax_tile_offsets), to k; the block that raises a stamp
//   appends the tile to sweep k's list, so each tile is listed once.
//   Blocks take the listed tiles one at a time from a counter (active
//   tiles cluster, so coarser shares would leave blocks idle).  Stamps
//   only grow, and the three lists and counters rotate by sweep modulo
//   3, so nothing is cleared while another block may read it.
// - Each voxel that a sweep visits writes whether it lowered into a bit of
//   that sweep's parity (a u16 per z row of a tile, by warp ballot), and a
//   tile with a change writes the sweep index into its changed stamp of
//   that parity.  Sweep k reads parity k - 1 and trusts a tile's bits only
//   when its stamp says k - 1: a tile skipped in sweep k - 1 keeps older
//   bits, which would cost work, not exactness.
// - Two buffers of packed words, one 8-byte word a voxel: closest x, y, z
//   and two flags, "a defined source" and "a defined push source" (the
//   masks folded in), so a neighbour costs one load and no mask.  The
//   input is packed into the first before sweep 0; sweep k reads buffer
//   k % 2 (and d2 buffer k % 2) and writes the other only in the tiles it
//   visits.  A tile that changed is visited in the next sweep too, so a
//   skipped tile's other buffer holds its current values.  The last
//   buffer written is unpacked into the output.
// - The block loads the tile's reach-2 halo of the read buffer into shared
//   memory, (8+4)(8+4)(16+4) words, cells outside the grid without flags:
//   the reach <= 2 candidates take no bounds test and no mask load, and
//   their loop is unrolled at compile time for each stencil of
//   config.STENCILS (the caller's table is matched on the host; any other
//   table takes a loop over shared memory).  The changed bits of the halo
//   sit beside it (one 20-bit word per halo row).  The jumps take one u16
//   of changed bits per (jump, row) in shared memory, built from the bits
//   of the two tiles each jump reads, and load a changed neighbour's word
//   from device memory: the voxels' running bests wait in shared memory
//   while each thread keeps two jumps' words for its four voxels in
//   flight.  The block's state is specialised for the push pass or none.
// - Coherence: the buffers, bits and stamps are written inside the launch,
//   so they are read with ld.global.cg (L2; never the read-only path) after
//   grid.sync().  "Anything changed" is a device word holding the last
//   sweep index (+1) in which some d2 fell; the loop ends when a sweep
//   changed nothing, or after max_iters sweeps when max_iters > 0; the
//   sweep count goes to state[1], the blocks of the cooperative grid to
//   state[2] and the tiles visited in sweep k (the first `log_sweeps`) to
//   state[3 + k].
//
// Bound: operations in the dense first sweep (about twelve int32
// operations a direction and voxel: ≈ 0.5 ms at cow_and_lady's 12.8 M
// voxels and 54 directions), then the candidates of changed neighbours
// (chip_smoke.py's frontier bound).  The design's own extra work, a bit
// test a direction for each voxel of a visited tile and the bytes those
// tiles move, is reported beside it, not in it.

#include <cooperative_groups.h>

#include "fiesta_kernels.cuh"

namespace cg = cooperative_groups;

// Reach <= 2 parts of config.STENCILS, in their order there.
#define FIESTA_FACES(X) \
  X(-1, 0, 0) X(1, 0, 0) X(0, -1, 0) X(0, 1, 0) X(0, 0, -1) X(0, 0, 1)
#define FIESTA_EDGES(X)                                                  \
  X(-1, -1, 0) X(1, 1, 0) X(0, -1, -1) X(0, 1, 1) X(-1, 0, -1) X(1, 0, 1) \
  X(-1, 1, 0) X(1, -1, 0) X(0, -1, 1) X(0, 1, -1) X(1, 0, -1) X(-1, 0, 1)
#define FIESTA_CORNERS(X)                                                  \
  X(-1, -1, -1) X(1, 1, 1) X(-1, -1, 1) X(1, 1, -1) X(-1, 1, -1) X(1, -1, 1) \
  X(1, -1, -1) X(-1, 1, 1)
#define FIESTA_FACES2(X) \
  X(-2, 0, 0) X(2, 0, 0) X(0, -2, 0) X(0, 2, 0) X(0, 0, -2) X(0, 0, 2)
#define FIESTA_KNIGHTS(X)                                                  \
  X(-2, -1, 0) X(2, 1, 0) X(0, -2, -1) X(0, 2, 1) X(-2, 0, -1) X(2, 0, 1)   \
  X(-2, 1, 0) X(2, -1, 0) X(0, -2, 1) X(0, 2, -1) X(2, 0, -1) X(-2, 0, 1)   \
  X(-1, -2, 0) X(1, 2, 0) X(0, -1, -2) X(0, 1, 2) X(-1, 0, -2) X(1, 0, 2)   \
  X(-1, 2, 0) X(1, -2, 0) X(0, -1, 2) X(0, 1, -2) X(1, 0, -2) X(-1, 0, 2)
#define FIESTA_STENCIL_6(X) FIESTA_FACES(X)
#define FIESTA_STENCIL_18(X) FIESTA_FACES(X) FIESTA_EDGES(X)
#define FIESTA_STENCIL_26(X) FIESTA_FACES(X) FIESTA_EDGES(X) FIESTA_CORNERS(X)
#define FIESTA_STENCIL_24(X) FIESTA_FACES(X) FIESTA_EDGES(X) FIESTA_FACES2(X)
#define FIESTA_STENCIL_32(X) \
  FIESTA_FACES(X) FIESTA_EDGES(X) FIESTA_FACES2(X) FIESTA_CORNERS(X)
// the ±3 faces of the 62-stencil have reach 3: they are jumps
#define FIESTA_STENCIL_62(X)                                          \
  FIESTA_FACES(X) FIESTA_EDGES(X) FIESTA_CORNERS(X) FIESTA_FACES2(X) \
  FIESTA_KNIGHTS(X)

namespace {

constexpr int kTX = 8, kTY = 8, kTZ = 16;  // the tile (RELAX_TILE)
constexpr int kRows = kTX * kTY;           // its z rows
constexpr int kHX = kTX + 4, kHY = kTY + 4, kHZ = kTZ + 4;  // reach-2 halo
constexpr int kHalo = kHX * kHY * kHZ;
constexpr int kThreads = 256;
// Launch bounds of 4 blocks an SM cap a thread at 64 registers (some
// spilled).  At cow_and_lady 4 blocks are then resident (≈ 44 KB of
// shared memory a block), 3 with the push masks (≈ 56 KB); caps of 80
// and 128 registers hold 3 and 2.  On an H100 the 64-register code ran
// faster on the global calls; with the push masks, at 3 blocks either
// way, the 80-register code ran 3-4 % faster on the longest call.
constexpr int kMinBlocks = 4;
constexpr int kPerThread = kTX * kTY * kTZ / kThreads;
constexpr int kMaxDirs = 128;       // directions a call, at most
constexpr int kMaxTileOffs = 320;   // RELAX_MAX_TILE_OFFSETS
constexpr unsigned long long kCoords = 0xFFFFFFFFFFFFull;  // x, y, z
static_assert(kTX == 8 && kTY == 8 && kTZ == 16,
              "tile coordinates are shifts; a z row's bits are one u16");
static_assert(kPerThread * kThreads == kTX * kTY * kTZ, "whole tiles");
static_assert(kHZ <= 32, "a halo row's bits fit one word");
static_assert(kTZ % 2 == 0 && kHZ % 2 == 0, "halo rows in 16-byte pairs");

// The launch's tables and extents, by value in its parameters.
struct RelaxParams {
  short d[3][kMaxDirs];         // directions in consideration order
  short toff[3][kMaxTileOffs];  // tile offsets that a changed tile marks
  int n, nsmall, ntoff;         // directions, of them reach <= 2; offsets
  int gx, gy, gz, ntx, nty, ntz;
  int x_offset;                 // global x of the grid's first plane
  int max_iters, log_sweeps;
};

struct RelaxMasks {
  const unsigned char* update;
  const unsigned char* source;
  const unsigned char* push_src;
  const unsigned char* push_recv;
};

// Per-tile scratch: the activity stamp, the changed stamp of each sweep
// parity, and each parity's changed bits (a u16 per z row, row = lx*8+ly);
// per voxel, two buffers of packed closest words.
struct RelaxAux {
  int* stamp;                // [ntiles]
  int* chg;                  // [2][ntiles]
  unsigned short* bits;      // [2][ntiles][kRows]
  int* list;                 // [3][ntiles] the tiles of a sweep (k % 3)
  int* len;                  // [3] their count
  int* take;                 // [3] the tiles of the list taken
  unsigned long long* word;  // [2][voxels]
};

// The grid's extents in voxels and tiles, and the directions' counts.
struct Dims {
  int gx, gy, gz, ntx, nty, ntz, n, nsmall, x_offset;
};

// One sweep's buffers: read, write.
struct Sweep {
  const int* d2r;
  const unsigned long long* wr;
  int* d2w;
  unsigned long long* ww;
  int k;
};

struct Shared {
  unsigned long long* hc;  // [kHalo] the halo's packed words
  unsigned* hb;            // [kHX * kHY] changed bits of the halo rows
  unsigned short* jm;      // [jumps][kRows] the jumps' changed bits a row
  int* jlin;               // [jumps] the jumps' voxel index offsets
  unsigned char* jval;     // [jumps] bits of the (two) tiles a jump reads
  // each voxel's running best (pass 1, and the push pass when masked)
  int *best, *d0, *pbest;
  unsigned long long *bw, *pw;
  unsigned char* vf;       // 1: in the update mask, 2: a push receiver
};

// A voxel's packed word: closest x | y << 16 | z << 32 (each -1 where
// undefined) | flags << 48, flag 1 "a defined source", flag 2 "a defined
// push source" (the masks folded in).
__device__ __forceinline__ unsigned long long pack(int cx, int cy, int cz,
                                                   unsigned flags) {
  return (unsigned long long)(unsigned short)cx |
         (unsigned long long)(unsigned short)cy << 16 |
         (unsigned long long)(unsigned short)cz << 32 |
         (unsigned long long)flags << 48;
}

// The flags of voxel q when its closest is defined.
__device__ __forceinline__ unsigned mask_flags(const RelaxMasks& m, int q) {
  return (unsigned)(!m.source || m.source[q]) |
         (unsigned)(m.push_src && m.push_src[q]) << 1;
}

// Visit the reach <= 2 directions of stencil S in order (S = 0: the
// caller's table `sd`, n of them, in shared memory).
template <int S, class F>
__device__ __forceinline__ void for_small(const short (*sd)[kMaxDirs], int n,
                                          F&& f) {
#define FIESTA_CALL(a, b, c) f(a, b, c);
  if constexpr (S == 6) {
    FIESTA_STENCIL_6(FIESTA_CALL)
  } else if constexpr (S == 18) {
    FIESTA_STENCIL_18(FIESTA_CALL)
  } else if constexpr (S == 24) {
    FIESTA_STENCIL_24(FIESTA_CALL)
  } else if constexpr (S == 26) {
    FIESTA_STENCIL_26(FIESTA_CALL)
  } else if constexpr (S == 32) {
    FIESTA_STENCIL_32(FIESTA_CALL)
  } else if constexpr (S == 62) {
    FIESTA_STENCIL_62(FIESTA_CALL)
  } else {
    for (int k = 0; k < n; ++k) f(sd[0][k], sd[1][k], sd[2][k]);
  }
#undef FIESTA_CALL
}

// Take the candidate of neighbour word w for voxel (x, y, z) where it is
// strictly smaller: into pass 1 when w is a defined source, into the push
// pass when the voxel receives pushes and w is a defined push source.
__device__ __forceinline__ void consider(unsigned long long w, int x, int y,
                                         int z, bool recv, int& best,
                                         unsigned long long& bw, int& pb,
                                         unsigned long long& pw) {
  const unsigned f = (unsigned)(w >> 48);
  if (!f) return;
  const int ex = x - (int)(w & 0xFFFFu), ey = y - (int)((w >> 16) & 0xFFFFu),
            ez = z - (int)((w >> 32) & 0xFFFFu);
  const int cand = ex * ex + ey * ey + ez * ez;
  if ((f & 1u) && cand < best) {
    best = cand;
    bw = w & kCoords;
  }
  if (recv && (f & 2u) && cand < pb) {
    pb = cand;
    pw = w & kCoords;
  }
}

// Sweep s over tile t with stencil S: load the halo and the changed bits,
// pull every voxel's candidates from the changed neighbours, write the
// result and the voxels' changed bits.  Returns this thread's "some voxel
// lowered".  Each phase's loads are independent of each other, so a
// thread keeps several in flight.
template <int S, bool Push>
__device__ __forceinline__ bool relax_tile(int t, Sweep s, RelaxMasks m,
                                           RelaxAux a, Dims p, Shared sm,
                                           const short (*sd)[kMaxDirs],
                                           unsigned char* nbv,
                                           unsigned* jany) {
  const int tid = threadIdx.x, k = s.k, pr = (k - 1) & 1;
  const int gx = p.gx, gy = p.gy, gz = p.gz, yz = gy * gz;
  const int ntiles = p.ntx * p.nty * p.ntz;
  const int tz = t % p.ntz, tr = t / p.ntz, ty = tr % p.nty,
            tx = tr / p.nty;
  const int x0 = tx * kTX, y0 = ty * kTY, z0 = tz * kTZ;
  const int nj = p.n - p.nsmall;
  const int* chg_r = a.chg + pr * ntiles;
  const unsigned short* bits_r = a.bits + (long long)pr * ntiles * kRows;

  // which tiles' bits of sweep k - 1 to trust: the 27 around, and the two
  // tiles along its axis that each jump reads
  if (tid < 27) {
    const int ux = tx + tid / 9 - 1, uy = ty + tid / 3 % 3 - 1,
              uz = tz + tid % 3 - 1;
    bool ok = ux >= 0 && ux < p.ntx && uy >= 0 && uy < p.nty && uz >= 0 &&
              uz < p.ntz;
    if (ok && k > 0)
      ok = __ldcg(chg_r + (ux * p.nty + uy) * p.ntz + uz) == k - 1;
    nbv[tid] = ok;
  } else if (tid >= 32 && tid < 32 + nj && k > 0) {
    const int j = tid - 32, i = p.nsmall + j;
    const int ax = sd[0][i] ? 0 : sd[1][i] ? 1 : 2;
    const int shift = ax == 2 ? 4 : 3, n_ax = ax == 0 ? p.ntx
                                            : ax == 1 ? p.nty : p.ntz;
    const int org = ax == 0 ? x0 : ax == 1 ? y0 : z0;
    const int a0 = (org + sd[ax][i]) >> shift;  // floor
    const int stride = ax == 0 ? p.nty * p.ntz : ax == 1 ? p.ntz : 1;
    const int t0 = t + (a0 - (org >> shift)) * stride;
    unsigned v = 0;
    if (a0 >= 0 && a0 < n_ax && __ldcg(chg_r + t0) == k - 1) v |= 1;
    if (a0 + 1 >= 0 && a0 + 1 < n_ax && __ldcg(chg_r + t0 + stride) == k - 1)
      v |= 2;
    sm.jval[j] = (unsigned char)v;
  }
  if (tid < 4) jany[tid] = 0;
  // the halo's packed words.  With gz even, every halo row starts on an
  // even voxel, so pairs along z are 16-byte aligned: cp.async.cg copies
  // them into shared memory without registers, through L2 only (coherent
  // after grid.sync()), zero-filled outside the grid, while the block
  // reads the changed bits.  Else plain loads.
  if (!(gz & 1)) {
    for (int e = tid; e < kHalo / 2; e += kThreads) {
      const int hz = 2 * (e % (kHZ / 2)), hr = e / (kHZ / 2), hy = hr % kHY,
                hx = hr / kHY;
      const int x = x0 + hx - 2, y = y0 + hy - 2, z = z0 + hz - 2;
      const bool in = (unsigned)x < (unsigned)gx &&
                      (unsigned)y < (unsigned)gy && (unsigned)z < (unsigned)gz;
      const unsigned long long* src = s.wr + (in ? x * yz + y * gz + z : 0);
      const unsigned dst = (unsigned)__cvta_generic_to_shared(sm.hc + 2 * e);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                   "l"(src), "r"(in ? 16 : 0));
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kHalo; e += kThreads) {
      const int hz = e % kHZ, hr = e / kHZ, hy = hr % kHY, hx = hr / kHY;
      const int x = x0 + hx - 2, y = y0 + hy - 2, z = z0 + hz - 2;
      unsigned long long w = 0;
      if ((unsigned)x < (unsigned)gx && (unsigned)y < (unsigned)gy &&
          (unsigned)z < (unsigned)gz)
        w = __ldcg(s.wr + x * yz + y * gz + z);
      sm.hc[e] = w;
    }
  }
  __syncthreads();
  // the halo rows' changed bits: bit hz of row (hx, hy) is voxel z0-2+hz
  if (tid < kHX * kHY) {
    const int x = x0 + tid / kHY - 2, y = y0 + tid % kHY - 2;
    unsigned w = 0;
    if ((unsigned)x < (unsigned)gx && (unsigned)y < (unsigned)gy) {
      if (k == 0) {
        w = (1u << kHZ) - 1;
      } else {
        const int ox = (x >> 3) - tx, oy = (y >> 3) - ty;
        const int row = (x & 7) * kTY + (y & 7);
        const int nb = (ox + 1) * 9 + (oy + 1) * 3;
        const int tt = ((tx + ox) * p.nty + ty + oy) * p.ntz + tz;
        unsigned lo = 0, mid = 0, hi = 0;
        if (nbv[nb]) lo = __ldcg(bits_r + (tt - 1) * kRows + row);
        if (nbv[nb + 1]) mid = __ldcg(bits_r + tt * kRows + row);
        if (nbv[nb + 2]) hi = __ldcg(bits_r + (tt + 1) * kRows + row);
        // the tile below in z gives its top 2 bits, the one above its
        // bottom 2
        w = lo >> (kTZ - 2) | mid << 2 | (hi & 3u) << (kTZ + 2);
      }
    }
    sm.hb[tid] = w;
  }
  // the jumps' changed bits, a u16 per (jump, row): bit lz is the
  // neighbour of voxel (x0+lx, y0+ly, z0+lz) along the jump
#pragma unroll 4
  for (int e = tid; e < nj * kRows; e += kThreads) {
    const int j = e / kRows, row = e % kRows;
    const int x = x0 + row / kTY, y = y0 + row % kTY;
    const int i = p.nsmall + j;
    const int dx = sd[0][i], dy = sd[1][i], dz = sd[2][i];
    const int xn = x + dx, yn = y + dy;
    unsigned mk = 0;
    if (x < gx && y < gy && (unsigned)xn < (unsigned)gx &&
        (unsigned)yn < (unsigned)gy) {
      if (dz == 0) {  // along x or y: the neighbour's row, same z
        if (k == 0) {
          mk = 0xFFFFu;
        } else {
          const int which = dx ? (xn >> 3) - ((x0 + dx) >> 3)
                               : (yn >> 3) - ((y0 + dy) >> 3);
          if ((sm.jval[j] >> which) & 1u)
            mk = __ldcg(bits_r + (((xn >> 3) * p.nty + (yn >> 3)) * p.ntz +
                                  tz) * kRows + (xn & 7) * kTY + (yn & 7));
        }
      } else {  // along z: this row's bits at z + dz, over two z tiles
        const int zs = z0 + dz;
        if (k == 0) {
          const int lo = max(0, -zs), hi = min(kTZ, gz - zs);
          mk = hi > lo ? (1u << hi) - (1u << lo) : 0u;
        } else {
          const int tt = t + (zs >> 4) - tz;
          unsigned lo16 = 0, hi16 = 0;
          if (sm.jval[j] & 1u) lo16 = __ldcg(bits_r + tt * kRows + row);
          if (sm.jval[j] & 2u)
            hi16 = __ldcg(bits_r + (tt + 1) * kRows + row);
          mk = ((hi16 << 16 | lo16) >> (zs & 15)) & 0xFFFFu;
        }
      }
    }
    sm.jm[e] = (unsigned short)mk;
    if (mk) atomicOr(jany + (j >> 5), 1u << (j & 31));
  }
  // the halo's copies ran beside the bits' loads
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // each voxel's own state and its reach <= 2 candidates
  const int lz = tid & 15, ly = (tid >> 4) & 7, lx0 = tid >> 7;
  const int y = y0 + ly, z = z0 + lz;
  const bool yz_in = y < gy && z < gz;
  const unsigned* hb0 = sm.hb + (lx0 + 2) * kHY + ly + 2;
#pragma unroll 1
  for (int i = 0; i < kPerThread; ++i) {
    const int l = tid + i * kThreads, lx = lx0 + 2 * i, x = x0 + lx;
    if (!yz_in || x >= gx) continue;
    const int v = x * yz + y * gz + z;
    const int d0 = __ldcg(s.d2r + v);
    const bool upd = !m.update || m.update[v];
    const bool recv = Push && m.push_recv[v];
    const int hc0 = ((lx + 2) * kHY + ly + 2) * kHZ + lz + 2;
    unsigned long long bw = sm.hc[hc0] & kCoords, pw = bw;
    int best = d0, pb = d0;
    if (upd) {
      const unsigned* hbv = hb0 + 2 * i * kHY;
      const unsigned long long* hcv = sm.hc + hc0;
      for_small<S>(sd, p.nsmall, [&](int dx, int dy, int dz) {
        if ((hbv[dx * kHY + dy] >> (lz + 2 + dz)) & 1u)
          consider(hcv[(dx * kHY + dy) * kHZ + dz], x + p.x_offset, y, z,
                   recv, best, bw, pb, pw);
      });
    }
    sm.d0[l] = d0;
    sm.best[l] = best;
    sm.bw[l] = bw;
    if (Push) {
      sm.pbest[l] = pb;
      sm.pw[l] = pw;
    }
    sm.vf[l] = (unsigned char)(upd | recv << 1);
  }
  // the jumps, direction-major: two jumps' words for the thread's four
  // voxels in flight at a time, considered in each voxel's order
  for (int j0 = 0; j0 < nj; j0 += 2) {
    if (!((jany[j0 >> 5] >> (j0 & 31)) & 3u)) continue;
    unsigned long long w[kPerThread][2];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int l = tid + i * kThreads, lx = lx0 + 2 * i;
      const bool live = yz_in && x0 + lx < gx && (sm.vf[l] & 1u);
      const int v = (x0 + lx) * yz + y * gz + z;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + u;
        w[i][u] = 0;
        if (live && j < nj &&
            ((sm.jm[j * kRows + lx * kTY + ly] >> lz) & 1u))
          w[i][u] = __ldcg(s.wr + v + sm.jlin[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (!(w[i][0] | w[i][1])) continue;
      const int l = tid + i * kThreads,
                x = x0 + lx0 + 2 * i + p.x_offset;  // global, for the candidates
      const bool recv = Push && (sm.vf[l] & 2u);
      int best = sm.best[l], pb = recv ? sm.pbest[l] : 0;
      unsigned long long bw = sm.bw[l], pw = recv ? sm.pw[l] : 0;
      consider(w[i][0], x, y, z, recv, best, bw, pb, pw);
      consider(w[i][1], x, y, z, recv, best, bw, pb, pw);
      sm.best[l] = best;
      sm.bw[l] = bw;
      if (recv) {
        sm.pbest[l] = pb;
        sm.pw[l] = pw;
      }
    }
  }
  // the push pass's result where strictly smaller; write the voxels and
  // their changed bits
  bool any = false;
  unsigned short* bits_w =
      a.bits + ((long long)(k & 1) * ntiles + t) * kRows;
#pragma unroll 1
  for (int i = 0; i < kPerThread; ++i) {
    const int l = tid + i * kThreads, x = x0 + lx0 + 2 * i;
    bool changed = false;
    if (yz_in && x < gx) {
      const int v = x * yz + y * gz + z;
      int best = sm.best[l];
      unsigned long long bw = sm.bw[l];
      if (Push && (sm.vf[l] & 2u) && sm.pbest[l] < best) {
        best = sm.pbest[l];
        bw = sm.pw[l];
      }
      changed = best < sm.d0[l];
      s.d2w[v] = best;
      s.ww[v] = bw | (unsigned long long)((short)bw >= 0 ? mask_flags(m, v)
                                                         : 0u) << 48;
    }
    // a warp is rows (lx, ly) and (lx, ly + 1) of 16 z each: two u16s
    const unsigned ball = __ballot_sync(0xffffffffu, changed);
    if ((tid & 31) == 0)
      reinterpret_cast<unsigned*>(bits_w)[l >> 5] = ball;
    any |= changed;
  }
  return any;
}

}  // namespace

// Outside the anonymous namespace, so that the profiler lists it by name.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    relax_sweeps(const int* d2_in, const short* c_in, int* d2_out,
                 short* c_out, int* d2_scr, RelaxMasks m, int* state,
                 RelaxAux a, RelaxParams p, int stencil) {
  extern __shared__ unsigned long long smem[];
  __shared__ short sd[3][kMaxDirs], toff[3][kMaxTileOffs];
  __shared__ unsigned char nbv[27];
  __shared__ unsigned jany[kMaxDirs / 32];
  const int nj = p.n - p.nsmall;
  Shared sm;
  const bool push = m.push_src != nullptr;
  constexpr int kVox = kTX * kTY * kTZ;
  sm.hc = smem;
  sm.bw = sm.hc + kHalo;
  sm.pw = push ? sm.bw + kVox : nullptr;
  sm.best = reinterpret_cast<int*>(sm.bw + (push ? 2 : 1) * kVox);
  sm.d0 = sm.best + kVox;
  sm.pbest = push ? sm.d0 + kVox : nullptr;
  sm.hb = reinterpret_cast<unsigned*>(sm.d0 + (push ? 2 : 1) * kVox);
  sm.jlin = reinterpret_cast<int*>(sm.hb + kHX * kHY);
  sm.jm = reinterpret_cast<unsigned short*>(sm.jlin + nj);
  sm.jval = reinterpret_cast<unsigned char*>(sm.jm + nj * kRows);
  sm.vf = sm.jval + nj;
  const int tid = threadIdx.x;
  const int yz = p.gy * p.gz, plane = p.gx * yz;
  const int ntiles = p.ntx * p.nty * p.ntz;
  const int stride = gridDim.x * kThreads;
  for (int i = tid; i < 3 * kMaxDirs; i += kThreads)
    (&sd[0][0])[i] = (&p.d[0][0])[i];
  for (int i = tid; i < 3 * kMaxTileOffs; i += kThreads)
    (&toff[0][0])[i] = (&p.toff[0][0])[i];
  for (int j = tid; j < nj; j += kThreads)
    sm.jlin[j] = p.d[0][p.nsmall + j] * yz + p.d[1][p.nsmall + j] * p.gz +
                 p.d[2][p.nsmall + j];
  const Dims g = {p.gx,  p.gy, p.gz,     p.ntx,     p.nty,
                  p.ntz, p.n,  p.nsmall, p.x_offset};
  for (int i = blockIdx.x * kThreads + tid; i < ntiles; i += stride) {
    a.stamp[i] = 0;
    a.chg[i] = -1;
    a.chg[ntiles + i] = -1;
  }
  if (blockIdx.x == 0) {
    for (int i = tid; i < 3 + p.log_sweeps; i += kThreads)
      state[i] = i == 2 ? (int)gridDim.x : 0;
    if (tid < 3) a.len[tid] = a.take[tid] = 0;
  }
  // the input, packed into word[0]; its d2 into the scratch (sweep k
  // reads word[k & 1] and d2 buffer k & 1: the scratch, then the output)
  for (int v = blockIdx.x * kThreads + tid; v < plane; v += stride) {
    const int cx = c_in[v];
    a.word[v] = pack(cx, c_in[plane + v], c_in[2 * plane + v],
                     cx >= 0 ? mask_flags(m, v) : 0u);
    d2_scr[v] = d2_in[v];
  }
  cg::grid_group grid = cg::this_grid();
  __syncthreads();
  grid.sync();
  __shared__ int next;
  int k = 0;
  for (;;) {
    Sweep s;
    s.d2r = (k & 1) ? d2_out : d2_scr;
    s.wr = a.word + (long long)(k & 1) * plane;
    s.d2w = (k & 1) ? d2_scr : d2_out;
    s.ww = a.word + (long long)((k + 1) & 1) * plane;
    s.k = k;
    bool changed = false;
    // sweep k visits every tile (k = 0) or the tiles its list holds,
    // which the sweep before appended as it raised their stamps; blocks
    // take them one at a time, asking for the next while they work.  The
    // list of sweep k + 2 (slot (k + 2) % 3) was last used in sweep k - 1.
    int* take = a.take + k % 3;
    int* list = a.list + (k % 3) * ntiles;
    const int n = k == 0 ? ntiles : __ldcg(a.len + k % 3);
    if (blockIdx.x == 0 && tid == 0)
      a.len[(k + 2) % 3] = a.take[(k + 2) % 3] = 0;
    if (tid == 0) next = atomicAdd(take, 1);
    __syncthreads();
    for (;;) {
      const int i = next;
      if (i >= n) break;
      const int t = k == 0 ? i : __ldcg(list + i);
      __syncthreads();
      int after = 0;
      if (tid == 0) after = atomicAdd(take, 1);
      bool any;
#define FIESTA_TILE(S)                                                \
  (push ? relax_tile<S, true>(t, s, m, a, g, sm, sd, nbv, jany)       \
        : relax_tile<S, false>(t, s, m, a, g, sm, sd, nbv, jany))
      switch (stencil) {
        case 6: any = FIESTA_TILE(6); break;
        case 18: any = FIESTA_TILE(18); break;
        case 24: any = FIESTA_TILE(24); break;
        case 26: any = FIESTA_TILE(26); break;
        case 32: any = FIESTA_TILE(32); break;
        case 62: any = FIESTA_TILE(62); break;
        default: any = FIESTA_TILE(0);
      }
#undef FIESTA_TILE
      if (__syncthreads_or(any)) {
        changed = true;
        const int tz = t % p.ntz, tr = t / p.ntz, ty = tr % p.nty,
                  tx = tr / p.nty;
        if (tid == 0) a.chg[(k & 1) * ntiles + t] = k;
        for (int o = tid; o < p.ntoff; o += kThreads) {
          const int ux = tx + toff[0][o], uy = ty + toff[1][o],
                    uz = tz + toff[2][o];
          if (ux >= 0 && ux < p.ntx && uy >= 0 && uy < p.nty && uz >= 0 &&
              uz < p.ntz) {
            const int u = (ux * p.nty + uy) * p.ntz + uz;
            // the block that first marks a tile for sweep k + 1 lists it
            if (atomicMax(a.stamp + u, k + 1) < k + 1)
              a.list[((k + 1) % 3) * ntiles + atomicAdd(a.len + (k + 1) % 3,
                                                         1)] = u;
          }
        }
      }
      if (tid == 0) next = after;
      __syncthreads();
    }
    if (tid == 0 && changed) atomicMax(state, k + 1);
    if (blockIdx.x == 0 && tid == 0 && k < p.log_sweeps) state[3 + k] = n;
    grid.sync();
    ++k;
    const int last = __ldcg(state);
    if (last < k || (p.max_iters > 0 && k >= p.max_iters)) break;
  }
  // the last sweep wrote word[k & 1] and the output's d2 when k is odd,
  // else the scratch's
  const unsigned long long* wf = a.word + (long long)(k & 1) * plane;
  for (int v = blockIdx.x * kThreads + tid; v < plane; v += stride) {
    const unsigned long long w = __ldcg(wf + v);
    c_out[v] = (short)w;
    c_out[plane + v] = (short)(w >> 16);
    c_out[2 * plane + v] = (short)(w >> 32);
    if (!(k & 1)) d2_out[v] = __ldcg(d2_scr + v);
  }
  if (blockIdx.x == 0 && tid == 0) state[1] = k;
}

namespace {

#define FIESTA_ROW(a, b, c) {a, b, c},
const short kS6[][3] = {FIESTA_STENCIL_6(FIESTA_ROW)};
const short kS18[][3] = {FIESTA_STENCIL_18(FIESTA_ROW)};
const short kS24[][3] = {FIESTA_STENCIL_24(FIESTA_ROW)};
const short kS26[][3] = {FIESTA_STENCIL_26(FIESTA_ROW)};
const short kS32[][3] = {FIESTA_STENCIL_32(FIESTA_ROW)};
const short kS62[][3] = {FIESTA_STENCIL_62(FIESTA_ROW)};
#undef FIESTA_ROW

struct Known {
  int id, n;
  const short (*d)[3];
};
const Known kKnown[] = {
    {6, 6, kS6},    {18, 18, kS18}, {24, 24, kS24},
    {26, 26, kS26}, {32, 32, kS32}, {62, 56, kS62},
};

// The compiled stencil whose reach <= 2 part is the table's first nsmall
// directions, in order (dirs [3][n]); 0 if none is.
int stencil_of(const short* dirs, int n, int nsmall) {
  for (const Known& s : kKnown) {
    if (s.n != nsmall) continue;
    bool same = true;
    for (int k = 0; k < nsmall && same; ++k)
      for (int ax = 0; ax < 3; ++ax) same &= dirs[ax * n + k] == s.d[k][ax];
    if (same) return s.id;
  }
  return 0;
}

// Dynamic shared memory of a block: the halo, the voxels' running state
// (twice with the push masks), the halo rows' bits and the jumps' tables.
constexpr size_t smem_bytes(int njumps, bool push) {
  return (kHalo + (push ? 2 : 1) * kTX * kTY * kTZ) * 8 +
         (push ? 3 : 2) * kTX * kTY * kTZ * 4 + kHX * kHY * 4 +
         njumps * (4 + kRows * 2 + 1) + kTX * kTY * kTZ;
}

// Blocks the card holds at once with `smem` bytes of dynamic shared memory
// each, for the cooperative grid (asked once per device and size); lifts
// the kernel's cap on dynamic shared memory to `smem` first.
cudaError_t resident_blocks(size_t smem, long long* out) {
  static long long cached[kFiestaMaxDevices];
  static size_t cached_smem[kFiestaMaxDevices];
  int device, sms, per_sm;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kFiestaMaxDevices && cached[device] &&
      cached_smem[device] == smem) {
    *out = cached[device];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(relax_sweeps,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, relax_sweeps,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  *out = (long long)sms * per_sm;
  if (device < kFiestaMaxDevices) {
    cached[device] = *out;
    cached_smem[device] = smem;
  }
  return cudaSuccess;
}

}  // namespace

// d2 [X,Y,Z] i32 and closest [3,X,Y,Z] i16 in; d2_out / c_out the result,
// d2_scr scratch of d2's shape and words scratch of 2 x X*Y*Z 8-byte words;
// masks u8 [X,Y,Z] or null (the push masks both or neither); x_offset the
// global x of the grid's first plane (0 for a whole grid); dirs
// [3][ndirs] i16 in consideration order, the first nsmall of reach <= 2,
// and toffs [3][ntoff] i16 the tile offsets a changed tile marks (host
// memory, copied into the launch); state [3 + log_sweeps] i32 scratch
// (on return state[1] the sweep count, state[2] the grid's blocks,
// state[3 + k] the tiles visited in sweep k); aux i32 scratch of (6 + 64)
// words a tile of 8 x 8 x 16, and 6.
// X*Y*Z < 2^31, every axis < 2^15, ndirs <= 128 (the wrapper checks).
FIESTA_EXPORT int fiesta_relax(const int* d2_in, const short* c_in,
                               int* d2_out, short* c_out, int* d2_scr,
                               unsigned long long* words,
                               const unsigned char* update,
                               const unsigned char* source,
                               const unsigned char* push_src,
                               const unsigned char* push_recv, int gx, int gy,
                               int gz, int x_offset, const short* dirs,
                               int ndirs, int nsmall, const short* toffs,
                               int ntoff, int max_iters, int log_sweeps,
                               int* state, int* aux, cudaStream_t stream) {
  if (ndirs < 0 || ndirs > kMaxDirs || nsmall < 0 || nsmall > ndirs ||
      ntoff < 1 || ntoff > kMaxTileOffs || log_sweeps < 0 ||
      (!push_src != !push_recv))
    return (int)cudaErrorInvalidValue;
  RelaxParams p = {};
  for (int ax = 0; ax < 3; ++ax) {
    for (int k = 0; k < ndirs; ++k) p.d[ax][k] = dirs[ax * ndirs + k];
    for (int o = 0; o < ntoff; ++o) p.toff[ax][o] = toffs[ax * ntoff + o];
  }
  p.n = ndirs;
  p.nsmall = nsmall;
  p.ntoff = ntoff;
  p.gx = gx;
  p.gy = gy;
  p.gz = gz;
  p.x_offset = x_offset;
  p.ntx = (gx + kTX - 1) / kTX;
  p.nty = (gy + kTY - 1) / kTY;
  p.ntz = (gz + kTZ - 1) / kTZ;
  p.max_iters = max_iters;
  p.log_sweeps = log_sweeps;
  const long long ntiles = (long long)p.ntx * p.nty * p.ntz;
  RelaxAux a;
  a.stamp = aux;
  a.chg = aux + ntiles;
  a.bits = reinterpret_cast<unsigned short*>(aux + 3 * ntiles);
  a.list = aux + (3 + kRows) * ntiles;
  a.len = a.list + 3 * ntiles;
  a.take = a.len + 3;
  a.word = words;
  RelaxMasks m = {update, source, push_src, push_recv};
  int stencil = stencil_of(dirs, ndirs, nsmall);
  const size_t smem = smem_bytes(ndirs - nsmall, push_src != nullptr);
  long long resident;
  const cudaError_t err = resident_blocks(smem, &resident);
  if (err != cudaSuccess) return (int)err;
  long long blocks = ntiles < resident ? ntiles : resident;
  if (blocks < 1) blocks = 1;
  void* args[] = {&d2_in, &c_in, &d2_out, &c_out, &d2_scr, &m,
                  &state, &a,    &p,      &stencil};
  return (int)cudaLaunchCooperativeKernel((const void*)relax_sweeps,
                                          (unsigned)blocks, kThreads, args,
                                          smem, stream);
}
