"""The card's peaks and the least time a function's work can take on it.

A bound is max(bytes / peak bytes/s, operations / peak operations/s) of
the work the function needs at the cell's shapes, whatever kernel
implements it.  The arithmetic is ``chip_smoke.py``'s (its ``bound`` and
the carve and EDT rows), copied so that the yardstick does not move with
the program.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published (data sheet): 3.35 TB/s of HBM3, and 67
# TFLOP/s of f32 outside the tensor cores counting an FMA as two
# operations; the port's kernels build with -fmad=false, so each f32
# operation is one instruction
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
# NOT published: derived as 64 INT32 lanes an SM x 132 SMs x the 1.98 GHz
# boost clock
I32_OPS_PER_S = 132 * 64 * 1.98e9

# the carve: each voxel is visited by one wavefront of each of the three
# orientations (it lies in one half-space of each), ~20 f32 operations a
# visit (offsets, two divisions and floors, four taps, the octant test,
# r2, the free test)
CARVE_VISITS = 3
CARVE_OPS_PER_VISIT = 20
# the EDT's windowed min-plus pass: the cheapest exact pass is O(A) a
# column (a lower envelope, or a min-plus convolution with the convex
# k^2), ~24 integer operations a voxel of a column that holds a value
# below "far"
ENVELOPE_OPS = 24


def bound_s(nbytes: float, ops: float, rate: float):
    """(seconds, "bytes" or "operations"): the larger of the two terms."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def carve_bound_s(scans: int, box) -> tuple:
    """The carve of ``scans`` boxes of shape ``box``: the f32 seeds read
    and the u8 free mask written once, the sensor positions, and the
    wavefront operations."""
    n = scans * box[0] * box[1] * box[2]
    return bound_s(n * 4 + n + scans * 3 * 4,
                   CARVE_VISITS * CARVE_OPS_PER_VISIT * n, F32_OPS_PER_S)


def edt_bound_s(grid) -> tuple:
    """The truncated EDT of a grid: three passes (binary along x, min-plus
    along y and along z), each reading and writing an i32 a voxel.  The
    binary pass's operations (4 a voxel) and each min-plus pass's (at
    most ENVELOPE_OPS a voxel, every column near an obstacle) stay below
    its bytes term at any shape, so the bound is the bytes: 24 B a voxel."""
    nvox = grid[0] * grid[1] * grid[2]
    passes = [bound_s(nvox * 8, 4 * nvox, I32_OPS_PER_S),
              bound_s(nvox * 8, ENVELOPE_OPS * nvox, I32_OPS_PER_S),
              bound_s(nvox * 8, ENVELOPE_OPS * nvox, I32_OPS_PER_S)]
    return (sum(t for t, _ in passes),
            "bytes" if all(b == "bytes" for _, b in passes)
            else "operations")
