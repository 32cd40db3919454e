"""The CUDA box add's schedule (``fiesta_tpu_torch/kernels/boxadd.cu``),
emulated on the CPU, against the plain version and fiesta_tpu.

The kernel gives each grid row along z one owner, the lowest scan whose
box covers the row's (x, y), and lets a warp take 8 box rows of one
(k, x) slab at once: a unit that every box holds whole or not at all is
skipped as a whole when a lower scan holds it, or, aligned, moves as
16-byte words with per-byte saturating adds (``__vaddus4``); any other
unit walks its rows and adds bytes.  The emulation runs those decisions
unit by unit, counts the path each unit takes and every write of a grid
byte (at most one owner each), and must equal ``_apply_box_counts_plain``,
the JAX package's ``rmw`` apply and, where its layout rules hold, the
Pallas ``box_add_inplace`` in interpret mode, bit for bit.
"""

import collections

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu.ops import raycast as jrc  # noqa: E402
from fiesta_tpu.ops.pallas import boxadd as jboxadd  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch.ops import raycast as trc  # noqa: E402

UNIT_ROWS = 8   # boxadd.cu's kUnitRows


def _vaddus4(a, b):
    """``__vaddus4`` on u32 words: each byte min(a + b, 255)."""
    ab = a.view(np.uint8).astype(np.int32) + b.view(np.uint8)
    return np.minimum(ab, 255).astype(np.uint8).view(np.uint32)


def test_vaddus4_is_a_per_byte_saturating_add():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    got = _vaddus4(a, b)
    for q in range(4):
        sa, sb, sg = ((x >> (8 * q)) & 0xFF for x in (a, b, got))
        np.testing.assert_array_equal(sg, np.minimum(sa + sb, 255))


def _boxadd_kernel(hit, miss, starts, bh, bm):
    """boxadd.cu's warps, unit by unit.  Returns (hit, miss, paths) with
    new counters and the count of units by path ("skip", "vector",
    "rows", "outside"); asserts that no grid byte is written twice and
    that every vector access is 16-byte aligned."""
    hit, miss = hit.copy(), miss.copy()
    gx, gy, gz = hit.shape
    k, bx, by, bz = bh.shape
    st = [tuple(int(v) for v in s) for s in starts]
    hf, mf = hit.reshape(-1), miss.reshape(-1)
    bhf, bmf = bh.reshape(-1), bm.reshape(-1)
    writes = np.zeros(hf.shape, np.int32)
    units = -(-by // UNIT_ROWS)
    paths = collections.Counter()
    for warp in range(k * bx * units):
        slab, u = divmod(warp, units)
        kk, x = divmod(slab, bx)
        X = st[kk][0] + x
        y0 = u * UNIT_ROWS
        rows = min(UNIT_ROWS, by - y0)
        Y0 = st[kk][1] + y0
        if not 0 <= X < gx:
            paths["outside"] += 1
            continue

        def holds_x(j):
            return st[j][0] <= X < st[j][0] + bx

        def row_base(j, Y):
            return ((j * bx + X - st[j][0]) * by + Y - st[j][1]) * bz \
                - st[j][2]

        uniform, lower = True, False
        gbase = (X * gy + Y0) * gz
        vec = (Y0 >= 0 and Y0 + rows <= gy and bz == gz
               and rows * gz % 16 == 0 and gbase % 16 == 0)
        for j in range(k):
            if not holds_x(j):
                continue
            lo, hi = max(Y0, st[j][1]), min(Y0 + rows, st[j][1] + by)
            if lo >= hi:
                continue
            uniform = uniform and lo == Y0 and hi == Y0 + rows
            lower = lower or j < kk
            vec = vec and st[j][2] == 0 and row_base(j, Y0) % 16 == 0
        if uniform and lower:
            paths["skip"] += 1
            continue
        if uniform and vec:
            paths["vector"] += 1
            n = rows * gz
            sl = slice(gbase, gbase + n)
            h = hf[sl].view(np.uint32).copy()
            m = mf[sl].view(np.uint32).copy()
            for j in range(kk, k):
                if not holds_x(j) or not st[j][1] <= Y0 < st[j][1] + by:
                    continue
                b = row_base(j, Y0)
                assert b % 16 == 0
                h = _vaddus4(h, bhf[b:b + n].view(np.uint32))
                m = _vaddus4(m, bmf[b:b + n].view(np.uint32))
            hf[sl], mf[sl] = h.view(np.uint8), m.view(np.uint8)
            writes[sl] += 1
            continue
        paths["rows"] += 1
        for r in range(rows):
            Y = Y0 + r
            if not 0 <= Y < gy:
                continue

            def holds(j):
                return holds_x(j) and st[j][1] <= Y < st[j][1] + by

            if any(holds(j) for j in range(kk)):
                continue
            cover = [j for j in range(kk, k) if holds(j)]
            zlo = min(max(st[j][2], 0) for j in cover)
            zhi = max(min(st[j][2] + bz, gz) for j in cover)
            z = np.arange(zlo, zhi)
            g0 = (X * gy + Y) * gz
            h = hf[g0 + z].astype(np.int32)
            m = mf[g0 + z].astype(np.int32)
            touched = np.zeros(z.shape, bool)
            for j in cover:
                ok = (z - st[j][2] >= 0) & (z - st[j][2] < bz)
                b = row_base(j, Y) + z[ok]
                h[ok] = np.minimum(h[ok] + bhf[b], 255)
                m[ok] = np.minimum(m[ok] + bmf[b], 255)
                touched |= ok
            at = g0 + z[touched]
            hf[at], mf[at] = h[touched], m[touched]
            writes[at] += 1
    assert writes.max(initial=0) <= 1, "a grid byte has two owners"
    return hit, miss, paths


# (grid, box, starts): at most four scans; the first four boxes of each
FIXTURES = {
    # the cow tick's layout: full-z rows of 80 bytes, 8-aligned x/y starts,
    # boxes nearly coinciding
    "rows80": ((24, 40, 80), (16, 16, 80),
               [[0, 8, 0], [8, 8, 0], [0, 16, 0], [8, 24, 0]]),
    # the demo's: rows of 36 bytes, 16-byte words over 8-row units
    "rows36": ((32, 40, 36), (16, 24, 36),
               [[8, 16, 0], [0, 8, 0], [16, 16, 0], [8, 8, 0]]),
    # unaligned x/y starts, one box cut by another's y edge mid-unit
    "unaligned_xy": ((23, 37, 36), (9, 11, 36),
                     [[0, 0, 0], [5, 7, 0], [13, 26, 0], [6, 3, 0]]),
    # z starts other than 0, one ending at the z face, boxes shorter
    # than the grid's z extent
    "z_start": ((20, 24, 40), (8, 8, 17),
                [[0, 0, 3], [4, 4, 23], [0, 8, 0], [3, 2, 11]]),
    # boxes at the grid's faces: starting at 0 and ending at the far face
    "faces": ((18, 21, 26), (10, 13, 26),
              [[8, 8, 0], [0, 0, 0], [8, 0, 0], [0, 8, 0]]),
}


def _inputs(grid, box, starts, k, seed):
    rng = np.random.default_rng(seed)
    hit = rng.integers(0, 256, grid).astype(np.uint8)
    hit[1:5] = 253                                   # saturates
    miss = rng.integers(0, 256, grid).astype(np.uint8)
    miss[:, :, -3:] = 254
    bh = rng.integers(0, 3, (k,) + box).astype(np.uint8)
    bm = rng.integers(0, 4, (k,) + box).astype(np.uint8)
    return hit, miss, np.asarray(starts[:k], np.int32), bh, bm


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_boxadd_schedule_matches_plain_and_jax(name, k):
    """Row owners, 16-byte words and the byte path give the K in-order
    saturating adds: overlapping boxes, counters at 253 and 254 plus
    increments, unaligned x/y/z starts, boxes at the grid's faces, rows
    of 36 and 80 bytes."""
    grid, box, starts = FIXTURES[name]
    arrays = _inputs(grid, box, starts, k, len(name) + k)
    got_h, got_m, paths = _boxadd_kernel(*arrays)
    plain = trc._apply_box_counts_plain(
        *(torch.from_numpy(a.copy()) for a in arrays))
    ref = jrc.apply_box_counts(*(jnp.asarray(a) for a in arrays),
                               mode="rmw")
    for got, p, r in zip((got_h, got_m), plain, ref):
        np.testing.assert_array_equal(got, p.numpy())
        np.testing.assert_array_equal(got, np.asarray(r))
    assert (got_h == 255).any()
    if name in ("rows80", "rows36"):
        assert paths["rows"] == 0 and paths["vector"] > 0, paths
        assert (paths["skip"] > 0) == (k > 1), paths
    else:
        assert paths["rows"] > 0, paths
    if jboxadd.box_add_supported(box, grid):
        assert name == "rows80"
        pallas = jboxadd.box_add_inplace(*(jnp.asarray(a) for a in arrays),
                                         interpret=True)
        for got, r in zip((got_h, got_m), pallas):
            np.testing.assert_array_equal(got, np.asarray(r))


@pytest.mark.parametrize("preset", ["cow_and_lady", "demo"])
def test_boxadd_schedule_at_the_presets_boxes(preset):
    """The presets' own grids, boxes and box placement (three sensors
    near one another, as in a tick): every unit is skipped whole or moves
    as 16-byte words, and the counters equal the plain version's."""
    cfg = ft.COW_AND_LADY if preset == "cow_and_lady" else ft.DEMO_ONBOARD
    box = trc._carve_box_shape(cfg)
    po = torch.tensor([[200.4, 201.7, 40.2], [207.9, 196.1, 40.0],
                       [193.2, 205.5, 39.7]]) * torch.tensor(
                           cfg.grid_shape, dtype=torch.float32) / 400.0
    starts = trc._box_starts(cfg, po).numpy()
    assert len({tuple(s) for s in starts}) == 3
    arrays = _inputs(cfg.grid_shape, box, starts.tolist(), 3, 7)
    got_h, got_m, paths = _boxadd_kernel(*arrays)
    assert paths["rows"] == 0 and paths["outside"] == 0, paths
    assert paths["skip"] > 0 and paths["vector"] > 0, paths
    plain = trc._apply_box_counts_plain(
        *(torch.from_numpy(a.copy()) for a in arrays))
    np.testing.assert_array_equal(got_h, plain[0].numpy())
    np.testing.assert_array_equal(got_m, plain[1].numpy())
