"""fiesta_tpu_torch CUDA kernels against their plain PyTorch versions.

Runs only on a CUDA card (marker ``cuda``; skips elsewhere).  The card
machine has no JAX, and ``tests/conftest.py`` imports it, so run this file
there with:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Every kernel must equal its plain version bit for bit, at small shapes
chosen for their edges: odd sizes, ragged tiles, t >= axis length,
duplicate and dropped splat indices, square and non-square carve boxes,
saturating and overlapping boxes on an unaligned grid and at the cow
and demo ticks' own boxes, both closest layouts (x-lead, and the widest-C
fallback), the EDT binary and closest split passes at their bounds'
edges on columns up to 450 rows, the closest window pass at its bounds'
edges along every axis at the cow and demo shapes, the closest binary
pass along every axis at the cow shape and with a u16 tile, sort
lengths below, at and above one shared-memory tile (up to 2^20 + 5
pairs, where the merge
levels split, and the cow splat's 147 456) with duplicate and sentinel
keys, equal, sorted and reverse-sorted keys, the splat at the cow box
size, windows of the drain that cut, cover or miss the grid, the three
wide closest passes on 64-bit words (both layouts, columns of 400 rows at
t = 2000), the wide split's own tiles (either side of its 32-bit tile
words' edge, ragged column counts, several chunks with lone values at
their edges, 1600-row columns in both word forms, its tiles and residency
at the wide path's maps and the CPU model's table) and the closest decode
(packed and wide words, both formats, a slab's x origin, roots of k + 1/2
rounded half to even).  The app's
prefetch worker uploads on the stream its replay loop reads.  The depth
kernel at 1, 3 and 4 frames of 24x32, 23x37 (no 16-byte path) and
480x640, with and without the filter and the margin, on NaN, infinite,
zero and gated depths, against a previous pose that sees the same scene
and one turned away, their eliminations pivoting on other rows.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import kernels  # noqa: E402
from fiesta_tpu_torch import pipeline  # noqa: E402
from fiesta_tpu_torch.io import replay  # noqa: E402
from fiesta_tpu_torch.config import (STENCILS,  # noqa: E402
                                     jump_offsets, stencil_offsets)
from fiesta_tpu_torch.ops import edt, esdf, fusion, raycast, sort  # noqa: E402
from fiesta_tpu_torch.ops import depth as depth_ops  # noqa: E402

pytestmark = pytest.mark.cuda

INF = edt._INF_EDT


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _eq(a, b):
    torch.cuda.synchronize()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), int((a != b).sum())


def _cuda_kernels(fn, attempts=3, inplace=()):
    """(fn(), the names of the CUDA kernels it launched, in order), read
    from ``torch.profiler``.  The trace drops the first kernels launched
    in it (one, on some cards two), so device sleeps go first and are
    left out.  A trace in which no sleep is left, or no kernel at all,
    may have dropped some of ``fn``'s: it is taken again, up to
    ``attempts`` times, and ``kernels.LAUNCHES`` counts one call.  The
    tensors ``inplace``, which ``fn`` updates in place, are put back as
    they were before each attempt."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = dict(kernels.LAUNCHES)
    saved = [x.clone() for x in inplace]
    for attempt in range(attempts):
        kernels.LAUNCHES.update(before)
        for x, x0 in zip(inplace, saved):
            x.copy_(x0)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(8):
                torch.cuda._sleep(5_000_000)
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        events = sorted((e for e in device if "spin_kernel" not in e.name),
                        key=lambda e: e.time_range.start)
        if events and len(events) < len(device):
            break
    return out, [e.name.split("(")[0] for e in events]


@pytest.mark.parametrize("n,r", [(1, 5000), (4099, 5000), (60000, 5000),
                                 (3 * 216 * 216 * 80, 3 * 192 * 256)],
                         ids=["1", "4099", "60000", "cow"])
def test_splat_kernel(dev, n, r):
    g = torch.Generator().manual_seed(n)
    lin = torch.randint(0, n + 3, (r,), generator=g, dtype=torch.int32)
    lin[:r // 10] = lin[r // 10:2 * (r // 10)]             # duplicates
    lin[-r // 20:] = n                                     # the drop slot
    val = 1000.0 + 2000.0 * torch.rand(r, generator=g)
    lin, val = lin.to(dev), val.to(dev)
    kernels.reset_launch_counts()
    got, names = _cuda_kernels(lambda: raycast.splat_packed(lin, val, n, 1.2))
    assert kernels.LAUNCHES["splat"] == 1
    assert names == ["splat_fill", "splat_scatter_max", "splat_gather",
                     "splat_write"]
    ref = raycast._splat_packed_plain(lin, val, n, 1.2)
    for a, b in zip(got, ref):
        _eq(a, b)
    # no rays: the zero fills alone
    empty, names = _cuda_kernels(lambda: kernels.splat(lin[:0], val[:0], n,
                                                       1.2))
    assert names == ["splat_fill", "splat_scatter_max"]
    for a in empty:
        _eq(a, torch.zeros_like(a))


def _cfg(map_size, origin, max_ray):
    return ft.FiestaConfig(resolution=0.2, map_size=map_size, origin=origin,
                           min_ray_length=0.3, max_ray_length=max_ray)


@pytest.mark.parametrize("cfg", [
    _cfg((12.0, 12.0, 4.8), (-6.0, -6.0, -2.4), 3.0),
    _cfg((12.0, 2.0, 4.8), (-6.0, -1.0, -2.4), 2.0),
    _cfg((6.4, 6.4, 3.2), (-3.2, -3.2, -1.6), 2.0)],
    ids=["square", "non_square", "aligned"])
def test_carve_kernel(dev, cfg):
    rng = np.random.default_rng(3)
    k, p = 3, 4000
    origins = torch.tensor(rng.uniform(-1.5, 1.5, (k, 3)), dtype=torch.float32)
    pts = origins[:, None, :] + torch.tensor(
        rng.uniform(-4, 4, (k, p, 3)), dtype=torch.float32)
    val = torch.tensor(rng.uniform(size=(k, p)) < 0.9)
    _, po, seeds, _, _, _ = raycast._scanline_seeds_batch(
        cfg, pts.to(dev), val.to(dev), origins.to(dev))
    kernels.reset_launch_counts()
    got, names = _cuda_kernels(
        lambda: raycast.carve_free_mask_batch(cfg, seeds, po))
    assert kernels.LAUNCHES["carve"] == 1
    assert names == ["carve_zero", "carve_sweep"]  # 217 at cow before
    ref = raycast._carve_free_plain(cfg, seeds, po)
    _eq(got, ref)
    assert bool(ref.any())
    _eq(got[:1], raycast._carve_free_plain(cfg, seeds[:1], po[:1]))  # K = 1
    _eq(raycast.carve_free_mask_batch(cfg, seeds[:1], po[:1]), got[:1])


def _range_seeds(box, po, res, density, g):
    """Seeds [K, *box]: a sparse set of voxels holding their range from
    the sensor (metres, a little beyond)."""
    axes = torch.meshgrid(*[torch.arange(n, dtype=torch.float32)
                            for n in box], indexing="ij")
    grid = torch.stack(axes, -1)
    rng_m = (grid[None] - po[:, None, None, None]).norm(dim=-1)
    keep = torch.rand(rng_m.shape, generator=g) < density
    val = rng_m * res + 0.1 * torch.rand(rng_m.shape, generator=g)
    return torch.where(keep, val, 0.0)


@pytest.mark.parametrize("box,po", [
    ((23, 17, 11), [[11.0, 8.0, 5.0], [3.0, 16.0, 0.0]]),       # slab edge
    ((23, 17, 11), [[0.0, 8.5, 5.5], [22.0, 16.0, 10.0]]),      # at a face
    ((23, 17, 11), [[-3.5, 8.2, 5.1], [25.25, -2.0, 13.0]]),    # outside
    ((216, 216, 80), [[108.3, 107.6, 40.2], [20.5, 190.0, 3.0],
                      [230.0, -5.0, 79.0]]),                    # cow box
    ((120, 120, 36), [[61.3, 58.7, 17.2]])],                    # demo box
    ids=["integer_slab", "at_face", "outside", "cow_box", "demo_box"])
def test_carve_kernel_sensor_edges(dev, box, po):
    """Sensors on an integer slab, at and past a box face, and the cow
    and demo boxes (their z plane, 216 x 216 and 120 x 120 cells, is split
    over a cluster's blocks)."""
    cfg = _cfg((12.0, 12.0, 4.8), (-6.0, -6.0, -2.4), 3.0)
    g = torch.Generator().manual_seed(len(po))
    po = torch.tensor(po, dtype=torch.float32)
    seeds = _range_seeds(box, po, cfg.resolution, 0.01, g)
    seeds, po = seeds.to(dev), po.to(dev)
    got = raycast.carve_free_mask_batch(cfg, seeds, po)
    ref = raycast._carve_free_plain(cfg, seeds, po)
    _eq(got, ref)
    assert bool(ref.any())


def _binary_edges(shape, t, g):
    """0 / INF volumes [A, ...] at the binary kernel's edges: lone seeds
    at t_local and t_local + 1 from either column end and from each
    segment edge (16 segments a column), all-far tiles, random seeds."""
    a = shape[0]
    tl = min(t, a - 1)
    seg_len = -(-a // 16)
    rows = {0, a - 1, tl, tl + 1, a - 1 - tl, a - 2 - tl}
    for edge in range(seg_len, a, seg_len):
        rows |= {edge - tl, edge - 1 - tl, edge - 1 + tl, edge + tl}
    rows = sorted(r for r in rows if 0 <= r < a)
    lone = torch.full(shape, INF).reshape(a, -1)
    for j in range(32, lone.shape[1]):          # the first tile: all far
        lone[rows[j % len(rows)], j] = 0
    rand = torch.where(torch.rand(shape, generator=g) < 0.03, 0, INF)
    return [x.reshape(shape).to(torch.int32) for x in (lone, rand)]


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("t", [1, 5, 17, 47, 60])
def test_binary_pass_kernel(dev, t, square):
    """Ragged tiles, t >= A (A = 1, 5, 37, 48 at t = 47, 60), and columns
    of 400 and 450 rows, lone seeds at each segment's edge; one CUDA
    launch a call."""
    g = torch.Generator().manual_seed(t)
    for shape in ((48, 20, 12), (1, 7, 3), (37, 1, 130), (5, 13, 40),
                  (400, 9, 40), (450, 5, 33)):
        for f in _binary_edges(shape, t, g):
            f = f.to(dev)
            _eq(edt.binary_pass(f, t, square),
                edt._binary_pass_plain(f, t, square))
    _, names = _cuda_kernels(lambda: edt.binary_pass(f, t, square))
    assert names == ["edt_binary_kernel"]


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("t", [1, 6, 17, 70])
def test_minplus_pass_kernel(dev, axis, t):
    g = torch.Generator().manual_seed(10 * t + axis)
    for shape in ((14, 17, 11), (70, 33, 5), (3, 41, 66)):
        near = torch.rand(shape, generator=g) < 0.05
        f = torch.where(near, torch.randint(0, 40, shape, generator=g), INF)
        f = f.to(torch.int32).to(dev)
        _eq(edt.minplus_pass(f, t, axis), edt._minplus_pass_plain(f, t, axis))


def _minplus_edges(shape, axis, t, g):
    """Inputs at the bounded window's edges, along ``axis``: random
    values in [0, INF], values about t^2, all-far columns, and lone values
    at distance t_local and t_local + 1 from a column's first row."""
    a = shape[axis]
    tl = min(t, a - 1)
    rand = torch.randint(0, INF + 1, shape, generator=g)
    rand[torch.rand(shape, generator=g) < 0.7] = INF
    pick = torch.tensor([t * t - 1, t * t, t * t + 1, t * t + 5, INF])
    near_t2 = pick[torch.randint(0, 5, shape, generator=g)]
    lone = torch.full(shape, INF).movedim(axis, 0)
    lone[:, ::2] = INF                              # all-far columns
    lone[0, 1::4] = 0
    lone[min(tl + 1, a - 1), 3::4] = 0
    lone[a - 1, 1::4] = 3
    return [x.to(torch.int32) for x in (rand, near_t2,
                                        lone.movedim(0, axis))]


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("t", [5, 100])
def test_minplus_pass_kernel_edges(dev, axis, t):
    """The bounded window at its edges, with t < A and t >= A, and columns
    longer than a tile's sweep segment (450 rows at t = 100)."""
    g = torch.Generator().manual_seed(t + axis)
    for shape in ((45, 37, 33), (450, 9, 7), (6, 450, 40), (5, 7, 450)):
        for f in _minplus_edges(shape, axis, t, g):
            f = f.to(dev)
            _eq(edt.minplus_pass(f, t, axis),
                edt._minplus_pass_plain(f, t, axis))


@pytest.mark.parametrize("probabilistic", [True, False])
@pytest.mark.parametrize("shape", [(16, 12, 24), (7, 5, 3)])
def test_fuse_kernel(dev, shape, probabilistic):
    rng = np.random.default_rng(sum(shape))
    lo = rng.uniform(-2.0, 3.5, shape).astype(np.float32)
    lo.flat[::7] = np.float32(0.4)
    lo.flat[::5] = np.float32(1.0)
    seen = (rng.random(shape) < 0.5).astype(np.uint8)
    hit = rng.integers(0, 256, shape).astype(np.uint8)
    miss = np.where(rng.random(shape) < 0.3, 0,
                    rng.integers(0, 256, shape)).astype(np.uint8)
    args = [torch.from_numpy(a).to(dev) for a in (lo, seen, hit, miss)]
    kw = dict(l_hit=0.85, l_miss=-0.4, clamp_min=-2.0, clamp_max=3.5,
              occ_thresh=0.4 if probabilistic else 1.0,
              occ_is_eq=not probabilistic)
    before = [a.clone() for a in args]
    got = fusion.fuse_drain(*args, **kw)
    ref = fusion._fuse_drain_plain(*args, **kw)
    for a, b in zip(got, ref):
        _eq(a, b)
    for a, b in zip(args, before):
        _eq(a, b)                                  # inputs left as they were


@pytest.mark.parametrize("grid,box,starts", [
    ((45, 43, 25), (13, 11, 25), [[0, 0, 0], [5, 7, 0], [32, 32, 0],
                                  [6, 8, 0]]),
    ((32, 24, 16), (16, 8, 16), [[0, 8, 0], [8, 8, 0], [8, 16, 0]])],
    ids=["unaligned", "aligned"])
def test_boxadd_kernel(dev, grid, box, starts):
    rng = np.random.default_rng(len(starts))
    hit = rng.integers(0, 256, grid).astype(np.uint8)
    hit[4:12] = 253                                # saturates
    miss = rng.integers(0, 256, grid).astype(np.uint8)
    k = len(starts)
    bh = rng.integers(0, 3, (k,) + box).astype(np.uint8)
    bm = rng.integers(0, 4, (k,) + box).astype(np.uint8)
    h, m, st, bh, bm = (torch.from_numpy(a).to(dev) for a in
                        (hit, miss, np.asarray(starts, np.int32), bh, bm))
    ref = raycast._apply_box_counts_plain(h.clone(), m.clone(), st, bh, bm)
    got = raycast.apply_box_counts(h, m, st, bh, bm)
    assert got[0] is h and got[1] is m                 # in place
    for a, b in zip(got, ref):
        _eq(a, b)
    assert int((ref[0] == 255).sum()) > 0


@pytest.mark.parametrize("preset", ["cow_and_lady", "demo"])
def test_boxadd_kernel_at_tick_boxes(dev, preset):
    """The presets' own boxes (cow: 3 x 216x216x80, demo: 3 x 120x120x36)
    at the starts ``scanline_batch_boxes`` gives each of five ticks of a
    replay (24x32 scans; the boxes of a tick coincide or nearly so), with
    the tick's counts and with random ones on counters near 255; one CUDA
    launch a call."""
    base = ft.COW_AND_LADY if preset == "cow_and_lady" else ft.DEMO_ONBOARD
    cfg = dataclasses.replace(replay.scale_intrinsics(base, 24, 32),
                              max_points_per_scan=24 * 32)
    _, frames = replay.make_sequence(cfg, n_frames=15, n_boxes=20, seed=0,
                                     kind="cloud", height=24, width=32,
                                     period=12.0, orbit_radius=5.0)
    batches = replay.stage_update_batches(cfg, frames, device=dev)
    g = torch.Generator(device=dev).manual_seed(len(preset))
    grid = cfg.grid_shape
    for tick in range(batches[0].shape[0]):
        pts, vals, tfs, _ = (b[tick] for b in batches)
        starts, hitc, missc, _, _ = raycast.scanline_batch_boxes(
            cfg, pts, vals, tfs)
        rand = [torch.randint(0, 4, hitc.shape, generator=g, device=dev,
                              dtype=torch.uint8) for _ in range(2)]
        for bh, bm in ((hitc, missc), rand):
            h = torch.randint(0, 256, grid, generator=g, device=dev,
                              dtype=torch.uint8)
            h[grid[0] // 3:grid[0] // 2] = 253             # saturates
            m = torch.randint(250, 256, grid, generator=g, device=dev,
                              dtype=torch.uint8)
            ref = raycast._apply_box_counts_plain(h.clone(), m.clone(),
                                                  starts, bh, bm)
            got, names = _cuda_kernels(
                lambda: raycast.apply_box_counts(h, m, starts, bh, bm),
                inplace=(h, m))
            assert names == ["boxadd_kernel"]
            assert got[0] is h and got[1] is m
            for a, b in zip(got, ref):
                _eq(a, b)


CLOSEST = {"x_lead": ((40, 33, 8), 9), "x_lead_long_t": ((37, 29, 20), 23),
           "widest_c": ((64, 16, 8), 1500), "long_c": ((24, 400, 10), 100),
           "long_c_450": ((8, 450, 6), 100)}


def _split_edges(shape, plan, g, dtype=torch.int32):
    """Split-pass input words ``v << s | payload`` (v <= cap) along the
    plan's c axis, of ``dtype``: random values; values whose candidates
    tie (v + k^2, within a side and across the two) with payloads 0-2;
    values at cap and cap - 1; all-far columns; lone values at t_local and
    t_local + 1 from either column end."""
    s, cap, c_ax = plan["s"], plan["cap"], plan["c"]
    a = shape[c_ax]
    tl = min(plan["t"], a - 1)
    lead = (a,) + tuple(n for i, n in enumerate(shape) if i != c_ax)
    pay = torch.randint(0, 1 << s, lead, generator=g)
    rand = torch.randint(0, cap + 1, lead, generator=g)
    rand[torch.rand(lead, generator=g) < 0.6] = cap
    pick = torch.tensor([0, 1, 3, 4, 8, 9, cap, cap])
    ties = pick[torch.randint(0, 8, lead, generator=g)]
    at_cap = torch.tensor([cap - 1, cap, cap, cap])[
        torch.randint(0, 4, lead, generator=g)]
    lone = torch.full(lead, cap).reshape(a, -1)
    rows = [0, tl, tl + 1, a - 1 - tl, a - 2 - tl, a - 1]
    for j in range(lone.shape[1]):
        r = rows[j % len(rows)]
        if 0 <= r < a and j % 7:                    # every 7th: all far
            lone[r, j] = j % 3
    out = []
    for v, p in ((rand, pay), (ties, torch.randint(0, 3, lead, generator=g)),
                 (at_cap, pay), (lone.reshape(lead), pay)):
        out.append(((v << s) | p).to(dtype).movedim(0, c_ax)
                   .contiguous())
    return out


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("layout", sorted(CLOSEST))
def test_closest_kernels(dev, layout, square):
    shape, t = CLOSEST[layout]
    plan = edt.closest_plan(shape, t)
    g = torch.Generator().manual_seed(len(layout))
    occ = (torch.rand(shape, generator=g) < 0.03).to(torch.uint8)
    occ[:, :3] = 0                                 # all-far tiles
    occ = occ.to(dev)
    a, b, c = plan["a"], plan["b"], plan["c"]
    p1 = edt._binary_packed_plain(occ, plan, a, square)
    _eq(edt.binary_packed(occ, plan, a, square), p1)
    if not square:
        p1 = edt.square_packed_l1(p1, plan)
    p2 = edt._window_packed_plain(p1, plan, b)
    _eq(edt.window_packed(p1, plan, b), p2)
    _eq(edt.split_packed(p2, plan, c), edt._split_packed_plain(p2, plan, c))
    # the split's bounds at their edges, one CUDA launch a call
    for x in _split_edges(tuple(shape), plan, g):
        x = x.to(dev)
        _eq(edt.split_packed(x, plan, c), edt._split_packed_plain(x, plan, c))
    _, names = _cuda_kernels(lambda: edt.split_packed(x, plan, c))
    assert names == ["closest_split_kernel"]


def _window_edges(shape, plan, axis, g, dtype=torch.int32):
    """Window-pass input words ``v << ba | a*`` (v <= cap) along ``axis``,
    of ``dtype``:
    random values; values whose candidates tie (within a side and across
    the two) with a* 0-2; values at cap and cap - 1; a first tile of 32
    all-far columns, then lone values at t_local and t_local + 1 from
    either column end and from each segment edge (16 segments a
    column)."""
    ba, cap = plan["ba"], plan["cap"]
    a = shape[axis]
    tl = min(plan["t"], a - 1)
    lead = (a,) + tuple(n for i, n in enumerate(shape) if i != axis)
    pay = torch.randint(0, 1 << ba, lead, generator=g)
    rand = torch.randint(0, cap + 1, lead, generator=g)
    rand[torch.rand(lead, generator=g) < 0.6] = cap
    pick = torch.tensor([0, 1, 3, 4, 8, 9, cap, cap])
    ties = pick[torch.randint(0, 8, lead, generator=g)]
    at_cap = torch.tensor([cap - 1, cap, cap, cap])[
        torch.randint(0, 4, lead, generator=g)]
    seg_len = -(-a // 16)
    rows = {0, tl, tl + 1, a - 1 - tl, a - 2 - tl, a - 1}
    for edge in range(seg_len, a, seg_len):
        rows |= {edge - tl, edge - 1 - tl, edge - 1 + tl, edge + tl}
    rows = sorted(r for r in rows if 0 <= r < a)
    lone = torch.full(lead, cap).reshape(a, -1)
    cols = torch.arange(32, lone.shape[1])      # the first tile: all far
    lone[torch.tensor(rows)[cols % len(rows)], cols] = cols % 3
    out = []
    for v, p in ((rand, pay), (ties, torch.randint(0, 3, lead, generator=g)),
                 (at_cap, pay), (lone.reshape(lead), pay)):
        out.append(((v << ba) | p).to(dtype).movedim(0, axis)
                   .contiguous())
    return out


@pytest.mark.parametrize("layout", sorted(CLOSEST) + ["cow", "demo"])
def test_closest_window_kernel(dev, layout):
    """The window pass's bounded window along every axis whose payload
    fits a packed plan (all but axis 0 of widest_c; the plans' own b axis
    is z, contiguous, at cow and demo), at the CLOSEST layouts and the
    cow (400x400x80, t = 100) and demo (400x400x36, t = 50) shapes, on
    the binary pass's words and at the bounds' edges; one CUDA launch a
    call."""
    shape, t = {"cow": ((400, 400, 80), 100),
                "demo": ((400, 400, 36), 50)}.get(layout) or CLOSEST[layout]
    g = torch.Generator().manual_seed(len(layout))
    plan = edt.closest_plan(shape, t)
    occ = (torch.rand(shape, generator=g) < 0.01).to(torch.uint8)
    occ[:, :3] = 0                                 # all-far tiles
    p1 = edt._binary_packed_plain(occ.to(dev), plan, plan["a"])
    _eq(edt.window_packed(p1, plan, plan["b"]),
        edt._window_packed_plain(p1, plan, plan["b"]))
    bits = [max(1, (n - 1).bit_length()) for n in shape]
    axes = 0
    for axis in range(3):
        ba = min(b for i, b in enumerate(bits) if i != axis)
        ax_plan = dict(plan, ba=ba, bb=bits[axis], s=ba + bits[axis])
        if plan["cap"].bit_length() + 1 + ax_plan["s"] > 31:
            continue
        axes += 1
        for x in _window_edges(shape, ax_plan, axis, g):
            x = x.to(dev)
            _eq(edt.window_packed(x, ax_plan, axis),
                edt._window_packed_plain(x, ax_plan, axis))
    assert axes == (2 if layout == "widest_c" else 3)
    kernels.reset_launch_counts()
    _, names = _cuda_kernels(lambda: edt.window_packed(p1, plan, plan["b"]))
    assert names == ["closest_window_kernel"]
    assert kernels.LAUNCHES["closest_window"] == 1


def _closest_binary_edges(shape, axis, t, g):
    """u8 occupancy along ``axis``: lone seeds at t_local and t_local + 1
    from either column end and from each segment edge (16 segments a
    column), pairs of seeds 2d apart (their middle row ties), all-far
    tiles, random seeds."""
    a = shape[axis]
    tl = min(t, a - 1)
    seg_len = -(-a // 16)
    rows = {0, a - 1, tl, tl + 1, a - 1 - tl, a - 2 - tl}
    for edge in range(seg_len, a, seg_len):
        rows |= {edge - tl, edge - 1 - tl, edge - 1 + tl, edge + tl}
    rows = sorted(r for r in rows if 0 <= r < a)
    lone = torch.zeros(shape, dtype=torch.uint8).movedim(axis, 0)
    flat = lone.reshape(a, -1)
    for j in range(32, flat.shape[1]):          # the first tile: all far
        flat[rows[j % len(rows)], j] = 1
        d = j % (tl + 2) + 1
        if j % 3 == 0 and j % a - d >= 0 and j % a + d < a:
            flat[[j % a - d, j % a + d], j] = 1
    rand = (torch.rand(shape, generator=g) < 0.03).to(torch.uint8)
    return [flat.reshape(lone.shape).movedim(0, axis).contiguous(), rand]


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("layout", sorted(CLOSEST) + ["cow", "u16_tile"])
def test_closest_binary_kernel(dev, layout, square):
    """The binary pass's tiles and segmented sweep along every axis (the
    plans' a axis is 0 or 1; axis 2 is contiguous), at the CLOSEST
    layouts, the cow shape (400x400x80, t = 100) and a t_local above 253
    (u16 tile); one CUDA launch a call (a template: the profiler lists
    ``void closest_binary_kernel<unsigned char>``)."""
    shape, t = {"cow": ((400, 400, 80), 100),
                "u16_tile": ((400, 8, 8), 300)}.get(layout) or CLOSEST[layout]
    g = torch.Generator().manual_seed(len(layout))
    for axis in range(3):
        a = shape[axis]
        plan = dict(t=t, ba=max(1, (a - 1).bit_length()), cap=t * t + 1)
        if axis == 0 or layout != "cow":
            for occ in _closest_binary_edges(shape, axis, t, g):
                occ = occ.to(dev)
                _eq(edt.binary_packed(occ, plan, axis, square),
                    edt._binary_packed_plain(occ, plan, axis, square))
    plan = edt.closest_plan(shape, t)
    occ = occ.to(dev)
    _, names = _cuda_kernels(
        lambda: edt.binary_packed(occ, plan, plan["a"], square))
    assert [n.split("<")[0] for n in names] == ["void closest_binary_kernel"]


@pytest.mark.parametrize("packed_out", [False, True])
def test_closest_transform_kernels_equal_plain(dev, monkeypatch, packed_out):
    occ = (torch.rand((48, 40, 24), generator=torch.Generator().manual_seed(
        5)) < 0.01).to(dev)
    kernels.reset_launch_counts()
    got = edt.truncated_edt_d2_closest(occ, 12, packed_out)
    assert [kernels.LAUNCHES[k] for k in
            ("closest_binary", "closest_window", "closest_split",
             "closest_decode")] == [1, 1, 1, 1]
    monkeypatch.setattr(edt, "binary_packed", edt._binary_packed_plain)
    monkeypatch.setattr(edt, "window_packed", edt._window_packed_plain)
    monkeypatch.setattr(edt, "split_packed", edt._split_packed_plain)
    monkeypatch.setattr(edt, "decode_split", edt._decode_split_plain)
    ref = edt.truncated_edt_d2_closest(occ, 12, packed_out)
    for a, b in zip(got, ref):
        _eq(a, b)
    _eq(got[0], edt.truncated_edt_d2(occ, 12))


# shapes past the int32 packing budget at t = 2000 (the wide plan's
# x-lead layout, a = x, b = z, c = y; t_local 399 on a long c or a
# column), and two wide plans built by hand: the widest-C axes, and a b
# axis of 400 rows (the window's k0p past its u8 cap of 254)
WIDE = {"x_lead": ((40, 40, 8), None), "long_c": ((40, 400, 8), None),
        "long_a": ((400, 40, 8), None), "widest_c": ((40, 40, 8), (1, 2, 0)),
        "long_b": ((40, 400, 8), (0, 1, 2))}
WIDE_T = 2000


def _wide_plan(layout):
    shape, axes = WIDE[layout]
    if axes is None:
        assert edt.closest_plan(shape, WIDE_T) is None
        return shape, edt.closest_plan_wide(shape, WIDE_T)
    bits = [max(1, (n - 1).bit_length()) for n in shape]
    a, b, c = axes
    return shape, dict(a=a, b=b, c=c, ba=bits[a], bb=bits[b],
                       s=bits[a] + bits[b], cap=WIDE_T * WIDE_T + 1, t=WIDE_T)


@pytest.mark.parametrize("layout", sorted(WIDE))
def test_closest_wide_kernels(dev, layout):
    """The three wide passes (64-bit words) against their plain versions
    (the pair passes packed into the word) on a sparse occupancy, the
    binary pass at its edges along a, the window and split passes at
    their bounds' edges along b and c; one CUDA launch a call, by name."""
    shape, plan = _wide_plan(layout)
    a, b, c = plan["a"], plan["b"], plan["c"]
    g = torch.Generator().manual_seed(len(layout))
    occ = (torch.rand(shape, generator=g) < 0.004).to(torch.uint8)
    occ[:, :3] = 0                                 # all-far tiles
    occ = occ.to(dev)
    p1 = edt.binary_wide(occ, plan, a)
    _eq(p1, edt._binary_wide_plain(occ, plan, a))
    p2 = edt.window_wide(p1, plan, b)
    _eq(p2, edt._window_wide_plain(p1, plan, b))
    _eq(edt.split_wide(p2, plan, c), edt._split_wide_plain(p2, plan, c))
    for o in _closest_binary_edges(shape, a, WIDE_T, g):
        o = o.to(dev)
        _eq(edt.binary_wide(o, plan, a), edt._binary_wide_plain(o, plan, a))
    for x in _window_edges(shape, plan, b, g, torch.int64):
        x = x.to(dev)
        _eq(edt.window_wide(x, plan, b), edt._window_wide_plain(x, plan, b))
    for x in _split_edges(shape, plan, g, torch.int64):
        x = x.to(dev)
        _eq(edt.split_wide(x, plan, c), edt._split_wide_plain(x, plan, c))
    kernels.reset_launch_counts()
    for fn, name in ((lambda: edt.binary_wide(occ, plan, a),
                      "void closest_binary_wide_kernel"),
                     (lambda: edt.window_wide(p1, plan, b),
                      "closest_window_wide_kernel"),
                     (lambda: edt.split_wide(p2, plan, c),
                      "void closest_split_wide_kernel")):
        _, names = _cuda_kernels(fn)
        assert [n.split("<")[0] for n in names] == [name]
    assert [kernels.LAUNCHES[k] for k in ("closest_binary_wide",
                                          "closest_window_wide",
                                          "closest_split_wide")] == [1, 1, 1]


# the wide split's tiles (closest_split_wide_kernel<T>): plans either side
# of the edge of its 32-bit tile words, a column count that is no multiple
# of its 16-column tiles, columns of several chunks, and long columns (1600
# rows, chunked in either word form); {case: ([outer, A, inner], t, s,
# chunk rows, or None for the kernel's own)}
SPLIT_TILES = {"u32_below_edge": ((3, 100, 7), 45, 20, None),
               "u64_above_edge": ((3, 100, 7), 46, 20, None),
               "chunks_u32": ((2, 200, 16), 10, 16, 24),
               "chunks_u64": ((2, 200, 16), 10, 29, 24),
               "long_u32": ((2, 1600, 8), 100, 17, None),
               "long_u64": ((2, 1600, 8), 100, 18, None)}


def _split_plan(t, s):
    return dict(a=0, b=2, c=1, ba=s // 2, bb=s - s // 2, s=s, cap=t * t + 1,
                t=t)


@pytest.mark.parametrize("case", sorted(SPLIT_TILES))
def test_closest_split_wide_tiles(dev, case):
    """The wide split against its plain version on words at its bounds'
    edges (``_split_edges``) and on lone values t_local and t_local + 1
    rows from each chunk edge, on the tile word
    ``kernels.split_wide_word_bits`` picks; one CUDA launch a call, of
    closest_split_wide_kernel on that word, by name."""
    shape, t, s, rows = SPLIT_TILES[case]
    plan = _split_plan(t, s)
    a, cap = shape[1], plan["cap"]
    tl = min(t, a - 1)
    bits = kernels.split_wide_word_bits(plan, a)
    assert bits == (64 if "u64" in case else 32)
    rows = rows or kernels.closest_split_wide_residency(
        shape, plan, 1)["chunk_rows"]
    assert (rows < a) == (not case.endswith("edge"))
    g = torch.Generator().manual_seed(len(case))
    xs = _split_edges(shape, plan, g, torch.int64)
    lone = torch.full((a, shape[0] * shape[2]), cap, dtype=torch.int64)
    at = [r for e in range(rows, a, rows)
          for r in (e - tl, e - tl - 1, e - 1 + tl, e + tl)] or [0]
    for j in range(lone.shape[1]):
        lone[at[j % len(at)] % a, j] = j % 3
    pay = torch.randint(0, 1 << s, lone.shape, generator=g)
    xs.append(((lone << s) | pay).reshape(a, shape[0], shape[2])
              .permute(1, 0, 2).contiguous())
    for x in xs:
        x = x.to(dev)
        _eq(kernels._closest_split_wide(x, plan, 1, rows=rows),
            edt._split_wide_plain(x, plan, 1))
    x = xs[0].to(dev)
    _eq(edt.split_wide(x, plan, 1), edt._split_wide_plain(x, plan, 1))
    kernels.reset_launch_counts()
    _, names = _cuda_kernels(
        lambda: kernels._closest_split_wide(x, plan, 1, rows=rows))
    word = {32: "unsigned int", 64: "unsigned long long"}[bits]
    assert names == [f"void closest_split_wide_kernel<{word}>"]
    assert kernels.LAUNCHES["closest_split_wide"] == 1


# the launcher's tiles (closest.cu's split_tiles), as
# tests/test_torch_split_wide_tiles.py's TILES holds them: {case: (shape,
# t, s, tile word bits or None for the plan's own, (columns, chunk rows))}
SPLIT_RESIDENCY = {
    "map_800": ((800, 800, 80), 100, 17, None, (16, 800)),
    "map_1600": ((1600, 1600, 80), 100, 18, None, (16, 320)),
    "map_800_u64": ((800, 800, 80), 100, 17, 64, (16, 267)),
    "long_1600_u32": ((8, 1600, 8), 100, 17, None, (16, 534)),
    "t_2000_a_400": ((8, 400, 8), 2000, 12, None, (16, 400)),
    "t_2000_a_3000": ((8, 3000, 8), 2000, 12, None, (8, 3000))}


@pytest.mark.parametrize("case", sorted(SPLIT_RESIDENCY))
def test_closest_split_wide_residency(dev, case):
    """The launcher's columns and chunk rows are the CPU model's; at 16
    columns a block four blocks (32 warps) reside an SM in u32 and three
    in u64 (the wide path's two maps, the split along y: 800 rows in u32,
    1600 in u64), with no spills."""
    shape, t, s, bits, tiles = SPLIT_RESIDENCY[case]
    plan = _split_plan(t, s)
    r = kernels.closest_split_wide_residency(shape, plan, 1, bits=bits)
    bits = bits or kernels.split_wide_word_bits(plan, shape[1])
    assert r["word_bytes"] == bits // 8, r
    assert (r["tile_cols"], r["chunk_rows"]) == tiles, r
    if r["tile_cols"] == 16:
        assert r["blocks_per_sm"] >= (4 if bits == 32 else 3), r
        assert bits == 64 or r["warps_per_sm"] >= 32, r
    assert r["blocks_per_sm"] >= 1 and r["local_bytes"] == 0, r


# (t, s, a) of tests/test_torch_split_wide_tiles.py's test_word_bits_edge
WORD_BITS_EDGE = [(45, 20, 100), (46, 20, 100), (1, 30, 9), (1, 31, 9),
                  (2, 30, 9), (50, 12, 30), (100, 17, 800), (100, 18, 1600),
                  (2000, 12, 400), (2000, 9, 40)]


def test_split_wide_u32_edge_agrees(dev):
    """The launcher's u32 rule (``split_wide_fits_u32`` in closest.cu,
    which refuses u32 tile words past it) and the wrapper's
    ``kernels.split_wide_word_bits`` agree: on the edge table of the CPU
    tests, and over t, s and a on both sides of the edge for every s
    (t_local one below, at and one above the largest that fits, through
    columns shorter and longer than t)."""
    cases = list(WORD_BITS_EDGE)
    for s in range(1, 32):
        # the largest t whose full-column words fit: 2 t^2 + 2 <= 2^(32-s)
        edge = math.isqrt(((1 << (32 - s)) - 2) // 2)
        for t in {1, 2, 45, 46, 100, 2000, max(edge - 1, 1), max(edge, 1),
                  edge + 1}:
            for a in (2, t, t + 1, t + 2, 2 * t + 3):
                cases.append((t, s, a))
    both = set()
    for t, s, a in cases:
        plan = _split_plan(t, s)
        fits = kernels.split_wide_fits_u32(plan, a)
        assert fits == (kernels.split_wide_word_bits(plan, a) == 32), \
            (t, s, a)
        both.add(fits)
    assert both == {True, False}


def _decode_words(shape, plan, dtype, g, dev, x0=0, dc2=None):
    """Split-pass words [X,Y,Z] of ``dtype`` on ``dev`` for the decode:
    each voxel's witness a few voxels away (its x global: + ``x0``), a
    fifth undefined (val = cap), sign 1 for a witness at higher c; or,
    with ``dc2`` (a list), the witness on the voxel's own a and b and dc2
    drawn from the list."""
    a, b = plan["a"], plan["b"]
    iota = [torch.arange(n).reshape([-1 if i == k else 1 for i in range(3)])
            .expand(shape) + (x0 if k == 0 else 0)
            for k, n in enumerate(shape)]

    def near(k):
        off = torch.randint(-3, 4, shape, generator=g)
        lo = x0 if k == 0 else 0
        return torch.clamp(iota[k] + off, lo, lo + shape[k] - 1)

    if dc2 is None:
        astar, bstar = near(a), near(b)
        dc = torch.randint(-5, 6, shape, generator=g)
        val = (iota[a] - astar) ** 2 + (iota[b] - bstar) ** 2 + dc * dc
        val[torch.rand(shape, generator=g) < 0.2] = plan["cap"]
        sign = (dc > 0) | ((dc == 0) & (torch.rand(shape, generator=g) < 0.5))
    else:
        astar, bstar = iota[a], iota[b]
        val = torch.tensor(dc2)[torch.randint(0, len(dc2), shape,
                                              generator=g)]
        sign = torch.rand(shape, generator=g) < 0.5
    s, ba = plan["s"], plan["ba"]
    return ((val << (s + 1)) | (sign.long() << s) | (bstar << ba)
            | astar).to(dtype).to(dev)


# (shape, plan, word dtype, x0): the cow transform's words, the widest-C
# packed plan, wide plans from i64 words, and an X-slab of the cow grid
# whose payloads hold global x (x0 150, as the sharded engine's)
DECODE = {"cow": ((400, 400, 80), 100, "packed", 0),
          "widest_c": ((64, 16, 8), 1500, "packed", 0),
          "wide_x_lead": ((40, 40, 8), WIDE_T, "wide", 0),
          "wide_long_c": ((40, 400, 8), WIDE_T, "wide", 0),
          "slab_x0": ((50, 400, 80), 100, "packed", 150)}


@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize("layout", sorted(DECODE))
def test_closest_decode_kernel(dev, layout, packed_out):
    """The decode kernel against its plain version in both formats: on
    the real transform's words (cow: kernels' passes; wide: the wide
    passes) and on synthetic words with undefined voxels, a slab's x
    origin; one CUDA launch a call, by name."""
    shape, t, kind, x0 = DECODE[layout]
    gshape = (400, 400, 80) if layout == "slab_x0" else shape
    plan = (edt.closest_plan(gshape, t) if kind == "packed"
            else edt.closest_plan_wide(shape, t))
    dtype = torch.int32 if kind == "packed" else torch.int64
    g = torch.Generator().manual_seed(len(layout) + packed_out)
    words = [_decode_words(shape, plan, dtype, g, dev, x0)]
    if x0 == 0:
        occ = (torch.rand(shape, generator=g) < 0.005).to(dev)
        if kind == "packed":
            words.append(edt.split_packed(edt.window_packed(edt.binary_packed(
                occ.view(torch.uint8), plan, plan["a"]), plan, plan["b"]),
                plan, plan["c"]))
        else:
            words.append(edt.split_wide(edt.window_wide(edt.binary_wide(
                occ, plan, plan["a"]), plan, plan["b"]), plan, plan["c"]))
    for w in words:
        assert w.dtype == dtype
        got = edt.decode_split(w, plan, packed_out, x0)
        ref = edt._decode_split_plain(w, plan, packed_out, x0)
        for a, b in zip(got, ref):
            _eq(a, b)
        assert int((got[0] < ft.grid.INF_D2).sum()) > 0
    kernels.reset_launch_counts()
    _, names = _cuda_kernels(lambda: edt.decode_split(w, plan, packed_out,
                                                      x0))
    assert [n.split("<")[0] for n in names] == ["void closest_decode_kernel"]
    assert kernels.LAUNCHES["closest_decode"] == 1


@pytest.mark.parametrize("kind", ["packed", "wide"])
def test_closest_decode_kernel_rounds_half_to_even(dev, kind):
    """dc2 = k^2 + k for k in 2048, 2049, 3000: the f32 root is exactly
    k + 0.5 and the kernel rounds it half to even (rintf), as the plain
    version's torch.round does."""
    shape = (8, 8, 8)
    plan = (edt.closest_plan(shape, 3100) if kind == "packed"
            else edt.closest_plan_wide(shape, 3100))
    dtype = torch.int32 if kind == "packed" else torch.int64
    g = torch.Generator().manual_seed(7)
    dc2 = [k * k + k for k in (2048, 2049, 3000)] + [4, 0]
    w = _decode_words(shape, plan, dtype, g, dev, dc2=dc2)
    got = edt.decode_split(w, plan)
    for a, b in zip(got, edt._decode_split_plain(w, plan)):
        _eq(a, b)
    c = plan["c"]
    ic = torch.arange(shape[c], device=dev).reshape(
        [-1 if i == c else 1 for i in range(3)])
    dc = (got[1][c].long() - ic).abs()
    for k in (2048, 2049, 3000):
        assert set((dc[got[0] == k * k + k]).tolist()) == {k + k % 2}


@pytest.mark.parametrize("packed_out", [False, True])
def test_wide_transform_kernels_equal_plain(dev, monkeypatch, packed_out):
    """The wide transform on the card: the three wide kernels and the
    decode, once each, equal to the transform through the plain
    versions; its d2 the d2-only transform's."""
    occ = (torch.rand((40, 400, 8), generator=torch.Generator().manual_seed(
        8)) < 0.004).to(dev)
    kernels.reset_launch_counts()
    got = edt.edt_closest_auto(occ, WIDE_T, packed_out)
    assert [kernels.LAUNCHES[k] for k in
            ("closest_binary_wide", "closest_window_wide",
             "closest_split_wide", "closest_decode", "closest_binary",
             "closest_window", "closest_split")] == [1, 1, 1, 1, 0, 0, 0]
    for name, plain in (("binary_wide", edt._binary_wide_plain),
                        ("window_wide", edt._window_wide_plain),
                        ("split_wide", edt._split_wide_plain),
                        ("decode_split", edt._decode_split_plain)):
        monkeypatch.setattr(edt, name, plain)
    ref = edt.truncated_edt_d2_closest_wide(occ, WIDE_T, packed_out)
    for a, b in zip(got, ref):
        _eq(a, b)
    _eq(got[0], edt.truncated_edt_d2(occ, WIDE_T))


def test_stream_kernels_equal_plain(dev, monkeypatch):
    cfg = replay.scale_intrinsics(ft.FiestaConfig(
        resolution=0.1, origin=(-2.25, -2.15, -0.95), map_size=(4.5, 4.3, 2.5),
        min_ray_length=0.3, max_ray_length=1.5, trunc_dist=1.2,
        edt_fine_dist=1.2, max_points_per_scan=24 * 32), 24, 32)
    _, frames = replay.make_sequence(cfg, n_frames=12, n_boxes=5, seed=1,
                                     height=24, width=32, orbit_radius=0.8)
    batches = replay.stage_update_batches(cfg, frames, device=dev)
    kernels.reset_launch_counts()
    k_state, k_stats = pipeline.fused_stream(cfg, ft.make_state(cfg, dev),
                                             *batches)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {
        "splat": 4, "carve": 4, "edt_binary": 4, "edt_minplus": 8,
        "fuse": 4, "boxadd": 4, "closest_binary": 0, "closest_window": 0,
        "closest_split": 0, "closest_decode": 0, "closest_binary_wide": 0,
        "closest_window_wide": 0, "closest_split_wide": 0, "sort": 0,
        "relax": 0, "depth": 0, "prep": 4, "changes": 0}
    monkeypatch.setattr(raycast, "_scanline_splat_prep",
                        raycast._scanline_splat_prep_plain)
    monkeypatch.setattr(raycast, "splat_packed", raycast._splat_packed_plain)
    monkeypatch.setattr(raycast, "carve_free_mask_batch",
                        raycast._carve_free_plain)
    monkeypatch.setattr(raycast, "apply_box_counts",
                        raycast._apply_box_counts_plain)
    monkeypatch.setattr(fusion, "fuse_drain", fusion._fuse_drain_plain)
    monkeypatch.setattr(edt, "binary_pass", edt._binary_pass_plain)
    monkeypatch.setattr(edt, "minplus_pass", edt._minplus_pass_plain)
    p_state, p_stats = pipeline.fused_stream(cfg, ft.make_state(cfg, dev),
                                             *batches)
    for f in dataclasses.fields(k_state):
        _eq(getattr(k_state, f.name), getattr(p_state, f.name))
    for a, b in zip(k_stats, p_stats):
        _eq(a, b)
    assert kernels.LAUNCHES["splat"] == 4          # the plain run: none
    assert kernels.LAUNCHES["prep"] == 4


def _sort_keys(kind, n, g):
    """Keys i32 [n]: random with heavy duplicates and drop sentinels, all
    equal, already sorted or reverse sorted."""
    keys = torch.randint(0, 1 << 25, (n,), generator=g, dtype=torch.int32)
    if kind == "random":
        keys[torch.randint(0, n, (max(n // 5, 1),), generator=g)] = 777
        keys[: n // 9] = 1 << 25                   # drop sentinels
    elif kind == "equal":
        keys[:] = 777
    elif kind == "sorted":
        keys = keys.sort().values
    else:
        keys = keys.sort(descending=True).values
    return keys


@pytest.mark.parametrize("kind,n", [
    ("random", 1), ("random", 255), ("random", 256), ("random", 1000),
    ("random", 4096), ("random", (1 << 18) + 3), ("random", 147456),
    ("random", (1 << 20) + 5), ("equal", 147456), ("sorted", 147456),
    ("reversed", 147456)])
def test_sort_kernel(dev, kind, n):
    g = torch.Generator().manual_seed(n)
    keys = _sort_keys(kind, n, g)
    vals = torch.rand(n, generator=g)
    keys, vals = keys.to(dev), vals.to(dev)
    kernels.reset_launch_counts()
    got, names = _cuda_kernels(lambda: sort.sort_pairs(keys, vals))
    assert kernels.LAUNCHES["sort"] == 1
    assert names == ["sort_network"]               # one cooperative launch
    ref = sort._sort_pairs_plain(keys, vals)
    _eq(got[0], ref[0])
    _eq(got[1].view(torch.int32), ref[1].view(torch.int32))
    assert bool((got[0][1:] >= got[0][:-1]).all())


@pytest.mark.parametrize("window", [((3, 5, 2), (20, 30, 11)),
                                    ((0, 0, 0), (99, 99, 99)),
                                    ((9, 9, 9), (8, 30, 12)),
                                    ((1, 2, 3), (7, 9, 9))],
                         ids=["inner", "whole", "empty", "cut"])
@pytest.mark.parametrize("shape", [(48, 40, 24), (23, 37, 13), (9, 11, 6),
                                   (6, 5, 7)])
def test_fuse_kernel_window(dev, shape, window):
    """Windows inside, around, outside and cutting 4-voxel groups (z from
    3 to 9), on grids whose z is a multiple of 4 (each group in one z row)
    or not (groups cross row ends: gz = 13, 6, 7)."""
    rng = np.random.default_rng(sum(shape))
    lo = rng.uniform(-2.0, 3.5, shape).astype(np.float32)
    seen = (rng.random(shape) < 0.5).astype(np.uint8)
    hit = rng.integers(0, 256, shape).astype(np.uint8)
    miss = np.where(rng.random(shape) < 0.3, 0,
                    rng.integers(0, 256, shape)).astype(np.uint8)
    args = [torch.from_numpy(a).to(dev) for a in (lo, seen, hit, miss)]
    win = tuple(torch.tensor(w, dtype=torch.int32, device=dev)
                for w in window)
    kw = dict(l_hit=0.85, l_miss=-0.4, clamp_min=-2.0, clamp_max=3.5,
              occ_thresh=0.4, occ_is_eq=False, window=win)
    kernels.reset_launch_counts()
    got = fusion.fuse_drain(*args, **kw)
    assert kernels.LAUNCHES["fuse"] == 1
    ref = fusion._fuse_drain_plain(*args, **kw)
    for a, b in zip(got, ref):
        _eq(a, b)


def test_fuse_kernel_window_past_2_31_voxels(dev):
    """The windowed drain's 64-bit form (``fuse_kernel<true, unsigned long
    long>``, taken past 2^31 voxels) on a grid of 2.18 G voxels (about
    33 GB at 15 bytes a voxel) with a small window across voxel 2^31.
    The drain writes every voxel, so every output is compared chunk by
    chunk along x with the plain drain of that chunk (its window moved to
    the chunk's coordinates), and the three counts with the chunks' sums:
    the plain drain of the whole grid would not fit beside the kernel's
    buffers."""
    free, _ = torch.cuda.mem_get_info(dev)
    if free < 40 * 2 ** 30:
        pytest.skip(f"needs 40 GB of free card memory, has "
                    f"{free / 2 ** 30:.1f} GB")
    shape = (1040, 1024, 2048)
    assert np.prod(shape) > 2 ** 31
    g = torch.Generator(device=dev).manual_seed(0)
    lo = torch.empty(shape, dtype=torch.float32, device=dev).uniform_(
        -2.0, 3.5, generator=g)
    seen, hit, miss = (torch.randint(0, n, shape, dtype=torch.uint8,
                                     device=dev, generator=g)
                       for n in (2, 256, 256))
    wmin = torch.tensor([1020, 300, 900], dtype=torch.int32, device=dev)
    wmax = torch.tensor([1030, 340, 1000], dtype=torch.int32, device=dev)
    kw = dict(l_hit=0.85, l_miss=-0.4, clamp_min=-2.0, clamp_max=3.5,
              occ_thresh=0.4, occ_is_eq=False)
    kernels.reset_launch_counts()
    got, names = _cuda_kernels(lambda: fusion.fuse_drain(
        lo, seen, hit, miss, window=(wmin, wmax), **kw))
    assert kernels.LAUNCHES["fuse"] == 1
    # beside the wrapper's own small launches (the counts' zero fill and
    # the window's bounds)
    fuse = [n for n in names if "fuse_kernel" in n]
    assert len(fuse) == 1 and \
        "fuse_kernel<true, unsigned long long>" in fuse[0], names
    sums = [0, 0, 0]
    for x0 in range(0, shape[0], 16):
        x1 = min(x0 + 16, shape[0])
        off = torch.tensor([x0, 0, 0], dtype=torch.int32, device=dev)
        ref = fusion._fuse_drain_plain(
            lo[x0:x1], seen[x0:x1], hit[x0:x1], miss[x0:x1],
            window=(wmin - off, wmax - off), **kw)
        _eq(got[0][x0:x1].view(torch.int32), ref[0].view(torch.int32))
        for a, b in zip(got[1:5], ref[1:5]):
            _eq(a[x0:x1], b)
        for i in range(3):
            sums[i] += int(ref[5 + i])
    assert [int(n) for n in got[5:]] == sums
    assert sums[0] > 0


def test_sorted_stream_launches_sort(dev, monkeypatch):
    """The stream in sorted-splat mode with the bitonic sort: the sort
    kernel launches once a tick and the state equals the direct splat's."""
    cfg = replay.scale_intrinsics(ft.FiestaConfig(
        resolution=0.1, origin=(-2.4, -2.4, -1.0), map_size=(4.8, 4.8, 3.2),
        min_ray_length=0.3, max_ray_length=1.5, trunc_dist=1.2,
        edt_fine_dist=1.2, max_points_per_scan=24 * 32), 24, 32)
    _, frames = replay.make_sequence(cfg, n_frames=9, n_boxes=5, seed=1,
                                     height=24, width=32, orbit_radius=0.8)
    batches = replay.stage_update_batches(cfg, frames, device=dev)
    direct, d_stats = pipeline.fused_stream(cfg, ft.make_state(cfg, dev),
                                            *batches)
    monkeypatch.setattr(raycast, "_SPLAT_ORDER", "sorted")
    monkeypatch.setattr(raycast, "_SPLAT_SORT_IMPL", "pallas")
    kernels.reset_launch_counts()
    srt, s_stats = pipeline.fused_stream(cfg, ft.make_state(cfg, dev),
                                         *batches)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sort"] == 3
    for f in dataclasses.fields(direct):
        _eq(getattr(srt, f.name), getattr(direct, f.name))
    for a, b in zip(s_stats, d_stats):
        _eq(a, b)


@pytest.mark.parametrize("kind", ["cloud", "depth"])
@pytest.mark.parametrize("method", ["scanline", "dda", "projective"])
def test_engine_kernels_equal_plain(dev, monkeypatch, method, kind):
    """``FiestaPipeline`` on the card, kernels against plain versions, in
    local-window mode (the windowed drain); with the kernels, ``process()``
    and ``update()`` never wait for the device."""
    cfg = dataclasses.replace(replay.scale_intrinsics(ft.FiestaConfig(
        resolution=0.1, origin=(-2.4, -2.4, -0.5), map_size=(4.8, 4.8, 2.0),
        min_ray_length=0.3, max_ray_length=2.0, trunc_dist=1.2,
        edt_fine_dist=1.2, max_points_per_scan=24 * 32, global_update=False,
        radius=(1.8, 1.8, 0.5)), 24, 32))
    _, frames = replay.make_sequence(cfg, n_frames=6, n_boxes=5, seed=3,
                                     height=24, width=32, orbit_radius=0.6,
                                     kind=kind)

    def run(sync_mode):
        pipe, n = ft.FiestaPipeline(cfg, method=method, device=dev), 0
        torch.cuda.set_sync_debug_mode(sync_mode)
        try:
            for i, (t, (pos, quat), scan) in enumerate(frames):
                pipe.observe_pose(t, pos, quat)
                (pipe.observe_cloud if kind == "cloud"
                 else pipe.observe_depth)(t, scan)
                n += pipe.process()
                if i % 3 == 2:
                    pipe.update()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        pipe.sync_device()
        return pipe, n

    kernels.reset_launch_counts()
    k_pipe, n = run("error")
    # the last frame waits for a newer pose; depth mode drops the first
    assert n == (5 if kind == "cloud" else 4)
    assert kernels.LAUNCHES["fuse"] == 2 and kernels.LAUNCHES["edt_binary"] \
        == 2
    if method == "scanline":
        # one prep, splat and carve a batched integrate call
        assert kernels.LAUNCHES["prep"] == kernels.LAUNCHES["splat"] == \
            kernels.LAUNCHES["carve"] == n
    else:
        assert kernels.LAUNCHES["prep"] == 0
    # every converted frame, the first (which yields nothing) among them
    assert kernels.LAUNCHES["depth"] == (0 if kind == "cloud" else n + 1)
    monkeypatch.setattr(raycast, "_scanline_splat_prep",
                        raycast._scanline_splat_prep_plain)
    monkeypatch.setattr(raycast, "splat_packed", raycast._splat_packed_plain)
    monkeypatch.setattr(raycast, "carve_free_mask_batch",
                        raycast._carve_free_plain)
    monkeypatch.setattr(raycast, "apply_box_counts",
                        raycast._apply_box_counts_plain)
    monkeypatch.setattr(fusion, "fuse_drain", fusion._fuse_drain_plain)
    monkeypatch.setattr(edt, "binary_pass", edt._binary_pass_plain)
    monkeypatch.setattr(edt, "minplus_pass", edt._minplus_pass_plain)
    p_pipe, _ = run("default")
    for f in dataclasses.fields(k_pipe.state):
        _eq(getattr(k_pipe.state, f.name), getattr(p_pipe.state, f.name))
    assert int(k_pipe.occupied().sum()) > 50


# the two-level EDT's coarse levels: cow (400x400x80 at t = 100, exact to
# t = 40) and demo (400x400x36 at t = 50, exact to t = 20), both with
# t >= gz on the half grid
COARSE = {"cow": ((200, 200, 40), 50), "demo": ((200, 200, 18), 25)}


@pytest.mark.parametrize("level", sorted(COARSE))
def test_coarse_level_kernels(dev, level):
    """The EDT passes and the three closest passes at the coarse level's
    shapes, on the any-pool of a random fine occupancy and on an empty
    grid, each equal to its plain version."""
    shape, t = COARSE[level]
    g = torch.Generator().manual_seed(t)
    fine = torch.rand(tuple(2 * n for n in shape), generator=g) < 0.002
    plan = edt.closest_plan(shape, t)
    a, b, c = plan["a"], plan["b"], plan["c"]
    for occ in (edt.downsample2_any(fine).to(dev),
                torch.zeros(shape, dtype=torch.bool, device=dev)):
        f = torch.full(shape, INF, dtype=torch.int32,
                       device=dev).masked_fill_(occ, 0)
        p1 = edt.binary_pass(f, t)
        _eq(p1, edt._binary_pass_plain(f, t))
        p2 = edt.minplus_pass(p1, t, 1)
        _eq(p2, edt._minplus_pass_plain(p1, t, 1))
        _eq(edt.minplus_pass(p2, t, 2), edt._minplus_pass_plain(p2, t, 2))
        o8 = occ.view(torch.uint8)
        q1 = edt.binary_packed(o8, plan, a)
        _eq(q1, edt._binary_packed_plain(o8, plan, a))
        q2 = edt.window_packed(q1, plan, b)
        _eq(q2, edt._window_packed_plain(q1, plan, b))
        _eq(edt.split_packed(q2, plan, c), edt._split_packed_plain(q2, plan, c))


@pytest.mark.parametrize("packed_out", [False, True])
def test_hierarchical_transform_kernels_equal_plain(dev, monkeypatch,
                                                    packed_out):
    """Both levels through the kernels (each closest kernel once a level),
    equal to the transform through the plain versions."""
    occ = (torch.rand((48, 40, 24), generator=torch.Generator().manual_seed(
        6)) < 0.01).to(dev)
    kernels.reset_launch_counts()
    got = edt.hierarchical_edt_d2_closest(occ, 5, 12, packed_out)
    d2 = edt.hierarchical_edt_d2(occ, 5, 12)
    assert [kernels.LAUNCHES[k] for k in
            ("closest_binary", "closest_window", "closest_split",
             "closest_decode", "edt_binary", "edt_minplus")] \
        == [2, 2, 2, 2, 2, 4]
    for name, plain in (("binary_packed", edt._binary_packed_plain),
                        ("window_packed", edt._window_packed_plain),
                        ("split_packed", edt._split_packed_plain),
                        ("decode_split", edt._decode_split_plain),
                        ("binary_pass", edt._binary_pass_plain),
                        ("minplus_pass", edt._minplus_pass_plain)):
        monkeypatch.setattr(edt, name, plain)
    ref = edt.hierarchical_edt_d2_closest(occ, 5, 12, packed_out)
    for x, y in zip(got, ref):
        _eq(x, y)
    _eq(d2, edt.hierarchical_edt_d2(occ, 5, 12))
    _eq(got[0], d2)


def test_plan_step_card_matches_cpu(dev):
    """One solve on the card and on the CPU from the same draws, within
    ``tests/test_torch_mpc.py``'s gate (1e-3 in controls and positions,
    1e-3 relative in cost): the softmax over K, the weighted control and
    the sums run in other orders.  ``plan_step`` with a CUDA generator
    gives finite costs, best <= mean."""
    from fiesta_tpu_torch.ops import query
    from fiesta_tpu_torch.planning import mpc

    cfg = ft.FiestaConfig(resolution=0.1, origin=(-2.0, -2.0, -1.0),
                          map_size=(4.0, 4.0, 2.0), trunc_dist=1.0,
                          edt_fine_dist=1.0)
    occ = torch.zeros(cfg.grid_shape, dtype=torch.bool)
    occ[17:23, 17:23, 6:14] = True
    occ[8:12, 25:30, 2:9] = True
    d2 = edt.truncated_edt_d2(occ, 10)
    dist = query.distance_grid(cfg, d2, torch.ones_like(occ,
                                                        dtype=torch.uint8))
    m = mpc.MPCConfig(horizon=16, n_rollouts=2048)
    args = [torch.tensor(x, dtype=torch.float32) for x in (
        [-1.5, -1.5, 0.0], [0.2, 0.0, 0.0], [1.6, 1.6, 0.3])]
    args.append(torch.zeros((16, 3)))
    normals = torch.randn((16, 3, 2048), generator=torch.Generator()
                          .manual_seed(0))
    cpu = mpc._plan_step_impl(cfg, m, dist, *args, normals)
    card = mpc._plan_step_impl(cfg, m, dist.to(dev),
                               *(x.to(dev) for x in args), normals.to(dev))
    torch.cuda.synchronize()
    assert (card.controls.cpu() - cpu.controls).abs().max() < 1e-3
    assert (card.positions.cpu() - cpu.positions).abs().max() < 1e-3
    assert abs(float(card.cost) - float(cpu.cost)) <= 1e-3 * float(cpu.cost)
    res = mpc.plan_step(cfg, m, dist.to(dev), *(x.to(dev) for x in args),
                        torch.Generator(device=dev).manual_seed(0))
    assert all(bool(torch.isfinite(x).all()) for x in res)
    assert float(res.best_sample_cost) <= float(res.mean_sample_cost)


# ---------------------------------------------------------------------------
# the relax kernel (the incremental ESDF)
# ---------------------------------------------------------------------------

RELAX_SHAPE = (40, 36, 24)


def _relax_dirs(conn, jumps, shape=RELAX_SHAPE):
    extra = tuple(d for d in jump_offsets(16)
                  if all(abs(d[i]) < shape[i] for i in range(3)))
    return stencil_offsets(conn) + (extra if jumps else ())


def _relax_seeds(shape, p, seed, dev):
    """d2 / closest seeded at a random occupancy, on ``dev``."""
    g = torch.Generator().manual_seed(seed)
    occ = (torch.rand(shape, generator=g) < p).to(dev)
    d2 = torch.where(occ, 0, ft.grid.INF_D2).to(torch.int32)
    c = torch.where(occ[None], ft.grid.coord_grids(shape, dev), -1)
    return occ, d2, c.to(torch.int16)


def _relax_check(d2, c, masks, dirs, max_iters=0):
    """The kernel (one CUDA launch, ``relax_sweeps``, through
    ``esdf.relax_to_fixpoint``) against ``relax_once``'s host loop, and the
    tiles ``kernels.relax_sweeps`` logs it visited per sweep: every tile in
    the first sweep, between 1 and every tile in each later one, none after
    the last.  Returns (sweeps, tiles visited per sweep, tile count)."""
    before = kernels.LAUNCHES["relax"]
    got, names = _cuda_kernels(lambda: esdf.relax_to_fixpoint(
        d2, c, *masks[:2], dirs, max_iters, *masks[2:]))
    assert kernels.LAUNCHES["relax"] == before + 1
    assert names == ["relax_sweeps"]
    ref = esdf._relax_to_fixpoint_plain(d2, c, *masks[:2], dirs, max_iters,
                                        *masks[2:])
    for a, b in zip(got, ref):
        _eq(a, b)
    sweeps = int(got[2])
    ntiles = int(np.prod([-(-n // t) for n, t in zip(d2.shape,
                                                      kernels.RELAX_TILE)]))
    d2_s, c_s, state = kernels.relax_sweeps(
        d2, c, *masks[:2], dirs, max_iters, *masks[2:])
    _eq(d2_s, ref[0])
    _eq(c_s, ref[1])
    state = state.cpu().tolist()
    assert state[1] == sweeps
    assert 1 <= state[2] <= ntiles          # the cooperative grid's blocks
    visited = state[3:3 + sweeps]
    assert visited[0] == ntiles
    assert all(0 < v <= ntiles for v in visited)
    assert not any(state[3 + sweeps:])
    return sweeps, visited, ntiles


@pytest.mark.parametrize("jumps", [False, True], ids=["stencil", "jumps"])
@pytest.mark.parametrize("conn", sorted(STENCILS))
def test_relax_kernel(dev, conn, jumps):
    occ, d2, c = _relax_seeds(RELAX_SHAPE, 0.002, conn, dev)
    sweeps, _, _ = _relax_check(d2, c, (None,) * 4, _relax_dirs(conn, jumps))
    assert sweeps > 2


def _relax_window(occ):
    w = torch.zeros_like(occ)
    w[6:30, 4:28, 3:17] = True
    return (w | occ, w, occ, w)


@pytest.mark.parametrize("max_iters", [0, 1, 2, 3])
@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
def test_relax_kernel_masks_and_max_iters(dev, window, max_iters):
    """The windowed masks with the push pass (update = window | queued,
    source = window, push from the queued voxels into the window), and
    ``max_iters`` 1, 2, 3 (stopping on an odd and on an even sweep: the
    final copy of the scratch) and 0 (to the fixpoint)."""
    occ, d2, c = _relax_seeds(RELAX_SHAPE, 0.002, 5, dev)
    masks = _relax_window(occ) if window else (None,) * 4
    sweeps, _, _ = _relax_check(d2, c, masks, _relax_dirs(24, True),
                                max_iters)
    if max_iters:
        assert sweeps == max_iters


def test_relax_kernel_converged_and_undefined(dev):
    """A converged input takes exactly one sweep and comes back equal; so
    does an all-undefined grid."""
    occ, d2, c = _relax_seeds(RELAX_SHAPE, 0.002, 8, dev)
    dirs = _relax_dirs(24, True)
    d2f, cf, _ = esdf.relax_to_fixpoint(d2, c, None, None, dirs)
    assert _relax_check(d2f, cf, (None,) * 4, dirs)[0] == 1
    _eq(esdf.relax_to_fixpoint(d2f, cf, None, None, dirs)[0], d2f)
    none_d2 = torch.full(RELAX_SHAPE, ft.grid.INF_D2, dtype=torch.int32,
                         device=dev)
    none_c = torch.full((3,) + RELAX_SHAPE, -1, dtype=torch.int16,
                        device=dev)
    assert _relax_check(none_d2, none_c, (None,) * 4, dirs)[0] == 1
    out = esdf.relax_to_fixpoint(none_d2, none_c, None, None, dirs)
    _eq(out[0], none_d2)
    _eq(out[1], none_c)


def test_relax_kernel_tie_order(dev):
    """A jump listed before a reach-1 offset with the same least
    candidate: the reach-1 offset wins, as in ``relax_once``."""
    shape = (10, 10, 10)
    d2 = torch.full(shape, ft.grid.INF_D2, dtype=torch.int32)
    c = torch.full((3,) + shape, -1, dtype=torch.int16)
    d2[6, 5, 5], c[:, 6, 5, 5] = 0, torch.tensor([6, 5, 5])
    d2[2, 6, 5], c[:, 2, 6, 5] = 9, torch.tensor([2, 9, 5])
    d2, c = d2.to(dev), c.to(dev)
    _relax_check(d2, c, (None,) * 4, ((4, 0, 0), (0, 1, 0)), max_iters=1)
    out = esdf.relax_to_fixpoint(d2, c, None, None, ((4, 0, 0), (0, 1, 0)),
                                 max_iters=1)
    assert out[1][:, 2, 5, 5].tolist() == [2, 9, 5]


def test_relax_kernel_several_voxels_a_thread(dev):
    """3.2 M voxels, more than the cooperative grid's resident threads."""
    shape = (200, 200, 80)
    occ, d2, c = _relax_seeds(shape, 2e-5, 9, dev)
    sweeps, _, _ = _relax_check(d2, c, _relax_window(occ),
                                _relax_dirs(24, True, shape))
    assert sweeps > 2


@pytest.mark.parametrize("shape", [(37, 29, 21), (9, 7, 17), (3, 2, 1)])
def test_relax_kernel_ragged_tiles(dev, shape):
    """Grids whose axes are no multiples of the 8 x 8 x 16 tile: partial
    tiles on every far face, and grids smaller than one tile."""
    occ, d2, c = _relax_seeds(shape, 0.01, sum(shape), dev)
    d2[0, 0, 0], c[:, 0, 0, 0] = 0, 0
    _relax_check(d2, c, (None,) * 4, _relax_dirs(24, True, shape))


def test_relax_kernel_sparse_corner_change(dev):
    """A converged map with one obstacle added in a corner: after the
    first sweep only the tiles around the change are visited."""
    shape = (64, 48, 40)
    occ, d2, c = _relax_seeds(shape, 3e-4, 12, dev)
    dirs = _relax_dirs(24, True, shape)
    d2f, cf, _ = esdf.relax_to_fixpoint(d2, c, None, None, dirs)
    d2f[1, 1, 1], cf[:, 1, 1, 1] = 0, 1
    sweeps, visited, ntiles = _relax_check(d2f, cf, (None,) * 4, dirs)
    assert sweeps > 2 and max(visited[1:]) < ntiles


def test_relax_kernel_far_jumps(dev):
    """Jumps of up to 64 voxels, past several tiles along every axis."""
    shape = (140, 72, 100)
    occ, d2, c = _relax_seeds(shape, 2e-5, 13, dev)
    dirs = stencil_offsets(24) + tuple(
        d for d in jump_offsets(64)
        if all(abs(d[i]) < shape[i] for i in range(3)))
    sweeps, _, _ = _relax_check(d2, c, (None,) * 4, dirs)
    assert sweeps > 2


def test_relax_kernel_change_carried_by_a_jump_alone(dev):
    """A change that only a long jump carries into a tile whose reach-2
    neighbours did not change: the tile is visited for the jump's changed
    bits, read from a tile two tiles away."""
    shape = (48, 8, 16)
    d2 = torch.full(shape, ft.grid.INF_D2, dtype=torch.int32)
    c = torch.full((3,) + shape, -1, dtype=torch.int16)
    d2[44, 3, 5], c[:, 44, 3, 5] = 0, torch.tensor([44, 3, 5])
    dirs = ((1, 0, 0), (-1, 0, 0), (16, 0, 0), (-16, 0, 0))
    sweeps, visited, ntiles = _relax_check(d2.to(dev), c.to(dev),
                                           (None,) * 4, dirs)
    assert sweeps > 3 and min(visited[1:]) < ntiles


def test_relax_kernel_caller_order_table(dev):
    """The 24-stencil in another order is no compiled stencil: the kernel
    takes its table loop, in the caller's order (ties included)."""
    rng = np.random.default_rng(3)
    dirs = tuple(stencil_offsets(24)[i] for i in rng.permutation(24)) + \
        _relax_dirs(24, True)[24:]
    occ, d2, c = _relax_seeds(RELAX_SHAPE, 0.002, 14, dev)
    _relax_check(d2, c, _relax_window(occ), dirs)


def test_relax_kernel_rejects_what_it_cannot_index(dev):
    d2 = torch.zeros((4, 4, 4), dtype=torch.int32, device=dev)
    c = torch.zeros((3, 4, 4, 4), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError, match="int16 direction table"):
        kernels.relax_to_fixpoint(d2, c, None, None, ((1 << 15, 0, 0),))
    with pytest.raises(ValueError, match="exceed"):
        kernels.relax_to_fixpoint(d2, c, None, None,
                                  tuple((0, 0, k) for k in range(3, 132)))
    with pytest.raises(ValueError, match="go together"):
        kernels.relax_to_fixpoint(d2, c, None, None, ((1, 0, 0),),
                                  push_src_mask=d2 == 0)


def _incremental_plain(monkeypatch):
    monkeypatch.setattr(raycast, "_scanline_splat_prep",
                        raycast._scanline_splat_prep_plain)
    monkeypatch.setattr(raycast, "splat_packed", raycast._splat_packed_plain)
    monkeypatch.setattr(raycast, "carve_free_mask_batch",
                        raycast._carve_free_plain)
    monkeypatch.setattr(raycast, "apply_box_counts",
                        raycast._apply_box_counts_plain)
    monkeypatch.setattr(fusion, "fuse_drain", fusion._fuse_drain_plain)
    monkeypatch.setattr(edt, "binary_pass", edt._binary_pass_plain)
    monkeypatch.setattr(edt, "minplus_pass", edt._minplus_pass_plain)
    monkeypatch.setattr(esdf, "relax_to_fixpoint",
                        esdf._relax_to_fixpoint_plain)
    monkeypatch.setattr(esdf, "apply_occupancy_changes",
                        esdf._apply_occupancy_changes_plain)


def _incremental_cfg(window):
    return replay.scale_intrinsics(ft.FiestaConfig(
        resolution=0.1, origin=(-2.4, -2.4, -0.5), map_size=(4.8, 4.8, 2.0),
        min_ray_length=0.3, max_ray_length=2.0, max_points_per_scan=24 * 32,
        esdf_mode="incremental", global_update=not window,
        radius=(1.8, 1.8, 0.5)), 24, 32)


@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
def test_incremental_stream_and_engine_kernels_equal_plain(dev, monkeypatch,
                                                           window):
    """The incremental tick stream (one relax launch a tick) and
    ``FiestaPipeline`` in incremental mode (one a ``update()``, which
    never waits for the device), kernels against plain versions."""
    cfg = _incremental_cfg(window)
    _, frames = replay.make_sequence(cfg, n_frames=9, n_boxes=5, seed=3,
                                     height=24, width=32, orbit_radius=0.6)
    batches = replay.stage_update_batches(cfg, frames, device=dev)

    def engine(sync_mode):
        pipe = ft.FiestaPipeline(cfg, method="scanline", device=dev)
        torch.cuda.set_sync_debug_mode(sync_mode)
        try:
            for i, (t, (pos, quat), scan) in enumerate(frames):
                pipe.observe_pose(t, pos, quat)
                pipe.observe_cloud(t, scan)
                pipe.process()
                if i % 3 == 2:
                    pipe.update(max_iters=0 if i < 6 else 2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        pipe.sync_device()
        return pipe.state

    kernels.reset_launch_counts()
    k_state, k_stats = pipeline.fused_stream(cfg, ft.make_state(cfg, dev),
                                             *batches, use_window=window)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["relax"] == kernels.LAUNCHES["changes"] == 3
    k_eng = engine("error")
    assert kernels.LAUNCHES["relax"] == kernels.LAUNCHES["changes"] == 6
    _incremental_plain(monkeypatch)
    p_state, p_stats = pipeline.fused_stream(cfg, ft.make_state(cfg, dev),
                                             *batches, use_window=window)
    p_eng = engine("default")
    assert kernels.LAUNCHES["relax"] == kernels.LAUNCHES["changes"] == 6
    for f in dataclasses.fields(k_state):
        _eq(getattr(k_state, f.name), getattr(p_state, f.name))
        _eq(getattr(k_eng, f.name), getattr(p_eng, f.name))
    for a, b in zip(k_stats, p_stats):
        _eq(a, b)
    assert int(k_stats.num_sweeps.max()) > 1


# ---------------------------------------------------------------------------
# the changes kernel (the incremental update's inserts and bucket resets)
# ---------------------------------------------------------------------------

CHANGES_SHAPES = {"vector": (40, 36, 24), "scalar": (23, 37, 13)}


def _changes_scene(shape, seed, x_offset=0, gx_all=None):
    """On the CPU: d2 / closest of an X-slab of ``shape`` whose closest
    coordinates are global (the slab starts at x ``x_offset`` of a grid
    ``gx_all`` planes long), the whole grid's occupancy after a drain,
    the log-odds before it and the insert mask they give.  Undefined
    closests; closests at obstacles that stay and at obstacles that went;
    inserts on voxels whose own obstacle went, on obstacles of other
    voxels' buckets, and along every face of the grid; log-odds at the
    threshold and one ulp above it."""
    g = torch.Generator().manual_seed(seed)
    gx, gy, gz = shape
    full = (gx_all or gx, gy, gz)
    occ = torch.rand(full, generator=g) < 0.1
    pts = torch.nonzero(torch.rand(full, generator=g) < 0.25)
    pick = torch.randint(0, len(pts), shape, generator=g)
    c = pts[pick].permute(3, 0, 1, 2).to(torch.int16)
    c = torch.where((torch.rand(shape, generator=g) < 0.2)[None], -1, c)
    self_c = ft.grid.coord_grids(shape, "cpu").to(torch.int32)
    self_c[0] += x_offset
    diff = self_c - c.to(torch.int32)
    d2 = torch.where(c[0] >= 0, (diff * diff).sum(0), ft.grid.INF_D2)
    own = occ[x_offset:x_offset + gx]         # a view: faces set in occ
    before = torch.rand(shape, generator=g) < 0.5
    for face in (own[0], own[-1], own[:, 0], own[:, -1], own[:, :, 0],
                 own[:, :, -1]):
        face.fill_(True)
    thr = np.float32(0.85)
    lo = torch.where(before, torch.from_numpy(np.float32(
        [np.nextafter(thr, np.float32(9))])), torch.from_numpy(
            np.float32([thr])))
    insert = own & ~before
    return d2.to(torch.int32), c.contiguous(), occ, lo, insert, float(thr)


def _changes_check(dev, d2, c, occ, arg, mask, x_offset=0):
    """``apply_occupancy_changes`` on the card (one ``changes_kernel``
    launch, its inputs left as they are) against its plain version on
    the CPU."""
    on_dev = [t.to(dev) for t in (d2, c, occ)]
    arg_dev = (esdf.NewlyOccupied(arg.logodds.to(dev), arg.occ_thresh,
                                  arg.occ_is_eq)
               if isinstance(arg, esdf.NewlyOccupied) else arg.to(dev))
    kept = [t.clone() for t in on_dev]
    before = kernels.LAUNCHES["changes"]
    got, names = _cuda_kernels(lambda: esdf.apply_occupancy_changes(
        *on_dev, arg_dev, x_offset=x_offset, mask=mask))
    assert kernels.LAUNCHES["changes"] == before + 1
    assert len(names) == 1 and "changes_kernel" in names[0], names
    ref = esdf._apply_occupancy_changes_plain(d2, c, occ, arg, x_offset,
                                              mask)
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        if a is not None:
            _eq(a.cpu(), b)
    for a, b in zip(on_dev, kept):
        _eq(a, b)
    return ref


@pytest.mark.parametrize("mask", kernels.CHANGES_MASKS)
@pytest.mark.parametrize("form", ["insert_mask", "drained", "drained_eq"])
@pytest.mark.parametrize("path", sorted(CHANGES_SHAPES))
def test_changes_kernel(dev, path, form, mask):
    """The kernel against the plain ``apply_occupancy_changes``, bit for
    bit: its vector path (four voxels a thread) and its one-voxel path,
    each insert form (a mask, and the drained form's old log-odds in both
    occupancy predicates) and each mask form (none, the resets, the
    windowed relaxation's queued voxels)."""
    d2, c, occ, lo, insert, thr = _changes_scene(CHANGES_SHAPES[path], 7)
    if form == "insert_mask":
        arg = insert
    elif form == "drained":
        arg = esdf.NewlyOccupied(lo, thr, False)
        occ = occ.to(torch.uint8)
    else:       # deterministic mode: occupied where the log-odds == thr
        lo = torch.where(insert, 0.5, torch.where(occ, thr, 0.0)).to(
            torch.float32)
        arg = esdf.NewlyOccupied(lo, thr, True)
    assert torch.equal(arg.mask(occ) if form != "insert_mask" else arg,
                       insert)
    _changes_check(dev, d2, c, occ, arg, mask)
    # the scene holds resets, and inserts on voxels whose obstacle went
    went = esdf._apply_occupancy_changes_plain(
        d2, c, occ, torch.zeros_like(insert))[2]
    assert int(went.sum()) > 0 and int((insert & went).sum()) > 0
    assert int((insert & ~went).sum()) > 0


@pytest.mark.parametrize("x_offset", [0, 13, 32])
def test_changes_kernel_x_origin(dev, x_offset):
    """An X-slab of 8 planes of a 40-plane grid (the sharded update's
    call): inserts take global coordinates, the resets read the gathered
    occupancy."""
    d2, c, occ, _, insert, _ = _changes_scene((8, 36, 24), x_offset,
                                              x_offset, 40)
    ref = _changes_check(dev, d2, c, occ, insert, "reset", x_offset)
    assert int(ref[2].sum()) > 0
    ins = ref[1][:, insert]
    assert int(ins[0].min()) == x_offset and int(ins[0].max()) == \
        x_offset + 7


def test_changes_kernel_rejects(dev):
    """What the kernel cannot take: the drained form on a slab, both
    insert forms at once, a mask it does not write."""
    d2, c, occ, lo, insert, thr = (t.to(dev) if torch.is_tensor(t) else t
                                   for t in _changes_scene((8, 6, 4), 1))
    with pytest.raises(ValueError, match="not both"):
        kernels.changes(d2, c, occ, insert, lo)
    with pytest.raises(ValueError, match="mask"):
        kernels.changes(d2, c, occ, insert, mask="deleted")
    big = torch.cat([occ, occ])
    with pytest.raises(ValueError, match="whole grid"):
        kernels.changes(d2, c, big, logodds=lo, occ_thresh=thr)


@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
def test_incremental_update_card_equals_cpu(dev, window):
    """20 ticks of an orbit in incremental mode, obstacles going from the
    third on: the card's update (the one-pass drain, the changes kernel,
    the relax kernel) against the CPU's (``fuse_counts``, the plain
    changes and sweeps) tick by tick: every state field, every
    ``UpdateStats`` field and the sweep count bit-equal."""
    cfg = dataclasses.replace(_incremental_cfg(window), p_max=0.85)
    _, frames = replay.make_sequence(cfg, n_frames=60, n_boxes=6, seed=5,
                                     height=24, width=32, orbit_radius=0.6)
    batches = replay.stage_update_batches(cfg, frames, device="cpu")
    g = torch.Generator().manual_seed(2)
    cpu, card = ft.make_state(cfg, "cpu"), ft.make_state(cfg, dev)
    deleted = 0
    kernels.reset_launch_counts()
    for i in range(batches[0].shape[0]):
        tick = [b[i] for b in batches]
        cpu = pipeline.integrate_scan_batch(cfg, cpu, *tick[:3], tick[3],
                                            use_window=window)
        card = pipeline.integrate_scan_batch(
            cfg, card, *(t.to(dev) for t in tick[:3]), tick[3].to(dev),
            use_window=window)
        if i >= 2:       # a third of the obstacles move away
            occ = torch.nonzero(ft.occupied_grid(cfg, cpu.logodds))
            gone = tuple(occ[torch.randperm(len(occ), generator=g)[
                :len(occ) // 3]].T)
            for s in (cpu, card):
                s.hit_cnt[gone] = 0
                s.miss_cnt[gone] = 3
        cpu, c_stats = pipeline.esdf_update(cfg, cpu, tick[3], window)
        card, k_stats = pipeline.esdf_update(cfg, card, tick[3].to(dev),
                                             window)
        for f in dataclasses.fields(cpu):
            _eq(getattr(card, f.name).cpu(), getattr(cpu, f.name))
        for a, b in zip(k_stats, c_stats):
            _eq(a.cpu(), b)
        deleted += int(c_stats.num_deleted)
    n = batches[0].shape[0]
    assert n == 20 and deleted > 0
    assert kernels.LAUNCHES["changes"] == kernels.LAUNCHES["relax"] == n
    assert kernels.LAUNCHES["fuse"] == n


@pytest.mark.parametrize("mode", ["rebuild", "incremental"])
def test_scrolling_engine_kernels_equal_plain(dev, monkeypatch, mode):
    """The persistent scrolling engine on an orbit past its grid: it
    scrolls, archives and restores, equal to the same run on the plain
    versions (states, anchor, archive tiles)."""
    from fiesta_tpu_torch.scrolling import ScrollingFiestaPipeline

    cfg = dataclasses.replace(_incremental_cfg(False), esdf_mode=mode)
    world = dataclasses.replace(cfg, origin=(-8.0, -8.0, -0.5),
                                map_size=(16.0, 16.0, 2.0))
    _, frames = replay.make_sequence(world, n_frames=12, n_boxes=10, seed=4,
                                     height=24, width=32, orbit_radius=3.0,
                                     period=0.4)

    def run():
        pipe = ScrollingFiestaPipeline(cfg, archive=True, device=dev)
        for i, (t, (pos, quat), scan) in enumerate(frames):
            pipe.observe_pose(t, pos, quat)
            pipe.observe_cloud(t, scan)
            if i + 1 < len(frames):
                pipe.observe_pose(frames[i + 1][0], *frames[i + 1][1])
            pipe.process()
            pipe.update()
        pipe.sync_device()
        return pipe

    kernels.reset_launch_counts()
    k = run()
    assert k.scroll_count > 1 and k.restore_count > 0
    assert kernels.LAUNCHES["relax" if mode == "incremental"
                            else "edt_binary"] > 0
    _incremental_plain(monkeypatch)
    p = run()
    for f in dataclasses.fields(k.state):
        _eq(getattr(k.state, f.name), getattr(p.state, f.name))
    np.testing.assert_array_equal(k.origin_vox, p.origin_vox)
    assert sorted(k.archive.tiles) == sorted(p.archive.tiles)
    for key, tile in k.archive.tiles.items():
        for name in ("logodds", "seen"):
            np.testing.assert_array_equal(tile[name],
                                          p.archive.tiles[key][name])


def test_app_prefetch_copies_on_the_loop_stream(dev, tmp_path, monkeypatch):
    """``run.main``'s prefetch worker enqueues its uploads on the stream
    the replay loop reads them on: run under a side stream, every upload
    goes there and the final map equals the default stream's run."""
    from fiesta_tpu_torch import checkpoint, run

    streams = []
    preload = ft.FiestaPipeline.preload_cloud

    def recorded(self, scan):
        streams.append(torch.cuda.current_stream(dev))
        return preload(self, scan)

    monkeypatch.setattr(ft.FiestaPipeline, "preload_cloud", recorded)
    argv = ["--preset", "small", "--frames", "6"]
    run.main(argv + ["--checkpoint", str(tmp_path / "default.npz")])
    side = torch.cuda.Stream(dev)
    streams.clear()
    with torch.cuda.stream(side):
        run.main(argv + ["--checkpoint", str(tmp_path / "side.npz")])
    assert len(streams) == 6 and all(s == side for s in streams)
    _, a = checkpoint.load(str(tmp_path / "default.npz"), device=dev)
    _, b = checkpoint.load(str(tmp_path / "side.npz"), device=dev)
    for f in dataclasses.fields(a):
        _eq(getattr(a, f.name), getattr(b, f.name))


# ---------------------------------------------------------------------------
# the sharded engine's forms: the relax kernel's x origin, the box add's
# out-of-slab corners, the tick on a virtual mesh of the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x0", [0, 8, 37])
@pytest.mark.parametrize("conn", [24, 62])
def test_relax_kernel_x_origin(dev, conn, x0):
    """One sweep on a halo-extended X-slab (8 own planes, a halo of the
    stencil's reach a side) whose closest coordinates are global: the
    kernel at ``max_iters`` 1 with ``x_offset`` (``esdf.relax_sweep``)
    against ``relax_once(x_offset=...)``, the update mask on the own
    planes, the halos read and never written, the change flag equal."""
    from fiesta_tpu_torch.parallel import sharding

    dirs = stencil_offsets(conn)
    pad = sharding._stencil_reach(dirs)
    shape = (8 + 2 * pad, 36, 24)
    occ, d2, c = _relax_seeds(shape, 0.01, conn + x0, dev)
    c = torch.where(c[:1] >= 0, c + torch.tensor(
        [x0 - pad, 0, 0], dtype=torch.int16, device=dev)[:, None, None,
                                                         None], c)
    own = torch.zeros(shape, dtype=torch.bool, device=dev)
    own[pad:pad + 8] = True
    for state in range(3):
        got = esdf.relax_sweep(d2, c, own, None, dirs, x_offset=x0 - pad)
        ref = esdf.relax_once(d2, c, own, None, dirs, x_offset=x0 - pad)
        for a, b in zip(got, ref):
            _eq(a, b)
        _eq(got[0][:pad], d2[:pad])
        _eq(got[1][:, pad + 8:], c[:, pad + 8:])
        d2, c = ref[0], ref[1]
    assert bool(ref[2]) or state == 2
    # a whole grid at x_offset 0 is the package's sweep
    occ, d2, c = _relax_seeds(RELAX_SHAPE, 0.002, conn, dev)
    got = kernels.relax_to_fixpoint(d2, c, None, None, dirs, max_iters=1,
                                    x_offset=0)
    ref = esdf._relax_to_fixpoint_plain(d2, c, None, None, dirs, 1)
    for a, b in zip(got, ref):
        _eq(a, b)


def test_boxadd_kernel_out_of_slab_starts(dev):
    """Corners shifted into a slab's frame (the sharded tick's box add):
    boxes that straddle either face of a 10-plane slab, lie inside it or
    miss it, against the plain version (which skips what lies outside)."""
    lx, gy, gz = 10, 24, 16
    box = (13, 8, 16)
    starts = [[-5, 0, 0], [7, 8, 0], [-13, 8, 0], [10, 0, 0], [-20, 16, 0],
              [2, 4, 0], [-3, 16, 0]]
    rng = np.random.default_rng(7)
    hit = rng.integers(240, 256, (lx, gy, gz)).astype(np.uint8)
    miss = rng.integers(0, 256, (lx, gy, gz)).astype(np.uint8)
    miss0 = miss.copy()
    k = len(starts)
    bh = rng.integers(0, 3, (k,) + box).astype(np.uint8)
    bm = rng.integers(0, 4, (k,) + box).astype(np.uint8)
    h, m, st, bh, bm = (torch.from_numpy(a).to(dev) for a in
                        (hit, miss, np.asarray(starts, np.int32), bh, bm))
    ref = raycast._apply_box_counts_plain(h.clone(), m.clone(), st, bh, bm)
    got = raycast.apply_box_counts(h, m, st, bh, bm)
    for a, b in zip(got, ref):
        _eq(a, b)
    assert not torch.equal(ref[1].cpu(), torch.from_numpy(miss0))


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_tick_on_a_virtual_mesh(dev, n):
    """The sharded tick on n shards of the card (slabs of 32 and 8
    planes, t = 12: the raw binary passes, the compose, the halo'd
    closest passes at slab shapes) bit-equal to the single-device tick on
    the card, eager closest, two ticks; the lazy derive too."""
    from fiesta_tpu_torch.parallel import sharding

    base = ft.FiestaConfig(resolution=0.1, origin=(-3.2, -2.0, -1.2),
                           map_size=(6.4, 4.0, 2.4), min_ray_length=0.2,
                           max_ray_length=1.5, trunc_dist=1.2,
                           edt_fine_dist=1.2, esdf_mode="rebuild")
    rng = np.random.default_rng(7)
    origins = rng.uniform(-1.0, 1.0, (3, 3)).astype(np.float32)
    origins[:, 2] *= 0.3
    pts = (origins[:, None, :]
           + rng.uniform(-2.0, 2.0, (3, 300, 3))).astype(np.float32)
    tfs = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    tfs[:, :3, 3] = origins
    args = [torch.from_numpy(a).to(dev) for a in (
        pts - origins[:, None, :], rng.uniform(size=(3, 300)) < 0.9, tfs,
        origins[-1])]
    mesh = sharding.make_mesh(n, [dev] * n)
    for cfg in (dataclasses.replace(base, closest_mode="eager"), base):
        ref = ft.make_state(cfg, dev)
        state = sharding.shard_state(ft.make_state(cfg, dev), mesh)
        step = sharding.sharded_fused_tick(cfg, mesh)
        kernels.reset_launch_counts()
        for _ in range(2):
            ref, rs = ft.fused_batch_step(cfg, ref, *args)
            state, ss = step(state, *args)
        got = sharding.gather_state(state, mesh)
        for f in ft.grid.FIELDS:
            _eq(getattr(got, f), getattr(ref, f))
        for a, b in zip(ss, rs):
            _eq(a, b)
        assert int(rs.num_inserted) > 0
        assert kernels.LAUNCHES["boxadd"] >= 2 * n
        if cfg.lazy_closest:
            cl = sharding.sharded_derive_closest(cfg, mesh)(state.logodds)
            _eq(sharding._gather_axis(mesh, cl, 0),
                pipeline.derive_closest(cfg, ref.logodds))


DEPTH_SHAPES = {"small": (24, 32), "odd": (23, 37), "demo": (480, 640)}


@functools.lru_cache(maxsize=None)
def _depth_scene(h, w):
    """(cfg, depths [5,H,W] f32, camera-to-world transforms [5,4,4] f32):
    five frames of an orbit, with NaN, infinities, zero, depths either
    side of the gates and one on the lower gate written into each frame's
    first rows and its last."""
    cfg = replay.scale_intrinsics(ft.FiestaConfig(
        resolution=0.1, origin=(-2.4, -2.4, -0.5), map_size=(4.8, 4.8, 2.0),
        min_ray_length=0.3, max_ray_length=2.0, max_points_per_scan=h * w),
        h, w)
    _, frames = replay.make_sequence(cfg, n_frames=5, n_boxes=5, seed=3,
                                     kind="depth", height=h, width=w,
                                     orbit_radius=0.6)
    depths = np.stack([f[2] for f in frames]).astype(np.float32)
    lo = np.float32(cfg.depth_filter_min_dist)
    edge = np.array([np.nan, np.inf, -np.inf, 0.0, lo, lo * 0.5,
                     np.nextafter(lo, np.float32(0)),
                     np.float32(cfg.depth_filter_max_dist) * 2], np.float32)
    for i, d in enumerate(depths):
        d[i % 2, :len(edge)] = edge
        d[-1, -len(edge):] = edge[::-1]
    tfs = np.stack([replay.pose_to_matrix(*f[1]) for f in frames]
                   ).astype(np.float32)
    return cfg, depths, tfs


def _turned(tf):
    """``tf`` with the camera yawed 90 degrees about the world z axis at
    its own position: it looks away, so most reprojections into it leave
    the image."""
    out = tf.copy()
    out[:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]],
                           np.float32) @ tf[:3, :3]
    return out


def _eq_bits(a, b):
    """``_eq`` with f32 compared by bit pattern, NaN included."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    _eq(a, b)


def _pivots(a):
    """The rows on which ``ops.depth._solve`` pivots, step by step."""
    a, rows, idx = a.astype(np.float32), [], np.arange(4)
    for j in range(4):
        p = int(np.argmax(np.where(idx >= j, np.abs(a[:, j]), -1)))
        rows.append(p)
        a[[j, p]] = a[[p, j]]
        f = np.where(idx > j, a[:, j] / a[j, j], 0).astype(np.float32)
        a = a - f[:, None] * a[j][None, :]
    return rows


@pytest.mark.parametrize("margin", [0, 3])
@pytest.mark.parametrize("use_filter", [False, True], ids=["raw", "filter"])
@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("shape", sorted(DEPTH_SHAPES))
def test_depth_kernel(dev, shape, k, use_filter, margin):
    """``kernels.depth`` through ``depth_tick_components`` against the
    plain version on the card: frames 1..k, frame 1 held against frame 0
    seen from its own pose and from one turned away.  px, py, pz and valid
    bit-equal, one launch a call; at k = 1 ``depth_to_cloud_components``
    too."""
    cfg, depths, tfs = _depth_scene(*DEPTH_SHAPES[shape])
    cfg = dataclasses.replace(cfg, depth_filter_margin=margin)
    d = torch.from_numpy(depths[1:1 + k]).to(dev)
    t = torch.from_numpy(tfs[1:1 + k]).to(dev)
    prev_d = torch.from_numpy(depths[0]).to(dev)
    poses = (tfs[0], _turned(tfs[0]))
    # the first pivot lies on the diagonal for one pose and off it for the
    # other; the second (the camera's y axis, world -z) always off it
    assert {_pivots(p)[0] for p in poses} == {0, 1}
    assert all(_pivots(p)[1] == 2 for p in poses)
    n_valid = []
    for pose in poses:
        prev_t = torch.from_numpy(pose).to(dev)
        before = kernels.LAUNCHES["depth"]
        got = depth_ops.depth_tick_components(cfg, d, t, prev_d, prev_t,
                                              use_filter)
        assert kernels.LAUNCHES["depth"] == before + 1
        ref = depth_ops._depth_tick_plain(cfg, d, t, prev_d, prev_t,
                                          use_filter)
        for a, b in zip(got, ref):
            _eq_bits(a, b)
        if k == 1:
            one = depth_ops.depth_to_cloud_components(cfg, d[0], t[0],
                                                      prev_t, prev_d,
                                                      use_filter)
            assert kernels.LAUNCHES["depth"] == before + 2
            for a, b in zip(one, got):
                _eq_bits(a.reshape(1, -1), b)
        n_valid.append(int(got[3][0].sum()))
    if use_filter:
        assert n_valid[0] > 0 and n_valid[1] < n_valid[0] // 4, n_valid


# the splat prep's configurations: the cow and demo grids (8-aligned boxes;
# the cow box spans z) and an unaligned grid smaller than the box's reach
PREP_CFGS = {
    "cow": ft.COW_AND_LADY,
    "demo": ft.DEMO_ONBOARD,
    "unaligned": ft.FiestaConfig(
        resolution=0.1, origin=(-2.25, -1.85, -0.95), map_size=(4.5, 3.7, 2.1),
        min_ray_length=0.3, max_ray_length=1.5),
}


def _prep_sensors(cfg):
    """Sensor positions [13,3] f32: the grid's middle, then two at each
    face: just inside the grid, and past it by 0.7 max range."""
    lo = np.array(cfg.origin, np.float64)
    hi = lo + np.array(cfg.grid_shape) * cfg.resolution
    mid = (lo + hi) / 2
    out = [mid]
    near, past = 0.3 * cfg.resolution, 0.7 * cfg.max_ray_length
    for j in range(3):
        for face, sgn in ((lo, 1), (hi, -1)):
            for off in (near, -past):
                p = mid.copy()
                p[j] = face[j] + sgn * off
                out.append(p)
    return np.array(out, np.float32)


def _prep_rays(cfg, o, start, rng, p):
    """World endpoints [p,3] f32 for a sensor at ``o`` whose box corner is
    ``start``: random directions and lengths up to 1.5 max range, and
    first rays of zero length; at the min and max range along each axis
    (exactly and an ulp either side); ending on each face of the box (and
    an ulp either side); far out along each axis, so out of the box there;
    with NaN or an infinity in each component."""
    res, box = cfg.resolution, raycast._carve_box_shape(cfg)
    d = rng.normal(size=(p, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (o + d * rng.uniform(0, 1.5 * cfg.max_ray_length, (p, 1))
           ).astype(np.float32)
    edge = [o]
    f32 = np.float32
    for r in (f32(cfg.min_ray_length), f32(cfg.max_ray_length)):
        for a in range(3):
            for sgn in (1, -1):
                for rr in (np.nextafter(r, f32(0)), r,
                           np.nextafter(r, f32(np.inf))):
                    q = o.copy()
                    q[a] = f32(o[a] + sgn * rr)
                    edge.append(q)
    lw = np.array(cfg.origin, f32) + np.asarray(start, f32) * f32(res)
    hw = lw + np.array(box, f32) * f32(res)
    for a in range(3):
        for face in (lw[a], hw[a]):
            for f in (np.nextafter(face, f32(-np.inf)), face,
                      np.nextafter(face, f32(np.inf))):
                q = (o + rng.uniform(-0.3, 0.3, 3) * res).astype(f32)
                q[a] = f
                edge.append(q)
        for sgn in (1, -1):
            q = o.copy()
            q[a] = f32(o[a] + sgn * 3 * box[a] * res)
            edge.append(q)
    for a in range(3):
        for bad in (np.nan, np.inf, -np.inf):
            q = (o + 0.5).astype(f32)
            q[a] = bad
            edge.append(q)
    edge = np.array(edge, f32)
    pts[:len(edge)] = edge
    return pts


def _rotation(rng):
    """A random rotation [3,3] from a unit quaternion."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _prep_scene(name, k, group, p=3000):
    """(cfg, {form: (points, kwargs)}, valid [K,P] bool) of K scans from
    sensors ``group * K ...`` of ``_prep_sensors`` (cyclically), as
    numpy: world points with origins, sensor-frame points with random
    rotations and the components of those."""
    cfg = PREP_CFGS[name]
    rng = np.random.default_rng([k, group, len(name)])
    sensors = _prep_sensors(cfg)
    o = sensors[[(group * k + i) % len(sensors) for i in range(k)]]
    po = ((o - np.array(cfg.origin, np.float32)) / np.float32(cfg.resolution)
          - np.float32(0.5)).astype(np.float32)
    starts = raycast._box_starts(cfg, torch.from_numpy(po)).numpy()
    world = np.stack([_prep_rays(cfg, o[i], starts[i], rng, p)
                      for i in range(k)])
    valid = rng.random((k, p)) < 0.9
    valid[:, :120] = True
    tfs = np.zeros((k, 4, 4), np.float32)
    sensor = np.empty_like(world)
    for i in range(k):
        rot = _rotation(rng).astype(np.float32)
        tfs[i, :3, :3], tfs[i, :3, 3], tfs[i, 3, 3] = rot, o[i], 1.0
        with np.errstate(invalid="ignore"):
            sensor[i] = (world[i] - o[i]) @ rot
    forms = {"world": (world, dict(origins=o)),
             "sensor": (sensor, dict(transforms=tfs)),
             "components": (tuple(np.ascontiguousarray(sensor[..., j])
                                  for j in range(3)), dict(transforms=tfs))}
    return cfg, forms, valid


def _to_dev(x, dev):
    if isinstance(x, tuple):
        return tuple(torch.from_numpy(c).to(dev) for c in x)
    return torch.from_numpy(x).to(dev)


def _prep_bits(got, ref):
    """starts, po_box, lin and rvalid bit for bit, val where rvalid."""
    rv = ref[4].reshape(-1)
    for a, b in zip(got[:3] + got[4:], ref[:3] + ref[4:]):
        _eq_bits(a, b)
    _eq_bits(got[3][rv], ref[3][rv])


@pytest.mark.parametrize("form", ["world", "sensor", "components"])
@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("name", sorted(PREP_CFGS))
def test_prep_kernel(dev, name, k, form):
    """``kernels.prep`` through ``_scanline_splat_prep`` against the plain
    prep on the card, in every input form, K scans from the 13 sensors of
    ``_prep_sensors`` (each used at least once), with the edge rays of
    ``_prep_rays``: one launch of ``prep_kernel`` a call, starts, po_box,
    lin and rvalid bit-equal, val where rvalid.  The plain prep's own
    values show the rays reached every case: hits, clipped rays and rays
    that leave the box across a face of each axis."""
    seen = dict(hit=0, clipped=0, short=0, exit=[0, 0, 0])
    for group in range(-(-13 // k)):
        cfg, forms, valid = _prep_scene(name, k, group)
        pts, kw = forms[form]
        pts, v = _to_dev(pts, dev), _to_dev(valid, dev)
        kw = {key: _to_dev(a, dev) for key, a in kw.items()}
        before = kernels.LAUNCHES["prep"]
        if group == 0:
            got, names = _cuda_kernels(
                lambda: raycast._scanline_splat_prep(cfg, pts, v, **kw))
            assert names == ["prep_kernel"], names
        else:
            got = raycast._scanline_splat_prep(cfg, pts, v, **kw)
        assert kernels.LAUNCHES["prep"] == before + 1
        ref = raycast._scanline_splat_prep_plain(cfg, pts, v, **kw)
        _prep_bits(got, ref)
        rv, val = ref[4].reshape(-1), ref[3]
        thr = 1000.0 + np.float32(cfg.max_ray_length + cfg.resolution)
        seen["hit"] += int((rv & (val >= 2000.0)).sum())
        seen["clipped"] += int((rv & (val == thr)).sum())
        seen["short"] += int((v.reshape(-1) & ~rv).sum())
        # a ray that leaves the box: its voxel on the face it crossed
        out = (rv & (val < thr)).cpu()
        box = raycast._carve_box_shape(cfg)
        lin = ref[2].cpu()[out] % math.prod(box)
        cell = (lin // (box[1] * box[2]), lin // box[2] % box[1],
                lin % box[2])
        for j in range(3):
            seen["exit"][j] += int(((cell[j] == 0)
                                    | (cell[j] == box[j] - 1)).sum())
    assert seen["hit"] and seen["clipped"] and seen["short"], seen
    assert all(seen["exit"]), seen


@pytest.mark.parametrize("impl", ["lax", "pallas"])
def test_prep_kernel_sorted_splat(dev, monkeypatch, impl):
    """The sorted splat (``FIESTA_SPLAT=sorted``, either sort) after the
    kernel's prep: seeds, masks and counts bit-equal to those after the
    plain prep."""
    monkeypatch.setattr(raycast, "_SPLAT_ORDER", "sorted")
    monkeypatch.setattr(raycast, "_SPLAT_SORT_IMPL", impl)
    for name in sorted(PREP_CFGS):
        cfg, forms, valid = _prep_scene(name, 3, 1)
        pts, kw = forms["components"]
        args = (cfg, _to_dev(pts, dev), _to_dev(valid, dev))
        kw = {key: _to_dev(a, dev) for key, a in kw.items()}
        before = dict(kernels.LAUNCHES)
        got = raycast._scanline_seeds_batch(*args, **kw)
        assert kernels.LAUNCHES["prep"] == before["prep"] + 1
        assert kernels.LAUNCHES["sort"] == before["sort"] + (impl == "pallas")
        with monkeypatch.context() as m:
            m.setattr(raycast, "_scanline_splat_prep",
                      raycast._scanline_splat_prep_plain)
            ref = raycast._scanline_seeds_batch(*args, **kw)
        for a, b in zip(got, ref):
            _eq_bits(a, b)


def test_prep_kernel_no_rays(dev):
    """Scans of no rays still place their boxes: starts and po_box as the
    plain prep's, empty rays."""
    cfg = PREP_CFGS["unaligned"]
    o = torch.from_numpy(_prep_sensors(cfg)[:4]).to(dev)
    pts = torch.zeros((4, 0, 3), device=dev)
    v = torch.zeros((4, 0), dtype=torch.bool, device=dev)
    got = raycast._scanline_splat_prep(cfg, pts, v, origins=o)
    ref = raycast._scanline_splat_prep_plain(cfg, pts, v, origins=o)
    for a, b in zip(got, ref):
        _eq_bits(a, b)
