"""Plain reference of the rebuild-mode map tick (FIESTA's global or
local update with the exact truncated EDT), in plain PyTorch.

It imports nothing of the program under test.  From the configuration's
fields and the same scans, depth images and poses the program was fed,
it works out again what a run of ticks leaves behind:

* per scan, the scanline integrator's box-local observations: the ray
  gates and max-ray clip, the endpoint splat (class and range packed in
  one f32, scatter-max, decode), the octant wavefront carve of free
  space, and the local window's gate;
* for depth images, the pinhole back-projection and the consistency
  filter against the previous frame;
* per tick, the fusion drain: one clamped log-odds step per observed
  voxel, a hit iff 2 * hits >= misses, the seen mask, and the counts of
  observed voxels and of occupancy flips;
* the exact squared EDT truncated at ``trunc_dist``.

Every f32 expression is written op for op as the scanline integrator and
the depth filter define it (FIESTA's semantics as the JAX package states
them), with divisions by tensors so that they round as IEEE divisions, so
that the reference agrees with a correct program bit for bit.  The EDT is
a different algorithm: nearest obstacle along x by running min and max of
indices, then brute-force windowed min-plus along y and z.

A scan's observations do not depend on the map, so the reference computes
them once per distinct scan and replays the drain tick by tick; the drain
touches only the voxels a tick observed, so it runs on their indices.
"""

from __future__ import annotations

import math

import numpy as np
import torch

INF_D2 = 1 << 29          # the map's "far" squared distance
_FAR = 1 << 24            # "no obstacle" inside the EDT's passes


def _f32(v: float) -> float:
    return float(np.float32(v))


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root (through f64)."""
    return torch.sqrt(x.double()).float()


class Geometry:
    """What the reference reads of a configuration's fields."""

    def __init__(self, fields: dict):
        if fields.get("esdf_mode", "rebuild") != "rebuild":
            raise ValueError("this reference covers esdf_mode='rebuild'")
        if not fields.get("probabilistic", True):
            raise ValueError("this reference covers probabilistic fusion")
        if fields.get("edt_fine_dist", 5.0) < fields.get("trunc_dist", 5.0):
            raise ValueError("this reference covers the one-level EDT")
        self.res = float(fields["resolution"])
        self.origin = tuple(float(v) for v in fields["origin"])
        self.map_size = tuple(float(v) for v in fields["map_size"])
        self.grid = tuple(int(math.ceil(s / self.res)) for s in self.map_size)
        self.min_ray = float(fields["min_ray_length"])
        self.max_ray = float(fields["max_ray_length"])
        self.l_hit = _f32(_logit(fields["p_hit"]))
        self.l_miss = _f32(_logit(fields["p_miss"]))
        self.lo_min = _f32(_logit(fields["p_min"]))
        self.lo_max = _f32(_logit(fields["p_max"]))
        self.occ_thr = _f32(_logit(fields["p_occ"]))
        self.cam = tuple(float(fields[k]) for k in
                         ("center_x", "center_y", "focal_x", "focal_y"))
        self.use_filter = bool(fields["use_depth_filter"])
        self.filter_tol = float(fields["depth_filter_tolerance"])
        self.filter_min = float(fields["depth_filter_min_dist"])
        self.filter_max = float(fields["depth_filter_max_dist"])
        self.filter_margin = int(fields["depth_filter_margin"])
        self.global_update = bool(fields["global_update"])
        self.radius = tuple(float(v) for v in fields["radius"])
        self.trunc = int(math.ceil(float(fields["trunc_dist"]) / self.res))
        # the distance of an unseen voxel, or one beyond the truncation
        self.infinity = float(fields["infinity_distance"])
        # carve box: reach r voxels around the sensor, x/y extents rounded
        # up to a multiple of 8 where the grid's are
        self.reach = int(math.ceil((self.max_ray + 2 * self.res)
                                   / self.res)) + 2
        e = 2 * self.reach + 1
        gx, gy, gz = self.grid
        self.aligned = gx % 8 == 0 and gy % 8 == 0
        if self.aligned:
            ea = -(-(e + 7) // 8) * 8
            self.box = (min(gx, ea), min(gy, ea), min(gz, e))
        else:
            self.box = tuple(min(g, e) for g in self.grid)

    @property
    def num_voxels(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


# ---------------------------------------------------------------------------
# Rays to box-local seeds
# ---------------------------------------------------------------------------


def _box_starts(geo: Geometry, po_grid: torch.Tensor) -> torch.Tensor:
    """Box corners [K,3] i32 for sensor grid positions [K,3] f32: centred
    on the rounded sensor voxel (half to even), clamped into the grid, x
    and y floored to a multiple of 8 before the clamp to the box."""
    e = 2 * geo.reach + 1
    cols = []
    for j in range(3):
        ex = min(geo.grid[j], e)
        u = torch.clamp(torch.round(po_grid[:, j]).to(torch.int32) - ex // 2,
                        0, geo.grid[j] - ex)
        if geo.aligned and j < 2:
            u = (u // 8) * 8
        cols.append(torch.clamp(u, 0, geo.grid[j] - geo.box[j]))
    return torch.stack(cols, dim=1)


def scan_seeds(geo: Geometry, px, py, pz, valid, transforms):
    """Sensor-frame rays (components [K,P] f32, valid [K,P] bool) of K
    scans with sensor-to-world ``transforms`` [K,4,4] f32 -> (box corners
    [K,3] i32, sensor in box units [K,3] f32, seeds [K,BX,BY,BZ] f32, hit
    u8, free-endpoint u8).  A ray is kept from ``min_ray`` on, clipped at
    ``max_ray``; its endpoint voxel, or where it leaves the box, takes
    ``2000 + range`` (a hit) or ``1000 + range`` (free up to there), the
    largest value winning each voxel."""
    res = geo.res
    bx, by, bz = geo.box
    nb = bx * by * bz
    k = px.shape[0]
    dev = px.device
    res_t = torch.full((), res, dtype=torch.float32, device=dev)
    mx, my, mz = (float(np.float32(o)) for o in geo.origin)

    r = transforms[:, :3, :3]
    wx, wy, wz = [px * r[:, i, 0, None] + py * r[:, i, 1, None]
                  + pz * r[:, i, 2, None] + transforms[:, i, 3, None]
                  for i in (0, 1, 2)]
    origins = transforms[:, :3, 3]
    ox, oy, oz = (origins[:, j, None] for j in range(3))

    valid = valid & torch.isfinite(wx) & torch.isfinite(wy) \
        & torch.isfinite(wz)
    dx, dy, dz = wx - ox, wy - oy, wz - oz
    length = _sqrt(dx * dx + dy * dy + dz * dz)
    kept = valid & (length >= geo.min_ray)
    is_hit = length <= geo.max_ray
    max_t = torch.full((), geo.max_ray, dtype=torch.float32, device=dev)
    scale = torch.where(is_hit, 1.0,
                        max_t / torch.clamp(length, min=1e-9))
    cx, cy, cz = ox + dx * scale, oy + dy * scale, oz + dz * scale

    po_grid = torch.stack([(origins[:, j] - m) / res_t - 0.5
                           for j, m in enumerate((mx, my, mz))], dim=1)
    starts = _box_starts(geo, po_grid)
    po_box = po_grid - starts.to(torch.float32)
    sx0, sy0, sz0 = (starts[:, j, None] for j in range(3))

    vx = torch.floor((cx - mx) / res_t).to(torch.int32)
    vy = torch.floor((cy - my) / res_t).to(torch.int32)
    vz = torch.floor((cz - mz) / res_t).to(torch.int32)
    vbx, vby, vbz = vx - sx0, vy - sy0, vz - sz0
    gx, gy, gz = geo.grid
    inside = ((vbx >= 0) & (vbx < bx) & (vby >= 0) & (vby < by)
              & (vbz >= 0) & (vbz < bz)
              & (vx >= 0) & (vx < gx) & (vy >= 0) & (vy < gy)
              & (vz >= 0) & (vz < gz))

    # where a ray leaves the box: the first face its segment crosses
    lwx = mx + sx0.to(torch.float32) * res
    lwy = my + sy0.to(torch.float32) * res
    lwz = mz + sz0.to(torch.float32) * res
    hwx, hwy, hwz = lwx + bx * res, lwy + by * res, lwz + bz * res
    ux, uy, uz = cx - ox, cy - oy, cz - oz

    def face_t(u, lo, hi, o):
        safe = torch.where(torch.abs(u) < 1e-9, 1e-9, u)
        return torch.where(u > 0, (hi - o) / safe, (lo - o) / safe)

    s_exit = torch.clamp(torch.minimum(torch.minimum(
        face_t(ux, lwx, hwx, ox), face_t(uy, lwy, hwy, oy)),
        face_t(uz, lwz, hwz, oz)), 0.0, 1.0)
    ulen = _sqrt(ux * ux + uy * uy + uz * uz)
    exit_dist = s_exit * ulen - 0.5 * res
    f = exit_dist / torch.clamp(ulen, min=1e-9)
    ebx = torch.clamp(torch.floor((ox + ux * f - mx) / res_t).to(torch.int32)
                      - sx0, 0, bx - 1)
    eby = torch.clamp(torch.floor((oy + uy * f - my) / res_t).to(torch.int32)
                      - sy0, 0, by - 1)
    ebz = torch.clamp(torch.floor((oz + uz * f - mz) / res_t).to(torch.int32)
                      - sz0, 0, bz - 1)

    sxx = torch.where(inside, vbx, ebx)
    syy = torch.where(inside, vby, eby)
    szz = torch.where(inside, vbz, ebz)
    value = torch.where(
        inside & is_hit, 2000.0 + length,
        1000.0 + torch.where(inside, geo.max_ray + geo.res,
                             exit_dist + geo.res))
    cell = (sxx * (by * bz) + syy * bz + szz).to(torch.int64)
    cell = cell + torch.arange(k, device=dev)[:, None] * nb
    # rays that fail the gates land in one spare cell past the boxes
    cell = torch.where(kept, cell, k * nb)
    target = torch.zeros(k * nb + 1, dtype=torch.float32, device=dev)
    target.scatter_reduce_(0, cell.reshape(-1), value.reshape(-1),
                           reduce="amax", include_self=True)
    packed = target[:k * nb]

    thr = _f32(geo.max_ray + geo.res - 1e-4)
    hit = packed >= 2000.0
    freeish = (packed >= 1000.0) & (packed < 2000.0)
    seeds = torch.where(hit, packed - 2000.0,
                        torch.where(freeish, packed - 1000.0, 0.0))
    epfree = freeish & (packed - 1000.0 >= thr)
    shape = (k,) + geo.box
    return (starts, po_box, seeds.reshape(shape),
            hit.to(torch.uint8).reshape(shape),
            epfree.to(torch.uint8).reshape(shape))


# ---------------------------------------------------------------------------
# The carve: octant wavefronts of max observation range
# ---------------------------------------------------------------------------


def _sweep(seeds, flip, po_a, o2, o3):
    """One batch of wavefronts along the leading axis of ``seeds`` [B, A,
    C2, C3] (walked from the high end where ``flip`` [B] is True): at each
    slab the carry takes the max over the (up to) four cells bracketing
    each cell's line of sight toward the sensor, then the max with the
    slab's seeds.  Returns the carry at every slab, [B, A, C2, C3]."""
    b, a, c2, c3 = seeds.shape
    dev = seeds.device
    idx = torch.arange(a, device=dev)
    steps = torch.where(flip[:, None], a - 1 - idx[None], idx[None])  # [B,A]
    steps_f = steps.to(torch.float32)
    rows = torch.arange(b, device=dev)
    # the carry plane with a zero border of one cell on each side, so that
    # each shifted view is a slice
    pad = torch.zeros((b, c2 + 2, c3 + 2), dtype=seeds.dtype, device=dev)
    mid = torch.zeros((b, c2, c3 + 2), dtype=seeds.dtype, device=dev)
    out = torch.empty_like(seeds)
    zero = torch.zeros((), dtype=seeds.dtype, device=dev)
    for s in range(a):
        ia = steps[:, s]
        d = torch.clamp(torch.abs(steps_f[:, s] - po_a), min=0.5)
        b2 = torch.floor(o2 / d[:, None])
        b3 = torch.floor(o3 / d[:, None])
        t = torch.zeros((b, c2, c3 + 2), dtype=seeds.dtype, device=dev)
        for sh in (-1, 0, 1):
            m = ((b2 == sh) | (b2 == sh - 1))[:, :, None]
            t = torch.maximum(t, torch.where(
                m, pad[:, 1 + sh:1 + sh + c2, :], zero))
        mid.copy_(t)
        acc = torch.zeros((b, c2, c3), dtype=seeds.dtype, device=dev)
        for sh in (-1, 0, 1):
            m = ((b3 == sh) | (b3 == sh - 1))[:, None, :]
            acc = torch.maximum(acc, torch.where(
                m, mid[:, :, 1 + sh:1 + sh + c3], zero))
        carry = torch.maximum(seeds[rows, ia], acc)
        out[rows, ia] = carry
        pad[:, 1:c2 + 1, 1:c3 + 1] = carry
    return out


def carve_free(geo: Geometry, seeds: torch.Tensor,
               po: torch.Tensor) -> torch.Tensor:
    """Free mask [K,BX,BY,BZ] bool of K boxes of seeds, sensor at ``po``
    [K,3] in box units.  A voxel belongs to the octant cone of its
    dominant offset axis (ties x > y > z); each axis's two wavefronts
    carry the range from the far faces toward the sensor, seeded in their
    own cone and sign; a voxel is free within the ray gates when it lies a
    voxel closer to the sensor than the range carried to it."""
    k, bx, by, bz = seeds.shape
    dev = seeds.device
    res = geo.res
    xs = torch.arange(bx, dtype=torch.float32, device=dev)
    ys = torch.arange(by, dtype=torch.float32, device=dev)
    zs = torch.arange(bz, dtype=torch.float32, device=dev)
    dx = xs[None, :, None, None] - po[:, 0, None, None, None]
    dy = ys[None, None, :, None] - po[:, 1, None, None, None]
    dz = zs[None, None, None, :] - po[:, 2, None, None, None]
    adx, ady, adz = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    in_x = (adx >= ady) & (adx >= adz)
    in_y = ~in_x & (ady >= adz)
    in_z = ~in_x & ~in_y
    r2 = dx * dx + dy * dy + dz * dz
    lo2, hi2 = (geo.min_ray / res) ** 2, (geo.max_ray / res) ** 2

    def free_test(w):
        wv = (w - res) * (1.0 / res)
        return (w > res) & (r2 >= lo2) & (r2 <= hi2) & (r2 < wv * wv)

    flip = torch.cat([torch.zeros(k, dtype=torch.bool, device=dev),
                      torch.ones(k, dtype=torch.bool, device=dev)])
    free = torch.zeros(seeds.shape, dtype=torch.bool, device=dev)
    axes = (
        (in_x, dx, (0, 1, 2, 3), 0, ys[None] - po[:, 1, None],
         zs[None] - po[:, 2, None]),
        (in_y, dy, (0, 2, 1, 3), 1, xs[None] - po[:, 0, None],
         zs[None] - po[:, 2, None]),
        (in_z, dz, (0, 3, 1, 2), 2, xs[None] - po[:, 0, None],
         ys[None] - po[:, 1, None]),
    )
    for cone, d, perm, j, o2, o3 in axes:
        near = cone & (d <= 0)
        far = cone & (d > 0)
        both = torch.cat([torch.where(near, seeds, 0.0).permute(perm),
                          torch.where(far, seeds, 0.0).permute(perm)], 0)
        w = _sweep(both.contiguous(), flip, torch.cat([po[:, j], po[:, j]]),
                   torch.cat([o2, o2]), torch.cat([o3, o3]))
        inv = [perm.index(i) for i in range(4)]
        free |= free_test(w[:k].permute(inv)) & (d <= 0)
        free |= free_test(w[k:].permute(inv)) & (d > 0)
        del both, w
    return free


# ---------------------------------------------------------------------------
# Local window and depth images
# ---------------------------------------------------------------------------


def local_window(geo: Geometry, center: torch.Tensor):
    """Inclusive voxel window (min [3] i32, max [3] i32) of the update
    radius around ``center`` [3] f32, clamped to the map box."""
    dev = center.device

    def vec(vals):
        return torch.stack([torch.full((), v, dtype=torch.float32,
                                       device=dev) for v in vals])

    radius, lo = vec(geo.radius), vec(geo.origin)
    hi = lo + vec(geo.map_size)
    res_t = torch.full((), geo.res, dtype=torch.float32, device=dev)
    min_pos = torch.clamp(center - radius, lo, hi)
    max_pos = torch.clamp(center + radius, lo, hi)
    return (torch.floor((min_pos - lo) / res_t).to(torch.int32),
            torch.floor((max_pos - 0.5 * geo.res - lo) / res_t).to(
                torch.int32))


def _inverse_times(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 @ b for [4,4] f32 by Gaussian elimination with partial
    pivoting (the first largest magnitude wins), then back substitution."""
    n = a.shape[0]
    rows = torch.arange(n, device=a.device)
    for j in range(n):
        col = torch.where(rows >= j, a[:, j].abs(),
                          torch.full_like(a[:, j], -1.0))
        p = torch.argmax(col)
        perm = torch.where(rows == j, p, torch.where(rows == p, j, rows))
        a, b = a[perm], b[perm]
        f = torch.where(rows > j, a[:, j] / a[j, j], torch.zeros_like(a[:, j]))
        a = a - f[:, None] * a[j][None, :]
        b = b - f[:, None] * b[j][None, :]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = b[i]
        for k in range(i + 1, n):
            acc = acc - a[i, k] * x[k]
        x[i] = acc / a[i, i]
    return torch.stack(x)


def depth_rays(geo: Geometry, depth: torch.Tensor, transform: torch.Tensor,
               prev_depth: torch.Tensor, prev_transform: torch.Tensor):
    """Camera-frame rays (x, y, z, valid), each [H,W], of a depth image
    [H,W] f32 in metres.  With the consistency filter, a pixel is kept
    within the depth gates where its point, moved into the previous
    camera (prev^-1 @ T), projects inside the image onto a pixel whose
    depth agrees within the tolerance."""
    h, w = depth.shape
    dev = depth.device
    cx, cy, fx, fy = geo.cam
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    fx_t = torch.full((), fx, dtype=torch.float32, device=dev)
    fy_t = torch.full((), fy, dtype=torch.float32, device=dev)
    x = (u - cx) * depth / fx_t
    y = (v - cy) * depth / fy_t
    valid = torch.isfinite(depth)
    if not geo.use_filter:
        return x, y, depth, valid
    m = geo.filter_margin
    if m > 0:
        valid = valid & (((u >= m) & (u < w - m)) & ((v >= m) & (v < h - m)))
    valid = valid & (depth >= geo.filter_min)
    valid = valid & (depth <= geo.filter_max)
    rel = _inverse_times(prev_transform, transform)
    c = [rel[i, 0] * x + rel[i, 1] * y + rel[i, 2] * depth + rel[i, 3]
         for i in range(4)]
    z = c[2] / c[3]
    uu = (c[0] / c[3]) * fx / z + cx
    vv = (c[1] / c[3]) * fy / z + cy
    in_img = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
    ui = torch.clamp(uu.to(torch.int32), 0, w - 1).long()
    vi = torch.clamp(vv.to(torch.int32), 0, h - 1).long()
    agree = torch.abs(prev_depth[vi, ui] - z) < geo.filter_tol
    return x, y, depth, valid & in_img & agree


# ---------------------------------------------------------------------------
# Observations of a tick, the drain, the EDT
# ---------------------------------------------------------------------------


def scan_boxes(geo: Geometry, px, py, pz, valid, transforms, windows=None):
    """Box-local (corners [K,3] i32, hits u8, misses u8) of K scans: a
    miss for every endpoint voxel (hit or free) and one more for every
    voxel carved free, gated by each scan's tick window (``windows``:
    (min [K,3], max [K,3]) inclusive) where the update is local."""
    starts, po, seeds, hit, epfree = scan_seeds(geo, px, py, pz, valid,
                                                transforms)
    free = carve_free(geo, seeds, po)
    if windows is not None:
        wmin, wmax = windows
        dev = starts.device
        gate = torch.ones(hit.shape, dtype=torch.bool, device=dev)
        for j, n in enumerate(geo.box):
            c = torch.arange(n, dtype=torch.int32, device=dev)[None] \
                + starts[:, j, None]
            ok = (c >= wmin[:, j, None]) & (c <= wmax[:, j, None])
            shape = [starts.shape[0], 1, 1, 1]
            shape[1 + j] = n
            gate = gate & ok.reshape(shape)
        hit = hit * gate
        epfree = epfree * gate
        free = free & gate
    miss = torch.maximum(hit, epfree) + free.to(torch.uint8)
    return starts, hit, miss


class TickObservations:
    """The voxels one tick observes: flat indices [n] i64, each with the
    hit or miss step of its counts; ``n`` is the tick's observed count."""

    def __init__(self, geo: Geometry, idx: torch.Tensor,
                 is_hit: torch.Tensor):
        self.idx = idx
        self.is_hit = is_hit
        self._geo = geo
        self._steps = {}

    def step(self, dtype: torch.dtype) -> torch.Tensor:
        """The log-odds step of each observed voxel, in ``dtype``."""
        if dtype not in self._steps:
            dev = self.idx.device
            hit = torch.full((), self._geo.l_hit, dtype=torch.float32,
                             device=dev)
            miss = torch.full((), self._geo.l_miss, dtype=torch.float32,
                              device=dev)
            self._steps[dtype] = torch.where(self.is_hit, hit, miss).to(dtype)
        return self._steps[dtype]


def tick_observations(geo: Geometry, starts, hits, misses) -> \
        TickObservations:
    """Sum a tick's scan boxes (corners [K,3], u8 counts [K,BX,BY,BZ])
    into the grid and list the voxels with a miss."""
    dev = hits.device
    hit_g = torch.zeros(geo.grid, dtype=torch.int32, device=dev)
    miss_g = torch.zeros(geo.grid, dtype=torch.int32, device=dev)
    bx, by, bz = geo.box
    for (x0, y0, z0), h, m in zip(starts.tolist(), hits, misses):
        hit_g[x0:x0 + bx, y0:y0 + by, z0:z0 + bz] += h.to(torch.int32)
        miss_g[x0:x0 + bx, y0:y0 + by, z0:z0 + bz] += m.to(torch.int32)
    hit_g = torch.clamp(hit_g, max=255).reshape(-1)
    miss_g = torch.clamp(miss_g, max=255).reshape(-1)
    idx = torch.nonzero(miss_g > 0).reshape(-1)
    return TickObservations(geo, idx, 2 * hit_g[idx] >= miss_g[idx])


class Map:
    """Log-odds and seen mask replayed through the drain.  ``dtype`` is
    the log-odds' precision: f32 as configured, lower for the control."""

    def __init__(self, geo: Geometry, device, dtype=torch.float32):
        self.geo = geo
        self.dtype = dtype
        n = geo.num_voxels
        self.logodds = torch.zeros(n, dtype=dtype, device=device)
        self.seen = torch.zeros(n, dtype=torch.uint8, device=device)

    def drain(self, obs: TickObservations):
        """One tick's drain; returns (observed, inserted, deleted) as
        0-dim tensors."""
        g = self.geo
        before = self.logodds[obs.idx]
        after = torch.clamp(before + obs.step(self.dtype), g.lo_min,
                            g.lo_max)
        occ_b, occ_a = before > g.occ_thr, after > g.occ_thr
        self.logodds[obs.idx] = after
        self.seen[obs.idx] = 1
        return (obs.idx.numel(), (occ_a & ~occ_b).sum(),
                (~occ_a & occ_b).sum())

    def occupied(self) -> torch.Tensor:
        return (self.logodds > self.geo.occ_thr).reshape(self.geo.grid)


def edt_d2(occupied: torch.Tensor, trunc: int) -> torch.Tensor:
    """Exact squared distance (voxel units, i32) from every voxel of
    ``occupied`` [X,Y,Z] bool to its nearest occupied voxel, INF_D2 where
    that exceeds ``trunc`` voxels."""
    x_n, y_n, z_n = occupied.shape
    dev = occupied.device
    cap = trunc + 1
    # along x: distance to the nearest occupied voxel of the column
    ix = torch.arange(x_n, device=dev)[:, None, None].expand(occupied.shape)
    far = 1 << 20
    below = torch.where(occupied, ix, -far).cummax(0).values
    above = torch.where(occupied, ix, x_n + far).flip(0).cummin(0).values \
        .flip(0)
    g = torch.clamp(torch.minimum(ix - below, above - ix), max=cap)
    f = torch.where(g >= cap, _FAR, g * g).to(torch.int32)
    # along y, then z: min over offsets |k| <= trunc of f[i + k] + k^2
    for axis in (1, 2):
        n = f.shape[axis]
        acc = f.clone()
        for k in range(1, min(trunc, n - 1) + 1):
            lo = f.narrow(axis, 0, n - k)       # f[i - k] for i >= k
            hi = f.narrow(axis, k, n - k)       # f[i + k] for i < n - k
            kk = k * k
            acc.narrow(axis, k, n - k).copy_(torch.minimum(
                acc.narrow(axis, k, n - k), lo + kk))
            acc.narrow(axis, 0, n - k).copy_(torch.minimum(
                acc.narrow(axis, 0, n - k), hi + kk))
        f = acc
    return torch.where(f <= trunc * trunc, f, INF_D2).to(torch.int32)
