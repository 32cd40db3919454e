"""Plain reference of the planner's read of a map, and the rule that
judges a closest grid, in plain PyTorch.

It imports nothing of the program under test.  From the reference's own
map (its occupancy, seen mask and exact truncated squared EDT) and the
geometry of ``rebuild.Geometry`` (``res``, ``origin``, ``map_size``,
``grid``, ``trunc``, ``infinity``) it works out:

* ``distance_grid``: sqrt(d2) times the resolution, in f32, and
  ``infinity`` where a voxel is unseen or beyond the truncation;
* ``nearest``: the distance at world positions, read at the voxel that
  holds each (FIESTA's GetDistance): ``infinity``
  where that voxel lies outside the grid, -10000 outside the map's box;
* ``trilinear``: distance and gradient at world positions, op for op in
  f32 in the reference's interpolation tree (GetDistWithGradTrilinear,
  ESDFMap.cpp:481-540), corners outside the grid reading infinity,
  positions outside the map -1 with a zero gradient (FIESTA's semantics
  as the JAX package states them), every division by a tensor so that it
  rounds as an IEEE division: a correct program agrees bit for bit.

A closest grid (a configuration that keeps one in its state) is judged by
a rule that does not depend on how ties are broken, so the reference
needs no copy of the program's tie-break: ``closest_errors`` counts the
voxels whose entry is not an occupied voxel at the exact squared
distance, or is not -1 exactly where that distance lies beyond the
truncation.  ``closest_grid`` gives such a grid from a map of its own (an
exact separable EDT that carries each minimum's source), for a control
to put in the program's place.
"""

from __future__ import annotations

import math

import torch

INF_D2 = 1 << 29          # the map's "far" squared distance
UNDEFINED = -10000.0      # the distance outside the map's box
_FAR = 1 << 24            # "no obstacle" inside the EDT's passes
_F32 = torch.float32


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=_F32, device=like.device)


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([float(v) for v in values], dtype=_F32,
                        device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root (through f64)."""
    return torch.sqrt(x.double()).float()


def pos_to_vox(geo, pos: torch.Tensor) -> torch.Tensor:
    """Voxel [..., 3] i32 holding each world position [..., 3] f32."""
    return torch.floor((pos - _vec(geo.origin, pos))
                       / _scalar(geo.res, pos)).to(torch.int32)


def vox_centre(geo, vox: torch.Tensor) -> torch.Tensor:
    """World position [..., 3] f32 of each voxel's centre."""
    ref = torch.empty((), dtype=_F32, device=vox.device)
    return ((vox.to(_F32) + 0.5) * _scalar(geo.res, ref)
            + _vec(geo.origin, ref))


def in_map(geo, pos: torch.Tensor) -> torch.Tensor:
    """Positions inside the map's box, faces included."""
    lo = _vec(geo.origin, pos)
    hi = lo + _vec(geo.map_size, pos)
    return torch.all((pos >= lo) & (pos <= hi), dim=-1)


def _lin(geo, vox: torch.Tensor) -> torch.Tensor:
    """Flat index (i64) of in-grid voxels [..., 3]."""
    _, gy, gz = geo.grid
    v = vox.to(torch.int64)
    return (v[..., 0] * gy + v[..., 1]) * gz + v[..., 2]


def _clip(geo, vox: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.clamp(vox[..., j], 0, g - 1)
                        for j, g in enumerate(geo.grid)], dim=-1)


def distance_grid(geo, d2: torch.Tensor,
                  seen: torch.Tensor) -> torch.Tensor:
    """Metric distance [X,Y,Z] f32 of a map's squared EDT ``d2`` (voxel
    units) and seen mask: ``infinity`` where unseen or beyond the
    truncation."""
    known = (seen.reshape(d2.shape) != 0) & (d2 < INF_D2)
    dist = _sqrt(d2.to(_F32)) * _scalar(geo.res, d2)
    return torch.where(known, dist, geo.infinity)


def nearest(geo, dist: torch.Tensor, pos: torch.Tensor,
            dtype: torch.dtype = _F32) -> torch.Tensor:
    """Distance [...] f32 at world positions [..., 3] f32: ``dist`` at the
    voxel holding each, ``infinity`` where that voxel lies outside the
    grid, ``UNDEFINED`` outside the map's box.  The grid's values are
    rounded to ``dtype``: f32 as the configuration states, lower for a
    control."""
    vox = pos_to_vox(geo, pos)
    hi = torch.tensor(geo.grid, dtype=torch.int32, device=pos.device)
    inside = torch.all((vox >= 0) & (vox < hi), dim=-1)
    v = dist.reshape(-1)[_lin(geo, _clip(geo, vox))].to(dtype).to(_F32)
    return torch.where(in_map(geo, pos),
                       torch.where(inside, v, geo.infinity), UNDEFINED)


def trilinear(geo, dist: torch.Tensor, pos: torch.Tensor,
              dtype: torch.dtype = _F32):
    """(distance [...], gradient [..., 3]) f32 at world positions [..., 3]
    f32: the trilinear interpolant of ``dist`` over the eight voxel
    centres around each position, and its analytic gradient.  The
    interpolation runs in ``dtype``: f32 as the configuration states,
    lower for a control."""
    gx, gy, gz = geo.grid
    res = _scalar(geo.res, pos)
    inside_map = in_map(geo, pos)
    idx = pos_to_vox(geo, pos - _scalar(0.5 * geo.res, pos))
    diff = ((pos - vox_centre(geo, idx)) / res).to(dtype)
    flat = dist.reshape(-1).to(dtype)

    def value(ox, oy, oz):
        ix, iy, iz = idx[..., 0] + ox, idx[..., 1] + oy, idx[..., 2] + oz
        ok = ((ix >= 0) & (ix < gx) & (iy >= 0) & (iy < gy) & (iz >= 0)
              & (iz < gz))
        v = flat[_lin(geo, _clip(geo, torch.stack([ix, iy, iz], -1)))]
        return torch.where(ok, v, geo.infinity)

    c = {(x, y, z): value(x, y, z) for x in (0, 1) for y in (0, 1)
         for z in (0, 1)}
    dx, dy, dz = diff[..., 0], diff[..., 1], diff[..., 2]
    # the interpolation tree of ESDFMap.cpp:519-539
    v00 = (1 - dx) * c[0, 0, 0] + dx * c[1, 0, 0]
    v01 = (1 - dx) * c[0, 0, 1] + dx * c[1, 0, 1]
    v10 = (1 - dx) * c[0, 1, 0] + dx * c[1, 1, 0]
    v11 = (1 - dx) * c[0, 1, 1] + dx * c[1, 1, 1]
    v0 = (1 - dy) * v00 + dy * v10
    v1 = (1 - dy) * v01 + dy * v11
    d = (1 - dz) * v0 + dz * v1
    inv = _scalar(1.0 / geo.res, pos).to(dtype)
    g_z = (v1 - v0) * inv
    g_y = ((1 - dz) * (v10 - v00) + dz * (v11 - v01)) * inv
    g_x = ((1 - dz) * (1 - dy) * (c[1, 0, 0] - c[0, 0, 0])
           + (1 - dz) * dy * (c[1, 1, 0] - c[0, 1, 0])
           + dz * (1 - dy) * (c[1, 0, 1] - c[0, 0, 1])
           + dz * dy * (c[1, 1, 1] - c[0, 1, 1])) * inv
    grad = torch.stack([g_x, g_y, g_z], dim=-1).to(_F32)
    return (torch.where(inside_map, d.to(_F32), -1.0),
            torch.where(inside_map[..., None], grad, 0.0))


def nearest_errors(geo, dist: torch.Tensor, ref_dist: torch.Tensor,
                   pos: torch.Tensor) -> int:
    """Positions whose distance differs, bit for bit, from the nearest
    read of the reference's distance grid."""
    want = nearest(geo, ref_dist, pos)
    return int((dist.reshape(-1).view(torch.int32)
                != want.reshape(-1).view(torch.int32)).sum())


def trilinear_errors(geo, dist: torch.Tensor, grad: torch.Tensor,
                     ref_dist: torch.Tensor, pos: torch.Tensor) -> int:
    """Positions whose distance or gradient differs, bit for bit, from
    the trilinear read of the reference's distance grid."""
    want_d, want_g = trilinear(geo, ref_dist, pos)
    bad = dist.reshape(-1).view(torch.int32) \
        != want_d.reshape(-1).view(torch.int32)
    bad |= (grad.reshape(-1, 3).view(torch.int32)
            != want_g.reshape(-1, 3).view(torch.int32)).any(dim=-1)
    return int(bad.sum())


def _decode(closest: torch.Tensor, xs: slice):
    """(x, y, z, defined, malformed) i64 of the closest entries of the
    x-slab ``xs``: a packed i32 grid (x << 20 | y << 10 | z, -1 undefined)
    or three i16 coordinate planes (-1 undefined)."""
    if closest.dim() == 3:
        p = closest[xs].to(torch.int64)
        return (p >> 20, (p >> 10) & 1023, p & 1023, p >= 0, p < -1)
    c = [closest[i, xs].to(torch.int64) for i in range(3)]
    defined = (c[0] >= 0) & (c[1] >= 0) & (c[2] >= 0)
    undefined = (c[0] == -1) & (c[1] == -1) & (c[2] == -1)
    return c[0], c[1], c[2], defined, ~defined & ~undefined


def closest_errors(geo, closest: torch.Tensor,
                   occupied: torch.Tensor, d2: torch.Tensor,
                   slab: int = 16) -> int:
    """Voxels whose closest entry is wrong: not an occupied voxel (of the
    reference's ``occupied`` [X,Y,Z]) at squared distance equal to the
    reference's exact ``d2``, or not -1 exactly where ``d2`` is
    ``INF_D2``.  Works through x-slabs of ``slab`` planes."""
    gx, gy, gz = geo.grid
    dev = d2.device
    occ = occupied.reshape(-1)
    ys = torch.arange(gy, device=dev)[None, :, None]
    zs = torch.arange(gz, device=dev)[None, None, :]
    bad = 0
    for x0 in range(0, gx, slab):
        xs = slice(x0, min(gx, x0 + slab))
        cx, cy, cz, defined, malformed = _decode(closest, xs)
        far = d2[xs] >= INF_D2
        wrong = malformed | (defined == far)
        inside = ((cx >= 0) & (cx < gx) & (cy >= 0) & (cy < gy) & (cz >= 0)
                  & (cz < gz))
        lin = torch.where(inside, (cx * gy + cy) * gz + cz, 0)
        xv = torch.arange(xs.start, xs.stop, device=dev)[:, None, None]
        r2 = (cx - xv) ** 2 + (cy - ys) ** 2 + (cz - zs) ** 2
        ok = inside & occ[lin] & (r2 == d2[xs].to(torch.int64))
        wrong |= defined & ~far & ~ok
        bad += int(wrong.sum())
    return bad


# ---------------------------------------------------------------------------
# Answers of the reference's own, for a control in the program's place
# ---------------------------------------------------------------------------


def closest_grid(geo, occupied: torch.Tensor) -> torch.Tensor:
    """A closest grid of ``occupied`` [X,Y,Z] bool: for every voxel an
    occupied voxel at the least squared distance, -1 beyond the
    truncation, packed (x << 20 | y << 10 | z, i32) where every axis fits
    10 bits, else three i16 planes.  The EDT's passes (nearest along x by
    running min and max of indices, then windowed min-plus along y and
    z), each minimum carrying its source's coordinates."""
    x_n, y_n, z_n = occupied.shape
    dev = occupied.device
    t = geo.trunc
    cap = t + 1
    ix = torch.arange(x_n, device=dev)[:, None, None].expand(occupied.shape)
    far = 1 << 20
    below = torch.where(occupied, ix, -far).cummax(0).values
    above = torch.where(occupied, ix, x_n + far).flip(0).cummin(0).values \
        .flip(0)
    take_below = ix - below <= above - ix
    g = torch.clamp(torch.minimum(ix - below, above - ix), max=cap)
    f = torch.where(g >= cap, _FAR, g * g).to(torch.int32)
    src = [torch.where(take_below, below, above).to(torch.int32)]
    for axis in (1, 2):
        n = f.shape[axis]
        shape = [1, 1, 1]
        shape[axis] = n
        own = torch.arange(n, dtype=torch.int32, device=dev).reshape(shape) \
            .expand(f.shape)
        src = src + [own]
        acc = f.clone()
        carried = [s.clone() for s in src]
        for k in range(1, min(t, n - 1) + 1):
            for to, frm in ((k, 0), (0, k)):
                cand = f.narrow(axis, frm, n - k) + k * k
                tgt = acc.narrow(axis, to, n - k)
                better = cand < tgt
                tgt.copy_(torch.where(better, cand, tgt))
                for c, s in zip(carried, src):
                    c_t = c.narrow(axis, to, n - k)
                    c_t.copy_(torch.where(better, s.narrow(axis, frm, n - k),
                                          c_t))
        f, src = acc, carried
    defined = f <= t * t
    if all(g <= 1024 for g in geo.grid):
        packed = (src[0] << 20) | (src[1] << 10) | src[2]
        return torch.where(defined, packed, -1).to(torch.int32)
    return torch.stack([torch.where(defined, s, -1) for s in src]) \
        .to(torch.int16)
