"""Planner-facing distance, gradient and closest-obstacle queries (port of
``fiesta_tpu/ops/query.py``; reference GetDistance, ESDFMap.cpp:467-479,
and GetDistWithGradTrilinear, ESDFMap.cpp:481-540).

Plain PyTorch, batched over any leading dims: they are XLA in the JAX
package.  Grid values are read by direct indexing where the TPU reads whole
z rows and selects with an iota mask (``query.py:64-67, 107-111``); the
result is the same, as the masked sum adds one value to zeros.  f32
expressions keep the JAX op order, and every division is by a 0-dim
tensor (``grid.f32_scalar``), so the results are bit-equal.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import FiestaConfig
from ..grid import (INF_D2, UNDEFINED_DIST, const_vec, f32_scalar,
                    occupied_grid, pos_in_map, pos_to_vox, sqrt_f32,
                    vox_to_pos)
from .edt import trunc_vox_for, truncated_edt_d2


def _at(grid: torch.Tensor, ix, iy, iz) -> torch.Tensor:
    """grid[ix, iy, iz] for in-range index tensors of one shape."""
    _, gy, gz = grid.shape
    lin = (ix.to(torch.int64) * gy + iy.to(torch.int64)) * gz \
        + iz.to(torch.int64)
    return grid.reshape(-1)[lin]


def _clip_vox(cfg: FiestaConfig, vox: torch.Tensor) -> torch.Tensor:
    hi = const_vec([g - 1 for g in cfg.grid_shape], vox.dtype, vox)
    return torch.minimum(torch.clamp(vox, min=0), hi)


def distance_grid(cfg: FiestaConfig, d2: torch.Tensor,
                  seen: torch.Tensor) -> torch.Tensor:
    """Dense metric distances [X,Y,Z] f32; unobserved or unreached voxels
    read ``cfg.infinity_distance`` (ESDFMap.cpp:246-248, 477-479)."""
    known = (seen != 0) & (d2 < INF_D2)
    dist = sqrt_f32(d2.to(torch.float32)) * cfg.resolution
    return torch.where(known, dist, cfg.infinity_distance)


def get_distance_vox(cfg: FiestaConfig, dist: torch.Tensor,
                     vox: torch.Tensor) -> torch.Tensor:
    """Distance at integer voxels [..., 3]; out-of-grid reads infinity."""
    hi = const_vec(cfg.grid_shape, vox.dtype, vox)
    inside = torch.all((vox >= 0) & (vox < hi), dim=-1)
    v = _clip_vox(cfg, vox)
    vals = _at(dist, v[..., 0], v[..., 1], v[..., 2])
    return torch.where(inside, vals, cfg.infinity_distance)


def get_distance(cfg: FiestaConfig, dist: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Distance at world positions [..., 3] (GetDistance); out-of-map
    positions return UNDEFINED_DIST (-10000), as the reference."""
    d = get_distance_vox(cfg, dist, pos_to_vox(cfg, pos))
    return torch.where(pos_in_map(cfg, pos), d, UNDEFINED_DIST)


def get_dist_grad_trilinear(
    cfg: FiestaConfig, dist: torch.Tensor, pos: torch.Tensor,
    out_value: float = -1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinearly interpolated distance and the analytic gradient of the
    interpolant (GetDistWithGradTrilinear).  Returns (dist [...], grad
    [..., 3]); out-of-map queries give ``out_value`` and a zero gradient.
    Corners outside the grid read infinity."""
    in_map = pos_in_map(cfg, pos)
    gx, gy, gz = cfg.grid_shape

    # corner voxel: Pos2Vox(pos - res/2) (ESDFMap.cpp:498-501)
    idx = pos_to_vox(cfg, pos - 0.5 * cfg.resolution)
    diff = (pos - vox_to_pos(cfg, idx)) / f32_scalar(cfg.resolution, pos)
    ix0, iy0, iz0 = idx[..., 0], idx[..., 1], idx[..., 2]

    def corner(ox, oy, oz):
        ix, iy, iz = ix0 + ox, iy0 + oy, iz0 + oz
        ok = ((ix >= 0) & (ix < gx) & (iy >= 0) & (iy < gy) & (iz >= 0)
              & (iz < gz))
        v = _at(dist, torch.clamp(ix, 0, gx - 1), torch.clamp(iy, 0, gy - 1),
                torch.clamp(iz, 0, gz - 1))
        return torch.where(ok, v, cfg.infinity_distance)

    v000, v001 = corner(0, 0, 0), corner(0, 0, 1)
    v100, v101 = corner(1, 0, 0), corner(1, 0, 1)
    v010, v011 = corner(0, 1, 0), corner(0, 1, 1)
    v110, v111 = corner(1, 1, 0), corner(1, 1, 1)

    dx, dy, dz = diff[..., 0], diff[..., 1], diff[..., 2]

    # the reference's interpolation tree (ESDFMap.cpp:519-539)
    v00 = (1 - dx) * v000 + dx * v100
    v01 = (1 - dx) * v001 + dx * v101
    v10 = (1 - dx) * v010 + dx * v110
    v11 = (1 - dx) * v011 + dx * v111

    v0 = (1 - dy) * v00 + dy * v10
    v1 = (1 - dy) * v01 + dy * v11

    d = (1 - dz) * v0 + dz * v1

    res_inv = 1.0 / cfg.resolution
    g_z = (v1 - v0) * res_inv
    g_y = ((1 - dz) * (v10 - v00) + dz * (v11 - v01)) * res_inv
    g_x = (
        (1 - dz) * (1 - dy) * (v100 - v000)
        + (1 - dz) * dy * (v110 - v010)
        + dz * (1 - dy) * (v101 - v001)
        + dz * dy * (v111 - v011)
    ) * res_inv

    grad = torch.stack([g_x, g_y, g_z], dim=-1)
    d = torch.where(in_map, d, out_value)
    grad = torch.where(in_map[..., None], grad, 0.0)
    return d, grad


def get_closest_obstacle(
    cfg: FiestaConfig,
    closest: torch.Tensor,   # packed i32 [X,Y,Z] or i16 [3,X,Y,Z] planes
    d2: torch.Tensor,        # [X,Y,Z] i32
    seen: torch.Tensor,      # [X,Y,Z] u8 {0,1}
    pos: torch.Tensor,       # [..., 3] world positions
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World coordinates of the nearest obstacle voxel centre and its
    distance, per query position.  Undefined (no obstacle within the
    truncation, unobserved voxel, or out of map): NaN coordinates and
    ``cfg.infinity_distance``.  Both closest state formats are taken."""
    in_map = pos_in_map(cfg, pos)
    v = _clip_vox(cfg, pos_to_vox(cfg, pos))
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    if closest.dim() == 3:     # packed x<<20 | y<<10 | z, -1 undefined
        p = _at(closest, vx, vy, vz).to(torch.int32)
        c = torch.where((p >= 0)[..., None],
                        torch.stack([p >> 20, (p >> 10) & 1023, p & 1023],
                                    dim=-1), -1)
    else:
        c = torch.stack([_at(closest[i], vx, vy, vz) for i in range(3)],
                        dim=-1).to(torch.int32)
    d2_v = _at(d2, vx, vy, vz)
    seen_v = _at(seen, vx, vy, vz)
    defined = in_map & (seen_v != 0) & (c[..., 0] >= 0) & (d2_v < INF_D2)
    pts = vox_to_pos(cfg, c)
    dist = sqrt_f32(d2_v.to(torch.float32)) * cfg.resolution
    return (torch.where(defined[..., None], pts, float("nan")),
            torch.where(defined, dist, cfg.infinity_distance))


def signed_distance_grid(cfg: FiestaConfig, d2: torch.Tensor,
                         seen: torch.Tensor,
                         occupied: torch.Tensor) -> torch.Tensor:
    """Signed distance field [X,Y,Z] f32: positive outside obstacles,
    negative inside, where interior distances come from an EDT of the free
    space truncated at ``cfg.trunc_dist`` and clamped there (C18)."""
    occupied = occupied.to(torch.bool)
    outside = distance_grid(cfg, d2, seen)
    t_m = cfg.trunc_dist
    d2_in = truncated_edt_d2(~occupied, trunc_vox_for(cfg.resolution, t_m))
    inside = torch.clamp(sqrt_f32(d2_in.to(torch.float32)) * cfg.resolution,
                         max=t_m)
    return torch.where(occupied, -inside, outside)


def get_occupancy(cfg: FiestaConfig, logodds: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """GetOccupancy (ESDFMap.cpp:452-460): -10000 out of map, else 0/1
    occupancy, i32."""
    v = _clip_vox(cfg, pos_to_vox(cfg, pos))
    occ = _at(occupied_grid(cfg, logodds), v[..., 0], v[..., 1], v[..., 2])
    return torch.where(pos_in_map(cfg, pos), occ.to(torch.int32), -10000)
