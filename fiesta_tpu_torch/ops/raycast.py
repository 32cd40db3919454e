"""Scanline integration: endpoint splat + octant free-space carve (port of
the batched scanline path of ``fiesta_tpu/ops/raycast.py``).

Per tick, K scans are integrated into sensor-centered carve boxes:

1. per-ray prep (plain PyTorch, component form): validity and length
   gates, clipping at max_ray_length, box placement, endpoint or box-exit
   voxel, and ONE packed f32 per ray carrying observation class and range
   (``2000 + range`` for a hit, ``1000 + range`` for a free seed);
2. the splat (``splat_packed``): zero-filled target, scatter-max of the
   packed values, decode into seeds / hit / free-endpoint masks;
3. the carve (``carve_free_mask_batch``): octant wavefront sweeps that
   propagate max observation range from the seeds toward the sensor, then
   the free test;
4. the counter apply: a saturating u8 add of each scan's box into the
   full grid, in scan order, with box corners kept on the device so the
   tick never waits on the host.

Steps 2, 3 and 4 have hand-written CUDA kernels (``kernels/splat.cu``,
``kernels/carve.cu``, ``kernels/boxadd.cu``); a CPU tensor takes the plain
PyTorch version here.

f32 arithmetic follows the JAX expressions op for op, with tensor
divisors (``grid.f32_scalar``) so that every division is IEEE.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import FiestaConfig
from ..grid import f32_scalar


class ScanResult(NamedTuple):
    hit_cnt: torch.Tensor
    miss_cnt: torch.Tensor
    num_rays: torch.Tensor       # rays passing validity/length gates
    num_endpoints: torch.Tensor  # endpoint observations splatted


# ---------------------------------------------------------------------------
# Carve box placement (ops/raycast.py:601-665)
# ---------------------------------------------------------------------------


def _carve_reach(cfg: FiestaConfig) -> int:
    """Half-extent r (voxels) of a scan's reach around the sensor voxel."""
    return int(math.ceil((cfg.max_ray_length + 2 * cfg.resolution)
                         / cfg.resolution)) + 2


def _aligned_box(cfg: FiestaConfig) -> bool:
    """Whether box corners are 8-aligned in x/y (grids whose x/y extents
    are multiples of 8)."""
    return cfg.grid_shape[0] % 8 == 0 and cfg.grid_shape[1] % 8 == 0


def _carve_box_shape(cfg: FiestaConfig) -> Tuple[int, int, int]:
    """Static carve-box shape; in aligned mode x/y extents are
    ``round_up(2r+1 + 7, 8)`` so a floored corner still covers the reach."""
    e = 2 * _carve_reach(cfg) + 1
    gx, gy, gz = cfg.grid_shape
    if _aligned_box(cfg):
        ea = -(-(e + 7) // 8) * 8
        return min(gx, ea), min(gy, ea), min(gz, e)
    return min(gx, e), min(gy, e), min(gz, e)


def _box_starts(cfg: FiestaConfig, po_grid: torch.Tensor) -> torch.Tensor:
    """Carve-box corners [K,3] i32 for sensor grid positions [K,3] f32.
    The floor to a multiple of 8 comes BEFORE the face clamp (see the JAX
    docstring for the coverage proof); ``torch.round`` rounds half to even
    like ``jnp.round``."""
    e = 2 * _carve_reach(cfg) + 1
    grid = cfg.grid_shape
    box = _carve_box_shape(cfg)
    cols = []
    for j in range(3):
        ex = min(grid[j], e)
        u = torch.clamp(torch.round(po_grid[:, j]).to(torch.int32) - ex // 2,
                        0, grid[j] - ex)
        if _aligned_box(cfg) and j < 2:
            u = (u // 8) * 8
        cols.append(torch.clamp(u, 0, grid[j] - box[j]))
    return torch.stack(cols, dim=1)


# ---------------------------------------------------------------------------
# Kernel 1: the splat
# ---------------------------------------------------------------------------


def _epfree_threshold(cfg: FiestaConfig) -> float:
    """f32 value of the free-endpoint threshold ``max_ray + res - 1e-4``
    (ops/pallas/fill.py:88)."""
    return float(np.float32(cfg.max_ray_length + cfg.resolution - 1e-4))


def _seeds_from_packed(packed: torch.Tensor, thr: float):
    """Decode packed class+range values into (seeds f32, hit u8, epfree
    u8) (``_seeds_from_packed``, ops/raycast.py:738-754)."""
    hit = packed >= 2000.0
    freeish = (packed >= 1000.0) & (packed < 2000.0)
    seeds = torch.where(hit, packed - 2000.0,
                        torch.where(freeish, packed - 1000.0, 0.0))
    epfree = freeish & (packed - 1000.0 >= thr)
    return seeds, hit.to(torch.uint8), epfree.to(torch.uint8)


def _splat_packed_plain(lin: torch.Tensor, val: torch.Tensor, n: int,
                        thr: float):
    """Plain version of the splat: zero target, scatter-max, decode.
    Indices ``>= n`` are dropped (JAX ``mode="drop"``): they land in one
    spare slot that is sliced off."""
    target = torch.zeros(n + 1, dtype=torch.float32, device=lin.device)
    idx = torch.clamp(lin, max=n).to(torch.int64)
    target.scatter_reduce_(0, idx, val, reduce="amax", include_self=True)
    return _seeds_from_packed(target[:n], thr)


def splat_packed(lin: torch.Tensor, val: torch.Tensor, n: int, thr: float):
    """Scatter-max the packed values ``val`` [R] f32 (>= 1000) at flat
    indices ``lin`` [R] i32 into a zeroed target of ``n`` cells, then
    decode: returns flat (seeds f32, hit u8, epfree u8) [n].  CUDA tensor:
    the ``splat`` kernel; CPU tensor: the plain version."""
    if lin.is_cuda:
        return kernels.splat(lin, val, n, thr)
    return _splat_packed_plain(lin, val, n, thr)


def _scanline_splat_prep(cfg: FiestaConfig, points, valid, origins=None,
                         transforms=None):
    """Per-ray half of the batched splat (ops/raycast.py:775-877): box
    placement, endpoint or box-exit voxel and the packed value per ray.

    points [K,P,3] f32 world-frame, or sensor-frame when ``transforms``
    [K,4,4] is given (origins are then the transforms' translations);
    valid [K,P] bool.  Returns (starts [K,3] i32, po_box [K,3] f32,
    lin_flat [K*P] i32 flat target index (K*BX*BY*BZ = dropped),
    val_flat [K*P] f32 packed value, rvalid [K,P] bool).
    """
    gx, gy, gz = cfg.grid_shape
    bx, by, bz = _carve_box_shape(cfg)
    nb = bx * by * bz
    k = points.shape[0]
    if k * nb >= 2**31:
        # the flat index k*nb + lin_w is int32; past 2^31 it wraps
        raise ValueError(
            f"flat endpoint splat index overflows int32: {k} scans x "
            f"{nb} box voxels = {k * nb} >= 2^31; reduce scans_per_tick "
            "or the carve box (max_ray_length/resolution)")
    res = cfg.resolution
    res_t = f32_scalar(res, points)
    mx, my, mz = (float(np.float32(o)) for o in cfg.origin)

    px, py, pz = (points[..., j] for j in range(3))          # [K,P]
    if transforms is not None:
        r = transforms[:, :3, :3]
        px, py, pz = [
            px * r[:, i, 0, None] + py * r[:, i, 1, None]
            + pz * r[:, i, 2, None] + transforms[:, i, 3, None]
            for i in (0, 1, 2)]
        origins = transforms[:, :3, 3]
    ox, oy, oz = (origins[:, j, None] for j in range(3))     # [K,1]

    # --- length gates and max-ray clipping (Fiesta.h:208-215) ---
    valid = valid & torch.isfinite(px) & torch.isfinite(py) \
        & torch.isfinite(pz)
    dx, dy, dz = px - ox, py - oy, pz - oz
    length = torch.sqrt(dx * dx + dy * dy + dz * dz)
    rvalid = valid & (length >= cfg.min_ray_length)
    is_hit = length <= cfg.max_ray_length
    scale = torch.where(
        is_hit, 1.0,
        f32_scalar(cfg.max_ray_length, length) / torch.clamp(length, min=1e-9))
    cx, cy, cz = ox + dx * scale, oy + dy * scale, oz + dz * scale

    # --- box placement [K,3] ---
    po_grid = torch.stack([(origins[:, j] - m) / res_t - 0.5
                           for j, m in enumerate((mx, my, mz))], dim=1)
    starts = _box_starts(cfg, po_grid)
    po_box = po_grid - starts.to(torch.float32)
    sx0, sy0, sz0 = (starts[:, j, None] for j in range(3))   # [K,1] i32

    # --- endpoint voxels in box coordinates ---
    vx = torch.floor((cx - mx) / res_t).to(torch.int32)
    vy = torch.floor((cy - my) / res_t).to(torch.int32)
    vz = torch.floor((cz - mz) / res_t).to(torch.int32)
    vbx, vby, vbz = vx - sx0, vy - sy0, vz - sz0
    in_box = ((vbx >= 0) & (vbx < bx) & (vby >= 0) & (vby < by)
              & (vbz >= 0) & (vbz < bz))
    inside = in_box & ((vx >= 0) & (vx < gx) & (vy >= 0) & (vy < gy)
                       & (vz >= 0) & (vz < gz))

    # --- box-exit clip for rays leaving the box ---
    lwx = mx + sx0.to(torch.float32) * res
    lwy = my + sy0.to(torch.float32) * res
    lwz = mz + sz0.to(torch.float32) * res
    hwx, hwy, hwz = lwx + bx * res, lwy + by * res, lwz + bz * res
    ux, uy, uz = cx - ox, cy - oy, cz - oz

    def t_axis(u, lo, hi, o):
        safe = torch.where(torch.abs(u) < 1e-9, 1e-9, u)
        return torch.where(u > 0, (hi - o) / safe, (lo - o) / safe)

    s_exit = torch.clamp(
        torch.minimum(torch.minimum(t_axis(ux, lwx, hwx, ox),
                                    t_axis(uy, lwy, hwy, oy)),
                      t_axis(uz, lwz, hwz, oz)), 0.0, 1.0)
    ulen = torch.sqrt(ux * ux + uy * uy + uz * uz)
    exit_dist = s_exit * ulen - 0.5 * res
    f = exit_dist / torch.clamp(ulen, min=1e-9)
    ebx = torch.clamp(torch.floor((ox + ux * f - mx) / res_t).to(torch.int32)
                      - sx0, 0, bx - 1)
    eby = torch.clamp(torch.floor((oy + uy * f - my) / res_t).to(torch.int32)
                      - sy0, 0, by - 1)
    ebz = torch.clamp(torch.floor((oz + uz * f - mz) / res_t).to(torch.int32)
                      - sz0, 0, bz - 1)

    # --- packed class+range value, flat index, splat ---
    sxx = torch.where(inside, vbx, ebx)
    syy = torch.where(inside, vby, eby)
    szz = torch.where(inside, vbz, ebz)
    packed_val = torch.where(
        inside & is_hit, 2000.0 + length,
        1000.0 + torch.where(inside, cfg.max_ray_length + cfg.resolution,
                             exit_dist + cfg.resolution))
    lin_w = sxx * (by * bz) + syy * bz + szz
    scan = torch.arange(k, dtype=torch.int32, device=points.device) * nb
    biglin = lin_w + scan[:, None]
    lin_flat = torch.where(rvalid, biglin, k * nb).reshape(-1)
    return starts, po_box, lin_flat, packed_val.reshape(-1), rvalid


def _scanline_seeds_batch(cfg: FiestaConfig, points, valid, origins=None,
                          transforms=None):
    """Batched endpoint splat (``_scanline_seeds_batch``,
    ops/raycast.py:757-910): the per-ray prep, then ONE flat splat over
    all K scans.  Returns (starts [K,3] i32, po_box [K,3] f32,
    seeds [K,BX,BY,BZ] f32, hit_b u8, epfree_b u8, rvalid [K,P] bool)."""
    starts, po_box, lin_flat, val_flat, rvalid = _scanline_splat_prep(
        cfg, points, valid, origins, transforms)
    box = (points.shape[0],) + _carve_box_shape(cfg)
    seeds, hit_b, epfree_b = splat_packed(
        lin_flat, val_flat, math.prod(box), _epfree_threshold(cfg))
    return (starts, po_box, seeds.reshape(box), hit_b.reshape(box),
            epfree_b.reshape(box), rvalid)


# ---------------------------------------------------------------------------
# Kernel 2: the carve
# ---------------------------------------------------------------------------


def _shift2d_b(x: torch.Tensor, dy: int, dz: int) -> torch.Tensor:
    """out[..., i, j] = x[..., i + dy, j + dz] with zero fill."""
    y, z = x.shape[-2], x.shape[-1]
    if dy:
        blk = torch.zeros(x.shape[:-2] + (abs(dy), z), dtype=x.dtype,
                          device=x.device)
        x = (torch.cat([x[..., dy:, :], blk], -2) if dy > 0
             else torch.cat([blk, x[..., :dy, :]], -2))
    if dz:
        blk = torch.zeros(x.shape[:-1] + (abs(dz),), dtype=x.dtype,
                          device=x.device)
        x = (torch.cat([x[..., dz:], blk], -1) if dz > 0
             else torch.cat([blk, x[..., :dz]], -1))
    return x


def _taps_max_b(carry, f2, f3):
    """Max over the (up to) four cells bracketing each cell's line of
    sight: carry [B, C2, C3], fractional offsets f2 [B, C2], f3 [B, C3]."""
    b2 = torch.floor(f2)
    b3 = torch.floor(f3)
    t = torch.zeros_like(carry)
    for d in (-1, 0, 1):
        m = ((b2 == d) | (b2 == d - 1))[:, :, None]
        t = torch.maximum(t, torch.where(m, _shift2d_b(carry, d, 0), 0.0))
    out = torch.zeros_like(carry)
    for d in (-1, 0, 1):
        m = ((b3 == d) | (b3 == d - 1))[:, None, :]
        out = torch.maximum(out, torch.where(m, _shift2d_b(t, 0, d), 0.0))
    return out


def _octant_scan_batched(seeds, flips, po_a, o2, o3):
    """Far-to-near sweep over a batch of octant wavefronts
    (``_octant_scan_batched``, ops/raycast.py:349-401).

    seeds [B, A, C2, C3] f32 (scan axis leading); flips: B bools, True =
    positive octant (walked from the high end); po_a [B] sensor coordinate
    along the scan axis; o2 [B, C2], o3 [B, C3] trailing-axis offsets.
    Returns W [B, A, C2, C3], the propagated max observation range.  (The
    JAX form pads A to a multiple of 4 with zero slabs walked first; they
    leave the carry at zero, so the walk here needs no pad.)
    """
    b, a = seeds.shape[:2]
    dev = seeds.device
    ar = torch.arange(a, device=dev)
    steps = torch.stack([a - 1 - ar if fl else ar for fl in flips])  # [B,A]
    idx_f = steps.to(torch.float32)
    rows = torch.arange(b, device=dev)
    carry = torch.zeros((b,) + tuple(seeds.shape[2:]), dtype=seeds.dtype,
                        device=dev)
    w = torch.empty_like(seeds)
    for s in range(a):
        ia = steps[:, s]
        d = torch.clamp(torch.abs(idx_f[:, s] - po_a), min=0.5)   # [B]
        f2 = o2 / d[:, None]
        f3 = o3 / d[:, None]
        carry = torch.maximum(seeds[rows, ia], _taps_max_b(carry, f2, f3))
        w[rows, ia] = carry
    return w


def _free_from_r2(cfg: FiestaConfig, r2, W):
    """Free test in squared voxel units: sensor distance within the ray
    gates and strictly closer (by one voxel) than the propagated range."""
    res = cfg.resolution
    wv = (W - res) * (1.0 / res)
    return ((W > res)
            & (r2 >= (cfg.min_ray_length / res) ** 2)
            & (r2 <= (cfg.max_ray_length / res) ** 2)
            & (r2 < wv * wv))


def _carve_free_plain(cfg: FiestaConfig, seeds: torch.Tensor,
                      po: torch.Tensor) -> torch.Tensor:
    """Plain version of the carve (the non-TPU branch of
    ``carve_free_mask_batch``, ops/raycast.py:542-598).  Returns the free
    mask [K, BX, BY, BZ] bool."""
    k, bx, by, bz = seeds.shape
    dev = seeds.device
    xs = torch.arange(bx, dtype=torch.float32, device=dev)
    ys = torch.arange(by, dtype=torch.float32, device=dev)
    zs = torch.arange(bz, dtype=torch.float32, device=dev)
    dx = xs[None, :, None, None] - po[:, 0, None, None, None]
    dy = ys[None, None, :, None] - po[:, 1, None, None, None]
    dz = zs[None, None, None, :] - po[:, 2, None, None, None]
    adx, ady, adz = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    # octant partition: dominant axis = max magnitude, ties x > y > z
    octx = (adx >= ady) & (adx >= adz)
    octy = ~octx & (ady >= adz)
    octz = ~octx & ~octy
    o_x = xs[None] - po[:, 0, None]    # [K, BX]
    o_y = ys[None] - po[:, 1, None]    # [K, BY]
    o_z = zs[None] - po[:, 2, None]    # [K, BZ]
    r2 = dx * dx + dy * dy + dz * dz

    def sweep_pair(s, oct_m, d, perm, po_a, o2, o3):
        """Forward (d <= 0) and reverse (d > 0) sweeps of one orientation;
        seeds are masked to the orientation's octant and sign, the free
        test to the sweep's own half-space."""
        s_n = torch.where(oct_m & (d <= 0), s, 0.0).permute(perm)
        s_p = torch.where(oct_m & (d > 0), s, 0.0).permute(perm)
        w = _octant_scan_batched(
            torch.cat([s_n, s_p], 0), (False,) * k + (True,) * k,
            torch.cat([po_a, po_a]), torch.cat([o2, o2], 0),
            torch.cat([o3, o3], 0))
        inv = [perm.index(i) for i in range(4)]
        wf, wr = w[:k].permute(inv), w[k:].permute(inv)
        return ((_free_from_r2(cfg, r2, wf) & (d <= 0))
                | (_free_from_r2(cfg, r2, wr) & (d > 0)))

    free = sweep_pair(seeds, octx, dx, (0, 1, 2, 3), po[:, 0], o_y, o_z)
    free |= sweep_pair(seeds, octy, dy, (0, 2, 1, 3), po[:, 1], o_x, o_z)
    free |= sweep_pair(seeds, octz, dz, (0, 3, 1, 2), po[:, 2], o_x, o_y)
    return free


def carve_free_mask_batch(cfg: FiestaConfig, seeds: torch.Tensor,
                          po: torch.Tensor) -> torch.Tensor:
    """Batched free-space carve: seeds [K,BX,BY,BZ] f32, po [K,3] f32
    (sensor in box index units) -> free mask [K,BX,BY,BZ] (bool on the
    CPU, u8 {0,1} from the kernel).  CUDA tensor: the ``carve`` kernel;
    CPU tensor: the plain version."""
    if seeds.is_cuda:
        return kernels.carve(
            seeds, po, res=cfg.resolution, min_ray=cfg.min_ray_length,
            max_ray=cfg.max_ray_length)
    return _carve_free_plain(cfg, seeds, po)


# ---------------------------------------------------------------------------
# Counter apply and the batched integrator (ops/raycast.py:961-1073)
# ---------------------------------------------------------------------------


def _apply_box_counts_plain(hit_cnt, miss_cnt, starts, hitc, missc):
    """Plain version of the counter apply: one saturating u8 add per scan,
    in scan order (the JAX ``rmw`` mode), into the given grids in place.
    The box region's flat indices are built on the device from
    ``starts``, so no value leaves the device.  Returns (hit_cnt,
    miss_cnt), the tensors it was given."""
    gy, gz = hit_cnt.shape[1:]
    box = hitc.shape[1:]
    dev = hit_cnt.device
    offs = (torch.arange(box[0], device=dev)[:, None, None] * (gy * gz)
            + torch.arange(box[1], device=dev)[None, :, None] * gz
            + torch.arange(box[2], device=dev)[None, None, :]).reshape(-1)
    st = starts.to(torch.int64)
    base = st[:, 0] * (gy * gz) + st[:, 1] * gz + st[:, 2]        # [K]
    hit_flat, miss_flat = hit_cnt.view(-1), miss_cnt.view(-1)
    for i in range(starts.shape[0]):
        idx = offs + base[i]
        for flat, inc in ((hit_flat, hitc[i]), (miss_flat, missc[i])):
            reg = flat[idx].to(torch.int32) + inc.reshape(-1).to(torch.int32)
            flat[idx] = torch.clamp(reg, max=255).to(torch.uint8)
    return hit_cnt, miss_cnt


def apply_box_counts(hit_cnt, miss_cnt, starts, hitc, missc):
    """Add K scans' box-local counts [K,BX,BY,BZ] u8 at the corners
    ``starts`` [K,3] i32 into the full u8 grids, saturating at 255, in
    scan order (``box_add_inplace``'s contract).  The grids are updated IN
    PLACE on every device and returned: the caller gives them up, as the
    JAX package donates them.  CUDA tensor: the ``boxadd`` kernel; CPU
    tensor: the plain version."""
    if hit_cnt.is_cuda:
        return kernels.boxadd(hit_cnt, miss_cnt, starts, hitc, missc)
    return _apply_box_counts_plain(hit_cnt, miss_cnt, starts, hitc, missc)


def scanline_batch_boxes(cfg: FiestaConfig, points, valid, transforms):
    """Box-local observation contributions of K sensor-frame scans (carve
    included): (starts [K,3] i32, hitc [K,BX,BY,BZ] u8, missc u8,
    n_rays i32, n_endpoints i32)."""
    starts, po_box, seeds, hit_b, epfree_b, rvalid = _scanline_seeds_batch(
        cfg, points, valid, transforms=transforms)
    free = carve_free_mask_batch(cfg, seeds, po_box)
    missc = torch.maximum(hit_b, epfree_b) + free.to(torch.uint8)
    return (starts, hit_b, missc, rvalid.sum(dtype=torch.int32),
            hit_b.sum(dtype=torch.int32) + epfree_b.sum(dtype=torch.int32))


def integrate_scan_scanline_batch(cfg: FiestaConfig, hit_cnt, miss_cnt,
                                  points, valid, transforms) -> ScanResult:
    """K sensor-frame scans integrated with one batched splat and carve
    (global update; same observation semantics as K sequential scans)."""
    starts, hitc, missc, n_rays, n_endpoints = scanline_batch_boxes(
        cfg, points, valid, transforms)
    hit_cnt, miss_cnt = apply_box_counts(hit_cnt, miss_cnt, starts,
                                         hitc, missc)
    return ScanResult(hit_cnt, miss_cnt, n_rays, n_endpoints)
