"""Scanline integration: endpoint splat + octant free-space carve (port of
the batched scanline path of ``fiesta_tpu/ops/raycast.py``).

Per tick, K scans are integrated into sensor-centered carve boxes:

1. per-ray prep (``_scanline_splat_prep``): validity and length gates,
   clipping at max_ray_length, box placement, endpoint or box-exit voxel,
   and ONE packed f32 per ray carrying observation class and range
   (``2000 + range`` for a hit, ``1000 + range`` for a free seed);
2. the splat (``splat_packed``): zero-filled target, scatter-max of the
   packed values, decode into seeds / hit / free-endpoint masks;
3. the carve (``carve_free_mask_batch``): octant wavefront sweeps that
   propagate max observation range from the seeds toward the sensor, then
   the free test;
4. the counter apply: a saturating u8 add of each scan's box into the
   full grid, in scan order, with box corners kept on the device so the
   tick never waits on the host.

Each step has a hand-written CUDA kernel (``kernels/prep.cu``,
``kernels/splat.cu``, ``kernels/carve.cu``, ``kernels/boxadd.cu``); a CPU
tensor takes the plain PyTorch version here.

f32 arithmetic follows the JAX expressions op for op, with tensor
divisors (``grid.f32_scalar``) so that every division is IEEE.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import FiestaConfig
from ..grid import (const_vec, f32_scalar, pos_to_vox, sqrt_f32,
                    vox_in_grid, vox_in_window, vox_to_idx, window_mask)
from ..timing import span
from . import sort


#: endpoint splat order, with the JAX package's switches and values
#: (``fiesta_tpu/ops/raycast.py:83-90``): "direct" splats the rays as
#: produced, "sorted" sorts them by flat index first
#: (``FIESTA_SPLAT_SORT_IMPL=pallas``: the bitonic ``ops.sort.sort_pairs``;
#: any other value, as there: ``torch.sort``).  The seeds are the same
#: either way: the splat's scatter-max commutes.
_SPLAT_ORDER = os.environ.get("FIESTA_SPLAT", "direct")
if _SPLAT_ORDER not in ("direct", "sorted"):
    raise ValueError(f"FIESTA_SPLAT={_SPLAT_ORDER!r}: expected direct|sorted")
_SPLAT_SORT_IMPL = os.environ.get("FIESTA_SPLAT_SORT_IMPL", "lax")


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


def _check_flat_index(k: int, nb: int) -> None:
    """The flat index k*nb + lin_w is int32; past 2^31 it wraps."""
    if k * nb >= 2**31:
        raise ValueError(
            f"flat endpoint splat index overflows int32: {k} scans x "
            f"{nb} box voxels = {k * nb} >= 2^31; reduce scans_per_tick "
            "or the carve box (max_ray_length/resolution)")


@functools.lru_cache(maxsize=64)
def _prep_geometry(cfg: FiestaConfig) -> dict:
    """The ``prep`` kernel's per-config arguments: grid, carve box,
    placement extent min(grid, 2r + 1), alignment, map origin and the ray
    limits."""
    e = 2 * _carve_reach(cfg) + 1
    return dict(grid=cfg.grid_shape, box=_carve_box_shape(cfg),
                extent=tuple(min(g, e) for g in cfg.grid_shape),
                aligned=_aligned_box(cfg), origin=cfg.origin,
                res=cfg.resolution, min_ray=cfg.min_ray_length,
                max_ray=cfg.max_ray_length)


def _scanline_splat_prep(cfg: FiestaConfig, points, valid, origins=None,
                         transforms=None):
    """Per-ray half of the batched splat (ops/raycast.py:775-877): box
    placement, endpoint or box-exit voxel and the packed value per ray.

    points [K,P,3] f32 world-frame, or sensor-frame when ``transforms``
    [K,4,4] is given (origins are then the transforms' translations), or
    the components (px, py, pz), each [K,P] (the depth tick); valid [K,P]
    bool.  Returns (starts [K,3] i32, po_box [K,3] f32,
    lin_flat [K*P] i32 flat target index (K*BX*BY*BZ = dropped),
    val_flat [K*P] f32 packed value, rvalid [K,P] bool).  CUDA tensors:
    the ``prep`` kernel, one launch; CPU tensors: the plain version.
    """
    components = isinstance(points, (tuple, list))
    first = points[0] if components else points
    if not first.is_cuda:
        return _scanline_splat_prep_plain(cfg, points, valid, origins,
                                          transforms)
    geo = _prep_geometry(cfg)
    _check_flat_index(first.shape[0], math.prod(geo["box"]))
    points = (tuple(c.contiguous() for c in points) if components
              else points.contiguous())
    return kernels.prep(
        points, valid.contiguous(),
        None if origins is None else origins.contiguous(),
        None if transforms is None else transforms.contiguous(), **geo)


def _scanline_splat_prep_plain(cfg: FiestaConfig, points, valid,
                               origins=None, transforms=None):
    """``_scanline_splat_prep`` in plain PyTorch ops, on any device."""
    gx, gy, gz = cfg.grid_shape
    bx, by, bz = _carve_box_shape(cfg)
    nb = bx * by * bz
    components = isinstance(points, (tuple, list))
    k = points[0].shape[0] if components else points.shape[0]
    _check_flat_index(k, nb)
    res = cfg.resolution
    dev = points[0].device if components else points.device
    res_t = torch.full((), res, dtype=torch.float32, device=dev)
    mx, my, mz = (float(np.float32(o)) for o in cfg.origin)

    px, py, pz = (points if components
                  else (points[..., j] for j in range(3)))  # [K,P]
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
    length = sqrt_f32(dx * dx + dy * dy + dz * dz)
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
    ulen = sqrt_f32(ux * ux + uy * uy + uz * uz)
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
    scan = torch.arange(k, dtype=torch.int32, device=dev) * nb
    biglin = lin_w + scan[:, None]
    lin_flat = torch.where(rvalid, biglin, k * nb).reshape(-1)
    return starts, po_box, lin_flat, packed_val.reshape(-1), rvalid


def _sort_splat(lin_flat: torch.Tensor, val_flat: torch.Tensor):
    """The sorted splat's reordering (``raycast.py:878-895``): the pairs in
    ascending flat-index order, by the bitonic ``sort_pairs`` (the ``sort``
    kernel on the card) under ``FIESTA_SPLAT_SORT_IMPL=pallas``, else by
    ``torch.sort`` and a gather.  The drop slot K*BX*BY*BZ is the largest
    key, so dropped rays sort last."""
    if _SPLAT_SORT_IMPL == "pallas":
        return sort.sort_pairs(lin_flat, val_flat)
    lin_sorted, order = torch.sort(lin_flat)
    return lin_sorted, val_flat[order]


def _scanline_seeds_batch(cfg: FiestaConfig, points, valid, origins=None,
                          transforms=None):
    """Batched endpoint splat (``_scanline_seeds_batch``,
    ops/raycast.py:757-910): the per-ray prep, then ONE flat splat over
    all K scans, in ray order or (``FIESTA_SPLAT=sorted``) in flat-index
    order; the scatter-max commutes, so both give the same seeds.  Returns
    (starts [K,3] i32, po_box [K,3] f32, seeds [K,BX,BY,BZ] f32, hit_b u8,
    epfree_b u8, rvalid [K,P] bool)."""
    with span("fiesta.integrate.prep"):
        starts, po_box, lin_flat, val_flat, rvalid = _scanline_splat_prep(
            cfg, points, valid, origins, transforms)
    if _SPLAT_ORDER == "sorted":
        lin_flat, val_flat = _sort_splat(lin_flat, val_flat)
    box = (starts.shape[0],) + _carve_box_shape(cfg)
    with span("fiesta.integrate.splat"):
        seeds, hit_b, epfree_b = splat_packed(
            lin_flat, val_flat, math.prod(box), _epfree_threshold(cfg))
    return (starts, po_box, seeds.reshape(box), hit_b.reshape(box),
            epfree_b.reshape(box), rvalid)


def _scanline_seeds(cfg: FiestaConfig, points, valid, origin):
    """Single-scan endpoint splat (K = 1 wrapper, ``raycast.py:913-922``):
    points [R,3] world frame, valid [R], origin [3].  Returns (starts [3],
    po_box [3], seeds [BX,BY,BZ], hit_b, epfree_b, rvalid [R])."""
    out = _scanline_seeds_batch(cfg, points[None], valid[None], origin[None])
    return tuple(a[0] for a in out)


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


def carve_free_mask(cfg: FiestaConfig, seeds: torch.Tensor,
                    po: torch.Tensor) -> torch.Tensor:
    """One scan's carve (K = 1 wrapper, ``raycast.py:300-314``): seeds
    [BX,BY,BZ] f32, po [3] f32 -> free mask [BX,BY,BZ]."""
    return carve_free_mask_batch(cfg, seeds[None], po[None])[0]


def _apply_box_counts_plain(hit_cnt, miss_cnt, starts, hitc, missc):
    """Plain version of the counter apply: one saturating u8 add per scan,
    in scan order (the JAX ``rmw`` mode), into the given grids in place.
    Box voxels outside the grids are skipped (the sharded engine's boxes
    reach past its slabs).  Returns (hit_cnt, miss_cnt), the tensors it
    was given."""
    grid = hit_cnt.shape
    gy, gz = grid[1:]
    box = hitc.shape[1:]
    dev = hit_cnt.device
    ax = [torch.arange(n, device=dev) for n in box]
    st = starts.to(torch.int64)
    hit_flat, miss_flat = hit_cnt.view(-1), miss_cnt.view(-1)
    for i in range(starts.shape[0]):
        c = [a + st[i, j] for j, a in enumerate(ax)]
        ok = [(v >= 0) & (v < g) for v, g in zip(c, grid)]
        inside = (ok[0][:, None, None] & ok[1][None, :, None]
                  & ok[2][None, None, :]).reshape(-1)
        idx = (c[0][:, None, None] * (gy * gz) + c[1][None, :, None] * gz
               + c[2][None, None, :]).reshape(-1)[inside]
        for flat, inc in ((hit_flat, hitc[i]), (miss_flat, missc[i])):
            reg = flat[idx].to(torch.int32) + inc.reshape(-1)[inside].to(
                torch.int32)
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


def _box_window_mask(cfg: FiestaConfig, starts, window, box_shape):
    """The window in carve-box coordinates (``raycast.py:925-938``):
    starts [..., 3] i32 -> bool [..., BX, BY, BZ]."""
    wmin, wmax = window
    dev = starts.device

    def axis_ok(n_, j):
        c = torch.arange(n_, dtype=torch.int32, device=dev) + starts[..., j,
                                                                      None]
        return (c >= wmin[j]) & (c <= wmax[j])

    bx, by, bz = box_shape
    return (axis_ok(bx, 0)[..., :, None, None]
            & axis_ok(by, 1)[..., None, :, None]
            & axis_ok(bz, 2)[..., None, None, :])


def scanline_batch_boxes(cfg: FiestaConfig, points, valid, transforms=None,
                         origins=None, window=None):
    """Box-local observation contributions of K scans (carve included,
    ``raycast.py:1036-1073``): (starts [K,3] i32, hitc [K,BX,BY,BZ] u8,
    missc u8, n_rays i32, n_endpoints i32).  Sensor-frame points with
    ``transforms`` [K,4,4], or world-frame points with ``origins`` [K,3].
    ``window`` (wmin [3] i32, wmax [3] i32, inclusive) gates which
    counters change; the carve geometry ignores it."""
    starts, po_box, seeds, hit_b, epfree_b, rvalid = _scanline_seeds_batch(
        cfg, points, valid, origins, transforms)
    with span("fiesta.integrate.carve"):
        if window is not None:
            wmask_b = _box_window_mask(cfg, starts, window,
                                       _carve_box_shape(cfg))
            zero = torch.zeros((), dtype=torch.uint8, device=hit_b.device)
            hit_b = torch.where(wmask_b, hit_b, zero)
            epfree_b = torch.where(wmask_b, epfree_b, zero)
        free = carve_free_mask_batch(cfg, seeds, po_box)
        if window is not None:
            free = free & wmask_b
    missc = torch.maximum(hit_b, epfree_b) + free.to(torch.uint8)
    return (starts, hit_b, missc, rvalid.sum(dtype=torch.int32),
            hit_b.sum(dtype=torch.int32) + epfree_b.sum(dtype=torch.int32))


def integrate_scan_scanline_batch(cfg: FiestaConfig, hit_cnt, miss_cnt,
                                  points, valid, transforms,
                                  window=None) -> ScanResult:
    """K sensor-frame scans integrated with one batched splat and carve
    (same observation semantics as K sequential scans); ``window`` as in
    ``scanline_batch_boxes``."""
    starts, hitc, missc, n_rays, n_endpoints = scanline_batch_boxes(
        cfg, points, valid, transforms, window=window)
    with span("fiesta.integrate.boxadd"):
        hit_cnt, miss_cnt = apply_box_counts(hit_cnt, miss_cnt, starts,
                                             hitc, missc)
    return ScanResult(hit_cnt, miss_cnt, n_rays, n_endpoints)


def integrate_scan_scanline(cfg: FiestaConfig, hit_cnt, miss_cnt, points,
                            valid, origin, window=None) -> ScanResult:
    """One world-frame scan (points [R,3] f32, valid [R] bool, origin [3]
    f32) integrated by octant shadow-casting (``raycast.py:1076-1129``):
    the batched splat, carve and box add with K = 1 (the box add is the
    JAX package's dynamic-slice saturating add at the same corner).  The
    counters are added to in place and returned."""
    starts, hitc, missc, n_rays, n_endpoints = scanline_batch_boxes(
        cfg, points[None], valid[None], origins=origin[None], window=window)
    hit_cnt, miss_cnt = apply_box_counts(hit_cnt, miss_cnt, starts,
                                         hitc, missc)
    return ScanResult(hit_cnt, miss_cnt, n_rays, n_endpoints)


# ---------------------------------------------------------------------------
# Single-scan helpers shared by the DDA and projective integrators
# (ops/raycast.py:110-166)
# ---------------------------------------------------------------------------


def _sumsq3(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis of [..., 3], as (x^2 + y^2) + z^2."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return x * x + y * y + z * z


def _norm3(d: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of [..., 3] with a correctly
    rounded sqrt (``jnp.linalg.norm``)."""
    return sqrt_f32(_sumsq3(d))


def _prep_rays(cfg: FiestaConfig, points, valid, origin):
    """Length gating and max-ray clipping (``raycast.py:110-121``,
    RaycastProcess, Fiesta.h:208-215): returns (clipped [R,3], valid [R],
    is_hit [R])."""
    valid = valid & torch.all(torch.isfinite(points), dim=-1)
    delta = points - origin
    length = _norm3(delta)
    valid = valid & (length >= cfg.min_ray_length)
    is_hit = length <= cfg.max_ray_length
    scale = torch.where(
        is_hit, 1.0,
        f32_scalar(cfg.max_ray_length, length) / torch.clamp(length, min=1e-9))
    clipped = origin + delta * scale[..., None]
    return clipped, valid, is_hit


def _mark(n: int, lin: torch.Tensor, device) -> torch.Tensor:
    """u8 [n] mask with 1 at the indices ``lin`` (values >= n dropped into
    a spare slot): the scatter-max of the constant 1 (``.at[].max(1,
    mode="drop")``), as an index fill of 1 (a fill takes the value as a
    kernel argument, where an index write would copy it to the device)."""
    m = torch.zeros(n + 1, dtype=torch.uint8, device=device)
    return m.index_fill_(0, torch.clamp(lin, max=n).long(), 1)[:n]


def _endpoint_masks(cfg: FiestaConfig, clipped, valid, is_hit, win):
    """Endpoint observations as dedup masks, hit winning ties
    (``raycast.py:124-146``): returns (hit_m, epfree_m) u8 grids."""
    gx, gy, gz = cfg.grid_shape
    vox = pos_to_vox(cfg, clipped)
    in_grid = vox_in_grid(cfg, vox)
    if win is not None:
        in_grid = in_grid & vox_in_window(vox, win[0], win[1])
    lin = vox_to_idx(cfg, vox)
    n = gx * gy * gz
    drop = torch.full_like(lin, n)
    hit_m = _mark(n, torch.where(valid & is_hit & in_grid, lin, drop),
                  clipped.device)
    epfree_m = _mark(n, torch.where(valid & ~is_hit & in_grid, lin, drop),
                     clipped.device)
    epfree_m = torch.where(hit_m > 0, torch.zeros_like(epfree_m), epfree_m)
    return hit_m.reshape(cfg.grid_shape), epfree_m.reshape(cfg.grid_shape)


def _sat_add_u8(cnt, inc):
    """Saturating u8 add (``raycast.py:149-156``): counters pin at 255."""
    inc = inc.to(cnt.dtype)
    return torch.where(cnt > 255 - inc, torch.full_like(cnt, 255), cnt + inc)


def _apply_counts(hit_cnt, miss_cnt, hit_m, epfree_m, pathfree_m):
    """Full-grid counter apply (``raycast.py:159-166``)."""
    dt = hit_cnt.dtype
    hit_d, ep_d, path_d = (m.to(dt) for m in (hit_m, epfree_m, pathfree_m))
    return (_sat_add_u8(hit_cnt, hit_d),
            _sat_add_u8(miss_cnt, torch.maximum(hit_d, ep_d) + path_d))


def _scan_counts(rvalid, hit_m, epfree_m):
    """(num_rays, num_endpoints) of one scan, i32."""
    return (rvalid.sum(dtype=torch.int32),
            hit_m.sum(dtype=torch.int32) + epfree_m.sum(dtype=torch.int32))


# ---------------------------------------------------------------------------
# Exact batched DDA (Amanatides-Woo, ops/raycast.py:174-287)
# ---------------------------------------------------------------------------


def _intbound(s, ds):
    """Smallest positive t with s + t*ds integral (raycast.cpp:14-23); the
    fraction is a floor modulo, as Python's ``%``."""
    s_ = torch.where(ds < 0, -s, s)
    ds_ = torch.abs(ds)
    frac = torch.remainder(s_, 1.0)
    return torch.where(ds_ == 0, float("inf"), (1.0 - frac) / ds_)


def integrate_scan_dda(cfg: FiestaConfig, hit_cnt, miss_cnt, points, valid,
                       origin, window=None) -> ScanResult:
    """Exact per-ray DDA integration (``raycast.py:182-287``): every ray
    advances in lock-step for ``cfg.ray_steps`` steps (all of them: no
    early exit, so nothing is read back to the host), marking each emitted
    voxel free once a later voxel is emitted on its ray.  points [R,3]
    world frame, valid [R], origin [3]; ``window`` (wmin, wmax) inclusive.
    Returns new counter grids."""
    res = cfg.resolution
    gx, gy, gz = cfg.grid_shape
    n = gx * gy * gz
    dev = points.device
    res_t = f32_scalar(res, points)
    map_origin = const_vec(cfg.origin, torch.float32, points)

    clipped, rvalid, is_hit = _prep_rays(cfg, points, valid, origin)
    hit_m, epfree_m = _endpoint_masks(cfg, clipped, rvalid, is_hit, window)

    start = origin / res_t                                   # [3]
    end = clipped / res_t                                    # [R,3]
    v0 = torch.floor(start).to(torch.int32)
    ev = torch.floor(end).to(torch.int32)
    d = (ev - v0[None]).to(torch.float32)
    step = torch.sign(d).to(torch.int32)
    t_max0 = _intbound(start[None], d)
    t_delta = torch.where(d == 0, float("inf"), step.to(torch.float32) / d)
    max_dist2 = _sumsq3(end - start[None])

    aabb_min = map_origin / res_t
    aabb_max = (map_origin + const_vec(cfg.map_size, torch.float32, points)
                ) / res_t
    alive = rvalid & ~torch.all(step == 0, dim=-1)
    min2 = cfg.min_ray_length ** 2
    max2 = cfg.max_ray_length ** 2

    v = v0[None].expand_as(ev).clone()
    tm = t_max0
    prev_lin = torch.full(ev.shape[:-1], n, dtype=torch.int32, device=dev)
    drop = torch.full_like(prev_lin, n)
    free_flat = torch.zeros(n + 1, dtype=torch.uint8, device=dev)
    for _ in range(cfg.ray_steps):
        vf = v.to(torch.float32)
        in_aabb = torch.all((vf >= aabb_min) & (vf < aabb_max), dim=-1)
        over = in_aabb & (_sumsq3(vf - start[None]) > max_dist2)
        at_end = torch.all(v == ev, dim=-1)
        center = (vf + 0.5) * res
        clen2 = _sumsq3(center - origin[None])
        gate = (clen2 >= min2) & (clen2 <= max2)
        mv = pos_to_vox(cfg, center)
        in_grid = vox_in_grid(cfg, mv)
        if window is not None:
            in_grid = in_grid & vox_in_window(mv, window[0], window[1])
        # the reference frees every emitted voxel but the last: a voxel is
        # marked once a later voxel is emitted on its ray
        emitted = alive & in_aabb
        free_flat.index_fill_(0, torch.where(emitted, prev_lin, drop).long(),
                              1)
        lin = vox_to_idx(cfg, mv)
        prev_lin = torch.where(
            emitted, torch.where(gate & in_grid, lin, drop), prev_lin)
        alive = alive & ~at_end & ~over
        tmx, tmy, tmz = tm[..., 0], tm[..., 1], tm[..., 2]
        take_x = (tmx < tmy) & (tmx < tmz)
        take_y = (tmx >= tmy) & (tmy < tmz)
        take_z = ~take_x & ~take_y
        adv = torch.stack([take_x, take_y, take_z], dim=-1) & alive[..., None]
        v = v + torch.where(adv, step, 0)
        tm = tm + torch.where(adv, t_delta, 0.0)
    pathfree_m = free_flat[:n].reshape(cfg.grid_shape)

    hit_cnt, miss_cnt = _apply_counts(hit_cnt, miss_cnt, hit_m, epfree_m,
                                      pathfree_m)
    return ScanResult(hit_cnt, miss_cnt, *_scan_counts(rvalid, hit_m,
                                                       epfree_m))


# ---------------------------------------------------------------------------
# Projective (depth-panorama) carving (ops/raycast.py:1132-1253)
# ---------------------------------------------------------------------------


def _spherical_coords(delta, az_bins: int, el_bins: int):
    """Direction vectors [..., 3] -> (range, az index, el index)."""
    r = _norm3(delta)
    az = torch.atan2(delta[..., 1], delta[..., 0])
    el = torch.asin(torch.clamp(
        delta[..., 2] / torch.clamp(r, min=1e-9), -1.0, 1.0))
    two_pi = f32_scalar(2 * math.pi, delta)
    pi = f32_scalar(math.pi, delta)
    ai = torch.clamp(torch.floor((az / two_pi + 0.5) * az_bins
                                 ).to(torch.int32), 0, az_bins - 1)
    ei = torch.clamp(torch.floor((el / pi + 0.5) * el_bins
                                 ).to(torch.int32), 0, el_bins - 1)
    return r, ai, ei


def integrate_scan_projective(cfg: FiestaConfig, hit_cnt, miss_cnt, points,
                              valid, origin, window=None, az_bins: int = 1024,
                              el_bins: int = 512, levels: int = 7
                              ) -> ScanResult:
    """Depth-panorama free-space carving with a max-depth mip pyramid
    (``raycast.py:1148-1253``): the scan's ranges are scatter-maxed into an
    az x el panorama, and every voxel reads the max depth of its angular
    footprint from the pyramid level whose bin matches it; a voxel is free
    when it lies within the ray gates and a voxel closer than that depth.
    points [R,3] world frame, valid [R], origin [3]."""
    dev = points.device
    clipped, rvalid, is_hit = _prep_rays(cfg, points, valid, origin)
    hit_m, epfree_m = _endpoint_masks(cfg, clipped, rvalid, is_hit, window)

    # 1) scatter-max the scan into the panorama (farthest evidence per
    #    direction; unclipped ranges, so long rays carve to max range)
    delta = points - origin
    r, ai, ei = _spherical_coords(delta, az_bins, el_bins)
    n_pix = az_bins * el_bins
    pix = torch.where(rvalid, ai * el_bins + ei,
                      torch.full_like(ai, n_pix)).long()
    pano = torch.full((n_pix + 1,), -float("inf"), dtype=torch.float32,
                      device=dev)
    pano.scatter_reduce_(
        0, pix, torch.minimum(r, f32_scalar(
            cfg.max_ray_length + cfg.resolution, r)), reduce="amax")
    pano = pano[:n_pix].reshape(az_bins, el_bins)

    # 2) the max-mip pyramid, flattened with per-level offsets
    levels = min(levels, int(math.log2(az_bins & -az_bins)),
                 int(math.log2(el_bins & -el_bins)))
    pyramid = [pano]
    for _ in range(levels - 1):
        p = pyramid[-1]
        a, e = p.shape
        pyramid.append(p.reshape(a // 2, 2, e // 2, 2).amax(dim=(1, 3)))
    flat = torch.cat([p.reshape(-1) for p in pyramid])
    offsets = np.concatenate(
        [[0], np.cumsum([p.numel() for p in pyramid])[:-1]]).astype(np.int64)

    # 3) every voxel gathers its footprint's max depth from its mip level
    gx, gy, gz = cfg.grid_shape
    res = cfg.resolution
    axes = []
    for g, o, c in zip((gx, gy, gz), cfg.origin, origin.unbind(0)):
        centers = ((torch.arange(g, dtype=torch.float32, device=dev) + 0.5)
                   * res + f32_scalar(o, origin))
        axes.append(centers - c)
    dvox = torch.stack(torch.broadcast_tensors(
        axes[0][:, None, None], axes[1][None, :, None],
        axes[2][None, None, :]), dim=-1)
    rv, vai, vei = _spherical_coords(dvox, az_bins, el_bins)

    base_ang = f32_scalar(2 * math.pi / az_bins, rv)
    foot = f32_scalar(res, rv) / torch.clamp(rv, min=res)
    lvl = torch.clamp(torch.ceil(torch.log2(torch.clamp(
        foot / base_ang, min=1.0))).to(torch.int32), 0, levels - 1)
    el_l = el_bins >> lvl          # the level's el extent
    idx = (const_vec(offsets.tolist(), torch.int64, rv)[lvl.long()]
           + ((vai >> lvl) * el_l + (vei >> lvl)).long())
    depth = flat[idx.reshape(-1)].reshape(cfg.grid_shape)

    free = ((rv >= cfg.min_ray_length) & (rv <= cfg.max_ray_length)
            & (rv < depth - res))     # -inf depth: unobserved, never free
    if window is not None:
        free = free & window_mask(cfg, window[0], window[1])

    hit_cnt, miss_cnt = _apply_counts(hit_cnt, miss_cnt, hit_m, epfree_m,
                                      free.to(torch.uint8))
    return ScanResult(hit_cnt, miss_cnt, *_scan_counts(rvalid, hit_m,
                                                       epfree_m))
