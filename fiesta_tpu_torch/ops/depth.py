"""Depth image -> point cloud with temporal consistency filtering (port of
``fiesta_tpu/ops/depth.py``, reference components C12/C13,
include/Fiesta.h:318-382).

Pinhole back-projection of an [H,W] f32 depth image (meters) and the
optional consistency filter: each point is reprojected into the previous
frame through last_T^-1 @ T and kept only where the previous depth at the
nearest pixel agrees within ``depth_filter_tolerance``, after the margin
crop and the [min, max] depth gates.  CUDA tensors take the ``depth``
kernel (``kernels/depth.cu``: every frame of a tick in one launch); CPU
tensors the plain PyTorch version, in the JAX package's component form and
op order, whose divisions take tensor divisors (``grid.f32_scalar``) so
that they are IEEE divisions.  The two agree bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from ..config import FiestaConfig
from ..grid import f32_scalar
from ..io.replay import pose_to_matrix  # noqa: F401  (depth.py:133)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 fused multiply-add a * b + c, rounded once: the product is exact
    in f64 and the f64 sum rounds to the f32 result (a second rounding can
    differ from the single one only when the f64 sum lands on an f32
    rounding midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def sensor_to_world(points: torch.Tensor,
                    transform: torch.Tensor) -> torch.Tensor:
    """``points @ transform[:3, :3].T + transform[:3, 3]`` for points
    [P, 3] f32, summed as the JAX package's CPU dot sums this [P,3] x [3,3]
    product when run op by op (``fiesta_tpu/pipeline.py:96-99``): rows 0
    and 1 of the rotation as (p0 r0 + p1 r1) + p2 r2, row 2 as the fused
    chain fma(p2, r2, fma(p1, r1, p0 r0)) (ROADMAP C); then + t."""
    r, t = transform[:3, :3], transform[:3, 3]
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    cols = [px * r[i, 0] + py * r[i, 1] + pz * r[i, 2] for i in (0, 1)]
    cols.append(_fma(pz, r[2, 2], _fma(py, r[2, 1], px * r[2, 0])))
    return torch.stack(cols, dim=-1) + t


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 @ b for a square [n, n] and b [n, m] by Gaussian elimination
    with partial pivoting, in tensor operations only (no host
    synchronisation on the card).  The JAX package solves through LAPACK
    (getrf + getrs); the two agree to rounding (ROADMAP C)."""
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


def _depth_kernel(cfg: FiestaConfig, depths, transforms, prev_depth,
                  prev_transform, use_filter: bool):
    """The ``depth`` kernel on K frames [K,H,W]: (px, py, pz, valid), each
    [K, H*W], pz a view of ``depths``."""
    contig = [None if t is None else t.contiguous()
              for t in (depths, transforms, prev_depth, prev_transform)]
    px, py, valid = kernels.depth(
        *contig, cx=cfg.center_x, cy=cfg.center_y, fx=cfg.focal_x,
        fy=cfg.focal_y, min_dist=cfg.depth_filter_min_dist,
        max_dist=cfg.depth_filter_max_dist, tol=cfg.depth_filter_tolerance,
        use_filter=use_filter, margin=cfg.depth_filter_margin)
    return px, py, contig[0].reshape(depths.shape[0], -1), valid


def depth_tick_components(cfg: FiestaConfig, depths: torch.Tensor,
                          transforms: torch.Tensor, prev_depth: torch.Tensor,
                          prev_transform: torch.Tensor, use_filter: bool):
    """The K depth frames of a tick [K,H,W] f32 with camera-to-world
    transforms [K,4,4], each filtered against its predecessor (frame 0
    against ``prev_depth`` [H,W] / ``prev_transform`` [4,4]): returns
    (px, py, pz, valid), each [K, H*W].  CUDA tensors: the ``depth``
    kernel, one launch, with pz a view of ``depths``; CPU:
    ``_depth_tick_plain``."""
    fn = _depth_kernel if depths.is_cuda else _depth_tick_plain
    return fn(cfg, depths, transforms, prev_depth, prev_transform,
              use_filter)


def _depth_tick_plain(cfg: FiestaConfig, depths, transforms, prev_depth,
                      prev_transform, use_filter: bool):
    """``depth_tick_components`` in plain PyTorch ops, on any device: the
    frames one by one through ``_components_plain``, stacked."""
    xs, ys, zs, vals = [], [], [], []
    ld, lt = prev_depth, prev_transform
    for i in range(depths.shape[0]):
        x, y, z, v = _components_plain(cfg, depths[i], transforms[i], lt, ld,
                                       use_filter)
        xs.append(x.reshape(-1))
        ys.append(y.reshape(-1))
        zs.append(z.reshape(-1))
        vals.append(v.reshape(-1))
        ld, lt = depths[i], transforms[i]
    return torch.stack(xs), torch.stack(ys), torch.stack(zs), \
        torch.stack(vals)


def depth_to_cloud_components(
    cfg: FiestaConfig,
    depth: torch.Tensor,
    transform: Optional[torch.Tensor] = None,
    last_transform: Optional[torch.Tensor] = None,
    last_depth: Optional[torch.Tensor] = None,
    use_filter: bool = False,
):
    """Back-projection and consistency filter in component form
    (``depth.py:34-90``): returns (px, py, pz, valid), each [H,W], camera
    frame.  ``transform`` / ``last_transform`` [4,4] f32 camera-to-world
    and ``last_depth`` [H,W] are needed with ``use_filter``.  CUDA
    tensors: the ``depth`` kernel with K = 1; CPU: ``_components_plain``."""
    if not depth.is_cuda:
        return _components_plain(cfg, depth, transform, last_transform,
                                 last_depth, use_filter)
    h, w = depth.shape
    one = None if transform is None else transform[None]
    return tuple(c.reshape(h, w) for c in _depth_kernel(
        cfg, depth[None], one, last_depth, last_transform, use_filter))


def _components_plain(cfg: FiestaConfig, depth: torch.Tensor, transform,
                      last_transform, last_depth, use_filter: bool):
    """``depth_to_cloud_components`` in plain PyTorch ops, on any device
    (the ``depth`` kernel's reference)."""
    h, w = depth.shape
    dev = depth.device
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]

    x = (u - cfg.center_x) * depth / f32_scalar(cfg.focal_x, depth)
    y = (v - cfg.center_y) * depth / f32_scalar(cfg.focal_y, depth)

    valid = torch.isfinite(depth)
    if use_filter:
        m = cfg.depth_filter_margin
        if m > 0:
            um = (u >= m) & (u < w - m)
            vm = (v >= m) & (v < h - m)
            valid = valid & (um & vm)
        valid = valid & (depth >= cfg.depth_filter_min_dist)
        valid = valid & (depth <= cfg.depth_filter_max_dist)

        rel = _solve(last_transform, transform)       # last_T^-1 @ T
        c0 = rel[0, 0] * x + rel[0, 1] * y + rel[0, 2] * depth + rel[0, 3]
        c1 = rel[1, 0] * x + rel[1, 1] * y + rel[1, 2] * depth + rel[1, 3]
        c2 = rel[2, 0] * x + rel[2, 1] * y + rel[2, 2] * depth + rel[2, 3]
        c3 = rel[3, 0] * x + rel[3, 1] * y + rel[3, 2] * depth + rel[3, 3]
        cz = c2 / c3
        uu = (c0 / c3) * cfg.focal_x / cz + cfg.center_x
        vv = (c1 / c3) * cfg.focal_y / cz + cfg.center_y

        in_img = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
        # truncation toward zero, as astype(int32); where in_img is False
        # the pixel is dropped whatever it reads
        ui = torch.clamp(uu.to(torch.int32), 0, w - 1).long()
        vi = torch.clamp(vv.to(torch.int32), 0, h - 1).long()
        prev = last_depth[vi, ui]                      # nearest pixel
        agree = torch.abs(prev - cz) < cfg.depth_filter_tolerance
        valid = valid & in_img & agree

    return x, y, depth, valid


def depth_to_cloud(
    cfg: FiestaConfig,
    depth: torch.Tensor,
    transform: Optional[torch.Tensor] = None,
    last_transform: Optional[torch.Tensor] = None,
    last_depth: Optional[torch.Tensor] = None,
    use_filter: bool = False,
):
    """Back-project a depth image [H,W] to a camera-frame cloud: returns
    (points [H*W, 3] f32, valid [H*W] bool) (``depth.py:93-118``)."""
    x, y, z, valid = depth_to_cloud_components(
        cfg, depth, transform, last_transform, last_depth, use_filter)
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3), valid.reshape(-1)


def transform_cloud(cfg: FiestaConfig, points: torch.Tensor,
                    transform: torch.Tensor) -> torch.Tensor:
    """Sensor-frame points [N,3] -> world frame through a [4,4] transform
    (``depth.py:121-130``)."""
    del cfg
    return sensor_to_world(points, transform)
