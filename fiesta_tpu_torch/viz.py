"""Visualization extraction (port of ``fiesta_tpu/viz.py``, reference
component C16).

Reference: GetPointCloud (src/ESDFMap.cpp:544-582), GetSliceMarker +
RainbowColorMap (src/ESDFMap.cpp:584-699), published as ROS messages
(Fiesta.h:143-159).  Without ROS/rviz, the equivalents here produce numpy
arrays (occupied-voxel positions, colored distance slices) that the app
dumps to .npz/.png.  Device tensors are read on the host through
``.cpu().numpy()``; a slice is cut on the device first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import FiestaConfig
from .grid import INF_D2, MapState, occupied_grid, vox_to_pos


def _positions(cfg: FiestaConfig, vox: np.ndarray) -> np.ndarray:
    """World positions [N,3] f32 of voxel centres (int32 voxels, as the
    JAX package's ``jnp.asarray`` of the indices gives)."""
    return vox_to_pos(cfg, torch.from_numpy(vox.astype(np.int32))).numpy()


def occupied_pointcloud(
    cfg: FiestaConfig,
    state: MapState,
    vis_lower_bound: Optional[float] = None,
    vis_upper_bound: Optional[float] = None,
    window: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> np.ndarray:
    """World positions [N,3] f32 of occupied voxel centres, z-clipped to
    the visualization bounds (voxel indices relative to the grid origin,
    ESDFMap.cpp:564-579); ``window`` (inclusive voxel min, max) gates all
    three axes, as the reference iterates min..max_vec
    (ESDFMap.cpp:566-568)."""
    occ = occupied_grid(cfg, state.logodds).cpu().numpy()
    lo = cfg.vis_lower_bound if vis_lower_bound is None else vis_lower_bound
    hi = cfg.vis_upper_bound if vis_upper_bound is None else vis_upper_bound
    zlo = int(np.floor(lo / cfg.resolution))
    zhi = int(np.floor(hi / cfg.resolution))
    z = np.arange(cfg.grid_shape[2])
    occ &= ((z >= zlo) & (z <= zhi))[None, None, :]
    if window is not None:
        wmin, wmax = window
        for ax in range(3):
            idx = np.arange(cfg.grid_shape[ax])
            m = (idx >= wmin[ax]) & (idx <= wmax[ax])
            occ &= m.reshape([-1 if a == ax else 1 for a in range(3)])
    return _positions(cfg, np.argwhere(occ))


def rainbow_color_map(h: np.ndarray) -> np.ndarray:
    """HSV-blend rainbow colormap, vectorized (RainbowColorMap,
    ESDFMap.cpp:584-637): maps [0,1] -> RGB in [0,1].

    h=1.0 wraps to pure red (same as h=0), as in the reference, which
    passes exactly 1 for saturated distances (ESDFMap.cpp:674) and does
    ``h -= floor(h)``."""
    h = np.asarray(h, np.float64)
    h = h - np.floor(h)
    h = h * 6.0
    i = np.floor(h).astype(np.int64)
    f = h - i
    f = np.where(i % 2 == 0, 1.0 - f, f)
    n = 1.0 - f  # s=v=1 so m=0, n=1-s*f
    one = np.ones_like(n)
    zero = np.zeros_like(n)
    # per-sextant (r,g,b)
    tables = [
        (one, n, zero),   # 0
        (n, one, zero),   # 1
        (zero, one, n),   # 2
        (zero, n, one),   # 3
        (n, zero, one),   # 4
        (one, zero, n),   # 5
    ]
    r = np.choose(i % 6, [t[0] for t in tables])
    g = np.choose(i % 6, [t[1] for t in tables])
    b = np.choose(i % 6, [t[2] for t in tables])
    return np.stack([r, g, b], axis=-1)


def slice_marker(
    cfg: FiestaConfig,
    state: MapState,
    slice_z: Optional[float] = None,
    max_dist: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Colored ESDF z-slice (GetSliceMarker, ESDFMap.cpp:639-699).

    Returns (positions [N,3], colors [N,3]) for voxels in the slice with a
    known finite distance; colors follow the reference's rainbow map of
    ``distance / max_dist`` clamped at 1.
    """
    z, md, dist, known = _slice_fields(cfg, state, slice_z, max_dist)
    xy = np.argwhere(known)
    vox = np.concatenate([xy, np.full((len(xy), 1), z)], axis=1)
    d = dist[known]
    colors = rainbow_color_map(np.where(d <= md, d / md, 1.0))
    return _positions(cfg, vox), colors


def slice_image(
    cfg: FiestaConfig, state: MapState, slice_z: Optional[float] = None,
    max_dist: Optional[float] = None,
) -> np.ndarray:
    """Full [X,Y,3] RGB image of a distance slice (unknown voxels black)."""
    _z, md, dist, known = _slice_fields(cfg, state, slice_z, max_dist)
    img = rainbow_color_map(np.where(dist <= md, dist / md, 1.0))
    img[~known] = 0.0
    return img


def performance_text(last_update_ms: Optional[float] = None,
                     tag: str = "UpdateESDF") -> str:
    """The reference's floating performance text marker (Fiesta.h:161-188
    renders it; Fiesta.h:524-529 composes this string: current and
    average update time), from the port's timing registry: the device
    seconds of the work under ``tag`` where its timer recorded them, else
    the host's."""
    from .timing import Timing

    mean_s = Timing.get_mean_device_seconds(tag)
    if mean_s is None:
        mean_s = Timing.get_mean_seconds(tag)
    mean_ms = mean_s * 1e3
    if last_update_ms is None:
        last_update_ms = mean_ms
    return (f"Fiesta\nCurrent update Time\n{last_update_ms:.3f} ms\n"
            f"Average update Time\n{mean_ms:.3f} ms")


def slice_index(cfg: FiestaConfig, slice_z: Optional[float] = None) -> int:
    """Z voxel index of the visualization slice (cfg.slice_vis_level)."""
    z_m = cfg.slice_vis_level if slice_z is None else slice_z
    return int(np.clip(int(np.floor(z_m / cfg.resolution)), 0,
                       cfg.grid_shape[2] - 1))


def _slice_fields(cfg, state, slice_z, max_dist):
    """(z, max_dist, dist[X,Y], known[X,Y]) for one z-slice, cut from d2
    and seen on the device before the host copy (one plane, not the
    grid)."""
    md = cfg.slice_vis_max_dist if max_dist is None else max_dist
    z = slice_index(cfg, slice_z)
    d2 = state.d2[:, :, z].cpu().numpy()
    seen = state.seen[:, :, z].cpu().numpy().astype(bool)
    known = seen & (d2 < int(INF_D2))
    dist = np.where(known, np.sqrt(d2.astype(np.float64)) * cfg.resolution,
                    cfg.infinity_distance)
    return z, md, dist, known
