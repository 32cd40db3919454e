"""Visualization extraction (port of ``fiesta_tpu/viz.py``, reference
component C16): so far the occupied-voxel point cloud (GetPointCloud,
src/ESDFMap.cpp:544-582), which the scrolling engine's
``occupied_world_points`` serves.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import FiestaConfig
from .grid import MapState, occupied_grid, vox_to_pos


def occupied_pointcloud(
    cfg: FiestaConfig,
    state: MapState,
    vis_lower_bound: Optional[float] = None,
    vis_upper_bound: Optional[float] = None,
) -> np.ndarray:
    """World positions [N,3] f32 of occupied voxel centres, z-clipped to
    the visualization bounds (voxel indices relative to the grid origin,
    ESDFMap.cpp:564-579).  ``fiesta_tpu``'s window gate comes with the
    callers that pass one (A13)."""
    occ = occupied_grid(cfg, state.logodds).cpu().numpy()
    lo = cfg.vis_lower_bound if vis_lower_bound is None else vis_lower_bound
    hi = cfg.vis_upper_bound if vis_upper_bound is None else vis_upper_bound
    zlo = int(np.floor(lo / cfg.resolution))
    zhi = int(np.floor(hi / cfg.resolution))
    z = np.arange(cfg.grid_shape[2])
    occ &= ((z >= zlo) & (z <= zhi))[None, None, :]
    vox = torch.from_numpy(np.argwhere(occ).astype(np.int32))
    return vox_to_pos(cfg, vox).numpy()
