"""Unbounded-world mapping via a scrolling grid (port of
``fiesta_tpu/scrolling.py``, reference component C3).

The reference's unbounded-world mode is a spatial-hash block map
(``#ifdef HASH_TABLE``, src/ESDFMap.cpp:128-167, 704-783).  Here, as in the
JAX package, it is a scrolling dense grid: a fixed device-resident box that
recenters around the robot, shifting surviving content and resetting the
region that enters; with a ``TileArchive`` the evicted strips go to a host
tile directory and come back when the robot returns.

Coordinates: the grid covers the world box ``cfg.origin + origin_vox *
resolution`` to ``+ map_size``.  Every op works in the fixed virtual frame
anchored at ``cfg.origin``; world-frame inputs and outputs shift by
``origin_vox * resolution``.  Shifts are host integer vectors, so a scroll
slices with Python integers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .archive import TileArchive
from .config import FiestaConfig
from .grid import INF_D2, UNDEFINED_COORD, Device, MapState, occupied_grid
from .ops import esdf
from .pipeline import FiestaPipeline, esdf_update, tick_rebuild_esdf
from .viz import occupied_pointcloud


def _shift_fill(arr: torch.Tensor, shift, fill) -> torch.Tensor:
    """Shift the last 3 dims of ``arr`` by -shift voxels: out[v] =
    arr[v + shift] where that lies in the grid, else ``fill`` (the space
    entering the grid)."""
    out = torch.full_like(arr, fill)
    dst, src = [], []
    for s, n in zip((int(s) for s in shift), arr.shape[-3:]):
        if abs(s) >= n:
            return out
        dst.append(slice(0, n - s) if s >= 0 else slice(-s, n))
        src.append(slice(s, n) if s >= 0 else slice(0, n + s))
    out[(...,) + tuple(dst)] = arr[(...,) + tuple(src)]
    return out


def scroll_state(state: MapState, shift) -> MapState:
    """Recenter the map by ``shift`` voxels (a host int [3]): content
    moves, the region entering the grid resets to unknown, and closest
    coordinates (packed int32 or [3,X,Y,Z] int16 planes) are re-based by
    -shift; a voxel whose closest obstacle leaves the grid loses it and
    its distance (``scrolling.py:55-94``)."""
    sx, sy, sz = (int(s) for s in shift)
    gx, gy, gz = state.d2.shape
    logodds = _shift_fill(state.logodds, shift, 0.0)
    d2 = _shift_fill(state.d2, shift, INF_D2)
    seen = _shift_fill(state.seen, shift, 0)
    hit_cnt = _shift_fill(state.hit_cnt, shift, 0)
    miss_cnt = _shift_fill(state.miss_cnt, shift, 0)
    if state.closest.dim() == 3:     # packed x<<20 | y<<10 | z
        closest = _shift_fill(state.closest, shift, -1)
        defined = closest >= 0
        x = (closest >> 20) - sx
        y = ((closest >> 10) & 1023) - sy
        z = (closest & 1023) - sz
        in_grid = ((x >= 0) & (x < gx) & (y >= 0) & (y < gy) & (z >= 0)
                   & (z < gz))
        d2 = torch.where(defined & ~in_grid, INF_D2, d2)
        closest = torch.where(defined & in_grid, (x << 20) | (y << 10) | z,
                              -1)
    else:
        closest = _shift_fill(state.closest, shift, UNDEFINED_COORD)
        defined = closest[0] >= 0
        rebased = torch.stack([closest[i] - s for i, s in
                               enumerate((sx, sy, sz))])
        closest = torch.where(defined[None], rebased, UNDEFINED_COORD)
        in_grid = ((closest >= 0).all(dim=0) & (closest[0] < gx)
                   & (closest[1] < gy) & (closest[2] < gz))
        evicted = defined & ~in_grid
        d2 = torch.where(evicted, INF_D2, d2)
        closest = torch.where(evicted[None], UNDEFINED_COORD, closest)
    return MapState(logodds=logodds, d2=d2, closest=closest, seen=seen,
                    hit_cnt=hit_cnt, miss_cnt=miss_cnt)


class ScrollingMixin:
    """The scrolling-grid and persistent-archive machinery
    (``scrolling.py:97-405``), mixed into an engine ahead of it in the
    MRO; the engine provides ``state``, ``cfg``, ``process`` and the
    queries.  Two hooks let an engine specialise the device work:
    ``_drain_counters`` flushes pending counters through one update, and
    ``_reshard_state`` re-cuts the state into the engine's slabs after
    the host-side strip writes (a no-op on one device; the sharded
    engine's ``parallel.engine``)."""

    def _init_scrolling(self, recenter_fraction: float, archive) -> None:
        self.origin_vox = np.zeros(3, np.int64)
        # recenter when the robot leaves the central box of this fraction
        self.recenter_fraction = recenter_fraction
        self.scroll_count = 0
        if archive is True:
            archive = TileArchive()
        self.archive = archive
        self.restore_count = 0
        if archive is not None and archive.num_tiles:
            self._hydrate_from_archive()

    def _drain_counters(self) -> None:
        self.state, _ = esdf_update(
            self.cfg, self.state,
            self._upload(np.asarray(self.cur_pos, np.float32)),
            use_window=not self.cfg.global_update)

    def _reshard_state(self) -> None:
        pass

    # -- frame bookkeeping -------------------------------------------------

    @property
    def world_origin(self) -> np.ndarray:
        """Current world position of grid cell (0,0,0)'s corner."""
        return (np.asarray(self.cfg.origin)
                + self.origin_vox * self.cfg.resolution)

    def _offset_m(self) -> np.ndarray:
        return self.origin_vox * self.cfg.resolution

    def maybe_recenter(self, robot_pos) -> bool:
        """Scroll the grid so the robot returns to the central region."""
        cfg = self.cfg
        center = self.world_origin + np.asarray(cfg.map_size) / 2
        half = np.asarray(cfg.map_size) / 2
        off = np.asarray(robot_pos, np.float64) - center
        if np.all(np.abs(off) <= self.recenter_fraction * half):
            return False
        if self.archive is not None:
            return self._recenter_persistent(robot_pos)
        shift_vox = np.round(off / cfg.resolution).astype(np.int64)
        lims = np.asarray(cfg.grid_shape, np.int64) - 1
        self._apply_scroll(np.clip(shift_vox, -lims, lims))
        self._reshard_state()
        return True

    def _apply_scroll(self, shift_vox: np.ndarray) -> None:
        self.state = scroll_state(self.state, shift_vox)
        self.origin_vox = self.origin_vox + shift_vox
        # rebase the robot position and the depth filter's previous-frame
        # transform into the new virtual frame (left as they were, the next
        # window would be off, and the filter, which reprojects into that
        # transform (Fiesta.h:356-377), would reject nearly every point)
        self.cur_pos = np.asarray(self.cur_pos) \
            - shift_vox * self.cfg.resolution
        if self.last_transform is not None:
            t = self.last_transform.copy()
            t[:3, 3] -= shift_vox * self.cfg.resolution
            self.last_transform = t
        self.scroll_count += 1
        self._sdf_cache = None

    # -- persistent-world plumbing (reference C3: HASH_TABLE block map) ----

    def _hydrate_from_archive(self) -> None:
        """Fill the initial window from a preloaded directory (cross-run
        resume); without it the first store of the window would erase the
        directory's content there."""
        lo_np, seen_np, any_data = self.archive.load(
            self.origin_vox, self.cfg.grid_shape)
        if not any_data:
            return
        self.state = dataclasses.replace(
            self.state, logodds=self._upload(lo_np),
            seen=self._upload(seen_np.astype(np.uint8)))
        self._rederive_distances()
        self._reshard_state()

    def _recenter_persistent(self, robot_pos) -> bool:
        """Recenter in fixed steps of grid/4 per axis (the JAX package's
        schedule, kept so that both engines scroll alike); distances
        re-derive once at the end when a strip was restored."""
        cfg = self.cfg
        n = np.asarray(cfg.grid_shape, np.int64)
        step = np.maximum(n // 4, 1)
        half = np.asarray(cfg.map_size) / 2

        def _trig(center_off):
            off_vox = np.abs(center_off) / cfg.resolution
            # the step/2 gate makes each step strictly shrink |off|
            return (np.abs(center_off) > self.recenter_fraction * half) \
                & (off_vox > step / 2)

        # a dead band (recenter_fraction < 0.25) where no fixed step fires:
        # bail before paying the counter drain below
        if not _trig(np.asarray(robot_pos, np.float64)
                     - (self.world_origin + half)).any():
            return False
        # drain pending counters before evicting: the strip's pending
        # observations would otherwise scroll off and be lost
        self._drain_counters()
        restored = scrolled = False
        for _ in range(64):
            off = np.asarray(robot_pos, np.float64) - (self.world_origin
                                                       + half)
            trig = _trig(off)
            if not trig.any():
                break
            shift_vox = np.where(trig, np.sign(off).astype(np.int64) * step,
                                 0)
            self._archive_evicted(shift_vox)
            self._apply_scroll(shift_vox)
            restored |= self._restore_entered(shift_vox)
            scrolled = True
        if restored:
            self._rederive_distances()
        if scrolled:
            self._reshard_state()
        return scrolled

    def _axis_strip(self, shift_vox, axis: int, entering: bool):
        """Slices of the strip along ``axis`` that leaves (entering=False,
        old frame) or enters (entering=True, new frame) the grid."""
        s = int(shift_vox[axis])
        n = self.cfg.grid_shape[axis]
        sl = [slice(None)] * 3
        if entering:
            sl[axis] = slice(n - s, n) if s > 0 else slice(0, -s)
        else:
            sl[axis] = slice(0, s) if s > 0 else slice(n + s, n)
        return tuple(sl)

    def _archive_evicted(self, shift_vox: np.ndarray) -> None:
        """Copy the strips about to leave the grid to the host directory
        (one per shifted axis; corner overlaps store the same data twice).
        The pipeline's only device-to-host copy, at recenters only."""
        for ax in range(3):
            if int(shift_vox[ax]) == 0:
                continue
            sl = self._axis_strip(shift_vox, ax, entering=False)
            starts = np.array([s.indices(n)[0] for s, n in
                               zip(sl, self.cfg.grid_shape)], np.int64)
            self.archive.store(self.origin_vox + starts,
                               self.state.logodds[sl].cpu().numpy(),
                               self.state.seen[sl].cpu().numpy())

    def _restore_entered(self, shift_vox: np.ndarray) -> bool:
        """Fill the strips that entered the grid from the directory.
        Returns whether anything was restored."""
        cfg = self.cfg
        restored = False
        for ax in range(3):
            if int(shift_vox[ax]) == 0:
                continue
            sl = self._axis_strip(shift_vox, ax, entering=True)
            idx = [s.indices(n) for s, n in zip(sl, cfg.grid_shape)]
            shape = tuple(i[1] - i[0] for i in idx)
            starts = np.array([i[0] for i in idx], np.int64)
            lo_np, seen_np, any_data = self.archive.load(
                self.origin_vox + starts, shape)
            if not any_data:
                continue
            logodds = self.state.logodds.clone()
            seen = self.state.seen.clone()
            logodds[sl] = self._upload(lo_np)
            seen[sl] = self._upload(seen_np.astype(np.uint8))
            self.state = dataclasses.replace(self.state, logodds=logodds,
                                             seen=seen)
            restored = True
        return restored

    def _rederive_distances(self) -> None:
        """Re-derive d2 and closest from the occupancy after a restore."""
        cfg = self.cfg
        self.restore_count += 1
        occ = occupied_grid(cfg, self.state.logodds)
        if cfg.esdf_mode == "rebuild":
            # the tick's derivation: lazy closest leaves closest as it is
            # (queries re-derive it, and the new d2 drops the cache)
            d2, closest = tick_rebuild_esdf(cfg, occ)
            self.state = dataclasses.replace(
                self.state, d2=d2,
                closest=self.state.closest if closest is None else closest)
        else:
            # seed every occupied voxel whose distance is not zero yet and
            # relax globally to the fixpoint; voxels whose closest obstacle
            # was evicted reset and re-settle against the restored content
            d2, closest, _ = esdf.update_esdf(
                self.state.d2, self.state.closest, occ,
                occ & (self.state.d2 != 0), None, None, cfg.relax_dirs)
            self.state = dataclasses.replace(self.state, d2=d2,
                                             closest=closest)

    # -- ingestion: world inputs shift into the virtual frame --------------

    def _to_virtual(self, pos) -> np.ndarray:
        return np.asarray(pos, np.float64) - self._offset_m()

    def _build_transform(self, pos, quat) -> np.ndarray:
        t = super()._build_transform(pos, quat).copy()
        t[:3, 3] -= self._offset_m()
        return t

    def process(self) -> int:
        # recenter on the most recent pose before integrating
        if self.sync.poses:
            self.maybe_recenter(self.sync.poses[-1][1])
        return super().process()

    # -- queries: world frame in, world frame out --------------------------

    def query_distance(self, positions):
        return super().query_distance(
            np.asarray(positions, np.float64) - self._offset_m())

    def query_dist_grad(self, positions):
        return super().query_dist_grad(
            np.asarray(positions, np.float64) - self._offset_m())

    def query_closest_obstacle(self, positions):
        """World-frame closest-obstacle query: positions shift into the
        virtual frame, the obstacle coordinates back out."""
        pts, dist = super().query_closest_obstacle(
            np.asarray(positions, np.float64) - self._offset_m())
        off = self._upload(np.asarray(self._offset_m(), np.float32))
        return torch.where(torch.isnan(pts), pts, pts + off), dist

    def occupied_world_points(self) -> np.ndarray:
        """World positions of occupied voxel centres."""
        pts = occupied_pointcloud(self.cfg, self.state,
                                  vis_lower_bound=-1e9, vis_upper_bound=1e9)
        return pts + self._offset_m()


class ScrollingFiestaPipeline(ScrollingMixin, FiestaPipeline):
    """``FiestaPipeline`` over an unbounded world (``scrolling.py:408``).

    The dense grid covers a moving box whose world anchor ``origin_vox``
    is kept in voxels; sensor inputs shift into the virtual frame, so every
    op runs unchanged.  With ``archive`` (a ``TileArchive``, or True for a
    new one) the explored world persists: recenters move in fixed grid/4
    steps, archive the evicted strips, restore the entered ones and
    re-derive distances.  ``device``: ``cuda`` unless given ``"cpu"``."""

    def __init__(self, cfg: FiestaConfig, method: str = "scanline",
                 recenter_fraction: float = 0.25, archive=None,
                 device: Device = None):
        super().__init__(cfg, method=method, device=device)
        self._init_scrolling(recenter_fraction, archive)
