"""Sensor pipeline and update scheduling (port of
``fiesta_tpu/pipeline.py``, reference include/Fiesta.h).

The batched tick: one tick integrates K sensor-frame scans (or K depth
images, back-projected and consistency-filtered), drains the counters into
log-odds in one pass (fusion) and rebuilds the exact truncated EDT of the
new occupancy, with the closest-obstacle grid in eager closest mode; in
local-update mode a window around the robot gates the counters and the
drain.  ``fused_stream`` / ``fused_depth_stream`` run N ticks as a Python
loop on the state's device; nothing in a tick reads a value back to the
host, so the device runs the ticks back to back.  ``derive_closest`` is
the lazy mode's closest grid for the current occupancy (the query path).

The app engine: ``ScanSynchronizer`` matches depth frames to poses
(component C14) and ``FiestaPipeline`` integrates each matched frame as it
arrives with one of the three integrators (``integrate_scan``) and runs
the 10 Hz update (``update``), serving the planner's queries from the map.

A config with ``edt_fine_dist < trunc_dist`` (on an even grid) rebuilds
with the two-level EDT (``edt.hierarchical_edt_d2`` and its closest form)
wherever the tick, the closest path and the engine rebuild.  With
``esdf_mode="incremental"`` the update runs the incremental engine in
place of the rebuild: the fusion drain (on the card the rebuild tick's
one-pass drain, on the CPU ``fuse_counts`` with its insert/delete masks)
and FIESTA's insert/delete relaxation (``esdf.update_esdf``: the inserts
and bucket resets, on the card one launch of the ``changes`` kernel, then
the sweeps to the fixpoint, on the card the ``relax`` kernel).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import FiestaConfig
from .grid import (Device, MapState, check_same_device, closest_packed_state,
                   local_window, local_window_np, make_state, occupied_grid,
                   resolve_device, window_mask)
from .io.replay import pad_cloud_np, pose_to_matrix
from .ops import edt, esdf, fusion, query, raycast
from .ops.depth import depth_tick_components, depth_to_cloud, \
    sensor_to_world
from .timing import TICK, Timer, span

#: integrator registry shared by the single-scan and batched paths
_INTEGRATORS = {
    "projective": raycast.integrate_scan_projective,
    "scanline": raycast.integrate_scan_scanline,
    "dda": raycast.integrate_scan_dda,
}


class UpdateStats(NamedTuple):
    num_observed: torch.Tensor   # occupancy-queue size (ESDFMap.cpp:237)
    num_inserted: torch.Tensor   # insert_queue_ size   (ESDFMap.cpp:277)
    num_deleted: torch.Tensor    # delete_queue_ size   (ESDFMap.cpp:277)
    num_sweeps: torch.Tensor     # relaxation sweeps (0 in rebuild mode)


def _levels(cfg: FiestaConfig):
    """(t_fine, t_total) in voxels."""
    return (edt.trunc_vox_for(cfg.resolution, cfg.edt_fine_dist),
            edt.trunc_vox_for(cfg.resolution, cfg.trunc_dist))


def _hierarchical(cfg: FiestaConfig) -> bool:
    """Whether the config selects the two-level EDT (edt_fine_dist <
    trunc_dist on an even grid)."""
    t_fine, t_total = _levels(cfg)
    return t_fine < t_total and all(g % 2 == 0 for g in cfg.grid_shape)


def rebuild_d2(cfg: FiestaConfig, occupied: torch.Tensor) -> torch.Tensor:
    """Truncated exact EDT of the current occupancy, two-level when the
    config selects it (``pipeline.py:109-125``)."""
    t_fine, t_total = _levels(cfg)
    if _hierarchical(cfg):
        return edt.hierarchical_edt_d2(occupied, t_fine, t_total)
    return edt.truncated_edt_d2(occupied, t_total)


def _sdf_from_state(cfg: FiestaConfig, state: MapState) -> torch.Tensor:
    """Signed distance field from the current map state (C18)."""
    occ = occupied_grid(cfg, state.logodds)
    return query.signed_distance_grid(cfg, state.d2, state.seen, occ)


def _closest_ok(shape, t) -> bool:
    """Packed or wide closest engine available."""
    return (edt.closest_plan(shape, t) is not None
            or edt.closest_plan_wide(shape, t) is not None)


def rebuild_tracks_closest(cfg: FiestaConfig) -> bool:
    """Whether the rebuild tick maintains ``state.closest``
    (``pipeline.py:148-165``): ``cfg.track_closest`` and a closest engine
    that fits the grid and truncation."""
    if not cfg.track_closest:
        return False
    t_fine, t_total = _levels(cfg)
    if _hierarchical(cfg):
        coarse = tuple(g // 2 for g in cfg.grid_shape)
        return (_closest_ok(cfg.grid_shape, t_fine)
                and _closest_ok(coarse, -(-t_total // 2)))
    return _closest_ok(cfg.grid_shape, t_total)


def rebuild_esdf(cfg: FiestaConfig, occupied: torch.Tensor):
    """EDT rebuild returning (d2, closest-or-None) (``pipeline.py:170-194``):
    with closest tracking the argmin rides the packed passes
    (``edt.edt_closest_auto``, at both levels of the two-level EDT when the
    config selects it), in the state's closest format."""
    if not rebuild_tracks_closest(cfg):
        return rebuild_d2(cfg, occupied), None
    t_fine, t_total = _levels(cfg)
    packed = closest_packed_state(cfg)
    if _hierarchical(cfg):
        return edt.hierarchical_edt_d2_closest(occupied, t_fine, t_total,
                                               packed_out=packed)
    return edt.edt_closest_auto(occupied, t_total, packed_out=packed)


def tick_rebuild_esdf(cfg: FiestaConfig, occupied: torch.Tensor):
    """What the tick derives: (d2, closest-or-None).  Lazy closest (the
    default) leaves closest to the query surface (``derive_closest``);
    eager mode rebuilds it every tick, as the reference writes
    closest_obstacle_ on every update."""
    if cfg.lazy_closest:
        return rebuild_d2(cfg, occupied), None
    return rebuild_esdf(cfg, occupied)


def derive_closest(cfg: FiestaConfig, logodds: torch.Tensor) -> torch.Tensor:
    """Closest-obstacle grid for the current occupancy (the lazy query
    path, ``pipeline.py:216-229``): in rebuild mode closest is a pure
    function of the occupancy, so this is bit for bit the grid an eager
    tick writes.  Callers gate on ``rebuild_tracks_closest``."""
    with span("fiesta.closest"):
        _, closest = rebuild_esdf(cfg, occupied_grid(cfg, logodds))
    if closest is None:
        raise ValueError("derive_closest on a config without a closest "
                         "engine; gate on rebuild_tracks_closest")
    return closest


def integrate_scan(cfg: FiestaConfig, state: MapState,
                   points_sensor: torch.Tensor, valid: torch.Tensor,
                   transform: torch.Tensor, window=None,
                   method: str = "projective"):
    """Transform one sensor-frame scan (points [P,3] f32, valid [P] bool,
    transform [4,4] f32 sensor-to-world) to world and accumulate its
    observations into the counters (``pipeline.py:84-106``).  ``window``
    (wmin [3] i32, wmax [3] i32): local-update mode.  Returns (new state,
    ScanResult).  The caller gives up ``state``, as the JAX package
    donates it."""
    check_same_device(state, points_sensor, valid, transform)
    points_world = sensor_to_world(points_sensor, transform)
    res = _INTEGRATORS[method](cfg, state.hit_cnt, state.miss_cnt,
                               points_world, valid, transform[:3, 3], window)
    return dataclasses.replace(state, hit_cnt=res.hit_cnt,
                               miss_cnt=res.miss_cnt), res


def esdf_update(cfg: FiestaConfig, state: MapState,
                cur_pos: Optional[torch.Tensor] = None,
                use_window: bool = False, max_iters: int = 0):
    """Fusion and ESDF maintenance (``pipeline.py:232-310``).  With
    ``use_window`` only the observations inside the local window around
    ``cur_pos`` [3] f32 apply (every counter is still zeroed).  Returns
    (new state, UpdateStats).

    Rebuild mode: the one-pass drain, then the EDT rebuilt over the whole
    grid; the counts come from the drain (no insert/delete masks are
    built) and ``max_iters`` is unused.  Incremental mode: the drain
    (``fuse_counts`` on the CPU, the one-pass drain on the card) and
    ``esdf.update_esdf`` (in the window when ``use_window``), whose
    relaxation stops after ``max_iters`` sweeps when it is > 0."""
    with span("fiesta.update"):
        if cfg.esdf_mode != "rebuild":
            return _incremental_update(cfg, state, cur_pos, use_window,
                                       max_iters)
        return _rebuild_update(cfg, state, cur_pos, use_window)


def _rebuild_update(cfg: FiestaConfig, state: MapState, cur_pos,
                    use_window: bool):
    """The rebuild engine's update: the one-pass drain, then the EDT."""
    window = local_window(cfg, cur_pos) if use_window else None
    on, off_eq = ((cfg.min_occupancy_log, False) if cfg.probabilistic
                  else (1.0, True))
    with span("fiesta.update.drain"):
        new_lo, seen, occ, hit0, miss0, n_obs, n_ins, n_del = \
            fusion.fuse_drain(
                state.logodds, state.seen, state.hit_cnt, state.miss_cnt,
                l_hit=cfg.prob_hit_log, l_miss=cfg.prob_miss_log,
                clamp_min=cfg.clamp_min_log, clamp_max=cfg.clamp_max_log,
                occ_thresh=on, occ_is_eq=off_eq, window=window)
    with span("fiesta.update.edt"):
        d2, closest = tick_rebuild_esdf(cfg, occ)
    if closest is None:
        closest = state.closest
    new_state = MapState(logodds=new_lo, d2=d2, closest=closest, seen=seen,
                         hit_cnt=hit0, miss_cnt=miss0)
    stats = UpdateStats(
        num_observed=n_obs, num_inserted=n_ins, num_deleted=n_del,
        num_sweeps=torch.zeros((), dtype=torch.int32, device=d2.device))
    return new_state, stats


def _incremental_update(cfg: FiestaConfig, state: MapState, cur_pos,
                        use_window: bool, max_iters: int):
    """The incremental engine's update (``pipeline.py:282-310``).  A CUDA
    state takes ``_drained_update``; a CPU state drains through
    ``fuse_counts``, whose masks give the inserts and the counts."""
    if state.logodds.is_cuda:
        return _drained_update(cfg, state, cur_pos, use_window, max_iters)
    wmask = None
    if use_window:
        wmask = window_mask(cfg, *local_window(cfg, cur_pos))
    with span("fiesta.update.drain"):
        fr = fusion.fuse_counts(cfg, state.logodds, state.seen,
                                state.hit_cnt, state.miss_cnt,
                                window_mask=wmask)
    with span("fiesta.update.relax"):
        d2, closest, sweeps = esdf.update_esdf(
            state.d2, state.closest, fr.occupied, fr.insert_mask,
            fr.delete_mask, wmask, cfg.relax_dirs, max_iters=max_iters)
    new_state = MapState(logodds=fr.logodds, d2=d2, closest=closest,
                         seen=fr.seen, hit_cnt=torch.zeros_like(state.hit_cnt),
                         miss_cnt=torch.zeros_like(state.miss_cnt))
    stats = UpdateStats(
        num_observed=fr.num_observed,
        num_inserted=fr.insert_mask.sum(dtype=torch.int32),
        num_deleted=fr.delete_mask.sum(dtype=torch.int32),
        num_sweeps=sweeps)
    return new_state, stats


def _drained_update(cfg: FiestaConfig, state: MapState, cur_pos,
                    use_window: bool, max_iters: int):
    """The incremental update through the rebuild tick's one-pass drain
    (``fusion.fuse_drain``: the window as its bounds, the counters
    returned zeroed, the counts its own), its inserts taken from the
    log-odds before it (``esdf.NewlyOccupied``): on the card two launches
    and the relax kernel's one.  Bit for bit ``_incremental_update``'s
    ``fuse_counts`` path, on either device."""
    window = local_window(cfg, cur_pos) if use_window else None
    on, off_eq = ((cfg.min_occupancy_log, False) if cfg.probabilistic
                  else (1.0, True))
    with span("fiesta.update.drain"):
        new_lo, seen, occ, hit0, miss0, n_obs, n_ins, n_del = \
            fusion.fuse_drain(
                state.logodds, state.seen, state.hit_cnt, state.miss_cnt,
                l_hit=cfg.prob_hit_log, l_miss=cfg.prob_miss_log,
                clamp_min=cfg.clamp_min_log, clamp_max=cfg.clamp_max_log,
                occ_thresh=on, occ_is_eq=off_eq, window=window)
    with span("fiesta.update.relax"):
        d2, closest, sweeps = esdf.update_esdf(
            state.d2, state.closest, occ,
            esdf.NewlyOccupied(state.logodds, on, off_eq), None,
            None if window is None else window_mask(cfg, *window),
            cfg.relax_dirs, max_iters=max_iters)
    new_state = MapState(logodds=new_lo, d2=d2, closest=closest, seen=seen,
                         hit_cnt=hit0, miss_cnt=miss0)
    return new_state, UpdateStats(num_observed=n_obs, num_inserted=n_ins,
                                  num_deleted=n_del, num_sweeps=sweeps)


def integrate_scan_batch(cfg: FiestaConfig, state: MapState, points, valids,
                         transforms: torch.Tensor,
                         cur_pos: Optional[torch.Tensor] = None,
                         use_window: bool = False,
                         method: str = "scanline") -> MapState:
    """Integrate K sensor-frame scans (points [K,P,3] f32 or the depth
    tick's components (px, py, pz) [K,P], valids [K,P] bool, transforms
    [K,4,4] f32 sensor-to-world) into the state's counters
    (``pipeline.py:313-356``): ``scanline`` in one batched splat and carve,
    the other integrators one scan after another.  ``use_window`` gates the
    counters to the local window around ``cur_pos``.  The caller gives up
    ``state``: its counters may be added to in place, on the CPU as on the
    card (``copy_state`` keeps a state to reuse)."""
    pts = tuple(points) if isinstance(points, (tuple, list)) else (points,)
    check_same_device(state, *pts, valids, transforms, cur_pos)
    with span("fiesta.integrate"):
        win = local_window(cfg, cur_pos) if use_window else None
        if method == "scanline":
            res = raycast.integrate_scan_scanline_batch(
                cfg, state.hit_cnt, state.miss_cnt, points, valids,
                transforms, win)
            return dataclasses.replace(state, hit_cnt=res.hit_cnt,
                                       miss_cnt=res.miss_cnt)
        if len(pts) != 1:
            raise ValueError("component-form points go to the scanline "
                             "integrator only")
        fn = _INTEGRATORS[method]
        hit, miss = state.hit_cnt, state.miss_cnt
        for i in range(points.shape[0]):
            pw = sensor_to_world(points[i], transforms[i])
            res = fn(cfg, hit, miss, pw, valids[i], transforms[i, :3, 3],
                     win)
            hit, miss = res.hit_cnt, res.miss_cnt
        return dataclasses.replace(state, hit_cnt=hit, miss_cnt=miss)


def fused_batch_step(cfg: FiestaConfig, state: MapState, points, valids,
                     transforms: torch.Tensor, cur_pos: torch.Tensor,
                     use_window: bool = False, method: str = "scanline",
                     max_iters: int = 0):
    """One ESDF tick: batched scan integration, occupancy fusion and ESDF
    maintenance (``pipeline.py:359-382``).  ``cur_pos`` [3] is the robot
    position, the window centre in local-update mode; ``max_iters`` caps
    the incremental engine's sweeps (see ``esdf_update``).  The caller
    gives up ``state`` (see ``integrate_scan_batch``)."""
    with span(TICK):
        state = integrate_scan_batch(cfg, state, points, valids, transforms,
                                     cur_pos, use_window=use_window,
                                     method=method)
        return esdf_update(cfg, state, cur_pos, use_window=use_window,
                           max_iters=max_iters)


def _stack_stats(per_tick):
    return UpdateStats(*(torch.stack(f) for f in zip(*per_tick)))


def fused_stream(cfg: FiestaConfig, state: MapState, points: torch.Tensor,
                 valids: torch.Tensor, transforms: torch.Tensor,
                 cur_positions: torch.Tensor, use_window: bool = False,
                 method: str = "scanline", max_iters: int = 0):
    """N consecutive ticks (``pipeline.py:465-502``): points [N,K,P,3],
    valids [N,K,P], transforms [N,K,4,4], cur_positions [N,3].  Returns
    the final state and UpdateStats with each field stacked to [N].  The
    caller gives up ``state`` (see ``integrate_scan_batch``)."""
    per_tick = []
    for i in range(points.shape[0]):
        state, stats = fused_batch_step(
            cfg, state, points[i], valids[i], transforms[i],
            cur_positions[i], use_window=use_window, method=method,
            max_iters=max_iters)
        per_tick.append(stats)
    return state, _stack_stats(per_tick)


def fused_depth_batch_step(cfg: FiestaConfig, state: MapState,
                           depths: torch.Tensor, transforms: torch.Tensor,
                           prev_depth: torch.Tensor,
                           prev_transform: torch.Tensor,
                           cur_pos: torch.Tensor, use_window: bool = False,
                           use_filter: bool = True, max_iters: int = 0):
    """Depth-image tick (``pipeline.py:385-428``): K depth frames [K,H,W]
    f32 (meters) with camera-to-world transforms [K,4,4] are back-projected
    and consistency-filtered against their chained predecessors (the first
    against ``prev_depth`` [H,W] / ``prev_transform`` [4,4]), then carved,
    fused and EDT'd like the cloud tick, in component form.  The caller
    gives up ``state``."""
    with span(TICK):
        with span("fiesta.depth"):
            *points, valids = depth_tick_components(
                cfg, depths, transforms, prev_depth, prev_transform,
                use_filter)
        return fused_batch_step(cfg, state, tuple(points), valids, transforms,
                                cur_pos, use_window=use_window,
                                method="scanline", max_iters=max_iters)


def fused_depth_stream(cfg: FiestaConfig, state: MapState,
                       depths: torch.Tensor, transforms: torch.Tensor,
                       cur_positions: torch.Tensor, use_window: bool = False,
                       use_filter: bool = True, max_iters: int = 0):
    """N depth ticks (``pipeline.py:431-462``): depths [N,K,H,W],
    transforms [N,K,4,4], cur_positions [N,3], a Python loop that chains the
    consistency filter across ticks (the first tick's first frame is its
    own predecessor).  Returns the final state and UpdateStats stacked to
    [N].  The caller gives up ``state``."""
    prev_d, prev_t = depths[0, 0], transforms[0, 0]
    per_tick = []
    for i in range(depths.shape[0]):
        state, stats = fused_depth_batch_step(
            cfg, state, depths[i], transforms[i], prev_d, prev_t,
            cur_positions[i], use_window=use_window, use_filter=use_filter,
            max_iters=max_iters)
        per_tick.append(stats)
        prev_d, prev_t = depths[i, -1], transforms[i, -1]
    return state, _stack_stats(per_tick)


# ---------------------------------------------------------------------------
# Host-side pose/depth synchronization (component C14)
# ---------------------------------------------------------------------------


class ScanSynchronizer:
    """Pose/depth timestamp matching (SynchronizationAndProcess semantics,
    ``pipeline.py:510-555``).

    A depth frame is processed once a pose *newer* than
    ``depth_time + time_delay`` exists (so the matched pose is final); the
    match is the latest pose with stamp <= depth_time + time_delay; frames
    with no matching pose are dropped (Fiesta.h:388-405).
    """

    def __init__(self, time_delay: float = 3e-3,
                 max_queue: int = 10000, max_depth_queue: int = 64):
        """``max_queue`` bounds the pose queue and ``max_depth_queue`` the
        frame queue, so a stalled stream cannot grow memory without bound
        (the reference subscribes with queue_size=10, Fiesta.h:115-116)."""
        self.time_delay = time_delay
        self.poses: deque = deque(maxlen=max_queue)   # (t, pos, quat)
        self.depths: deque = deque(maxlen=max_depth_queue)  # (t, payload)

    def push_pose(self, t: float, pos, quat_wxyz) -> None:
        self.poses.append((float(t), np.asarray(pos, np.float64),
                           np.asarray(quat_wxyz, np.float64)))

    def push_depth(self, t: float, payload) -> None:
        self.depths.append((float(t), payload))

    def drain(self):
        """The (depth_payload, pose_t, pos, quat) matches that are final."""
        out = []
        while self.depths:
            dt, payload = self.depths[0]
            cutoff = dt + self.time_delay
            # wait until a newer pose guarantees the match is final
            if not self.poses or self.poses[-1][0] <= cutoff:
                break
            match = None
            while self.poses and self.poses[0][0] <= cutoff:
                match = self.poses.popleft()
            self.depths.popleft()
            if match is None:
                continue  # drop: no fresh pose (Fiesta.h:402-405)
            out.append((payload, match[0], match[1], match[2]))
        return out


# ---------------------------------------------------------------------------
# The engine (reference Fiesta<DepthMsgType, PoseMsgType> equivalent)
# ---------------------------------------------------------------------------


class FiestaPipeline:
    """End-to-end streaming ESDF engine (``pipeline.py:563-857``).

    Usage::

        pipe = FiestaPipeline(cfg, method="scanline")   # on cuda
        pipe.observe_pose(t, pos, quat_wxyz)
        pipe.observe_cloud(t, points_cam)        # or observe_depth(t, img)
        pipe.process()                           # sync + integrate scans
        stats = pipe.update()                    # fusion + ESDF (10 Hz tick)
        d, g = pipe.query_dist_grad(positions)

    ``device`` is where the map lives: ``cuda`` unless given ``"cpu"``
    (then every kernel is replaced by its plain version).  ``process`` and
    ``update`` only enqueue work: host arrays go up through pinned memory
    without waiting, and nothing is read back, so the card runs frames and
    updates back to back; ``sync_device`` waits for it.
    """

    def __init__(self, cfg: FiestaConfig, method: str = "projective",
                 device: Device = None):
        cfg.validate()
        if method not in _INTEGRATORS:
            raise ValueError(f"unknown method {method!r}: expected one of "
                             f"{sorted(_INTEGRATORS)}")
        self.cfg = cfg
        self.method = method
        self.device = resolve_device(device)
        self.state: MapState = make_state(cfg, self.device)
        self.sync = ScanSynchronizer()
        self.T_D_B = np.eye(4)   # dataset extrinsics (parameters.cpp:67-75)
        self.T_B_C = np.eye(4)
        self.cur_pos = np.zeros(3)
        self.last_transform: Optional[np.ndarray] = None
        self.last_depth = None
        self.new_msg = False
        self.esdf_cnt = 0
        self.image_cnt = 0
        self._sdf_cache = None
        self._sdf_src = None
        self._closest_cache = None
        self._closest_src = None

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, without waiting for the
        work queued there (pinned staging, asynchronous copy)."""
        t = torch.from_numpy(np.array(array, order="C"))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- ingestion ---------------------------------------------------------

    def observe_pose(self, t: float, pos, quat_wxyz) -> None:
        self.sync.push_pose(t, pos, quat_wxyz)

    def observe_cloud(self, t: float, points_cam) -> None:
        """Sensor-frame point cloud (PointCloud2 input mode): a numpy [N,3]
        array, or a (points, valid) device pair from ``preload_cloud``."""
        self.sync.push_depth(t, ("cloud", points_cam))

    def preload_cloud(self, points_cam: np.ndarray):
        """Pad and upload a scan once, ahead of streaming."""
        pts = np.ascontiguousarray(points_cam, np.float32)
        valid = np.isfinite(pts).all(axis=-1)
        return self._pad_cloud(pts, valid)

    def observe_depth(self, t: float, depth_m: np.ndarray) -> None:
        """Depth image [H,W] in meters (Image input mode)."""
        self.sync.push_depth(t, ("depth", depth_m))

    # -- processing --------------------------------------------------------

    def _to_virtual(self, pos) -> np.ndarray:
        """World -> map-frame hook (identity here; a scrolling engine
        shifts by its rolling origin)."""
        return np.asarray(pos, np.float64)

    def _build_transform(self, pos, quat) -> np.ndarray:
        t_wb = np.asarray(pose_to_matrix(pos, quat))
        return t_wb @ self.T_D_B @ self.T_B_C    # Fiesta.h:419

    def _cloud_to_np(self, data):
        """Raw cloud -> padded host (pts [P,3] f32, valid [P] bool)."""
        pts = np.asarray(data, np.float32)
        valid = np.isfinite(pts).all(axis=-1)
        return self._pad_cloud_np(
            np.ascontiguousarray(pts, np.float32), valid)

    def _pad_cloud_np(self, pts: np.ndarray, valid: np.ndarray):
        """Host pad / strided subsample to ``cfg.max_points_per_scan``."""
        return pad_cloud_np(self.cfg, pts, valid)

    def _pad_cloud(self, pts: np.ndarray, valid: np.ndarray):
        pts, valid = self._pad_cloud_np(pts, valid)
        return self._upload(pts.astype(np.float32)), self._upload(valid)

    def _pad_cloud_dev(self, pts: torch.Tensor, valid: torch.Tensor):
        """Device twin of ``_pad_cloud`` for clouds already on the device
        (the depth path)."""
        n = self.cfg.max_points_per_scan
        if pts.shape[0] > n:
            stride = -(-pts.shape[0] // n)
            pts, valid = pts[::stride][:n], valid[::stride][:n]
        pad = n - pts.shape[0]
        if pad:
            pts = torch.cat([pts, pts.new_zeros((pad, 3))])
            valid = torch.cat([valid, valid.new_zeros(pad)])
        return pts, valid

    def _convert_depth(self, data, transform):
        """Depth image -> padded device (pts, valid), threading the
        consistency filter chain (C12/C13).  Returns None for the first
        filtered frame (it yields nothing, Fiesta.h:353)."""
        cfg = self.cfg
        self.image_cnt += 1
        if np.prod(np.shape(data)) > cfg.max_points_per_scan:
            raise ValueError(
                f"depth image {np.shape(data)} exceeds "
                f"max_points_per_scan={cfg.max_points_per_scan}; raise it "
                "to H*W: subsampling depth pixels would drop observations")
        with Timer("depth", self.device):
            use_filter = (cfg.use_depth_filter and self.image_cnt > 1
                          and self.last_depth is not None)
            depth = self._upload(np.asarray(data, np.float32))
            last_t = (self.last_transform if self.last_transform is not None
                      else transform)
            pts_cam, valid = depth_to_cloud(
                cfg, depth, self._upload(np.asarray(transform, np.float32)),
                self._upload(np.asarray(last_t, np.float32)),
                self.last_depth if self.last_depth is not None else depth,
                use_filter=use_filter)
            if cfg.use_depth_filter:
                self.last_transform = transform
            self.last_depth = depth
            if self.image_cnt == 1 and cfg.use_depth_filter:
                return None  # first frame yields nothing (Fiesta.h:353)
        return self._pad_cloud_dev(pts_cam, valid)

    def process(self) -> int:
        """Drain synchronized frames through conversion and integration.
        Returns the number of frames integrated.  Enqueues device work
        only: it never waits for the device."""
        cfg = self.cfg
        n_frames = 0
        for payload, _, pos, quat in self.sync.drain():
            transform = self._build_transform(pos, quat)
            kind, data = payload
            if kind == "depth":
                converted = self._convert_depth(data, transform)
                if converted is None:
                    continue
                pts, valid = converted
            elif isinstance(data, tuple):      # pre-uploaded device pair
                pts, valid = data
            else:
                pts_np, valid_np = self._cloud_to_np(data)
                pts, valid = self._upload(pts_np), self._upload(valid_np)
            with Timer("raycasting", self.device):
                vpos = self._to_virtual(pos)
                win = None
                if not cfg.global_update:
                    win = tuple(self._upload(w)
                                for w in local_window_np(cfg, vpos))
                self.state, _ = integrate_scan(
                    cfg, self.state, pts, valid,
                    self._upload(np.asarray(transform, np.float32)), win,
                    method=self.method)
            self.cur_pos = self._to_virtual(pos)
            self.new_msg = True
            n_frames += 1
        return n_frames

    def update(self, max_iters: int = 0) -> Optional[UpdateStats]:
        """The 10 Hz ESDF tick (UpdateEsdfEvent, Fiesta.h:481-539); None
        when no frame arrived since the last one.  ``max_iters`` caps the
        incremental engine's relaxation sweeps (0: to the fixpoint)."""
        if not self.new_msg:
            return None
        self.new_msg = False
        self.esdf_cnt += 1
        with Timer("UpdateESDF", self.device):
            self.state, stats = esdf_update(
                self.cfg, self.state,
                self._upload(np.asarray(self.cur_pos, np.float32)),
                use_window=not self.cfg.global_update, max_iters=max_iters)
        if self.cfg.signed_needed:
            # maintain the signed field every tick (the reference's inverse
            # map, Fiesta.h:216-218)
            self._sdf_cache = _sdf_from_state(self.cfg, self.state)
            self._sdf_src = self.state.d2
        return stats

    def sync_device(self) -> None:
        """Block until all queued device work for the map has finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- queries -----------------------------------------------------------

    def _positions(self, positions) -> torch.Tensor:
        if isinstance(positions, torch.Tensor):
            return positions.to(self.device, torch.float32)
        return self._upload(np.asarray(positions, np.float32))

    def distance_grid(self) -> torch.Tensor:
        return query.distance_grid(self.cfg, self.state.d2, self.state.seen)

    def query_distance(self, positions) -> torch.Tensor:
        with span("fiesta.query"):
            return query.get_distance(self.cfg, self.distance_grid(),
                                      self._positions(positions))

    def query_dist_grad(self, positions):
        with span("fiesta.query"):
            return query.get_dist_grad_trilinear(
                self.cfg, self.distance_grid(), self._positions(positions))

    def _derive_closest(self) -> torch.Tensor:
        """Fresh closest grid from the current occupancy."""
        return derive_closest(self.cfg, self.state.logodds)

    def closest_grid(self) -> torch.Tensor:
        """Current closest-obstacle grid (packed int32 or i16 planes,
        ``grid.closest_packed_state``).  In lazy mode it is derived on the
        first call after a tick and cached on the identity of the tick's
        ``d2`` (every tick makes a new one; nothing writes into it), so any
        state change invalidates it; eager mode reads ``state.closest``."""
        if not self.cfg.lazy_closest:
            return self.state.closest
        if (self._closest_cache is not None
                and self._closest_src is self.state.d2):
            return self._closest_cache
        self._closest_cache = self._derive_closest()
        self._closest_src = self.state.d2
        return self._closest_cache

    def query_closest_obstacle(self, positions):
        """Nearest-obstacle world coordinates and distance per query
        position (``query.get_closest_obstacle``), read from
        ``closest_grid()``."""
        with span("fiesta.query"):
            return query.get_closest_obstacle(
                self.cfg, self.closest_grid(), self.state.d2,
                self.state.seen, self._positions(positions))

    def occupied(self) -> torch.Tensor:
        return occupied_grid(self.cfg, self.state.logodds)

    def sdf_grid(self) -> torch.Tensor:
        """Signed distance field [X,Y,Z] f32 (component C18), cached per
        ESDF tick on the identity of ``state.d2``."""
        if self._sdf_cache is not None and self._sdf_src is self.state.d2:
            return self._sdf_cache
        self._sdf_cache = _sdf_from_state(self.cfg, self.state)
        self._sdf_src = self.state.d2
        return self._sdf_cache
