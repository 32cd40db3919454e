"""The production mapping tick (port of the scanline rebuild path of
``fiesta_tpu/pipeline.py``).

One tick integrates K sensor-frame scans (splat + carve + counter apply),
drains the counters into log-odds in one pass (fusion) and rebuilds the
exact truncated EDT of the new occupancy, with the closest-obstacle grid
in eager closest mode.  ``fused_stream`` runs N ticks as a Python loop on
the state's device; nothing in a tick reads a value back to the host, so
the device runs the ticks back to back.  ``derive_closest`` is the lazy
mode's closest grid for the current occupancy (the query path).

This covers the global-update scanline tick with the rebuild ESDF, lazy
or eager closest (the cow_and_lady production configuration); window
mode, the other integrators, the incremental engine and the hierarchical
EDT raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .config import FiestaConfig
from .grid import MapState, check_same_device, closest_packed_state, \
    occupied_grid
from .ops import edt, fusion, query, raycast


class UpdateStats(NamedTuple):
    num_observed: torch.Tensor   # occupancy-queue size (ESDFMap.cpp:237)
    num_inserted: torch.Tensor   # insert_queue_ size   (ESDFMap.cpp:277)
    num_deleted: torch.Tensor    # delete_queue_ size   (ESDFMap.cpp:277)
    num_sweeps: torch.Tensor     # relaxation sweeps (0 in rebuild mode)


def _hierarchical(cfg: FiestaConfig) -> bool:
    """Whether the config selects the two-level EDT (edt_fine_dist <
    trunc_dist on an even grid)."""
    t_total = edt.trunc_vox_for(cfg.resolution, cfg.trunc_dist)
    t_fine = edt.trunc_vox_for(cfg.resolution, cfg.edt_fine_dist)
    return t_fine < t_total and all(g % 2 == 0 for g in cfg.grid_shape)


def rebuild_d2(cfg: FiestaConfig, occupied: torch.Tensor) -> torch.Tensor:
    """Truncated exact EDT of the current occupancy
    (``pipeline.py:109-125``)."""
    if _hierarchical(cfg):
        raise NotImplementedError(
            "edt_fine_dist < trunc_dist selects the hierarchical EDT, which "
            "this port does not have yet; use edt_fine_dist >= trunc_dist")
    return edt.truncated_edt_d2(
        occupied, edt.trunc_vox_for(cfg.resolution, cfg.trunc_dist))


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
    t_total = edt.trunc_vox_for(cfg.resolution, cfg.trunc_dist)
    if _hierarchical(cfg):
        t_fine = edt.trunc_vox_for(cfg.resolution, cfg.edt_fine_dist)
        coarse = tuple(g // 2 for g in cfg.grid_shape)
        return (_closest_ok(cfg.grid_shape, t_fine)
                and _closest_ok(coarse, -(-t_total // 2)))
    return _closest_ok(cfg.grid_shape, t_total)


def rebuild_esdf(cfg: FiestaConfig, occupied: torch.Tensor):
    """EDT rebuild returning (d2, closest-or-None) (``pipeline.py:170-194``):
    with closest tracking the argmin rides the packed passes
    (``edt.edt_closest_auto``), in the state's closest format."""
    if not rebuild_tracks_closest(cfg):
        return rebuild_d2(cfg, occupied), None
    if _hierarchical(cfg):
        raise NotImplementedError(
            "edt_fine_dist < trunc_dist selects the hierarchical EDT with "
            "closest, which this port does not have yet")
    return edt.edt_closest_auto(
        occupied, edt.trunc_vox_for(cfg.resolution, cfg.trunc_dist),
        packed_out=closest_packed_state(cfg))


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
    _, closest = rebuild_esdf(cfg, occupied_grid(cfg, logodds))
    if closest is None:
        raise ValueError("derive_closest on a config without a closest "
                         "engine; gate on rebuild_tracks_closest")
    return closest


def esdf_update(cfg: FiestaConfig, state: MapState):
    """One-pass fusion drain + EDT rebuild, global update
    (``pipeline.py:248-280``).  Returns (new state, UpdateStats); the
    counts come from the drain and no insert/delete masks are built."""
    if cfg.esdf_mode != "rebuild":
        raise NotImplementedError(
            f"esdf_mode={cfg.esdf_mode!r}: this port has the rebuild "
            "engine only")
    on, off_eq = ((cfg.min_occupancy_log, False) if cfg.probabilistic
                  else (1.0, True))
    new_lo, seen, occ, hit0, miss0, n_obs, n_ins, n_del = fusion.fuse_drain(
        state.logodds, state.seen, state.hit_cnt, state.miss_cnt,
        l_hit=cfg.prob_hit_log, l_miss=cfg.prob_miss_log,
        clamp_min=cfg.clamp_min_log, clamp_max=cfg.clamp_max_log,
        occ_thresh=on, occ_is_eq=off_eq)
    d2, closest = tick_rebuild_esdf(cfg, occ)
    if closest is None:
        closest = state.closest
    new_state = MapState(logodds=new_lo, d2=d2, closest=closest, seen=seen,
                         hit_cnt=hit0, miss_cnt=miss0)
    stats = UpdateStats(
        num_observed=n_obs, num_inserted=n_ins, num_deleted=n_del,
        num_sweeps=torch.zeros((), dtype=torch.int32, device=d2.device))
    return new_state, stats


def integrate_scan_batch(cfg: FiestaConfig, state: MapState,
                         points: torch.Tensor, valids: torch.Tensor,
                         transforms: torch.Tensor) -> MapState:
    """Integrate K sensor-frame scans ([K,P,3] f32, [K,P] bool, [K,4,4]
    f32 sensor-to-world) into the state's counters (scanline branch of
    ``pipeline.py:315-342``).  The caller gives up ``state``, as the JAX
    package donates it: its counters are added to in place, on the CPU as
    on the card (``copy_state`` keeps a state to reuse)."""
    check_same_device(state, points, valids, transforms)
    res = raycast.integrate_scan_scanline_batch(
        cfg, state.hit_cnt, state.miss_cnt, points, valids, transforms)
    return dataclasses.replace(state, hit_cnt=res.hit_cnt,
                               miss_cnt=res.miss_cnt)


def fused_batch_step(cfg: FiestaConfig, state: MapState,
                     points: torch.Tensor, valids: torch.Tensor,
                     transforms: torch.Tensor, cur_pos: torch.Tensor):
    """One ESDF tick: batched scan integration, occupancy fusion and EDT
    rebuild (``pipeline.py:362-382``).  ``cur_pos`` [3] is the robot
    position (the window centre, unused by the global update).  The
    caller gives up ``state`` (see ``integrate_scan_batch``)."""
    check_same_device(state, cur_pos)
    state = integrate_scan_batch(cfg, state, points, valids, transforms)
    return esdf_update(cfg, state)


def fused_stream(cfg: FiestaConfig, state: MapState, points: torch.Tensor,
                 valids: torch.Tensor, transforms: torch.Tensor,
                 cur_positions: torch.Tensor):
    """N consecutive ticks (``pipeline.py:468-502``): points [N,K,P,3],
    valids [N,K,P], transforms [N,K,4,4], cur_positions [N,3].  Returns
    the final state and UpdateStats with each field stacked to [N].  The
    caller gives up ``state`` (see ``integrate_scan_batch``)."""
    per_tick = []
    for i in range(points.shape[0]):
        state, stats = fused_batch_step(cfg, state, points[i], valids[i],
                                        transforms[i], cur_positions[i])
        per_tick.append(stats)
    return state, UpdateStats(*(torch.stack(f) for f in zip(*per_tick)))
