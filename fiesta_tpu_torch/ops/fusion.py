"""Probabilistic occupancy fusion (port of ``fiesta_tpu/ops/fusion.py``).

Reference semantics (src/ESDFMap.cpp:235-271, 401-450): each queued voxel
(``miss_cnt > 0``) applies ONE clamped log-odds step, a hit iff
``2*hit >= miss``; occupancy flips count as inserts/deletes.

``fuse_counts`` is the drain with its insert/delete masks, which the
incremental engine consumes (``fusion.py:37``), and
``set_occupancy_direct`` the deterministic direct write (``fusion.py:82``);
both are plain PyTorch, as in the JAX package.

``fuse_drain`` is the one-pass drain of the rebuild tick
(``ops/pallas/fuse.py:fuse_counts_pallas``): it returns the u8 occupancy
and only the counts of the flips.  In local-update mode an inclusive voxel
window drops the observations outside it (the semantics of
``fusion.fuse_counts`` with a window mask); the same pass applies it.  A
CUDA tensor takes the ``fuse`` kernel (``kernels/fuse.cu``), a CPU tensor
the plain version here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..config import FiestaConfig
from ..grid import occupied_grid, vox_in_grid, vox_to_idx


def _f32(v: float) -> float:
    """``v`` rounded to f32 (as a JAX weak-typed scalar meets an f32
    array)."""
    return float(np.float32(v))


class FusionResult(NamedTuple):
    logodds: torch.Tensor       # updated log-odds
    seen: torch.Tensor          # updated observed mask (u8)
    occupied: torch.Tensor      # occupancy AFTER the update (bool)
    insert_mask: torch.Tensor   # flipped free -> occupied (insert_queue_)
    delete_mask: torch.Tensor   # flipped occupied -> free (delete_queue_)
    num_observed: torch.Tensor  # queued-voxel count, 0-dim i32


def fuse_counts(cfg: FiestaConfig, logodds: torch.Tensor, seen: torch.Tensor,
                hit_cnt: torch.Tensor, miss_cnt: torch.Tensor,
                window_mask=None) -> FusionResult:
    """Drain the observation counters into log-odds (UpdateOccupancy,
    ``fusion.py:37-79``): each voxel with ``miss_cnt > 0`` (inside
    ``window_mask`` [X,Y,Z] bool when given) takes one clamped log-odds
    step, a hit iff ``2*hit >= miss``.  The counters are left as they
    are; the caller zeroes them."""
    observed = miss_cnt > 0
    if window_mask is not None:
        observed = observed & window_mask
    is_hit = 2 * hit_cnt.to(torch.int32) >= miss_cnt.to(torch.int32)
    step = torch.where(is_hit, _f32(cfg.prob_hit_log),
                       _f32(cfg.prob_miss_log))
    occ_before = occupied_grid(cfg, logodds)
    new_lo = torch.clamp(logodds + step, _f32(cfg.clamp_min_log),
                         _f32(cfg.clamp_max_log))
    new_lo = torch.where(observed, new_lo, logodds)
    occ_after = occupied_grid(cfg, new_lo)
    return FusionResult(
        logodds=new_lo, seen=seen | observed.to(seen.dtype),
        occupied=occ_after, insert_mask=occ_after & ~occ_before,
        delete_mask=~occ_after & occ_before,
        num_observed=observed.sum(dtype=torch.int32))


def set_occupancy_direct(cfg: FiestaConfig, logodds: torch.Tensor,
                         vox: torch.Tensor, occ: torch.Tensor):
    """Deterministic direct occupancy write (the ``#ifndef PROBABILISTIC``
    branch of SetOccupancy, ESDFMap.cpp:438-450; ``fusion.py:82-126``):
    voxels ``vox`` [N,3] take ``occ`` [N] in {0,1}, the later of duplicate
    writes winning and writes outside the grid dropped.  Returns
    (new_logodds, insert_mask, delete_mask)."""
    n = logodds.numel()
    lin = torch.where(vox_in_grid(cfg, vox), vox_to_idx(cfg, vox), n)
    # later writes win: the max of (write order, occ) packed, so the
    # latest write decides; slot n takes the dropped writes
    order = torch.arange(occ.shape[0], dtype=torch.int32,
                         device=logodds.device)
    packed = torch.full((n + 1,), -1, dtype=torch.int32,
                        device=logodds.device).scatter_reduce_(
        0, lin.to(torch.int64), order * 2 + occ.to(torch.int32), "amax")[:n]
    if cfg.probabilistic:
        on, off = cfg.clamp_max_log, cfg.clamp_min_log
    else:
        on, off = 1.0, 0.0
    written = torch.where((packed & 1) == 1, _f32(on), _f32(off))
    new_lo = torch.where(packed >= 0, written,
                         logodds.reshape(-1)).reshape(logodds.shape)
    occ_before = occupied_grid(cfg, logodds)
    occ_after = occupied_grid(cfg, new_lo)
    return new_lo, occ_after & ~occ_before, ~occ_after & occ_before


def _in_window(shape, window, device) -> torch.Tensor:
    """Dense bool mask of the inclusive window (wmin [3], wmax [3])."""
    wmin, wmax = window
    m = [(c >= wmin[j]) & (c <= wmax[j]) for j, c in enumerate(
        torch.arange(g, dtype=torch.int32, device=device) for g in shape)]
    return m[0][:, None, None] & m[1][None, :, None] & m[2][None, None, :]


def _slab_window(window, x_offset):
    """A global window in the frame of an X-slab whose first plane is
    global x ``x_offset`` (``fuse.py:181-182``)."""
    if x_offset is None or window is None:
        return window
    shift = torch.zeros(3, dtype=torch.int32, device=window[0].device)
    shift[0] = int(x_offset)
    return tuple(w.reshape(3).to(torch.int32) - shift for w in window)


def _fuse_drain_plain(logodds, seen, hit_cnt, miss_cnt, *, l_hit, l_miss,
                      clamp_min, clamp_max, occ_thresh, occ_is_eq,
                      window=None):
    """Plain version of the one-pass drain, with the arithmetic of
    ``fuse_counts_pallas``'s kernel body."""
    thr = _f32(occ_thresh)

    def occ_of(lo):
        return (lo == thr) if occ_is_eq else (lo > thr)

    miss32 = miss_cnt.to(torch.int32)
    obs = miss32 > 0
    if window is not None:
        obs = obs & _in_window(logodds.shape, window, logodds.device)
    is_hit = 2 * hit_cnt.to(torch.int32) >= miss32
    step = torch.where(is_hit, _f32(l_hit), _f32(l_miss))
    new = torch.clamp(logodds + step, _f32(clamp_min), _f32(clamp_max))
    new = torch.where(obs, new, logodds)
    occ_b, occ_a = occ_of(logodds), occ_of(new)
    return (new, seen | obs.to(seen.dtype), occ_a.to(torch.uint8),
            torch.zeros_like(hit_cnt), torch.zeros_like(miss_cnt),
            obs.sum(dtype=torch.int32),
            (occ_a & ~occ_b).sum(dtype=torch.int32),
            (~occ_a & occ_b).sum(dtype=torch.int32))


def fuse_drain(logodds, seen, hit_cnt, miss_cnt, *, l_hit, l_miss,
               clamp_min, clamp_max, occ_thresh, occ_is_eq, window=None,
               x_offset=None):
    """Drain the counters in one pass (the contract of
    ``fuse_counts_pallas``).  Returns (new_logodds f32, new_seen u8, occ
    u8, hit_zeroed u8, miss_zeroed u8, n_observed, n_inserted, n_deleted);
    ``occ_is_eq`` selects deterministic mode's ``logodds == occ_thresh``
    over ``>``.  ``window`` (wmin [3] i32, wmax [3] i32 on the inputs'
    device, inclusive voxel bounds): observations outside it are dropped
    and every counter is still zeroed.  Every output is a new tensor and
    the inputs are left as they are (the JAX kernel aliases them in
    place).  CUDA tensor: the ``fuse`` kernel; CPU: the plain version.
    ``x_offset``: the inputs are an X-slab whose first plane is global x
    ``x_offset`` and ``window`` is in global voxels; the window shifts by
    -x_offset into the slab (``fuse.py:181-182``)."""
    window = _slab_window(window, x_offset)
    args = dict(l_hit=l_hit, l_miss=l_miss, clamp_min=clamp_min,
                clamp_max=clamp_max, occ_thresh=occ_thresh,
                occ_is_eq=occ_is_eq, window=window)
    if logodds.is_cuda:
        return kernels.fuse(logodds, seen, hit_cnt, miss_cnt, **args)
    return _fuse_drain_plain(logodds, seen, hit_cnt, miss_cnt, **args)
