"""Probabilistic occupancy fusion (port of ``fiesta_tpu/ops/fusion.py``).

Reference semantics (src/ESDFMap.cpp:235-271, 401-450): each queued voxel
(``miss_cnt > 0``) applies ONE clamped log-odds step, a hit iff
``2*hit >= miss``; occupancy flips count as inserts/deletes.

``fuse_drain`` is the one-pass drain of the rebuild tick
(``ops/pallas/fuse.py:fuse_counts_pallas``): it returns the u8 occupancy
and only the counts of the flips.  In local-update mode an inclusive voxel
window drops the observations outside it (the semantics of
``fusion.fuse_counts`` with a window mask); the same pass applies it.  A
CUDA tensor takes the ``fuse`` kernel (``kernels/fuse.cu``), a CPU tensor
the plain version here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels


def _in_window(shape, window, device) -> torch.Tensor:
    """Dense bool mask of the inclusive window (wmin [3], wmax [3])."""
    wmin, wmax = window
    m = [(c >= wmin[j]) & (c <= wmax[j]) for j, c in enumerate(
        torch.arange(g, dtype=torch.int32, device=device) for g in shape)]
    return m[0][:, None, None] & m[1][None, :, None] & m[2][None, None, :]


def _fuse_drain_plain(logodds, seen, hit_cnt, miss_cnt, *, l_hit, l_miss,
                      clamp_min, clamp_max, occ_thresh, occ_is_eq,
                      window=None):
    """Plain version of the one-pass drain, with the arithmetic of
    ``fuse_counts_pallas``'s kernel body."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    thr = f32(occ_thresh)

    def occ_of(lo):
        return (lo == thr) if occ_is_eq else (lo > thr)

    miss32 = miss_cnt.to(torch.int32)
    obs = miss32 > 0
    if window is not None:
        obs = obs & _in_window(logodds.shape, window, logodds.device)
    is_hit = 2 * hit_cnt.to(torch.int32) >= miss32
    step = torch.where(is_hit, f32(l_hit), f32(l_miss))
    new = torch.clamp(logodds + step, f32(clamp_min), f32(clamp_max))
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
    ``x_offset`` (a shard's slab origin) comes with the multi-GPU port and
    raises."""
    if x_offset is not None:
        raise NotImplementedError(
            "x_offset places a shard's slab in the global window; the "
            "multi-GPU engine that passes it is not ported yet")
    args = dict(l_hit=l_hit, l_miss=l_miss, clamp_min=clamp_min,
                clamp_max=clamp_max, occ_thresh=occ_thresh,
                occ_is_eq=occ_is_eq, window=window)
    if logodds.is_cuda:
        return kernels.fuse(logodds, seen, hit_cnt, miss_cnt, **args)
    return _fuse_drain_plain(logodds, seen, hit_cnt, miss_cnt, **args)
