"""Probabilistic occupancy fusion (port of ``fiesta_tpu/ops/fusion.py``).

Reference semantics (src/ESDFMap.cpp:235-271, 401-450): each queued voxel
(``miss_cnt > 0``) applies ONE clamped log-odds step, a hit iff
``2*hit >= miss``; occupancy flips count as inserts/deletes.

``fuse_drain`` is the one-pass drain of the rebuild tick
(``ops/pallas/fuse.py:fuse_counts_pallas``): it returns the u8 occupancy
and only the counts of the flips.  A CUDA tensor takes the ``fuse`` kernel
(``kernels/fuse.cu``), a CPU tensor the plain version here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels


def _fuse_drain_plain(logodds, seen, hit_cnt, miss_cnt, *, l_hit, l_miss,
                      clamp_min, clamp_max, occ_thresh, occ_is_eq):
    """Plain version of the one-pass drain, with the arithmetic of
    ``fuse_counts_pallas``'s kernel body."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    thr = f32(occ_thresh)

    def occ_of(lo):
        return (lo == thr) if occ_is_eq else (lo > thr)

    miss32 = miss_cnt.to(torch.int32)
    obs = miss32 > 0
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
    """Drain the counters in one pass, global update (the contract of
    ``fuse_counts_pallas``).  Returns (new_logodds f32, new_seen u8, occ
    u8, hit_zeroed u8, miss_zeroed u8, n_observed, n_inserted, n_deleted);
    ``occ_is_eq`` selects deterministic mode's ``logodds == occ_thresh``
    over ``>``.  Every output is a new tensor and the inputs are left as
    they are (the JAX kernel aliases them in place).  CUDA tensor: the
    ``fuse`` kernel; CPU: the plain version.  ``window`` / ``x_offset``
    (local-update mode) are not ported yet and raise."""
    if window is not None or x_offset is not None:
        raise NotImplementedError(
            "the windowed fusion drain comes with window mode, which this "
            "port does not have yet")
    args = dict(l_hit=l_hit, l_miss=l_miss, clamp_min=clamp_min,
                clamp_max=clamp_max, occ_thresh=occ_thresh,
                occ_is_eq=occ_is_eq)
    if logodds.is_cuda:
        return kernels.fuse(logodds, seen, hit_cnt, miss_cnt, **args)
    return _fuse_drain_plain(logodds, seen, hit_cnt, miss_cnt, **args)
