"""Debug validators (port of ``fiesta_tpu/debug.py``, reference component
C20, behind #ifdef DEBUG).

The reference ships two oracles inside the library:

  * CheckConsistency (src/ESDFMap.cpp:856-902): structural invariants of the
    doubly-linked-list bookkeeping.  The dense design has no linked lists;
    the equivalent invariants are (SURVEY.md section 7):
      - every defined ``closest`` points at an occupied voxel;
      - ``d2`` equals |v - closest|^2 exactly;
      - occupied voxels are their own closest obstacle with d2 == 0.
  * CheckWithGroundTruth (src/ESDFMap.cpp:905-1054): exact nearest-neighbor
    distances (an exact EDT here, scipy's) with a signed-error histogram
    in 0.1-wide buckets.

Both run in numpy on arrays copied from the state's device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .config import FiestaConfig
from .grid import INF_D2, MapState, occupied_grid
from .ops.edt import trunc_vox_for
from .pipeline import rebuild_tracks_closest


def check_consistency(cfg: FiestaConfig, state: MapState,
                      closest=None) -> bool:
    """Structural invariant check; raises AssertionError with detail on
    failure, returns True otherwise.

    Applies to incremental mode and the rebuild mode, which maintains
    ``closest`` with the packed-argmin EDT.  With the two-level EDT
    (``edt_fine_dist < trunc_dist``) the far field's closest coordinates
    are coarse-quantized by design (snapped to the even corner of the
    winning 2x2x2 block): the exact invariants hold on the fine field
    only, and the far field is checked against the quantization envelope
    (|v-c|^2 within 2*sqrt(3*d2)+3 of d2; occupancy checked at block
    granularity).

    ``closest``: the grid to validate against (pass
    ``pipe.closest_grid()`` in lazy closest mode, where ``state.closest``
    is intentionally stale between derives).  Defaults to
    ``state.closest``; with the default under ``cfg.lazy_closest`` only
    the closest-free invariants are checked.
    """
    d2 = state.d2.cpu().numpy()
    closest_stale = closest is None and cfg.lazy_closest
    closest = (state.closest if closest is None else closest).cpu().numpy()
    if closest.ndim == 3:
        # packed rebuild format (grid.closest_packed_state): decode to
        # planes for the invariants below
        defined_p = closest >= 0
        closest = np.stack([
            np.where(defined_p, closest >> 20, -1),
            np.where(defined_p, (closest >> 10) & 1023, -1),
            np.where(defined_p, closest & 1023, -1),
        ]).astype(np.int64)
    occ = occupied_grid(cfg, state.logodds).cpu().numpy()

    if (cfg.esdf_mode == "rebuild"
            and (not rebuild_tracks_closest(cfg) or closest_stale)):
        # closest is intentionally stale on this config (track_closest off,
        # no closest engine fits, or lazy mode with no derived grid
        # passed); only the closest-free invariant holds
        if occ.any() and not np.all(d2[occ] == 0):
            raise AssertionError("occupied voxel with nonzero distance")
        return True

    defined = closest[0] >= 0
    if not np.all((d2 < int(INF_D2)) == defined):
        raise AssertionError("d2 finiteness disagrees with closest definedness")

    t_fine = trunc_vox_for(cfg.resolution, cfg.edt_fine_dist)
    t_total = trunc_vox_for(cfg.resolution, cfg.trunc_dist)
    hier = (cfg.esdf_mode == "rebuild" and t_fine < t_total
            and all(g % 2 == 0 for g in cfg.grid_shape))
    if hier:
        # coarse far-field values can quantize below t_fine^2 near the
        # boundary; shrink the strict set by the quantization envelope so
        # only guaranteed-fine voxels face the exact invariants
        strict_cut = max(
            0, t_fine * t_fine
            - int(np.ceil(2 * np.sqrt(3) * t_fine)) - 3)
        exact = defined & (d2 <= strict_cut)
    else:
        exact = defined

    if exact.any():
        cx, cy, cz = (c[exact] for c in closest)
        if not occ[cx, cy, cz].all():
            raise AssertionError("closest obstacle not occupied")
        vx, vy, vz = np.nonzero(exact)
        want = (vx - cx) ** 2 + (vy - cy) ** 2 + (vz - cz) ** 2
        if not np.array_equal(d2[exact], want):
            raise AssertionError("d2 != |v - closest|^2")
    far = defined & ~exact
    if far.any():
        cx, cy, cz = (c[far].astype(np.int64) for c in closest)
        occ_blk = occ.reshape(occ.shape[0] // 2, 2, occ.shape[1] // 2, 2,
                              occ.shape[2] // 2, 2).any(axis=(1, 3, 5))
        if not occ_blk[cx // 2, cy // 2, cz // 2].all():
            raise AssertionError(
                "far-field closest outside an occupied coarse block")
        vx, vy, vz = np.nonzero(far)
        got = ((vx - cx) ** 2 + (vy - cy) ** 2
               + (vz - cz) ** 2).astype(np.float64)
        tol = 2.0 * np.sqrt(3.0 * d2[far]) + 3.0
        if not np.all(np.abs(got - d2[far]) <= tol):
            raise AssertionError(
                "far-field |v - closest|^2 outside the coarse "
                "quantization envelope")
    if occ.any() and not np.all(d2[occ] == 0):
        raise AssertionError("occupied voxel with nonzero distance")
    return True


def check_with_ground_truth(
    cfg: FiestaConfig, state: MapState, n_buckets: int = 32
) -> Dict[str, object]:
    """Signed-error statistics vs exact nearest-neighbor distances.

    Mirrors the reference's report (ESDFMap.cpp:940-978): counts of
    over/under-estimates beyond 1e-3, mean/RMS signed error, max error, and
    a histogram of overestimates in 0.1 m buckets.
    """
    from scipy import ndimage

    occ = occupied_grid(cfg, state.logodds).cpu().numpy()
    d2 = state.d2.cpu().numpy()
    seen = state.seen.cpu().numpy().astype(bool)
    known = seen & (d2 < int(INF_D2))

    out: Dict[str, object] = {"num_known": int(known.sum())}
    if not occ.any() or not known.any():
        out.update(count_over=0, count_under=0, mean_error=0.0,
                   rms_error=0.0, max_abs_error=0.0, max_over=0.0,
                   max_under=0.0, histogram=[0] * n_buckets)
        return out

    truth = ndimage.distance_transform_edt(~occ) * cfg.resolution
    ours = np.sqrt(d2[known].astype(np.float64)) * cfg.resolution
    err = ours - truth[known]

    over = err > 1e-3
    under = err < -1e-3
    hist = np.bincount(
        np.minimum((err[over] / 0.1).astype(np.int64), n_buckets - 1),
        minlength=n_buckets,
    ).tolist()
    out.update(
        count_over=int(over.sum()),
        count_under=int(under.sum()),
        mean_error=float(err.mean()),
        rms_error=float(np.sqrt((err**2).mean())),
        # worst error per direction: max_over is the reference's
        # overestimate statistic (ESDFMap.cpp:940-978); max_under the
        # unsafe direction (less clearance than reality), which a signed
        # max would hide; max_abs_error the larger of the two
        max_abs_error=float(np.abs(err).max()),
        max_over=float(err[over].max()) if over.any() else 0.0,
        max_under=float(-err[under].min()) if under.any() else 0.0,
        histogram=hist,
    )
    return out
