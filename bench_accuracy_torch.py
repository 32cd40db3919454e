#!/usr/bin/env python3
"""Accuracy benchmark: the reference algorithm and fiesta_tpu_torch's EDT
against the exact EDT (the twin of ``bench_accuracy.py``).

    python3 bench_accuracy_torch.py [--platform cpu] [--frames N]

The reference's own accuracy oracle (CheckWithGroundTruth,
src/ESDFMap.cpp:905-1054: signed error per voxel against the exact
nearest-obstacle distance, flagged above 1e-3, in 0.1 m buckets) over one
streamed occupancy on three engines:

  * the reference algorithm (``native/fiesta_core.cpp`` through
    ``fiesta_tpu_torch.native``: queue-based incremental 24-neighbour
    BFS, the semantics of src/ESDFMap.cpp:273-398), fed each tick's
    occupancy flips;
  * fiesta_tpu_torch's EDT on the card (``truncated_edt_d2``, exact
    within trunc_dist, or ``hierarchical_edt_d2`` where edt_fine_dist <
    trunc_dist on even dimensions, as the tick dispatches);
  * scipy's ``distance_transform_edt``, the ground truth.

The stream is the cow_and_lady replay's first 26 frames (``--frames``),
8 ticks of three scans through ``integrate_scan_batch`` and
``fusion.fuse_counts``.
Errors are reported over the voxels whose true distance is within
edt_fine_dist and within trunc_dist.  Four statements are checked: the
port's EDT is exact within edt_fine_dist and truncates no voxel there,
stays within one coarse voxel in the full domain, and the reference BFS
never underestimates.

Prints one JSON line: the port's rms error (m) over the full domain, with
``vs_baseline`` = reference rms / port rms (above 1: the port is the more
accurate); diagnostics go to stderr.
"""

import sys

import numpy as np

import fiesta_tpu_torch as ft
from fiesta_tpu_torch import benchtools as bt
from fiesta_tpu_torch import native
from fiesta_tpu_torch.ops import edt

H, W = 192, 256
N_FRAMES = 26


def error_report(name, dist_m, exact_m, domain, res):
    """The reference oracle's stats (ESDFMap.cpp:955-1058): signed error
    over ``domain``, 0.1-bucket histogram of |error| above 1e-3."""
    err = dist_m[domain] - exact_m[domain]
    inf_mask = ~np.isfinite(dist_m[domain])
    n_inf = int(inf_mask.sum())
    err = err[~inf_mask]
    hist, _ = np.histogram(
        np.abs(err), bins=[1e-3] + [0.1 * k for k in range(1, 11)] + [1e9])
    rep = {
        "engine": name,
        "n": int(err.size),
        "n_unreachable": n_inf,
        "rms": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(err.mean()),
        "max": float(err.max()),
        "min": float(err.min()),
        "frac_within_res": float(np.mean(np.abs(err) <= res + 1e-6)),
        "hist_0.1_buckets": hist.tolist(),
    }
    bt.log(f"{name:<28s} rms={rep['rms']:.4f} m  mean={rep['mean']:.4f}  "
           f"max={rep['max']:.3f}  min={rep['min']:.3f}  "
           f"<=res: {100 * rep['frac_within_res']:.2f}%  "
           f"unreachable={n_inf}")
    return rep


def stream_flips(cfg, frames, dev, core):
    """Stream ``frames`` in ticks of three on ``dev``, feeding each tick's
    insert/delete flips to the C++ core ``core`` and updating it.  Returns
    the final occupancy [X,Y,Z] bool on ``dev``."""
    for i, (vox, flags, state) in enumerate(
            bt.occupancy_flips(cfg, frames, dev)):
        if len(vox):
            core.set_occupancy(vox, flags)
            core.update()
        bt.log(f"batch {i + 1}: +{int(flags.sum())} obstacles, "
               f"-{int((flags == 0).sum())}")
    return ft.occupied_grid(cfg, state.logodds)


def port_d2(cfg, occupied):
    """The port's EDT of ``occupied``, dispatched as the rebuild tick
    dispatches it (``bench_accuracy.py:149-154``)."""
    t_total = edt.trunc_vox_for(cfg.resolution, cfg.trunc_dist)
    t_fine = edt.trunc_vox_for(cfg.resolution, cfg.edt_fine_dist)
    if t_fine < t_total and all(g % 2 == 0 for g in cfg.grid_shape):
        return edt.hierarchical_edt_d2(occupied, t_fine, t_total)
    return edt.truncated_edt_d2(occupied, t_total)


def measure(cfg, frames, dev):
    """The three engines on ``frames``' stream.  Returns the JSON line's
    fields with the contract's numbers under ``checks``; raises
    AssertionError where the contract fails."""
    from scipy import ndimage

    core = native.NativeEsdf(cfg.grid_shape)
    occupied = stream_flips(cfg, frames, dev, core)
    occ = occupied.cpu().numpy()
    n_occ = int(occ.sum())
    bt.log(f"{n_occ} occupied voxels")
    if n_occ <= 0:
        raise AssertionError("the stream mapped an empty world")
    res = cfg.resolution
    exact_m = ndimage.distance_transform_edt(~occ) * res
    ref_d2 = core.dist2().astype(np.float64)
    ref_m = np.where(ref_d2 < 0, np.inf, np.sqrt(np.maximum(ref_d2, 0)) * res)
    d2 = port_d2(cfg, occupied).cpu().numpy().astype(np.float64)
    port_m = np.where(d2 >= float(ft.INF_D2), np.inf, np.sqrt(d2) * res)

    reports = {}
    for dom, lim in (("fine", cfg.edt_fine_dist), ("full", cfg.trunc_dist)):
        domain = exact_m <= lim
        bt.log(f"--- domain {dom} (true distance <= {lim} m: "
               f"{int(domain.sum())} voxels) ---")
        reports[dom] = {
            "reference": error_report("reference queue-BFS (native)",
                                      ref_m, exact_m, domain, res),
            "port": error_report("fiesta_tpu_torch EDT rebuild", port_m,
                                 exact_m, domain, res),
        }
    fine, full = reports["fine"], reports["full"]
    coarse_bound = 2 * res * np.sqrt(3)
    checks = {
        "fine_unreachable": fine["port"]["n_unreachable"],
        "fine_max_err_m": fine["port"]["max"],
        "fine_min_err_m": fine["port"]["min"],
        "full_max_err_m": full["port"]["max"],
        "coarse_bound_m": coarse_bound,
        "reference_min_err_m": full["reference"]["min"],
    }
    # the contract (bench_accuracy.py:177-184); n_unreachable == 0 matters:
    # a voxel wrongly truncated inside the exact radius would drop out of
    # the error stats and the max/min checks
    assert checks["fine_unreachable"] == 0, \
        "the port's EDT truncated a voxel inside edt_fine_dist"
    assert (checks["fine_max_err_m"] <= 1e-6
            and checks["fine_min_err_m"] >= -1e-6), \
        "the port's EDT must be exact within edt_fine_dist"
    assert checks["full_max_err_m"] <= coarse_bound + 1e-6, \
        "the port's coarse-level error must stay within one coarse voxel"
    assert checks["reference_min_err_m"] >= -1e-6, \
        "the reference BFS never underestimates"
    port_rms, ref_rms = full["port"]["rms"], full["reference"]["rms"]
    return {
        "metric": "esdf_rms_error_m_vs_exact",
        "value": port_rms,
        "unit": "m",
        "vs_baseline": max(ref_rms, 1e-6) / max(port_rms, 1e-6),
        "reference_rms_m": ref_rms,
        "checks": checks,
    }


def main(argv=None):
    ap = bt.parser(__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=N_FRAMES,
                    help="replayed frames, three a tick (default: "
                         "bench_accuracy.py's 26)")
    args = ap.parse_args(argv)
    dev = bt.device(args.platform, "bench_accuracy_torch.py")
    card = bt.describe(dev)
    bt.log(f"device: {card}")
    cfg = bt.cow_config(H, W)
    frames = bt.replay_frames(cfg, args.frames, H, W)
    line = measure(cfg, frames, dev)
    bt.emit({**line, "device": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
