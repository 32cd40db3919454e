#!/usr/bin/env python3
"""Benchmark: cow_and_lady-scale streaming ESDF on one CUDA card
(fiesta_tpu_torch; the twin of ``bench.py``).

    python3 bench_torch.py [--platform cpu]

The reference times depth conversion, raycast + fusion and UpdateESDF on
the cow_and_lady dataset (0.05 m, 20x20x4 m = 12.8 M voxels) against a
10 Hz budget (100 ms an update batch, launch/cow_and_lady.launch:6).  The
replay world stands in for the dataset at the same scale: 192x256 scans
at 30 Hz from ``make_sequence(n_frames=49, n_boxes=20, seed=0)``, an ESDF
update every third scan.

Four warm batches go through ``fused_batch_step`` (the map settles and
every kernel is built and launched once); the remaining twelve go once
through ``fused_batch_step`` a call on the host clock with one
synchronise at the end (``dispatch_ms_per_batch``, a diagnostic), then
through ``fused_stream`` once untimed and three times timed, each run
continuing from the last state, as ``bench.py`` sequences them.  The
metric is the median of the three streams in milliseconds a batch (3
scans integrated, occupancy fused, exact truncated EDT), from CUDA events
around each stream; ``vs_baseline`` = 100 ms / that.  Fails on a map with
1000 occupied voxels or fewer, as ``bench.py`` does.

Prints one JSON line on stdout; diagnostics go to stderr.
"""

import statistics
import sys
import time

import fiesta_tpu_torch as ft
from fiesta_tpu_torch import benchtools as bt
from fiesta_tpu_torch.io import replay

H, W = 192, 256
N_FRAMES = 49
WARM_BATCHES = 4
REPS = 3
MIN_OCCUPIED = 1000      # bench.py:184
BUDGET_MS = 100.0        # the reference's 10 Hz update budget


def measure(cfg, frames, dev, warm_batches=WARM_BATCHES, reps=REPS,
            min_occupied=MIN_OCCUPIED):
    """The cow tick on ``dev``: ``frames`` staged in batches of three,
    ``warm_batches`` ticks, the rest a tick a call, then once untimed and
    ``reps`` times timed through ``fused_stream``.  Returns (the JSON
    line's fields, the final state)."""
    t0 = time.perf_counter()
    pts, vals, tfs, pos = replay.stage_update_batches(cfg, frames,
                                                      device=dev)
    n_total = pts.shape[0]
    bt.log(f"staged {n_total} batches in {time.perf_counter() - t0:.1f} s")
    use_window = not cfg.global_update
    state = ft.make_state(cfg, dev)
    for i in range(warm_batches):
        ti = time.perf_counter()
        state, stats = ft.fused_batch_step(
            cfg, state, pts[i], vals[i], tfs[i], pos[i],
            use_window=use_window, method="scanline")
        bt.sync(dev)
        bt.log(f"warm batch {i}: {time.perf_counter() - ti:.2f} s "
               f"observed={int(stats.num_observed)} "
               f"inserted={int(stats.num_inserted)}")
    n_occ = int(ft.occupied_grid(cfg, state.logodds).sum())
    bt.log(f"warmup done; map occupied voxels: {n_occ}")
    if n_occ <= min_occupied:
        raise AssertionError(
            f"benchmark scene mapped only {n_occ} occupied voxels: not a "
            "representative benchmark; fix the replay world")

    stream = tuple(a[warm_batches:] for a in (pts, vals, tfs, pos))
    n = stream[0].shape[0]

    def dispatch(st):
        for i in range(n):
            st, _ = ft.fused_batch_step(cfg, st, *(a[i] for a in stream),
                                        use_window=use_window,
                                        method="scanline")
        return st

    # per-dispatch stream (diagnostic): one tick a call, one synchronise
    # at the end, on the host clock
    bt.sync(dev)
    t0 = time.perf_counter()
    state = dispatch(state)
    bt.sync(dev)
    dispatch_ms = 1e3 * (time.perf_counter() - t0) / n
    bt.log(f"per-dispatch stream: {n} batches -> {dispatch_ms:.3f} ms a "
           "batch")

    def run(st):
        return ft.fused_stream(cfg, st, *stream, use_window=use_window,
                               method="scanline")

    state, _ = run(state)
    rep_ms = []
    for _ in range(reps):
        (state, stats), ms = bt.timed(lambda st=state: run(st), dev)
        rep_ms.append(ms / n)
    batch_ms = statistics.median(rep_ms)
    bt.log(f"steady stream: {n} update batches (3 scans each), reps "
           f"{rep_ms} ms a batch -> {batch_ms:.3f} ms a batch, "
           f"{batch_ms / 3:.3f} ms a frame (last tick observed="
           f"{int(stats.num_observed[-1])})")
    return {
        "metric": "esdf_update_batch_ms_cow_and_lady_scale",
        "value": batch_ms,
        "unit": "ms",
        "vs_baseline": BUDGET_MS / batch_ms,
        "dispatch_ms_per_batch": dispatch_ms,
        "rep_ms_per_batch": rep_ms,
        "rep_spread_ms": [min(rep_ms), max(rep_ms)],
        "reps_used": reps,
    }, state


def main(argv=None):
    args = bt.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = bt.device(args.platform, "bench_torch.py")
    card = bt.describe(dev)
    cfg = bt.cow_config(H, W)
    bt.log(f"device: {card}; grid {cfg.grid_shape} = "
           f"{cfg.num_voxels / 1e6:.1f} M voxels, res {cfg.resolution} m, "
           f"scan {H}x{W} = {H * W} rays")
    t0 = time.perf_counter()
    frames = bt.replay_frames(cfg, N_FRAMES, H, W)
    bt.log(f"rendered {len(frames)} frames in "
           f"{time.perf_counter() - t0:.1f} s")
    line, _ = measure(cfg, frames, dev)
    bt.emit({**line, "device": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
