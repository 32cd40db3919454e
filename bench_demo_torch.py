#!/usr/bin/env python3
"""Benchmark: the demo (onboard) preset, depth images and local-window
updates, on one CUDA card (fiesta_tpu_torch; the twin of
``bench_demo.py``).

    python3 bench_demo_torch.py [--platform cpu]

The reference's second launch config (launch/demo.launch): 0.1 m over
40x40x3.6 m (400x400x36 = 5.76 M voxels), depth images with the temporal
consistency filter, ESDF updates in a 6x6x3 m box around the robot, 10 Hz.
The tick is ``fused_depth_stream``'s: back-projection, filter, carve,
fusion and exact truncated EDT, in the local window (``global_update`` is
off).  49 replayed depth frames of 120x160 make 16 ticks of three; the
stream runs once untimed from an empty map, then once timed from where it
left the map (CUDA events), ``bench_demo.py``'s protocol.  Fails on an
empty map.

Prints one JSON line on stdout; diagnostics go to stderr.
"""

import sys
import time

import fiesta_tpu_torch as ft
from fiesta_tpu_torch import benchtools as bt

H, W = 120, 160
N_FRAMES = 49
BUDGET_MS = 100.0


def measure(cfg, frames, dev):
    """The demo depth tick on ``dev``: the frames' ticks streamed twice,
    the second timed.  Returns (the JSON line's fields, the final
    state)."""
    depths, tfs, poss = bt.stage_depth_ticks(frames, dev)
    n = depths.shape[0]
    use_window = not cfg.global_update

    def stream(state):
        return ft.fused_depth_stream(cfg, state, depths, tfs, poss,
                                     use_window=use_window)

    t0 = time.perf_counter()
    st, stats = stream(ft.make_state(cfg, dev))
    bt.sync(dev)
    bt.log(f"build + first stream: {time.perf_counter() - t0:.1f} s "
           f"(last tick observed={int(stats.num_observed[-1])})")
    (st, stats), ms = bt.timed(lambda: stream(st), dev)
    batch_ms = ms / n
    n_occ = int(ft.occupied_grid(cfg, st.logodds).sum())
    bt.log(f"map occupied voxels: {n_occ}")
    if n_occ <= 0:
        raise AssertionError("benchmark scene mapped an empty world")
    bt.log(f"steady: {n} depth-mode ticks -> {batch_ms:.3f} ms a batch, "
           f"{batch_ms / 3:.3f} ms a frame")
    return {
        "metric": "esdf_update_batch_ms_demo_depth_window",
        "value": batch_ms,
        "unit": "ms",
        "vs_baseline": BUDGET_MS / batch_ms,
    }, st


def main(argv=None):
    args = bt.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = bt.device(args.platform, "bench_demo_torch.py")
    card = bt.describe(dev)
    cfg = bt.demo_config(H, W)
    bt.log(f"device: {card}; grid {cfg.grid_shape} = "
           f"{cfg.num_voxels / 1e6:.2f} M voxels, res {cfg.resolution} m, "
           f"depth {H}x{W}, window radius {cfg.radius}")
    frames = bt.replay_frames(cfg, N_FRAMES, H, W, kind="depth")
    line, _ = measure(cfg, frames, dev)
    bt.emit({**line, "device": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
