#!/usr/bin/env python3
"""End-to-end benchmark on one CUDA card, perception to control
(fiesta_tpu_torch; the twin of ``bench_e2e.py``).

    python3 bench_e2e_torch.py [--platform cpu]

The robotics loop the reference system and an external planner run every
control period: integrate the new scans (carve and endpoint fusion),
rebuild the exact truncated ESDF, derive the planner's distance grid and
solve a receding-horizon MPC (16384 MPPI rollouts, horizon 30, gradient
refinement), then execute the first control.  On the cow_and_lady replay
(``bench.py``'s 49 frames in batches of three), four warm ticks settle
the map, and the other twelve batches are each one period:
``fused_batch_step``, ``distance_grid``, ``_plan_step_impl`` on normals
drawn from a ``torch.Generator`` on the device (seeded 0 at each stream's
start), the executed control and ``shift_nominal``.  The periods run in a
Python loop with no host wait inside a stream (the JAX benchmark's
``lax.scan`` has no counterpart here).  Each stream starts from a copy
of the warm map, made outside its timed window; the first is untimed,
the metric is the median of the next three (CUDA events), in ms a period;
``vs_baseline`` = 100 ms / that (the reference's 10 Hz cadence).

Prints one JSON line on stdout; diagnostics go to stderr.
"""

import statistics
import sys
import time

import numpy as np
import torch

import fiesta_tpu_torch as ft
from fiesta_tpu_torch import benchtools as bt
from fiesta_tpu_torch.io import replay
from fiesta_tpu_torch.ops.query import distance_grid
from fiesta_tpu_torch.planning import mpc

H, W = 192, 256
N_FRAMES = 49
WARM_BATCHES = 4
REPS = 3
BUDGET_MS = 100.0


def periods(cfg, m, state, batches, p0, v0, goal, normals):
    """Perception -> control periods over ``batches`` (points, valids,
    transforms, positions, each [N,...]) from ``state`` (given up, as a
    tick gives it up), each solving from ``normals(i)`` [H,3,K].  Returns
    (final state, final p, final v, the solves' costs [N], the solves'
    controls [N,H,3])."""
    p, v = p0, v0
    nominal = torch.zeros((m.horizon, 3), device=p0.device)
    costs, controls = [], []
    for i in range(batches[0].shape[0]):
        state, _ = ft.fused_batch_step(cfg, state, *(b[i] for b in batches),
                                       method="scanline")
        dist = distance_grid(cfg, state.d2, state.seen)
        res = mpc._plan_step_impl(cfg, m, dist, p, v, goal, nominal,
                                  normals(i))
        v = torch.clamp(v + res.controls[0] * m.dt, -m.v_max, m.v_max)
        p = p + v * m.dt
        nominal = mpc.shift_nominal(res.controls)
        costs.append(res.cost)
        controls.append(res.controls)
    return state, p, v, torch.stack(costs), torch.stack(controls)


def measure(cfg, m, frames, dev, warm_batches=WARM_BATCHES, reps=REPS):
    """The e2e loop on ``dev`` at planner config ``m``: ``warm_batches``
    ticks, then one untimed and ``reps`` timed streams of periods over the
    rest.  Returns (the JSON line's fields, the first stream's (final
    state, p, v, costs, controls))."""
    batches = replay.stage_update_batches(cfg, frames, device=dev)
    bt.log(f"staged {batches[0].shape[0]} perception batches "
           f"({cfg.num_voxels / 1e6:.1f} M voxels, "
           f"{batches[0].shape[2]} rays a scan x 3)")
    state = ft.make_state(cfg, dev)
    for i in range(warm_batches):
        state, _ = ft.fused_batch_step(cfg, state,
                                       *(b[i] for b in batches),
                                       method="scanline")
    stream = tuple(b[warm_batches:] for b in batches)
    n = stream[0].shape[0]
    center = np.asarray(cfg.origin) + np.asarray(cfg.map_size) / 2
    goal = torch.tensor(center + [1.5, 1.5, 0.0], dtype=torch.float32,
                        device=dev)
    p0 = torch.tensor(center + [0.0, -1.5, 0.0], dtype=torch.float32,
                      device=dev)
    v0 = torch.zeros(3, device=dev)
    gen = torch.Generator(device=dev)
    shape = (m.horizon, 3, m.n_rollouts)

    def normals(_):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev)

    def run(st):
        gen.manual_seed(0)
        return periods(cfg, m, st, stream, p0, v0, goal, normals)

    t0 = time.perf_counter()
    first = run(ft.copy_state(state))
    bt.sync(dev)
    bt.log(f"first stream: {time.perf_counter() - t0:.1f} s; final pos "
           f"{first[1].cpu().numpy().round(2)}, last cost "
           f"{float(first[3][-1]):.1f}")
    times = []
    for _ in range(reps):
        st = ft.copy_state(state)
        _, ms = bt.timed(lambda st=st: run(st), dev)
        times.append(ms / n)
    ms = statistics.median(times)
    bt.log(f"{n} perception->control periods a stream x {reps} streams: "
           f"{times} ms a period")
    return {
        "metric": "e2e_perception_to_control_ms",
        "value": ms,
        "unit": "ms",
        "vs_baseline": BUDGET_MS / ms,
    }, first


def main(argv=None):
    args = bt.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = bt.device(args.platform, "bench_e2e_torch.py")
    card = bt.describe(dev)
    cfg = bt.cow_config(H, W)
    bt.log(f"device: {card}")
    frames = bt.replay_frames(cfg, N_FRAMES, H, W)
    line, _ = measure(cfg, mpc.MPCConfig(), frames, dev)
    bt.emit({**line, "device": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
