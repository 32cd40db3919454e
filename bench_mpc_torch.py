#!/usr/bin/env python3
"""MPC benchmark on one CUDA card (fiesta_tpu_torch; the twin of
``bench_mpc.py``): ``plan_step`` latency at the production rollout count
(north star: at least 1e4 rollouts a control step), and its parity with
the independent numpy planner.

    python3 bench_mpc_torch.py [--platform cpu]

The map is ``bench_mpc.py``'s: random 0.1 % occupancy (numpy seed 0) on
the cow_and_lady grid, through the port's ``truncated_edt_d2`` and
``distance_grid``.  Twenty solves at ``MPCConfig()`` (16384 rollouts,
horizon 30), each warm-started by ``shift_nominal`` of the last, draw
their noise from one ``torch.Generator`` on the device seeded 0; they are
timed as one stream (CUDA events) after an untimed first solve.

Parity, against ``planning/reference_planner.py`` (numpy float64, finite
differences, no code shared with the planner):

  * same schedule (horizon 10, 4 rollouts at sigma 1e-6, 6 refinement
    steps, generator seed 7): max |du| between the two control sequences,
    tolerance 0.05;
  * full solve (horizon 16, 512 rollouts, 8 refinement steps, seed 8):
    the solve's cost scored by the oracle's cost over the oracle's own
    40-step solve from the same start (at most 1 or little above is
    good).

Prints one JSON line on stdout; diagnostics go to stderr.
"""

import sys

import numpy as np
import torch

from fiesta_tpu_torch import benchtools as bt
from fiesta_tpu_torch.config import COW_AND_LADY
from fiesta_tpu_torch.ops import edt, query
from fiesta_tpu_torch.planning import mpc
from fiesta_tpu_torch.planning import reference_planner as refp

N_SOLVES = 20
DU_TOL = 0.05
BUDGET_MS = 100.0        # one solve in a 10 Hz control tick


def random_map(cfg, dev):
    """The planner's distance grid on ``dev``: 0.1 % random occupancy
    (numpy seed 0) through the exact truncated EDT
    (``bench_mpc.py:33-36``)."""
    rng = np.random.default_rng(0)
    occ = torch.from_numpy(rng.random(cfg.grid_shape) < 0.001).to(dev)
    d2 = edt.truncated_edt_d2(occ, edt.trunc_vox_for(cfg.resolution,
                                                     cfg.trunc_dist))
    return query.distance_grid(cfg, d2, torch.ones_like(occ))


def _solve(cfg, m, dist, p0, goal, nominal, seed):
    """``plan_step`` from rest at ``p0`` with a generator seeded ``seed``
    (numpy inputs)."""
    dev = dist.device
    p0, v0, goal, nominal = (
        torch.as_tensor(np.asarray(x, np.float32), device=dev)
        for x in (p0, np.zeros(3), goal, nominal))
    return mpc.plan_step(cfg, m, dist, p0, v0, goal, nominal,
                         torch.Generator(device=dev).manual_seed(seed))


def parity(cfg, dist, same=(10, 4, 6), full=(16, 512, 8), oracle_steps=40):
    """The two parity statements: (same-schedule max |du|, full-solve cost
    ratio).  ``same`` and ``full``: (horizon, rollouts, refinement
    steps)."""
    dist_np = dist.cpu().numpy().astype(np.float64)   # one f64 copy
    p0 = np.asarray([0.5, 0.3, 0.2])
    goal = np.asarray([2.5, 1.5, 0.4])
    h, k, steps = same
    par = mpc.MPCConfig(horizon=h, n_rollouts=k, sigma=1e-6,
                        refine_steps=steps)
    nom = np.zeros((h, 3))
    res = _solve(cfg, par, dist, p0, goal, nom, 7)
    ctrl_ref, _ = refp.plan(cfg, par, dist_np, p0, np.zeros(3), goal, nom,
                            steps=steps)
    max_du = float(np.abs(res.controls.cpu().numpy().astype(np.float64)
                          - ctrl_ref).max())
    h, k, steps = full
    fcfg = mpc.MPCConfig(horizon=h, n_rollouts=k, refine_steps=steps)
    nom = np.zeros((h, 3))
    res = _solve(cfg, fcfg, dist, p0, goal, nom, 8)
    ours = refp.cost(cfg, fcfg, dist_np, p0, np.zeros(3),
                     res.controls.cpu().numpy().astype(np.float64), goal)
    _, theirs = refp.plan(cfg, fcfg, dist_np, p0, np.zeros(3), goal, nom,
                          steps=oracle_steps)
    bt.log(f"parity: same-schedule max|du| = {max_du:.4f} (tolerance "
           f"{DU_TOL}); full solve cost {ours:.3f} vs independent planner "
           f"{theirs:.3f} (ratio {ours / max(theirs, 1e-9):.3f})")
    return max_du, ours / max(theirs, 1e-9)


def measure(cfg, m, dev, n_solves=N_SOLVES, **parity_sizes):
    """``n_solves`` timed receding-horizon solves at ``m`` on the random
    map, then the parity statements.  Returns the JSON line's fields."""
    dist = random_map(cfg, dev)
    bt.log(f"rollouts={m.n_rollouts} horizon={m.horizon} "
           f"refine_steps={m.refine_steps}")
    p0 = torch.zeros(3, device=dev)
    v0 = torch.zeros(3, device=dev)
    goal = torch.tensor([3.0, 2.0, 0.5], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def tick(prev):
        return mpc.plan_step(cfg, m, dist, p0, v0, goal,
                             mpc.shift_nominal(prev), gen)

    res = tick(torch.zeros((m.horizon, 3), device=dev))
    bt.sync(dev)

    def stream(res):
        for _ in range(n_solves):
            res = tick(res.controls)
        float(res.cost)
        return res

    res, ms = bt.timed(lambda: stream(res), dev)
    solve_ms = ms / n_solves
    bt.log(f"plan_step: {solve_ms:.3f} ms -> "
           f"{m.n_rollouts / solve_ms * 1e-3:.3f} M rollouts/s, "
           f"{1e3 / solve_ms:.1f} solves/s")
    max_du, ratio = parity(cfg, dist, **parity_sizes)
    return {
        "metric": "mpc_plan_step_ms_16384_rollouts",
        "value": solve_ms,
        "unit": "ms",
        "vs_baseline": BUDGET_MS / solve_ms,
        "parity_max_du_same_schedule": max_du,
        "parity_cost_ratio_vs_independent_planner": ratio,
    }


def main(argv=None):
    args = bt.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = bt.device(args.platform, "bench_mpc_torch.py")
    card = bt.describe(dev)
    bt.log(f"device: {card}")
    line = measure(COW_AND_LADY, mpc.MPCConfig(), dev)
    bt.emit({**line, "device": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
