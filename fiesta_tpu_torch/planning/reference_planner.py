"""Independent CPU ESDF-gradient planner: the parity oracle for the port's
``plan_step`` (port of ``fiesta_tpu/planning/reference_planner.py``).

The reference repo ships no planner (its map API is the hook external
planners consume, ESDFMap.cpp:481-540), so the oracle is built from
scratch: pure NumPy, float64, and **central finite-difference gradients**
(no PyTorch, no autograd, no code shared with ``planning/mpc.py``),
solving the same optimal-control problem:

  * double-integrator dynamics with velocity clamping
    (``mpc.rollout_positions``);
  * collision cost from trilinearly interpolated ESDF distances (the
    reference's interpolation tree, ESDFMap.cpp:519-539), plus goal,
    terminal, and effort terms with the same weights.

Two parity statements follow (``bench_mpc_torch.py`` reports both):

  1. gradient parity: the autograd gradient of ``mpc.trajectory_cost``
     matches the finite-difference gradient of this module's cost at
     common points;
  2. solution parity: from the same warm start, ``plan_step``'s control
     sequence agrees with this planner's (elementwise, in the smooth
     regime) and its final cost, scored by THIS module's cost, is at
     least as good in cluttered scenes.

The arithmetic is ``fiesta_tpu``'s, operation for operation, so both
packages' oracles give the same float64 results.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def trilinear_distance(cfg, dist: np.ndarray, pos: np.ndarray,
                       out_value: float = -1.0) -> np.ndarray:
    """Trilinear interpolation of the distance grid at ``pos`` [...,3]
    (GetDistWithGradTrilinear's value path, ESDFMap.cpp:481-540), in
    float64 numpy.  Out-of-map reads ``out_value``; out-of-grid corners
    read infinity_distance (the reference's reserved undefined slot)."""
    dist = np.asarray(dist, np.float64)
    pos = np.asarray(pos, np.float64)
    gx, gy, gz = cfg.grid_shape
    origin = np.asarray(cfg.origin, np.float64)
    res = float(cfg.resolution)

    in_map = np.all(
        (pos >= origin) & (pos <= origin + np.asarray(cfg.map_size)),
        axis=-1)
    idx = np.floor((pos - 0.5 * res - origin) / res).astype(np.int64)
    corner_pos = (idx + 0.5) * res + origin
    f = (pos - corner_pos) / res                 # in [0,1)^3

    inf = float(cfg.infinity_distance)
    acc = np.zeros(pos.shape[:-1], np.float64)
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                ix, iy, iz = idx[..., 0] + ox, idx[..., 1] + oy, idx[..., 2] + oz
                ok = ((ix >= 0) & (ix < gx) & (iy >= 0) & (iy < gy)
                      & (iz >= 0) & (iz < gz))
                v = np.where(
                    ok,
                    dist[np.clip(ix, 0, gx - 1), np.clip(iy, 0, gy - 1),
                         np.clip(iz, 0, gz - 1)],
                    inf)
                w = (np.where(ox, f[..., 0], 1 - f[..., 0])
                     * np.where(oy, f[..., 1], 1 - f[..., 1])
                     * np.where(oz, f[..., 2], 1 - f[..., 2]))
                acc = acc + w * v
    return np.where(in_map, acc, out_value)


def rollout(mpc, p0, v0, controls: np.ndarray) -> np.ndarray:
    """Double-integrator rollout with velocity clamping ([H,3] -> [H,3])."""
    p = np.asarray(p0, np.float64).copy()
    v = np.asarray(v0, np.float64).copy()
    out = np.empty_like(np.asarray(controls, np.float64))
    for t in range(controls.shape[0]):
        v = np.clip(v + controls[t] * mpc.dt, -mpc.v_max, mpc.v_max)
        p = p + v * mpc.dt
        out[t] = p
    return out


def cost(cfg, mpc, dist: np.ndarray, p0, v0, controls: np.ndarray,
         goal) -> float:
    """The trajectory cost of ``mpc.trajectory_cost``, re-derived in
    numpy (same weights, same clamp semantics, signed-mode aware)."""
    controls = np.asarray(controls, np.float64)
    goal = np.asarray(goal, np.float64)
    positions = rollout(mpc, p0, v0, controls)
    out_value = -cfg.trunc_dist if mpc.signed else -1.0
    d = trilinear_distance(cfg, dist, positions, out_value=out_value)
    if mpc.signed:
        d = np.maximum(d, -cfg.trunc_dist)
    else:
        d = np.where(d < 0, 0.0, d)
    violation = np.maximum(mpc.margin - d, 0.0)
    collision = float(np.sum(violation ** 2))
    goal_err = positions - goal
    goal_cost = float(np.sum(goal_err[:-1] ** 2)) * mpc.w_goal / max(
        mpc.horizon, 1)
    terminal = float(np.sum(goal_err[-1] ** 2)) * mpc.w_terminal
    effort = float(np.sum(controls ** 2)) * mpc.w_effort
    return mpc.w_collision * collision + goal_cost + terminal + effort


def fd_gradient(cfg, mpc, dist, p0, v0, controls, goal,
                eps: float = 1e-4) -> np.ndarray:
    """Central finite-difference gradient of ``cost`` wrt controls."""
    controls = np.asarray(controls, np.float64)
    g = np.zeros_like(controls)
    for t in range(controls.shape[0]):
        for a in range(3):
            up = controls.copy()
            dn = controls.copy()
            up[t, a] += eps
            dn[t, a] -= eps
            g[t, a] = (cost(cfg, mpc, dist, p0, v0, up, goal)
                       - cost(cfg, mpc, dist, p0, v0, dn, goal)) / (2 * eps)
    return g


def plan(cfg, mpc, dist: np.ndarray, p0, v0, goal, nominal: np.ndarray,
         steps: int = 80, lr: float = None,
         eps: float = 1e-4) -> Tuple[np.ndarray, float]:
    """Gradient-descent planner: Adam on finite-difference gradients (the
    same update schedule plan_step's refinement stage uses, so in the
    smooth regime the two descend the same surface in lockstep).

    Returns (controls [H,3], final cost)."""
    lr = mpc.refine_lr if lr is None else lr
    ctrl = np.asarray(nominal, np.float64).copy()
    m = np.zeros_like(ctrl)
    v = np.zeros_like(ctrl)
    for t in range(1, steps + 1):
        g = fd_gradient(cfg, mpc, dist, p0, v0, ctrl, goal, eps=eps)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1 - 0.9 ** t)
        vhat = v / (1 - 0.999 ** t)
        ctrl = np.clip(ctrl - lr * mhat / (np.sqrt(vhat) + 1e-8),
                       -mpc.a_max, mpc.a_max)
    return ctrl, cost(cfg, mpc, dist, p0, v0, ctrl, goal)
