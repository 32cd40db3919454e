"""Sampling MPC with ESDF-gradient refinement (port of
``fiesta_tpu/planning/mpc.py``).

A double-integrator point mass with velocity and acceleration limits.
One solve (``plan_step``) draws K perturbed control sequences, rolls them
out in component layout ([H, 3, K]: the K rollouts on the last, contiguous
axis), scores them against the distance grid (MPPI: a softmax over K and
the weighted control), then refines the winner with a few Adam steps on
the gradient of the trilinearly interpolated collision cost, taken by
autograd through ``query.get_dist_grad_trilinear``.
``make_sharded_planner`` splits the K rollouts over a mesh's shards.

Plain PyTorch on the device of the distance grid: the JAX package writes
no Pallas kernel for the planner.  f32 expressions keep the JAX op order,
and every division is by a 0-dim tensor (``grid.f32_scalar``).  Where a
gradient flows, ``jnp.clip`` becomes ``minimum(maximum(x, lo), hi)``: at
a tie it passes half the gradient, as ``jnp.clip`` does, where
``torch.clamp`` passes all of it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import FiestaConfig
from ..grid import f32_scalar
from ..ops.query import get_dist_grad_trilinear, get_distance


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """The planner's settings (``mpc.py:36-64``), same fields and
    defaults."""

    horizon: int = 30
    dt: float = 0.1
    n_rollouts: int = 16384
    temperature: float = 0.5          # MPPI lambda
    sigma: float = 1.5                # control noise std (m/s^2)
    a_max: float = 6.0
    v_max: float = 3.0
    margin: float = 0.6               # desired clearance (m)
    w_collision: float = 200.0
    w_goal: float = 5.0
    w_terminal: float = 50.0
    w_effort: float = 0.05
    refine_steps: int = 8
    refine_lr: float = 0.3
    # Distance lookup of the MPPI sampling stage: "nearest" reads one voxel
    # per sample, "trilinear" the interpolant; the refinement always uses
    # the trilinear form.
    sample_query: str = "nearest"
    # The grid is a signed distance field (``query.signed_distance_grid``):
    # penetration is graded, and out-of-map queries read -trunc_dist.
    signed: bool = False


def mpc_config_from_fields(fields: dict) -> MPCConfig:
    """An MPCConfig from a field dict, such as ``dataclasses.asdict`` of a
    ``fiesta_tpu`` one."""
    names = {f.name for f in dataclasses.fields(MPCConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown MPCConfig fields: {sorted(unknown)}")
    return MPCConfig(**fields)


class PlanResult(NamedTuple):
    controls: torch.Tensor            # [H,3] optimized control sequence
    positions: torch.Tensor           # [H,3] resulting trajectory
    cost: torch.Tensor                # scalar cost of the plan
    best_sample_cost: torch.Tensor
    mean_sample_cost: torch.Tensor


def rollout_positions(mpc: MPCConfig, p0: torch.Tensor, v0: torch.Tensor,
                      controls: torch.Tensor) -> torch.Tensor:
    """Integrate controls [H,...] over their leading (horizon) axis from
    (p0, v0), which broadcast against each step's control: [H,3] from [3]
    -> positions [H,3] (``mpc.py:75-85``).  The velocity clip is
    ``jnp.clip``'s in value and gradient."""
    lo, hi = (f32_scalar(b, controls) for b in (-mpc.v_max, mpc.v_max))
    p, v, out = p0, v0, []
    for a in controls:
        v = torch.minimum(torch.maximum(v + a * mpc.dt, lo), hi)
        p = p + v * mpc.dt
        out.append(p)
    return torch.stack(out)


def _rollout_positions_soa(mpc: MPCConfig, p0: torch.Tensor,
                           v0: torch.Tensor,
                           controls_soa: torch.Tensor) -> torch.Tensor:
    """Batched rollout in component layout: controls [H,3,K] -> positions
    [H,3,K] (``mpc.py:88-105``)."""
    k = controls_soa.shape[-1]
    return rollout_positions(mpc, p0[:, None].expand(3, k),
                             v0[:, None].expand(3, k), controls_soa)


def _floored(cfg: FiestaConfig, mpc: MPCConfig,
             d: torch.Tensor) -> torch.Tensor:
    """Signed: penetration floored at -trunc_dist (which also maps the
    -10000 out-of-map sentinel there); unsigned: negative sentinels read
    as fully colliding (0)."""
    if mpc.signed:
        return torch.maximum(d, f32_scalar(-cfg.trunc_dist, d))
    return torch.where(d < 0, 0.0, d)


def _violation(mpc: MPCConfig, d: torch.Tensor) -> torch.Tensor:
    return torch.maximum(mpc.margin - d, f32_scalar(0.0, d))


def _per_step(mpc: MPCConfig, total: torch.Tensor) -> torch.Tensor:
    """``total * w_goal / max(horizon, 1)``, the division IEEE."""
    return total * mpc.w_goal / f32_scalar(max(mpc.horizon, 1), total)


def _sample_costs_soa(cfg: FiestaConfig, mpc: MPCConfig,
                      dist_grid: torch.Tensor, p0: torch.Tensor,
                      v0: torch.Tensor, goal: torch.Tensor,
                      ctrl_soa: torch.Tensor) -> torch.Tensor:
    """MPPI sample costs [K] from controls [H,3,K]: ``trajectory_cost``
    evaluated in component layout (``mpc.py:133-157``)."""
    pos = _rollout_positions_soa(mpc, p0, v0, ctrl_soa)      # [H,3,K]
    if mpc.sample_query == "trilinear":
        d, _ = get_dist_grad_trilinear(
            cfg, dist_grid, pos.movedim(1, -1),
            out_value=-cfg.trunc_dist if mpc.signed else -1.0)  # [H,K]
    else:
        d = get_distance(cfg, dist_grid, pos.movedim(1, -1))    # [H,K]
    collision = torch.sum(_violation(mpc, _floored(cfg, mpc, d)) ** 2, 0)
    ge = pos - goal[None, :, None]                           # [H,3,K]
    goal_cost = _per_step(mpc, torch.sum(ge[:-1] ** 2, dim=(0, 1)))
    terminal = torch.sum(ge[-1] ** 2, dim=0) * mpc.w_terminal
    effort = torch.sum(ctrl_soa ** 2, dim=(0, 1)) * mpc.w_effort
    return mpc.w_collision * collision + goal_cost + terminal + effort


def trajectory_cost(cfg: FiestaConfig, mpc: MPCConfig,
                    dist_grid: torch.Tensor, positions: torch.Tensor,
                    controls: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
    """Collision + goal + effort cost of one trajectory ([H,3] inputs,
    ``mpc.py:160-186``), differentiable in ``positions`` and
    ``controls``."""
    d, _ = get_dist_grad_trilinear(
        cfg, dist_grid, positions,
        out_value=-cfg.trunc_dist if mpc.signed else -1.0)
    collision = torch.sum(_violation(mpc, _floored(cfg, mpc, d)) ** 2)
    goal_err = positions - goal
    goal_cost = _per_step(mpc, torch.sum(goal_err[:-1] ** 2))
    terminal = torch.sum(goal_err[-1] ** 2) * mpc.w_terminal
    effort = torch.sum(controls ** 2) * mpc.w_effort
    return mpc.w_collision * collision + goal_cost + terminal + effort


def _plan_step_impl(cfg: FiestaConfig, mpc: MPCConfig,
                    dist_grid: torch.Tensor, p0: torch.Tensor,
                    v0: torch.Tensor, goal: torch.Tensor,
                    nominal: torch.Tensor,
                    normals: torch.Tensor) -> PlanResult:
    """One MPC solve from standard normal draws ``normals`` [H,3,K] f32
    (``mpc.py:189-271``): MPPI sampling, then ``refine_steps`` Adam steps
    on the trajectory cost's gradient."""
    samples = _samples(mpc, nominal, normals)
    costs = _sample_costs_soa(cfg, mpc, dist_grid, p0, v0, goal, samples)
    beta = torch.min(costs)
    w = torch.softmax(-(costs - beta) / f32_scalar(mpc.temperature, costs),
                      dim=0)
    mppi_ctrl = torch.clamp(torch.einsum("hck,k->hc", samples, w),
                            -mpc.a_max, mpc.a_max)
    return _refine(cfg, mpc, dist_grid, p0, v0, goal, mppi_ctrl, beta,
                   torch.mean(costs))


def _samples(mpc: MPCConfig, nominal: torch.Tensor,
             normals: torch.Tensor) -> torch.Tensor:
    """The MPPI control samples [H,3,K] from standard normals."""
    return torch.clamp(nominal[:, :, None] + normals * mpc.sigma,
                       -mpc.a_max, mpc.a_max)


def _refine(cfg: FiestaConfig, mpc: MPCConfig, dist_grid: torch.Tensor,
            p0: torch.Tensor, v0: torch.Tensor, goal: torch.Tensor,
            mppi_ctrl: torch.Tensor, beta: torch.Tensor,
            mean_cost: torch.Tensor) -> PlanResult:
    """``refine_steps`` Adam steps on the trajectory cost's gradient from
    the MPPI control, and the solve's result."""
    def grad(ctrl):
        """The refinement cost's gradient at ``ctrl`` (``jax.value_and_grad``
        at ``mpc.py:237``)."""
        c = ctrl.detach().requires_grad_(True)
        with torch.enable_grad():
            cost = trajectory_cost(cfg, mpc, dist_grid,
                                   rollout_positions(mpc, p0, v0, c), c, goal)
            return torch.autograd.grad(cost, c)[0]

    ctrl = mppi_ctrl
    m = torch.zeros_like(ctrl)
    v = torch.zeros_like(ctrl)
    t = torch.zeros((), dtype=torch.float32, device=ctrl.device)
    b1, b2 = f32_scalar(0.9, t), f32_scalar(0.999, t)
    for _ in range(mpc.refine_steps):
        g = grad(ctrl)
        t = t + 1
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        ctrl = torch.clamp(
            ctrl - mpc.refine_lr * mhat / (torch.sqrt(vhat) + 1e-8),
            -mpc.a_max, mpc.a_max)

    final_pos = rollout_positions(mpc, p0, v0, ctrl)
    final_cost = trajectory_cost(cfg, mpc, dist_grid, final_pos, ctrl, goal)
    return PlanResult(controls=ctrl, positions=final_pos, cost=final_cost,
                      best_sample_cost=beta, mean_sample_cost=mean_cost)


def plan_step(cfg: FiestaConfig, mpc: MPCConfig, dist_grid: torch.Tensor,
              p0: torch.Tensor, v0: torch.Tensor, goal: torch.Tensor,
              nominal: torch.Tensor,
              generator: torch.Generator) -> PlanResult:
    """One MPC solve (``mpc.py:274-285``) on the device of ``dist_grid``
    [X,Y,Z] f32 (``query.distance_grid``, or the signed field with
    ``mpc.signed``): p0, v0, goal [3] f32 and the warm start ``nominal``
    [H,3] f32 lie there too.  The control noise is drawn from
    ``generator`` (a ``torch.Generator`` on that device, in place of the
    JAX key) as standard normals [H,3,K]."""
    dev = dist_grid.device
    for name, x in (("p0", p0), ("v0", v0), ("goal", goal),
                    ("nominal", nominal)):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, distance grid on {dev}")
    normals = torch.randn((mpc.horizon, 3, mpc.n_rollouts),
                          generator=generator, dtype=torch.float32,
                          device=dev)
    return _plan_step_impl(cfg, mpc, dist_grid, p0, v0, goal, nominal,
                           normals)


def shift_nominal(controls: torch.Tensor) -> torch.Tensor:
    """Receding-horizon warm start: drop the executed step, repeat the
    last."""
    return torch.cat([controls[1:], controls[-1:]], dim=0)


def make_sharded_planner(cfg: FiestaConfig, mpc: MPCConfig, mesh):
    """The planner with its K rollouts split over ``mesh``'s shards
    (``mpc.py:293-324``, scenario parallelism): each shard scores its K/n
    samples against its copy of the distance grid, and only the softmax's
    normaliser and the weighted control sum across shards (with the
    least cost, its shift).  The refinement runs once, on the first local
    shard's device.

    Returns planner(dist_grids, p0, v0, goal, nominal, generator) ->
    PlanResult, ``plan_step``'s arguments with ``dist_grids`` a grid per
    local shard (or one grid, copied to each); the normals [H,3,K] are
    drawn once from ``generator`` (or given as ``normals=``, as
    ``_plan_step_impl`` takes them) and split on K, so a solve equals
    ``plan_step`` from the same generator within the planner's
    tolerances (the sums over K run in another order)."""
    from ..parallel.sharding import _to

    n = mesh.size
    if mpc.n_rollouts % n:
        raise ValueError(
            f"n_rollouts={mpc.n_rollouts} must divide by the size of mesh "
            f"axis 'x' ({n}) that shards the rollouts")
    kl = mpc.n_rollouts // n

    def planner(dist_grids, p0, v0, goal, nominal, generator=None,
                normals=None):
        if isinstance(dist_grids, torch.Tensor):
            dist_grids = [_to(dist_grids, d) for d in mesh.devices]
        if normals is None:
            normals = torch.randn((mpc.horizon, 3, mpc.n_rollouts),
                                  generator=generator, dtype=torch.float32,
                                  device=generator.device)
        samples, costs = [], []
        for grid, i, dev in zip(dist_grids, mesh.local, mesh.devices):
            s = _samples(mpc, _to(nominal, dev),
                         _to(normals[..., i * kl:(i + 1) * kl], dev))
            samples.append(s)
            costs.append(_sample_costs_soa(cfg, mpc, grid, _to(p0, dev),
                                           _to(v0, dev), _to(goal, dev), s))
        beta = mesh.pmin([torch.min(c) for c in costs])
        x = [-(c - b) / f32_scalar(mpc.temperature, c)
             for c, b in zip(costs, beta)]
        top = mesh.pmax([torch.max(xi) for xi in x])
        e = [torch.exp(xi - t) for xi, t in zip(x, top)]
        z = mesh.psum([torch.sum(ei) for ei in e])
        ctrl = mesh.psum([torch.einsum("hck,k->hc", s, ei / zi)
                          for s, ei, zi in zip(samples, e, z)])[0]
        mppi_ctrl = torch.clamp(ctrl, -mpc.a_max, mpc.a_max)
        total = mesh.psum([torch.sum(c) for c in costs])[0]
        mean_cost = total / f32_scalar(mpc.n_rollouts, total)
        dev = mesh.devices[0]
        return _refine(cfg, mpc, dist_grids[0], _to(p0, dev), _to(v0, dev),
                       _to(goal, dev), mppi_ctrl, beta[0], mean_cost)

    return planner
