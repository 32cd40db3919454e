"""fiesta_tpu_torch planner against fiesta_tpu.planning (CPU).

The same distance grids, controls and normal draws (made with numpy, and
with ``jax.random.normal`` for the solves) go through both packages:

- bit for bit, with the JAX package run op by op (``jax.disable_jit()``):
  the rollouts in both layouts (including velocities that saturate at
  ``v_max``, controls at ``+-a_max`` and the clip's ties) and the
  sampling stage's nearest lookup, the port's ``get_distance`` on a
  component-layout view, against JAX's ``_nearest_distance_soa``
  (positions out of the grid, out of the map and NaN);
- within stated tolerances, where sums run in another order (XLA's
  reductions and the softmax and weighted control over K):
  ``_sample_costs_soa`` within 1e-6 relative, ``trajectory_cost`` and its
  autograd gradient within 1e-5 relative to ``jax.value_and_grad``'s,
  and ``plan_step`` given JAX's draws within 1e-3 in controls and
  positions and 1e-3 relative in cost, the gate of
  ``tests/test_mpc_parity.py``;
- the gradient against the independent numpy oracle
  (``reference_planner.fd_gradient``) at ``test_mpc_parity.py``'s gate;
- the whole slice: the port's ``FiestaPipeline`` maps a replay and the
  port's planner flies across it clear of the true geometry, following
  the JAX planner's flight on the same map from the same draws.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from scipy import ndimage  # noqa: E402

from fiesta_tpu import FiestaConfig  # noqa: E402
from fiesta_tpu.io import replay as jreplay  # noqa: E402
from fiesta_tpu.planning import mpc as jmpc  # noqa: E402
from fiesta_tpu.planning import reference_planner as ref  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch.io import replay as treplay  # noqa: E402
from fiesta_tpu_torch.ops import edt as tedt  # noqa: E402
from fiesta_tpu_torch.ops import query as tquery  # noqa: E402
from fiesta_tpu_torch.planning import mpc as tmpc  # noqa: E402

CFG = FiestaConfig(resolution=0.1, origin=(-2.0, -2.0, -1.0),
                   map_size=(4.0, 4.0, 2.0), min_ray_length=0.3,
                   max_ray_length=4.0, trunc_dist=1.0, edt_fine_dist=1.0)
TCFG = ft.config_from_fields(dataclasses.asdict(CFG))


def _port_mpc(m):
    return tmpc.mpc_config_from_fields(dataclasses.asdict(m))


def _grids(seed=0, n_boxes=6):
    """(unsigned distance grid, signed distance field, occupancy) of a
    scene of random boxes and a block at the map's centre, which the
    fixtures' paths cross, every voxel observed, as numpy f32."""
    rng = np.random.default_rng(seed)
    occ = np.zeros(TCFG.grid_shape, bool)
    occ[17:23, 17:23, 6:14] = True
    for _ in range(n_boxes):
        c = rng.integers(4, 36, 3) * [1, 1, 0.5]
        c = c.astype(int)
        s = rng.integers(2, 6, 3)
        occ[c[0]:c[0] + s[0], c[1]:c[1] + s[1], c[2]:c[2] + s[2]] = True
    occ_t = torch.from_numpy(occ)
    d2 = tedt.truncated_edt_d2(occ_t, tedt.trunc_vox_for(0.1, 1.0))
    seen = torch.ones(TCFG.grid_shape, dtype=torch.uint8)
    dist = tquery.distance_grid(TCFG, d2, seen)
    sdf = tquery.signed_distance_grid(TCFG, d2, seen, occ_t)
    return dist.numpy(), sdf.numpy(), occ


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _saturating(rng, h, k=None):
    """Controls at +-a_max (velocities saturate at v_max within a step or
    two) and zeros (v stays at its clip bound: the clip's tie)."""
    shape = (h, 3) if k is None else (h, 3, k)
    c = rng.choice([-6.0, 0.0, 6.0], size=shape).astype(np.float32)
    c[: h // 3] = 6.0
    return c


@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_rollouts_bit_equal(kind):
    m = jmpc.MPCConfig(horizon=12)
    tm = _port_mpc(m)
    rng = np.random.default_rng(1)
    p0 = np.float32([0.3, -0.2, 0.1])
    v0 = np.float32([3.0, -3.0, 1.0]) if kind == "saturating" else \
        rng.uniform(-2, 2, 3).astype(np.float32)
    if kind == "saturating":
        one, soa = _saturating(rng, 12), _saturating(rng, 12, 50)
    else:
        one = rng.uniform(-6, 6, (12, 3)).astype(np.float32)
        soa = rng.uniform(-6, 6, (12, 3, 50)).astype(np.float32)
    args = [jnp.asarray(x) for x in (p0, v0)]
    targs = [torch.from_numpy(x) for x in (p0, v0)]
    with jax.disable_jit():
        r1 = jmpc.rollout_positions(m, *args, jnp.asarray(one))
        r2 = jmpc._rollout_positions_soa(m, *args, jnp.asarray(soa))
    np.testing.assert_array_equal(
        tmpc.rollout_positions(tm, *targs, torch.from_numpy(one)).numpy(),
        np.asarray(r1))
    got = tmpc._rollout_positions_soa(tm, *targs, torch.from_numpy(soa))
    assert got.shape == (12, 3, 50)
    np.testing.assert_array_equal(got.numpy(), np.asarray(r2))


def test_nearest_distance_bit_equal():
    dist, _, _ = _grids(2)
    rng = np.random.default_rng(3)
    lo, size = np.float32(CFG.origin), np.float32(CFG.map_size)
    pos = (lo - 0.3 + rng.random((400, 3)) * (size + 0.6)).astype(np.float32)
    pos[:6] = lo + size                          # on the far faces: in the
    pos[0, 1] = 0.0                              # map, out of the grid
    pos[6] = lo
    pos[7] = [np.nan, 0.0, 0.0]
    pos[8] = [0.0, 99.0, 0.0]
    with jax.disable_jit():
        want = jmpc._nearest_distance_soa(
            CFG, jnp.asarray(dist), *(jnp.asarray(pos[:, i]) for i in range(3)))
    # the sampling stage's nearest lookup is the port's get_distance, on a
    # component-layout view ([3, N] moved to [N, 3]), as it reads [H,3,K]
    soa = torch.from_numpy(np.ascontiguousarray(pos.T)).movedim(0, -1)
    got = tquery.get_distance(TCFG, torch.from_numpy(dist), soa)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tquery.get_distance(TCFG, torch.from_numpy(dist),
                            torch.from_numpy(pos)).numpy(),
        got.numpy())
    g = got.numpy()
    assert (g == -10000.0).sum() > 50 and (g == 10000.0).sum() >= 1
    assert ((g >= 0) & (g < 10000.0)).sum() > 100


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("query", ["nearest", "trilinear"])
def test_sample_costs_match_jax(query, signed):
    dist, sdf, _ = _grids(4)
    grid = sdf if signed else dist
    m = jmpc.MPCConfig(horizon=14, n_rollouts=300, sample_query=query,
                       signed=signed)
    rng = np.random.default_rng(5)
    p0, v0 = np.float32([-1.2, -1.0, 0.0]), np.float32([0.5, 0.2, 0.0])
    goal = np.float32([1.5, 1.2, 0.3])
    ctrl = rng.normal(0, 3, (14, 3, 300)).astype(np.float32)
    ctrl[..., :20] = _saturating(rng, 14, 20)
    want = jmpc._sample_costs_soa(CFG, m, jnp.asarray(grid),
                                  *(jnp.asarray(x) for x in (p0, v0, goal,
                                                             ctrl)))
    got = tmpc._sample_costs_soa(TCFG, _port_mpc(m), torch.from_numpy(grid),
                                 *(torch.from_numpy(x) for x in (p0, v0, goal,
                                                                 ctrl)))
    assert got.shape == (300,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(got.max()) > 1.5 * float(got.min())     # costs spread


def _cost_and_grad_jax(m, grid, p0, v0, ctrl, goal):
    def f(c):
        pos = jmpc.rollout_positions(m, jnp.asarray(p0), jnp.asarray(v0), c)
        return jmpc.trajectory_cost(CFG, m, grid, pos, c, jnp.asarray(goal))
    c, g = jax.value_and_grad(f)(jnp.asarray(ctrl))
    return float(c), np.asarray(g)


def _cost_and_grad_port(m, grid, p0, v0, ctrl, goal):
    c = torch.from_numpy(ctrl).requires_grad_(True)
    pos = tmpc.rollout_positions(m, torch.from_numpy(p0),
                                 torch.from_numpy(v0), c)
    cost = tmpc.trajectory_cost(TCFG, m, torch.from_numpy(grid), pos, c,
                                torch.from_numpy(goal))
    (g,) = torch.autograd.grad(cost, c)
    return float(cost.detach()), g.numpy()


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_trajectory_cost_and_grad_match_jax(kind, signed):
    dist, sdf, _ = _grids(6)
    grid = sdf if signed else dist
    m = jmpc.MPCConfig(horizon=12, signed=signed)
    rng = np.random.default_rng(7)
    goal = np.float32([1.6, 1.4, 0.4])
    worst = 0.0
    for trial in range(4):
        p0 = rng.uniform(-1.5, 1.5, 3).astype(np.float32)
        if kind == "saturating":
            v0 = np.float32([3.0, -3.0, 3.0])
            ctrl = _saturating(rng, 12)
        else:
            v0 = rng.uniform(-1, 1, 3).astype(np.float32)
            ctrl = rng.uniform(-2, 2, (12, 3)).astype(np.float32)
        cj, gj = _cost_and_grad_jax(m, jnp.asarray(grid), p0, v0, ctrl, goal)
        ct, gt = _cost_and_grad_port(_port_mpc(m), grid, p0, v0, ctrl, goal)
        assert abs(ct - cj) <= 1e-5 * abs(cj), (trial, ct, cj)
        worst = max(worst, _rel(gt, gj))
    assert worst < 1e-5, f"gradient rel L2 {worst:.2e}"


def test_gradient_matches_numpy_oracle():
    """The independent float64 finite-difference gradient, at
    ``tests/test_mpc_parity.py::test_gradient_parity``'s gate."""
    dist, _, _ = _grids(8)
    m = jmpc.MPCConfig(horizon=12)
    rng = np.random.default_rng(1)
    p0, v0 = np.float32([0.3, -0.2, 0.1]), np.zeros(3, np.float32)
    goal = np.float32([1.5, 1.5, 0.5])
    worst = 0.0
    for _ in range(4):
        ctrl = rng.uniform(-1.5, 1.5, (12, 3)).astype(np.float32)
        _, gt = _cost_and_grad_port(_port_mpc(m), dist, p0, v0, ctrl, goal)
        gf = ref.fd_gradient(CFG, m, dist.astype(np.float64), p0, v0,
                             ctrl.astype(np.float64), goal)
        worst = max(worst, _rel(gt, gf))
    assert worst < 2e-2, f"gradient mismatch: rel L2 {worst:.4f}"


def _port_solve(m, grid, p0, v0, goal, nominal, key):
    normals = np.asarray(jax.random.normal(
        key, (m.horizon, 3, m.n_rollouts), jnp.float32))
    return tmpc._plan_step_impl(
        TCFG, _port_mpc(m), torch.from_numpy(np.asarray(grid)),
        *(torch.from_numpy(np.array(x, np.float32))
          for x in (p0, v0, goal, nominal, normals)))


@pytest.mark.parametrize("variant", ["nearest", "trilinear", "signed"])
def test_plan_step_matches_jax(variant):
    dist, sdf, _ = _grids(9, n_boxes=10)
    m = jmpc.MPCConfig(horizon=16, n_rollouts=512,
                       sample_query="trilinear" if variant == "trilinear"
                       else "nearest", signed=variant == "signed")
    grid = sdf if m.signed else dist
    p0, v0 = np.float32([-1.5, -1.5, 0.0]), np.float32([0.2, 0.0, 0.0])
    goal = np.float32([1.6, 1.6, 0.3])
    nominal = np.random.default_rng(2).uniform(
        -1, 1, (16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jmpc.plan_step(CFG, m, jnp.asarray(grid),
                          *(jnp.asarray(x) for x in (p0, v0, goal, nominal)),
                          key)
    got = _port_solve(m, grid, p0, v0, goal, nominal, key)
    assert isinstance(got, tmpc.PlanResult)
    assert got.controls.shape == (16, 3) and got.positions.shape == (16, 3)
    assert np.abs(got.controls.numpy() - np.asarray(want.controls)).max() \
        < 1e-3
    assert np.abs(got.positions.numpy() - np.asarray(want.positions)).max() \
        < 1e-3
    for field in ("cost", "best_sample_cost", "mean_sample_cost"):
        g, w = float(getattr(got, field)), float(getattr(want, field))
        assert abs(g - w) <= 1e-3 * abs(w), (field, g, w)
    assert float(got.best_sample_cost) <= float(got.mean_sample_cost)


def test_plan_step_draws_on_the_grid_device():
    dist, _, _ = _grids(9)
    m = tmpc.MPCConfig(horizon=8, n_rollouts=64, refine_steps=2)
    args = [torch.from_numpy(x) for x in (
        np.float32([0.0, 0.0, 0.0]), np.zeros(3, np.float32),
        np.float32([1.0, 1.0, 0.0]), np.zeros((8, 3), np.float32))]
    grid = torch.from_numpy(dist)
    runs = [tmpc.plan_step(TCFG, m, grid, *args,
                           torch.Generator().manual_seed(0))
            for _ in range(2)]
    for a, b in zip(*runs):                       # same seed, same solve
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(x).all()) for x in runs[0])
    nominal = tmpc.shift_nominal(torch.arange(24.0).reshape(8, 3))
    assert nominal[0].tolist() == [3.0, 4.0, 5.0]
    assert torch.equal(nominal[-1], nominal[-2])
    assert tmpc.mpc_config_from_fields(
        dataclasses.asdict(jmpc.MPCConfig())) == tmpc.MPCConfig()
    with pytest.raises(ValueError, match="unknown"):
        tmpc.mpc_config_from_fields({"horizon": 3, "rollouts": 9})
    if torch.cuda.is_available():
        return
    with pytest.raises(ValueError, match="distance grid on cpu"):
        tmpc.plan_step(TCFG, m, grid, args[0].to("meta"), *args[1:],
                       torch.Generator())


def test_map_then_fly_follows_jax():
    """``tests/test_full_loop.py`` on the port: the port's engine maps the
    replay (on the CPU), the port's planner flies 40 receding-horizon
    steps across the room.  The executed path stays 0.1 m clear of the
    true world geometry and approaches the goal, and given the JAX
    flight's per-step draws it follows that flight, flown by the JAX
    planner on the same map, within 1e-2 m at every step."""
    cfg = jreplay.scale_intrinsics(FiestaConfig(
        resolution=0.1, origin=(-3.0, -3.0, -0.5), map_size=(6.0, 6.0, 2.0),
        min_ray_length=0.3, max_ray_length=6.0,
        max_points_per_scan=120 * 160), height=120, width=160)
    tc = ft.config_from_fields(dataclasses.asdict(cfg))
    world, frames = treplay.make_sequence(
        tc, n_frames=18, n_boxes=5, seed=11, height=120, width=160,
        period=6.0, orbit_radius=1.2)
    pipe = ft.FiestaPipeline(tc, method="scanline", device="cpu")
    for i, (t, (pos, quat), scan) in enumerate(frames):
        pipe.observe_pose(t, pos, quat)
        pipe.observe_cloud(t, scan)
        if i + 1 < len(frames):
            pipe.observe_pose(frames[i + 1][0], *frames[i + 1][1])
        pipe.process()
        if i % 3 == 2:
            pipe.update()
    pipe.observe_pose(frames[-1][0] + 1.0, *frames[-1][1])
    pipe.process()
    pipe.update()
    dist = pipe.distance_grid()

    m = jmpc.MPCConfig(horizon=16, dt=0.1, n_rollouts=1024, refine_steps=15,
                       margin=0.3)
    tm = _port_mpc(m)
    goal = np.float32([1.5, 1.5, 0.6])
    jdist = jnp.asarray(dist.numpy())
    jp, jv = jnp.float32([-1.5, -1.5, 0.6]), jnp.zeros(3, jnp.float32)
    jnom = jnp.zeros((m.horizon, 3), jnp.float32)
    tp, tv = torch.tensor(np.asarray(jp)), torch.zeros(3)
    tnom = torch.zeros((m.horizon, 3))
    goal_t = torch.from_numpy(goal)
    key = jax.random.PRNGKey(3)
    lo, hi = torch.tensor(-m.v_max), torch.tensor(m.v_max)
    executed, followed = [tp.numpy().copy()], [np.asarray(jp)]
    for _ in range(40):
        key, k = jax.random.split(key)
        res = jmpc.plan_step(cfg, m, jdist, jp, jv, jnp.asarray(goal), jnom,
                             k)
        jv = jnp.clip(jv + res.controls[0] * m.dt, -m.v_max, m.v_max)
        jp = jp + jv * m.dt
        jnom = jmpc.shift_nominal(res.controls)
        followed.append(np.asarray(jp))

        normals = torch.from_numpy(np.array(jax.random.normal(
            k, (m.horizon, 3, m.n_rollouts), jnp.float32)))
        tres = tmpc._plan_step_impl(tc, tm, dist, tp, tv, goal_t, tnom,
                                    normals)
        tv = torch.minimum(torch.maximum(tv + tres.controls[0] * m.dt, lo),
                           hi)
        tp = tp + tv * m.dt
        tnom = tmpc.shift_nominal(tres.controls)
        executed.append(tp.numpy().copy())
        if float(torch.linalg.norm(tp - goal_t)) < 0.3:
            break

    executed = np.asarray(executed)
    followed = np.asarray(followed)
    assert executed.shape == followed.shape
    assert np.abs(executed - followed).max() < 1e-2
    assert np.linalg.norm(executed[-1] - goal) < 1.0
    occ_true = world.occupied_voxels(tc)
    true_dist = ndimage.distance_transform_edt(~occ_true) * cfg.resolution
    vox = np.floor((executed - np.asarray(cfg.origin)) / cfg.resolution
                   ).astype(int)
    vox = np.clip(vox, 0, np.asarray(cfg.grid_shape) - 1)
    clearance = true_dist[vox[:, 0], vox[:, 1], vox[:, 2]]
    assert clearance.min() > 0.1, f"came within {clearance.min():.2f} m"
