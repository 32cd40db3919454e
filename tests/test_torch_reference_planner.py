"""fiesta_tpu_torch's numpy planner oracle against fiesta_tpu's (CPU).

``fiesta_tpu_torch.planning.reference_planner`` is the port's own copy of
the independent float64 finite-difference planner: each of its five
functions gives ``fiesta_tpu.planning.reference_planner``'s result bit
for bit on seeded float64 inputs (positions in and out of the map, both
collision modes), and ``plan`` on a small map gives the same controls and
cost.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from fiesta_tpu import FiestaConfig  # noqa: E402
from fiesta_tpu.planning import mpc as jmpc  # noqa: E402
from fiesta_tpu.planning import reference_planner as jref  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch.planning import mpc as tmpc  # noqa: E402
from fiesta_tpu_torch.planning import reference_planner as tref  # noqa: E402

CFG = FiestaConfig(resolution=0.1, origin=(-1.0, -1.0, -0.5),
                   map_size=(2.0, 2.0, 1.0), min_ray_length=0.3,
                   max_ray_length=2.0, trunc_dist=0.8, edt_fine_dist=0.8)
TCFG = ft.config_from_fields(dataclasses.asdict(CFG))
H = 6


def _inputs(seed):
    """A float64 distance grid, a start, a goal and controls [H,3]."""
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0.0, 1.0, CFG.grid_shape)
    dist[rng.random(CFG.grid_shape) < 0.05] = 0.0
    p0 = rng.uniform(-0.6, 0.6, 3) * [1, 1, 0.5]
    v0 = rng.uniform(-0.5, 0.5, 3)
    goal = rng.uniform(-0.8, 0.8, 3) * [1, 1, 0.5]
    controls = rng.uniform(-3.0, 3.0, (H, 3))
    return dist, p0, v0, goal, controls


def _mpcs(signed):
    kw = dict(horizon=H, n_rollouts=8, refine_steps=2, signed=signed)
    return jmpc.MPCConfig(**kw), tmpc.MPCConfig(**kw)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_trilinear_distance_and_rollout_match(seed):
    dist, p0, v0, _, controls = _inputs(seed)
    rng = np.random.default_rng(10 + seed)
    # inside, on the faces, and outside the map
    pos = rng.uniform(-1.3, 1.3, (64, 3)) * [1, 1, 0.5]
    pos[:6] = [[-1.0, -1.0, -0.5], [1.0, 1.0, 0.5], [0.95, 0.0, 0.0],
               [-0.95, 0.3, 0.45], [1.0 + 1e-9, 0.0, 0.0], [0.0, 0.0, 0.0]]
    for out_value in (-1.0, -0.8):
        _same(tref.trilinear_distance(TCFG, dist, pos, out_value),
              jref.trilinear_distance(CFG, dist, pos, out_value))
    jm, tm = _mpcs(False)
    _same(tref.rollout(tm, p0, v0, controls),
          jref.rollout(jm, p0, v0, controls))


@pytest.mark.parametrize("signed", [False, True])
def test_cost_and_fd_gradient_match(signed):
    dist, p0, v0, goal, controls = _inputs(2 + signed)
    if signed:
        dist = dist - 0.3             # a signed field: negative inside
    jm, tm = _mpcs(signed)
    want = jref.cost(CFG, jm, dist, p0, v0, controls, goal)
    got = tref.cost(TCFG, tm, dist, p0, v0, controls, goal)
    assert isinstance(got, float) and got == want
    _same(tref.fd_gradient(TCFG, tm, dist, p0, v0, controls, goal),
          jref.fd_gradient(CFG, jm, dist, p0, v0, controls, goal))


def test_plan_matches_on_a_small_map():
    """Four Adam steps on finite-difference gradients from a zero warm
    start, around a block between start and goal: the same controls and
    final cost, and a cost below the warm start's."""
    occ = np.zeros(CFG.grid_shape, bool)
    occ[8:12, 8:12, :] = True
    idx = np.indices(CFG.grid_shape).reshape(3, -1).T
    seeds = np.argwhere(occ)
    d = np.sqrt(((idx[:, None, :] - seeds[None]) ** 2).sum(-1).min(1))
    dist = np.minimum(d * CFG.resolution, CFG.trunc_dist).reshape(
        CFG.grid_shape)
    jm, tm = _mpcs(False)
    p0, v0 = np.asarray([-0.6, -0.6, 0.0]), np.zeros(3)
    goal = np.asarray([0.6, 0.6, 0.0])
    nominal = np.zeros((H, 3))
    got = tref.plan(TCFG, tm, dist, p0, v0, goal, nominal, steps=4)
    want = jref.plan(CFG, jm, dist, p0, v0, goal, nominal, steps=4)
    _same(got[0], want[0])
    assert got[1] == want[1]
    assert got[1] < tref.cost(TCFG, tm, dist, p0, v0, nominal, goal)
