"""fiesta_tpu_torch query surface against fiesta_tpu (CPU).

Every query function on the same map state and the same positions, the
JAX reference run op by op (``jax.disable_jit()``: compiled XLA:CPU may
contract f32 multiply-adds and rewrite divisions), compared bit for bit
(f32 by bit pattern, NaN included).  Positions cover the map, its faces,
the outside and NaN; the state has unobserved and unreached voxels.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu import FiestaConfig  # noqa: E402
from fiesta_tpu import grid as jgrid  # noqa: E402
from fiesta_tpu import pipeline as jpipe  # noqa: E402
from fiesta_tpu.ops import query as jquery  # noqa: E402
from fiesta_tpu.ops.pallas import edt as jedt  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import grid as tgrid  # noqa: E402
from fiesta_tpu_torch import pipeline as tpipe  # noqa: E402
from fiesta_tpu_torch.ops import query as tquery  # noqa: E402

CFG = FiestaConfig(resolution=0.1, origin=(-2.0, -1.6, -0.7),
                   map_size=(4.0, 3.2, 2.4), trunc_dist=1.2,
                   edt_fine_dist=1.2)
TCFG = ft.FiestaConfig(resolution=0.1, origin=(-2.0, -1.6, -0.7),
                       map_size=(4.0, 3.2, 2.4), trunc_dist=1.2,
                       edt_fine_dist=1.2)


@functools.cache
def _state():
    """Host arrays of a map: log-odds, seen (two thirds observed), d2 and
    both closest formats from the JAX transform of the occupancy."""
    rng = np.random.default_rng(0)
    shape = CFG.grid_shape
    logodds = np.where(rng.random(shape) < 0.01, 2.0,
                       rng.uniform(-2.0, 0.5, shape)).astype(np.float32)
    seen = (rng.random(shape) < 0.67).astype(np.uint8)
    occ = np.array(jgrid.occupied_grid(CFG, jnp.asarray(logodds)))
    t = jedt.trunc_vox_for(CFG.resolution, CFG.trunc_dist)
    d2, packed = jedt.truncated_edt_d2_closest(jnp.asarray(occ), t,
                                               packed_out=True)
    _, planes = jedt.truncated_edt_d2_closest(jnp.asarray(occ), t)
    return dict(logodds=logodds, seen=seen, occ=occ, d2=np.array(d2),
                packed=np.array(packed), planes=np.array(planes))


def _positions():
    rng = np.random.default_rng(1)
    lo = np.asarray(CFG.origin, np.float32)
    hi = lo + np.asarray(CFG.map_size, np.float32)
    pos = rng.uniform(lo - 0.3, hi + 0.3, (2994, 3)).astype(np.float32)
    special = np.array([lo, hi, (lo + hi) / 2, [np.nan, 0.0, 0.0],
                        [1e9, -1e9, 0.0], lo - 0.05],
                       np.float32)
    return np.concatenate([pos, special]).reshape(-1, 12, 3)


POS = _positions()


def _eq(got, ref):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype == np.float32:
        got, ref = got.view(np.uint32), ref.view(np.uint32)
    np.testing.assert_array_equal(got, ref)


def _j(name):
    return jnp.asarray(_state()[name])


def _t(name):
    return torch.from_numpy(_state()[name])


def _jdist():
    with jax.disable_jit():
        return jquery.distance_grid(CFG, _j("d2"), _j("seen"))


def _tdist():
    return tquery.distance_grid(TCFG, _t("d2"), _t("seen"))


def case_distance_grid():
    return _tdist(), _jdist()


def case_get_distance_vox():
    rng = np.random.default_rng(2)
    vox = rng.integers(-3, 45, (500, 3)).astype(np.int32)
    with jax.disable_jit():
        ref = jquery.get_distance_vox(CFG, _jdist(), jnp.asarray(vox))
    return tquery.get_distance_vox(TCFG, _tdist(), torch.from_numpy(vox)), ref


def case_get_distance():
    with jax.disable_jit():
        ref = jquery.get_distance(CFG, _jdist(), jnp.asarray(POS))
    return tquery.get_distance(TCFG, _tdist(), torch.from_numpy(POS)), ref


def case_get_dist_grad_trilinear():
    with jax.disable_jit():
        ref = jquery.get_dist_grad_trilinear(CFG, _jdist(), jnp.asarray(POS))
    return tquery.get_dist_grad_trilinear(TCFG, _tdist(),
                                          torch.from_numpy(POS)), ref


def case_get_dist_grad_trilinear_signed():
    with jax.disable_jit():
        sdf = jquery.signed_distance_grid(CFG, _j("d2"), _j("seen"),
                                          _j("occ"))
        ref = jquery.get_dist_grad_trilinear(CFG, sdf, jnp.asarray(POS),
                                             out_value=-1e4)
    tsdf = tquery.signed_distance_grid(TCFG, _t("d2"), _t("seen"), _t("occ"))
    return tquery.get_dist_grad_trilinear(TCFG, tsdf, torch.from_numpy(POS),
                                          out_value=-1e4), ref


def case_get_closest_obstacle_packed():
    with jax.disable_jit():
        ref = jquery.get_closest_obstacle(CFG, _j("packed"), _j("d2"),
                                          _j("seen"), jnp.asarray(POS))
    return tquery.get_closest_obstacle(TCFG, _t("packed"), _t("d2"),
                                       _t("seen"), torch.from_numpy(POS)), ref


def case_get_closest_obstacle_planes():
    with jax.disable_jit():
        ref = jquery.get_closest_obstacle(CFG, _j("planes"), _j("d2"),
                                          _j("seen"), jnp.asarray(POS))
    return tquery.get_closest_obstacle(TCFG, _t("planes"), _t("d2"),
                                       _t("seen"), torch.from_numpy(POS)), ref


def case_signed_distance_grid():
    with jax.disable_jit():
        ref = jquery.signed_distance_grid(CFG, _j("d2"), _j("seen"),
                                          _j("occ"))
    return tquery.signed_distance_grid(TCFG, _t("d2"), _t("seen"),
                                       _t("occ")), ref


def case_sdf_from_state():
    st = _state()
    tstate = tgrid.state_from_arrays(TCFG, dict(
        logodds=st["logodds"], d2=st["d2"], closest=st["packed"],
        seen=st["seen"], hit_cnt=np.zeros_like(st["seen"]),
        miss_cnt=np.zeros_like(st["seen"])), device="cpu")
    jstate = jgrid.MapState(
        logodds=_j("logodds"), d2=_j("d2"), closest=_j("packed"),
        seen=_j("seen"), hit_cnt=jnp.zeros_like(_j("seen")),
        miss_cnt=jnp.zeros_like(_j("seen")))
    with jax.disable_jit():
        ref = jpipe._sdf_from_state(CFG, jstate)
    return tpipe._sdf_from_state(TCFG, tstate), ref


def case_get_occupancy():
    with jax.disable_jit():
        ref = jquery.get_occupancy(CFG, _j("logodds"), jnp.asarray(POS))
    return tquery.get_occupancy(TCFG, _t("logodds"),
                                torch.from_numpy(POS)), ref


def case_grid_helpers():
    rng = np.random.default_rng(3)
    vox = rng.integers(-2, 50, (300, 3)).astype(np.int32)
    idx = rng.integers(0, 40 * 32 * 24, (300,)).astype(np.int32)
    with jax.disable_jit():
        ref = (jgrid.vox_to_pos(CFG, jnp.asarray(vox)),
               jgrid.idx_to_vox(CFG, jnp.asarray(idx)),
               jgrid.pos_in_map(CFG, jnp.asarray(POS)))
    got = (tgrid.vox_to_pos(TCFG, torch.from_numpy(vox)),
           tgrid.idx_to_vox(TCFG, torch.from_numpy(idx)),
           tgrid.pos_in_map(TCFG, torch.from_numpy(POS)))
    return got, ref


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_query_matches_jax(name):
    got, ref = CASES[name]()
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _eq(g, r)


def test_fixture_covers_the_edge_cases():
    pos = torch.from_numpy(POS)
    in_map = tgrid.pos_in_map(TCFG, pos)
    assert bool(in_map.any()) and not bool(in_map.all())
    d = tquery.get_distance(TCFG, _tdist(), pos)
    assert bool((d == TCFG.infinity_distance).any())      # unobserved
    assert bool(((d > 0) & (d < TCFG.infinity_distance)).any())
    pts, dist = tquery.get_closest_obstacle(TCFG, _t("packed"), _t("d2"),
                                            _t("seen"), pos)
    assert bool(torch.isnan(pts).any()) and bool(torch.isfinite(pts).any())
