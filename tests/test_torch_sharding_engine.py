"""fiesta_tpu_torch's sharded engines against fiesta_tpu.parallel (CPU).

``ShardedFiestaPipeline`` and ``ShardedScrollingFiestaPipeline`` of both
packages are fed the same replays (made from seeds by the JAX package's
``replay.make_sequence``): JAX's on conftest's 8-device virtual CPU mesh,
the port's on virtual CPU meshes (``make_mesh(n, ["cpu"] * n)``).  The
states (the port's gathered from its slabs), the archives and the signed
field must be bit-equal; the rollout-sharded planner must come within the
planner's tolerances (``tests/test_torch_mpc.py``) of JAX's sharded solve
from JAX's draws and within 1e-5 of the port's own single-device solve
from the same generator.  One test for each of ``tests/test_sharding.py``'s
engine-level functions but the CLI's (``test_torch_sharding_app.py``), on
its grids (64x40x24 at 0.1 m, 60x80 scans).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu import FiestaConfig  # noqa: E402
from fiesta_tpu.archive import TileArchive as JArchive  # noqa: E402
from fiesta_tpu.io import replay as jreplay  # noqa: E402
from fiesta_tpu.ops.query import signed_distance_grid  # noqa: E402
from fiesta_tpu.grid import occupied_grid as joccupied  # noqa: E402
from fiesta_tpu.parallel import engine as jengine  # noqa: E402
from fiesta_tpu.parallel import sharding as jsh  # noqa: E402
from fiesta_tpu.planning import mpc as jmpc  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import grid as tgrid  # noqa: E402
from fiesta_tpu_torch.archive import TileArchive  # noqa: E402
from fiesta_tpu_torch.parallel import engine as tengine  # noqa: E402
from fiesta_tpu_torch.parallel import sharding  # noqa: E402
from fiesta_tpu_torch.planning import mpc as tmpc  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs conftest's 8-device CPU mesh")

H, W = 60, 80


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**over):
    """tests/test_sharding.py's engine grid: 64x40x24, 60x80 scans."""
    base = dict(resolution=0.1, origin=(-3.2, -2.0, -1.2),
                map_size=(6.4, 4.0, 2.4), min_ray_length=0.2,
                max_ray_length=1.5, trunc_dist=1.2, edt_fine_dist=1.2,
                esdf_mode="rebuild", global_update=True)
    base.update(over)
    return dataclasses.replace(
        jreplay.scale_intrinsics(FiestaConfig(**base), H, W),
        max_points_per_scan=H * W)


def _port(cfg):
    return ft.config_from_fields(dataclasses.asdict(cfg))


def _mesh(n):
    return sharding.make_mesh(n, ["cpu"] * n)


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype == bool and got.dtype == np.uint8:
        want = want.astype(np.uint8)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _same_state(tp, jp, what=""):
    for f in tgrid.FIELDS:
        _same(getattr(tp.state, f), getattr(jp.state, f), f"{what} {f}")


def _drive(pipe, frames, update_every=3, kind="cloud", flush=False):
    """tests/test_sharding.py's feed: the synchroniser releases a scan once
    a newer pose exists, so each frame is followed by the next pose (the
    last by a pose a second later)."""
    observe = pipe.observe_depth if kind == "depth" else pipe.observe_cloud
    for i, (t, (pos, quat), scan) in enumerate(frames):
        pipe.observe_pose(t, pos, quat)
        observe(t, scan)
        if i + 1 < len(frames):
            pipe.observe_pose(frames[i + 1][0], *frames[i + 1][1])
        else:
            pipe.observe_pose(t + 1.0, pos, quat)
        pipe.process()
        if i % update_every == update_every - 1:
            pipe.update()
    if flush:
        pipe.update()
    return pipe


def _frames(cfg, **kw):
    args = dict(n_frames=6, n_boxes=4, seed=3, height=H, width=W,
                orbit_radius=0.8, orbit_z=0.3, period=6.0)
    args.update(kw)
    return jreplay.make_sequence(cfg, **args)[1]


# ---------------------------------------------------------------------------
# The engine and the planner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """Both packages' sharded engines after 6 frames, a tick a third."""
    cfg = _cfg()
    frames = _frames(cfg)
    jp = _drive(jengine.ShardedFiestaPipeline(cfg, mesh=jsh.make_mesh(8),
                                              scans_per_tick=3), frames)
    tps = {n: _drive(tengine.ShardedFiestaPipeline(
        _port(cfg), mesh=_mesh(n), scans_per_tick=3), frames)
        for n in (2, 8)}
    return cfg, jp, tps


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_pipeline_matches_single_device_engine(engines, n):
    """The observe / process / update engine bit-equal to JAX's sharded
    one (tests/test_sharding.py:290-391), its queries on the gathered
    map, and the rollout-sharded planner: within the planner's
    tolerances of JAX's sharded solve from JAX's draws, and within 1e-5
    of the port's single-device ``plan_step`` from the same generator."""
    cfg, jp, tps = engines
    tp = tps[n]
    _same_state(tp, jp)
    assert bool((tp.state.logodds != 0).any())
    q = np.asarray([[0.0, 0.0, 0.0], [0.5, -0.3, 0.1]])
    _same(tp.query_distance(q), jp.query_distance(q))

    m = jmpc.MPCConfig(n_rollouts=64, horizon=8, refine_steps=2)
    tm = tmpc.mpc_config_from_fields(dataclasses.asdict(m))
    goal = np.asarray([0.5, 0.5, 0.0])
    jp.cur_pos = tp.cur_pos = np.zeros(3)
    want = jp.plan(goal, m, key=jax.random.PRNGKey(0))
    normals = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(0), (m.horizon, 3, m.n_rollouts), jnp.float32)))
    tp.plan(goal, tm)                       # builds the planner and grids
    zeros = torch.zeros(3)
    got = tp._planner(tp._dist_cache, zeros, zeros,
                      torch.tensor(goal, dtype=torch.float32),
                      torch.zeros((m.horizon, 3)), normals=normals)
    assert np.abs(got.controls.numpy() - np.asarray(want.controls)).max() \
        < 1e-3
    assert np.abs(got.positions.numpy()
                  - np.asarray(want.positions)).max() < 1e-3
    for field in ("cost", "best_sample_cost", "mean_sample_cost"):
        g, w = float(getattr(got, field)), float(getattr(want, field))
        assert abs(g - w) <= 1e-3 * abs(w), (field, g, w)

    sharded = tp.plan(goal, tm, generator=torch.Generator().manual_seed(5))
    single = tmpc.plan_step(tp.cfg, tm, tp.distance_grid(), zeros, zeros,
                            torch.tensor(goal, dtype=torch.float32),
                            torch.zeros((m.horizon, 3)),
                            torch.Generator().manual_seed(5))
    np.testing.assert_allclose(sharded.controls.numpy(),
                               single.controls.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(sharded.cost), float(single.cost),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="must divide"):
        tp.plan(goal, dataclasses.replace(tm, n_rollouts=63))


def test_sharded_pipeline_depth_input():
    """Depth images back-projected at observe time, then the sharded
    tick: bit-equal to JAX's sharded depth engine."""
    cfg = _cfg(max_ray_length=2.2)
    frames = _frames(cfg, n_boxes=6, kind="depth", orbit_z=0.0)
    jp = _drive(jengine.ShardedFiestaPipeline(cfg, mesh=jsh.make_mesh(8),
                                              scans_per_tick=3),
                frames, kind="depth", flush=True)
    tp = _drive(tengine.ShardedFiestaPipeline(_port(cfg), mesh=_mesh(8),
                                              scans_per_tick=3),
                frames, kind="depth", flush=True)
    _same_state(tp, jp)
    assert int(tp.occupied().sum()) > 0


def test_sharded_sdf_matches_single_device():
    """The signed field on the mesh (interior EDT on the slabs) bit-equal
    to JAX's sharded one and to ``query.signed_distance_grid``; a signed
    solve reads it."""
    cfg = _cfg(max_ray_length=2.2, signed_needed=True)
    frames = _frames(cfg, n_boxes=6, orbit_z=0.0)
    jp = _drive(jengine.ShardedFiestaPipeline(cfg, mesh=jsh.make_mesh(8),
                                              scans_per_tick=3),
                frames, flush=True)
    tp = _drive(tengine.ShardedFiestaPipeline(_port(cfg), mesh=_mesh(8),
                                              scans_per_tick=3),
                frames, flush=True)
    _same_state(tp, jp)
    sdf = tp.sdf_grid()
    _same(sdf, jp.sdf_grid())
    _same(sdf, signed_distance_grid(cfg, jp.state.d2, jp.state.seen,
                                    joccupied(cfg, jp.state.logodds)))
    assert tp.sdf_grid() is sdf                  # cached for the tick
    occ = tp.occupied().numpy()
    assert occ.any() and (sdf.numpy()[occ] <= 0).all()
    res = tp.plan(np.asarray([0.5, 0.5, 0.0]), tmpc.MPCConfig(
        n_rollouts=64, horizon=6, refine_steps=2, signed=True))
    assert res.controls.shape == (6, 3) and tp._dist_cache_signed is True


# ---------------------------------------------------------------------------
# The unbounded world
# ---------------------------------------------------------------------------


def test_sharded_scrolling_archive_matches_single_device():
    """ShardedScrollingFiestaPipeline (2 shards; JAX's on 8): recenters
    with the archive's eviction and restore, bit-equal to JAX's sharded
    one (tests/test_sharding.py:523-601)."""
    cfg = _cfg(max_ray_length=2.2)
    frames = _frames(cfg, n_frames=24, n_boxes=8, seed=6, orbit_radius=1.8,
                     orbit_z=0.2, period=1.0)
    jp = _drive(jengine.ShardedScrollingFiestaPipeline(
        cfg, mesh=jsh.make_mesh(8), scans_per_tick=1, archive=JArchive()),
        frames, update_every=1)
    tp = _drive(tengine.ShardedScrollingFiestaPipeline(
        _port(cfg), mesh=_mesh(2), scans_per_tick=1,
        archive=TileArchive()), frames, update_every=1)
    assert tp.scroll_count == jp.scroll_count > 0
    assert tp.restore_count == jp.restore_count > 0
    np.testing.assert_array_equal(tp.origin_vox, jp.origin_vox)
    assert sorted(tp.archive.tiles) == sorted(jp.archive.tiles)
    for key, tile in jp.archive.tiles.items():
        for name in ("logodds", "seen"):
            _same(tp.archive.tiles[key][name], tile[name], f"{key} {name}")
    _same_state(tp, jp)
    q = np.asarray([[0.5, 0.5, 0.2], [-0.5, 1.0, 0.0]])
    _same(tp.query_distance(q), jp.query_distance(q))
