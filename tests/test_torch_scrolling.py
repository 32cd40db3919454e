"""fiesta_tpu_torch's unbounded world against fiesta_tpu (CPU).

``scroll_state`` in both closest formats; ``ScrollingFiestaPipeline``
(recentering, the persistent fixed-step recenter, strip archive and
restore, hydration, the pending-counter drain, the world-frame queries)
in both ``esdf_mode``s, each case run on both packages and compared bit
for bit (states, ``origin_vox``, scroll and restore counts, archive
tiles); the persistent engine against a fixed grid covering the whole
world; the ``TileArchive`` copy on ``tests/test_archive.py``'s cases; and
checkpoints written by either package loaded by the other, anchor and
pre-u8 ``seen`` included.  The cases are ``tests/test_scrolling.py``'s and
``tests/test_archive.py``'s, less the CLI.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu import FiestaConfig  # noqa: E402
from fiesta_tpu import archive as jarchive  # noqa: E402
from fiesta_tpu import checkpoint as jcheckpoint  # noqa: E402
from fiesta_tpu import grid as jgrid  # noqa: E402
from fiesta_tpu import scrolling as jscroll  # noqa: E402
from fiesta_tpu.io import replay as jreplay  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import archive as tarchive  # noqa: E402
from fiesta_tpu_torch import checkpoint as tcheckpoint  # noqa: E402
from fiesta_tpu_torch import grid as tgrid  # noqa: E402
from fiesta_tpu_torch import scrolling as tscroll  # noqa: E402
from fiesta_tpu_torch.ops import esdf as tesdf  # noqa: E402

MODES = ["rebuild", "incremental"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the plain relaxation is thousands of small
    tensor ops, and the suite's workers share the CPU, where more threads
    only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# tests/test_scrolling.py's grid: 40 x 40 x 20 at 0.1 m
SCFG = jreplay.scale_intrinsics(FiestaConfig(
    resolution=0.1, origin=(-2.0, -2.0, -0.5), map_size=(4.0, 4.0, 2.0),
    min_ray_length=0.3, max_ray_length=4.0, max_points_per_scan=60 * 80),
    height=60, width=80)

# tests/test_archive.py's grid: 40 x 40 x 20, exact EDT to 2 m
ACFG = FiestaConfig(resolution=0.1, origin=(-2.0, -2.0, -1.0),
                    map_size=(4.0, 4.0, 2.0), trunc_dist=2.0,
                    edt_fine_dist=2.0)


def _port(cfg):
    return ft.config_from_fields(dataclasses.asdict(cfg))


def _same(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    if ref.dtype == bool and got.dtype == np.uint8:
        # the JAX engine's hydration leaves a bool ``seen`` (ROADMAP C)
        ref = ref.astype(np.uint8)
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    if got.dtype == np.float32:
        got, ref = got.view(np.int32), ref.view(np.int32)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _same_state(tstate, jstate, what=""):
    for f in tgrid.FIELDS:
        _same(getattr(tstate, f), getattr(jstate, f), f"{what} {f}")


def _same_archive(ta, ja):
    assert ta.tile_shape == ja.tile_shape
    assert sorted(ta.tiles) == sorted(ja.tiles)
    for key, tile in ja.tiles.items():
        for name in ("logodds", "seen"):
            _same(ta.tiles[key][name], tile[name], f"tile {key} {name}")


def _same_pipes(tp, jp, what=""):
    _same_state(tp.state, jp.state, what)
    np.testing.assert_array_equal(tp.origin_vox, jp.origin_vox)
    assert tp.scroll_count == jp.scroll_count
    assert tp.restore_count == jp.restore_count
    if jp.archive is not None:
        _same_archive(tp.archive, jp.archive)


def _pipes(cfg, **kw):
    """The scrolling engine on both packages (the port's on the CPU)."""
    return (tscroll.ScrollingFiestaPipeline(_port(cfg), device="cpu", **kw),
            jscroll.ScrollingFiestaPipeline(cfg, **kw))


def _to_jax(state):
    return jgrid.MapState(**{f: jnp.asarray(getattr(state, f).numpy())
                             for f in tgrid.FIELDS})


# ---------------------------------------------------------------------------
# scroll_state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_scroll_state_matches_jax(mode):
    """Random content in both closest formats (packed in rebuild mode,
    [3,X,Y,Z] planes in incremental), shifted inside the grid, by a whole
    axis and beyond it."""
    cfg = dataclasses.replace(ACFG, esdf_mode=mode)
    tc = _port(cfg)
    rng = np.random.default_rng(2)
    shape = cfg.grid_shape
    occ = rng.random(shape) < 0.02
    d2, closest = tesdf.build_esdf(torch.from_numpy(occ))
    state = ft.make_state(tc, device="cpu")
    if tgrid.closest_packed_state(tc):
        closest = tgrid.pack_closest(closest)
    state = dataclasses.replace(
        state, d2=d2, closest=closest,
        logodds=torch.from_numpy(rng.normal(size=shape).astype(np.float32)),
        seen=torch.from_numpy((rng.random(shape) < 0.5).astype(np.uint8)),
        hit_cnt=torch.from_numpy(rng.integers(0, 9, shape).astype(np.uint8)),
        miss_cnt=torch.from_numpy(rng.integers(0, 9, shape).astype(np.uint8)))
    assert state.closest.dim() == (3 if mode == "rebuild" else 4)
    for shift in ([5, -3, 0], [-12, 7, 3], [0, 0, -19], [40, 0, 0],
                  [-41, 2, 1]):
        got = tscroll.scroll_state(state, np.array(shift, np.int64))
        ref = jscroll.scroll_state(_to_jax(state),
                                   jnp.asarray(shift, jnp.int32))
        _same_state(got, ref, f"shift {shift}")


@pytest.mark.parametrize("mode", MODES)
def test_scroll_moves_content_and_evicts_closest(mode):
    """``tests/test_scrolling.py``'s two scroll_state cases: the obstacle
    and its distances move with the content, the entered region is
    unknown, and voxels whose obstacle leaves the grid lose it."""
    cfg = _port(dataclasses.replace(SCFG, esdf_mode=mode))
    for vox, shift in (((20, 20, 10), [5, -3, 0]), ((2, 20, 10), [10, 0, 0])):
        occ = torch.zeros(cfg.grid_shape, dtype=torch.bool)
        occ[vox] = True
        state = ft.make_state(cfg, device="cpu")
        d2, closest, _ = tesdf.update_esdf(state.d2, state.closest, occ, occ,
                                           None, None, cfg.stencil)
        state = dataclasses.replace(
            state, d2=d2, closest=closest,
            logodds=torch.where(occ, 5.0, 0.0),
            seen=torch.ones(cfg.grid_shape, dtype=torch.uint8))
        out = tscroll.scroll_state(state, np.array(shift))
        cl = (tgrid.unpack_closest(out.closest) if out.closest.dim() == 3
              else out.closest)
        if shift[0] == 5:
            assert float(out.logodds[15, 23, 10]) == 5.0
            assert int(out.d2[15, 23, 10]) == 0
            assert cl[:, 15, 23, 10].tolist() == [15, 23, 10]
            assert int(out.d2[17, 23, 10]) == 4
            assert not bool(out.seen[-1, 0, 0])
            assert int(out.d2[-1, 0, 0]) == tgrid.INF_D2
        else:
            assert int(out.d2[0, 20, 10]) == tgrid.INF_D2
            assert int(cl[0, 0, 20, 10]) == -1


# ---------------------------------------------------------------------------
# the scrolling engine
# ---------------------------------------------------------------------------


def _feed(pipes, frames, update_every=3, kind="cloud"):
    for pipe in pipes:
        for i, (t, (pos, quat), scan) in enumerate(frames):
            pipe.observe_pose(t, pos, quat)
            (pipe.observe_cloud if kind == "cloud" else pipe.observe_depth)(
                t, scan)
            if i + 1 < len(frames):
                pipe.observe_pose(frames[i + 1][0], *frames[i + 1][1])
            pipe.process()
            if i % update_every == update_every - 1:
                pipe.update()
        pipe.observe_pose(frames[-1][0] + 1.0, *frames[-1][1])
        pipe.process()
        pipe.update()


@pytest.mark.parametrize("mode", MODES)
def test_scrolling_pipeline_follows_robot(mode):
    """An orbit far beyond the grid: the map scrolls and follows the
    robot, the mapped voxels agree with the world, and the port equals
    the JAX engine after every frame's recenter and update."""
    cfg = dataclasses.replace(SCFG, esdf_mode=mode)
    world_cfg = dataclasses.replace(cfg, origin=(-8.0, -8.0, -0.5),
                                    map_size=(16.0, 16.0, 2.0))
    world, frames = jreplay.make_sequence(
        world_cfg, n_frames=12, n_boxes=10, seed=4, height=60, width=80,
        orbit_radius=5.0, period=4.0)
    tp, jp = _pipes(cfg, recenter_fraction=0.2)
    _feed((tp, jp), frames)
    assert tp.scroll_count > 0
    _same_pipes(tp, jp)
    center = tp.world_origin + np.asarray(cfg.map_size) / 2
    assert np.linalg.norm((frames[-1][1][0] - center)[:2]) < 2.5
    assert int(tp.state.seen.sum()) > 1000
    pts = tp.occupied_world_points()
    np.testing.assert_array_equal(pts, jp.occupied_world_points())
    if len(pts):       # as tests/test_scrolling.py: the orbit may map none
        from scipy import ndimage

        true_dist = ndimage.distance_transform_edt(
            ~world.occupied_voxels(world_cfg))
        vox = np.floor((pts - np.asarray(world_cfg.origin))
                       / world_cfg.resolution).astype(int)
        inside = np.all((vox >= 0) & (vox < true_dist.shape), axis=1)
        assert (true_dist[tuple(vox[inside].T)] <= 2.0).mean() > 0.9


def test_scroll_rebases_depth_filter_transform():
    tp, jp = _pipes(SCFG)
    for pipe in (tp, jp):
        t = np.eye(4)
        t[:3, 3] = [1.0, 2.0, 0.5]
        pipe.last_transform = t
        pipe.cur_pos = np.array([0.3, 0.2, 0.1])
        pipe._apply_scroll(np.array([10, 0, -5], np.int64))
    np.testing.assert_allclose(tp.last_transform[:3, 3], [0.0, 2.0, 1.0])
    np.testing.assert_array_equal(tp.last_transform, jp.last_transform)
    np.testing.assert_array_equal(tp.cur_pos, jp.cur_pos)
    _same_pipes(tp, jp)


@pytest.mark.parametrize("mode", MODES)
def test_scrolling_closest_query_world_frame(mode):
    """World-frame closest-obstacle queries after a recenter
    (``tests/test_scrolling.py``): equal to JAX's, to the distance query,
    and pointing at occupied voxels in world coordinates."""
    cfg = dataclasses.replace(SCFG, trunc_dist=1.5, edt_fine_dist=1.5,
                              esdf_mode=mode)
    _, frames = jreplay.make_sequence(cfg, n_frames=6, n_boxes=6, seed=3,
                                      height=60, width=80, orbit_radius=0.8,
                                      period=4.0)
    tp, jp = _pipes(cfg)
    _feed((tp, jp), frames)
    for pipe in (tp, jp):
        pipe._apply_scroll(np.array([7, -4, 0], np.int64))
        pipe._rederive_distances()
    _same_pipes(tp, jp)
    occ_pts = tp.occupied_world_points()
    assert occ_pts.shape[0] > 0
    q = occ_pts[:5] + np.asarray([0.15, 0.0, 0.0])
    pts, dist = tp.query_closest_obstacle(q)
    with jax.disable_jit():
        r_pts, r_dist = jp.query_closest_obstacle(q)
        r_d = jp.query_distance(q)
    _same(pts, r_pts, "points")
    _same(dist, r_dist, "dist")
    dd = tp.query_distance(q)
    _same(dd, r_d, "distance")
    pts, dist, dd = pts.numpy(), dist.numpy(), dd.numpy()
    for i in range(len(q)):
        if dist[i] < cfg.infinity_distance:
            assert abs(dist[i] - dd[i]) < 1e-5
            assert np.linalg.norm(occ_pts - pts[i], axis=1).min() < \
                cfg.resolution * 0.51


# ---------------------------------------------------------------------------
# the persistent world (tests/test_archive.py)
# ---------------------------------------------------------------------------


def _plant_obstacle(pipe):
    """A fully observed map with one obstacle at world voxel (20, 20, 10),
    distances derived as an update would derive them."""
    lo = np.zeros(pipe.cfg.grid_shape, np.float32)
    lo[20, 20, 10] = 5.0
    if isinstance(pipe, tscroll.ScrollingFiestaPipeline):
        pipe.state = dataclasses.replace(
            pipe.state, logodds=torch.from_numpy(lo),
            seen=torch.ones(pipe.cfg.grid_shape, dtype=torch.uint8))
        occ = ft.occupied_grid(pipe.cfg, pipe.state.logodds)
        d2, closest, _ = tesdf.update_esdf(
            pipe.state.d2, pipe.state.closest, occ, occ, None, None,
            pipe.cfg.relax_dirs) if pipe.cfg.esdf_mode != "rebuild" else \
            (ft.pipeline.rebuild_d2(pipe.cfg, occ), pipe.state.closest, None)
    else:
        from fiesta_tpu.ops import esdf as jesdf
        from fiesta_tpu.pipeline import rebuild_d2_jit

        pipe.state = dataclasses.replace(
            pipe.state, logodds=jnp.asarray(lo),
            seen=jnp.ones(pipe.cfg.grid_shape, jnp.uint8))
        occ = jgrid.occupied_grid(pipe.cfg, pipe.state.logodds)
        d2, closest, _ = jesdf.update_esdf(
            pipe.state.d2, pipe.state.closest, occ, occ, jnp.zeros_like(occ),
            None, pipe.cfg.relax_dirs) if pipe.cfg.esdf_mode != "rebuild" \
            else (rebuild_d2_jit(pipe.cfg, occ), pipe.state.closest, None)
    pipe.state = dataclasses.replace(pipe.state, d2=d2, closest=closest)


def _walk(pipe, x):
    """Recenter toward world x until the grid settles."""
    for _ in range(64):
        if not pipe.maybe_recenter(np.array([x, 0.05, 0.05])):
            return
    raise AssertionError("recentering did not settle")


@pytest.mark.parametrize("mode", MODES)
def test_persistent_scroll_restores_explored_world(mode):
    """Fly away until the obstacle is evicted and back: the archive
    restores it and its distances; without an archive the same trip
    forgets it.  Bit-equal to the JAX engine after each leg."""
    cfg = dataclasses.replace(ACFG, esdf_mode=mode)
    tp, jp = _pipes(cfg, archive=True)
    probe = np.array([[0.05, 0.55, 0.05]])
    for pipe in (tp, jp):
        _plant_obstacle(pipe)
    d_before = float(tp.query_distance(probe)[0])
    assert abs(d_before - 0.5) < 1e-5
    for x in (8.0, 0.05):
        for pipe in (tp, jp):
            _walk(pipe, x)
        _same_pipes(tp, jp, f"at x = {x}")
        if x == 8.0:
            assert tp.origin_vox[0] > 21 and tp.archive.num_tiles > 0
            assert not bool(ft.occupied_grid(tp.cfg, tp.state.logodds).any())
    assert tp.restore_count > 0
    gv = tuple(np.array([20, 20, 10]) - tp.origin_vox)
    assert float(tp.state.logodds[gv]) == 5.0 and bool(tp.state.seen[gv])
    assert int(tp.state.d2[gv]) == 0
    assert abs(float(tp.query_distance(probe)[0]) - d_before) < 1e-5

    plain = tscroll.ScrollingFiestaPipeline(_port(cfg), device="cpu")
    _plant_obstacle(plain)
    _walk(plain, 8.0)
    _walk(plain, 0.05)
    assert not bool(ft.occupied_grid(plain.cfg, plain.state.logodds).any())


@pytest.mark.parametrize("mode", MODES)
def test_preloaded_archive_hydrates_initial_window(mode):
    """A new engine over a loaded directory answers queries over explored
    space, and re-storing its window keeps the directory's content."""
    cfg = dataclasses.replace(ACFG, esdf_mode=mode)
    tp1, jp1 = _pipes(cfg, archive=True)
    for pipe in (tp1, jp1):
        _plant_obstacle(pipe)
        pipe.archive.store(pipe.origin_vox, np.asarray(pipe.state.logodds),
                           np.asarray(pipe.state.seen))
    n_seen = tp1.archive.seen_voxels()
    assert n_seen > 0
    tp2 = tscroll.ScrollingFiestaPipeline(_port(cfg), archive=tp1.archive,
                                          device="cpu")
    jp2 = jscroll.ScrollingFiestaPipeline(cfg, archive=jp1.archive)
    _same_pipes(tp2, jp2)
    assert float(tp2.state.logodds[20, 20, 10]) == 5.0
    assert int(tp2.state.d2[20, 20, 10]) == 0
    d = float(tp2.query_distance(np.array([[0.05, 0.55, 0.05]]))[0])
    assert abs(d - 0.5) < 1e-5
    tp2.archive.store(tp2.origin_vox, tp2.state.logodds.numpy(),
                      tp2.state.seen.numpy())
    assert tp2.archive.seen_voxels() == n_seen


@pytest.mark.parametrize("mode", MODES)
def test_pending_counters_fused_before_eviction(mode):
    """Counters not yet drained survive eviction and restore."""
    cfg = dataclasses.replace(ACFG, esdf_mode=mode)
    tp, jp = _pipes(cfg, archive=True)
    hit = np.zeros(cfg.grid_shape, np.uint8)
    hit[5, 20, 10] = 1
    miss = hit.copy()
    tp.state = dataclasses.replace(tp.state, hit_cnt=torch.from_numpy(hit),
                                   miss_cnt=torch.from_numpy(miss))
    jp.state = dataclasses.replace(jp.state, hit_cnt=jnp.asarray(hit),
                                   miss_cnt=jnp.asarray(miss))
    for x in (8.0, 0.05):
        for pipe in (tp, jp):
            _walk(pipe, x)
        _same_pipes(tp, jp, f"at x = {x}")
    gv = tuple(np.array([5, 20, 10]) - tp.origin_vox)
    assert float(tp.state.logodds[gv]) > 0.0 and bool(tp.state.seen[gv])


@pytest.mark.parametrize("mode", MODES)
def test_persistent_scrolling_matches_fixed_grid(mode):
    """``tests/test_archive.py``'s equivalence oracle, on the port: a
    persistent scrolling engine over a 6 m window and a fixed engine over
    the whole 12 m world, fed the same scans (an orbit that leaves the
    first window and comes back), hold bit-identical log-odds and seen in
    the final window, and (rebuild mode) equal distances away from its
    faces; the scrolling engine is also bit-equal to the JAX one.  The
    fixed engine rebuilds in both cases: log-odds and seen do not depend
    on the ESDF engine."""
    h, w = 30, 40
    world_cfg = jreplay.scale_intrinsics(FiestaConfig(
        resolution=0.1, origin=(-6.0, -6.0, -1.0), map_size=(12.0, 12.0, 2.0),
        min_ray_length=0.3, max_ray_length=1.5, trunc_dist=1.5,
        edt_fine_dist=1.5, max_points_per_scan=h * w), height=h, width=w)
    small_cfg = dataclasses.replace(world_cfg, origin=(-3.0, -3.0, -1.0),
                                    map_size=(6.0, 6.0, 2.0), esdf_mode=mode)
    # a full orbit (radius 4 m > the window's half 3 m) in 17 frames
    _, frames = jreplay.make_sequence(
        world_cfg, n_frames=17, n_boxes=12, seed=5, height=h, width=w,
        period=0.5, orbit_radius=4.0, orbit_z=0.0)
    big = ft.FiestaPipeline(_port(world_cfg), method="scanline",
                            device="cpu")
    tp, jp = _pipes(small_cfg, archive=True)
    _feed((big, tp, jp), frames, update_every=1)
    assert tp.scroll_count > 0 and tp.restore_count > 0
    _same_pipes(tp, jp)
    off = np.round((tp.world_origin - np.asarray(world_cfg.origin))
                   / world_cfg.resolution).astype(int)
    sx, sy, sz = small_cfg.grid_shape
    sl = (slice(off[0], off[0] + sx), slice(off[1], off[1] + sy),
          slice(off[2], off[2] + sz))
    _same(tp.state.seen, big.state.seen[sl], "seen")
    _same(tp.state.logodds, big.state.logodds[sl], "logodds")
    if mode == "rebuild":
        shrink = int(world_cfg.trunc_dist / world_cfg.resolution) + 2
        inner = (slice(shrink, sx - shrink), slice(shrink, sy - shrink))
        _same(tp.state.d2[inner], big.state.d2[sl][inner], "d2")
        assert int(tp.state.seen[inner].sum()) > 100


# ---------------------------------------------------------------------------
# TileArchive (tests/test_archive.py:21-71) and checkpoints
# ---------------------------------------------------------------------------


def test_archive_roundtrip_and_file_cross_load(tmp_path):
    """Boxes straddling tiles at negative world voxels, a far box never
    touched, and the directory file written by each package read by the
    other."""
    rng = np.random.default_rng(0)
    shape, world_lo = (13, 9, 6), (-5, -3, -2)
    lo = rng.normal(size=shape).astype(np.float32)
    seen = rng.random(shape) < 0.7
    ta = tarchive.TileArchive(tile_shape=(8, 8, 4))
    ja = jarchive.TileArchive(tile_shape=(8, 8, 4))
    for arch in (ta, ja):
        arch.store(world_lo, lo, seen)
    _same_archive(ta, ja)
    got_lo, got_seen, any_data = ta.load(world_lo, shape)
    assert any_data
    np.testing.assert_array_equal(got_lo, lo)
    np.testing.assert_array_equal(got_seen, seen)
    far_lo, far_seen, far_any = ta.load((1000, 1000, 1000), (4, 4, 4))
    assert not far_any and not far_seen.any() and (far_lo == 0).all()
    ta.save(str(tmp_path / "port.npz"))
    ja.save(str(tmp_path / "jax.npz"))
    _same_archive(tarchive.TileArchive.from_file(str(tmp_path / "jax.npz")),
                  ja)
    _same_archive(ta, jarchive.TileArchive.from_file(
        str(tmp_path / "port.npz")))


def test_archive_skips_unseen_and_keeps_partial_tiles():
    arch = tarchive.TileArchive(tile_shape=(8, 8, 8))
    lo = np.zeros((16, 8, 8), np.float32)
    seen = np.zeros((16, 8, 8), bool)
    seen[2, 3, 4] = True
    arch.store((0, 0, 0), lo, seen)
    assert arch.num_tiles == 1 and arch.seen_voxels() == 1
    arch.store((0, 0, 0), lo, np.zeros_like(seen))      # forgetting sticks
    assert arch.num_tiles == 1 and arch.seen_voxels() == 0
    arch = tarchive.TileArchive(tile_shape=(8, 8, 8))
    arch.store((0, 0, 0), np.full((8, 8, 8), 2.0, np.float32),
               np.ones((8, 8, 8), bool))
    arch.store((0, 0, 0), np.full((2, 2, 2), -1.0, np.float32),
               np.ones((2, 2, 2), bool))
    got, _, _ = arch.load((0, 0, 0), (8, 8, 8))
    assert (got[:2, :2, :2] == -1.0).all() and (got[4:, 4:, 4:] == 2.0).all()
    _, _, any_data = arch.load((4, 4, 4), (4, 4, 4))
    assert any_data                                     # seen corner data
    seen = np.zeros((8, 8, 8), bool)
    seen[0, 0, 0] = True
    arch = tarchive.TileArchive(tile_shape=(8, 8, 8))
    arch.store((0, 0, 0), np.ones((8, 8, 8), np.float32), seen)
    assert not arch.load((4, 4, 4), (4, 4, 4))[2]       # unseen overlap
    assert arch.load((0, 0, 0), (2, 2, 2))[2]


@pytest.mark.parametrize("mode", MODES)
def test_checkpoints_cross_load(tmp_path, mode):
    """A scrolling engine's checkpoint with its anchor, saved by each
    package and loaded by the other; a fixed-grid one has no anchor; a
    bool ``seen`` (before the u8 migration) loads as u8."""
    cfg = dataclasses.replace(ACFG, esdf_mode=mode)
    tp, jp = _pipes(cfg, archive=True)
    for pipe in (tp, jp):
        _plant_obstacle(pipe)
        _walk(pipe, 8.0)
    _same_pipes(tp, jp)
    t_path, j_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tcheckpoint.save(t_path, tp.cfg, tp.state, origin_vox=tp.origin_vox)
    jcheckpoint.save(j_path, cfg, jp.state, origin_vox=jp.origin_vox)
    cfg_j, state_j = jcheckpoint.load(t_path)
    cfg_t, state_t = tcheckpoint.load(j_path, device="cpu")
    assert cfg_j == cfg and cfg_t == tp.cfg
    _same_state(state_t, jp.state)
    _same_state(tp.state, state_j)
    for path in (t_path, j_path):
        np.testing.assert_array_equal(tcheckpoint.load_anchor(path),
                                      tp.origin_vox)
        np.testing.assert_array_equal(jcheckpoint.load_anchor(path),
                                      tp.origin_vox)
    tcheckpoint.save(t_path, tp.cfg, tp.state)
    assert tcheckpoint.load_anchor(t_path) is None
    assert jcheckpoint.load_anchor(t_path) is None
    # a checkpoint from before the u8 migration: bool seen
    arrays = {f: getattr(tp.state, f).numpy() for f in tgrid.FIELDS}
    arrays["seen"] = arrays["seen"].astype(bool)
    np.savez_compressed(str(tmp_path / "old"), **arrays, __config__=np.asarray(
        __import__("json").dumps(dataclasses.asdict(cfg))))
    _, old = tcheckpoint.load(str(tmp_path / "old.npz"), device="cpu")
    assert old.seen.dtype == torch.uint8
    _same_state(old, jcheckpoint.load(str(tmp_path / "old.npz"))[1])
