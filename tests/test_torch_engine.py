"""fiesta_tpu_torch app engine against fiesta_tpu (CPU).

``ScanSynchronizer`` and ``FiestaPipeline`` on both packages, fed the same
replayed clouds the way ``run.py`` feeds them: the map state after every
``update()`` and the query outputs must be bit-equal for each integrator
(scanline, DDA, projective), with a global and a local-window update.
The pieces are held to their JAX counterparts one by one too: the
single-scan integrators, the sensor-to-world transform, the update
windows, the windowed fusion drain and the lazy closest cache.  The JAX
package runs op by op (``jax.disable_jit()``) wherever f32 values meet.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu import FiestaConfig  # noqa: E402
from fiesta_tpu import grid as jgrid  # noqa: E402
from fiesta_tpu import pipeline as jpipe  # noqa: E402
from fiesta_tpu.io import replay as jreplay  # noqa: E402
from fiesta_tpu.ops import depth as jdepth  # noqa: E402
from fiesta_tpu.ops import fusion as jfusion  # noqa: E402
from fiesta_tpu.ops import raycast as jrc  # noqa: E402
from fiesta_tpu.ops.pallas import fuse as jfuse  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import grid as tgrid  # noqa: E402
from fiesta_tpu_torch import pipeline as tpipe  # noqa: E402
from fiesta_tpu_torch.ops import depth as tdepth  # noqa: E402
from fiesta_tpu_torch.ops import fusion as tfusion  # noqa: E402
from fiesta_tpu_torch.ops import raycast as trc  # noqa: E402

H, W = 24, 32
METHODS = ("scanline", "dda", "projective")


def engine_cfg(window: bool, **kw) -> FiestaConfig:
    """A 48x48x20 map at 0.1 m, 2 m rays, exact EDT to 1.2 m; with
    ``window`` a local update of 1.8 x 1.8 x 0.5 m around the robot."""
    return jreplay.scale_intrinsics(FiestaConfig(
        resolution=0.1, origin=(-2.4, -2.4, -0.5), map_size=(4.8, 4.8, 2.0),
        min_ray_length=0.3, max_ray_length=2.0, trunc_dist=1.2,
        edt_fine_dist=1.2, max_points_per_scan=H * W,
        global_update=not window, radius=(1.8, 1.8, 0.5), **kw), H, W)


def port_cfg(cfg):
    return ft.config_from_fields(dataclasses.asdict(cfg))


def replay(pipe, frames, kind="cloud"):
    """Frames at 30 Hz with the 10 Hz update every third frame, then a
    final pose that lets the synchronizer release the last frame
    (``tests/test_pipeline.py:31-59``).  Returns the state arrays and
    stats after every update."""
    out = []

    def update():
        stats = pipe.update()
        if stats is not None:
            out.append(({f: np.array(getattr(pipe.state, f))   # a copy
                         for f in tgrid.FIELDS},
                        tuple(int(s) for s in stats)))

    for i, (t, (pos, quat), scan) in enumerate(frames):
        pipe.observe_pose(t, pos, quat)
        (pipe.observe_cloud if kind == "cloud" else pipe.observe_depth)(
            t, scan)
        pipe.process()
        if i % 3 == 2:
            update()
    pipe.observe_pose(frames[-1][0] + 1.0, *frames[-1][1])
    pipe.process()
    update()
    return out


def query_positions(cfg, n=200, seed=0):
    rng = np.random.default_rng(seed)
    lo, size = np.asarray(cfg.origin), np.asarray(cfg.map_size)
    pos = (lo + rng.random((n, 3)) * size).astype(np.float32)
    pos[-2:] = [[99.0, 0.0, 0.0], [np.nan, 0.0, 0.0]]
    return pos


def assert_same(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    if got.dtype == np.float32:
        got, ref = got.view(np.int32), ref.view(np.int32)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def compare_replays(cfg, method, kind, frames):
    """Run both engines on ``frames``; assert every update's state and
    stats and the final queries bit-equal.  Returns the port engine."""
    with jax.disable_jit():
        jp = jpipe.FiestaPipeline(cfg, method=method)
        ref = replay(jp, frames, kind)
    tp = ft.FiestaPipeline(port_cfg(cfg), method=method, device="cpu")
    got = replay(tp, frames, kind)
    assert len(got) == len(ref) == 3
    for n, ((gs, gst), (rs, rst)) in enumerate(zip(got, ref)):
        for f in tgrid.FIELDS:
            assert_same(gs[f], rs[f], f"update {n}: {f}")
        assert gst == rst, f"update {n}: stats"
    pos = query_positions(cfg)
    with jax.disable_jit():
        r_d = jp.query_distance(pos)
        r_dg = jp.query_dist_grad(pos)
        r_co = jp.query_closest_obstacle(pos)
    assert_same(tp.query_distance(pos), r_d, "query_distance")
    for g, r, what in zip(tp.query_dist_grad(pos), r_dg, ("dist", "grad")):
        assert_same(g, r, f"query_dist_grad {what}")
    for g, r, what in zip(tp.query_closest_obstacle(pos), r_co,
                          ("points", "dist")):
        assert_same(g, r, f"query_closest_obstacle {what}")
    assert_same(tp.closest_grid(), jp.closest_grid(), "closest_grid")
    assert_same(tp.occupied(), jp.occupied(), "occupied")
    return tp, got


@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
@pytest.mark.parametrize("method", METHODS)
def test_cloud_replay_matches_jax(method, window):
    cfg = engine_cfg(window)
    _, frames = jreplay.make_sequence(cfg, n_frames=6, n_boxes=5, seed=3,
                                      height=H, width=W, orbit_radius=0.6)
    tp, got = compare_replays(cfg, method, "cloud", frames)
    assert int(tp.occupied().sum()) > 100
    assert all(stats[0] > 0 for _, stats in got)
    if window:
        # the window gates the drain: some observed voxels lie outside it
        full = engine_cfg(False)
        _, g_full = compare_replays_port_only(full, method, frames)
        assert got[0][1][0] < g_full[0][1][0]


def compare_replays_port_only(cfg, method, frames):
    tp = ft.FiestaPipeline(port_cfg(cfg), method=method, device="cpu")
    return tp, replay(tp, frames)


def test_synchronizer_matches_jax():
    """``tests/test_pipeline.py:118-142`` on both packages."""
    outs = []
    for cls in (jpipe.ScanSynchronizer, tpipe.ScanSynchronizer):
        s = cls(time_delay=3e-3)
        log = []
        s.push_depth(1.0, "d1")
        s.push_pose(0.99, [0, 0, 0], [1, 0, 0, 0])
        log.append(s.drain())
        s.push_pose(1.002, [1, 1, 1], [1, 0, 0, 0])
        s.push_pose(1.5, [2, 2, 2], [1, 0, 0, 0])
        log.append(s.drain())
        s.push_depth(0.5, "d0")
        log.append(s.drain())
        s.push_depth(1.4, "d2")
        s.push_pose(2.0, [3, 3, 3], [1, 0, 0, 0])
        log.append(s.drain())
        outs.append(log)
    jlog, tlog = outs
    assert [len(x) for x in tlog] == [0, 1, 0, 0]
    (payload, t, pos, quat), = tlog[1]
    assert payload == "d1" and t == 1.002 and pos[0] == 1
    assert [[(p, t, list(a), list(b)) for p, t, a, b in x] for x in tlog] \
        == [[(p, t, list(a), list(b)) for p, t, a, b in x] for x in jlog]


def _scan(seed, p=H * W):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2.5, 2.5, (p, 3)).astype(np.float32)
    pts[::17] = np.nan
    valid = np.isfinite(pts).all(-1) & (rng.random(p) < 0.95)
    ang = rng.uniform(-np.pi, np.pi, 3)
    quat = np.concatenate([[np.cos(ang[0])], np.sin(ang[0]) * ang[1:] / 4,
                           [0.3]])
    tf = jdepth.pose_to_matrix(rng.uniform(-0.5, 0.5, 3), quat)
    return pts, valid, np.asarray(tf, np.float32)


def test_sensor_to_world_matches_jax_dot():
    """The world transform of ``integrate_scan`` (``points @ r.T + t``)
    bit-equal to the JAX dot run op by op, and ``transform_cloud``."""
    pts, _, tf = _scan(1, 4096)
    pts = np.nan_to_num(pts)
    with jax.disable_jit():
        t = jnp.asarray(tf)
        ref = jnp.asarray(pts) @ t[:3, :3].T + t[:3, 3]
    got = tdepth.sensor_to_world(torch.from_numpy(pts), torch.from_numpy(tf))
    assert_same(got, ref, "world points")
    assert_same(tdepth.transform_cloud(None, torch.from_numpy(pts),
                                       torch.from_numpy(tf)), ref, "cloud")


@pytest.mark.parametrize("method", METHODS)
def test_integrate_scan_matches_jax(method):
    """One scan through ``integrate_scan`` from a mapped state, global and
    windowed: counters and the scan's counts bit-equal."""
    cfg = engine_cfg(True)
    tc = port_cfg(cfg)
    rng = np.random.default_rng(7)
    base = {f: np.asarray(getattr(jgrid.make_state(cfg), f))
            for f in tgrid.FIELDS}
    base["hit_cnt"] = rng.integers(0, 3, cfg.grid_shape).astype(np.uint8)
    base["miss_cnt"] = rng.integers(250, 256, cfg.grid_shape).astype(
        np.uint8)                                   # saturates
    pts, valid, tf = _scan(2)
    for win in (None, ((5, 7, 2), (30, 40, 15))):
        jwin = None if win is None else tuple(jnp.asarray(w, jnp.int32)
                                              for w in win)
        twin = None if win is None else tuple(
            torch.tensor(w, dtype=torch.int32) for w in win)
        with jax.disable_jit():
            jstate = jgrid.MapState(**{f: jnp.asarray(a)
                                       for f, a in base.items()})
            jnew, jres = jpipe.integrate_scan(
                cfg, jstate, jnp.asarray(pts), jnp.asarray(valid),
                jnp.asarray(tf), jwin, method=method)
        tnew, tres = tpipe.integrate_scan(
            tc, ft.state_from_arrays(tc, base, device="cpu"),
            torch.from_numpy(pts), torch.from_numpy(valid),
            torch.from_numpy(tf), twin, method=method)
        for f in ("hit_cnt", "miss_cnt"):
            assert_same(getattr(tnew, f), getattr(jnew, f), f"{win}: {f}")
        assert int(tres.num_rays) == int(jres.num_rays) > 0
        assert int(tres.num_endpoints) == int(jres.num_endpoints) > 0
        assert int((tnew.miss_cnt.numpy() != base["miss_cnt"]).sum()) > 0


def test_single_scan_wrappers_match_jax():
    """The K = 1 splat and carve wrappers (``_scanline_seeds``,
    ``carve_free_mask``) on one world-frame scan."""
    cfg = engine_cfg(False)
    tc = port_cfg(cfg)
    pts, valid, tf = _scan(3)
    origin = tf[:3, 3]
    with jax.disable_jit():
        ref = jrc._scanline_seeds(cfg, *(jnp.asarray(a) for a in
                                         (pts, valid, origin)))
        ref_free = jrc.carve_free_mask(cfg, ref[2], ref[1])
    got = trc._scanline_seeds(tc, *(torch.from_numpy(a) for a in
                                    (pts, valid, origin)))
    for i, (g, r) in enumerate(zip(got, ref)):
        assert_same(g, r, f"seeds output {i}")
    free = trc.carve_free_mask(tc, got[2], got[1])
    assert_same(free, ref_free, "free")
    assert bool(free.any())


def test_sqrt_f32_is_correctly_rounded():
    """``grid.sqrt_f32`` equals the IEEE f32 square root (numpy's, and
    XLA's ``sqrt`` op by op) on random values and on the integer squared
    distances the query path roots; PyTorch's own vectorised f32 ``sqrt``
    may differ from it in the last bit on the CPU (ROADMAP C)."""
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.uniform(0, 75, 200_000),
                        np.arange(1 << 16)]).astype(np.float32)
    got = tgrid.sqrt_f32(torch.from_numpy(x)).numpy()
    assert_same(got, np.sqrt(x), "sqrt_f32 vs numpy")
    with jax.disable_jit():
        assert_same(got, jnp.sqrt(jnp.asarray(x)), "sqrt_f32 vs jax")


def test_intbound_matches_jax():
    rng = np.random.default_rng(4)
    s = rng.uniform(-40, 40, (5000, 3)).astype(np.float32)
    s[:50] = -rng.uniform(0, 1e-6, (50, 3))
    ds = rng.integers(-3, 4, (5000, 3)).astype(np.float32)
    with jax.disable_jit():
        ref = jrc._intbound(jnp.asarray(s), jnp.asarray(ds))
    assert_same(trc._intbound(torch.from_numpy(s), torch.from_numpy(ds)),
                ref, "intbound")


def test_windows_match_jax():
    cfg = engine_cfg(True)
    tc = port_cfg(cfg)
    centers = np.array([[0.1, -0.3, 0.4], [2.3, 2.3, 1.4], [-9.0, 0.0, 0.0],
                        [0.05, 0.15, -0.25]], np.float32)
    for c in centers:
        with jax.disable_jit():
            jmin, jmax = jgrid.local_window(cfg, jnp.asarray(c))
        tmin, tmax = tgrid.local_window(tc, torch.from_numpy(c))
        nmin, nmax = tgrid.local_window_np(tc, c)
        rmin, rmax = jgrid.local_window_np(cfg, c)
        for g, r in ((tmin, jmin), (tmax, jmax), (nmin, rmin), (nmax, rmax),
                     (torch.from_numpy(nmin), jmin)):
            assert_same(g, r, f"window at {c}")
        assert_same(tgrid.window_mask(tc, tmin, tmax),
                    jgrid.window_mask(cfg, jmin, jmax), "window_mask")
    fmin, fmax = tgrid.full_window(tc, device="cpu")
    rmin, rmax = jgrid.full_window(cfg)
    assert_same(fmin, rmin, "full min")
    assert_same(fmax, rmax, "full max")
    vox = torch.tensor([[0, 0, 0], [5, 7, 2], [30, 40, 15], [31, 7, 2]])
    assert tgrid.vox_in_window(vox, torch.tensor([5, 7, 2]),
                               torch.tensor([30, 40, 15])).tolist() == [
        False, True, True, False]


def _fusion_arrays(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = cfg.grid_shape
    lo = rng.uniform(cfg.clamp_min_log, cfg.clamp_max_log,
                     shape).astype(np.float32)
    lo.flat[::7] = np.float32(cfg.min_occupancy_log)
    seen = (rng.random(shape) < 0.5).astype(np.uint8)
    hit = rng.integers(0, 256, shape).astype(np.uint8)
    miss = np.where(rng.random(shape) < 0.3, 0,
                    rng.integers(0, 256, shape)).astype(np.uint8)
    return lo, seen, hit, miss


@pytest.mark.parametrize("wmin,wmax", [((3, 5, 2), (20, 30, 11)),
                                       ((0, 0, 0), (47, 47, 19)),
                                       ((9, 9, 9), (8, 30, 12))],
                         ids=["inner", "whole", "empty"])
def test_windowed_fuse_drain_matches_jax(wmin, wmax):
    """``fuse_drain(window=...)`` against ``fusion.fuse_counts`` with the
    dense window mask (op by op) and ``fuse_counts_pallas(window=...)`` in
    interpret mode: all eight outputs."""
    cfg = engine_cfg(True)
    tc = port_cfg(cfg)
    arrays = _fusion_arrays(cfg, sum(wmin))
    kw = dict(l_hit=cfg.prob_hit_log, l_miss=cfg.prob_miss_log,
              clamp_min=cfg.clamp_min_log, clamp_max=cfg.clamp_max_log,
              occ_thresh=cfg.min_occupancy_log, occ_is_eq=False)
    jwin = (jnp.asarray(wmin, jnp.int32), jnp.asarray(wmax, jnp.int32))
    twin = tuple(torch.tensor(w, dtype=torch.int32) for w in (wmin, wmax))
    got = tfusion.fuse_drain(*(torch.from_numpy(a) for a in arrays),
                             window=twin, **kw)
    with jax.disable_jit():
        chain = jfusion.fuse_counts(
            cfg, *(jnp.asarray(a) for a in arrays),
            window_mask=jgrid.window_mask(cfg, *jwin))
    pallas = jfuse.fuse_counts_pallas(*(jnp.asarray(a) for a in arrays),
                                      window=jwin, interpret=True, **kw)
    for i, (g, r) in enumerate(zip(got, pallas)):
        assert_same(g, r, f"output {i}")
    assert_same(got[0], chain.logodds, "logodds")
    assert_same(got[1], chain.seen, "seen")
    assert_same(got[2], np.asarray(chain.occupied, np.uint8), "occupied")
    assert int(got[5]) == int(chain.num_observed)
    assert int(got[6]) == int(np.asarray(chain.insert_mask).sum())
    assert int(got[7]) == int(np.asarray(chain.delete_mask).sum())
    assert not got[3].any() and not got[4].any()
    mask = tgrid.window_mask(tc, *twin)
    assert int(got[5]) == int(((torch.from_numpy(arrays[3]) > 0)
                               & mask).sum())


def test_lazy_closest_invalidated_by_tick():
    """``tests/test_pipeline.py:349-390`` on the port: query -> tick ->
    query serves a fresh closest grid (cached on the tick's d2), equal to
    the JAX engine's at each step, and a cache hit returns the same
    tensor."""
    cfg = dataclasses.replace(engine_cfg(False), max_points_per_scan=256)
    tc = port_cfg(cfg)
    assert tc.lazy_closest
    jp = jpipe.FiestaPipeline(cfg, method="scanline")
    tp = ft.FiestaPipeline(tc, method="scanline", device="cpu")

    def tick(center):
        pts = np.full((1, 256, 3), np.nan, np.float32)
        pts[0, :8] = center + np.linspace(0, 0.04, 24).reshape(8, 3)
        tfs = np.eye(4, dtype=np.float32)[None]
        args = (pts, np.isfinite(pts).all(-1), tfs,
                np.zeros(3, np.float32))
        with jax.disable_jit():
            jp.state, _ = jpipe.fused_batch_step(
                cfg, jp.state, *(jnp.asarray(a) for a in args),
                method="scanline")
        tp.state, _ = tpipe.fused_batch_step(
            tc, tp.state, *(torch.from_numpy(a) for a in args))

    for _ in range(2):
        tick(np.array([1.0, 1.0, 0.5], np.float32))
    g1 = tp.closest_grid()
    assert tp.closest_grid() is g1                 # cached
    assert_same(g1, jp.closest_grid(), "first closest")
    assert (g1 >= 0).any()
    for _ in range(2):
        tick(np.array([-1.0, -1.2, 0.2], np.float32))   # new cluster
    g2 = tp.closest_grid()
    assert g2 is not g1 and not torch.equal(g1, g2)
    assert_same(g2, jp.closest_grid(), "fresh closest")
    assert not tp.state.closest.ge(0).any()        # lazy: state untouched


def test_engine_defaults_and_device():
    cfg = port_cfg(engine_cfg(False))
    pipe = ft.FiestaPipeline(cfg, device="cpu")
    assert pipe.method == "projective" and pipe.state.d2.device.type == "cpu"
    assert pipe.update() is None                   # nothing observed yet
    with pytest.raises(ValueError, match="method"):
        ft.FiestaPipeline(cfg, method="raymarch", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ft.FiestaPipeline(cfg)
