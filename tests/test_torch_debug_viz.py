"""fiesta_tpu_torch's debug oracles and visualization against fiesta_tpu's
(CPU).

The same map states (from the port's engine on replayed scans: rebuild
with eager closest, lazy closest with and without the derived grid,
incremental, two-level, and a corrupted d2) go through both packages'
``check_consistency`` (same verdict, same failure text) and
``check_with_ground_truth`` (equal reports); the visualization extractors
give bit-equal arrays.  The checks of ``tests/test_aux.py:55-121, 250-262``
run on the port too.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu import FiestaConfig  # noqa: E402
from fiesta_tpu import debug as jdebug  # noqa: E402
from fiesta_tpu import grid as jgrid  # noqa: E402
from fiesta_tpu import viz as jviz  # noqa: E402
from fiesta_tpu.io import replay as jreplay  # noqa: E402
from fiesta_tpu.timing import Timing as JTiming  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import debug, grid, viz  # noqa: E402
from fiesta_tpu_torch.ops import esdf  # noqa: E402
from fiesta_tpu_torch.ops.query import signed_distance_grid  # noqa: E402
from fiesta_tpu_torch.timing import Timer, Timing  # noqa: E402

H, W = 24, 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: at these shapes it is the fastest, and the
    suite runs several workers side by side (a thread a core each would
    oversubscribe the CPU many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

#: the engine configurations whose states the oracles judge
STATES = {
    "rebuild_eager": dict(closest_mode="eager"),
    "lazy_derived": dict(),
    "lazy_unpassed": dict(),
    "incremental": dict(esdf_mode="incremental"),
    "two_level": dict(edt_fine_dist=0.4),
}


def engine_cfg(**kw) -> FiestaConfig:
    """A 48x48x20 map at 0.1 m, 2 m rays, exact EDT to 1.2 m."""
    fields = dict(
        resolution=0.1, origin=(-2.4, -2.4, -0.5), map_size=(4.8, 4.8, 2.0),
        min_ray_length=0.3, max_ray_length=2.0, trunc_dist=1.2,
        edt_fine_dist=1.2, max_points_per_scan=H * W)
    return jreplay.scale_intrinsics(FiestaConfig(**{**fields, **kw}), H, W)


def port_cfg(cfg):
    return ft.config_from_fields(dataclasses.asdict(cfg))


def _run_engine(cfg, n_frames=6):
    """The port's engine on ``n_frames`` replayed scans, ``update()``
    every third frame and once at the end."""
    _, frames = jreplay.make_sequence(cfg, n_frames=n_frames, n_boxes=6,
                                      seed=3, height=H, width=W)
    pipe = ft.FiestaPipeline(port_cfg(cfg), method="scanline", device="cpu")
    for i, (t, (pos, quat), scan) in enumerate(frames):
        pipe.observe_pose(t, pos, quat)
        pipe.observe_cloud(t, scan)
        pipe.process()
        if i % 3 == 2:
            pipe.update()
    pipe.observe_pose(frames[-1][0] + 1.0, *frames[-1][1])
    pipe.process()
    pipe.update()
    return pipe


@pytest.fixture(scope="module")
def states():
    """name -> (jax config, port state, closest grid to pass or None)."""
    out = {}
    for name, kw in STATES.items():
        cfg = engine_cfg(**kw)
        pipe = _run_engine(cfg)
        closest = pipe.closest_grid() if name != "lazy_unpassed" else None
        out[name] = (cfg, pipe.state, closest)
    cfg, state, closest = out["rebuild_eager"]
    d2 = state.d2.clone()
    v = tuple(int(i) for i in (d2 > 0).nonzero()[0])
    d2[v] = 17 if int(d2[v]) != 17 else 18
    out["corrupt_d2"] = (cfg, dataclasses.replace(state, d2=d2), closest)
    return out


def jax_state(state):
    return jgrid.MapState(**{f: jnp.asarray(getattr(state, f).numpy())
                             for f in grid.FIELDS})


def verdict(check, *args, **kw):
    try:
        return check(*args, **kw)
    except AssertionError as e:
        return f"AssertionError: {e}"


@pytest.mark.parametrize("name", list(STATES) + ["corrupt_d2"])
def test_check_consistency_same_verdict(states, name):
    cfg, state, closest = states[name]
    got = verdict(debug.check_consistency, port_cfg(cfg), state,
                  closest=closest)
    ref = verdict(jdebug.check_consistency, cfg, jax_state(state),
                  closest=None if closest is None
                  else jnp.asarray(closest.numpy()))
    assert got == ref
    assert (got is True) == (name != "corrupt_d2"), got


@pytest.mark.parametrize("name", list(STATES))
def test_ground_truth_report_equal(states, name):
    cfg, state, _ = states[name]
    got = debug.check_with_ground_truth(port_cfg(cfg), state)
    assert got == jdebug.check_with_ground_truth(cfg, jax_state(state))
    assert got["num_known"] > 0


def assert_same(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    assert got.tobytes() == ref.tobytes(), what


def test_rainbow_color_map_equal():
    h = np.concatenate([np.linspace(-0.5, 1.5, 4001), [0.0, 1.0, 1 / 6]])
    assert_same(viz.rainbow_color_map(h), jviz.rainbow_color_map(h))


@pytest.mark.parametrize("slice_z", [None, 0.05, 0.35, 0.95])
def test_slices_equal(states, slice_z):
    cfg, state, _ = states["lazy_derived"]
    tcfg, js = port_cfg(cfg), jax_state(state)
    assert viz.slice_index(tcfg, slice_z) == jviz.slice_index(cfg, slice_z)
    assert_same(viz.slice_image(tcfg, state, slice_z),
                jviz.slice_image(cfg, js, slice_z), "slice_image")
    for g, r in zip(viz.slice_marker(tcfg, state, slice_z, max_dist=0.7),
                    jviz.slice_marker(cfg, js, slice_z, max_dist=0.7)):
        assert_same(g, r, "slice_marker")


@pytest.mark.parametrize("window", [None, "inner"])
@pytest.mark.parametrize("bounds", [(None, None), (0.95, 1.45)])
def test_occupied_pointcloud_equal(states, window, bounds):
    cfg, state, _ = states["lazy_derived"]
    if window == "inner":
        window = (np.array([40, 20, 10]), np.array([47, 30, 14]))
    got = viz.occupied_pointcloud(port_cfg(cfg), state, *bounds,
                                  window=window)
    ref = jviz.occupied_pointcloud(cfg, jax_state(state), *bounds,
                                   window=window)
    assert_same(got, ref)
    assert len(got) > 0


@pytest.mark.parametrize("last_ms", [None, 12.5])
def test_performance_text_equal(last_ms):
    for reg in (Timing, JTiming):
        reg.reset()
        for s in (0.0125, 0.0031, 0.0207):
            reg.add_sample("UpdateESDF", s)
    assert viz.performance_text(last_ms) == jviz.performance_text(last_ms)
    Timing.reset()
    JTiming.reset()


# ---------------------------------------------------------------------------
# tests/test_aux.py on the port
# ---------------------------------------------------------------------------

CFG = ft.FiestaConfig(resolution=0.1, origin=(-1.0, -1.0, -0.5),
                      map_size=(2.0, 2.0, 1.0))


def _built_state():
    """A 4x4x2 box relaxed by the incremental engine into an empty map
    (``tests/test_aux.py:25-39``)."""
    state = ft.make_state(CFG, device="cpu")
    occ = torch.zeros(CFG.grid_shape, dtype=torch.bool)
    occ[8:12, 8:12, 4:6] = True
    d2, closest, _ = esdf.update_esdf(
        state.d2, state.closest, occ, occ, torch.zeros_like(occ), None,
        CFG.stencil)
    return dataclasses.replace(
        state, d2=d2, closest=closest,
        logodds=torch.where(occ, 5.0, -5.0),
        seen=torch.ones(CFG.grid_shape, dtype=torch.uint8))


def test_check_consistency_passes_and_detects():
    state = _built_state()
    assert debug.check_consistency(CFG, state, closest=state.closest)
    d2 = state.d2.clone()
    d2[0, 0, 0] = 17
    bad = dataclasses.replace(state, d2=d2)
    with pytest.raises(AssertionError):
        debug.check_consistency(CFG, bad, closest=bad.closest)


def test_ground_truth_report():
    rep = debug.check_with_ground_truth(CFG, _built_state())
    assert rep["num_known"] > 0
    assert rep["count_under"] == 0 and rep["max_under"] == 0.0
    assert rep["max_abs_error"] < 0.2
    assert rep["max_over"] <= rep["max_abs_error"]
    assert sum(rep["histogram"]) == rep["count_over"]


def test_signed_distance():
    state = _built_state()
    sd = signed_distance_grid(CFG, state.d2, state.seen,
                              grid.occupied_grid(CFG, state.logodds)).numpy()
    assert sd[9, 9, 4] < 0 and sd[0, 0, 0] > 0
    assert sd[7, 9, 4] > 0 and sd[8, 9, 4] <= 0


def test_viz_outputs():
    state = _built_state()
    pc = viz.occupied_pointcloud(CFG, state)
    assert pc.shape == (4 * 4 * 2, 3)
    pos, colors = viz.slice_marker(CFG, state, slice_z=0.95)
    assert len(pos) == len(colors) > 0
    assert colors.min() >= 0 and colors.max() <= 1
    assert viz.slice_image(CFG, state, slice_z=0.95).shape == (20, 20, 3)


def test_rainbow_matches_reference_formula():
    np.testing.assert_allclose(viz.rainbow_color_map(np.array([0.0]))[0],
                               [1, 0, 0], atol=1e-9)
    assert viz.rainbow_color_map(np.array([0.5]))[0][2] == 1.0
    assert viz.rainbow_color_map(np.array([1.0 / 6.0]))[0][1] == 1.0


def test_performance_text_marker():
    Timing.reset()
    with Timer("UpdateESDF"):
        pass
    txt = viz.performance_text(last_update_ms=12.5)
    assert txt.startswith("Fiesta\nCurrent update Time\n12.500 ms")
    assert "Average update Time" in txt
    Timing.reset()
