"""fiesta_tpu_torch's incremental engine against fiesta_tpu (CPU).

``esdf_mode="incremental"``: the tick stream (``fused_stream``, global and
windowed, several ticks) and the app engine (``FiestaPipeline`` with
``update(max_iters=...)``, then its closest grid, queries and signed
field) on both packages from the same replayed scans.  Every state field
and every tick's ``UpdateStats``, the sweep count included, must be
bit-equal.  The JAX package runs jitted, as ``test_torch_pipeline.py``'s
stream does (the scanline integrator's f32 work rounds alike on these
fixtures), and its queries op by op (``jax.disable_jit()``).
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

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import grid as tgrid  # noqa: E402
from fiesta_tpu_torch import pipeline as tpipe  # noqa: E402
from fiesta_tpu_torch.io import replay as treplay  # noqa: E402

H, W = 24, 32


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the plain relaxation is thousands of small
    tensor ops, and the suite's workers share the CPU, where more threads
    only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(window: bool) -> FiestaConfig:
    """A 48x48x32 map at 0.1 m in incremental mode; with ``window`` a
    local update of 1.5 x 1.5 x 0.8 m around the robot."""
    return jreplay.scale_intrinsics(FiestaConfig(
        resolution=0.1, origin=(-2.4, -2.4, -1.0), map_size=(4.8, 4.8, 3.2),
        min_ray_length=0.3, max_ray_length=1.5, max_points_per_scan=H * W,
        esdf_mode="incremental", global_update=not window,
        radius=(1.5, 1.5, 0.8)), H, W)


def _port(cfg):
    return ft.config_from_fields(dataclasses.asdict(cfg))


def _same(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    if got.dtype == np.float32:
        got, ref = got.view(np.int32), ref.view(np.int32)
    np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
def test_fused_stream_incremental_matches_jax(window):
    cfg = _cfg(window)
    tc = _port(cfg)
    _, frames = treplay.make_sequence(tc, n_frames=9, n_boxes=5, seed=1,
                                      height=H, width=W, orbit_radius=0.8)
    batches = treplay.stage_update_batches(tc, frames, device="cpu")
    j_state, j_stats = jpipe.fused_stream(
        cfg, jgrid.make_state(cfg), *(jnp.asarray(b.numpy())
                                      for b in batches), use_window=window)
    t_state, t_stats = tpipe.fused_stream(
        tc, ft.make_state(tc, device="cpu"), *batches, use_window=window)
    for f in tgrid.FIELDS:
        _same(getattr(t_state, f), getattr(j_state, f), f)
    for f in j_stats._fields:
        _same(getattr(t_stats, f), getattr(j_stats, f), f)
    assert t_state.closest.shape == (3,) + tc.grid_shape
    assert int(t_stats.num_inserted.sum()) > 100
    assert int(t_stats.num_sweeps.max()) > 1


def _replay(pipe, frames, caps):
    """Frames with an update every third (``update(max_iters=caps[n])``)
    and one after a final pose releases the last frame; returns every
    update's state arrays and stats."""
    out = []

    def update(cap):
        stats = pipe.update(max_iters=cap)
        out.append(({f: np.array(getattr(pipe.state, f))
                     for f in tgrid.FIELDS},
                    tuple(int(s) for s in stats)))

    for i, (t, (pos, quat), scan) in enumerate(frames):
        pipe.observe_pose(t, pos, quat)
        pipe.observe_cloud(t, scan)
        pipe.process()
        if i % 3 == 2:
            update(caps[len(out)])
    pipe.observe_pose(frames[-1][0] + 1.0, *frames[-1][1])
    pipe.process()
    update(caps[len(out)])
    return out


def test_engine_incremental_matches_jax():
    """``FiestaPipeline`` in incremental mode, one update capped at 2
    sweeps; then ``closest_grid``, the three queries and the signed field
    on its state."""
    cfg = _cfg(False)
    _, frames = jreplay.make_sequence(cfg, n_frames=6, n_boxes=5, seed=3,
                                      height=H, width=W, orbit_radius=0.6)
    caps = (0, 2, 0)
    jp = jpipe.FiestaPipeline(cfg, method="scanline")
    ref = _replay(jp, frames, caps)
    tp = ft.FiestaPipeline(_port(cfg), method="scanline", device="cpu")
    got = _replay(tp, frames, caps)
    assert len(got) == len(ref) == 3
    for n, ((gs, gst), (rs, rst)) in enumerate(zip(got, ref)):
        for f in tgrid.FIELDS:
            _same(gs[f], rs[f], f"update {n}: {f}")
        assert gst == rst, f"update {n}: stats"
    assert got[1][1][3] == 2 and got[2][1][3] > 2
    rng = np.random.default_rng(0)
    pos = (np.asarray(cfg.origin) + rng.random((200, 3))
           * np.asarray(cfg.map_size)).astype(np.float32)
    pos[-2:] = [[99.0, 0.0, 0.0], [np.nan, 0.0, 0.0]]
    with jax.disable_jit():
        r_out = (jp.closest_grid(), jp.query_distance(pos),
                 *jp.query_dist_grad(pos), *jp.query_closest_obstacle(pos),
                 jp.sdf_grid())
    g_out = (tp.closest_grid(), tp.query_distance(pos),
             *tp.query_dist_grad(pos), *tp.query_closest_obstacle(pos),
             tp.sdf_grid())
    for g, r, what in zip(g_out, r_out, ("closest_grid", "distance",
                                         "trilinear", "gradient", "points",
                                         "dist", "sdf")):
        _same(g, r, what)
    assert tp.closest_grid() is tp.state.closest
    assert np.isfinite(g_out[5].numpy()[:-2]).any()
    assert int((tp.closest_grid()[0] >= 0).sum()) > 1000
