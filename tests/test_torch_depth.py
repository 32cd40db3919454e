"""fiesta_tpu_torch depth-image path against fiesta_tpu (CPU).

Back-projection and the consistency filter (``ops.depth``), the batched
depth tick and stream with and without the local window, and the
``FiestaPipeline`` depth-image replay for each integrator: bit-equal to
the JAX package run op by op.  Two f32 functions cannot be matched bit for
bit (the JAX package's transcendentals and LAPACK solve are not the
port's); their tests show that every difference is a rounding-level one,
and the boundary flips they could cause are counted in ROADMAP C.
"""

import dataclasses
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu import grid as jgrid  # noqa: E402
from fiesta_tpu import pipeline as jpipe  # noqa: E402
from fiesta_tpu.io import replay as jreplay  # noqa: E402
from fiesta_tpu.ops import depth as jdepth  # noqa: E402
from fiesta_tpu.ops import raycast as jrc  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import kernels  # noqa: E402
from fiesta_tpu_torch import pipeline as tpipe  # noqa: E402
from fiesta_tpu_torch.io import replay as treplay  # noqa: E402
from fiesta_tpu_torch.ops import depth as tdepth  # noqa: E402
from fiesta_tpu_torch.ops import raycast as trc  # noqa: E402

from test_torch_engine import (H, METHODS, W, assert_same,  # noqa: E402
                               compare_replays, engine_cfg, port_cfg)


def _depth_frames(cfg, n=6, seed=3):
    _, frames = jreplay.make_sequence(cfg, n_frames=n, n_boxes=5, seed=seed,
                                      kind="depth", height=H, width=W,
                                      orbit_radius=0.6)
    depths = np.stack([f[2] for f in frames]).astype(np.float32)
    tfs = np.stack([jdepth.pose_to_matrix(*f[1]) for f in frames]
                   ).astype(np.float32)
    return frames, depths, tfs


@pytest.mark.parametrize("margin", [0, 3])
def test_depth_to_cloud_matches_jax(margin):
    """Components, the stacked cloud and the filter's valid mask over a
    chain of frames, with and without the margin crop."""
    cfg = dataclasses.replace(engine_cfg(False), depth_filter_margin=margin)
    tc = port_cfg(cfg)
    _, depths, tfs = _depth_frames(cfg)
    n_valid = 0
    for i in range(1, len(depths)):
        args = (depths[i], tfs[i], tfs[i - 1], depths[i - 1])
        for use_filter in (False, True):
            with jax.disable_jit():
                ref = jdepth.depth_to_cloud_components(
                    cfg, *(jnp.asarray(a) for a in args),
                    use_filter=use_filter)
                ref_pts, ref_val = jdepth.depth_to_cloud(
                    cfg, *(jnp.asarray(a) for a in args),
                    use_filter=use_filter)
            targs = [torch.from_numpy(a) for a in args]
            got = tdepth.depth_to_cloud_components(tc, *targs,
                                                   use_filter=use_filter)
            for g, r, what in zip(got, ref, "xyzv"):
                assert_same(g, r, f"frame {i} filter {use_filter}: {what}")
            pts, val = tdepth.depth_to_cloud(tc, *targs,
                                             use_filter=use_filter)
            assert_same(pts, ref_pts, "cloud")
            assert_same(val, ref_val, "cloud valid")
            n_valid += int(val.sum()) if use_filter else 0
    assert n_valid > 100


def _with_edge_depths(cfg, depths):
    """``depths`` with NaN, infinities, zero, depths either side of the
    gates and one on the lower gate written into each frame's first rows
    (the last row of a frame where the margin crop keeps nothing)."""
    depths = depths.copy()
    lo = np.float32(cfg.depth_filter_min_dist)
    edge = np.array([np.nan, np.inf, -np.inf, 0.0, lo, lo * 0.5,
                     np.nextafter(lo, np.float32(0)),
                     np.float32(cfg.depth_filter_max_dist) * 2], np.float32)
    for i, d in enumerate(depths):
        d[i % 2, :len(edge)] = edge
        d[-1, -len(edge):] = edge[::-1]
    return depths


@pytest.mark.parametrize("margin", [0, 3])
@pytest.mark.parametrize("use_filter", [False, True], ids=["raw", "filter"])
@pytest.mark.parametrize("k", [1, 3])
def test_depth_tick_components_matches_chain_and_jax(k, use_filter, margin):
    """``depth_tick_components`` on CPU: K frames, frame 0 held against
    the given predecessor and frame i against frame i - 1, equal to the
    chained per-frame ``depth_to_cloud_components`` stacked, and to the
    JAX package's ``depth_to_cloud_components`` run op by op."""
    cfg = dataclasses.replace(engine_cfg(False), depth_filter_margin=margin)
    tc = port_cfg(cfg)
    _, depths, tfs = _depth_frames(cfg)
    depths = _with_edge_depths(cfg, depths)
    frames = range(1, 1 + k)
    got = tdepth.depth_tick_components(
        tc, torch.from_numpy(depths[1:1 + k]), torch.from_numpy(tfs[1:1 + k]),
        torch.from_numpy(depths[0]), torch.from_numpy(tfs[0]), use_filter)
    chain = [tdepth.depth_to_cloud_components(
        tc, *(torch.from_numpy(a) for a in (depths[i], tfs[i], tfs[i - 1],
                                            depths[i - 1])),
        use_filter=use_filter) for i in frames]
    with jax.disable_jit():
        ref = [jdepth.depth_to_cloud_components(
            cfg, *(jnp.asarray(a) for a in (depths[i], tfs[i], tfs[i - 1],
                                            depths[i - 1])),
            use_filter=use_filter) for i in frames]
    for c, what in enumerate("xyzv"):
        assert tuple(got[c].shape) == (k, H * W), what
        assert_same(got[c], torch.stack([f[c].reshape(-1) for f in chain]),
                    f"chain {what}")
        assert_same(got[c], np.stack([np.asarray(f[c]).reshape(-1)
                                      for f in ref]), f"jax {what}")
    if use_filter:
        n = int(got[3].sum())
        assert 0 < n < k * H * W - 8 * k


def test_depth_kernel_registered():
    """The ``depth`` kernel's entry: its source, C symbol and launch
    counter, and an argument list as long as the C entry's (plus the
    stream)."""
    src, sym, argtypes = kernels._SIGNATURES["depth"]
    assert (src, sym) == ("depth.cu", "fiesta_depth")
    assert src in kernels.SOURCES and kernels.LAUNCHES["depth"] == 0
    text = (kernels._HERE / src).read_text()
    params = re.search(rf"int {sym}\(([^)]*)\)", text).group(1)
    assert len(params.split(",")) == len(argtypes)
    assert re.search(r"__global__\s+void\s+__launch_bounds__\([^)]*\)\s+"
                     r"depth_kernel\(", text)


def test_depth_kernel_wants_cuda_tensors():
    """A CPU tensor never reaches the kernel: the wrapper refuses it (the
    ops module routes CPU tensors to the plain version)."""
    d = torch.ones((1, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.depth(d, None, None, None, cx=2.0, cy=2.0, fx=1.0, fy=1.0,
                      min_dist=0.1, max_dist=10.0, tol=0.1,
                      use_filter=False, margin=0)
    assert kernels.LAUNCHES["depth"] == 0


def test_relative_transform_agrees_to_rounding():
    """The filter's last_T^-1 @ T: the port's elimination against the JAX
    package's LAPACK solve and the f64 solution.  Entries may differ in
    the last bits (ROADMAP C), never by more than rounding."""
    _, _, tfs = _depth_frames(engine_cfg(False), n=8)
    n_diff = 0
    for i in range(1, len(tfs)):
        with jax.disable_jit():
            ref = np.asarray(jnp.linalg.solve(jnp.asarray(tfs[i - 1]),
                                              jnp.asarray(tfs[i])))
        got = tdepth._solve(torch.from_numpy(tfs[i - 1]),
                            torch.from_numpy(tfs[i])).numpy()
        exact = np.linalg.solve(tfs[i - 1].astype(np.float64),
                                tfs[i].astype(np.float64))
        np.testing.assert_allclose(got, exact, rtol=0, atol=4e-6)
        np.testing.assert_allclose(ref, exact, rtol=0, atol=4e-6)
        n_diff += int((got != ref).sum())
    assert n_diff < 16 * (len(tfs) - 1)
    assert np.array_equal(treplay.pose_to_matrix([1.0, 2.0, 3.0],
                                                 [0.9, 0.1, -0.3, 0.2]),
                          jdepth.pose_to_matrix([1.0, 2.0, 3.0],
                                                [0.9, 0.1, -0.3, 0.2]))


def test_spherical_bins_differ_only_at_edges():
    """The projective integrator's panorama bins: ranges bit-equal, and a
    bin differs from the JAX package's only where the f64 bin coordinate
    lies within a few f32 ulps of a bin edge (the two packages' atan2 and
    asin differ by 1-2 ulps)."""
    rng = np.random.default_rng(1)
    d = rng.uniform(-5, 5, (100_000, 3)).astype(np.float32)
    with jax.disable_jit():
        jr, ja, je = (np.asarray(a) for a in
                      jrc._spherical_coords(jnp.asarray(d), 1024, 512))
    tr, ta, te = (a.numpy() for a in
                  trc._spherical_coords(torch.from_numpy(d), 1024, 512))
    assert_same(tr, jr, "range")
    d64 = d.astype(np.float64)
    r64 = np.linalg.norm(d64, axis=-1)
    coord = {"az": (np.arctan2(d64[:, 1], d64[:, 0]) / (2 * np.pi) + 0.5)
             * 1024,
             "el": (np.arcsin(d64[:, 2] / r64) / np.pi + 0.5) * 512}
    for name, got, ref in (("az", ta, ja), ("el", te, je)):
        bad = np.nonzero(got != ref)[0]
        edge = np.abs(coord[name][bad] - np.round(coord[name][bad]))
        assert (edge < 1e-3).all(), (name, edge.max())
        assert len(bad) <= 10, name


@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
def test_fused_depth_stream_matches_jax(window):
    """Two depth ticks of three frames: ``fused_depth_batch_step`` (filter
    chain seeded with the first frame) and ``fused_depth_stream``, states
    and stats bit-equal to JAX."""
    cfg = engine_cfg(window)
    tc = port_cfg(cfg)
    frames, depths, tfs = _depth_frames(cfg)
    depths = depths.reshape(2, 3, H, W)
    tfs = tfs.reshape(2, 3, 4, 4)
    poss = np.stack([frames[2][1][0], frames[5][1][0]]).astype(np.float32)
    with jax.disable_jit():
        j_state, j_stats = jpipe.fused_depth_stream(
            cfg, jgrid.make_state(cfg), jnp.asarray(depths),
            jnp.asarray(tfs), jnp.asarray(poss), use_window=window)
        j_one, j_one_stats = jpipe.fused_depth_batch_step(
            cfg, jgrid.make_state(cfg), jnp.asarray(depths[0]),
            jnp.asarray(tfs[0]), jnp.asarray(depths[0, 0]),
            jnp.asarray(tfs[0, 0]), jnp.asarray(poss[0]), use_window=window)
    t = [torch.from_numpy(a) for a in (depths, tfs, poss)]
    t_state, t_stats = tpipe.fused_depth_stream(
        tc, ft.make_state(tc, device="cpu"), *t, use_window=window)
    t_one, t_one_stats = tpipe.fused_depth_batch_step(
        tc, ft.make_state(tc, device="cpu"), t[0][0], t[1][0], t[0][0, 0],
        t[1][0, 0], t[2][0], use_window=window)
    for f in ft.grid.FIELDS:
        assert_same(getattr(t_state, f), getattr(j_state, f), f)
        assert_same(getattr(t_one, f), getattr(j_one, f), f"one tick {f}")
    for f in j_stats._fields:
        assert_same(getattr(t_stats, f), getattr(j_stats, f), f)
        assert_same(getattr(t_one_stats, f), getattr(j_one_stats, f), f)
    assert int(ft.occupied_grid(tc, t_state.logodds).sum()) > 50
    assert int(t_stats.num_observed[1]) > 0


@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
@pytest.mark.parametrize("method", METHODS)
def test_depth_replay_matches_jax(method, window):
    """``FiestaPipeline`` in depth-image mode (the filter chain threads the
    engine's frames; the first frame yields nothing)."""
    cfg = engine_cfg(window)
    frames, _, _ = _depth_frames(cfg)
    tp, got = compare_replays(cfg, method, "depth", frames)
    assert tp.image_cnt == len(frames)
    assert int(tp.occupied().sum()) > 50
