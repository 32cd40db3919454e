"""fiesta_tpu_torch two-level (hierarchical) EDT against fiesta_tpu (CPU).

``hierarchical_edt_d2`` and ``hierarchical_edt_d2_closest`` (both closest
formats, with each level on the packed passes and on the wide fallback)
must equal the JAX package's bit for bit, and so must every path that
rebuilds with them when ``edt_fine_dist < trunc_dist``: ``rebuild_d2``,
``rebuild_esdf``, the tick stream in lazy and eager closest mode (whose
eager closest equals ``derive_closest``) and ``FiestaPipeline``.  The JAX
wide fallback runs op by op: jitted, it cannot branch on ``packed_out``
(ROADMAP C).
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
from fiesta_tpu.ops.pallas import edt as jedt  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import pipeline as tpipe  # noqa: E402
from fiesta_tpu_torch.io import replay as treplay  # noqa: E402
from fiesta_tpu_torch.ops import edt as tedt  # noqa: E402

# (shape, p, t_fine, t_total): random scenes; one whose coarse t (15) is
# past every coarse axis (12 x 10 x 6); an empty and a full grid
D2_CASES = {
    "random": ((32, 28, 20), 0.01, 4, 9),
    "coarse_t_past_axes": ((24, 20, 12), 0.01, 3, 30),
    "sparse_deep": ((40, 36, 16), 0.003, 5, 12),
    "empty": ((24, 20, 12), 0.0, 3, 8),
    "full": ((24, 20, 12), 1.0, 3, 8),
}
# both levels packed; both levels on the wide fallback (no packed plan
# fits t = 20000 on 16 x 16 x 8 or t = 20000 on 8 x 8 x 4)
CLOSEST_CASES = {"packed": ((32, 28, 20), 0.01, 4, 9),
                 "wide": ((16, 16, 8), 0.02, 20000, 40000)}


def _occ(shape, p, seed):
    return np.random.default_rng(seed).random(shape) < p


def _same(got, ref, what):
    ref = np.asarray(ref)
    assert got.numpy().dtype == ref.dtype and got.shape == ref.shape, what
    np.testing.assert_array_equal(got.numpy(), ref, err_msg=what)


@pytest.mark.parametrize("case", sorted(D2_CASES))
def test_hierarchical_edt_d2_matches_jax(case):
    shape, p, t_fine, t_total = D2_CASES[case]
    occ = _occ(shape, p, len(case))
    ref = jedt.hierarchical_edt_d2(jnp.asarray(occ), t_fine, t_total)
    got = tedt.hierarchical_edt_d2(torch.from_numpy(occ), t_fine, t_total)
    _same(got, ref, "d2")
    # the u8 occupancy of the drain gives the same field
    _same(tedt.hierarchical_edt_d2(torch.from_numpy(occ.astype(np.uint8)),
                                   t_fine, t_total), ref, "d2 from u8")
    coarse = occ.reshape(shape[0] // 2, 2, shape[1] // 2, 2, shape[2] // 2,
                         2).any(axis=(1, 3, 5))
    np.testing.assert_array_equal(
        tedt.downsample2_any(torch.from_numpy(occ)).numpy(), coarse)


@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize("case", sorted(CLOSEST_CASES))
def test_hierarchical_closest_matches_jax(case, packed_out):
    shape, p, t_fine, t_total = CLOSEST_CASES[case]
    coarse = tuple(g // 2 for g in shape)
    t_coarse = -(-t_total // 2)
    fits = (tedt.closest_plan(shape, t_fine) is not None,
            tedt.closest_plan(coarse, t_coarse) is not None)
    assert fits == ((True, True) if case == "packed" else (False, False))
    occ = _occ(shape, p, 3)
    with jax.disable_jit():
        ref = jedt.hierarchical_edt_d2_closest(
            jnp.asarray(occ), t_fine, t_total, packed_out=packed_out)
    got = tedt.hierarchical_edt_d2_closest(torch.from_numpy(occ), t_fine,
                                           t_total, packed_out=packed_out)
    _same(got[0], ref[0], "d2")
    _same(got[1], ref[1], "closest")
    _same(got[0], tedt.hierarchical_edt_d2(torch.from_numpy(occ), t_fine,
                                           t_total).numpy(), "d2 of d2-only")
    assert int((got[0] < jgrid.INF_D2).sum()) > 0


def test_hierarchical_preconditions_raise():
    with pytest.raises(ValueError, match="even"):
        tedt.hierarchical_edt_d2(torch.zeros((6, 5, 4), dtype=torch.bool),
                                 1, 3)
    with pytest.raises(ValueError, match="1024"):
        tedt.hierarchical_edt_d2_closest(
            torch.zeros((1026, 2, 2), dtype=torch.bool), 1, 3,
            packed_out=True)


H, W = 24, 32


def _hier_cfg(**kw):
    """A 48x48x32 grid at 0.1 m: exact EDT to 0.5 m (t_fine 5), the far
    field to 1.2 m (t_total 12, coarse 24x24x16 at t 6)."""
    return jreplay.scale_intrinsics(FiestaConfig(
        resolution=0.1, origin=(-2.4, -2.4, -1.0), map_size=(4.8, 4.8, 3.2),
        min_ray_length=0.3, max_ray_length=1.5, trunc_dist=1.2,
        edt_fine_dist=0.5, max_points_per_scan=H * W, **kw), H, W)


@pytest.mark.parametrize("mode", ["lazy", "eager"])
def test_fused_stream_hierarchical_matches_jax(mode):
    cfg = _hier_cfg(closest_mode=mode)
    tc = ft.config_from_fields(dataclasses.asdict(cfg))
    assert tpipe._hierarchical(tc) and tpipe.rebuild_tracks_closest(tc)
    _, frames = treplay.make_sequence(tc, n_frames=12, n_boxes=5, seed=2,
                                      height=H, width=W, orbit_radius=0.8)
    batches = treplay.stage_update_batches(tc, frames, device="cpu")
    j_state, j_stats = jpipe.fused_stream(
        cfg, jgrid.make_state(cfg), *(jnp.asarray(b.numpy())
                                      for b in batches))
    t_state, t_stats = tpipe.fused_stream(
        tc, ft.make_state(tc, device="cpu"), *batches)
    got = ft.state_to_arrays(t_state)
    for field in got:
        np.testing.assert_array_equal(got[field],
                                      np.asarray(getattr(j_state, field)),
                                      err_msg=field)
    for field in j_stats._fields:
        np.testing.assert_array_equal(getattr(t_stats, field).numpy(),
                                      np.asarray(getattr(j_stats, field)),
                                      err_msg=field)
    d2 = got["d2"]
    fine = tedt.truncated_edt_d2(ft.occupied_grid(tc, t_state.logodds), 5)
    # the far field is present, and the fine field is exact
    assert ((d2 > 25) & (d2 < jgrid.INF_D2)).sum() > 100
    np.testing.assert_array_equal(d2[fine.numpy() < jgrid.INF_D2],
                                  fine.numpy()[fine.numpy() < jgrid.INF_D2])
    lazy = tpipe.derive_closest(tc, t_state.logodds)
    np.testing.assert_array_equal(
        lazy.numpy(), np.asarray(jpipe.derive_closest(cfg,
                                                      j_state.logodds)))
    if mode == "eager":
        assert torch.equal(lazy, t_state.closest)
        assert (got["closest"] >= 0).sum() > 100
    else:
        assert not (got["closest"] >= 0).any()


def test_pipeline_hierarchical_matches_jax():
    """``FiestaPipeline`` on the two-level config, 9 frames with an update
    every third and one after the last: the final state, the closest grid and the distance and
    closest queries equal the JAX engine's (run op by op, as
    ``tests/test_torch_engine.py`` runs it)."""
    cfg = _hier_cfg()
    tc = ft.config_from_fields(dataclasses.asdict(cfg))
    _, frames = jreplay.make_sequence(cfg, n_frames=9, n_boxes=5, seed=6,
                                      height=H, width=W, orbit_radius=0.8)
    with jax.disable_jit():
        jp = jpipe.FiestaPipeline(cfg, method="scanline")
    tp = ft.FiestaPipeline(tc, method="scanline", device="cpu")
    for pipe in (jp, tp):
        ctx = jax.disable_jit() if pipe is jp else torch.no_grad()
        with ctx:
            for i, (t, (pos, quat), scan) in enumerate(frames):
                pipe.observe_pose(t, pos, quat)
                pipe.observe_cloud(t, scan)
                pipe.process()
                if i % 3 == 2:
                    pipe.update()
            pipe.observe_pose(frames[-1][0] + 1.0, *frames[-1][1])
            pipe.process()
            pipe.update()
    assert tp.esdf_cnt == jp.esdf_cnt == 4
    for field in ft.grid.FIELDS:
        _same(getattr(tp.state, field), getattr(jp.state, field), field)
    with jax.disable_jit():
        _same(tp.closest_grid(), jp.closest_grid(), "closest_grid")
        pos = np.random.default_rng(0).uniform(-2.4, 2.4, (300, 3)).astype(
            np.float32)
        _same(tp.query_distance(pos), jp.query_distance(pos), "distance")
        for g, r, what in zip(tp.query_closest_obstacle(pos),
                              jp.query_closest_obstacle(pos),
                              ("points", "dist")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=what)
    assert int(tp.occupied().sum()) > 100
