"""fiesta_tpu_torch tick stream against fiesta_tpu (CPU).

A multi-tick ``fused_stream`` on replayed scans, once on an 8-aligned
grid and once on an unaligned one: the port's final ``MapState`` and
every tick's ``UpdateStats`` must equal ``fiesta_tpu.pipeline.fused_stream``
bit for bit.  Off a TPU the JAX tick runs its XLA fusion and ``rmw``
counter apply, which its own tests pin to the Pallas drain and box add;
the port's one-pass drain and box add are held against those Pallas
kernels in interpret mode here as well.
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
from fiesta_tpu.ops import fusion as jfusion  # noqa: E402
from fiesta_tpu.ops import raycast as jrc  # noqa: E402
from fiesta_tpu.ops.pallas import boxadd as jboxadd  # noqa: E402
from fiesta_tpu.ops.pallas import fuse as jfuse  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import pipeline as tpipe  # noqa: E402
from fiesta_tpu_torch.io import replay as treplay  # noqa: E402
from fiesta_tpu_torch.ops import fusion as tfusion  # noqa: E402
from fiesta_tpu_torch.ops import raycast as trc  # noqa: E402

H, W = 24, 32


def _cfg(map_size, origin):
    return jreplay.scale_intrinsics(FiestaConfig(
        resolution=0.1, origin=origin, map_size=map_size,
        min_ray_length=0.3, max_ray_length=1.5, trunc_dist=1.2,
        edt_fine_dist=1.2, max_points_per_scan=H * W), H, W)


GRIDS = {
    "aligned": _cfg((4.8, 4.8, 3.2), (-2.4, -2.4, -1.0)),      # 48x48x32
    "unaligned": _cfg((4.5, 4.3, 2.5), (-2.2, -2.1, -0.9)),    # 45x43x25
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_fused_stream_matches_jax(name):
    cfg = GRIDS[name]
    tc = ft.config_from_fields(dataclasses.asdict(cfg))
    _, frames = treplay.make_sequence(tc, n_frames=12, n_boxes=5, seed=1,
                                      height=H, width=W, orbit_radius=0.8)
    pts, vals, tfs, pos = treplay.stage_update_batches(tc, frames,
                                                       device="cpu")
    j_state, j_stats = jpipe.fused_stream(
        cfg, jgrid.make_state(cfg), *(jnp.asarray(a.numpy())
                                      for a in (pts, vals, tfs, pos)))
    t_state, t_stats = tpipe.fused_stream(
        tc, ft.make_state(tc, device="cpu"), pts, vals, tfs, pos)
    got = ft.state_to_arrays(t_state)
    for field in got:
        ref = np.asarray(getattr(j_state, field))
        assert got[field].dtype == ref.dtype, field
        np.testing.assert_array_equal(got[field], ref, err_msg=field)
    for field in j_stats._fields:
        ref = np.asarray(getattr(j_stats, field))
        out = getattr(t_stats, field)
        assert out.shape == (4,) and out.dtype == torch.int32, field
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=field)
    occupied = ft.occupied_grid(tc, t_state.logodds)
    assert int(occupied.sum()) > 100
    assert int(t_stats.num_inserted.sum()) > 0
    assert (got["d2"] < jgrid.INF_D2).sum() > (got["d2"] == 0).sum()


def test_fuse_counts_matches_jax():
    """The port's drain against the JAX package's plain fusion
    (``fusion.fuse_counts``, op by op): log-odds, seen, occupancy, and the
    three counts equal to the sums of its observed, insert and delete
    masks."""
    cfg = GRIDS["aligned"]
    rng = np.random.default_rng(3)
    shape = (16, 16, 8)
    lo = rng.uniform(cfg.clamp_min_log, cfg.clamp_max_log,
                     shape).astype(np.float32)
    lo.flat[::7] = np.float32(cfg.min_occupancy_log)
    seen = (rng.random(shape) < 0.5).astype(np.uint8)
    hit = rng.integers(0, 256, shape).astype(np.uint8)
    miss = np.where(rng.random(shape) < 0.3, 0,
                    rng.integers(0, 256, shape)).astype(np.uint8)
    with jax.disable_jit():
        ref = jfusion.fuse_counts(cfg, *(jnp.asarray(a)
                                         for a in (lo, seen, hit, miss)))
    new_lo, new_seen, occ, hit0, miss0, n_obs, n_ins, n_del = \
        tfusion.fuse_drain(*(torch.from_numpy(a)
                             for a in (lo, seen, hit, miss)),
                           l_hit=cfg.prob_hit_log, l_miss=cfg.prob_miss_log,
                           clamp_min=cfg.clamp_min_log,
                           clamp_max=cfg.clamp_max_log,
                           occ_thresh=cfg.min_occupancy_log, occ_is_eq=False)
    for name, g, r in (("logodds", new_lo, ref.logodds),
                       ("seen", new_seen, ref.seen),
                       ("occupied", occ, np.asarray(ref.occupied, np.uint8))):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    assert int(n_obs) == int(ref.num_observed) > 0
    assert int(n_ins) == int(np.asarray(ref.insert_mask).sum()) > 0
    assert int(n_del) == int(np.asarray(ref.delete_mask).sum()) > 0
    assert not hit0.any() and not miss0.any()


def _fusion_inputs(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(cfg.clamp_min_log, cfg.clamp_max_log,
                     shape).astype(np.float32)
    lo.flat[::7] = np.float32(cfg.min_occupancy_log)
    lo.flat[::11] = np.float32(1.0)
    seen = (rng.random(shape) < 0.5).astype(np.uint8)
    hit = rng.integers(0, 256, shape).astype(np.uint8)
    miss = np.where(rng.random(shape) < 0.3, 0,
                    rng.integers(0, 256, shape)).astype(np.uint8)
    return lo, seen, hit, miss


@pytest.mark.parametrize("probabilistic", [True, False])
def test_fuse_drain_matches_pallas_interpret(probabilistic):
    """The one-pass drain: all eight outputs of ``fuse_counts_pallas``."""
    cfg = dataclasses.replace(GRIDS["aligned"], probabilistic=probabilistic)
    arrays = _fusion_inputs(cfg, (16, 12, 24), 5)
    on, eq = ((cfg.min_occupancy_log, False) if probabilistic
              else (1.0, True))
    kw = dict(l_hit=cfg.prob_hit_log, l_miss=cfg.prob_miss_log,
              clamp_min=cfg.clamp_min_log, clamp_max=cfg.clamp_max_log,
              occ_thresh=on, occ_is_eq=eq)
    ref = jfuse.fuse_counts_pallas(*(jnp.asarray(a) for a in arrays),
                                   interpret=True, **kw)
    got = tfusion.fuse_drain(*(torch.from_numpy(a) for a in arrays), **kw)
    assert len(got) == 8
    for i, (r, g) in enumerate(zip(ref, got)):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype, i
        np.testing.assert_array_equal(g.numpy(), r, err_msg=str(i))
    assert int(got[5]) > 0 and int(got[6]) + int(got[7]) > 0


def test_box_add_matches_pallas_interpret():
    """An 8-aligned fixture ``box_add_inplace`` accepts: overlapping boxes,
    saturation, in scan order."""
    rng = np.random.default_rng(2)
    g, box = (32, 24, 16), (16, 8, 16)
    assert jboxadd.box_add_supported(box, g)
    hit = rng.integers(0, 256, g).astype(np.uint8)
    hit[4:12] = 253
    miss = rng.integers(0, 256, g).astype(np.uint8)
    starts = np.array([[0, 8, 0], [8, 8, 0], [8, 16, 0]], np.int32)
    bh = rng.integers(0, 3, (3,) + box).astype(np.uint8)
    bm = rng.integers(0, 4, (3,) + box).astype(np.uint8)
    ref = jboxadd.box_add_inplace(*(jnp.asarray(a) for a in
                                    (hit, miss, starts, bh, bm)),
                                  interpret=True)
    got = trc.apply_box_counts(*(torch.from_numpy(a) for a in
                                 (hit, miss, starts, bh, bm)))
    for r, o in zip(ref, got):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert int((got[0] == 255).sum()) > 0


def test_apply_box_counts_matches_rmw_with_saturation():
    rng = np.random.default_rng(0)
    g = (32, 16, 16)
    hit = rng.integers(0, 256, g).astype(np.uint8)
    hit[:8] = 254
    miss = rng.integers(0, 256, g).astype(np.uint8)
    box = (8, 8, 16)
    starts = np.array([[0, 0, 0], [4, 8, 0], [16, 8, 0]], np.int32)
    bh = rng.integers(0, 4, (3,) + box).astype(np.uint8)
    bm = rng.integers(0, 4, (3,) + box).astype(np.uint8)
    ref = jrc.apply_box_counts(*(jnp.asarray(a) for a in
                                 (hit, miss, starts, bh, bm)), mode="rmw")
    got = trc.apply_box_counts(*(torch.from_numpy(a) for a in
                                 (hit, miss, starts, bh, bm)))
    for r, o in zip(ref, got):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_tick_gives_up_its_input_state():
    """A tick adds into its input state's counters in place (the JAX
    package donates the state); a copy kept with ``copy_state`` replays
    the same tick."""
    cfg = GRIDS["unaligned"]
    tc = ft.config_from_fields(dataclasses.asdict(cfg))
    _, frames = treplay.make_sequence(tc, n_frames=3, n_boxes=5, seed=1,
                                      height=H, width=W, orbit_radius=0.8)
    pts, vals, tfs, pos = (b[0] for b in treplay.stage_update_batches(
        tc, frames, device="cpu"))
    state = ft.make_state(tc, device="cpu")
    kept = ft.copy_state(state)
    hit_in, miss_in = state.hit_cnt, state.miss_cnt
    ticked = tpipe.integrate_scan_batch(tc, state, pts, vals, tfs)
    assert ticked.hit_cnt is hit_in and ticked.miss_cnt is miss_in
    assert int(miss_in.sum()) > 0 and not kept.miss_cnt.any()
    new, stats = tpipe.fused_batch_step(tc, ft.copy_state(kept), pts, vals,
                                        tfs, pos)
    again, stats2 = tpipe.fused_batch_step(tc, kept, pts, vals, tfs, pos)
    for f in ft.grid.FIELDS:
        assert torch.equal(getattr(new, f), getattr(again, f)), f
    assert all(torch.equal(a, b) for a, b in zip(stats, stats2))
    assert int(stats.num_observed) == int((miss_in > 0).sum())
    assert not new.hit_cnt.any() and not new.miss_cnt.any()


def test_tick_raises_for_paths_not_ported():
    """Paths that once raised until they were ported.  The drain's shard
    offset (the sharded engine's): a slab's drain with ``x_offset`` equals
    the whole grid's windowed drain on the slab's planes.  The
    hierarchical EDT (edt_fine_dist < trunc_dist) is: ``rebuild_d2``,
    ``rebuild_esdf`` and the eager tick's rebuild equal the JAX package's
    on the same occupancy.  So is the incremental engine (it raised until
    it was ported): an incremental ``esdf_update`` of a state with
    pending counters equals the JAX package's, sweeps included."""
    cfg = ft.config_from_fields(dataclasses.asdict(GRIDS["aligned"]))
    occ = np.random.default_rng(0).random(cfg.grid_shape) < 0.01
    hier = dataclasses.replace(cfg, edt_fine_dist=0.5)
    j_hier = dataclasses.replace(GRIDS["aligned"], edt_fine_dist=0.5)
    assert tpipe._hierarchical(hier)
    occ_t, occ_j = torch.from_numpy(occ), jnp.asarray(occ)
    np.testing.assert_array_equal(tpipe.rebuild_d2(hier, occ_t).numpy(),
                                  np.asarray(jpipe.rebuild_d2_jit(j_hier,
                                                                  occ_j)))
    for got, ref in (
            (tpipe.rebuild_esdf(hier, occ_t),
             jpipe.rebuild_esdf_jit(j_hier, occ_j)),
            (tpipe.tick_rebuild_esdf(
                dataclasses.replace(hier, closest_mode="eager"), occ_t),
             jpipe.tick_rebuild_esdf_jit(
                 dataclasses.replace(j_hier, closest_mode="eager"), occ_j))):
        for g, r in zip(got, ref):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    state = ft.make_state(cfg, device="cpu")
    state.miss_cnt.fill_(2)
    kw = dict(l_hit=0.8, l_miss=-0.4, clamp_min=-2.0, clamp_max=3.5,
              occ_thresh=0.8, occ_is_eq=False,
              window=(torch.zeros(3, dtype=torch.int32),
                      torch.full((3,), 7, dtype=torch.int32)))
    whole = tfusion.fuse_drain(state.logodds, state.seen, state.hit_cnt,
                               state.miss_cnt, **kw)
    slab = tfusion.fuse_drain(
        *(getattr(state, f)[4:8].clone()
          for f in ("logodds", "seen", "hit_cnt", "miss_cnt")),
        x_offset=torch.full((), 4, dtype=torch.int32), **kw)
    for a, b in zip(slab[:5], whole[:5]):
        assert torch.equal(a, b[4:8])
    assert 0 < int(slab[5]) < int(whole[5])
    j_incr = FiestaConfig(resolution=0.5, origin=(-3.0, -2.5, -1.0),
                          map_size=(6.0, 5.0, 4.0), esdf_mode="incremental")
    incr = ft.config_from_fields(dataclasses.asdict(j_incr))
    rng = np.random.default_rng(1)
    shape = incr.grid_shape
    miss = rng.integers(0, 3, shape).astype(np.uint8)
    hit = np.where(rng.random(shape) < 0.1, miss, 0).astype(np.uint8)
    lo = np.where(rng.random(shape) < 0.5, 1.2, 0.0).astype(
        np.float32)                        # one hit step from occupied
    state = dataclasses.replace(ft.make_state(incr, device="cpu"),
                                logodds=torch.from_numpy(lo),
                                hit_cnt=torch.from_numpy(hit),
                                miss_cnt=torch.from_numpy(miss))
    j_state = dataclasses.replace(jgrid.make_state(j_incr),
                                  logodds=jnp.asarray(lo),
                                  hit_cnt=jnp.asarray(hit),
                                  miss_cnt=jnp.asarray(miss))
    got, got_stats = tpipe.esdf_update(incr, state)
    ref, ref_stats = jpipe.esdf_update(j_incr, j_state,
                                       jnp.zeros(3, jnp.float32))
    for f in ft.grid.FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert tuple(int(x) for x in got_stats) == \
        tuple(int(x) for x in ref_stats)
    assert int(got_stats.num_inserted) > 0 and int(got_stats.num_sweeps) > 1
