"""The incremental update's occupancy changes (``esdf.apply_occupancy_changes``
and the ``changes`` kernel's contract) and the drained update on the CPU.

The ``changes`` kernel's registration (its source, C symbol, argument
count and ``__global__`` name), that CPU tensors never reach it, the
three mask forms and the three insert forms (a ``fuse_counts`` insert
mask, the scrolling engine's ``occ & (d2 != 0)`` and the drained
``NewlyOccupied``) against a voxel-by-voxel emulation of the kernel's
body, on a slab with its x origin too; ``NewlyOccupied`` against
``fuse_counts``' insert mask; and ``pipeline._drained_update`` (the
one-pass drain, then the changes and the relaxation, the path a CUDA
state takes) against the ``fuse_counts`` path, over the ticks of two
orbits of different rooms with obstacles going, global and windowed:
every state field and every ``UpdateStats`` bit-equal.  The card tests
(``test_torch_cuda.py``) hold the kernel to the plain version.
"""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import kernels, pipeline  # noqa: E402
from fiesta_tpu_torch.grid import INF_D2, coord_grids  # noqa: E402
from fiesta_tpu_torch.io import replay  # noqa: E402
from fiesta_tpu_torch.ops import esdf, fusion  # noqa: E402

H, W = 24, 32


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the plain relaxation is many small tensor
    ops, and the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_changes_kernel_registered():
    """The ``changes`` kernel's entry: its source, C symbol and launch
    counter, an argument list as long as the C entry's (the stream
    included), and a ``__global__`` the benchmark's reader of hand-written
    kernels finds (so its time is not counted as plain ops) in a source
    of its own, outside ``relax.cu`` (whose kernels ``relax_ms`` reads)."""
    from esdfbench import trace

    src, sym, argtypes = kernels._SIGNATURES["changes"]
    assert (src, sym) == ("changes.cu", "fiesta_changes")
    assert src in kernels.SOURCES and kernels.LAUNCHES["changes"] == 0
    text = (kernels._HERE / src).read_text()
    params = re.search(rf"int {sym}\(([^)]*)\)", text).group(1)
    assert len(params.split(",")) == len(argtypes)
    assert "changes_kernel" in trace.hand_kernel_names(kernels._HERE)
    assert "changes_kernel" not in trace.hand_kernel_names(kernels._HERE,
                                                           "relax.cu")


def _scene(shape, seed, x_offset=0, gx_all=None):
    """A d2 / closest state on an X-slab of ``shape`` whose closest
    coordinates are global (the slab starts at x ``x_offset`` of a grid
    ``gx_all`` planes long), the whole grid's occupancy after a drain and
    an insert mask: undefined closests, closests at obstacles that stay
    and at obstacles that went, inserts on voxels whose obstacle went and
    at the grid's faces."""
    g = torch.Generator().manual_seed(seed)
    gx, gy, gz = shape
    gx_all = gx_all or gx
    full = (gx_all, gy, gz)
    occ = torch.rand(full, generator=g) < 0.15
    pts = torch.nonzero(torch.rand(full, generator=g) < 0.3)
    pick = torch.randint(0, len(pts), shape, generator=g)
    closest = pts[pick].permute(3, 0, 1, 2).to(torch.int16)
    undefined = torch.rand(shape, generator=g) < 0.2
    closest = torch.where(undefined[None], -1, closest)
    diff = (coord_grids(shape, "cpu").to(torch.int32)
            - closest.to(torch.int32)) + torch.tensor(
                [x_offset, 0, 0], dtype=torch.int32)[:, None, None, None]
    d2 = torch.where(undefined, INF_D2, (diff * diff).sum(0))
    own = occ[x_offset:x_offset + gx]
    insert = own & (torch.rand(shape, generator=g) < 0.5)
    insert[0] |= own[0]                       # the grid's faces
    insert[:, -1] |= own[:, -1]
    return d2.to(torch.int32), closest, occ, insert


def _emulated(d2, closest, occ, insert, x_offset, mask):
    """The kernel's body, voxel by voxel in plain Python."""
    d2, closest = d2.clone(), closest.clone()
    gx, gy, gz = d2.shape
    out = torch.zeros(d2.shape, dtype=torch.bool)
    for x in range(gx):
        for y in range(gy):
            for z in range(gz):
                c = [int(closest[k, x, y, z]) for k in range(3)]
                ins = bool(insert[x, y, z])
                if ins:
                    d2[x, y, z] = 0
                    c = [np.int16(x + x_offset), y, z]
                reset = c[0] >= 0 and not bool(occ[c[0], c[1], c[2]])
                if reset:
                    d2[x, y, z] = INF_D2
                    c = [-1, -1, -1]
                closest[:, x, y, z] = torch.tensor(c, dtype=torch.int16)
                out[x, y, z] = reset or (mask == "queued" and ins)
    return d2, closest, None if mask is None else out


@pytest.mark.parametrize("mask", kernels.CHANGES_MASKS)
@pytest.mark.parametrize("form", ["insert_mask", "scrolling", "drained"])
def test_changes_forms_equal_emulation(form, mask):
    """Every insert form and mask form of ``apply_occupancy_changes`` on
    the CPU against the emulated kernel body."""
    d2, closest, occ, insert = _scene((7, 6, 5), 3)
    if form == "scrolling":
        insert = occ & (d2 != 0)
        arg = insert
    elif form == "drained":
        lo = torch.where(insert, -1.0, torch.where(occ, 2.0, 0.25))
        arg = esdf.NewlyOccupied(lo.to(torch.float32), 0.5, False)
        assert torch.equal(arg.mask(occ.to(torch.uint8)), insert)
        occ = occ.to(torch.uint8)             # the drain's u8 occupancy
    else:
        arg = insert
    got = esdf.apply_occupancy_changes(d2, closest, occ, arg, mask=mask)
    ref = _emulated(d2, closest, occ.to(torch.bool), insert, 0, mask)
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(insert.sum()) > 0
    assert mask is None or int(ref[2].sum()) > int(insert.sum())
    assert kernels.LAUNCHES["changes"] == 0


@pytest.mark.parametrize("x_offset", [0, 3, 9])
def test_changes_on_a_slab(x_offset):
    """An X-slab of a 14-plane grid: inserts take global coordinates and
    the resets read the whole grid's occupancy."""
    d2, closest, occ, insert = _scene((5, 6, 4), x_offset, x_offset, 14)
    got = esdf.apply_occupancy_changes(d2, closest, occ, insert,
                                       x_offset=x_offset)
    ref = _emulated(d2, closest, occ, insert, x_offset, "reset")
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(ref[2].sum()) > 0


def test_changes_kernel_wants_cuda_tensors():
    """A CPU tensor never reaches the kernel: the wrapper refuses it, and
    ``apply_occupancy_changes`` routes CPU tensors to the plain version."""
    d2, closest, occ, insert = _scene((4, 5, 6), 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.changes(d2, closest, occ, insert)
    got = esdf.apply_occupancy_changes(d2, closest, occ, insert)
    ref = esdf._apply_occupancy_changes_plain(d2, closest, occ, insert)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert kernels.LAUNCHES["changes"] == 0


def _cfg(window, probabilistic=True):
    """A 32x32x16 map at 0.1 m in incremental mode, its log-odds clamped
    so low that one missed tick frees an occupied voxel; with ``window`` a
    local update of 1.2 x 1.2 x 0.6 m around the robot."""
    return replay.scale_intrinsics(ft.FiestaConfig(
        resolution=0.1, origin=(-1.6, -1.6, -0.3), map_size=(3.2, 3.2, 1.6),
        min_ray_length=0.2, max_ray_length=1.5, max_points_per_scan=H * W,
        esdf_mode="incremental", global_update=not window, p_max=0.85,
        probabilistic=probabilistic, radius=(1.2, 1.2, 0.6)), H, W)


@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
@pytest.mark.parametrize("probabilistic", [True, False])
def test_newly_occupied_is_fuse_counts_insert_mask(probabilistic, window):
    """Log-odds at and around the thresholds and the clamps: the one-pass
    drain's occupancy and ``NewlyOccupied`` give ``fuse_counts``' insert
    mask, and the drain's counts its masks' counts."""
    cfg = _cfg(window, probabilistic)
    rng = np.random.default_rng(5)
    shape = cfg.grid_shape
    thr = cfg.min_occupancy_log
    one = np.float32(1.0)   # deterministic mode's occupied value
    lo = torch.from_numpy(rng.choice(np.float32(
        [0.0, cfg.clamp_min_log, cfg.clamp_max_log, thr, thr - 0.2,
         thr + 0.2, np.nextafter(np.float32(thr), np.float32(9)),
         one, one - np.float32(cfg.prob_hit_log),
         one - np.float32(cfg.prob_miss_log), -0.4]), size=shape))
    seen = torch.from_numpy((rng.random(shape) < 0.5).astype(np.uint8))
    miss = torch.from_numpy(rng.integers(0, 4, size=shape).astype(np.uint8))
    hit = torch.minimum(torch.from_numpy(
        rng.integers(0, 4, size=shape).astype(np.uint8)), miss)
    pos = torch.tensor([0.3, -0.2, 0.4])
    window_b = ft.local_window(cfg, pos) if window else None
    fr = fusion.fuse_counts(cfg, lo, seen, hit, miss, window_mask=(
        None if window_b is None else ft.grid.window_mask(cfg, *window_b)))
    on, eq = ((cfg.min_occupancy_log, False) if probabilistic
              else (1.0, True))
    _, _, occ, _, _, n_obs, n_ins, n_del = fusion._fuse_drain_plain(
        lo, seen, hit, miss, l_hit=cfg.prob_hit_log,
        l_miss=cfg.prob_miss_log, clamp_min=cfg.clamp_min_log,
        clamp_max=cfg.clamp_max_log, occ_thresh=on, occ_is_eq=eq,
        window=window_b)
    inserts = esdf.NewlyOccupied(lo, on, eq).mask(occ)
    assert torch.equal(inserts, fr.insert_mask)
    assert int(inserts.sum()) > 0
    assert [int(n_obs), int(n_ins), int(n_del)] == [
        int(fr.num_observed), int(fr.insert_mask.sum()),
        int(fr.delete_mask.sum())]


def _ticks(cfg):
    """Three ticks of an orbit in one room, then three in another."""
    pts, vals, tfs, pos = [], [], [], []
    for seed in (4, 9):
        _, frames = replay.make_sequence(cfg, n_frames=9, n_boxes=6,
                                         seed=seed, height=H, width=W,
                                         orbit_radius=0.5)
        b = replay.stage_update_batches(cfg, frames, device="cpu")
        for acc, x in zip((pts, vals, tfs, pos), b):
            acc.append(x)
    return [torch.cat(x) for x in (pts, vals, tfs, pos)]


def _obstacles_gone(cfg, state, g):
    """A third of the occupied voxels, drawn by ``g``, seen free this tick
    (misses and no hit in their counters): obstacles that moved away."""
    occ = torch.nonzero(ft.occupied_grid(cfg, state.logodds))
    gone = occ[torch.randperm(len(occ), generator=g)[:len(occ) // 3]]
    hit, miss = state.hit_cnt.clone(), state.miss_cnt.clone()
    hit[tuple(gone.T)] = 0
    miss[tuple(gone.T)] = 3
    return dataclasses.replace(state, hit_cnt=hit, miss_cnt=miss)


@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
def test_drained_update_equals_fuse_counts_path(window):
    """``_drained_update`` (the card's update, here on its plain
    versions) against ``_incremental_update``'s ``fuse_counts`` path from
    the same integrated state, tick by tick, obstacles going from the
    third tick on: every state field and every ``UpdateStats`` field (the
    sweeps included) bit-equal."""
    cfg = _cfg(window)
    pts, vals, tfs, pos = _ticks(cfg)
    g = torch.Generator().manual_seed(11)
    state = ft.make_state(cfg, device="cpu")
    counts = torch.zeros(3, dtype=torch.int64)
    for i in range(pts.shape[0]):
        state = pipeline.integrate_scan_batch(cfg, state, pts[i], vals[i],
                                              tfs[i], pos[i],
                                              use_window=window)
        if i >= 2:
            state = _obstacles_gone(cfg, state, g)
        ref, ref_stats = pipeline._incremental_update(cfg, state, pos[i],
                                                      window, 0)
        got, got_stats = pipeline._drained_update(cfg, state, pos[i],
                                                  window, 0)
        for f in dataclasses.fields(ref):
            a, b = getattr(got, f.name), getattr(ref, f.name)
            assert a.dtype == b.dtype and torch.equal(a, b), (i, f.name)
        for f, a, b in zip(ref_stats._fields, got_stats, ref_stats):
            assert a.dtype == b.dtype and torch.equal(a, b), (i, f)
        counts += torch.stack([ref_stats.num_inserted, ref_stats.num_deleted,
                               ref_stats.num_sweeps]).to(torch.int64)
        state = ref
    inserted, deleted, sweeps = counts.tolist()
    assert inserted > 50 and deleted > 10 and sweeps > 6
