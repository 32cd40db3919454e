"""The relax kernel's frontier schedule on the CPU (no card needed).

``kernels/relax.cu`` sweeps the incremental ESDF's relaxation to its
fixpoint, but after its first, dense sweep it visits only the tiles of
``kernels.RELAX_TILE`` voxels that ``kernels.relax_tile_offsets`` marks
from the tiles that changed, and inside them pulls only from neighbours
whose changed bit of the sweep before is set and valid.  This file holds
a plain PyTorch emulation of that schedule (``emulate_relax``): the input
packed into the first of two buffers, the dense first sweep, the per-tile
activity stamps, the buffers written only in visited tiles (a tile that
changed is visited in the next sweep too, so a skipped tile's other
buffer holds its current values), the changed bits of each sweep parity
validated by each tile's changed stamp of that parity (a stale bit would
only cost work: a neighbour that did not change cannot win), and the
read-out of the last buffer written.  It must equal
``esdf._relax_to_fixpoint_plain`` and ``fiesta_tpu``'s
``relax_to_fixpoint`` exactly (d2, closest, sweeps) in the global and
windowed (push masks) modes, with ``max_iters``, and on tiles that do
not divide the grid; a property test holds the tile-offset
table to every voxel-level receiver.
"""

import itertools

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu.ops import esdf as jesdf  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import kernels  # noqa: E402
from fiesta_tpu_torch import pipeline as tpipe  # noqa: E402
from fiesta_tpu_torch.config import (STENCILS, jump_offsets,  # noqa: E402
                                     stencil_offsets)
from fiesta_tpu_torch.io import replay as treplay  # noqa: E402
from fiesta_tpu_torch.ops import esdf as tesdf  # noqa: E402

SHAPE = (16, 14, 10)
ODD_TILE = (3, 5, 4)      # divides no axis of SHAPE


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the emulation is thousands of small tensor
    ops, and the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trimmed_jumps(max_jump, shape):
    return tuple(d for d in jump_offsets(max_jump)
                 if all(abs(d[i]) < shape[i] for i in range(3)))


def _dirs(conn, jumps, shape=SHAPE):
    return stencil_offsets(conn) + (_trimmed_jumps(8, shape) if jumps
                                    else ())


# ---------------------------------------------------------------------------
# the tile-offset table
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None, database=None)
@given(conn=st.sampled_from(sorted(STENCILS)),
       max_jump=st.integers(0, 64),
       shape=st.tuples(*(st.integers(1, 70),) * 3),
       tile=st.tuples(*(st.integers(1, 17),) * 3),
       seed=st.integers(0, 2 ** 31 - 1))
def test_tile_offsets_cover_every_receiver(conn, max_jump, shape, tile,
                                           seed):
    """For every direction d and changed voxel u, the receiver v = u - d
    (which pulls from u) lies in a tile that the tile-level dilation of
    u's tile marks; u's own tile is marked too."""
    dirs = stencil_offsets(conn) + _trimmed_jumps(max_jump, shape)
    offs = set(kernels.relax_tile_offsets(dirs, tile))
    assert (0, 0, 0) in offs
    rng = np.random.default_rng(seed)
    us = rng.integers(0, shape, size=(40, 3))
    d = np.array(dirs, np.int64)
    for u in us:
        v = u[None] - d
        inside = ((v >= 0) & (v < np.array(shape))).all(1)
        for vv in v[inside]:
            dt = tuple(int(a) // t - int(b) // t
                       for a, b, t in zip(vv, u, tile))
            assert dt in offs, (tuple(u), tuple(vv), dt)


def test_tile_offsets_at_cow():
    """cow_and_lady's 54 directions on the kernel's tile: the tiles
    around that share a face or an edge (the 24-stencil has no corner
    offset), and along each axis the tiles that the jumps reach."""
    cfg = ft.COW_AND_LADY
    offs = kernels.relax_tile_offsets(cfg.relax_dirs)
    near = {o for o in itertools.product((-1, 0, 1), repeat=3)
            if sum(map(abs, o)) <= 2}
    assert near <= set(offs)
    far = sorted(o for o in offs if o not in near)
    tx, ty, tz = kernels.RELAX_TILE
    want = set()
    for axis, t in enumerate((tx, ty, tz)):
        for d in (4, 8, 16, 32, 64):
            if d < cfg.grid_shape[axis]:
                for s in (-d, d):
                    for m in range(t):
                        o = [0, 0, 0]
                        o[axis] = (m - s) // t
                        want.add(tuple(o))
    assert far == sorted(want - near)
    assert len(offs) <= kernels.RELAX_MAX_TILE_OFFSETS


def test_tile_offsets_fit_the_kernel_for_any_table():
    """The most offsets any accepted table can give (every stencil, up to
    RELAX_MAX_DIRS directions) fit the kernel's table."""
    jumps = tuple((0, 0, s) for k in range(3, 64) for s in (-k, k))
    dirs = stencil_offsets(62) + jumps
    dirs = dirs[:kernels.RELAX_MAX_DIRS]
    assert len(kernels.relax_tile_offsets(dirs)) <= \
        kernels.RELAX_MAX_TILE_OFFSETS


# ---------------------------------------------------------------------------
# the emulation of the kernel's schedule
# ---------------------------------------------------------------------------

def emulate_relax(d2, closest, update_mask, source_mask, dirs, max_iters=0,
                  push_src_mask=None, push_recv_mask=None,
                  tile=kernels.RELAX_TILE):
    """``relax.cu``'s schedule in plain PyTorch.  Returns (d2, closest,
    sweeps, tiles visited per sweep)."""
    shape = tuple(d2.shape)
    nt = tuple(-(-n // t) for n, t in zip(shape, tile))
    ntiles = int(np.prod(nt))
    ix, iy, iz = np.ix_(*(np.arange(n) // t for n, t in zip(shape, tile)))
    tid = torch.from_numpy((ix * nt[1] + iy) * nt[2] + iz)
    small, jumps = tesdf.consideration_order(dirs)
    offs = kernels.relax_tile_offsets(small + jumps, tile)
    # the kernel packs its input into buffer 0; sweep k reads buffer k % 2
    # and writes the other, only in the tiles it visits
    bufs = [[d2.clone(), closest.clone()],
            [torch.empty_like(d2), torch.empty_like(closest)]]
    stamp = torch.zeros(ntiles, dtype=torch.int64)
    tile_chg = [torch.full((ntiles,), -1, dtype=torch.int64)
                for _ in range(2)]
    bits = [torch.zeros(shape, dtype=torch.bool) for _ in range(2)]
    visited = []
    k = 0
    while True:
        rd, wr = bufs[k % 2], bufs[(k + 1) % 2]
        if k == 0:
            active_t = torch.ones(ntiles, dtype=torch.bool)
            eff = torch.ones(shape, dtype=torch.bool)
        else:
            p = (k - 1) % 2
            active_t = stamp >= k
            # a bit counts only if its tile changed in that sweep (else
            # it is left from an older sweep of the same parity)
            eff = bits[p] & (tile_chg[p] == k - 1)[tid]
        active = active_t[tid]
        src = eff if source_mask is None else source_mask & eff
        psrc = None if push_src_mask is None else push_src_mask & eff
        nd2, nc, _ = tesdf.relax_once(rd[0], rd[1], update_mask, src, dirs,
                                      psrc, push_recv_mask)
        changed = (nd2 < rd[0]) & active
        wr[0][active] = nd2[active]
        wr[1][:, active] = nc[:, active]
        bits[k % 2][active] = changed[active]
        chg_t = torch.zeros(ntiles, dtype=torch.bool)
        chg_t[tid[changed]] = True
        tile_chg[k % 2][chg_t] = k
        marked = np.zeros(nt, bool)
        chg3 = chg_t.numpy().reshape(nt)
        for o in offs:
            src_sl = tuple(slice(max(0, -a), n - max(0, a))
                           for a, n in zip(o, nt))
            dst_sl = tuple(slice(max(0, a), n - max(0, -a))
                           for a, n in zip(o, nt))
            marked[dst_sl] |= chg3[src_sl]
        m = torch.from_numpy(marked.reshape(-1))
        stamp[m] = torch.clamp(stamp[m], min=k + 1)
        visited.append(int(active_t.sum()))
        k += 1
        if not bool(changed.any()) or (max_iters and k >= max_iters):
            break
    return bufs[k % 2][0], bufs[k % 2][1], k, visited


def _seeded(shape, p, seed):
    occ = np.random.default_rng(seed).random(shape) < p
    d2 = np.where(occ, 0, ft.grid.INF_D2).astype(np.int32)
    c = np.where(occ[None], ft.grid.coord_grids(shape, "cpu").numpy(),
                 -1).astype(np.int16)
    return occ, d2, c


def _window(shape, lo, hi):
    m = np.zeros(shape, bool)
    m[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1] = True
    return m


def _masks(kind, occ, shape=SHAPE):
    w = _window(shape, (3, 2, 2), (11, 10, 7))
    return {"global": (None,) * 4,
            "window": (w | occ, w, occ, w)}[kind]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(np.asarray(a))


def _check_three(d2, c, masks, dirs, max_iters, tile):
    """The emulation == the plain loop == fiesta_tpu, exactly; returns
    (sweeps, tiles visited per sweep, tile count)."""
    upd, src, psrc, precv = (_t(m) for m in masks)
    d2, c = _t(d2), _t(c)
    got = emulate_relax(d2, c, upd, src, dirs, max_iters, psrc, precv, tile)
    ref = tesdf._relax_to_fixpoint_plain(d2, c, upd, src, dirs, max_iters,
                                         psrc, precv)
    with jax.disable_jit():
        jref = jesdf.relax_to_fixpoint(
            _j(d2), _j(c), _j(upd), _j(src), dirs, max_iters=max_iters,
            push_src_mask=_j(psrc), push_recv_mask=_j(precv))
    for g, r, j, what in zip(got[:2], ref[:2], jref[:2], ("d2", "closest")):
        assert torch.equal(g, r), what
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=what)
    assert got[2] == int(ref[2]) == int(jref[2])
    ntiles = int(np.prod([-(-n // t) for n, t in zip(d2.shape, tile)]))
    visited = got[3]
    assert visited[0] == ntiles
    assert all(0 < v <= ntiles for v in visited)
    return got[2], visited, ntiles


@pytest.mark.parametrize("tile", [kernels.RELAX_TILE, ODD_TILE],
                         ids=["kernel_tile", "odd_tile"])
@pytest.mark.parametrize("jumps", [False, True], ids=["stencil", "jumps"])
@pytest.mark.parametrize("conn", sorted(STENCILS))
def test_emulation_matches_plain_and_jax(conn, jumps, tile):
    occ, d2, c = _seeded(SHAPE, 0.01, conn)
    sweeps, visited, ntiles = _check_three(
        d2, c, _masks("global", occ), _dirs(conn, jumps), 0, tile)
    assert sweeps > 1


@pytest.mark.parametrize("max_iters", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["global", "window"])
def test_emulation_masks_and_max_iters(kind, max_iters):
    """The windowed masks with the push pass, and ``max_iters`` stopping
    on an odd and on an even sweep (the final copy of the scratch), on
    tiles that divide no axis of the grid."""
    occ, d2, c = _seeded(SHAPE, 0.01, 7)
    sweeps, _, _ = _check_three(d2, c, _masks(kind, occ), _dirs(24, True),
                                max_iters, ODD_TILE)
    if max_iters:
        assert sweeps == max_iters


def test_emulation_skips_tiles_on_a_sparse_change():
    """A converged map with one obstacle added in a corner: the sweeps
    after the first visit only the tiles around the change."""
    shape = (24, 20, 18)
    occ, d2, c = _seeded(shape, 0.004, 11)
    dirs = _dirs(24, True, shape)
    d2f, cf, _ = tesdf._relax_to_fixpoint_plain(_t(d2), _t(c), None, None,
                                                dirs)
    d2n, cn = d2f.clone(), cf.clone()
    d2n[1, 1, 1], cn[:, 1, 1, 1] = 0, torch.tensor([1, 1, 1])
    sweeps, visited, ntiles = _check_three(d2n.numpy(), cn.numpy(),
                                           (None,) * 4, dirs, 0, ODD_TILE)
    assert sweeps > 2
    assert max(visited[1:]) < ntiles


def test_emulation_long_jump_into_a_quiet_tile():
    """A change that only a long jump carries into a tile whose reach-2
    neighbours did not change: the jump's changed bit, read from a tile
    two tiles away, must be seen."""
    shape = (20, 6, 6)
    d2 = np.full(shape, ft.grid.INF_D2, np.int32)
    c = np.full((3,) + shape, -1, np.int16)
    d2[18, 3, 3], c[:, 18, 3, 3] = 0, (18, 3, 3)
    dirs = ((1, 0, 0), (-1, 0, 0), (8, 0, 0))
    sweeps, visited, ntiles = _check_three(d2, c, (None,) * 4, dirs, 0,
                                           (4, 6, 6))
    assert sweeps > 3
    assert min(visited[1:]) < ntiles


# ---------------------------------------------------------------------------
# the incremental stream's own relaxation calls
# ---------------------------------------------------------------------------

H, W = 24, 32


def _stream_calls(window):
    """The relax calls of the incremental tick stream on the fixture of
    ``tests/test_torch_incremental.py`` (48x48x32 at 0.1 m): the inputs
    and the plain result of each."""
    cfg = treplay.scale_intrinsics(ft.FiestaConfig(
        resolution=0.1, origin=(-2.4, -2.4, -1.0), map_size=(4.8, 4.8, 3.2),
        min_ray_length=0.3, max_ray_length=1.5, max_points_per_scan=H * W,
        esdf_mode="incremental", global_update=not window,
        radius=(1.5, 1.5, 0.8)), H, W)
    _, frames = treplay.make_sequence(cfg, n_frames=9, n_boxes=5, seed=1,
                                      height=H, width=W, orbit_radius=0.8)
    batches = treplay.stage_update_batches(cfg, frames, device="cpu")
    calls, plain = [], tesdf.relax_to_fixpoint

    def record(*args, **kw):
        out = plain(*args, **kw)
        calls.append((args, kw, out))
        return out

    tesdf.relax_to_fixpoint = record
    try:
        tpipe.fused_stream(cfg, ft.make_state(cfg, device="cpu"), *batches,
                           use_window=window)
    finally:
        tesdf.relax_to_fixpoint = plain
    return calls


@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
def test_emulation_on_the_incremental_stream(window):
    """Every relax call of the incremental stream, global and windowed,
    on the kernel's tile and on an odd one: the emulation equals the
    stream's plain result and fiesta_tpu's relax_to_fixpoint."""
    calls = _stream_calls(window)
    assert len(calls) == 3
    for args, kw, out in calls:
        d2, c, upd, src, dirs = args
        kw = dict(kw)
        max_iters = kw.pop("max_iters", 0)
        psrc, precv = kw.get("push_src_mask"), kw.get("push_recv_mask")
        assert (psrc is not None) == window
        with jax.disable_jit():
            jref = jesdf.relax_to_fixpoint(
                _j(d2), _j(c), _j(upd), _j(src), dirs, max_iters=max_iters,
                push_src_mask=_j(psrc), push_recv_mask=_j(precv))
        for tile in (kernels.RELAX_TILE, (5, 7, 6)):
            got = emulate_relax(d2, c, upd, src, dirs, max_iters, psrc,
                                precv, tile)
            for g, r, j in zip(got[:2], out[:2], jref[:2]):
                assert torch.equal(g, r)
                np.testing.assert_array_equal(g.numpy(), np.asarray(j))
            assert got[2] == int(out[2]) == int(jref[2])
    assert max(int(o[2]) for _, _, o in calls) > 1
