"""fiesta_tpu_torch's incremental ESDF against fiesta_tpu (CPU).

The same numpy inputs go through ``fiesta_tpu.ops.esdf`` and
``fiesta_tpu_torch.ops.esdf``: ``relax_once`` and ``relax_to_fixpoint``
(every stencil with and without the long jumps, the update, source and
push masks, ``max_iters``), ``apply_occupancy_changes``, ``update_esdf``
(global, windowed and with a packed closest) on the cuboid insert/delete
fixtures of ``tests/test_esdf.py``, and ``build_esdf``.  d2, closest and
the sweep counts must be bit-equal.  The port is also held to the queue
oracle in a window and to the C++ core (``fiesta_tpu.native``), and a
fixture where a reach-2 offset and a jump tie checks the consideration
order.  The JAX relaxation runs op by op (``jax.disable_jit()``) where a
case compiles once only.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu import INF_D2, FiestaConfig, native  # noqa: E402
from fiesta_tpu import stencil_offsets  # noqa: E402
from fiesta_tpu import grid as jgrid  # noqa: E402
from fiesta_tpu.config import jump_offsets  # noqa: E402
from fiesta_tpu.ops import esdf as jesdf  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import grid as tgrid  # noqa: E402
from fiesta_tpu_torch.ops import esdf as tesdf  # noqa: E402

from fiesta_oracle import QueueESDF, exact_edt_d2  # noqa: E402

DIRS = stencil_offsets(24)
SHAPE = (16, 14, 10)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the plain relaxation is thousands of small
    tensor ops, and the suite's workers share the CPU, where more threads
    only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dirs(conn, jumps, shape=SHAPE):
    extra = tuple(d for d in jump_offsets(8)
                  if all(abs(d[i]) < shape[i] for i in range(3)))
    return stencil_offsets(conn) + (extra if jumps else ())


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _same(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _seeded(shape, p, seed):
    """d2 / closest seeded at a random occupancy (relaxation's start)."""
    occ = np.random.default_rng(seed).random(shape) < p
    d2 = np.where(occ, 0, INF_D2).astype(np.int32)
    c = np.where(occ[None], np.asarray(jgrid.coord_grids(shape)),
                 -1).astype(np.int16)
    return occ, d2, c


def _window(shape, lo, hi):
    m = np.zeros(shape, bool)
    m[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1] = True
    return m


def _masks(kind, occ):
    """(update, source, push_src, push_recv) of a mask case."""
    w = _window(SHAPE, (3, 2, 2), (11, 10, 7))
    return {"none": (None, None, None, None),
            "update": (w, None, None, None),
            "source": (None, w, None, None),
            "window": (w | occ, w, occ, w)}[kind]


def _relax_both(d2, c, masks, dirs, max_iters):
    upd, src, psrc, precv = masks
    with jax.disable_jit():
        ref = jesdf.relax_to_fixpoint(
            _j(d2), _j(c), _j(upd), _j(src), dirs, max_iters=max_iters,
            push_src_mask=_j(psrc), push_recv_mask=_j(precv))
    got = tesdf.relax_to_fixpoint(
        _t(d2), _t(c), _t(upd), _t(src), dirs, max_iters, _t(psrc),
        _t(precv))
    return got, ref


@pytest.mark.parametrize("jumps", [False, True], ids=["stencil", "jumps"])
@pytest.mark.parametrize("conn", [6, 24, 26, 62])
def test_relax_to_fixpoint_matches_jax(conn, jumps):
    occ, d2, c = _seeded(SHAPE, 0.01, conn)
    (gd, gc, gi), (rd, rc, ri) = _relax_both(
        d2, c, _masks("none", occ), _dirs(conn, jumps), 0)
    _same(gd, rd, "d2")
    _same(gc, rc, "closest")
    assert gi.dtype == torch.int32 and gi.dim() == 0
    assert int(gi) == int(ri) > 1
    # at the fixpoint one more sweep changes nothing
    _, _, changed = tesdf.relax_once(gd, gc, None, None, _dirs(conn, jumps))
    assert not bool(changed)


@pytest.mark.parametrize("max_iters", [0, 1, 2])
@pytest.mark.parametrize("kind", ["update", "source", "window"])
def test_relax_masks_and_max_iters_match_jax(kind, max_iters):
    occ, d2, c = _seeded(SHAPE, 0.01, 7)
    (gd, gc, gi), (rd, rc, ri) = _relax_both(
        d2, c, _masks(kind, occ), _dirs(24, True), max_iters)
    _same(gd, rd, "d2")
    _same(gc, rc, "closest")
    assert int(gi) == int(ri)
    if max_iters:
        assert int(gi) == max_iters


@pytest.mark.parametrize("conn,jumps", [(6, False), (62, True)])
def test_relax_once_matches_jax(conn, jumps):
    """One sweep from a state part-way to the fixpoint, with the windowed
    masks and the push pass, and from it unmasked."""
    occ, d2, c = _seeded(SHAPE, 0.01, 3)
    d2, c, _ = tesdf.relax_to_fixpoint(_t(d2), _t(c), None, None,
                                       _dirs(24, False), max_iters=2)
    d2, c = d2.numpy(), c.numpy()
    dirs = _dirs(conn, jumps)
    for masks in (_masks("window", occ), _masks("none", occ)):
        with jax.disable_jit():
            ref = jesdf.relax_once(_j(d2), _j(c), *map(_j, masks[:2]), dirs,
                                   push_src_mask=_j(masks[2]),
                                   push_recv_mask=_j(masks[3]))
        got = tesdf.relax_once(_t(d2), _t(c), *map(_t, masks[:2]), dirs,
                               _t(masks[2]), _t(masks[3]))
        for g, r in zip(got, ref):
            _same(g, r)
        assert bool(got[2])


def test_consideration_order_breaks_ties():
    """A jump listed before a reach-1 offset, both giving the same least
    candidate: the reach-1 offset is considered first and wins (the
    ``dirs`` order would pick the jump)."""
    shape = (10, 10, 10)
    d2 = np.full(shape, INF_D2, np.int32)
    c = np.full((3,) + shape, -1, np.int16)
    d2[6, 5, 5], c[:, 6, 5, 5] = 0, (6, 5, 5)     # v + (4,0,0): itself
    d2[2, 6, 5], c[:, 2, 6, 5] = 9, (2, 9, 5)     # v + (0,1,0)
    dirs = ((4, 0, 0), (0, 1, 0))
    got = tesdf.relax_once(_t(d2), _t(c), None, None, dirs)
    with jax.disable_jit():
        ref = jesdf.relax_once(_j(d2), _j(c), None, None, dirs)
    for g, r in zip(got, ref):
        _same(g, r)
    assert int(got[0][2, 5, 5]) == 16
    assert got[1][:, 2, 5, 5].tolist() == [2, 9, 5]


def test_apply_occupancy_changes_matches_jax():
    occ, d2, c = _seeded(SHAPE, 0.02, 11)
    d2, c, _ = tesdf.relax_to_fixpoint(_t(d2), _t(c), None, None, DIRS)
    rng = np.random.default_rng(12)
    now = occ & (rng.random(SHAPE) < 0.6)              # deletes
    ins = (rng.random(SHAPE) < 0.01) & ~occ            # inserts
    now |= ins
    got = tesdf.apply_occupancy_changes(d2, c, _t(now), _t(ins))
    ref = jesdf.apply_occupancy_changes(_j(d2.numpy()), _j(c.numpy()),
                                        _j(now), _j(ins))
    for g, r in zip(got, ref):
        _same(g, r)
    assert int(got[2].sum()) > 0


def _cuboid_groups(shape, rng, n=4):
    groups = []
    for _ in range(n):
        lo = rng.integers(0, np.array(shape) - 2)
        hi = np.minimum(lo + rng.integers(1, 4, size=3), shape)
        groups.append([(x, y, z) for x in range(lo[0], hi[0])
                       for y in range(lo[1], hi[1])
                       for z in range(lo[2], hi[2])])
    return groups


@pytest.mark.parametrize("mode", ["global", "window", "packed"])
def test_update_esdf_cuboid_stress_matches_jax(mode):
    """``tests/test_esdf.py``'s cuboid insert/delete stress pattern
    (test_ESDF_Map.cpp:56-104): every step bit-equal to the JAX update,
    sweeps included; globally, in a window, and through a packed
    closest."""
    shape = (12, 12, 8)
    rng = np.random.default_rng(5)
    wmask = _window(shape, (3, 3, 2), (9, 9, 5)) if mode == "window" \
        else None
    d2 = np.full(shape, INF_D2, np.int32)
    c = np.full((3,) + shape, -1, np.int16)
    if mode == "packed":
        c = np.asarray(jgrid.pack_closest(jnp.asarray(c)))
    jd, jc, td, tc = _j(d2), _j(c), _t(d2), _t(c)
    occ = np.zeros(shape, bool)
    groups = _cuboid_groups(shape, rng)
    steps = [[(v, 1) for v in g] for g in groups]
    steps += [[(v, 0) for v in groups[i]] for i in rng.permutation(4)]
    for changes in steps:
        ins = np.zeros(shape, bool)
        for v, o in changes:
            ins[v] |= bool(o) and not occ[v]
            occ[v] = bool(o)
        jd, jc, ji = jesdf.update_esdf(jd, jc, _j(occ), _j(ins),
                                       _j(np.zeros(shape, bool)), _j(wmask),
                                       DIRS)
        td, tc, ti = tesdf.update_esdf(td, tc, _t(occ), _t(ins), None,
                                       _t(wmask), DIRS)
        _same(td, jd, "d2")
        _same(tc, jc, "closest")
        assert int(ti) == int(ji)
    assert not occ.any()
    if mode != "window":
        assert (td.numpy() == INF_D2).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_windowed_update_matches_queue_oracle(seed):
    """``tests/test_esdf.py:305``'s windowed case: in-window distances
    equal the queue oracle's (patch-B push into the window included),
    nowhere looser than it, never below the exact EDT; and bit-equal to
    the JAX update."""
    shape = (16, 16, 8)
    lo, hi = np.array([4, 4, 2]), np.array([11, 11, 5])
    rng = np.random.default_rng(seed)
    wmask = _window(shape, lo, hi)
    d2 = np.full(shape, INF_D2, np.int32)
    c = np.full((3,) + shape, -1, np.int16)
    jd, jc, td, tc = _j(d2), _j(c), _t(d2), _t(c)
    occ = np.zeros(shape, bool)
    oracle = QueueESDF(shape, DIRS, window=(lo, hi))

    def step(changes):
        nonlocal jd, jc, td, tc
        ins = np.zeros(shape, bool)
        for v, o in changes:
            ins[v] |= bool(o) and not occ[v]
            occ[v] = bool(o)
        td, tc, _ = tesdf.update_esdf(td, tc, _t(occ), _t(ins), None,
                                      _t(wmask), DIRS)
        jd, jc, _ = jesdf.update_esdf(jd, jc, _j(occ), _j(ins), None,
                                      _j(wmask), DIRS)
        _same(td, jd, "d2")
        _same(tc, jc, "closest")
        oracle.set_occupancy(changes)
        ours = td.numpy().astype(np.int64)
        theirs = np.where(oracle.d2 >= oracle.INF, int(INF_D2), oracle.d2)
        np.testing.assert_array_equal(ours[wmask], theirs[wmask])
        assert (ours <= theirs).all()
        finite = ours < int(INF_D2)
        assert (ours[finite] >= exact_edt_d2(occ)[finite]).all()

    for _ in range(4):
        base = rng.integers(0, np.array(shape) - 2)
        ext = rng.integers(1, 4, size=3)
        step([((x, y, z), 1)
              for x in range(base[0], min(base[0] + ext[0], shape[0]))
              for y in range(base[1], min(base[1] + ext[1], shape[1]))
              for z in range(base[2], min(base[2] + ext[2], shape[2]))])
        if occ.any():
            occ_list = np.argwhere(occ)
            kill = occ_list[rng.integers(0, len(occ_list),
                                         size=max(1, len(occ_list) // 3))]
            step([(tuple(v), 0) for v in kill])


@pytest.mark.skipif(not native.available(),
                    reason="native library unavailable")
def test_update_esdf_matches_native_core():
    """Inserts, then deletes, against the C++ core's queue engine
    (``tests/test_native.py``): equal distances after every step."""
    shape = (20, 20, 12)
    rng = np.random.default_rng(7)
    core = native.NativeEsdf(shape)
    td = _t(np.full(shape, INF_D2, np.int32))
    tc = _t(np.full((3,) + shape, -1, np.int16))
    occ = np.zeros(shape, bool)
    groups = _cuboid_groups(shape, rng, n=3)
    steps = [[(v, 1) for v in g] for g in groups]
    steps += [[(v, 0) for v in groups[i]] for i in rng.permutation(3)]
    for changes in steps:
        core.set_occupancy(np.array([v for v, _ in changes], np.int32),
                           np.array([o for _, o in changes], np.uint8))
        core.update()
        ins = np.zeros(shape, bool)
        for v, o in changes:
            ins[v] |= bool(o) and not occ[v]
            occ[v] = bool(o)
        td, tc, _ = tesdf.update_esdf(td, tc, _t(occ), _t(ins), None, None,
                                      DIRS)
        nd2 = core.dist2()
        np.testing.assert_array_equal(
            np.where(nd2 < 0, int(INF_D2), nd2), td.numpy().astype(np.int64))
    assert not occ.any()


@pytest.mark.parametrize("case", ["random", "empty", "full", "cuboids"])
def test_build_esdf_matches_jax(case):
    shape = (24, 20, 16)
    occ = {"random": np.random.default_rng(0).random(shape) < 0.02,
           "empty": np.zeros(shape, bool), "full": np.ones(shape, bool),
           "cuboids": _window(shape, (3, 4, 5), (9, 6, 7))}[case]
    got = tesdf.build_esdf(_t(occ))
    ref = jesdf.build_esdf(_j(occ))
    for g, r in zip(got, ref):
        _same(g, r)
    if case != "empty":
        np.testing.assert_array_equal(got[0].numpy(), exact_edt_d2(occ))


def test_build_esdf_rejects_long_axis():
    with pytest.raises(ValueError, match="cannot represent"):
        tesdf.build_esdf(torch.zeros((513, 2, 2), dtype=torch.bool))


def test_coord_grids_and_state_bytes_match_jax():
    shape = (5, 7, 3)
    _same(tgrid.coord_grids(shape, device="cpu"), jgrid.coord_grids(shape))
    cfg = FiestaConfig(resolution=0.5, origin=(0.0, 0.0, 0.0),
                       map_size=(4.0, 3.0, 2.0), esdf_mode="incremental")
    tcfg = ft.config_from_fields(dataclasses.asdict(cfg))
    assert tgrid.state_bytes(ft.make_state(tcfg, device="cpu")) == \
        jgrid.state_bytes(jgrid.make_state(cfg))
