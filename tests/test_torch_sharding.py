"""fiesta_tpu_torch's sharded grid ops against fiesta_tpu.parallel (CPU).

The same seeded numpy inputs go through the JAX sharded functions on
conftest's 8-device virtual CPU mesh and through the port's on virtual CPU
meshes of 2 and 8 shards (``sharding.make_mesh(n, ["cpu"] * n)``); the
states, stats, closest grids and sweep counts must be bit-equal, and equal
to the port's single-device results.  One test for each of
``tests/test_sharding.py``'s grid-level functions (the engine-level ones
are in ``test_torch_sharding_engine.py``), on its grids (32x20x10,
128x20x10 and 64x40x24), plus what the port adds: both closest layouts
(plan a == 0, and c == 0 forced by patching ``closest_plan`` in both
packages: no small grid selects it), slabs thinner than t (the multi-hop
halo and the raw binary passes at lx <= t), boxes straddling slab
boundaries (the box add's shifted corners against JAX's clip-and-pad),
the drain's ``x_offset``, ``relax_once(x_offset=...)`` against JAX's
``_relax_once_local`` inside ``shard_map``, and the tick through
``distributed_mesh`` in two gloo processes against the in-process mesh.
"""

import dataclasses
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from fiesta_tpu import FiestaConfig  # noqa: E402
from fiesta_tpu import grid as jgrid  # noqa: E402
from fiesta_tpu.ops import raycast as jraycast  # noqa: E402
from fiesta_tpu.ops.pallas import fuse as jfuse  # noqa: E402
from fiesta_tpu.ops.pallas import edt as jedt  # noqa: E402
from fiesta_tpu.parallel import sharding as jsh  # noqa: E402
from fiesta_tpu.pipeline import derive_closest as jderive  # noqa: E402
from fiesta_tpu.scrolling import scroll_state as jscroll  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import grid as tgrid  # noqa: E402
from fiesta_tpu_torch.ops import edt as tedt  # noqa: E402
from fiesta_tpu_torch.ops import esdf as tesdf  # noqa: E402
from fiesta_tpu_torch.ops import fusion as tfusion  # noqa: E402
from fiesta_tpu_torch.ops import raycast as traycast  # noqa: E402
from fiesta_tpu_torch.parallel import sharding  # noqa: E402
from fiesta_tpu_torch.scrolling import scroll_state as tscroll  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs conftest's 8-device CPU mesh")

#: tests/test_sharding.py's grids
CFG = FiestaConfig(resolution=0.1, origin=(-1.6, -1.0, -0.5),
                   map_size=(3.2, 2.0, 1.0))          # 32x20x10
EDT_CFG = FiestaConfig(resolution=0.1, origin=(-6.4, -1.0, -0.5),
                       map_size=(12.8, 2.0, 1.0))     # 128x20x10
TICK_CFG = FiestaConfig(resolution=0.1, origin=(-3.2, -2.0, -1.2),
                        map_size=(6.4, 4.0, 2.4),     # 64x40x24, lx 8 at n 8
                        min_ray_length=0.2, max_ray_length=1.5,
                        trunc_dist=1.2, edt_fine_dist=1.2,   # t 12 > lx
                        esdf_mode="rebuild", global_update=True)
NS = (2, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(cfg):
    return ft.config_from_fields(dataclasses.asdict(cfg))


def _mesh(n):
    return sharding.make_mesh(n, ["cpu"] * n)


def _jmesh(n=8):
    return jsh.make_mesh(n)


def _split(x, n, axis=0):
    """Host array or tensor -> the port's per-shard slabs."""
    t = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x
    lx = t.shape[axis] // n
    return [t.narrow(axis, i * lx, lx).contiguous() for i in range(n)]


def _cat(xs, axis=0):
    return torch.cat(list(xs), axis).numpy()


def _jput(x, mesh, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype == bool and got.dtype == np.uint8:
        want = want.astype(np.uint8)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, want.dtype, got.shape, want.shape)
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _random_occ(shape, p, seed):
    return np.random.default_rng(seed).random(shape) < p


# ---------------------------------------------------------------------------
# The mesh and the state
# ---------------------------------------------------------------------------


def test_mesh_collectives_and_state_round_trip():
    """The collectives on a virtual mesh, and shard_state / gather_state
    in both closest formats (packed [X,Y,Z] on axis 0, planes on axis
    1)."""
    mesh = _mesh(4)
    assert mesh.size == 4 and mesh.axis_names == ("x",)
    xs = [torch.full((2, 3), i, dtype=torch.int32) for i in range(4)]
    right = mesh.shift(xs, 1, -1)
    assert [int(r[0, 0]) for r in right] == [-1, 0, 1, 2]
    left = mesh.shift(xs, -2)
    assert left[2] is None and left[3] is None and int(left[0][0, 0]) == 2
    assert [int(s) for s in mesh.psum([x[0, 0] for x in xs])] == [6] * 4
    assert int(mesh.pmin([x[0, 0] + 3 for x in xs])[1]) == 3
    g = mesh.all_gather(xs)
    assert g[0].shape == (8, 3) and g[3] is g[0]
    assert mesh.x0s(5) == [0, 5, 10, 15]
    with pytest.raises(ValueError, match="requested a 9-device mesh"):
        sharding.make_mesh(9)
    for eager in (False, True):
        cfg = _port(dataclasses.replace(TICK_CFG, closest_mode="eager",
                                        esdf_mode="rebuild" if eager
                                        else "incremental"))
        rng = np.random.default_rng(1)
        empty = ft.make_state(cfg, "cpu")
        state = tgrid.state_from_arrays(cfg, {
            f: (rng.normal(size=a.shape) * 100).astype(a.numpy().dtype)
            for f, a in ((f, getattr(empty, f)) for f in tgrid.FIELDS)},
            device="cpu")
        axes = sharding.state_shardings(state)
        assert axes["closest"] == (0 if state.closest.dim() == 3 else 1)
        sstate = sharding.shard_state(state, _mesh(8))
        assert sstate.closest[0].shape[axes["closest"]] == 8
        back = sharding.gather_state(sstate, _mesh(8))
        for f in tgrid.FIELDS:
            _same(getattr(back, f), getattr(state, f), f)


# ---------------------------------------------------------------------------
# EDT: raw passes on short slabs, the composed EDT, both closest layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lx", [4, 8, 13])
def test_raw_binary_passes_on_slabs_thinner_than_t(lx):
    """The raw L1 pass (``square=False``: t + 1 beyond the local reach
    min(t, lx - 1)) and the raw packed pass on slabs of lx <= t, against
    JAX's ``l1_pass`` and ``_binary_packed_xla``."""
    t = 12
    occ = _random_occ((lx, 20, 10), 0.03, lx)
    f = np.where(occ, 0, jedt._INF_EDT).astype(np.int32)
    _same(tedt.binary_pass(torch.from_numpy(f), t, square=False),
          jedt.l1_pass(jnp.asarray(f), t), "l1")
    plan = jedt.closest_plan((64, 40, 24), t)
    assert plan == tedt.closest_plan((64, 40, 24), t)
    _same(tedt.binary_packed(torch.from_numpy(occ.astype(np.uint8)), plan,
                             0, square=False),
          jedt._binary_packed_xla(jnp.asarray(occ.astype(np.uint8)), plan,
                                  square=False), "packed")


@pytest.fixture(scope="module")
def edt_case():
    occ = _random_occ(EDT_CFG.grid_shape, 0.02, 9)
    want = {}
    for t in (8, 20):
        fn = jsh.sharded_truncated_edt(EDT_CFG, _jmesh(), t)
        want[t] = np.asarray(fn(_jput(occ, _jmesh(), P("x", None, None))))
    return occ, want


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("t", [8, 20])
def test_sharded_truncated_edt_matches_single(edt_case, t, n):
    """``sharded_truncated_edt`` (the x pass composed through log-hop
    edge planes; t = 20 exceeds the 16-plane slabs at n = 8) against the
    JAX sharded EDT and the port's single-device one."""
    occ, want = edt_case
    got = _cat(sharding.sharded_truncated_edt(_port(EDT_CFG), _mesh(n), t)(
        _split(occ, n)))
    _same(got, want[t])
    _same(got, tedt.truncated_edt_d2(torch.from_numpy(occ), t))


def _c0_plan(shape, t):
    """A packed closest plan with the split pass along x (c == 0), the
    layout ``closest_plan`` picks only past the int32 budget of the
    x-lead layout."""
    bits = [max(int(g - 1).bit_length(), 1) for g in shape]
    plan = dict(a=1, b=2, c=0, ba=bits[1], bb=bits[2], s=bits[1] + bits[2],
                cap=t * t + 1, t=t)
    vbits = max(int(2 * t * t + 1).bit_length(),
                int(t * t + 1).bit_length() + 1)
    assert vbits + plan["s"] <= 31
    return plan


@pytest.fixture
def layout(request, monkeypatch):
    """``closest_plan`` as it is (a == 0 on these grids) or forced to the
    c == 0 layout, in both packages."""
    if request.param == "c0":
        for mod in (jedt, tedt):
            monkeypatch.setattr(mod, "closest_plan", _c0_plan)
    return request.param


_JAX_CLOSEST = {}


@pytest.mark.parametrize("layout", ["a0", "c0"], indirect=True)
@pytest.mark.parametrize("n", NS)
def test_local_edt_closest_both_layouts(layout, n):
    """``_local_edt_closest`` in both layouts (a == 0: the raw packed
    pass composed across shards with a global payload; c == 0: the split
    pass over a multi-hop halo of t = 12 planes, slabs of 8 at n = 8),
    against the JAX function under ``shard_map`` and the port's
    single-device transform."""
    shape, t = TICK_CFG.grid_shape, 12
    assert (tedt.closest_plan(shape, t)["c" if layout == "c0" else "a"]
            == 0)
    occ = _random_occ(shape, 0.01, 4)
    if layout not in _JAX_CLOSEST:
        jm = _jmesh()
        local = jsh._local_edt_closest(shape, 8, t)
        lx = shape[0] // 8
        _JAX_CLOSEST[layout] = jax.jit(jax.shard_map(
            lambda o: local(o, jax.lax.axis_index("x").astype(jnp.int32)
                            * lx),
            mesh=jm, in_specs=P("x", None, None),
            out_specs=(P("x", None, None), P(None, "x", None, None)),
            check_vma=False))(_jput(occ, jm, P("x", None, None)))
    jd2, jcl = _JAX_CLOSEST[layout]
    tlocal = sharding._local_edt_closest(shape, _mesh(n), t)
    d2s, cls = tlocal(_split(occ, n), _mesh(n).x0s(shape[0] // n))
    _same(_cat(d2s), jd2, "d2")
    _same(_cat(cls, 1), jcl, "closest")
    sd2, scl = tedt.truncated_edt_d2_closest(torch.from_numpy(occ), t)
    _same(_cat(d2s), sd2)
    _same(_cat(cls, 1), scl)
    assert (np.asarray(jcl) >= 0).any()


# ---------------------------------------------------------------------------
# The tick
# ---------------------------------------------------------------------------


def _tick_scene(seed=7, k=2, p=300):
    """tests/test_sharding.py:432-442."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-1.0, 1.0, (k, 3)).astype(np.float32)
    origins[:, 2] *= 0.3
    pts = (origins[:, None, :]
           + rng.uniform(-2.0, 2.0, (k, p, 3))).astype(np.float32)
    tfs = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    tfs[:, :3, 3] = origins
    return (pts - origins[:, None, :], rng.uniform(size=(k, p)) < 0.9, tfs,
            origins[-1])


_JAX_TICKS = {}


def _jax_tick(cfg, n_ticks=2):
    """The JAX sharded tick's final state (numpy) and stats, and its
    sharded lazy closest where the config derives one; cached."""
    key = (dataclasses.astuple(cfg), n_ticks)
    if key not in _JAX_TICKS:
        from fiesta_tpu.grid import make_state

        jm = _jmesh()
        step = jsh.sharded_fused_tick(cfg, jm)
        state = jsh.shard_state(make_state(cfg), jm)
        args = [jnp.asarray(a) for a in _tick_scene()]
        for _ in range(n_ticks):
            state, stats = step(state, *args)
        lazy = None
        if cfg.lazy_closest and jsh.sharded_closest_supported(cfg):
            lazy = np.asarray(jsh.sharded_derive_closest(cfg, jm)(
                state.logodds))
            _same(lazy, jderive(cfg, jax.device_get(state.logodds)))
        _JAX_TICKS[key] = (
            {f: np.asarray(getattr(state, f)) for f in tgrid.FIELDS},
            [int(s) for s in stats], lazy)
    return _JAX_TICKS[key]


def _port_tick(cfg, mesh, n_ticks=2):
    tcfg = _port(cfg)
    step = sharding.sharded_fused_tick(tcfg, mesh)
    state = sharding.shard_state(ft.make_state(tcfg, "cpu"), mesh)
    args = [torch.from_numpy(np.asarray(a)) for a in _tick_scene()]
    for _ in range(n_ticks):
        state, stats = step(state, *args)
    return state, stats


def _compare_tick(cfg, n):
    want, want_stats, want_lazy = _jax_tick(cfg)
    mesh = _mesh(n)
    state, stats = _port_tick(cfg, mesh)
    got = sharding.gather_state(state, mesh)
    for f in tgrid.FIELDS:
        _same(getattr(got, f), want[f], f)
    assert [int(s) for s in stats] == want_stats
    assert want_stats[1] > 0                     # a non-degenerate scene
    if want_lazy is not None:
        tcfg = _port(cfg)
        cl = sharding.sharded_derive_closest(tcfg, mesh)(state.logodds)
        got_cl = sharding._gather_axis(mesh, cl, 0 if cl[0].dim() == 3
                                       else 1)
        _same(got_cl, want_lazy, "lazy closest")
        assert (want_lazy >= 0).any()
    return got


@pytest.mark.parametrize("n", NS)
def test_sharded_fused_tick_matches_single_device(n):
    """Two production ticks (carve, drain, EDT; t = 12 over slabs of 8 at
    n = 8) bit-equal to JAX's sharded tick and the port's single-device
    tick."""
    got = _compare_tick(TICK_CFG, n)
    tcfg = _port(TICK_CFG)
    ref = ft.make_state(tcfg, "cpu")
    args = [torch.from_numpy(np.asarray(a)) for a in _tick_scene()]
    for _ in range(2):
        ref, _ = ft.fused_batch_step(tcfg, ref, *args)
    for f in tgrid.FIELDS:
        _same(getattr(got, f), getattr(ref, f), f)


@pytest.mark.parametrize("n", NS)
def test_sharded_closest_matches_single_device(n):
    """Lazy closest (the default): the sharded derive bit-equal."""
    assert TICK_CFG.lazy_closest
    _compare_tick(TICK_CFG, n)


@pytest.mark.parametrize("n", NS)
def test_sharded_eager_closest_matches_single_device(n):
    _compare_tick(dataclasses.replace(TICK_CFG, closest_mode="eager"), n)


@pytest.mark.parametrize("n", NS)
def test_sharded_window_tick_matches_single_device(n):
    """Local-window mode: the drain's window shifted into each slab."""
    cfg = dataclasses.replace(TICK_CFG, global_update=False,
                              radius=(1.0, 1.0, 0.6))
    got = _compare_tick(cfg, n)
    assert not np.asarray(got.seen).all()


@pytest.mark.parametrize("n", NS)
def test_sharded_hierarchical_tick_matches_single_device(n):
    _compare_tick(dataclasses.replace(TICK_CFG, trunc_dist=1.6,
                                      edt_fine_dist=0.8), n)


@pytest.mark.parametrize("n", NS)
def test_sharded_window_hierarchical_combined(n):
    _compare_tick(dataclasses.replace(
        TICK_CFG, global_update=False, radius=(1.0, 1.0, 0.6),
        trunc_dist=1.6, edt_fine_dist=0.8), n)


def test_box_add_straddling_slabs_and_drain_x_offset():
    """The box add with corners shifted by -x0 (boxes that straddle a
    slab's faces or miss it) against JAX's ``apply_box_local``
    clip-and-pad, and the drain with ``x_offset`` against JAX's drain
    given the same slab and ``x_offset`` (``fuse.py:181-182``) and against
    the global window's drain cut to the slab."""
    rng = np.random.default_rng(3)
    gx, gy, gz, lx = 32, 12, 10, 8
    box = (6, 5, 4)
    k = 5
    starts = np.stack([rng.integers(-2, gx - box[0] + 3, k),
                       rng.integers(0, gy - box[1] + 1, k),
                       rng.integers(0, gz - box[2] + 1, k)], 1).astype(
        np.int32)
    starts[0, 0], starts[1, 0] = 5, 7          # across the 8-plane face
    hit = rng.integers(0, 2, (k,) + box).astype(np.uint8)
    miss = rng.integers(0, 3, (k,) + box).astype(np.uint8)
    base = rng.integers(250, 256, (gx, gy, gz)).astype(np.uint8)

    def jax_apply(cnt, boxc, start, x0):
        # sharding.py:785-798
        ls = jnp.clip(start[0] - x0, -box[0], lx)
        padded = jnp.pad(cnt, ((box[0], box[0]), (0, 0), (0, 0)))
        at = (ls + box[0], start[1], start[2])
        reg = jax.lax.dynamic_slice(padded, at, box)
        padded = jax.lax.dynamic_update_slice(
            padded, jraycast._sat_add_u8(reg, boxc), at)
        return padded[box[0]:box[0] + lx]

    for x0 in range(0, gx, lx):
        want_h = jnp.asarray(base[x0:x0 + lx])
        want_m = jnp.asarray(base[x0:x0 + lx])
        for i in range(k):
            want_h = jax_apply(want_h, jnp.asarray(hit[i]),
                               jnp.asarray(starts[i]), x0)
            want_m = jax_apply(want_m, jnp.asarray(miss[i]),
                               jnp.asarray(starts[i]), x0)
        h = torch.from_numpy(base[x0:x0 + lx].copy())
        m = torch.from_numpy(base[x0:x0 + lx].copy())
        shifted = torch.from_numpy(starts - np.int32([x0, 0, 0]))
        traycast.apply_box_counts(h, m, shifted, torch.from_numpy(hit),
                                  torch.from_numpy(miss))
        _same(h, want_h, f"hit x0={x0}")
        _same(m, want_m, f"miss x0={x0}")

    lo = rng.normal(size=(gx, gy, gz)).astype(np.float32)
    seen = (rng.random((gx, gy, gz)) < 0.5).astype(np.uint8)
    hc = rng.integers(0, 3, (gx, gy, gz)).astype(np.uint8)
    mc = rng.integers(0, 4, (gx, gy, gz)).astype(np.uint8)
    win = (torch.tensor([9, 2, 1], dtype=torch.int32),
           torch.tensor([20, 9, 7], dtype=torch.int32))
    kw = dict(l_hit=0.85, l_miss=-0.4, clamp_min=-2.0, clamp_max=3.5,
              occ_thresh=1.39, occ_is_eq=False)
    full = tfusion.fuse_drain(*(torch.from_numpy(a) for a in (lo, seen, hc,
                                                              mc)),
                              window=win, **kw)
    counts = torch.zeros(3, dtype=torch.int32)
    for x0 in range(0, gx, lx):
        slab = [a[x0:x0 + lx].copy() for a in (lo, seen, hc, mc)]
        part = tfusion.fuse_drain(*(torch.from_numpy(a) for a in slab),
                                  window=win, x_offset=x0, **kw)
        want = jfuse.fuse_counts_pallas(
            *(jnp.asarray(a) for a in slab),
            window=tuple(jnp.asarray(w.numpy()) for w in win),
            x_offset=x0, interpret=True, **kw)
        for i, (a, b) in enumerate(zip(part, want)):
            _same(a, b, f"drain output {i} x0={x0}")
        for a, b in zip(part[:5], full[:5]):
            _same(a, b[x0:x0 + lx])
        counts += torch.stack(part[5:])
    assert counts.tolist() == [int(c) for c in full[5:]]
    assert 0 < int(full[5]) < int((mc > 0).sum())


# ---------------------------------------------------------------------------
# The incremental engine
# ---------------------------------------------------------------------------


def _jax_update(cfg, n, occ, ins, d2=None, c=None):
    jm = _jmesh(n)
    step = jsh.sharded_esdf_update(cfg, jm)
    shape = cfg.grid_shape
    s3, s4 = P("x", None, None), P(None, "x", None, None)
    d2 = np.full(shape, jgrid.INF_D2, np.int32) if d2 is None else d2
    c = np.full((3,) + shape, -1, np.int16) if c is None else c
    out = step(_jput(d2, jm, s3), _jput(c, jm, s4), _jput(occ, jm, s3),
               _jput(ins, jm, s3))
    return tuple(np.asarray(x) for x in out)


def _port_update(cfg, n, occ, ins, d2=None, c=None):
    shape = cfg.grid_shape
    d2 = np.full(shape, jgrid.INF_D2, np.int32) if d2 is None else d2
    c = np.full((3,) + shape, -1, np.int16) if c is None else c
    step = sharding.sharded_esdf_update(_port(cfg), _mesh(n))
    d2s, cls, iters = step(_split(d2, n), _split(c, n, 1), _split(occ, n),
                           _split(ins, n))
    return _cat(d2s), _cat(cls, 1), int(iters)


@pytest.mark.parametrize("n_dev", NS)
def test_sharded_update_matches_single_device(n_dev):
    """``sharded_esdf_update`` from an empty map: d2, closest and the
    sweep count bit-equal to JAX's sharded update and the port's
    single-device ``update_esdf``."""
    cfg = CFG
    occ = _random_occ(cfg.grid_shape, 0.02, 5)
    jd2, jc, jit = _jax_update(cfg, n_dev, occ, occ)
    d2, c, iters = _port_update(cfg, n_dev, occ, occ)
    _same(d2, jd2)
    _same(c, jc)
    assert iters == int(jit) >= 1
    sd2, sc, sit = tesdf.update_esdf(
        torch.full(cfg.grid_shape, jgrid.INF_D2, dtype=torch.int32),
        torch.full((3,) + cfg.grid_shape, -1, dtype=torch.int16),
        torch.from_numpy(occ), torch.from_numpy(occ), None, None,
        cfg.stencil)
    _same(d2, sd2)
    _same(c, sc)
    assert iters == int(sit)


def test_sharded_incremental_delete():
    """Deleting an obstacle re-propagates across slab faces."""
    shape = CFG.grid_shape
    occ_a = np.zeros(shape, bool)
    occ_a[4, 6, 3] = True
    occ_b = np.zeros(shape, bool)
    occ_b[28, 12, 7] = True
    both = occ_a | occ_b
    jd2, jc, _ = _jax_update(CFG, 8, both, both)
    jd2, jc, jit = _jax_update(CFG, 8, occ_b, np.zeros(shape, bool), jd2,
                               jc)
    for n in NS:
        d2, c, _ = _port_update(CFG, n, both, both)
        d2, c, iters = _port_update(CFG, n, occ_b, np.zeros(shape, bool),
                                    d2, c)
        _same(d2, jd2)
        _same(c, jc)
        assert iters == int(jit)


def test_sharded_update_reach3_stencil_matches_single_device():
    """connectivity=62 reaches +-3 voxels: halos of 3 planes."""
    cfg = dataclasses.replace(CFG, connectivity=62)
    assert sharding._stencil_reach(cfg.stencil) == 3
    occ = _random_occ(cfg.grid_shape, 0.03, 9)
    jd2, jc, jit = _jax_update(cfg, 8, occ, occ)
    for n in NS:
        d2, c, iters = _port_update(cfg, n, occ, occ)
        _same(d2, jd2)
        _same(c, jc)
        assert iters == int(jit)


@pytest.mark.parametrize("connectivity", [24, 62])
def test_relax_once_x_offset_matches_relax_once_local(connectivity):
    """One sweep on halo-extended slabs, ``relax_once(x_offset=x0 -
    pad)`` with the update mask on the slab's own planes, against JAX's
    ``_relax_once_local`` (its halo exchange inside ``shard_map``)."""
    cfg = dataclasses.replace(CFG, connectivity=connectivity)
    dirs, pad = cfg.stencil, jsh._stencil_reach(cfg.stencil)
    shape = cfg.grid_shape
    occ = _random_occ(shape, 0.03, 2)
    rng = np.random.default_rng(8)
    # a mid-relaxation state: some voxels hold (stale) global closest
    c = np.where(rng.random(shape) < 0.1, 1, -1)[None] * np.stack(
        np.meshgrid(*(np.arange(g) for g in shape), indexing="ij"))
    c = np.where(occ[None], np.stack(np.meshgrid(
        *(np.arange(g) for g in shape), indexing="ij")), c)
    c = np.where(c[0:1] < 0, -1, c).astype(np.int16)
    d2 = np.where(occ, 0, jgrid.INF_D2).astype(np.int32)
    jm, lx = _jmesh(), shape[0] // 8

    def local(d, cl):
        x0 = jax.lax.axis_index("x").astype(jnp.int32) * lx
        return jsh._relax_once_local(d, cl, x0, dirs, None, None, "x",
                                     pad)[:2]

    jd2, jc = jax.jit(jax.shard_map(
        local, mesh=jm, in_specs=(P("x", None, None),
                                  P(None, "x", None, None)),
        out_specs=(P("x", None, None), P(None, "x", None, None)),
        check_vma=False))(_jput(d2, jm, P("x", None, None)),
                          _jput(c, jm, P(None, "x", None, None)))
    mesh = _mesh(8)
    ext_c = sharding._halo_exchange_x(mesh, _split(c, 8, 1), pad)
    got_d2, got_c = [], []
    for j, (d, e) in enumerate(zip(_split(d2, 8), ext_c)):
        ext_d2 = torch.cat([torch.full((pad,) + shape[1:], jgrid.INF_D2,
                                       dtype=torch.int32), d,
                            torch.full((pad,) + shape[1:], jgrid.INF_D2,
                                       dtype=torch.int32)])
        own = torch.zeros(ext_d2.shape, dtype=torch.bool)
        own[pad:pad + lx] = True
        od, oc, _ = tesdf.relax_once(ext_d2, e, own, None, dirs,
                                     x_offset=j * lx - pad)
        _same(od[:pad], ext_d2[:pad], "halo d2 untouched")
        got_d2.append(od[pad:pad + lx])
        got_c.append(oc[:, pad:pad + lx])
    _same(_cat(got_d2), jd2)
    _same(_cat(got_c, 1), jc)
    assert (np.asarray(jd2) < jgrid.INF_D2).sum() > occ.sum()


# ---------------------------------------------------------------------------
# Scrolling on sharded state
# ---------------------------------------------------------------------------


def test_sharded_scroll_matches_single_device():
    """scroll_state of a state gathered from 8 slabs equals JAX's scroll
    of its X-sharded state (tests/test_sharding.py:215-251)."""
    shape = CFG.grid_shape
    rng = np.random.default_rng(3)
    arrays = dict(
        logodds=rng.normal(size=shape).astype(np.float32),
        d2=rng.integers(0, 50, size=shape).astype(np.int32),
        closest=rng.integers(0, 10, size=(3,) + shape).astype(np.int16),
        seen=rng.random(shape) < 0.5,
        hit_cnt=rng.integers(0, 3, size=shape).astype(np.uint8),
        miss_cnt=rng.integers(0, 3, size=shape).astype(np.uint8))
    jm = _jmesh()
    jstate = jsh.shard_state(jgrid.MapState(
        **{f: jnp.asarray(a) for f, a in arrays.items()}), jm)
    want = jscroll(jstate, jnp.asarray([5, -3, 2], jnp.int32))
    cfg = _port(dataclasses.replace(CFG, esdf_mode="incremental"))
    state = tgrid.state_from_arrays(cfg, dict(
        arrays, seen=arrays["seen"].astype(np.uint8)), device="cpu")
    mesh = _mesh(8)
    got = tscroll(sharding.gather_state(sharding.shard_state(state, mesh),
                                        mesh), np.asarray([5, -3, 2]))
    for f in tgrid.FIELDS:
        _same(getattr(got, f), getattr(want, f), f)


# ---------------------------------------------------------------------------
# The distributed transport
# ---------------------------------------------------------------------------

_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    sys.path.insert(0, {root!r})
    import fiesta_tpu_torch as ft
    from fiesta_tpu_torch.parallel import sharding
    torch.set_num_threads(1)
    rank = int(sys.argv[1])
    mesh = sharding.distributed_mesh(init_method="file://" + {store!r},
                                     world_size=2, rank=rank, device="cpu")
    assert mesh.size == 2 and mesh.local == (rank,) and mesh.distributed
    cfg = ft.FiestaConfig(**{cfg!r})
    scene = np.load({scene!r})
    step = sharding.sharded_fused_tick(cfg, mesh)
    state = sharding.shard_state(ft.make_state(cfg, "cpu"), mesh)
    state, stats = step(state, *(torch.from_numpy(scene[k])
                                 for k in ("pts", "val", "tfs", "cur")))
    full = sharding.gather_state(state, mesh)
    if rank == 0:
        np.savez({out!r}, stats=np.asarray([int(s) for s in stats]),
                 **{{f: getattr(full, f).numpy()
                    for f in ft.grid.FIELDS}})
    print("RANK_OK", rank, dict(sharding.COLLECTIVES))
""")


def test_distributed_mesh_two_gloo_processes(tmp_path):
    """``distributed_mesh`` in two gloo processes (a file store in
    ``tmp_path``): one tick bit-equal to the in-process 2-shard mesh's,
    its halos, gathers and sums through ``torch.distributed``."""
    import pathlib

    root = str(pathlib.Path(__file__).resolve().parents[1])
    out, scene = str(tmp_path / "rank0.npz"), str(tmp_path / "scene.npz")
    np.savez(scene, **dict(zip(("pts", "val", "tfs", "cur"), _tick_scene())))
    code = _RANK.format(root=root, store=str(tmp_path / "store"), out=out,
                        scene=scene, cfg=dataclasses.asdict(TICK_CFG))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=root) for r in range(2)]
    try:
        res = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, res):
        assert p.returncode == 0, se[-3000:]
        assert "RANK_OK" in so and "'gloo'" in so, so
    mesh = _mesh(2)
    state, stats = _port_tick(TICK_CFG, mesh, n_ticks=1)
    want = sharding.gather_state(state, mesh)
    got = np.load(out)
    for f in tgrid.FIELDS:
        _same(got[f], getattr(want, f), f)
    assert got["stats"].tolist() == [int(s) for s in stats]
