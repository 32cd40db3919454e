"""fiesta_tpu_torch's wide closest transform and closest decode against
fiesta_tpu (CPU).

Where the packed word misses int32 (``closest_plan`` is None and
``closest_plan_wide`` is not), the port runs the JAX package's two-word
passes as three passes over one 64-bit word ``val << shift | payload``
and decodes the last word as the packed transform does.  Here, on such
shapes (the x-lead layout the wide plan takes, a widest-C plan built by
hand, columns longer than 254 rows at t = 2000):

  * the plain decode of the 64-bit words equals ``fiesta_tpu``'s
    ``truncated_edt_d2_closest_wide`` (run op by op: jitted, it cannot
    branch on ``packed_out``, ROADMAP C; its passes are computed once a
    layout and decoded in both formats) and ``_reconstruct_closest`` in
    both output formats, half-even rounding included;
  * a small wide config's ``pipeline.derive_closest`` equals JAX's.

``test_torch_closest_wide_words.py`` holds each pass's 64-bit word to
``fiesta_tpu``'s pair passes and the CUDA kernels' algorithms on it, on
these shapes.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# One intra-op thread: with six pytest-xdist workers on eight Xeon cores,
# each worker's OpenMP pool spins while small ops wait, and the plain wide
# transform at long_c took 543 s instead of 0.7 (six processes at once).
# Every worker imports this module when it collects, so the setting holds
# for the run.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu import FiestaConfig  # noqa: E402
from fiesta_tpu import pipeline as jpipe  # noqa: E402
from fiesta_tpu.io import replay as jreplay  # noqa: E402
from fiesta_tpu.ops.pallas import edt as jedt  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import pipeline as tpipe  # noqa: E402
from fiesta_tpu_torch.io import replay as treplay  # noqa: E402
from fiesta_tpu_torch.ops import edt as tedt  # noqa: E402

T = 2000
# (shape, t): the wide plan's own x-lead layout (a = x, b = z, c = y), a
# c column of 400 rows and an a column of 256 rows (t_local 399 and 255:
# the binary pass's doubling reach passes 255 only for the first), and an
# a column of 400 rows
SHAPES = {"x_lead": ((40, 40, 8), T), "long_c": ((40, 400, 8), T),
          "long_a_256": ((256, 40, 8), T), "long_a_400": ((400, 40, 8), T)}


def _plan(layout):
    """The wide plan of ``layout``; ``widest_c`` is the x_lead shape with
    the widest-C axes (a = y, b = z, c = x), built by hand: the wide plan
    takes x-lead wherever its payload fits 31 bits."""
    if layout == "widest_c":
        shape, t = SHAPES["x_lead"]
        return shape, dict(a=1, b=2, c=0, ba=6, bb=3, s=9, cap=t * t + 1,
                           t=t)
    shape, t = SHAPES[layout]
    assert tedt.closest_plan(shape, t) is None
    plan = tedt.closest_plan_wide(shape, t)
    assert plan is not None and (plan["a"], plan["b"], plan["c"]) == (0, 2, 1)
    return shape, plan



def _occ(shape, plan, seed):
    """Sparse random occupancy, plus lone seeds at t_local and t_local + 1
    from a column's ends along each axis of the plan."""
    rng = np.random.default_rng(seed)
    occ = rng.random(shape) < 0.004
    for axis in (plan["a"], plan["b"], plan["c"]):
        a = shape[axis]
        tl = min(plan["t"], a - 1)
        x = np.moveaxis(occ, axis, 0)
        for j, r in enumerate(sorted({0, tl // 2, tl, tl + 1, a - 1 - tl,
                                      a - 2 - tl, a - 1})):
            if 0 <= r < a:
                x[r, j % x.shape[1], (3 * j) % x.shape[2]] = True
    return occ


def _check(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), r)


#: layout -> (occupancy, plan, fiesta_tpu's (val, sign, b*, a*) in [X,Y,Z])
_FIELDS = {}


def _jax_fields(layout):
    """``fiesta_tpu``'s wide transform up to its decode (the pair passes,
    transposes and unpack of ``truncated_edt_d2_closest_wide``), op by op,
    once per layout: both output formats decode the same fields."""
    if layout not in _FIELDS:
        shape, plan = _plan(layout)
        occ = _occ(shape, plan, 11)
        a, b, c, ba = plan["a"], plan["b"], plan["c"], plan["ba"]
        with jax.disable_jit():
            occ_t = jnp.asarray(occ).transpose(a, b, c).astype(jnp.uint8)
            hi, lo = jedt._binary_pair_xla(occ_t, plan)
            hi, lo = jedt._window_pair_xla(hi.transpose(1, 0, 2),
                                           lo.transpose(1, 0, 2), plan)
            val, sign, pay = jedt._split_pair_xla(
                hi.transpose(2, 1, 0), lo.transpose(2, 1, 0), plan)
            inv = tuple(int(i) for i in np.argsort((c, a, b)))
            val, sign, pay = (x.transpose(inv) for x in (val, sign, pay))
            _FIELDS[layout] = (occ, plan,
                               (val, sign, pay >> ba, pay & ((1 << ba) - 1)))
    return _FIELDS[layout]


@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize("layout", ["x_lead", "long_c"])
def test_wide_transform_matches_jax(layout, packed_out):
    """The wide transform (the word passes, then the decode of the i64
    words) equals ``fiesta_tpu``'s, op by op, and its d2 the d2-only
    transform's.  The reference is ``_reconstruct_closest`` on the cached
    fields; at x_lead the whole ``truncated_edt_d2_closest_wide`` equals
    that composition too."""
    occ, plan, fields = _jax_fields(layout)
    with jax.disable_jit():
        ref = jedt._reconstruct_closest(occ.shape, plan, *fields,
                                        packed_out=packed_out)
        if layout == "x_lead":
            whole = jedt.truncated_edt_d2_closest_wide(
                jnp.asarray(occ), T, packed_out=packed_out)
            for w, r in zip(whole, ref):
                w, r = np.asarray(w), np.asarray(r)
                assert w.dtype == r.dtype
                np.testing.assert_array_equal(w, r)
    o = torch.from_numpy(occ)
    got = tedt.truncated_edt_d2_closest_wide(o, T, packed_out)
    _check(got, ref)
    assert torch.equal(got[0], tedt.truncated_edt_d2(o, T))
    # the decode of the split's i64 words, through the dispatcher
    p3 = tedt.split_wide(tedt.window_wide(tedt.binary_wide(
        o, plan, plan["a"]), plan, plan["b"]), plan, plan["c"])
    _check(tedt.decode_split(p3, plan, packed_out), ref)


def _words(shape, plan, seed, dc2_extra=None):
    """Synthetic split words [X,Y,Z] (i64) with JAX's decode inputs: each
    voxel's witness a few voxels away (val = da^2 + db^2 + dc^2, undefined
    beyond t^2, sign 1 for a witness at higher c), or, with ``dc2_extra``
    (a list of values), dc2 itself drawn from it with da = db = 0."""
    rng = np.random.default_rng(seed)
    a, b, c = plan["a"], plan["b"], plan["c"]
    iota = np.indices(shape)
    astar = np.clip(iota[a] + rng.integers(-3, 4, shape), 0, shape[a] - 1)
    bstar = np.clip(iota[b] + rng.integers(-3, 4, shape), 0, shape[b] - 1)
    if dc2_extra is None:
        dc = rng.integers(-5, 6, shape)
        val = (iota[a] - astar) ** 2 + (iota[b] - bstar) ** 2 + dc ** 2
        val[rng.random(shape) < 0.2] = plan["cap"]
        sign = (dc > 0) | ((dc == 0) & (rng.random(shape) < 0.5))
    else:
        astar, bstar = iota[a], iota[b]
        val = np.asarray(dc2_extra)[rng.integers(0, len(dc2_extra), shape)]
        sign = rng.random(shape) < 0.5
    s, ba = plan["s"], plan["ba"]
    words = (val.astype(np.int64) << (s + 1)) \
        | (sign.astype(np.int64) << s) | (bstar.astype(np.int64) << ba) \
        | astar
    parts = [jnp.asarray(x.astype(np.int32)) for x in
             (val, sign, bstar, astar)]
    return torch.from_numpy(words), parts


@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize("layout", ["x_lead", "widest_c"])
def test_decode_from_wide_words_matches_jax(layout, packed_out):
    """The plain decode of i64 words in both layouts, both formats, equals
    ``fiesta_tpu``'s ``_reconstruct_closest`` on the unpacked fields; the
    i32 unpack gives the same fields."""
    shape, plan = _plan(layout)
    words, parts = _words(shape, plan, 5 + packed_out)
    with jax.disable_jit():
        ref = jedt._reconstruct_closest(shape, plan, *parts,
                                        packed_out=packed_out)
    _check(tedt.decode_split(words, plan, packed_out), ref)
    for got, want in zip(tedt.unpack_split(words, plan), parts):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [2048, 2049, 3000])
def test_decode_rounds_half_to_even(k):
    """dc2 = k^2 + k (k >= 2048): the f32 root is exactly k + 0.5, which
    the decode rounds half to even, as ``jnp.round`` does (``roundf``
    would give k + 1 for even k)."""
    shape = (8, 8, 8)
    plan = tedt.closest_plan_wide(shape, 3100)
    dc2 = k * k + k
    root = np.sqrt(np.float32(dc2), dtype=np.float32)
    assert root == np.float32(k + 0.5)
    words, parts = _words(shape, plan, k, dc2_extra=[dc2, 4, 0])
    with jax.disable_jit():
        ref = jedt._reconstruct_closest(shape, plan, *parts)
    got = tedt.decode_split(words, plan)
    _check(got, ref)
    ic = np.indices(shape)[plan["c"]]
    dc = np.abs(got[1][plan["c"]].numpy().astype(np.int64) - ic)
    assert set(np.unique(dc[parts[0] == dc2])) == {k + (k % 2)}


H, W = 24, 32


def _wide_config():
    """A small config whose grid (48x48x32) and truncation (t = 2000) only
    the wide plan fits, and its scans."""
    cfg = jreplay.scale_intrinsics(FiestaConfig(
        resolution=0.1, origin=(-2.4, -2.4, -1.0), map_size=(4.8, 4.8, 3.2),
        min_ray_length=0.3, max_ray_length=1.5, trunc_dist=200.0,
        edt_fine_dist=200.0, max_points_per_scan=H * W), H, W)
    tc = ft.config_from_fields(dataclasses.asdict(cfg)).validate()
    t = tedt.trunc_vox_for(tc.resolution, tc.trunc_dist)
    assert tedt.closest_plan(tc.grid_shape, t) is None
    assert tedt.closest_plan_wide(tc.grid_shape, t) is not None
    _, frames = treplay.make_sequence(tc, n_frames=9, n_boxes=5, seed=4,
                                      height=H, width=W, orbit_radius=0.8)
    return cfg, tc, treplay.stage_update_batches(tc, frames, device="cpu")


def test_derive_closest_wide_config_matches_jax():
    """A wide config's lazy ``derive_closest`` equals ``fiesta_tpu``'s
    (op by op) on the port's mapped occupancy, and its d2 the tick's."""
    cfg, tc, batches = _wide_config()
    assert tpipe.rebuild_tracks_closest(tc) and tc.lazy_closest
    state, _ = tpipe.fused_stream(tc, ft.make_state(tc, device="cpu"),
                                  *batches)
    occupied = ft.occupied_grid(tc, state.logodds)
    assert int(occupied.sum()) > 20
    got = tpipe.derive_closest(tc, state.logodds)
    with jax.disable_jit():
        ref = jpipe.derive_closest(cfg, jnp.asarray(state.logodds.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32 and int((got >= 0).sum()) > 1000
    d2, _ = tpipe.rebuild_esdf(tc, occupied)
    assert torch.equal(d2, state.d2)
