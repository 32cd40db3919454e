"""fiesta_tpu_torch closest-obstacle transform against fiesta_tpu (CPU).

The three packed passes run along the plan's axes of the natural [X,Y,Z]
grid in the port and on the transposed volume in the JAX package; per
column the words must be equal, against the Pallas kernels in interpret
mode (as ``tests/test_kernels_interpret.py`` runs them).  The transform
(packed and wide), eager closest in the tick stream and the lazy
``derive_closest`` must equal the JAX package's bit for bit.
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
from fiesta_tpu_torch import kernels as tkernels  # noqa: E402
from fiesta_tpu_torch import pipeline as tpipe  # noqa: E402
from fiesta_tpu_torch.io import replay as treplay  # noqa: E402
from fiesta_tpu_torch.ops import edt as tedt  # noqa: E402

# (shape, t): the cow layout (a = x, b = z, c = y) at a small size, and a
# shape whose x-lead layout does not fit int32 so the plan is widest-C
LAYOUTS = {"cow_order": ((40, 40, 8), 9), "widest_c": ((64, 16, 8), 1500)}


def _occ(shape, p, seed):
    return np.random.default_rng(seed).random(shape) < p


def test_layouts_are_what_they_claim():
    cow = tedt.closest_plan((400, 400, 80), 100)
    assert (cow["a"], cow["b"], cow["c"], cow["ba"], cow["bb"], cow["s"]) \
        == (0, 2, 1, 9, 7, 16)
    small = tedt.closest_plan(*LAYOUTS["cow_order"])
    assert (small["a"], small["b"], small["c"]) == (0, 2, 1)
    wide_c = tedt.closest_plan(*LAYOUTS["widest_c"])
    assert (wide_c["a"], wide_c["b"], wide_c["c"]) == (1, 2, 0)


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_packed_passes_match_pallas_interpret(layout, square):
    shape, t = LAYOUTS[layout]
    plan = tedt.closest_plan(shape, t)
    assert plan == jedt.closest_plan(shape, t)
    a, b, c = plan["a"], plan["b"], plan["c"]
    occ = _occ(shape, 0.03, 5)
    occ[:, 0, :] = False                  # all-far columns and tiles

    occ_t = jnp.asarray(occ.transpose(a, b, c).astype(np.uint8))
    p1_j = jedt._binary_packed_pallas(occ_t, plan, interpret=True,
                                      square=square)          # [A,B,C]
    p1 = tedt.binary_packed(torch.from_numpy(occ), plan, a, square)
    np.testing.assert_array_equal(p1.permute(a, b, c).numpy(),
                                  np.asarray(p1_j))
    if not square:
        p1_j = jedt.square_packed_l1(p1_j, plan)
        p1 = tedt.square_packed_l1(p1, plan)
        np.testing.assert_array_equal(p1.permute(a, b, c).numpy(),
                                      np.asarray(p1_j))

    p2_j = jedt._window_packed_pallas(p1_j.transpose(1, 0, 2), plan,
                                      interpret=True)         # [B,A,C]
    p2 = tedt.window_packed(p1, plan, b)
    np.testing.assert_array_equal(p2.permute(b, a, c).numpy(),
                                  np.asarray(p2_j))

    p3_j = jedt._split_packed_pallas(p2_j.transpose(2, 1, 0), plan,
                                     interpret=True)          # [C,A,B]
    p3 = tedt.split_packed(p2, plan, c)
    np.testing.assert_array_equal(p3.permute(c, a, b).numpy(),
                                  np.asarray(p3_j))


def _volumes(shape):
    single = np.zeros(shape, bool)
    single[shape[0] // 2, 3, shape[2] - 2] = True
    edge = np.zeros(shape, bool)
    edge[0, 0, 0] = edge[-1, -1, -1] = True
    return {"empty": np.zeros(shape, bool), "single": single, "edge": edge,
            "random": _occ(shape, 0.01, 7)}


def _check_closest(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize("kind", ["empty", "single", "edge", "random"])
def test_truncated_edt_d2_closest_matches_jax(kind, packed_out):
    shape, t = (30, 26, 12), 7
    occ = _volumes(shape)[kind]
    ref = jedt.truncated_edt_d2_closest(jnp.asarray(occ), t,
                                        packed_out=packed_out)
    got = tedt.truncated_edt_d2_closest(torch.from_numpy(occ), t,
                                        packed_out=packed_out)
    _check_closest(got, ref)
    # d2 of the closest transform is the d2-only transform's
    np.testing.assert_array_equal(
        got[0].numpy(), tedt.truncated_edt_d2(torch.from_numpy(occ),
                                              t).numpy())


@pytest.mark.parametrize("packed_out", [False, True])
def test_wide_closest_matches_jax(packed_out):
    """A shape and truncation where only the two-word plan fits.  The JAX
    function runs op by op: jitted, it traces ``packed_out`` and cannot
    branch on it (ROADMAP C)."""
    shape, t = (40, 36, 12), 1500
    assert tedt.closest_plan(shape, t) is None
    assert tedt.closest_plan_wide(shape, t) is not None
    occ = _occ(shape, 0.004, 9)
    with jax.disable_jit():
        ref = jedt.truncated_edt_d2_closest_wide(jnp.asarray(occ), t,
                                                 packed_out=packed_out)
    got = tedt.edt_closest_auto(torch.from_numpy(occ), t,
                                packed_out=packed_out)
    _check_closest(got, ref)
    np.testing.assert_array_equal(
        got[0].numpy(), tedt.truncated_edt_d2(torch.from_numpy(occ),
                                              t).numpy())


def test_wide_equals_packed_where_both_fit():
    shape, t = (30, 26, 12), 7
    occ = torch.from_numpy(_volumes(shape)["random"])
    for packed_out in (False, True):
        for a, b in zip(tedt.truncated_edt_d2_closest(occ, t, packed_out),
                        tedt.truncated_edt_d2_closest_wide(occ, t,
                                                           packed_out)):
            assert torch.equal(a, b)


H, W = 24, 32


def _eager_stream():
    cfg = jreplay.scale_intrinsics(FiestaConfig(
        resolution=0.1, origin=(-2.4, -2.4, -1.0), map_size=(4.8, 4.8, 3.2),
        min_ray_length=0.3, max_ray_length=1.5, trunc_dist=1.2,
        edt_fine_dist=1.2, max_points_per_scan=H * W,
        closest_mode="eager"), H, W)
    tc = ft.config_from_fields(dataclasses.asdict(cfg))
    _, frames = treplay.make_sequence(tc, n_frames=9, n_boxes=5, seed=4,
                                      height=H, width=W, orbit_radius=0.8)
    return cfg, tc, treplay.stage_update_batches(tc, frames, device="cpu")


def test_eager_stream_closest_matches_lazy_and_jax():
    cfg, tc, batches = _eager_stream()
    assert not tc.lazy_closest and tpipe.rebuild_tracks_closest(tc)
    t_state, _ = tpipe.fused_stream(tc, ft.make_state(tc, device="cpu"),
                                    *batches)
    j_state, _ = jpipe.fused_stream(
        cfg, jgrid.make_state(cfg), *(jnp.asarray(a.numpy())
                                      for a in batches))
    got = ft.state_to_arrays(t_state)
    for field in got:
        np.testing.assert_array_equal(got[field],
                                      np.asarray(getattr(j_state, field)),
                                      err_msg=field)
    assert got["closest"].dtype == np.int32
    assert (got["closest"] >= 0).sum() > 100
    lazy = tpipe.derive_closest(tc, t_state.logodds)
    assert torch.equal(lazy, t_state.closest)
    np.testing.assert_array_equal(
        lazy.numpy(), np.asarray(jpipe.derive_closest(
            cfg, jnp.asarray(got["logodds"]))))


# ---------------------------------------------------------------------------
# The CUDA split kernel's bounded windows (kernels/closest.cu), emulated
# ---------------------------------------------------------------------------

# the card tests' layouts (tests/test_torch_cuda.py), t < A and t >= A
SPLIT_LAYOUTS = {"x_lead": ((40, 33, 8), 9),
                 "x_lead_long_t": ((37, 29, 20), 23),
                 "widest_c": ((64, 16, 8), 1500),
                 "x_lead_t_ge_a": ((40, 33, 8), 40)}
# closest.cu's split block at these column lengths: 512 threads, 32
# columns, so 16 segments a column
SPLIT_SEGS = 16


def _split_words(kind, shape, plan, seed):
    """Split-pass input words ``v << s | payload`` (v <= cap) along the
    plan's c axis, for each edge of the kernel's bounds."""
    s, cap, c_ax = plan["s"], plan["cap"], plan["c"]
    rng = np.random.default_rng(seed)
    lead = (shape[c_ax],) + tuple(n for i, n in enumerate(shape) if i != c_ax)
    a = lead[0]
    tl = min(plan["t"], a - 1)
    pay = rng.integers(0, 1 << s, lead)
    if kind == "random":
        v = rng.integers(0, cap + 1, lead)
        v[rng.uniform(size=lead) < 0.6] = cap
    elif kind == "ties":
        # candidates v + k^2 tie often (0 + 4 = 3 + 1, 0 + 9 = 8 + 1, ...):
        # equal values on both sides, and equal values with small payloads
        v = rng.choice([0, 1, 3, 4, 8, 9, cap, cap], lead)
        pay = rng.integers(0, 3, lead)
    elif kind == "cap":
        v = rng.choice([cap - 1, cap, cap, cap], lead)
    elif kind == "all_far":
        v = np.full(lead, cap)
        v[:, 0, 0] = rng.integers(0, cap, a)        # one column with values
    else:                   # "lone": one near value per column, at t_local
        v = np.full(lead, cap)      # and t_local + 1 from either column end
        rows = [0, tl, tl + 1, a - 1 - tl, a - 2 - tl, a - 1]
        flat = v.reshape(a, -1)
        for j in range(flat.shape[1]):
            r = rows[j % len(rows)]
            if 0 <= r < a and j % 7:                 # every 7th: all far
                flat[r, j] = j % 3
    words = (np.asarray(v, np.int64) << s) | pay
    return np.ascontiguousarray(np.moveaxis(words.astype(np.int32), 0, c_ax))


def _split_word(acc_n, acc_p, s, cap):
    """The split kernel's output word from its two accumulators."""
    vn, vp = acc_n >> s, acc_p >> s
    use_p = int(vp < vn)
    return (min(vn, vp, cap) << (s + 1)) | (use_p << s) \
        | ((acc_p if use_p else acc_n) & ((1 << s) - 1))


def _window_word(acc_n, acc, s, cap):
    """The window kernel's output word from its one accumulator."""
    return (min(acc >> s, cap) << s) | (acc & ((1 << s) - 1))


def _bounded_kernel_column(w, tl, s, cap, word, shared, segs=SPLIT_SEGS,
                           unroll=4):
    """closest.cu's bounded-pass body on one tile column of loaded words,
    thread by thread: the segments' first and last rows below cap, the
    barrier, the carries, k0p (u8: capped at 254, 255 for none) on a
    downward walk, then the upward walk carrying k0n, each side's loop
    ``unroll`` offsets a turn (an offset past the side's reach re-reads
    its last one), side p starting from side n's accumulator when
    ``shared`` (the window pass), and ``word(acc_n, acc_p, s, cap)``.
    Returns the output words; asserts that no int32 sum overflows."""
    a = len(w)
    w = [int(x) for x in w]
    near = [(x >> s) < cap for x in w]
    seg_len = -(-a // segs)
    bounds = [(min(a, j * seg_len), min(a, min(a, j * seg_len) + seg_len))
              for j in range(segs)]
    first = [next((i for i in range(r0, r1) if near[i]), -1)
             for r0, r1 in bounds]
    last = [next((i for i in range(r1 - 1, r0 - 1, -1) if near[i]), -1)
            for r0, r1 in bounds]
    any_near = any(near)
    out = [0] * a

    def side(acc, i, k, kmax, step):
        while k <= kmax and ((k * k) << s) < acc:
            for u in range(unroll):
                kq = min(k + u, kmax)
                cand = w[i + step * kq] + ((kq * kq) << s)
                assert cand < 2 ** 31
                acc = min(acc, cand)
            k += unroll
        return acc

    for j, (r0, r1) in enumerate(bounds):
        lp, k0p = -1, {}
        if any_near:
            nn = a
            for q in range(j):
                if last[q] >= 0:
                    lp = last[q]
            for q in range(segs - 1, j, -1):
                if first[q] >= 0:
                    nn = first[q]
            for i in range(r1 - 1, r0 - 1, -1):
                k0p[i] = 255 if nn == a else min(nn - i, 254)
                if near[i]:
                    nn = i
        for i in range(r0, r1):
            acc_n = acc_p = w[i]
            if any_near:
                if lp >= 0:
                    acc_n = side(acc_n, i, i - lp, min(tl, i), -1)
                if shared:
                    acc_p = acc_n
                if k0p[i] != 255:
                    acc_p = side(acc_p, i, k0p[i], min(tl, a - 1 - i), 1)
                if near[i]:
                    lp = i
            out[i] = word(acc_n, acc_p, s, cap)
            assert 0 <= out[i] < 2 ** 31
    return out


def _bounded_kernel(x, axis, tl, s, cap, word, shared):
    """The kernel emulation over every column along ``axis``."""
    x = np.moveaxis(x, axis, 0)
    flat = x.reshape(x.shape[0], -1)
    got = np.stack([_bounded_kernel_column(flat[:, j], tl, s, cap, word,
                                           shared)
                    for j in range(flat.shape[1])], 1)
    return np.moveaxis(got.reshape(x.shape).astype(np.int32), 0, axis)


def _split_kernel(p2, plan):
    """The split kernel's emulation along the plan's c axis."""
    a = p2.shape[plan["c"]]
    return _bounded_kernel(p2, plan["c"], min(plan["t"], a - 1), plan["s"],
                           plan["cap"], _split_word, shared=False)


@pytest.mark.parametrize("kind", ["random", "ties", "cap", "all_far",
                                  "lone"])
@pytest.mark.parametrize("layout", sorted(SPLIT_LAYOUTS))
def test_split_window_matches_plain_and_pallas(layout, kind):
    """The split kernel's bounds, as ``split_window_taps`` models them and
    as the kernel's threads run them, give the plain pass and the Pallas
    kernel's words: side and payload ties, values at cap and cap - 1,
    all-far columns, lone values at t_local and t_local + 1 from a column
    end, columns of many segments; t < A and t >= A."""
    shape, t = SPLIT_LAYOUTS[layout]
    plan = tedt.closest_plan(shape, t)
    c_ax = plan["c"]
    p2 = _split_words(kind, shape, plan, len(layout) + len(kind))
    x = torch.from_numpy(p2)
    out, taps_n, taps_p = tedt.split_window_taps(x, plan, c_ax)
    plain = tedt._split_packed_plain(x, plan, c_ax).numpy()
    np.testing.assert_array_equal(out.numpy(), plain)
    rest = tuple(i for i in range(3) if i != c_ax)
    ref = np.asarray(jedt._split_packed_pallas(
        jnp.asarray(p2.transpose((c_ax,) + rest)), plan, interpret=True))
    np.testing.assert_array_equal(
        plain, ref.transpose(tuple(int(i) for i in np.argsort(
            (c_ax,) + rest))))
    np.testing.assert_array_equal(_split_kernel(p2, plan), plain)
    tl = min(t, shape[c_ax] - 1)
    assert int(taps_n.max()) <= tl and int(taps_p.max()) <= tl
    far_cols = ((p2 >> plan["s"]) >= plan["cap"]).all(axis=c_ax)
    for taps in (taps_n, taps_p):
        assert not np.moveaxis(taps.numpy(), c_ax, 0)[:, far_cols].any()


@pytest.mark.parametrize("kind", ["random", "ties", "lone"])
@pytest.mark.parametrize("shape,t", [((24, 400, 10), 100),
                                     ((8, 450, 6), 100)])
def test_split_window_long_columns(shape, t, kind):
    """Columns of 400 and 450 rows (25 and 29 rows a segment) at the cow
    truncation."""
    plan = tedt.closest_plan(shape, t)
    assert plan["c"] == 1
    p2 = _split_words(kind, shape, plan, shape[1])
    x = torch.from_numpy(p2)
    plain = tedt._split_packed_plain(x, plan, 1).numpy()
    out, taps_n, taps_p = tedt.split_window_taps(x, plan, 1)
    np.testing.assert_array_equal(out.numpy(), plain)
    np.testing.assert_array_equal(_split_kernel(p2, plan), plain)
    assert max(int(taps_n.max()), int(taps_p.max())) <= t


def test_split_window_tap_counts():
    """Taps on one column, counted by hand: t = 10, 16 rows of far words
    but value 0 at row 0 (payload 2) and at row 14 (payload 1).  Side n
    of rows 1-10 starts at k0n = i, where row 0 gives i^2 << s, and stops
    at once; rows 11-14 have k0n > t; row 15 takes row 14 at k0n = 1.
    Side p alike for rows 4-13 from row 14; rows 14-15 have nothing
    above.  Row 7 ties (49 from each side): n wins although p's payload
    is smaller."""
    plan = dict(t=10, s=4, cap=101)
    w = np.full((16, 1, 1), (101 << 4) | 9, np.int32)
    w[0], w[14] = 2, 1
    out, taps_n, taps_p = tedt.split_window_taps(torch.from_numpy(w), plan)
    np.testing.assert_array_equal(taps_n.numpy()[:, 0, 0],
                                  [0] + [1] * 10 + [0] * 4 + [1])
    np.testing.assert_array_equal(taps_p.numpy()[:, 0, 0],
                                  [0] * 4 + [1] * 10 + [0] * 2)
    np.testing.assert_array_equal(
        out.numpy(), tedt._split_packed_plain(torch.from_numpy(w),
                                              plan).numpy())
    assert out.numpy()[7, 0, 0] == (49 << 5) | 2           # sign 0, n's pay
    assert out.numpy()[10, 0, 0] == (16 << 5) | (1 << 4) | 1  # p wins


# ---------------------------------------------------------------------------
# The CUDA window kernel's bounded window (kernels/closest.cu: the split's
# body with one shared accumulator), emulated
# ---------------------------------------------------------------------------


def _window_plan(shape, t, axis):
    """A packed plan for the window pass along ``axis``: the payload's b
    field fits that axis, its a field the narrowest other axis."""
    bits = [max(1, (n - 1).bit_length()) for n in shape]
    ba = min(b for i, b in enumerate(bits) if i != axis)
    plan = dict(t=t, ba=ba, bb=bits[axis], s=ba + bits[axis],
                cap=t * t + 1)
    assert plan["cap"].bit_length() + 1 + plan["s"] <= 31
    return plan


def _window_words(kind, shape, plan, axis, seed):
    """Window-pass input words ``v << ba | a*`` (v <= cap) along
    ``axis``, for each edge of the kernel's bounds."""
    ba, cap = plan["ba"], plan["cap"]
    rng = np.random.default_rng(seed)
    lead = (shape[axis],) + tuple(n for i, n in enumerate(shape)
                                  if i != axis)
    a = lead[0]
    tl = min(plan["t"], a - 1)
    pay = rng.integers(0, 1 << ba, lead)
    if kind == "random":
        v = rng.integers(0, cap + 1, lead)
        v[rng.uniform(size=lead) < 0.6] = cap
    elif kind == "ties":
        # candidates v + k^2 tie often, within a side and across the two;
        # payloads 0-2 tie the a* field too
        v = rng.choice([0, 1, 3, 4, 8, 9, cap, cap], lead)
        pay = rng.integers(0, 3, lead)
    elif kind == "cap":
        v = rng.choice([cap - 1, cap, cap, cap], lead)
    elif kind == "all_far":
        v = np.full(lead, cap)
        v[:, 0, 0] = rng.integers(0, cap, a)        # one column with values
    else:           # "lone": one near value per column, at t_local and
        v = np.full(lead, cap)      # t_local + 1 from either column end
        seg_len = -(-a // SPLIT_SEGS)               # and from segment edges
        rows = {0, tl, tl + 1, a - 1 - tl, a - 2 - tl, a - 1}
        for edge in range(seg_len, a, seg_len):
            rows |= {edge - tl, edge - 1 - tl, edge - 1 + tl, edge + tl}
        rows = sorted(r for r in rows if 0 <= r < a)
        flat = v.reshape(a, -1)
        for j in range(flat.shape[1]):
            if j % 7:                                # every 7th: all far
                flat[rows[j % len(rows)], j] = j % 3
    words = (np.asarray(v, np.int64) << ba) | pay
    return np.ascontiguousarray(np.moveaxis(words.astype(np.int32), 0, axis))


def _window_kernel(p1, plan, axis):
    """The window kernel's emulation along ``axis``: the load's repack
    ``v << s | i << ba | a*``, then the bounded body with one accumulator
    and the clamp at cap."""
    ba, s = plan["ba"], plan["s"]
    x = np.moveaxis(p1.astype(np.int64), axis, 0)
    i = np.arange(x.shape[0]).reshape((-1,) + (1,) * (x.ndim - 1))
    w = ((x >> ba) << s) | (i << ba) | (x & ((1 << ba) - 1))
    return _bounded_kernel(np.moveaxis(w, 0, axis), axis,
                           min(plan["t"], x.shape[0] - 1), s, plan["cap"],
                           _window_word, shared=True)


def _check_window(p1, plan, axis):
    """The emulation, ``closest_window_taps`` and the Pallas kernel all
    give ``_window_packed_plain``'s words; the taps stay within each
    voxel's reach on either side (so below the brute force's 2 t_local
    loads) and are 0 in columns with no value below cap."""
    x = torch.from_numpy(p1)
    plain = tedt._window_packed_plain(x, plan, axis).numpy()
    out, taps = tedt.closest_window_taps(x, plan, axis)
    np.testing.assert_array_equal(out.numpy(), plain)
    rest = tuple(i for i in range(3) if i != axis)
    ref = np.asarray(jedt._window_packed_pallas(
        jnp.asarray(p1.transpose((axis,) + rest)), plan, interpret=True))
    np.testing.assert_array_equal(
        plain, ref.transpose(tuple(int(i) for i in np.argsort(
            (axis,) + rest))))
    np.testing.assert_array_equal(_window_kernel(p1, plan, axis), plain)
    a = p1.shape[axis]
    tl = min(plan["t"], a - 1)
    i = np.arange(a).reshape((-1, 1, 1))
    reach = np.minimum(tl, i) + np.minimum(tl, a - 1 - i)
    assert (np.moveaxis(taps.numpy(), axis, 0) <= reach).all()
    far_cols = ((p1 >> plan["ba"]) >= plan["cap"]).all(axis=axis)
    assert not np.moveaxis(taps.numpy(), axis, 0)[:, far_cols].any()


@pytest.mark.parametrize("kind", ["random", "ties", "cap", "all_far",
                                  "lone"])
@pytest.mark.parametrize("layout", sorted(SPLIT_LAYOUTS))
def test_window_kernel_matches_plain_and_pallas(layout, kind):
    """The window kernel's bounds, as ``closest_window_taps`` models them
    and as the kernel's threads run them, along the plan's b axis: side
    and payload ties, values at cap and cap - 1, all-far tiles, lone
    values at t_local and t_local + 1 from a column end and a segment
    edge; t < A and t >= A."""
    shape, t = SPLIT_LAYOUTS[layout]
    plan = tedt.closest_plan(shape, t)
    p1 = _window_words(kind, shape, plan, plan["b"], len(layout) + len(kind))
    _check_window(p1, plan, plan["b"])


@pytest.mark.parametrize("kind", ["random", "ties", "lone"])
@pytest.mark.parametrize("shape,t", [((24, 400, 10), 100),
                                     ((8, 450, 6), 100)])
def test_window_kernel_long_columns(shape, t, kind):
    """Columns of 400 and 450 rows (25 and 29 rows a segment) at the cow
    truncation, the window along axis 1."""
    plan = _window_plan(shape, t, 1)
    p1 = _window_words(kind, shape, plan, 1, shape[1] + len(kind))
    _check_window(p1, plan, 1)


def test_window_tap_counts():
    """Taps on one column of 16 rows, counted by hand: t = 10, value 0 at
    row 3 (a* = 1) and row 9 (a* = 2), cap elsewhere.  Rows 0-2 take row 3
    on side p in one offset; rows 4-5 take it on side n, and side p,
    starting from that accumulator, stops before row 9 (the split's side
    p, from the centre, would take one more); rows 6-8 take both rows,
    and row 6 ties (9 from each side): row 3's smaller payload wins;
    rows 10-15 take row 9 on side n."""
    plan = dict(t=10, ba=2, bb=4, s=6, cap=101)
    raw = np.full((16, 1, 1), (101 << 2) | 3, np.int32)
    raw[3], raw[9] = 1, 2
    out, taps = tedt.closest_window_taps(torch.from_numpy(raw), plan)
    np.testing.assert_array_equal(
        taps.numpy()[:, 0, 0], [1, 1, 1, 0, 1, 1, 2, 2, 2, 0] + [1] * 6)
    np.testing.assert_array_equal(
        out.numpy(), tedt._window_packed_plain(torch.from_numpy(raw),
                                               plan).numpy())
    assert out.numpy()[6, 0, 0] == (9 << 6) | (3 << 2) | 1
    assert out.numpy()[7, 0, 0] == (4 << 6) | (9 << 2) | 2
    # the split's sides on the same words: side p from the centre
    _, taps_n, taps_p = tedt.split_window_taps(
        tedt._window_repack(torch.from_numpy(raw), plan), plan)
    np.testing.assert_array_equal(
        (taps_n + taps_p).numpy()[:, 0, 0],
        [1, 1, 1, 0, 2, 2, 2, 2, 2, 0] + [1] * 6)


# ---------------------------------------------------------------------------
# The CUDA binary kernel's column tiles and segmented sweep
# (kernels/closest.cu), emulated
# ---------------------------------------------------------------------------

# closest.cu's binary block at these column lengths: 512 threads, 32
# columns, so 16 segments a column
BINARY_TC, BINARY_SEGS = 32, 16


def _binary_plan(a, t):
    """A packed plan's binary-pass fields for columns of ``a`` rows."""
    return dict(t=t, ba=max(1, (a - 1).bit_length()), cap=t * t + 1)


def _binary_kernel(occ, plan, square, tc=BINARY_TC, segs=BINARY_SEGS):
    """closest.cu's binary kernel on an [A, cols] occupancy, block by block
    (tc columns, numpy across them) and thread by thread: a tile with no
    seed writes ``far << ba | i``; otherwise the tile holds 0 at a seed
    and t_local + 2 elsewhere (u8 while that fits, else u16), each of
    ``segs`` segments sweeps itself from "none" (g at its last row, h at
    its first), then, after the barrier, sweeps forward from the carries
    below, keeping g in the tile, and backward from the carries above,
    forming each word from g and d = min(g, h)."""
    a, ncols = occ.shape
    tl = min(plan["t"], a - 1)
    ba = plan["ba"]
    cap, big = tl + 2, tl + 1
    far = plan["cap"] if square else plan["t"] + 1
    reach_ok = tkernels._binary_reach(tl) > tl
    tile_max = 255 if cap <= 255 else 65535
    seg_len = -(-a // segs)
    bounds = [(min(a, j * seg_len), min(a, min(a, j * seg_len) + seg_len))
              for j in range(segs)]
    out = np.empty((a, ncols), np.int64)
    for c0 in range(0, ncols, tc):
        seeds = occ[:, c0:c0 + tc] != 0
        if not seeds.any():
            out[:, c0:c0 + tc] = (far << ba) | np.arange(a)[:, None]
            continue
        tile = np.where(seeds, 0, cap)
        up, down = [], []
        for r0, r1 in bounds:
            g = np.full(tile.shape[1], cap)
            h = np.full(tile.shape[1], cap)
            for i in range(r0, r1):
                g = np.minimum(g + 1, tile[i])
                h = np.minimum(h, tile[i] + (i - r0))
            up.append(g)
            down.append(h)
        for j, (r0, r1) in enumerate(bounds):
            g = np.full(tile.shape[1], cap)
            for q in range(j):
                g = np.minimum(g + bounds[q][1] - bounds[q][0], up[q])
            h = np.full(tile.shape[1], cap)
            for q in range(segs - 1, j, -1):
                h = np.minimum(h + bounds[q][1] - bounds[q][0], down[q])
            for i in range(r0, r1):
                g = np.minimum(g + 1, tile[i])
                assert g.max() <= tile_max
                tile[i] = g
            for i in range(r1 - 1, r0 - 1, -1):
                gi = tile[i]
                h = np.minimum(h + 1, gi)
                d = h
                near = ((d * d if square else d) << ba) \
                    | np.where(gi == d, i - gi, i + d)
                far_word = (far << ba) \
                    | np.where(reach_ok & (gi == big), i - big, i)
                out[i, c0:c0 + tc] = np.where(d <= tl, near, far_word)
    assert out.max() < 2 ** 31 and out.min() >= 0
    return out.astype(np.int32)


def _binary_columns(a, t, seed):
    """[A, cols] u8 occupancy at the kernel's edges: a first tile with no
    seed; lone seeds at t_local and t_local + 1 from either column end and
    from each segment edge (both sides); pairs of seeds 2d apart, whose
    middle row ties (g == h); random seeds, sparse and dense; and a last
    tile only partly filled."""
    tl = min(t, a - 1)
    seg_len = -(-a // BINARY_SEGS)
    rows = {0, a - 1, tl, tl + 1, a - 1 - tl, a - 2 - tl}
    for edge in range(seg_len, a, seg_len):
        rows |= {edge - tl, edge - 1 - tl, edge - 1 + tl, edge + tl}
    rows = sorted(r for r in rows if 0 <= r < a)
    cols = [np.zeros(a, np.uint8) for _ in range(BINARY_TC)]
    for r in rows:
        col = np.zeros(a, np.uint8)
        col[r] = 1
        cols.append(col)
    for d in sorted({1, 2, tl // 2, tl, tl + 1}):
        for mid in (a // 2, seg_len, seg_len - 1, d):
            if 0 <= mid - d and mid + d < a and d > 0:
                col = np.zeros(a, np.uint8)
                col[[mid - d, mid + d]] = 1
                cols.append(col)
    rng = np.random.default_rng(seed)
    for p in (0.01, 0.05, 0.3):
        cols += list((rng.uniform(size=(6, a)) < p).astype(np.uint8))
    cols += [np.zeros(a, np.uint8)] * (-len(cols) % BINARY_TC + 11)
    return np.stack(cols, 1)


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("t", [3, 4, 17, 100, "a"])
@pytest.mark.parametrize("a", [5, 48, 400, 401])
def test_binary_kernel_matches_plain_and_pallas(a, t, square):
    """The tile sweep gives the packed binary pass's words: t < A and
    t >= A ("a": t = A + 3), reach_ok false (t = 3) and true (t = 4),
    columns of one to sixteen segments, lone seeds at t_local and
    t_local + 1 from a column end and a segment edge, ties between the
    seeds below and above, the far payload i - L, all-far tiles and a
    partly filled last tile."""
    t = a + 3 if t == "a" else t
    plan = _binary_plan(a, t)
    occ = _binary_columns(a, t, a + t)
    got = _binary_kernel(occ, plan, square)
    plain = tedt._binary_packed_plain(torch.from_numpy(occ), plan, 0,
                                      square).numpy()
    np.testing.assert_array_equal(got, plain)
    ref = np.asarray(jedt._binary_packed_pallas(
        jnp.asarray(occ[:, :, None]), plan, interpret=True, square=square))
    np.testing.assert_array_equal(got, ref[:, :, 0])
    tl = min(t, a - 1)
    if tkernels._binary_reach(tl) > tl and a > tl + 1:
        # a lone seed at row r gives row r + L its index as the far payload
        val = got >> plan["ba"]
        assert ((val == plan["cap"] if square else val == t + 1)
                & ((got & ((1 << plan["ba"]) - 1))
                   != np.arange(a)[:, None])).any()


@pytest.mark.parametrize("square", [True, False])
def test_binary_kernel_u16_tile(square):
    """t_local above 253 (the packed plan (400, 8, 8) at t = 300): the
    tile holds g in u16."""
    shape, t = (400, 8, 8), 300
    plan = tedt.closest_plan(shape, t)
    assert plan is not None and plan["a"] == 0
    occ = _binary_columns(400, t, 3)
    got = _binary_kernel(occ, plan, square)
    np.testing.assert_array_equal(got, tedt._binary_packed_plain(
        torch.from_numpy(occ), plan, 0, square).numpy())
    ref = np.asarray(jedt._binary_packed_pallas(
        jnp.asarray(occ[:, :, None]), plan, interpret=True, square=square))
    np.testing.assert_array_equal(got, ref[:, :, 0])
