"""fiesta_tpu_torch EDT passes and transform against fiesta_tpu (CPU).

The JAX Pallas kernels run in interpret mode, as
``tests/test_kernels_interpret.py`` runs them; the port's plain versions
(what a CPU tensor takes) must match them bit for bit.  d2 is a pure
function of the occupancy, so ``truncated_edt_d2`` must too.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu.ops.pallas import edt as jedt  # noqa: E402

from fiesta_tpu_torch.ops import edt as tedt  # noqa: E402

INF = jedt._INF_EDT


def _binary_volume(shape, p, seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.uniform(size=shape) < p, 0, INF).astype(np.int32)


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("t", [1, 5, 17, 47, 60])
def test_binary_pass_matches_pallas_interpret(t, square):
    f = _binary_volume((48, 20, 12), 0.02, 1)
    f[:, 0, 0] = INF                       # an all-far column
    ref = np.asarray(jedt._binary_pass_pallas(jnp.asarray(f), t,
                                              interpret=True, square=square))
    got = tedt.binary_pass(torch.from_numpy(f), t, square=square).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("t", [1, 5, 17, 47])
def test_minplus_pass_matches_pallas_interpret(t):
    f = _binary_volume((48, 20, 12), 0.02, 0)
    f[:, 3] = np.minimum(f[:, 3], 7)       # non-binary values
    ref = np.asarray(jedt._minplus_pass_pallas(jnp.asarray(f), t,
                                               interpret=True))
    got = tedt.minplus_pass(torch.from_numpy(f), t, axis=0).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_minplus_pass_any_axis_matches_xla(axis):
    """The axis argument walks strided columns: equal to the JAX pass on
    the volume transposed so that axis leads."""
    rng = np.random.default_rng(axis)
    f = np.where(rng.uniform(size=(14, 17, 11)) < 0.05,
                 rng.integers(0, 40, (14, 17, 11)), INF).astype(np.int32)
    perm = (axis,) + tuple(i for i in range(3) if i != axis)
    inv = tuple(int(i) for i in np.argsort(perm))
    ref = np.asarray(jedt._minplus_pass_xla(
        jnp.asarray(f.transpose(perm)), 6)).transpose(inv)
    got = tedt.minplus_pass(torch.from_numpy(f), 6, axis=axis).numpy()
    np.testing.assert_array_equal(got, ref)


def _volumes():
    rng = np.random.default_rng(7)
    shape = (24, 19, 13)
    single = np.zeros(shape, bool)
    single[11, 3, 9] = True
    edge = np.zeros(shape, bool)
    edge[0, 0, 0] = edge[-1, -1, -1] = True
    return {"empty": np.zeros(shape, bool), "single": single, "edge": edge,
            "random": rng.random(shape) < 0.01}


@pytest.mark.parametrize("t", [0, 1, 5, 17, 30])
@pytest.mark.parametrize("kind", ["empty", "single", "edge", "random"])
def test_truncated_edt_matches_jax(kind, t):
    occ = _volumes()[kind]
    ref = np.asarray(jedt.truncated_edt_d2(jnp.asarray(occ), t))
    got = tedt.truncated_edt_d2(torch.from_numpy(occ), t).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_trunc_and_closest_capability_match():
    for res, dist in ((0.05, 5.0), (0.1, 5.0), (0.2, 2.0), (0.03, 1.0)):
        assert tedt.trunc_vox_for(res, dist) == jedt.trunc_vox_for(res, dist)
    for shape, t in (((400, 400, 80), 100), ((48, 48, 32), 15),
                     ((2048, 2048, 64), 400), ((40, 32, 24), 9)):
        assert tedt.closest_capability(shape, t) == \
            jedt.closest_capability(shape, t)
        assert tedt.closest_plan(shape, t) == jedt.closest_plan(shape, t)
        assert tedt.closest_plan_wide(shape, t) == \
            jedt.closest_plan_wide(shape, t)


# ---------------------------------------------------------------------------
# The CUDA min-plus kernel's bounded window (kernels/edt.cu), emulated
# ---------------------------------------------------------------------------


def _minplus_inputs(kind, t, seed):
    """Columns along axis 0 (length 48) for each edge of the bound."""
    rng = np.random.default_rng(seed)
    shape = (48, 9, 7)
    if kind == "random":
        f = rng.integers(0, INF + 1, shape)
        f[rng.uniform(size=shape) < 0.6] = INF
    elif kind == "near_t2":
        # values at, just below and just above t^2, and far
        f = rng.choice([t * t - 1, t * t, t * t + 1, t * t + 2, INF], shape)
    elif kind == "all_far":
        f = np.full(shape, INF)
        f[:, 0, 0] = 3                          # one column with values
    else:                                       # "single": one 0 per column
        f = np.full(shape, INF)
        tl = min(t, shape[0] - 1)
        f[0, :, :] = 0                          # distance tl at row tl ...
        f[:, 1, :] = INF
        f[min(tl + 1, shape[0] - 1), 1, :] = 0  # ... and tl + 1 from row 0
        f[:, 2, :] = INF
        f[shape[0] - 1, 2, 3] = 5               # a non-zero lone value
    return np.asarray(f, np.int32)


@pytest.mark.parametrize("t", [1, 6, 30, 47, 100])
@pytest.mark.parametrize("kind", ["random", "near_t2", "all_far", "single"])
def test_bounded_window_matches_plain_and_pallas(kind, t):
    """The kernel's loop bounds (k0 from below, k^2 >= acc from above) give
    the plain pass on every value, above t^2 and on all-far columns too;
    t = 47, 100 cover t >= A - 1 (A = 48), the rest t < A."""
    f = _minplus_inputs(kind, t, t)
    got, taps = tedt.minplus_window_taps(torch.from_numpy(f), t, 0)
    plain = tedt._minplus_pass_plain(torch.from_numpy(f), t, 0).numpy()
    np.testing.assert_array_equal(got.numpy(), plain)
    ref = np.asarray(jedt._minplus_pass_pallas(jnp.asarray(f), t,
                                               interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref)
    tl = min(t, f.shape[0] - 1)
    assert int(taps.max()) <= tl
    far_cols = (f >= INF).all(axis=0)
    assert not taps.numpy()[:, far_cols].any()  # all-far columns: no loop
    assert not taps.numpy()[f == 0].any()       # acc = 0 stops at once


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_bounded_window_any_axis(axis):
    rng = np.random.default_rng(axis + 20)
    f = np.where(rng.uniform(size=(14, 17, 11)) < 0.05,
                 rng.integers(0, 400, (14, 17, 11)), INF).astype(np.int32)
    got, _ = tedt.minplus_window_taps(torch.from_numpy(f), 9, axis)
    np.testing.assert_array_equal(
        got.numpy(), tedt._minplus_pass_plain(torch.from_numpy(f), 9,
                                              axis).numpy())


def test_bounded_window_tap_counts():
    """Taps on one column, counted by hand: a lone 0 at row 0, t = 10.
    Row i (1 <= i <= 10) starts at k0 = i, where the 0 gives acc = i^2,
    so it stops there: one tap; rows past t have k0 > t: none."""
    f = np.full((16, 1, 1), INF, np.int32)
    f[0] = 0
    _, taps = tedt.minplus_window_taps(torch.from_numpy(f), 10, 0)
    np.testing.assert_array_equal(taps.numpy()[:, 0, 0],
                                  [0] + [1] * 10 + [0] * 5)


def _segmented_k0(col, segs, cap=2047, none=1 << 20):
    """edt.cu's k0 sweep of one tile column, thread by thread: each of
    ``segs`` threads finds the first and last value below INF in its
    segment, then (after the barrier) sweeps its rows forward from the
    nearest such row before it and backward from the nearest after it."""
    a = len(col)
    seg_len = -(-a // segs)
    bounds = [(min(a, s * seg_len), min(a, min(a, s * seg_len) + seg_len))
              for s in range(segs)]
    first, last = [], []
    for r0, r1 in bounds:
        rows = [i for i in range(r0, r1) if col[i] < INF]
        first.append(rows[0] if rows else -1)
        last.append(rows[-1] if rows else -1)
    k0 = [0] * a
    for s, (r0, r1) in enumerate(bounds):
        lp, nn = -none, a + none
        for j in range(s):
            if last[j] >= 0:
                lp = last[j]
        for j in range(segs - 1, s, -1):
            if first[j] >= 0:
                nn = first[j]
        for i in range(r0, r1):
            if col[i] < INF:
                lp = i
            k0[i] = min(i - lp, cap)
        for i in range(r1 - 1, r0 - 1, -1):
            if col[i] < INF:
                nn = i
            k0[i] = min(k0[i], nn - i, cap)
    return k0


@pytest.mark.parametrize("a,segs", [(48, 8), (400, 8), (80, 8), (5, 8),
                                    (401, 16), (3000, 256)])
def test_segmented_k0_is_the_nearest_distance(a, segs):
    """The segmented sweep gives the distance to the nearest value below
    INF (capped at 2047), empty segments and near-free columns included."""
    rng = np.random.default_rng(a)
    for p in (0.0, 0.002, 0.05, 0.5):
        col = np.where(rng.uniform(size=a) < p, 7, INF)
        near = np.flatnonzero(col < INF)
        want = [min(int(np.abs(near - i).min()), 2047) if near.size else 2047
                for i in range(a)]
        assert _segmented_k0(col, segs) == want



# ---------------------------------------------------------------------------
# The CUDA binary kernel's column tiles and segmented sweep (kernels/edt.cu),
# emulated
# ---------------------------------------------------------------------------

# edt.cu's binary block at these column lengths: 32 columns, 512 threads
BINARY_TC, BINARY_SEGS = 32, 16


def _segmented_binary(f, t, square, tc=BINARY_TC, segs=BINARY_SEGS):
    """edt.cu's binary kernel on an [A, cols] volume, block by block (tc
    columns, numpy across them) and thread by thread: a tile with no value
    below t_local + 1 writes the sentinel; otherwise each of ``segs``
    segments sweeps itself from "far" (g at its last row, h at its
    first), then, after the barrier, sweeps forward and backward from the
    carries of the segments below and above."""
    a, ncols = f.shape
    tl = min(t, a - 1)
    cap = tl + 1
    far = INF if square else t + 1
    seg_len = -(-a // segs)
    bounds = [(min(a, j * seg_len), min(a, min(a, j * seg_len) + seg_len))
              for j in range(segs)]
    out = np.empty_like(f)
    for c0 in range(0, ncols, tc):
        v = np.minimum(f[:, c0:c0 + tc], cap)
        if not (v < cap).any():
            out[:, c0:c0 + tc] = far
            continue
        up, down = [], []
        for r0, r1 in bounds:
            g = np.full(v.shape[1], cap)
            h = np.full(v.shape[1], cap)
            for i in range(r0, r1):
                g = np.minimum(g + 1, v[i])
                h = np.minimum(h, v[i] + (i - r0))
            up.append(g)
            down.append(h)
        for j, (r0, r1) in enumerate(bounds):
            g = np.full(v.shape[1], cap)
            for q in range(j):
                g = np.minimum(g + bounds[q][1] - bounds[q][0], up[q])
            h = np.full(v.shape[1], cap)
            for q in range(segs - 1, j, -1):
                h = np.minimum(h + bounds[q][1] - bounds[q][0], down[q])
            fwd = {}
            for i in range(r0, r1):
                g = np.minimum(g + 1, v[i])
                fwd[i] = g
            for i in range(r1 - 1, r0 - 1, -1):
                h = np.minimum(h + 1, fwd[i])
                out[i, c0:c0 + tc] = np.where(h > tl, far,
                                              h * h if square else h)
    return out


def _binary_edges(a, t, seed):
    """[A, cols] 0 / INF columns for each edge of the sweep: all far, lone
    seeds at t_local and t_local + 1 from either column end and from each
    segment edge (both sides), and random seeds, sparse and dense."""
    tl = min(t, a - 1)
    seg_len = -(-a // BINARY_SEGS)
    rows = {0, a - 1, tl, tl + 1, a - 1 - tl, a - 2 - tl}
    for edge in range(seg_len, a, seg_len):
        rows |= {edge - tl, edge - 1 - tl, edge - 1 + tl, edge + tl}
    rows = sorted(r for r in rows if 0 <= r < a)
    cols = [np.full(a, INF)]
    for r in rows:
        col = np.full(a, INF)
        col[r] = 0
        cols.append(col)
    rng = np.random.default_rng(seed)
    for p in (0.01, 0.05, 0.3):
        cols += list(np.where(rng.uniform(size=(8, a)) < p, 0, INF))
    return np.stack(cols, 1).astype(np.int32)


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("t", [1, 5, 17, 47, 100, "a"])
@pytest.mark.parametrize("a", [5, 48, 400, 401])
def test_segmented_binary_matches_plain_and_pallas(a, t, square):
    """The tile sweep gives the binary pass on every column: t < A and
    t >= A ("a": t = A + 3), columns of one to sixteen segments, seeds at
    t_local and t_local + 1 from a column end and from a segment edge."""
    t = a + 3 if t == "a" else t
    f = _binary_edges(a, t, a + t)
    got = _segmented_binary(f, t, square)
    plain = tedt._binary_pass_plain(torch.from_numpy(f), t, square).numpy()
    np.testing.assert_array_equal(got, plain)
    ref = np.asarray(jedt._binary_pass_pallas(
        jnp.asarray(f[:, :, None]), t, interpret=True, square=square))
    np.testing.assert_array_equal(got, ref[:, :, 0])
