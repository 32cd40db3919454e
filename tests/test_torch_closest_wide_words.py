"""fiesta_tpu_torch's wide closest passes, word by word, against fiesta_tpu
(CPU).

On ``test_torch_closest_wide.py``'s shapes (the x-lead layout the wide
plan takes, a widest-C plan built by hand, columns longer than 254 rows at
t = 2000):

  * each pass's 64-bit word equals ``fiesta_tpu``'s pair pass
    (``_binary_pair_xla``, ``_window_pair_xla``, ``_split_pair_xla``)
    packed into the word;
  * the CUDA kernels' algorithms on that word (the binary pass's closed
    form with its far-voxel payload, the window and split passes'
    bounded windows with k0p capped at 254, four offsets a turn),
    emulated in numpy, give the same words.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # as tests/test_torch_closest_wide.py says

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu.ops.pallas import edt as jedt  # noqa: E402

from fiesta_tpu_torch import kernels as tkernels  # noqa: E402
from fiesta_tpu_torch.ops import edt as tedt  # noqa: E402

from test_torch_closest_wide import SHAPES, _occ, _plan  # noqa: E402

LAYOUTS = sorted(SHAPES) + ["widest_c"]


def _jax_pairs(occ, plan):
    """fiesta_tpu's three pair passes on the transposed volume, each packed
    into the 64-bit word: ([A,B,C], [B,A,C], [C,A,B])."""
    a, b, c, ba, s = plan["a"], plan["b"], plan["c"], plan["ba"], plan["s"]
    occ_t = jnp.asarray(occ.transpose(a, b, c).astype(np.uint8))
    h1, l1 = jedt._binary_pair_xla(occ_t, plan)
    h2, l2 = jedt._window_pair_xla(h1.transpose(1, 0, 2),
                                   l1.transpose(1, 0, 2), plan)
    val, sign, pay = jedt._split_pair_xla(h2.transpose(2, 1, 0),
                                          l2.transpose(2, 1, 0), plan)
    w = [np.asarray(x).astype(np.int64) for x in (h1, l1, h2, l2, val, sign,
                                                  pay)]
    return ((w[0] << ba) | w[1], (w[2] << s) | w[3],
            (w[4] << (s + 1)) | (w[5] << s) | w[6])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_wide_words_equal_jax_pair_passes(layout):
    shape, plan = _plan(layout)
    a, b, c = plan["a"], plan["b"], plan["c"]
    occ = _occ(shape, plan, len(layout))
    j1, j2, j3 = _jax_pairs(occ, plan)
    p1 = tedt.binary_wide(torch.from_numpy(occ), plan, a)
    p2 = tedt.window_wide(p1, plan, b)
    p3 = tedt.split_wide(p2, plan, c)
    for got, ref, perm in ((p1, j1, (a, b, c)), (p2, j2, (b, a, c)),
                           (p3, j3, (c, a, b))):
        assert got.dtype == torch.int64 and got.shape == shape
        np.testing.assert_array_equal(got.permute(perm).numpy(), ref)
    # some voxels have their obstacle within t, some beyond the column
    val = p3 >> (plan["s"] + 1)
    assert bool((val <= plan["t"] ** 2).any())


def _closed_form_binary(occ, plan):
    """closest.cu's binary pass in closed form on [A, cols] (u8): g and h,
    the distances to the nearest seed at or before / at or after row i
    clamped at L + 1 (L = t_local + 1), D = min(g, h); value D^2 with the
    lower seed's index where D <= t_local, else cap with i - L (a seed
    exactly L below, when the doubling steps reach past t_local) or i."""
    a, ncols = occ.shape
    tl = min(plan["t"], a - 1)
    big = tl + 1
    cap_t = tl + 2
    reach_ok = tkernels._binary_reach(tl) > tl
    g = np.empty((a, ncols), np.int64)
    h = np.empty((a, ncols), np.int64)
    run = np.full(ncols, cap_t)
    for i in range(a):
        run = np.where(occ[i] != 0, 0, np.minimum(run + 1, cap_t))
        g[i] = run
    run = np.full(ncols, cap_t)
    for i in range(a - 1, -1, -1):
        run = np.where(occ[i] != 0, 0, np.minimum(run + 1, cap_t))
        h[i] = run
    d = np.minimum(g, h)
    i = np.arange(a)[:, None]
    near = ((d * d) << plan["ba"]) | np.where(g == d, i - g, i + d)
    far = (plan["cap"] << plan["ba"]) | np.where(reach_ok & (g == big),
                                                 i - big, i)
    return np.where(d <= tl, near, far)


def _bounded_model(x, tl, s, cap, shared):
    """closest.cu's bounded-window body on 64-bit words [A, cols] (the
    load's words): side n from k0n (the nearest row below holding a value
    below cap), side p from k0p (the nearest above, stored capped at 254:
    a lower bound), each while k <= its reach and (k^2 << s) < acc, four
    offsets a turn (an offset past the reach re-reads its last one); side
    p starts from side n's accumulator when ``shared``.  Returns (acc_n,
    acc_p)."""
    a = x.shape[0]
    i = np.arange(a)[:, None] + np.zeros_like(x)
    near = (x >> s) < cap
    below = np.maximum.accumulate(np.where(near, i, -1), axis=0)
    above = np.minimum.accumulate(np.where(near, i, a)[::-1], axis=0)[::-1]
    lp = np.concatenate([np.full_like(x[:1], -1), below[:-1]])
    nn = np.concatenate([above[1:], np.full_like(x[:1], a)])
    sides = []
    acc = x.copy()
    for step, k, kmax, live in (
            (-1, i - lp, np.minimum(tl, i), lp >= 0),
            (1, np.minimum(nn - i, 254), np.minimum(tl, a - 1 - i), nn < a)):
        if not shared:
            acc = x.copy()
        k = np.where(live, k, 0)
        live = live & (k <= kmax) & (((k * k) << s) < acc)
        while live.any():
            for u in range(4):
                kq = np.minimum(k + u, kmax)
                rows = np.clip(i + step * kq, 0, a - 1)
                cand = np.take_along_axis(x, rows, 0) + ((kq * kq) << s)
                assert cand.max() < 2 ** 63 - 1
                acc = np.where(live, np.minimum(acc, cand), acc)
            k = k + 4
            live = live & (k <= kmax) & (((k * k) << s) < acc)
        sides.append(acc)
    return sides


@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_models_give_the_wide_words(layout):
    """The wide kernels' algorithms (the packed kernels' bodies on 64-bit
    words) on each pass's input: the binary pass's closed form along a,
    the window's repack and shared bounded window along b, the split's two
    bounded windows along c, each equal to the plain word pass."""
    shape, plan = _plan(layout)
    a, b, c = plan["a"], plan["b"], plan["c"]
    ba, s, cap = plan["ba"], plan["s"], plan["cap"]
    occ = torch.from_numpy(_occ(shape, plan, 3 + len(layout)))
    p1 = tedt.binary_wide(occ, plan, a)
    x = occ.to(torch.uint8).movedim(a, 0).reshape(shape[a], -1).numpy()
    np.testing.assert_array_equal(
        _closed_form_binary(x, plan),
        p1.movedim(a, 0).reshape(shape[a], -1).numpy())

    p2 = tedt.window_wide(p1, plan, b)
    x = p1.movedim(b, 0).reshape(shape[b], -1).numpy()
    rows = np.arange(x.shape[0])[:, None]
    w = ((x >> ba) << s) | (rows << ba) | (x & ((1 << ba) - 1))
    _, acc = _bounded_model(w, min(plan["t"], shape[b] - 1), s, cap, True)
    word = (np.minimum(acc >> s, cap) << s) | (acc & ((1 << s) - 1))
    np.testing.assert_array_equal(
        word, p2.movedim(b, 0).reshape(shape[b], -1).numpy())

    p3 = tedt.split_wide(p2, plan, c)
    x = p2.movedim(c, 0).reshape(shape[c], -1).numpy()
    acc_n, acc_p = _bounded_model(x, min(plan["t"], shape[c] - 1), s, cap,
                                  False)
    vn, vp = acc_n >> s, acc_p >> s
    use_p = vp < vn
    word = (np.minimum(np.minimum(vn, vp), cap) << (s + 1)) \
        | (use_p.astype(np.int64) << s) \
        | (np.where(use_p, acc_p, acc_n) & ((1 << s) - 1))
    np.testing.assert_array_equal(
        word, p3.movedim(c, 0).reshape(shape[c], -1).numpy())
