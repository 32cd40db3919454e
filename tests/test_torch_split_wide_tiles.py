"""The wide closest split's tiled schedule on the CPU (no card needed).

``kernels/closest.cu``'s ``closest_split_wide_kernel<T>`` runs the wide
transform's last pass in blocks of 16 columns and 256 threads, each thread one column's rows ``c0 + g``, ``c0 + g +
16``, ...; it walks the column in chunks of ``rows`` output rows, each
loaded with t_local rows of halo either side, takes the nearest near row
below (lp) and above (nn, k0p's 254/255 codes) from a bit mask of the
chunk's near rows, and works on u32 tile words where
``kernels.split_wide_word_bits`` allows; its launcher sizes the chunks
(``split_tiles``).  This file holds a numpy model of that sizing
(``split_tiles``, held to the table ``TILES`` that
``tests/test_torch_cuda.py`` holds the launcher to on the card) and an
emulation of the schedule, thread by thread (``emulate_split_wide``:
the chunk's buffer and masks, each thread's mask scans and lp/nn walk,
the bounded sides four offsets a turn with the kmax clamp, the words
narrowed and every add and shift wrapped at the tile word's width, the
output word formed in 64 bits).  It must equal ``edt._split_wide_plain``
and ``fiesta_tpu``'s ``_split_pair_xla`` packed into the word, on plans
on both sides of the 32-bit edge and exactly on it, a column shorter
than t, chunks that do not divide the column, all-far columns and
tiles, lone values at t_local and t_local + 1 from chunk edges, and ties
across a chunk edge.  Past the edge, the same schedule on u32 words
wraps and disagrees, so the condition is needed.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu.ops.pallas import edt as jedt  # noqa: E402

from fiesta_tpu_torch import kernels  # noqa: E402
from fiesta_tpu_torch.ops import edt as tedt  # noqa: E402

M32, M64 = (1 << 32) - 1, (1 << 64) - 1
K0_FAR, K0_NONE = 254, 255           # closest.cu's kK0Far, kK0None
OUTER, INNER = 2, 9                  # 18 columns: tiles of 16 and 2
# closest.cu's kSplitThreads, kSplitCols, kSplitMinRows, SplitWide<T>::kSmem
THREADS, COLS, MIN_ROWS = 256, 16, 64
SMEM = {32: 54 * 1024, 64: 72 * 1024}
# closest.cu's split_tiles: {(rows A, reach tl, tile word bits): (columns,
# chunk rows)}; tests/test_torch_cuda.py holds the launcher to this table
TILES = {(800, 100, 32): (16, 800), (1600, 100, 64): (16, 320),
         (800, 100, 64): (16, 267), (400, 399, 64): (16, 400),
         (1600, 100, 32): (16, 534), (3000, 2000, 64): (8, 3000)}


def split_smem(span, tc, bits):
    """closest.cu's split_smem: base addresses, the tile, the near masks."""
    return 8 * tc + span * tc * bits // 8 + 4 * tc * -(-span // 32)


def split_tiles(a, tl, bits):
    """closest.cu's split_tiles: (columns, chunk rows) of a block along a
    column of ``a`` rows: the column in one chunk where it fits ``SMEM``;
    else chunks of equal rows with tl rows of halo either side, as few as
    the budget allows; where a chunk would hold fewer than ``MIN_ROWS``
    rows, the whole column with fewer columns while it needs > 200 KB."""
    tc, budget = COLS, SMEM[bits]
    if split_smem(a, tc, bits) <= budget:
        return tc, a
    span = (budget - 12 * tc) * 8 // (tc * (bits + 1))
    while split_smem(span + 1, tc, bits) <= budget:
        span += 1
    while split_smem(span, tc, bits) > budget:
        span -= 1
    if span - 2 * tl >= MIN_ROWS:
        chunks = -(-a // (span - 2 * tl))
        return tc, -(-a // chunks)
    while tc > 1 and split_smem(a, tc, bits) > 200 * 1024:
        tc //= 2
    return tc, a


def _last_near(m, lo, to):
    """closest.cu's last_near: the highest row in [lo, to) whose bit is
    set in the 32-bit words ``m``, or -1."""
    while to > lo:
        w = (to - 1) >> 5
        w0 = w << 5
        bits = m[w] & (M32 >> (31 - ((to - 1) & 31)))
        if lo > w0:
            bits &= (M32 << (lo - w0)) & M32
        if bits:
            return w0 + bits.bit_length() - 1
        to = w0
    return -1


def _first_near(m, lo, to):
    """closest.cu's first_near: the lowest row in [lo, to) whose bit is
    set, or ``to``."""
    while lo < to:
        w = lo >> 5
        w0 = w << 5
        bits = m[w] & ((M32 << (lo - w0)) & M32)
        if bits:
            return min(w0 + (bits & -bits).bit_length() - 1, to)
        lo = w0 + 32
    return to


def _side(col, b, d, k0, kmax, s, acc, wmask):
    """closest.cu's bounded_side on tile words of ``wmask``'s width: four
    offsets a turn, an offset past kmax re-reading kmax's."""
    k = k0
    while k <= kmax and ((k * k) << s) & wmask < acc:
        for u in range(4):
            kq = min(k + u, kmax)
            acc = min(acc, (col[b + d * kq] + (((kq * kq) << s) & wmask))
                      & wmask)
        k += 4
    return acc


def _split_word(acc_n, acc_p, s, cap):
    """closest.cu's split_word: val << (s+1) | sign << s | pay, in 64
    bits, ties to the negative side."""
    vn, vp = acc_n >> s, acc_p >> s
    use_p = vp < vn
    val = min(vn, vp, cap)
    return (val << (s + 1)) | (int(use_p) << s) | \
        ((acc_p if use_p else acc_n) & ((1 << s) - 1))


def emulate_split_wide(x, plan, bits, tc, rows, threads=THREADS):
    """The kernel's schedule on the columns ``x`` (int64 [A, ncols], the
    columns in the kernel's [outer, inner] order), thread by thread, on
    tile words of ``bits``: blocks of ``tc`` columns (the last one ragged),
    chunks of ``rows`` output rows with halos of t_local, the near masks,
    each thread's rows g, g + threads / tc, ... with its lp and nn.
    Returns the int64 output words [A, ncols]."""
    a, ncols = x.shape
    s, cap = plan["s"], plan["cap"]
    tl = min(plan["t"], a - 1)
    wmask = M32 if bits == 32 else M64
    span = a if rows >= a or rows + 2 * tl >= a else rows + 2 * tl
    mw, groups = -(-span // 32), threads // tc
    fill = (cap << s) & wmask
    words = [[int(v) & wmask for v in row] for row in x]   # the narrowing
    out = np.zeros_like(x)
    for col0 in range(0, ncols, tc):
        for c0 in range(0, a, rows):
            c1 = min(a, c0 + rows)
            lo = max(0, c0 - tl)
            n = min(a, c1 + tl) - lo
            assert n <= span
            tile = [[words[lo + r][col0 + c] if col0 + c < ncols else fill
                     for r in range(n)] for c in range(tc)]
            masks = [[0] * mw for _ in range(tc)]
            for c, col in enumerate(tile):
                for r, w in enumerate(col):
                    if (w >> s) < cap:
                        masks[c][r >> 5] |= 1 << (r & 31)
            any_near = any(any(m) for m in masks)
            for tid in range(threads):
                c, g = tid % tc, tid // tc
                col, m = tile[c], masks[c]
                i0 = c0 + g
                lp, nn = -1, n
                if any_near and i0 < c1:
                    lp = _last_near(m, max(0, i0 - lo - tl), i0 - lo)
                    nn = _first_near(m, i0 - lo + 1, n)
                for i in range(i0, c1, groups):
                    b = i - lo
                    acc_n = acc_p = col[b]
                    if any_near:
                        if i != i0:
                            q = _last_near(m, b - groups, b)
                            if q >= 0:
                                lp = q
                            if nn <= b:
                                nn = _first_near(m, b + 1, n)
                        kp = min(nn - b, K0_FAR) if nn < n else K0_NONE
                        if lp >= 0:
                            acc_n = _side(col, b, -1, b - lp, min(tl, i), s,
                                          acc_n, wmask)
                        if kp != K0_NONE:
                            acc_p = _side(col, b, 1, kp,
                                          min(tl, a - 1 - i), s, acc_p,
                                          wmask)
                    if col0 + c < ncols:
                        out[i, col0 + c] = _split_word(acc_n, acc_p, s, cap)
    return out


def _plan(t, s):
    """A wide plan for the split alone (axis 1; s = ba + bb)."""
    return dict(a=0, b=2, c=1, ba=s // 2, bb=s - s // 2, s=s,
                cap=t * t + 1, t=t)


def _random_words(rng, a, plan, far=0.6):
    """[A, ncols] words v << s | payload: v uniform in [0, cap], a share
    ``far`` at cap, payloads anywhere below 2^s."""
    shape = (a, OUTER * INNER)
    v = rng.integers(0, plan["cap"] + 1, shape)
    v[rng.random(shape) < far] = plan["cap"]
    return v, rng.integers(0, 1 << plan["s"], shape)


def _lone(a, plan, rows_at):
    """All-far columns, each with one value of 0..2 at a row of
    ``rows_at`` (in turn; rows outside the column skipped)."""
    v = np.full((a, OUTER * INNER), plan["cap"])
    for j in range(v.shape[1]):
        r = rows_at[j % len(rows_at)]
        if 0 <= r < a:
            v[r, j] = j % 3
    return v


def _case(name):
    """(plan, values [A, ncols], payloads, chunk rows or None for the
    kernel's own) of each case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "u32_below_edge":     # (cap + t^2 + 1) << 20 = 4052 << 20
        plan, a, rows = _plan(45, 20), 100, None
    elif name == "u32_on_edge":      # (2 + 1 + 1) << 30 == 2^32
        plan, a, rows = _plan(1, 30), 9, None
    elif name == "u64_above_edge":   # 4234 << 20 > 2^32
        plan, a, rows = _plan(46, 20), 100, None
    elif name == "axis_shorter_than_t":
        plan, a, rows = _plan(50, 12), 30, None
    elif name == "ragged_chunks":    # chunks of 24 over 101 rows
        plan, a, rows = _plan(10, 14), 101, 24
    if name in ("u32_below_edge", "u32_on_edge", "u64_above_edge",
                "axis_shorter_than_t", "ragged_chunks"):
        v, pay = _random_words(rng, a, plan)
        if name == "u32_on_edge":    # the largest words: cap, payload max
            pay[rng.random(pay.shape) < 0.5] = (1 << plan["s"]) - 1
        return plan, v, pay, rows
    if name == "all_far":            # a whole tile far, then mixed columns
        plan, a, rows = _plan(12, 16), 64, 20
        v, pay = _random_words(rng, a, plan)
        v[:, :16] = plan["cap"]
        v[:, 16] = plan["cap"]
        return plan, v, pay, rows
    if name == "lone_at_chunk_edges":
        plan, a, rows = _plan(8, 16), 96, 24
        tl = plan["t"]
        at = []
        for e in (24, 48, 72):       # chunk edges: a chunk's c0, the last's c1
            at += [e - tl, e - tl - 1, e - 1 + tl, e + tl, e - 1 - tl,
                   e + tl + 1]
        v = _lone(a, plan, at)
        return plan, v, rng.integers(0, 1 << plan["s"], v.shape), rows
    if name == "ties_across_chunk_edge":
        plan, a, rows = _plan(6, 10), 72, 24
        v = np.full((a, OUTER * INNER), plan["cap"])
        pay = rng.integers(0, 3, v.shape)
        for j in range(v.shape[1]):  # equal values d rows either side of e
            e = (24, 48)[j % 2] + (j % 5) - 2
            d = 1 + j % 4
            v[e - d, j] = v[e + d, j] = j % 3
            if j % 3 == 0:           # and a tie within a side
                v[e - d - 1, j] = v[e - d, j] + 2 * d + 1
        return plan, v, pay, rows
    raise ValueError(name)


CASES = ["u32_below_edge", "u32_on_edge", "u64_above_edge",
         "axis_shorter_than_t", "ragged_chunks", "all_far",
         "lone_at_chunk_edges", "ties_across_chunk_edge"]


def _volume(x):
    """[A, ncols] -> the [OUTER, A, INNER] volume the split runs along
    axis 1 of (columns in [outer, inner] order)."""
    a = x.shape[0]
    return torch.from_numpy(np.ascontiguousarray(
        x.reshape(a, OUTER, INNER).transpose(1, 0, 2)))


def _columns(vol):
    return vol.numpy().transpose(1, 0, 2).reshape(vol.shape[1], -1)


@pytest.mark.parametrize("name", CASES)
def test_emulated_schedule_equals_plain_and_jax(name):
    plan, v, pay, rows = _case(name)
    s, a = plan["s"], v.shape[0]
    assert v.max() <= plan["cap"] and pay.max() < 1 << s
    x = (v.astype(np.int64) << s) | pay
    bits = kernels.split_wide_word_bits(plan, a)
    tl = min(plan["t"], a - 1)
    tc, chunk = split_tiles(a, tl, bits)
    rows = rows or chunk
    if name in ("ragged_chunks", "all_far", "lone_at_chunk_edges",
                "ties_across_chunk_edge"):
        assert rows < a              # several chunks with halos
    plain = _columns(tedt._split_wide_plain(_volume(x), plan, 1))
    val, sign, p = jedt._split_pair_xla(jnp.asarray(v.astype(np.int32)),
                                        jnp.asarray(pay.astype(np.int32)),
                                        plan)
    ref = (np.asarray(val).astype(np.int64) << (s + 1)) | \
        (np.asarray(sign).astype(np.int64) << s) | np.asarray(p)
    np.testing.assert_array_equal(plain, ref)
    np.testing.assert_array_equal(
        emulate_split_wide(x, plan, bits, tc, rows), ref)
    if bits == 32:                   # the u64 instantiation agrees too
        np.testing.assert_array_equal(
            emulate_split_wide(x, plan, 64, tc, rows), ref)
    # some voxels find a nearer obstacle along the split axis
    assert ((ref >> (s + 1)) < v).any()


@pytest.mark.parametrize("t,s,a,bits", [
    (45, 20, 100, 32), (46, 20, 100, 64),        # either side of the edge
    (1, 30, 9, 32), (1, 31, 9, 64), (2, 30, 9, 64),   # on it, and past
    (50, 12, 30, 32),                             # t_local = 29 < t
    (100, 17, 800, 32), (100, 18, 1600, 64),      # the card's two maps
    (2000, 12, 400, 64), (2000, 9, 40, 32)])      # the wide tests' plans
def test_word_bits_edge(t, s, a, bits):
    """32-bit tile words exactly where the largest word the split
    compares, the largest tile word plus the largest k^2 << s, is below
    2^32."""
    plan = _plan(t, s)
    tl = min(t, a - 1)
    largest = ((plan["cap"] << s) | ((1 << s) - 1)) + ((tl * tl) << s)
    assert kernels.split_wide_word_bits(plan, a) == bits
    assert (largest <= M32) == (bits == 32)


def test_past_the_edge_u32_words_would_wrap():
    """One step past the edge (t = 46 at s = 20) a column whose side runs
    to k = t over far words: u32 words wrap there and pick a wrong word;
    the u64 words the kernel takes are right."""
    plan = _plan(46, 20)
    a, s, cap = 100, 20, plan["cap"]
    assert kernels.split_wide_word_bits(plan, a) == 64
    v = np.full((a, OUTER * INNER), cap)
    pay = np.full(v.shape, (1 << s) - 1)
    v[50] = cap - 1                  # side n of row 51 runs to k = 46
    x = (v.astype(np.int64) << s) | pay
    ref = _columns(tedt._split_wide_plain(_volume(x), plan, 1))
    np.testing.assert_array_equal(
        emulate_split_wide(x, plan, 64, 16, a), ref)
    assert not np.array_equal(emulate_split_wide(x, plan, 32, 16, a), ref)


@pytest.mark.parametrize("a,t,bits,chunked", [
    (800, 100, 32, False), (1600, 100, 64, True), (800, 100, 64, True),
    (400, 2000, 64, False)])
def test_tiles_for_residency(a, t, bits, chunked):
    """The chunks keep 16 columns and the block within its budget: four
    blocks an SM in u32, three in u64, of an H100's 228 KB (1 KB of it
    reserved a block), chunks as even as the column allows; the sizing
    gives ``TILES``' entry."""
    tl = min(t, a - 1)
    tc, rows = split_tiles(a, tl, bits)
    assert TILES[a, tl, bits] == (tc, rows)
    span = a if rows >= a or rows + 2 * tl >= a else rows + 2 * tl
    smem = split_smem(span, tc, bits)
    blocks = {32: 4, 64: 3}[bits]
    assert tc == COLS
    assert smem <= SMEM[bits]
    assert blocks * (smem + 1024) <= 228 * 1024
    assert (rows < a) == chunked
    if chunked:
        chunks = -(-a // rows)
        assert chunks * rows - a < chunks and rows >= MIN_ROWS
        assert split_smem(-(-a // (chunks - 1)) + 2 * tl, tc, bits) > \
            SMEM[bits]


def test_tiles_table():
    """``TILES``, the table the launcher is held to on the card, is the
    sizing's: 16 columns a block until a column of 8-byte words, too long
    to chunk past its halos, falls back to the bounded body's rule."""
    for (a, tl, bits), want in TILES.items():
        assert split_tiles(a, tl, bits) == want
