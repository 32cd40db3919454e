"""fiesta_tpu_torch sort and sorted splat against fiesta_tpu (CPU).

The plain bitonic network (``ops.sort``) must equal
``fiesta_tpu.ops.pallas.sort.sort_pairs`` in interpret mode bit for bit,
keys and values, on the JAX package's own cases (heavy duplicates, drop
sentinels, N of 256, 1000 and 4096) and on N = 1 and a non-power of two.
The CUDA kernel's schedule (one launch: the tile sort, then per merge level
the strided merge and the tile finish, with grid barriers between), emulated
here in numpy block by block, must give the same keys and values at its
tile size and others, and each merge block's index set must hold every
partner of its stages.
The sorted splat must give the direct splat's seeds and masks, and the
JAX package's sorted splat's.
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu import FiestaConfig  # noqa: E402
from fiesta_tpu.ops import raycast as jrc  # noqa: E402
from fiesta_tpu.ops.pallas import sort as jsort  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import kernels  # noqa: E402
from fiesta_tpu_torch.ops import raycast as trc  # noqa: E402
from fiesta_tpu_torch.ops import sort as tsort  # noqa: E402


def _pairs(n, seed):
    """The interpret test's keys (``test_kernels_interpret.py:335-339``)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 25, n).astype(np.int32)
    keys[rng.integers(0, n, max(n // 5, 1))] = 777     # heavy duplicates
    keys[: n // 9] = 1 << 25                           # drop sentinels
    vals = rng.random(n).astype(np.float32)
    return keys, vals


@pytest.mark.parametrize("n", [1, 256, 300, 1000, 4096])
def test_sort_pairs_matches_pallas_interpret(n):
    keys, vals = _pairs(n, n)
    rk, rv = jsort.sort_pairs(jnp.asarray(keys), jnp.asarray(vals),
                              interpret=True)
    gk, gv = tsort.sort_pairs(torch.from_numpy(keys), torch.from_numpy(vals))
    assert gk.dtype == torch.int32 and gv.dtype == torch.float32
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(gv.numpy().view(np.int32),
                                  np.asarray(rv).view(np.int32))
    assert np.all(np.diff(gk.numpy()) >= 0)
    if n >= 9:
        assert (gk.numpy()[-(n // 9):] == 1 << 25).all()


def test_sort_ties_keep_their_pairs():
    """Strict compares: equal keys never swap, so the output is a function
    of the input (all keys equal and no pad: nothing moves)."""
    vals = np.arange(256, dtype=np.float32)
    k, v = tsort.sort_pairs(torch.zeros(256, dtype=torch.int32),
                            torch.from_numpy(vals))
    assert not k.any()
    np.testing.assert_array_equal(v.numpy(), vals)
    assert [kernels.sort_padded_size(n) for n in (1, 255, 256, 257, 4097)] \
        == [256, 256, 256, 512, 8192]


TILE_LOG = 11             # kernels/sort.cu kLogTile
MERGE_MAX_LOG_ROWS = 7    # kernels/sort.cu kMergeMaxLogRows
MERGE_LOG_PAIRS = 11      # kernels/sort.cu kMergeLogPairs
MERGE_MAX = 4096          # kernels/sort.cu kMergeMax: the merge block's pairs


def _schedule(n_pad, log_tile=TILE_LOG, max_log_rows=MERGE_MAX_LOG_ROWS):
    """The turns of ``sort_network`` (``kernels/sort.cu``), in order, with
    a grid barrier before each but the first: ("tiles", t, s_lo, s_hi) and
    ("merge", s, j_hi, j_lo, log_c)."""
    log_n = n_pad.bit_length() - 1
    t = min(log_n, log_tile)
    plan = [("tiles", t, 1, t)]
    for s in range(t + 1, log_n + 1):
        for j_hi in range(s - 1, t - 1, -max_log_rows):
            j_lo = max(t, j_hi - max_log_rows + 1)
            log_c = min(j_lo, max(5, MERGE_LOG_PAIRS - (j_hi - j_lo + 1)))
            plan.append(("merge", s, j_hi, j_lo, log_c))
        plan.append(("tiles", t, s, s))
    return plan


def _merge_sets(n_pad, j_hi, j_lo, log_c, blocks=None):
    """[blocks, pairs] global indices of the merge turn's blocks (all, or
    the ids ``blocks``), in each block's order (row = bits j_lo .. j_hi,
    column = bits below log_c)."""
    mid_bits = j_lo - log_c
    log_e = j_hi - j_lo + 1 + log_c
    if blocks is None:
        blocks = np.arange(n_pad >> log_e)
    b = np.asarray(blocks, np.int64)[:, None]
    e = np.arange(1 << log_e)[None, :]
    i0 = ((b >> mid_bits) << (j_hi + 1)) | ((b & ((1 << mid_bits) - 1))
                                             << log_c)
    return i0 | ((e >> log_c) << j_lo) | (e & ((1 << log_c) - 1))


def _tiles(k, v, t, s_lo, s_hi):
    """``tile_stages``: each contiguous tile of 2^t pairs through stages
    s_lo .. s_hi, j < min(s, t), each pair taking its partner's where the
    network puts it there (the register and shuffle form)."""
    i = np.arange(k.size).reshape(-1, 1 << t)
    k, v = k.reshape(i.shape), v.reshape(i.shape)
    e = np.arange(1 << t)
    for s in range(s_lo, s_hi + 1):
        for j in range(min(s, t) - 1, -1, -1):
            pk, pv = k[:, e ^ (1 << j)], v[:, e ^ (1 << j)]
            want_min = ((i >> j) & 1) == ((i >> s) & 1)
            take = np.where(want_min, pk < k, pk > k)
            k, v = np.where(take, pk, k), np.where(take, pv, v)
    return k.reshape(-1), v.reshape(-1)


def _merge(k, v, s, j_hi, j_lo, log_c):
    """``merge_stages``: gather each block's pairs, run stages j_hi .. j_lo
    as compare-exchanges in the block's own indexing with the block's one
    direction, scatter back."""
    idx = _merge_sets(k.size, j_hi, j_lo, log_c)
    bk, bv = k[idx], v[idx]
    asc = (((idx[:, :1] >> s) & 1) == 0)
    e = np.arange(idx.shape[1])
    for j in range(j_hi, j_lo - 1, -1):
        d = 1 << (j - j_lo + log_c)
        lo = e[(e & d) == 0]
        kl, kh = bk[:, lo], bk[:, lo + d]
        swap = np.where(asc, kh < kl, kh > kl)
        bk[:, lo], bk[:, lo + d] = (np.where(swap, kh, kl),
                                    np.where(swap, kl, kh))
        vl, vh = bv[:, lo], bv[:, lo + d]
        bv[:, lo], bv[:, lo + d] = (np.where(swap, vh, vl),
                                    np.where(swap, vl, vh))
    k, v = k.copy(), v.copy()
    k[idx], v[idx] = bk, bv
    return k, v


def _emulated_sort(keys, vals, log_tile=TILE_LOG,
                   max_log_rows=MERGE_MAX_LOG_ROWS):
    """The CUDA sort's schedule run in numpy on the padded pairs."""
    n = keys.size
    n_pad = kernels.sort_padded_size(n)
    k = np.full(n_pad, kernels.SORT_SENTINEL, np.int32)
    v = np.zeros(n_pad, np.float32)
    k[:n], v[:n] = keys, vals
    for turn in _schedule(n_pad, log_tile, max_log_rows):
        if turn[0] == "tiles":
            k, v = _tiles(k, v, *turn[1:])
        else:
            k, v = _merge(k, v, *turn[1:])
    return k[:n], v[:n]


@functools.lru_cache(maxsize=None)
def _pallas_sorted(n):
    keys, vals = _pairs(n, n)
    rk, rv = jsort.sort_pairs(jnp.asarray(keys), jnp.asarray(vals),
                              interpret=True)
    return np.asarray(rk), np.asarray(rv)


@pytest.mark.parametrize("log_tile", [TILE_LOG, 9, 13])
@pytest.mark.parametrize("n", [1, 255, 256, 4097, (1 << 15) + 3])
def test_kernel_schedule_matches_network(n, log_tile):
    """The CUDA sort's schedule (tile sort, per level the strided merge and
    the tile finish) gives the plain network's and the Pallas kernel's
    keys and values bit for bit, at the kernel's tiles of 2^11 pairs and at
    2^9 and 2^13 (the schedule is exact for any tile size)."""
    keys, vals = _pairs(n, n)
    gk, gv = _emulated_sort(keys, vals, log_tile)
    pk, pv = tsort._sort_pairs_plain(torch.from_numpy(keys),
                                     torch.from_numpy(vals))
    rk, rv = _pallas_sorted(n)
    for ref_k, ref_v in ((pk.numpy(), pv.numpy()), (rk, rv)):
        np.testing.assert_array_equal(gk, ref_k)
        np.testing.assert_array_equal(gv.view(np.int32),
                                      ref_v.view(np.int32))


@pytest.mark.parametrize("max_log_rows", [1, 2, 3])
def test_kernel_schedule_split_levels(max_log_rows):
    """Levels longer than one merge block split top down (the kernel does
    past 2^(t+7) pairs): the same keys and values at 2^16 pairs when a
    merge turn holds only 2^max_log_rows rows."""
    n = (1 << 15) + 3
    keys, vals = _pairs(n, n)
    plan = _schedule(1 << 16, 11, max_log_rows)
    assert len(plan) == 1 + sum(-(-(s - 11) // max_log_rows) + 1
                                for s in range(12, 17))
    gk, gv = _emulated_sort(keys, vals, 11, max_log_rows)
    rk, rv = _pallas_sorted(n)
    np.testing.assert_array_equal(gk, rk)
    np.testing.assert_array_equal(gv.view(np.int32), rv.view(np.int32))


@pytest.mark.parametrize("log_n", [8, 16, 18, 30])
def test_merge_sets_closed_under_their_stages(log_n):
    """Each merge block's pairs are closed under every partner i ^ 2^j of
    the turn's stages (the block's partner e ^ 2^(j - j_lo + log_c) is
    that pair), share bit s (one direction), read 32 or more contiguous
    pairs a row, fit the kernel's shared memory, and the blocks partition
    the array (at 2^30: 64 blocks drawn from seed 0, disjoint); the
    schedule has 1 + 2 (log2 n_pad - t) turns while a level fits one
    block (15 turns, 14 grid barriers, at the cow splat's 2^18)."""
    n_pad = 1 << log_n
    rng = np.random.default_rng(0)
    for log_tile in (TILE_LOG, 9, 13):
        plan = _schedule(n_pad, log_tile)
        t = plan[0][1]
        if log_n - t <= MERGE_MAX_LOG_ROWS:
            assert len(plan) == 1 + 2 * (log_n - t)
        for _, s, j_hi, j_lo, log_c in (p for p in plan if p[0] == "merge"):
            assert 5 <= log_c <= j_lo and s > j_hi >= j_lo >= t
            assert 1 << (j_hi - j_lo + 1 + log_c) <= MERGE_MAX
            n_blocks = n_pad >> (j_hi - j_lo + 1 + log_c)
            blocks = None
            if log_n > 20:
                blocks = np.unique(np.concatenate([
                    [0, n_blocks - 1], rng.integers(0, n_blocks, 62)]))
            idx = _merge_sets(n_pad, j_hi, j_lo, log_c, blocks)
            assert np.unique(idx).size == idx.size
            assert idx.min() >= 0 and idx.max() < n_pad
            if blocks is None:
                assert idx.size == n_pad
            e = np.arange(idx.shape[1])
            for j in range(j_lo, j_hi + 1):
                np.testing.assert_array_equal(
                    idx[:, e ^ (1 << (j - j_lo + log_c))], idx ^ (1 << j))
            assert (((idx >> s) & 1) == ((idx[:, :1] >> s) & 1)).all()
            assert (np.diff(idx[:, :32], axis=1) == 1).all()
    assert len(_schedule(1 << 18)) == 15     # the cow splat's sort


H, W = 24, 32


def _cfg():
    return dataclasses.replace(FiestaConfig(
        resolution=0.1, origin=(-2.4, -2.4, -1.0), map_size=(4.8, 4.8, 3.2),
        min_ray_length=0.3, max_ray_length=1.5), max_points_per_scan=H * W)


def _scans(k, p, seed):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-1.0, 1.0, (k, 3)).astype(np.float32)
    pts = (origins[:, None, :]
           + rng.uniform(-2.0, 2.0, (k, p, 3))).astype(np.float32)
    valid = rng.random((k, p)) < 0.9
    return pts, valid, origins


@pytest.mark.parametrize("impl", ["pallas", "lax"])
def test_sorted_splat_matches_direct_and_jax(monkeypatch, impl):
    """Both packages in sorted mode (the JAX package off a TPU sorts with
    ``lax.sort``) against the port's direct splat: seeds, masks and rays
    bit-equal."""
    cfg = _cfg()
    tc = ft.config_from_fields(dataclasses.asdict(cfg))
    pts, valid, origins = _scans(3, 600, 4)
    targs = [torch.from_numpy(a) for a in (pts, valid, origins)]
    direct = trc._scanline_seeds_batch(tc, *targs)
    monkeypatch.setattr(trc, "_SPLAT_ORDER", "sorted")
    monkeypatch.setattr(trc, "_SPLAT_SORT_IMPL", impl)
    monkeypatch.setattr(jrc, "_SPLAT_ORDER", "sorted")
    monkeypatch.setattr(jrc, "_SPLAT_SORT_IMPL", impl)
    got = trc._scanline_seeds_batch(tc, *targs)
    with jax.disable_jit():
        ref = jrc._scanline_seeds_batch(cfg, *(jnp.asarray(a) for a in
                                               (pts, valid, origins)))
    for i, (g, d, r) in enumerate(zip(got, direct, ref)):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype, i
        np.testing.assert_array_equal(g.numpy(), d.numpy(), err_msg=str(i))
        np.testing.assert_array_equal(g.numpy(), r, err_msg=str(i))
    assert int(got[3].sum()) > 0 and float(got[2].max()) > 0


def test_sorted_order_goes_through_sort_pairs(monkeypatch):
    """Under ``pallas`` the splat's pairs are sorted by ``ops.sort`` (the
    kernel on the card), ascending, drops last."""
    seen = []

    def spy(keys, vals):
        out = tsort._sort_pairs_plain(keys, vals)
        seen.append(out[0])
        return out

    monkeypatch.setattr(trc, "_SPLAT_ORDER", "sorted")
    monkeypatch.setattr(trc, "_SPLAT_SORT_IMPL", "pallas")
    monkeypatch.setattr(tsort, "sort_pairs", spy)
    tc = ft.config_from_fields(dataclasses.asdict(_cfg()))
    pts, valid, origins = _scans(2, 500, 5)
    trc._scanline_seeds_batch(tc, *(torch.from_numpy(a) for a in
                                    (pts, valid, origins)))
    assert len(seen) == 1
    keys = seen[0].numpy()
    box = trc._carve_box_shape(tc)
    assert np.all(np.diff(keys) >= 0) and keys[-1] == 2 * np.prod(box)
