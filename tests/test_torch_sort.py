"""fiesta_tpu_torch sort and sorted splat against fiesta_tpu (CPU).

The plain bitonic network (``ops.sort``) must equal
``fiesta_tpu.ops.pallas.sort.sort_pairs`` in interpret mode bit for bit,
keys and values, on the JAX package's own cases (heavy duplicates, drop
sentinels, N of 256, 1000 and 4096) and on N = 1 and a non-power of two.
The sorted splat must give the direct splat's seeds and masks, and the
JAX package's sorted splat's.
"""

import dataclasses

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
