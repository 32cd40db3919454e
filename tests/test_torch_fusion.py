"""fiesta_tpu_torch's occupancy fusion against fiesta_tpu (CPU).

``fuse_counts`` (global and windowed), the drain the incremental engine
takes, and ``set_occupancy_direct`` in both ``probabilistic`` modes, with
duplicate and out-of-grid writes: the same numpy inputs through
``fiesta_tpu.ops.fusion`` (op by op, ``jax.disable_jit()``) and the port,
every output bit-equal.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu import FiestaConfig  # noqa: E402
from fiesta_tpu import grid as jgrid  # noqa: E402
from fiesta_tpu.ops import fusion as jfusion  # noqa: E402

import fiesta_tpu_torch as ft  # noqa: E402
from fiesta_tpu_torch import grid as tgrid  # noqa: E402
from fiesta_tpu_torch.ops import fusion as tfusion  # noqa: E402


def _cfg(probabilistic):
    return FiestaConfig(resolution=0.5, origin=(-3.0, -2.5, -1.0),
                        map_size=(6.0, 5.0, 3.5), probabilistic=probabilistic)


def _same(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    if got.dtype == np.float32:
        got, ref = got.view(np.int32), ref.view(np.int32)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _grids(cfg, seed):
    """Log-odds around the thresholds and the clamps, seen, counters."""
    rng = np.random.default_rng(seed)
    shape = cfg.grid_shape
    occ = cfg.min_occupancy_log
    lo = rng.choice(np.float32([0.0, cfg.clamp_min_log, cfg.clamp_max_log,
                                occ, occ - 0.2, occ + 0.2, 1.0, -0.4]),
                    size=shape).astype(np.float32)
    seen = (rng.random(shape) < 0.5).astype(np.uint8)
    miss = rng.integers(0, 4, size=shape).astype(np.uint8)
    hit = np.minimum(rng.integers(0, 4, size=shape), miss).astype(np.uint8)
    miss[0, 0, :3] = 255                       # saturated counters
    hit[0, 0, :3] = (255, 127, 128)
    return lo, seen, hit, miss


@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
@pytest.mark.parametrize("probabilistic", [True, False])
def test_fuse_counts_matches_jax(probabilistic, window):
    cfg = _cfg(probabilistic)
    tcfg = ft.config_from_fields(dataclasses.asdict(cfg))
    arrays = _grids(cfg, 3)
    wmask = None
    if window:
        wmin, wmax = np.array([2, 1, 0]), np.array([8, 7, 4])
        wmask = np.array(jgrid.window_mask(cfg, jnp.asarray(wmin),
                                           jnp.asarray(wmax)))
        _same(tgrid.window_mask(tcfg, torch.from_numpy(wmin),
                                torch.from_numpy(wmax)), wmask, "wmask")
    with jax.disable_jit():
        ref = jfusion.fuse_counts(cfg, *map(jnp.asarray, arrays),
                                  window_mask=None if wmask is None
                                  else jnp.asarray(wmask))
    got = tfusion.fuse_counts(tcfg, *map(torch.from_numpy, arrays),
                              window_mask=None if wmask is None
                              else torch.from_numpy(wmask))
    for f in ref._fields:
        _same(getattr(got, f), getattr(ref, f), f)
    assert int(got.num_observed) > 0 and got.delete_mask.any()
    # a deterministic map is occupied at log-odds == 1.0 exactly, which a
    # fusion step does not reach
    assert bool(got.insert_mask.any()) == probabilistic


@pytest.mark.parametrize("probabilistic", [True, False])
def test_set_occupancy_direct_matches_jax(probabilistic):
    """Duplicate writes (the later wins), writes outside the grid on every
    face (dropped), and flips both ways."""
    cfg = _cfg(probabilistic)
    tcfg = ft.config_from_fields(dataclasses.asdict(cfg))
    rng = np.random.default_rng(9)
    shape = np.array(cfg.grid_shape)
    lo = np.where(rng.random(cfg.grid_shape) < 0.3,
                  np.float32(cfg.clamp_max_log if probabilistic else 1.0),
                  np.float32(0.0)).astype(np.float32)
    vox = rng.integers(-2, shape + 2, size=(400, 3)).astype(np.int32)
    vox[200:260] = vox[:60]                    # duplicates, later wins
    vox[-6:] = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [shape[0], 0, 0],
                [0, shape[1], 0], [0, 0, shape[2]]]
    occ = rng.integers(0, 2, size=400).astype(np.int32)
    with jax.disable_jit():
        ref = jfusion.set_occupancy_direct(cfg, jnp.asarray(lo),
                                           jnp.asarray(vox), jnp.asarray(occ))
    got = tfusion.set_occupancy_direct(tcfg, torch.from_numpy(lo),
                                       torch.from_numpy(vox),
                                       torch.from_numpy(occ))
    for g, r, what in zip(got, ref, ("logodds", "insert", "delete")):
        _same(g, r, what)
    assert got[1].any() and got[2].any()
