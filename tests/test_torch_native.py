"""fiesta_tpu_torch's binding to the C++ core against fiesta_tpu's (CPU).

Both bindings load ``native/libfiesta_core.so`` (built from
``native/Makefile``).  On one seeded stream of insert and delete batches
the port's ``NativeEsdf`` gives ``fiesta_tpu.native``'s expansion counts,
squared distances and closest-obstacle indices after every update; its
shape guard raises before the library could read past a buffer; and its
build (``make`` into a file of the process, then a rename) leaves a
library that loads.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

from fiesta_tpu import native as jnative  # noqa: E402

from fiesta_tpu_torch import native as tnative  # noqa: E402


def _stream(shape, seed, steps=4):
    """Batches of (voxels [N,3] i32, flags [N] u8): random blocks inserted,
    then some of the occupied voxels deleted, alternately."""
    rng = np.random.default_rng(seed)
    occ = np.zeros(shape, bool)
    out = []
    for k in range(steps):
        if k % 2 == 0:
            lo = rng.integers(0, np.array(shape) - 4, (3, 3))
            hi = lo + rng.integers(1, 5, (3, 3))
            new = np.zeros(shape, bool)
            for a, b in zip(lo, hi):
                new[a[0]:b[0], a[1]:b[1], a[2]:b[2]] = True
            vox = np.argwhere(new & ~occ)
            occ |= new
            flags = np.ones(len(vox), np.uint8)
        else:
            cand = np.argwhere(occ)
            vox = cand[rng.random(len(cand)) < 0.4]
            occ[tuple(vox.T)] = False
            flags = np.zeros(len(vox), np.uint8)
        out.append((vox.astype(np.int32), flags))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_native_esdf_matches_fiesta_tpu(seed):
    shape = (20, 16, 12)
    ours, theirs = tnative.NativeEsdf(shape), jnative.NativeEsdf(shape)
    assert ours.shape == theirs.shape == shape
    for vox, flags in _stream(shape, seed):
        assert len(vox)
        ours.set_occupancy(vox, flags)
        theirs.set_occupancy(vox, flags)
        n = ours.update()
        assert isinstance(n, int) and n == theirs.update()
        for got, want in ((ours.dist2(), theirs.dist2()),
                          (ours.closest(), theirs.closest())):
            assert got.dtype == np.int64 and got.shape == shape
            np.testing.assert_array_equal(got, want)
    d2 = ours.dist2()
    assert (d2 == 0).any() and (d2 > 0).any()


def test_shape_guard_raises():
    core = tnative.NativeEsdf((4, 4, 4))
    with pytest.raises(ValueError, match="to match occ"):
        core.set_occupancy(np.zeros((3, 2), np.int32),
                           np.ones(3, np.uint8))
    with pytest.raises(ValueError, match="to match occ"):
        core.set_occupancy(np.zeros((2, 3), np.int32),
                           np.ones(3, np.uint8))
    core.set_occupancy(np.zeros((1, 3), np.int32), np.ones(1, np.uint8))
    assert core.update() > 0


def test_build_renames_into_place():
    tnative._build()
    assert os.path.exists(tnative._LIB_PATH)
    assert not [f for f in os.listdir(tnative._NATIVE_DIR)
                if f.endswith(f".{os.getpid()}.tmp")]
    assert tnative.available()
