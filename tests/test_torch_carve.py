"""fiesta_tpu_torch free-space carve against fiesta_tpu (CPU).

The port's plain carve (what a CPU tensor takes, and what the CUDA kernel
is held to on the card) against the JAX carve's XLA form and against the
TPU Pallas kernel in interpret mode, on the fixture of
``tests/test_kernels_interpret.py`` and on a non-square box.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu.config import FiestaConfig  # noqa: E402
from fiesta_tpu.ops import raycast as jrc  # noqa: E402

from fiesta_tpu_torch import config as tconfig  # noqa: E402
from fiesta_tpu_torch.ops import raycast as trc  # noqa: E402

SQUARE = FiestaConfig(resolution=0.2, map_size=(12.0, 12.0, 4.8),
                      origin=(-6.0, -6.0, -2.4), min_ray_length=0.3,
                      max_ray_length=3.0)
# y extent (10 voxels) below the reach box (29): BX != BY
NON_SQUARE = FiestaConfig(resolution=0.2, map_size=(12.0, 2.0, 4.8),
                          origin=(-6.0, -1.0, -2.4), min_ray_length=0.3,
                          max_ray_length=2.0)


def _seeds(cfg, seed):
    """The interpret test's scene: K=2 world-frame scans of 400 points."""
    rng = np.random.default_rng(seed)
    k, p = 2, 400
    origins = rng.uniform(-2, 2, (k, 3)).astype(np.float32)
    origins[:, 1] *= cfg.map_size[1] / 12.0
    origins[:, 2] *= 0.4
    pts = (origins[:, None, :]
           + rng.uniform(-4, 4, (k, p, 3))).astype(np.float32)
    val = rng.uniform(size=(k, p)) < 0.9
    seeds_fn = jax.vmap(lambda pp, v, o: jrc._scanline_seeds(cfg, pp, v, o))
    _, po_box, seeds, _, _, _ = seeds_fn(
        jnp.asarray(pts), jnp.asarray(val), jnp.asarray(origins))
    return np.asarray(seeds), np.asarray(po_box)


def _plain(cfg, seeds, po):
    tc = tconfig.config_from_fields(dataclasses.asdict(cfg))
    free = trc.carve_free_mask_batch(tc, torch.tensor(seeds),
                                     torch.tensor(po))
    assert free.dtype == torch.bool and free.shape == seeds.shape
    return free.numpy()


@pytest.mark.parametrize("cfg", [SQUARE, NON_SQUARE],
                         ids=["square", "non_square"])
def test_carve_matches_xla(cfg):
    seeds, po = _seeds(cfg, 3)
    assert (seeds.shape[1] == seeds.shape[2]) == (cfg is SQUARE)
    got = _plain(cfg, seeds, po)
    ref = np.asarray(jax.jit(jrc.carve_free_mask_batch, static_argnums=0)(
        cfg, jnp.asarray(seeds), jnp.asarray(po)))
    np.testing.assert_array_equal(got, ref)
    assert ref.any() and not ref.all()


@pytest.mark.parametrize("cfg", [SQUARE, NON_SQUARE],
                         ids=["square", "non_square"])
def test_carve_matches_pallas_interpret(cfg):
    """The TPU kernel sums r2 as (d_axis^2 + d_c2^2) + d_c3^2 per
    orientation (ops/pallas/carve.py:267-269); the port keeps the XLA
    form's (dx^2 + dy^2) + dz^2.  On these fixtures the two orders agree
    on every voxel."""
    seeds, po = _seeds(cfg, 3)
    got = _plain(cfg, seeds, po)
    ref = np.asarray(jrc._carve_free_tpu(cfg, jnp.asarray(seeds),
                                         jnp.asarray(po), interpret=True,
                                         io_mode="relayout"))
    np.testing.assert_array_equal(got, ref)


def test_taps_and_shift_match_xla():
    rng = np.random.default_rng(9)
    carry = rng.uniform(0, 3, (4, 9, 7)).astype(np.float32)
    f2 = rng.uniform(-1.5, 1.5, (4, 9)).astype(np.float32)
    f3 = rng.uniform(-1.5, 1.5, (4, 7)).astype(np.float32)
    f2[0, :5] = [-2.0, -1.0, 0.0, 1.0, 2.0]        # integer tap edges
    ref = np.asarray(jrc._taps_max_b(jnp.asarray(carry), jnp.asarray(f2),
                                     jnp.asarray(f3)))
    got = trc._taps_max_b(torch.from_numpy(carry), torch.from_numpy(f2),
                          torch.from_numpy(f3)).numpy()
    np.testing.assert_array_equal(got, ref)
    for dy, dz in ((1, 0), (-2, 0), (0, 3), (-1, -1)):
        np.testing.assert_array_equal(
            trc._shift2d_b(torch.from_numpy(carry), dy, dz).numpy(),
            np.asarray(jrc._shift2d_b(jnp.asarray(carry), dy, dz)))


# ---------------------------------------------------------------------------
# The CUDA kernel's schedule (kernels/carve.cu), emulated in torch on the CPU
# ---------------------------------------------------------------------------


def _orient_dims(shape, o):
    """(A, C2, C3) of orientation o for a box (BX, BY, BZ), as carve.cu's
    ``orient_dims``."""
    bx, by, bz = shape
    return ((bx, by, bz), (by, bx, bz), (bz, bx, by))[o]


def _cut_wavefronts(cfg, seeds, po):
    """carve.cu's sweep on the CPU: each of the K * 6 wavefronts walks
    only its half-space (the forward one while f32(idx) - po <= 0, the
    reverse one while > 0), its tap offsets from tables of the rows' and
    columns' floor(o / d), and stores only 1s into a zeroed mask.  Returns
    (free mask bool, {(k, o, dir): steps walked})."""
    f32 = torch.float32
    k_n = seeds.shape[0]
    box = tuple(seeds.shape[1:])
    res = torch.tensor(np.float32(cfg.resolution))
    inv_res = torch.tensor(np.float32(1.0 / cfg.resolution))
    min2 = torch.tensor(np.float32((cfg.min_ray_length / cfg.resolution)
                                   ** 2))
    max2 = torch.tensor(np.float32((cfg.max_ray_length / cfg.resolution)
                                   ** 2))
    mask = torch.zeros(seeds.shape, dtype=torch.uint8)
    steps = {}
    for k in range(k_n):
        p = po[k]
        for o in range(3):
            a, c2, c3 = _orient_dims(box, o)
            pr, pc = p[1 if o == 0 else 0], p[1 if o == 2 else 2]
            rows = torch.arange(c2, dtype=f32)
            cols = torch.arange(c3, dtype=f32)
            # the slab's voxel coordinates, [C2, C3] each
            r_i = torch.arange(c2)[:, None].expand(c2, c3)
            c_i = torch.arange(c3)[None, :].expand(c2, c3)
            for direction in (0, 1):
                carry = torch.zeros((c2, c3), dtype=f32)
                s = 0
                while True:
                    idx = s if direction == 0 else a - 1 - s
                    if not 0 <= idx < a:
                        break
                    dax = torch.tensor(float(idx), dtype=f32) - p[o]
                    if not bool(dax <= 0 if direction == 0 else dax > 0):
                        break
                    tap = torch.zeros((c2, c3), dtype=f32)
                    if s > 0:
                        d = torch.clamp(dax.abs(), min=0.5)
                        b2 = torch.floor((rows - pr) / d)
                        b3 = torch.floor((cols - pc) / d)
                        # zero pad: carries are >= 0, so a tap out of the
                        # plane never wins the max, as the kernel skips it
                        old = torch.nn.functional.pad(carry, (1, 1, 1, 1))
                        for d2 in (-1, 0, 1):
                            m2 = (b2 == d2) | (b2 == d2 - 1)
                            for d3 in (-1, 0, 1):
                                m3 = (b3 == d3) | (b3 == d3 - 1)
                                sh = old[1 + d2:1 + d2 + c2,
                                         1 + d3:1 + d3 + c3]
                                tap = torch.maximum(tap, torch.where(
                                    m2[:, None] & m3[None, :], sh, 0.0))
                    full = torch.full((c2, c3), idx)
                    x, y, z = ((full, r_i, c_i), (r_i, full, c_i),
                               (r_i, c_i, full))[o]
                    dx = x.to(f32) - p[0]
                    dy = y.to(f32) - p[1]
                    dz = z.to(f32) - p[2]
                    adx, ady, adz = dx.abs(), dy.abs(), dz.abs()
                    octx = (adx >= ady) & (adx >= adz)
                    octy = ~octx & (ady >= adz)
                    in_oct = (octx, octy, ~octx & ~octy)[o]
                    seed = seeds[k, x, y, z]
                    w = torch.maximum(torch.where(in_oct, seed, 0.0), tap)
                    r2 = (dx * dx + dy * dy) + dz * dz
                    wv = (w - res) * inv_res
                    free = ((w > res) & (r2 >= min2) & (r2 <= max2)
                            & (r2 < wv * wv))
                    mask[k, x[free], y[free], z[free]] = 1
                    carry = w
                    s += 1
                steps[(k, o, direction)] = s
    return mask.view(torch.bool), steps


def _synthetic(shape, po, res, seed, density=0.02):
    """Seeds [K, *shape] f32: a sparse set of voxels holding their range
    from the sensor (metres, a little beyond), and po [K, 3] as given."""
    rng = np.random.default_rng(seed)
    po = np.asarray(po, np.float32)
    k = po.shape[0]
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in shape],
                                indexing="ij"), -1).astype(np.float32)
    rng_m = np.linalg.norm(grid[None] - po[:, None, None, None], axis=-1)
    keep = rng.uniform(size=(k,) + tuple(shape)) < density
    val = (rng_m * res + rng.uniform(0.0, 0.1, keep.shape)).astype(np.float32)
    return np.where(keep, val, 0.0).astype(np.float32), po


DEMO_LIKE = FiestaConfig(resolution=0.1, map_size=(12.0, 12.0, 3.6),
                         origin=(-6.0, -6.0, -1.8), min_ray_length=0.3,
                         max_ray_length=6.0)
SHAPE = (23, 17, 11)


def _fixture(name):
    """(cfg, seeds, po) of each schedule fixture."""
    if name in ("square", "non_square"):
        cfg = SQUARE if name == "square" else NON_SQUARE
        return (cfg,) + _seeds(cfg, 3)
    if name == "k1":
        seeds, po = _seeds(SQUARE, 5)
        return SQUARE, seeds[:1], po[:1]
    pos = {
        # on an integer slab of every axis
        "integer_slab": [[11.0, 8.0, 5.0], [3.0, 16.0, 0.0]],
        # on the low and the high face of a box axis
        "at_face": [[0.0, 8.5, 5.5], [22.0, 16.0, 10.0]],
        # outside the box, below and above
        "outside": [[-3.5, 8.2, 5.1], [25.25, -2.0, 13.0]],
    }
    if name == "demo_box":
        box = (120, 120, 36)
        seeds, po = _synthetic(box, [[61.3, 58.7, 17.2]], 0.1, 4,
                               density=0.005)
        return DEMO_LIKE, seeds, po
    seeds, po = _synthetic(SHAPE, pos[name], SQUARE.resolution, len(name))
    return SQUARE, seeds, po


FIXTURES = ["square", "non_square", "k1", "integer_slab", "at_face",
            "outside", "demo_box"]


@pytest.mark.parametrize("name", FIXTURES)
def test_cut_wavefronts_match_plain_and_xla(name):
    """The kernel's schedule (half-space walks, carry over steps, three
    orientations into one mask) equals the plain carve and the JAX
    carve's XLA form; each orientation walks every slab exactly once."""
    cfg, seeds, po = _fixture(name)
    got, steps = _cut_wavefronts(cfg, torch.tensor(seeds), torch.tensor(po))
    plain = _plain(cfg, seeds, po)
    np.testing.assert_array_equal(got.numpy(), plain)
    ref = np.asarray(jax.jit(jrc.carve_free_mask_batch, static_argnums=0)(
        cfg, jnp.asarray(seeds), jnp.asarray(po)))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.any()
    for k in range(seeds.shape[0]):
        for o in range(3):
            a = _orient_dims(seeds.shape[1:], o)[0]
            assert steps[(k, o, 0)] + steps[(k, o, 1)] == a
    if name == "outside":
        # a sensor outside the box: one direction walks the whole axis,
        # the other nothing
        assert steps[(0, 0, 0)] == 0 and steps[(0, 0, 1)] == SHAPE[0]
        assert steps[(1, 0, 0)] == SHAPE[0] and steps[(1, 0, 1)] == 0
    if name == "integer_slab":
        # the sensor's own slab (d = 0) belongs to the forward walk
        assert steps[(0, 0, 0)] == 12 and steps[(1, 2, 0)] == 1


@pytest.mark.parametrize("name", ["k1", "integer_slab", "at_face",
                                  "outside"])
def test_cut_wavefronts_match_pallas_interpret(name):
    cfg, seeds, po = _fixture(name)
    got, _ = _cut_wavefronts(cfg, torch.tensor(seeds), torch.tensor(po))
    ref = np.asarray(jrc._carve_free_tpu(cfg, jnp.asarray(seeds),
                                         jnp.asarray(po), interpret=True,
                                         io_mode="relayout"))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("c2", [1, 5, 80, 216])
@pytest.mark.parametrize("cs", [1, 2, 8, 16])
def test_cluster_bands_cover_the_plane(c2, cs):
    """carve.cu splits a plane's C2 rows into bands of R = ceil(C2 / CS)
    rows, one per block; a tap row j2 = i2 +- 1 outside a band is the
    previous block's last row or the next block's first: every row lies
    in exactly one band, and each neighbour row so addressed exists."""
    r = -(-c2 // cs)
    owner = {}
    for rank in range(cs):
        lo = rank * r
        for i in range(max(0, min(r, c2 - lo))):
            assert lo + i not in owner
            owner[lo + i] = (rank, i)
    assert sorted(owner) == list(range(c2))
    for i2, (rank, _) in owner.items():
        lo = rank * r
        for j2 in (i2 - 1, i2 + 1):
            if not 0 <= j2 < c2:
                continue
            if j2 < lo:
                assert owner[j2] == (rank - 1, r - 1)
            elif j2 >= lo + r:
                assert owner[j2] == (rank + 1, 0)
            else:
                assert owner[j2] == (rank, j2 - lo)
