"""fiesta_tpu_torch endpoint splat against fiesta_tpu (CPU).

The JAX reference runs op by op (``jax.disable_jit``): compiled, XLA:CPU
contracts ``a*b + c`` into fused multiply-adds and turns ``x / const``
into ``x * (1/const)``, neither of which is the IEEE expression both
packages write (ROADMAP queue C).  Op by op, every f32 output — seeds
included — must be bit-equal.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fiesta_tpu import FiestaConfig  # noqa: E402
from fiesta_tpu.ops import raycast as jrc  # noqa: E402

from fiesta_tpu_torch import config as tconfig  # noqa: E402
from fiesta_tpu_torch.ops import raycast as trc  # noqa: E402

ALIGNED = FiestaConfig(resolution=0.1, origin=(-2.4, -2.4, -1.0),
                       map_size=(4.8, 4.8, 3.2), min_ray_length=0.3,
                       max_ray_length=1.2)
UNALIGNED = FiestaConfig(resolution=0.1, origin=(-2.25, -2.15, -0.95),
                         map_size=(4.5, 4.3, 2.5), min_ray_length=0.3,
                         max_ray_length=1.2)


def _scans(cfg, k=3, p=600, seed=0):
    """K sensor-frame scans covering every ray class: hits, rays past
    max_ray (clipped free endpoints), rays leaving the carve box and the
    grid, too-short rays, NaN points, invalid flags and duplicate
    endpoints; sensors near the map faces so the box clamp binds."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(cfg.origin)
    hi = lo + np.asarray(cfg.map_size)
    tfs = np.zeros((k, 4, 4), np.float32)
    for i in range(k):
        a, b = rng.uniform(0, 2 * np.pi, 2)
        ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
        r = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]]) @ \
            np.array([[1, 0, 0], [0, cb, -sb], [0, sb, cb]])
        tfs[i, :3, :3] = r
        tfs[i, 3, 3] = 1
        tfs[i, :3, 3] = rng.uniform(lo + 0.2, hi - 0.2)
    tfs[0, :3, 3] = lo + 0.15                      # corner: clamp binds
    dirs = rng.normal(size=(k, p, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rng_len = rng.choice([0.1, 0.5, 0.9, 1.19, 1.2, 1.21, 2.0, 4.0, 9.0],
                         size=(k, p)) + rng.uniform(0, 0.05, (k, p))
    pts = (dirs * rng_len[..., None]).astype(np.float32)
    pts[:, :40] = pts[:, 40:80]                    # duplicate endpoints
    pts[:, 100:110, 1] = np.nan                    # NaN points
    pts[:, 110:115] = np.inf
    pts[:, 120:200] = 0.1 * np.round(pts[:, 120:200] * 10)  # voxel faces
    val = rng.uniform(size=(k, p)) < 0.9
    return pts, val, tfs


def _jax_seeds(cfg, pts, val, tfs=None, origins=None):
    with jax.disable_jit():
        out = jrc._scanline_seeds_batch(
            cfg, jnp.asarray(pts), jnp.asarray(val),
            None if origins is None else jnp.asarray(origins),
            transforms=None if tfs is None else jnp.asarray(tfs))
    return [np.asarray(o) for o in out]


def _torch_seeds(cfg, pts, val, tfs=None, origins=None):
    tc = tconfig.config_from_fields(dataclasses.asdict(cfg))
    out = trc._scanline_seeds_batch(
        tc, torch.from_numpy(pts), torch.from_numpy(val),
        None if origins is None else torch.from_numpy(origins),
        transforms=None if tfs is None else torch.from_numpy(tfs))
    return [o.numpy() for o in out]


_NAMES = ("starts", "po_box", "seeds", "hit_b", "epfree_b", "rvalid")


@pytest.mark.parametrize("frame", ["sensor", "world"])
@pytest.mark.parametrize("cfg", [ALIGNED, UNALIGNED],
                         ids=["aligned", "unaligned"])
def test_scanline_seeds_batch_matches_jax(cfg, frame):
    pts, val, tfs = _scans(cfg)
    if frame == "sensor":
        ref = _jax_seeds(cfg, pts, val, tfs=tfs)
        got = _torch_seeds(cfg, pts, val, tfs=tfs)
    else:
        world = (np.einsum("kij,kpj->kpi", tfs[:, :3, :3], pts)
                 + tfs[:, None, :3, 3]).astype(np.float32)
        origins = np.ascontiguousarray(tfs[:, :3, 3])
        ref = _jax_seeds(cfg, world, val, origins=origins)
        got = _torch_seeds(cfg, world, val, origins=origins)
    for name, r, g in zip(_NAMES, ref, got):
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    hit, ep = ref[3], ref[4]
    assert hit.sum() > 50 and ep.sum() > 20       # both classes present
    assert (ref[2] > 0).sum() > hit.sum() + ep.sum()   # exit-only seeds too


def test_seeds_decode_matches_jax():
    cfg = dataclasses.replace(ALIGNED, max_ray_length=3.0)
    thr_hi = 1000.0 + cfg.max_ray_length + cfg.resolution
    vals = np.random.default_rng(5).choice(
        [0.0, 999.9, 1000.0, thr_hi - 1e-4, thr_hi, np.nextafter(
            np.float32(thr_hi - 1e-4), np.float32(0)),
         1999.9, 2000.0, 2002.5], size=(1, 8, 8, 6)).astype(np.float32)
    with jax.disable_jit():
        ref = jrc._seeds_from_packed(cfg, jnp.asarray(vals))
    tc = tconfig.config_from_fields(dataclasses.asdict(cfg))
    got = trc._seeds_from_packed(torch.from_numpy(vals),
                                 trc._epfree_threshold(tc))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_splat_drops_out_of_range_and_keeps_max():
    lin = torch.tensor([3, 3, 5, 8, 8, 0], dtype=torch.int32)
    val = torch.tensor([1000.5, 2001.0, 1003.0, 2000.5, 9.0e9, 1000.25])
    seeds, hit, ep = trc.splat_packed(lin, val, 8, 1002.0 - 1000.0)
    np.testing.assert_array_equal(
        seeds.numpy(), np.float32([0.25, 0, 0, 1.0, 0, 3.0, 0, 0]))
    np.testing.assert_array_equal(hit.numpy(), [0, 0, 0, 1, 0, 0, 0, 0])
    np.testing.assert_array_equal(ep.numpy(), [0, 0, 0, 0, 0, 1, 0, 0])


def _splat_four_steps(lin, val, n, thr):
    """The CUDA splat's four launches (``kernels/splat.cu``) in torch: zero
    fills (seeds, then the masks beside the scatter), scatter-max on the
    int32 bit patterns, per-ray gather of the voxel's maximum, and per-ray
    decode written at the voxel."""
    seeds = torch.zeros(n, dtype=torch.float32)
    hit = torch.zeros(n, dtype=torch.uint8)
    epfree = torch.zeros(n, dtype=torch.uint8)
    at = lin[(lin >= 0) & (lin < n)].to(torch.int64)
    seeds.view(torch.int32).scatter_reduce_(
        0, at, val[(lin >= 0) & (lin < n)].view(torch.int32), "amax")
    p = seeds[at]                                    # a copy: the gather
    h = p >= 2000.0
    freeish = (p >= 1000.0) & (p < 2000.0)
    free_range = p - torch.tensor(1000.0)
    seeds[at] = torch.where(h, p - torch.tensor(2000.0),
                            torch.where(freeish, free_range,
                                        torch.tensor(0.0)))
    hit[at] = h.to(torch.uint8)
    epfree[at] = (freeish & (free_range >= thr)).to(torch.uint8)
    return seeds, hit, epfree


@pytest.mark.parametrize("n,r", [(1, 7), (4099, 5000), (60000, 5000),
                                 (3 * 20 * 20 * 8, 30000)])
def test_four_step_splat_matches_plain(n, r):
    """Decoding only the voxels a ray touched, after a dense zero fill,
    equals the dense decode of the plain splat bit for bit: duplicates,
    dropped indices (>= n), values on both sides of 2000 and on the class
    and threshold edges."""
    rng = np.random.default_rng(n)
    lin = rng.integers(0, n + 3, r).astype(np.int32)
    lin[: r // 10] = lin[r // 10: 2 * (r // 10)]               # duplicates
    thr = np.float32(1.2)
    val = (1000.0 + 2000.0 * rng.random(r)).astype(np.float32)
    val[::7] = rng.choice(np.float32([1000.0, 2000.0, 1000.0 + thr,
                                      np.nextafter(np.float32(2000.0), 0),
                                      2000.0 + thr]), val[::7].size)
    lin_t, val_t = torch.from_numpy(lin), torch.from_numpy(val)
    got = _splat_four_steps(lin_t, val_t, n, float(thr))
    ref = trc._splat_packed_plain(lin_t, val_t, n, float(thr))
    for g, f in zip(got, ref):
        assert g.dtype == f.dtype
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      f.numpy().view(np.uint8))
    assert bool((lin >= n).any())
    if n > 1:
        assert int(ref[1].sum()) > 0 and int(ref[2].sum()) > 0
    # no rays: the fill alone is the splat
    none = torch.zeros(0, dtype=torch.int32), torch.zeros(0)
    for g, f in zip(_splat_four_steps(*none, n, float(thr)),
                    trc._splat_packed_plain(*none, n, float(thr))):
        np.testing.assert_array_equal(g.numpy(), f.numpy())


def test_box_placement_matches_jax():
    rng = np.random.default_rng(3)
    for cfg in (ALIGNED, UNALIGNED):
        tc = tconfig.config_from_fields(dataclasses.asdict(cfg))
        assert trc._carve_box_shape(tc) == jrc._carve_box_shape(cfg)
        assert trc._carve_reach(tc) == jrc._carve_reach(cfg)
        po = rng.uniform(-5, 55, (256, 3)).astype(np.float32)
        po[:32] = np.round(po[:32]) + 0.5          # round-half-even ties
        ref = np.asarray(jrc._box_starts(cfg, jnp.asarray(po)))
        got = trc._box_starts(tc, torch.from_numpy(po)).numpy()
        np.testing.assert_array_equal(got, ref)


def test_flat_index_overflow_guard():
    cfg = FiestaConfig(resolution=0.02, origin=(0.0, 0.0, 0.0),
                       map_size=(20.0, 20.0, 20.0), max_ray_length=5.0)
    tc = tconfig.config_from_fields(dataclasses.asdict(cfg))
    k = 16                      # 16 x 520 x 520 x 509 box voxels > 2^31
    assert k * np.prod(trc._carve_box_shape(tc)) >= 2**31
    pts = torch.zeros((k, 4, 3))
    with pytest.raises(ValueError, match="overflows int32"):
        trc._scanline_seeds_batch(tc, pts, torch.ones((k, 4), dtype=bool),
                                  torch.zeros((k, 3)))


def test_prep_kernel_registered():
    """The ``prep`` kernel's entry: its source, C symbol and launch
    counter, an argument list as long as the C entry's (the stream
    included), and a ``__global__`` the benchmark's reader of
    hand-written kernels finds (so its time is not counted as plain ops)."""
    import re

    from esdfbench import trace
    from fiesta_tpu_torch import kernels

    src, sym, argtypes = kernels._SIGNATURES["prep"]
    assert (src, sym) == ("prep.cu", "fiesta_prep")
    assert src in kernels.SOURCES and kernels.LAUNCHES["prep"] == 0
    text = (kernels._HERE / src).read_text()
    params = re.search(rf"int {sym}\(([^)]*)\)", text).group(1)
    assert len(params.split(",")) == len(argtypes)
    assert "prep_kernel" in trace.hand_kernel_names(kernels._HERE)


def test_prep_kernel_wants_cuda_tensors():
    """A CPU tensor never reaches the kernel: the wrapper refuses it, and
    the prep routes CPU tensors to the plain version."""
    from fiesta_tpu_torch import kernels

    tc = tconfig.config_from_fields(dataclasses.asdict(UNALIGNED))
    pts, val, tfs = (torch.from_numpy(a) for a in _scans(UNALIGNED, k=2))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.prep(pts, val, transforms=tfs, **trc._prep_geometry(tc))
    got = trc._scanline_splat_prep(tc, pts, val, transforms=tfs)
    ref = trc._scanline_splat_prep_plain(tc, pts, val, transforms=tfs)
    for g, r in zip(got, ref):      # bit for bit, NaN values included
        if g.dtype == torch.float32:
            g, r = g.view(torch.int32), r.view(torch.int32)
        assert torch.equal(g, r)
    assert kernels.LAUNCHES["prep"] == 0


@pytest.mark.parametrize("cfg", [ALIGNED, UNALIGNED],
                         ids=["aligned", "unaligned"])
def test_prep_geometry(cfg):
    """The kernel's per-config arguments are the plain prep's: the box,
    its alignment, and the placement extent that ``_box_starts`` clamps
    with, min(grid, 2r + 1)."""
    tc = tconfig.config_from_fields(dataclasses.asdict(cfg))
    geo = trc._prep_geometry(tc)
    e = 2 * jrc._carve_reach(cfg) + 1
    assert geo["box"] == jrc._carve_box_shape(cfg)
    assert geo["extent"] == tuple(min(g, e) for g in cfg.grid_shape)
    assert geo["aligned"] == (cfg is ALIGNED)
    assert (geo["origin"], geo["res"], geo["min_ray"], geo["max_ray"]) == (
        cfg.origin, cfg.resolution, cfg.min_ray_length, cfg.max_ray_length)
