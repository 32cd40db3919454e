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
