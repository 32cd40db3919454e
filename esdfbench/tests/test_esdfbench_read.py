"""The planner's read after each tick (a mix with ``reads``) and the
checks of the read and of a kept closest grid: true for the program as
it is, false for the read or the closest grid broken underneath, and
the ticks of a mix without reads as they were."""

import types

import pytest
import torch

from conftest import run_small
from esdfbench import check, control, generator, harness, spec


def _stale_grid(lag):
    """A distance grid cached on the wrong key: the one built ``lag``
    calls before (``None``: the first one, never rebuilt)."""
    def fault(query):
        real = query.distance_grid
        built = []

        def grid(cfg, d2, seen):
            built.append(real(cfg, d2, seen))
            if lag is None:
                return built[0]
            del built[:-lag - 1]
            return built[0]
        return "distance_grid", grid, "query_dist"
    fault.__name__ = f"stale_grid_{lag}"
    return fault


def _gradient_ulp(query):
    """One gradient component off by one ulp."""
    real = query.get_dist_grad_trilinear

    def read(*a, **k):
        dist, grad = real(*a, **k)
        grad = grad.clone()
        g = grad.view(-1, 3)
        g[0, 1] = torch.nextafter(g[0, 1], torch.tensor(float("inf")))
        return dist, grad
    return "get_dist_grad_trilinear", read, "query_grad"


def _distance_altered(query):
    """One sample's distance altered where it is read."""
    real = query.get_distance

    def read(*a, **k):
        dist = real(*a, **k).clone()
        dist.view(-1)[dist.numel() // 2] += 0.5
        return dist
    return "get_distance", read, "query_dist"


@pytest.mark.parametrize("fault", [None, _stale_grid(1), _stale_grid(None),
                                   _gradient_ulp, _distance_altered])
def test_read_faults_fail_their_check(small_root, monkeypatch, fault):
    from fiesta_tpu_torch.ops import query

    if fault is not None:
        name, patched, caught = fault(query)
        monkeypatch.setattr(query, name, patched)
    result = run_small(small_root, "small_cow_read")
    checks = result["checks"]
    assert {"query_dist", "query_grad"} <= set(checks)
    assert "closest" not in checks
    assert result["correct"] is (fault is None), checks
    if fault is not None:
        assert checks[caught]["value"] > 0, checks


def moved_to_free_voxel(closest, occupied):
    """``closest`` (packed) with one defined entry moved to a free voxel at
    the same distance: its obstacle reflected through the voxel."""
    gx, gy, gz = occupied.shape
    p = closest.reshape(-1).to(torch.int64)
    idx = torch.arange(p.numel())
    v = torch.stack([idx // (gy * gz), idx // gz % gy, idx % gz], -1)
    u = torch.stack([p >> 20, (p >> 10) & 1023, p & 1023], -1)
    w = 2 * v - u
    hi = torch.tensor([gx, gy, gz])
    inside = ((w >= 0) & (w < hi)).all(-1)
    wc = torch.where(inside[:, None], w, 0)
    free = ~occupied.reshape(-1)[(wc[:, 0] * gy + wc[:, 1]) * gz + wc[:, 2]]
    ok = torch.nonzero((p >= 0) & (u != v).any(-1) & inside & free)
    if not len(ok):          # an early map with no such entry
        return closest
    k = int(ok[0])
    out = closest.clone()
    out.view(-1)[k] = int((w[k, 0] << 20) | (w[k, 1] << 10) | w[k, 2])
    return out


def _eager_entry_dropped(cfg, state):
    closest = state.closest.clone()
    defined = torch.nonzero(closest.view(-1) >= 0)
    if len(defined):
        closest.view(-1)[int(defined[0])] = -1
    return closest


def _eager_entry_moved(cfg, state):
    from fiesta_tpu_torch import occupied_grid

    return moved_to_free_voxel(state.closest,
                               occupied_grid(cfg, state.logodds))


@pytest.mark.parametrize("fault", [None, _eager_entry_dropped,
                                   _eager_entry_moved])
def test_eager_closest_state_is_checked(small_root, monkeypatch, fault):
    """An eager map's ``state.closest`` is held to the reference: a correct
    one passes ``untouched`` and ``closest``; an entry dropped, or moved
    to a free voxel at the same distance, fails ``closest``."""
    import dataclasses

    from fiesta_tpu_torch import pipeline

    if fault is not None:
        real = pipeline.fused_batch_step

        def step(cfg, state, *a, **k):
            state, stats = real(cfg, state, *a, **k)
            return dataclasses.replace(state,
                                       closest=fault(cfg, state)), stats
        monkeypatch.setattr(pipeline, "fused_batch_step", step)
    result = run_small(small_root, "small_cow_eager")
    checks = result["checks"]
    assert checks["untouched"]["value"] == 0
    assert "query_dist" not in checks
    assert result["correct"] is (fault is None), checks
    assert (checks["closest"]["value"] == 0) is (fault is None)


def test_ticks_without_reads_make_the_same_calls(small_root, monkeypatch):
    """Without ``reads`` a tick is the tick entry's call alone, with the
    same arguments; with them the planner's read follows it in the same
    call, on the tick's map at the orbit tick's positions."""
    import fiesta_tpu_torch as ft
    from fiesta_tpu_torch import pipeline
    from fiesta_tpu_torch.ops import query

    calls = []

    def spy(name, real):
        def f(*a, **k):
            calls.append((name, a, k))
            return real(*a, **k)
        return f

    monkeypatch.setattr(pipeline, "fused_batch_step",
                        spy("tick", pipeline.fused_batch_step))
    for name in ("distance_grid", "get_distance", "get_dist_grad_trilinear"):
        monkeypatch.setattr(query, name, spy(name, getattr(query, name)))
    dev = torch.device("cpu")
    for cell_name, reads in (("small_cow", False),
                             ("small_cow_read", True)):
        cell = spec.load_cell(cell_name, small_root)
        cfg = ft.config_from_fields(cell.fields).validate()
        stream = generator.make_stream(cell.fields, cell.traffic, 3, dev)
        ticks = harness.Ticks(cfg, stream)
        state = ft.make_state(cfg, dev)
        calls.clear()
        k = stream.scans_per_tick
        new, _ = ticks(state, stream.ticks_per_orbit + 2)  # orbit tick 2
        assert [c[0] for c in calls] == (
            ["tick", "distance_grid", "get_distance",
             "get_dist_grad_trilinear"] if reads else ["tick"])
        _, args, kwargs = calls[0]
        assert args[0] is cfg and args[1] is state
        for got, want in zip(args[2:], (
                stream.points[2 * k:3 * k], stream.valid[2 * k:3 * k],
                stream.transforms[2 * k:3 * k],
                stream.positions[3 * k - 1])):
            assert torch.equal(torch.nan_to_num(got),
                               torch.nan_to_num(want))
        assert kwargs == {"use_window": False, "method": "scanline"}
        if not reads:
            assert ticks.last_read is None and ticks.read_ms is None
            continue
        assert calls[1][1][1] is new.d2 and calls[1][1][2] is new.seen
        samples, refine = stream.reads.at(2)
        assert torch.equal(calls[2][1][2], samples)
        assert torch.equal(calls[3][1][2], refine)
        assert calls[3][2] == {"out_value": -1.0}
        assert ticks.last_read.orbit_tick == 2 and ticks.read_ms > 0


def test_read_positions_from_the_seed_around_the_robot(small_root):
    cell = spec.load_cell("small_cow_read", small_root)
    spec_ = cell.traffic["reads"]
    dev = torch.device("cpu")
    a, b, c = (generator.make_stream(cell.fields, cell.traffic, s, dev).reads
               for s in (2 ** 33 + 1, 2 ** 33 + 1, 2 ** 33 + 2))
    assert torch.equal(a.samples, b.samples)
    assert not torch.equal(a.samples, c.samples)
    h, k, r = spec_["horizon"], spec_["rollouts"], spec_["refine_steps"] + 1
    assert a.samples.shape == (h, k, 3) == c.samples.shape
    assert torch.equal(a.refine, a.samples[:, :r].movedim(1, 0))
    # from rest: each step moves at most v_max * dt along an axis
    step = torch.diff(a.samples, dim=0, prepend=torch.zeros(1, k, 3)).abs()
    assert bool((step <= spec_["v_max"] * spec_["dt"] + 1e-5).all())
    # read at each tick's sensor position; some leave the map's box
    samples, refine = a.at(3)
    pose = a.poses[3]
    assert torch.equal(samples, pose + a.samples)
    assert torch.equal(refine, pose + a.refine)
    lo = torch.tensor(cell.fields["origin"])
    hi = lo + torch.tensor(cell.fields["map_size"])
    inside = ((samples >= lo) & (samples <= hi)).all(-1)
    assert 0 < int(inside.sum()) < inside.numel()


def test_control_fails_the_read_checks(small_root):
    cell = spec.load_cell("small_cow_read", small_root)
    checks, ok = control.readings(cell, 11, 20, torch.device("cpu"))
    assert not ok
    by = {c.name: c for c in checks}
    assert by["logodds"].value > 0
    assert by["query_dist"].value > 0 and by["query_grad"].value > 0


def test_reference_closest_grid_and_its_check():
    """The reference's own closest grid passes the rule; an entry moved
    to a free voxel at the same distance, or dropped, fails it."""
    rd = check.read_reference(spec.load_cell("cow_global_read"))
    geo = types.SimpleNamespace(res=0.1, origin=(0.0, 0.0, 0.0),
                                map_size=(2.4, 2.0, 1.6), grid=(24, 20, 16),
                                trunc=5, infinity=10000.0)
    gen = torch.Generator().manual_seed(5)
    occ = torch.rand(geo.grid, generator=gen) < 0.01
    from esdfbench.references import rebuild

    d2 = rebuild.edt_d2(occ, geo.trunc)
    closest = rd.closest_grid(geo, occ)
    assert rd.closest_errors(geo, closest, occ, d2, slab=5) == 0
    moved = moved_to_free_voxel(closest, occ)
    assert rd.closest_errors(geo, moved, occ, d2) == 1
    dropped = closest.clone()
    dropped.view(-1)[int(torch.nonzero(dropped.view(-1) >= 0)[0])] = -1
    assert rd.closest_errors(geo, dropped, occ, d2) == 1
