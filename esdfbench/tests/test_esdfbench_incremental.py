"""The incremental map's cell: the reference against the program, the
check against faults of the relaxation and of the map, and the relax
readers."""

import dataclasses
import types

import pytest
import torch

from conftest import run_small
from esdfbench import check, control, generator, harness, roofline, spec

CELL = "small_cow_incr"


def _program(cell):
    import fiesta_tpu_torch as ft

    cfg = ft.config_from_fields(cell.fields).validate()
    return ft, cfg


def _two_scenes(cell, seeds, dev):
    """An orbit of each seed's room, one after the other, cycled: boxes
    vanish and appear where the scene changes, so obstacles are deleted
    as well as inserted."""
    a, b = (generator.make_stream(cell.fields, cell.traffic, s, dev)
            for s in seeds)
    return dataclasses.replace(a, **{
        k: torch.cat([getattr(a, k), getattr(b, k)])
        for k in ("transforms", "positions", "points", "valid")})


def test_reference_follows_the_program_bit_for_bit(small_root):
    """Two cycles of a stream whose room changes between its orbits,
    from an empty map: the reference's drain and relaxation, on its own
    map, agree with the program's incremental tick in d2, closest and
    every tick's four stats; the program's insert and delete masks count
    what the drain counts."""
    cell = spec.load_cell(CELL, small_root)
    ft, cfg = _program(cell)
    dev = torch.device("cpu")
    stream = _two_scenes(cell, (2 ** 33 + 5, 17), dev)
    ticks = harness.Ticks(cfg, stream)
    state = ft.make_state(cfg, dev)
    ref = spec.reference(cell)
    geo = ref.Geometry(cell.fields)
    obs = check.observations(ref, geo, stream)
    m = ref.Map(geo, dev)
    d2 = torch.full(geo.grid, ref.INF_D2, dtype=torch.int32)
    closest = torch.full((3,) + geo.grid, -1, dtype=torch.int16)
    changes = torch.zeros(2, dtype=torch.int64)
    for t in range(2 * stream.ticks_per_orbit):
        state, st = ticks(state, t)
        occ_b = m.occupied()
        n_obs, n_ins, n_del = m.drain(obs[t % len(obs)])
        d2, closest, sweeps = ref.update(geo, d2, closest, occ_b,
                                         m.occupied())
        assert [int(st.num_observed), int(st.num_inserted),
                int(st.num_deleted), int(st.num_sweeps)] == \
            [int(n_obs), int(n_ins), int(n_del), sweeps], t
        assert torch.equal(state.d2, d2) and \
            torch.equal(state.closest, closest), t
        changes += torch.tensor([int(n_ins), int(n_del)])
    assert (changes > 0).all(), changes


def _sweep_short(esdf, keep_last):
    real = esdf.relax_to_fixpoint

    def relax(*a, **k):
        out = real(*a, **k)
        n = int(out[2]) - (1 if keep_last else 2)
        return real(*a, **dict(k, max_iters=n)) if n >= 1 else out
    return "relax_to_fixpoint", relax


def _one_sweep_short(esdf):
    """The relaxation stops one sweep short: the sweep that changes
    nothing is not run (the map is the fixpoint, the count is not)."""
    return _sweep_short(esdf, True)


def _short_of_the_fixpoint(esdf):
    """The relaxation stops before its last sweep that lowers a
    distance."""
    return _sweep_short(esdf, False)


def _bucket_kept(esdf):
    """A deleted obstacle's bucket left in place: nothing resets."""
    real = esdf.apply_occupancy_changes

    def apply(d2, closest, occupied, insert_mask, **k):
        return real(d2, closest, torch.ones_like(occupied), insert_mask, **k)
    return "apply_occupancy_changes", apply


@pytest.mark.parametrize("fault", [None, _one_sweep_short,
                                   _short_of_the_fixpoint, _bucket_kept])
def test_relaxation_faults_fail_the_check(small_root, monkeypatch, fault):
    from fiesta_tpu_torch.ops import esdf

    if fault is not None:
        monkeypatch.setattr(esdf, *fault(esdf))
    result = run_small(small_root, CELL)
    assert result["correct"] is (fault is None), result["checks"]


def _tie_moved(ft, cfg, moved):
    """After each tick, one closest entry that the tick changed moves to
    another occupied voxel at the same distance, where one exists."""
    def after(state, new):
        occ = ft.occupied_grid(cfg, new.logodds)
        pts = torch.nonzero(occ).to(torch.int32)
        changed = ((new.closest != state.closest).any(dim=0)
                   & (new.d2 > 0))
        for v in torch.nonzero(changed)[:64].tolist():
            d = ((pts - torch.tensor(v, dtype=torch.int32)) ** 2).sum(1)
            own = new.closest[(slice(None),) + tuple(v)].to(torch.int32)
            ties = pts[(d == new.d2[tuple(v)]) & (pts != own).any(1)]
            if len(ties):
                closest = new.closest.clone()
                closest[(slice(None),) + tuple(v)] = ties[0].to(torch.int16)
                moved.append(v)
                return dataclasses.replace(new, closest=closest)
        return new
    return after


def _exact_edt(ft, cfg, moved):
    """The exact EDT, with its argmin, written where the fixpoint should
    be."""
    from fiesta_tpu_torch.ops import esdf

    def after(state, new):
        d2, closest = esdf.build_esdf(ft.occupied_grid(cfg, new.logodds))
        moved.append(int(((closest != new.closest).any(0)).sum()))
        return dataclasses.replace(new, d2=d2, closest=closest)
    return after


@pytest.mark.parametrize("fault", [_tie_moved, _exact_edt])
def test_map_faults_fail_the_check(small_root, monkeypatch, fault):
    from fiesta_tpu_torch import pipeline

    cell = spec.load_cell(CELL, small_root)
    ft, cfg = _program(cell)
    moved = []
    alter = fault(ft, cfg, moved)
    real = pipeline.fused_batch_step

    def step(cfg_, state, *a, **k):
        new, stats = real(cfg_, state, *a, **k)
        return alter(state, new), stats
    monkeypatch.setattr(pipeline, "fused_batch_step", step)
    result = run_small(small_root, CELL)
    assert moved and any(moved), "the fault never changed the map"
    assert result["correct"] is False, result["checks"]
    by = result["checks"]
    assert by["closest"]["value"] + by["d2"]["value"] > 0, by


def test_control_fails_the_incremental_cell(small_root):
    cell = spec.load_cell(CELL, small_root)
    checks, ok = control.readings(cell, 11, 20, torch.device("cpu"))
    assert not ok
    assert {c.name: c for c in checks}["logodds"].value > 0


def test_relax_bound_by_hand():
    t, by = roofline.relax_bound_s(10_000_000, 20_000)
    assert by == "operations"
    assert t == pytest.approx(12e7 / (132 * 64 * 1.98e9))
    t, by = roofline.relax_bound_s(10, 200_000)
    assert by == "bytes" and t == pytest.approx(20 * 200_000 / 3.35e12)


def test_relax_readers_on_a_made_up_slice(tmp_path):
    from esdfbench import trace

    (tmp_path / "relax.cu").write_text(
        "__global__ void __launch_bounds__(256, 2)\n relax_sweeps(int a) {}")
    (tmp_path / "carve.cu").write_text("__global__ void carve_sweep() {}")
    # four ticks, one relax launch each, 1 ms apiece but the first 3 ms;
    # the cut after the second
    series = {"relax_sweeps": [(10.0 * i, 1e-3 if i else 3e-3)
                               for i in range(4)]}
    s = trace.TraceSlice(ticks=4, window_s=0.05, busy_s=0.02,
                         by_name={"relax_sweeps": 6e-3, "carve_sweep": 1e-3},
                         device_ops=[], idle_gaps=[], series=series,
                         cuts=[15.0])
    cell = spec.load_cell("cow_incr_dynamic")
    work = [(5, 1_000_000, 200_000), (3, 2_000_000, 300_000)]
    stats = torch.tensor([[9, 1, 1, 4], [9, 1, 1, 6]])
    reading = harness.Reading(cell, s, [], set(), None, (), tmp_path, stats,
                              work)
    read = {m: spec.metric_reader(cell, m)(reading) for m in (
        "relax_ms", "relax_roofline", "sweeps_per_tick")}
    assert read["relax_ms"] == pytest.approx(1.5)
    assert read["sweeps_per_tick"] == pytest.approx(5.0)
    bound = sum(roofline.relax_bound_s(p, c)[0] for _, p, c in work)
    assert read["relax_roofline"] == pytest.approx(100 * bound / 4e-3)
    # nothing to read: no number, never a zero
    none = harness.Reading(cell, s, [], set(), None, (), tmp_path)
    for m in ("relax_roofline", "sweeps_per_tick"):
        assert spec.metric_reader(cell, m)(none) is None
    uncut = dataclasses.replace(s, cuts=[])
    assert spec.metric_reader(cell, "relax_roofline")(harness.Reading(
        cell, uncut, [], set(), None, (), tmp_path, stats, work)) is None


def test_relax_work_follows_the_program_from_its_map(small_root):
    """The roofline's counts replay the program's ticks from its own map:
    the same sweeps as its stats, and a count for each of them."""
    cell = spec.load_cell(CELL, small_root)
    ft, cfg = _program(cell)
    dev = torch.device("cpu")
    stream = generator.make_stream(cell.fields, cell.traffic, 123, dev)
    ticks = harness.Ticks(cfg, stream)
    state = ft.make_state(cfg, dev)
    ref = spec.reference(cell)
    geo = ref.Geometry(cell.fields)
    first, n = stream.ticks_per_orbit + 1, 4
    sweeps = []
    for t in range(first + n):
        if t == first:
            start = check.esdf_copy(state)
        state, st = ticks(state, t)
        sweeps.append(int(st.num_sweeps))
    work = check.relax_work(ref, geo, check.observations(ref, geo, stream),
                            first, start, n)
    assert [w[0] for w in work] == sweeps[first:]
    assert all(p >= 0 and c >= 0 for _, p, c in work)
    assert any(p > 0 for _, p, _ in work)


def test_invariants_of_a_made_up_map():
    """Each invariant counts its own fault on a tiny map with one
    obstacle; a correct map passes them all."""
    ref = spec.load_module(spec.BENCH_DIR / "references" / "incremental.py",
                           "esdfbench_reference_incremental")
    fields = spec.load_json(spec.BENCH_DIR / "configs"
                            / "cow_and_lady_incremental.json")
    fields = dict(fields, resolution=0.5, origin=[0.0, 0.0, 0.0],
                  map_size=[4.0, 3.0, 2.0])
    geo = ref.Geometry(fields)
    occ = torch.zeros(geo.grid, dtype=torch.bool)
    occ[1, 2, 1] = True
    empty = (torch.full(geo.grid, ref.INF_D2, dtype=torch.int32),
             torch.full((3,) + geo.grid, -1, dtype=torch.int16))
    d2, closest, _ = ref.update(geo, *empty, torch.zeros_like(occ), occ)
    good = ref.invariants(geo, d2, closest, occ)
    assert {k: v for k, v in good.items() if k != "excess_max"} == dict.fromkeys(
        ["closest_occupied", "d2_consistent", "fixpoint", "below_edt",
         "undefined", "above_edt"], 0)
    bad = types.SimpleNamespace(d2=d2.clone(), closest=closest.clone())
    bad.d2[5, 0, 0] += 1                      # off its closest entry
    bad.closest[:, 7, 5, 3] = -1              # undefined where defined
    bad.d2[7, 5, 3] = ref.INF_D2
    got = ref.invariants(geo, bad.d2, bad.closest, occ)
    assert got["d2_consistent"] == 1 and got["undefined"] == 1
    assert got["fixpoint"] >= 1
    low = d2.clone()
    low[3, 3, 3] = 0
    assert ref.invariants(geo, low, closest, occ)["below_edt"] == 1
    gone = torch.zeros_like(occ)
    assert ref.invariants(geo, d2, closest, gone)["closest_occupied"] == \
        int((closest[0] >= 0).sum())


def test_the_slice_sweeps_are_held(small_root):
    """The check follows the program's map through its last ticks, and
    holds the sweeps that ``relax_work`` counted in the traced slice to
    the program's: one count off fails ``sweeps``."""
    cell = spec.load_cell(CELL, small_root)
    ft, cfg = _program(cell)
    dev = torch.device("cpu")
    stream = generator.make_stream(cell.fields, cell.traffic, 2 ** 40 + 3,
                                   dev)
    ticks = harness.Ticks(cfg, stream)
    state = ft.make_state(cfg, dev)
    ref = spec.reference(cell)
    geo = ref.Geometry(cell.fields)
    obs = check.observations(ref, geo, stream)
    w_first, n = stream.ticks_per_orbit, 3
    first = w_first + n + 2
    stats = []
    for t in range(first + check.STRETCH_TICKS):
        if t == w_first:
            work = (w_first, check.relax_work(
                ref, geo, obs, w_first, check.esdf_copy(state, host=True),
                n))
        if t == first:
            stretch = (t, check.esdf_copy(state), [])
        state, st = ticks(state, t)
        if t >= first:
            stretch[2].append(check.esdf_copy(state))
        stats.append([int(st.num_observed), int(st.num_inserted),
                      int(st.num_deleted), int(st.num_sweeps)])
    program = {"stats": torch.tensor(stats), "final": state,
               "samples": {len(stats) - 1: check.sample(state)},
               "stretch": stretch}
    checks, ref_stats = check.compare(ref, cell, stream, program, obs, work)
    by = {c.name: c for c in checks}
    assert all(c.ok for c in checks), by
    assert (ref_stats[w_first:w_first + n, 3] >= 0).all()
    assert (ref_stats[first:, 3] >= 0).all()
    assert (ref_stats[w_first + n:first, 3] == -1).all()
    off = (w_first, [(w[0] + (k == 1), w[1], w[2])
                     for k, w in enumerate(work[1])])
    checks, _ = check.compare(ref, cell, stream, program, obs, off)
    by = {c.name: c for c in checks}
    assert by["sweeps"].value == 1 and not by["sweeps"].ok


def test_a_cut_inside_the_slice_is_read_and_left_out():
    """``trace.cut``'s mark after a slice's first ops is read as a cut,
    and is none of the slice's operations; the opening marks are not."""
    from esdfbench import trace

    mark = trace.MARK_NAME
    evs = [(mark, True, 0.0, 5.0, 1, False), (mark, True, 6.0, 9.0, 1, False),
           ("relax_sweeps(int*)", True, 20.0, 30.0, 1, False),
           (mark, True, 31.0, 32.0, 1, False),
           ("relax_sweeps(int*)", True, 40.0, 45.0, 1, False)]
    s = trace.read_device(evs, 1.0, 2)
    assert s.cuts == [31.0]
    assert list(s.series) == ["relax_sweeps"]
    assert s.series["relax_sweeps"] == [(20.0, pytest.approx(1e-5)),
                                        (40.0, pytest.approx(5e-6))]
    assert s.busy_s == pytest.approx(15e-6)
