"""The end-to-end statistics and the roofline bounds."""

import json
import statistics

import pytest

from esdfbench import harness, roofline, spec
from esdfbench.references import rebuild


def test_tick_ms_is_the_whole_window_over_all_ticks():
    assert harness.tick_ms(10.0, 2500) == pytest.approx(4.0)
    assert harness.tick_ms(0.25, 1) == pytest.approx(250.0)


def test_p95_is_over_every_tick_and_moves_with_one_stall():
    # 20 ticks: one stall lies in the top 5 %
    base = [4.0 + 0.01 * (i % 7) for i in range(20)]
    assert harness.tick_p95_ms(base) == pytest.approx(
        statistics.quantiles(base, n=100, method="inclusive")[94])
    stalled = list(base)
    stalled[13] = 80.0
    assert harness.tick_p95_ms(stalled) > harness.tick_p95_ms(base) + 1.0
    # a median of chunk means would not see it
    chunks = [statistics.mean(base[i:i + 5]) for i in range(0, 20, 5)]
    chunks_stalled = [statistics.mean(stalled[i:i + 5])
                      for i in range(0, 20, 5)]
    assert statistics.median(chunks_stalled) == pytest.approx(
        statistics.median(chunks), abs=0.01)


def _geometry(name):
    return rebuild.Geometry(spec.load_json(
        spec.BENCH_DIR / "configs" / f"{name}.json"))


def test_carve_box_and_bound_by_hand():
    cow, demo = _geometry("cow_and_lady"), _geometry("demo_onboard")
    # reach ceil(5.1 / 0.05) + 2 = 104 -> 209, rounded up to 216 in x, y
    assert cow.grid == (400, 400, 80) and cow.box == (216, 216, 80)
    # reach ceil(5.2 / 0.1) + 2 = 54 -> 109, rounded up to 120 in x, y
    assert demo.grid == (400, 400, 36) and demo.box == (120, 120, 36)
    n = 3 * 216 * 216 * 80
    t, by = roofline.carve_bound_s(3, cow.box)
    assert by == "operations"
    assert t == pytest.approx(60 * n / 33.5e12)
    assert t == pytest.approx(20.055e-6, rel=1e-3)
    t, by = roofline.carve_bound_s(3, demo.box)
    assert t == pytest.approx(60 * 3 * 120 * 120 * 36 / 33.5e12)


def test_edt_bound_by_hand():
    t, by = roofline.edt_bound_s((400, 400, 80))
    assert by == "bytes"
    assert t == pytest.approx(24 * 12_800_000 / 3.35e12)
    assert t == pytest.approx(91.70e-6, rel=1e-3)
    t, _ = roofline.edt_bound_s((400, 400, 36))
    assert t == pytest.approx(24 * 5_760_000 / 3.35e12)


def test_idle_and_plain_readers_on_a_made_up_slice():
    from esdfbench import trace

    s = trace.TraceSlice(ticks=10, window_s=0.05, busy_s=0.02,
                         by_name={"carve_sweep": 0.004, "carve_zero": 0.001,
                                  "edt_minplus_kernel": 0.006,
                                  "edt_binary_kernel": 0.001,
                                  "vectorized_elementwise_kernel": 0.008},
                         device_ops=[], idle_gaps=[])
    cell = spec.load_cell("cow_global_stream")
    reading = harness.Reading(cell, s, [3.0, 5.0], {
        "carve_sweep", "carve_zero", "edt_minplus_kernel",
        "edt_binary_kernel"}, _geometry("cow_and_lady"))
    read = {m: spec.metric_reader(cell, m)(reading) for m in (
        "idle_share", "plain_ms", "dispatch_ms", "carve_roofline",
        "edt_roofline")}
    assert read["idle_share"] == pytest.approx(60.0)
    assert read["plain_ms"] == pytest.approx(0.8)
    assert read["dispatch_ms"] == pytest.approx(4.0)
    assert read["carve_roofline"] == pytest.approx(
        100 * 20.055e-6 / 0.0005, rel=1e-3)
    assert read["edt_roofline"] == pytest.approx(
        100 * 91.70e-6 / 0.0007, rel=1e-3)
    # nothing to read: no number, never a zero
    empty = harness.Reading(cell, trace.TraceSlice(10, 0.05, 0.02, {}, [],
                                                   []), [], set(),
                            _geometry("cow_and_lady"))
    for m in ("carve_roofline", "edt_roofline", "dispatch_ms"):
        assert spec.metric_reader(cell, m)(empty) is None


def test_gaps_are_labelled_by_the_innermost_host_op():
    from esdfbench import trace

    host = [(0, 100, "aten::outer"), (10, 40, "aten::inner"),
            (60, 70, "aten::other")]
    got = dict(trace._label_gaps([(20, 30), (50, 56), (120, 130)], host))
    assert got == {"aten::inner": pytest.approx(10e-6),
                   "aten::outer": pytest.approx(6e-6),
                   "python": pytest.approx(10e-6)}


def test_benchmark_json_names_and_units():
    import re

    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert name.match(e["name"]), e["name"]
            if "unit" in e:
                assert unit.match(e["unit"])
    cells = {w["name"] for w in bench["workloads"]}
    # every cell reports what each of its per-layer metrics moves
    reported = {w: {m["name"] for m in bench["end_to_end"]
                    if w in m.get("workloads", cells)} for w in cells}
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert m["moves"] in reported[w] - {"setup_s"}, (m["name"], w)
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
    for w in cells:
        assert "setup_s" in reported[w] and len(reported[w]) >= 2
    assert all(w["chips"] == 1 for w in bench["workloads"])


def test_tick_ms_is_held_end_to_end_where_steady_and_per_layer_in_the_read_cell():
    cow, read = spec.load_cell("cow_global_stream"), \
        spec.load_cell("cow_global_read")
    assert [m["name"] for m in cow.end_to_end] == [
        "tick_ms", "tick_p95_ms", "setup_s"]
    assert [m["name"] for m in read.end_to_end] == ["tick_p95_ms", "setup_s"]
    assert "tick_ms.with_read" in {m["name"] for m in read.per_layer}
    assert all(m["moves"] == "tick_p95_ms" for m in read.per_layer)
    assert all(m["moves"] == "tick_ms" for m in cow.per_layer)


@pytest.mark.parametrize("base", [
    "dispatch_ms", "plain_ms", "carve_roofline", "edt_roofline",
    "idle_share"])
def test_with_read_readers_read_what_their_base_reads(base):
    from esdfbench import trace

    s = trace.TraceSlice(ticks=10, window_s=0.05, busy_s=0.02,
                         by_name={"carve_sweep": 0.004,
                                  "edt_minplus_kernel": 0.006,
                                  "vectorized_elementwise_kernel": 0.008},
                         device_ops=[], idle_gaps=[])
    cell = spec.load_cell("cow_global_read")
    reading = harness.Reading(cell, s, [3.0, 5.0], {
        "carve_sweep", "edt_minplus_kernel"}, _geometry("cow_and_lady"),
        [8.0, 9.0, 10.0])
    got = spec.metric_reader(cell, f"{base}.with_read")(reading)
    assert got is not None
    assert got == spec.metric_reader(cell, base)(reading)


def test_tick_ms_with_read_is_the_mean_untraced_interval():
    cell = spec.load_cell("cow_global_read")
    reader = spec.metric_reader(cell, "tick_ms.with_read")
    reading = harness.Reading(cell, None, [], set(), None, [8.0, 9.0, 13.0])
    assert reader(reading) == pytest.approx(10.0)
    assert reader(harness.Reading(cell, None, [], set(), None, [])) is None
