"""The program's spans read by the benchmark (``esdfbench/spans.py``): a
synthetic trace read by hand, the older readers blind to the spans, and
the span orbits of a small cell on the CPU."""

import time

import pytest
import torch

from esdfbench import harness, spans, spec, trace

SLICE = trace.SLICE
MARK = trace.MARK_NAME


def _trace(with_spans: bool):
    """A synthetic span-trace orbit of 2 ticks, times in us, thread 7.

    Tick 1 (100-200): integrate (110-150) holding splat (120-140), update
    (160-190); tick 2 (300-350) with nothing inside.  Runtime calls: corr
    1 in splat, 2 in integrate's own time, 3 in update, 4 in tick 2's own
    time, 5 outside any span (after tick 1); corr 6's kernel has no
    runtime call.  A cudaStreamSynchronize in update, a
    cudaDeviceSynchronize outside the spans.  The device: a mark, then
    kernels 1-6; two idle gaps fall in spans (update's, tick 2's) and the
    rest outside."""
    evs = [
        # (name, on device, start, end, thread, corr, is an annotation)
        (SLICE, False, 50.0, 400.0, 7, 0, True),
        (MARK, True, 0.0, 40.0, 0, 99, False),
        # a host operation whose own id equals kernel 1's correlation id
        ("aten::add", False, 144.0, 147.0, 7, 1, False),
        ("cudaLaunchKernel", False, 125.0, 126.0, 7, 1, False),
        ("cudaLaunchKernel", False, 145.0, 146.0, 7, 2, False),
        ("cudaMemcpyAsync", False, 165.0, 166.0, 7, 3, False),
        ("cudaStreamSynchronize", False, 170.0, 180.0, 7, 0, False),
        ("cudaLaunchKernel", False, 310.0, 311.0, 7, 4, False),
        ("cudaLaunchKernel", False, 250.0, 251.0, 7, 5, False),
        ("cudaDeviceSynchronize", False, 390.0, 395.0, 7, 0, False),
        ("splat_scatter_max", True, 130.0, 135.0, 0, 1, False),
        ("fuse_kernel", True, 135.0, 155.0, 0, 2, False),
        ("Memcpy DtoH", True, 170.0, 172.0, 0, 3, False),
        ("edt_minplus_kernel", True, 320.0, 330.0, 0, 4, False),
        ("carve_sweep", True, 260.0, 300.0, 0, 5, False),
        ("boxadd_kernel", True, 380.0, 382.0, 0, 6, False),
    ]
    if with_spans:
        for name, a, b in (("fiesta.tick", 100.0, 200.0),
                           ("fiesta.integrate", 110.0, 150.0),
                           ("fiesta.integrate.splat", 120.0, 140.0),
                           ("fiesta.update", 160.0, 190.0),
                           ("fiesta.tick", 300.0, 350.0)):
            evs.append((name, False, a, b, 7, 0, True))
            # the profiler's device-side copy of the annotation
            evs.append((name, True, a + 5, b + 5, 0, 0, True))
    return evs


def test_read_spans_by_hand():
    got = spans.read_spans(_trace(True), ticks=2)
    rows = got["spans"]
    # host self ms a tick: tick 100+50 less children 40+30; integrate 40
    # less splat 20; splat 20; update 30
    assert rows["fiesta.tick"]["host_self_ms"] == pytest.approx(80e-3 / 2)
    assert rows["fiesta.integrate"]["host_self_ms"] == pytest.approx(
        20e-3 / 2)
    assert rows["fiesta.integrate.splat"]["host_self_ms"] == pytest.approx(
        20e-3 / 2)
    assert rows["fiesta.update"]["host_self_ms"] == pytest.approx(30e-3 / 2)
    # device ms and launches a tick by the innermost span of the call
    assert rows["fiesta.integrate.splat"]["device_ms"] == pytest.approx(
        5e-3 / 2)
    assert rows["fiesta.integrate"]["device_ms"] == pytest.approx(20e-3 / 2)
    assert rows["fiesta.update"]["device_ms"] == pytest.approx(2e-3 / 2)
    assert rows["fiesta.tick"]["device_ms"] == pytest.approx(10e-3 / 2)
    assert [rows[k]["launches"] for k in (
        "fiesta.tick", "fiesta.integrate", "fiesta.integrate.splat",
        "fiesta.update")] == [0.5, 0.5, 0.5, 0.5]
    assert rows["fiesta.update"]["syncs"] == 0.5
    assert rows["fiesta.tick"]["syncs"] == 0
    tick = got["tick"]
    assert tick["launches"] == 2.0 and tick["syncs"] == 0.5
    assert tick["device_ms"] == pytest.approx(37e-3 / 2)
    # kernels 5 (called outside the spans) and 6 (no runtime call)
    assert tick["ops"] == 6 and tick["unattributed"] == 2
    assert got["marked"] is True
    # busy 130-155, 170-172, 260-300, 320-330, 380-382 within the slice
    # 50-400: gaps 50-130 (mid 90: none), 155-170 (162.5: update),
    # 172-260 (216: none), 300-320 (310: tick 2), 330-380 (355: none),
    # 382-400 (391: none)
    gaps = dict(got["span_gaps"])
    assert gaps == pytest.approx({spans.NO_SPAN: (80 + 88 + 50 + 18) * 1e-6,
                                  "fiesta.tick": 20e-6,
                                  "fiesta.update": 15e-6})


def test_read_spans_under_the_read():
    """The harness's range around the planner's read (after tick 1): its
    launches and synchronisations a tick, apart from the tick's; None
    where the trace holds no read."""
    assert spans.read_spans(_trace(True), ticks=2)["read"] is None
    evs = _trace(True) + [
        (spans.READ, False, 355.0, 389.0, 7, 0, True),
        (spans.READ, True, 360.0, 394.0, 0, 0, True),
        ("cudaLaunchKernel", False, 358.0, 359.0, 7, 7, False),
        ("cudaLaunchKernel", False, 370.0, 371.0, 7, 8, False),
        ("cudaStreamSynchronize", False, 375.0, 377.0, 7, 0, False),
        ("vectorized_elementwise_kernel", True, 383.0, 384.0, 0, 7, False),
        ("index_elementwise_kernel", True, 386.0, 389.0, 0, 8, False),
    ]
    got = spans.read_spans(evs, ticks=2)
    assert got["read"] == pytest.approx({"launches": 1.0, "syncs": 0.5,
                                         "device_ms": 4e-3 / 2})
    assert got["tick"]["launches"] == 2.0 and got["tick"]["syncs"] == 0.5
    assert got["tick"]["ops"] == 8 and got["tick"]["unattributed"] == 2
    assert got["spans"][spans.READ]["launches"] == 1.0


def test_read_spans_without_spans_is_none():
    assert spans.read_spans(_trace(False), ticks=2) is None
    assert spans.read_spans([], ticks=2) is None


def test_older_readers_blind_to_the_spans():
    """``trace.read_device`` and ``trace.read_gaps`` read the same with the
    program's annotations (host ranges and their device copies) in the
    trace as without: their events as ``trace.events`` gives them."""
    def old(evs):
        return [(name, dev, a, b, th, note) for name, dev, a, b, th, _, note
                in evs]

    for read in (lambda e: trace.read_device(e, 0.35, 2), trace.read_gaps):
        without = read(old(_trace(False)))
        assert without is not None
        assert read(old(_trace(True))) == without


def _reading(root, name):
    cell = spec.load_cell(name, root)
    return harness.Reading(cell, None, [], set(), None)


@pytest.mark.parametrize("name,extra", [
    ("small_cow", set()), ("small_demo", {"fiesta.depth"}),
    ("small_cow_read", set())])
def test_span_orbits_on_a_small_cell(small_root, name, extra):
    """The span orbits through the program's plain versions on the CPU:
    host ms by layer, every span name of the tick, no device operation."""
    torch.manual_seed(0)
    reading = _reading(small_root, name)
    t0 = time.perf_counter()
    found = spans.measure(reading, torch.device("cpu"), seed=2 ** 31 + 5)
    assert time.perf_counter() - t0 < 120
    assert spans.measure(reading) is found
    host = found["host_ms"]
    assert {"fiesta.tick", "fiesta.integrate", "fiesta.update",
            "fiesta.integrate.carve", "fiesta.update.edt"} | extra <= \
        set(host)
    parts = sum(host.get(k, 0.0) for k in ("fiesta.depth",
                                            "fiesta.integrate",
                                            "fiesta.update"))
    assert 0 < parts <= host["fiesta.tick"]
    reads = name == "small_cow_read"
    assert set(found["spans"]) == set(host) | ({spans.READ} if reads
                                              else set())
    assert found["tick"]["ops"] == 0 and found["tick"]["syncs"] == 0
    for metric in ("tick_host_ms", "integrate_host_ms", "update_host_ms",
                   "launches_per_tick", "host_syncs_per_tick"):
        value = spec.metric_reader(reading.cell, metric)(reading)
        assert value is not None and value >= 0, metric
    # the read's metrics read something where the cell reads the map
    for metric in ("query_host_ms", "query_launches_per_tick",
                   "query_syncs_per_tick"):
        value = spec.metric_reader(reading.cell, metric)(reading)
        assert (value is not None) is reads, metric
        if value is not None:
            assert value >= 0 and found["read"]["syncs"] == 0
    if reads:
        assert found["read_ms"] > 0
    from fiesta_tpu_torch import timing
    assert not timing._on


def test_no_spans_no_reading(small_root, monkeypatch):
    """A program without spans (the parent of the change that adds them):
    every span metric reads nothing, and no orbit runs."""
    from fiesta_tpu_torch import timing

    monkeypatch.delattr(timing, "enable")
    monkeypatch.setattr(spans.generator, "make_stream", None)
    reading = _reading(small_root, "small_cow")
    for metric in ("tick_host_ms", "depth_host_ms", "integrate_host_ms",
                   "update_host_ms", "launches_per_tick",
                   "host_syncs_per_tick", "query_host_ms",
                   "query_launches_per_tick", "query_syncs_per_tick"):
        assert spec.metric_reader(reading.cell, metric)(reading) is None
