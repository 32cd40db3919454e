"""The port's spans and its timing registry (``fiesta_tpu_torch.timing``).

Off, a span records nothing and never opens a profiler range; on, spans
nest, share their tick's number and sit in a ``torch.profiler`` trace as
user annotations around the work made inside them; one tick records one
span per layer of the map tick; a ``Timer`` feeds the on-screen marker
with the device seconds where its events give them.
"""

import contextlib
import dataclasses
import io
import json
import time
import types

import numpy as np
import pytest
import torch

import fiesta_tpu_torch as ft
from fiesta_tpu_torch import kernels, pipeline, run, timing, viz
from fiesta_tpu_torch.io import replay
from fiesta_tpu_torch.ops.depth import pose_to_matrix
from fiesta_tpu_torch.timing import Timer, Timing, span

H, W = 24, 32

CLOUD_TICK = {"fiesta.tick", "fiesta.integrate", "fiesta.integrate.prep",
              "fiesta.integrate.splat", "fiesta.integrate.carve",
              "fiesta.integrate.boxadd", "fiesta.update",
              "fiesta.update.drain", "fiesta.update.edt"}


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and no spans kept."""
    timing.enable(False)
    timing.drain()
    yield
    timing.enable(False)
    timing.drain()


def _cfg(**kw):
    cfg = replay.scale_intrinsics(ft.FiestaConfig(
        resolution=0.1, origin=(-2.4, -2.4, -1.0), map_size=(4.8, 4.8, 3.2),
        min_ray_length=0.3, max_ray_length=1.5, trunc_dist=1.2,
        edt_fine_dist=1.2, max_points_per_scan=H * W), H, W)
    return dataclasses.replace(cfg, **kw)


def _ticks(cfg, kind):
    """Two ticks' arguments of three scans each (clouds or depth images),
    and the call that runs one."""
    _, frames = replay.make_sequence(cfg, n_frames=6, n_boxes=4, seed=2,
                                     kind=kind, height=H, width=W,
                                     orbit_radius=0.6)
    if kind == "cloud":
        pts, vals, tfs, pos = replay.stage_update_batches(cfg, frames,
                                                          device="cpu")
        args = [(pts[i], vals[i], tfs[i], pos[i]) for i in range(2)]
        return args, lambda st, a: pipeline.fused_batch_step(cfg, st, *a)
    depths = torch.from_numpy(np.stack([f[2] for f in frames])
                              .astype(np.float32)).reshape(2, 3, H, W)
    tfs = torch.from_numpy(np.stack([pose_to_matrix(*f[1]) for f in frames])
                           .astype(np.float32)).reshape(2, 3, 4, 4)
    pos = [torch.tensor(frames[3 * i + 2][1][0], dtype=torch.float32)
           for i in range(2)]
    args = [(depths[i], tfs[i], depths[0, 0] if i == 0 else depths[0, 2],
             tfs[0, 0] if i == 0 else tfs[0, 2], pos[i]) for i in range(2)]
    return args, lambda st, a: pipeline.fused_depth_batch_step(
        cfg, st, *a, use_window=True)


def _raise(*a, **kw):
    raise AssertionError("record_function reached with tracing off")


def test_off_records_nothing_and_never_reaches_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    cfg = _cfg()
    args, tick = _ticks(cfg, "cloud")
    state = ft.make_state(cfg, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        state, _ = tick(state, args[0])
        with span("fiesta.query") as s:
            assert s is None
    assert timing.drain() == []
    assert span("fiesta.a") is span("fiesta.b")


def test_nesting_parents_tick_number_and_self_time(monkeypatch):
    clock = iter(range(0, 10**9, 1000))     # 1 us a reading
    monkeypatch.setattr(timing, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(clock), perf_counter=time.perf_counter))
    monkeypatch.setitem(kernels.LAUNCHES, "splat", 0)
    timing.enable(True)
    with span("fiesta.query"):
        pass
    for _ in range(2):
        with span(timing.TICK):
            with span("fiesta.integrate"):
                with span("fiesta.integrate.splat"):
                    kernels.LAUNCHES["splat"] += 2
            with span("fiesta.update"):
                pass
    spans = timing.drain()
    assert timing.drain() == []
    names = [s.name for s in spans]
    assert names == ["fiesta.query"] + ["fiesta.tick", "fiesta.integrate",
                                        "fiesta.integrate.splat",
                                        "fiesta.update"] * 2
    assert [s.parent for s in spans] == [None, None, 1, 2, 1, None, 5, 6, 5]
    t0 = spans[1].tick
    assert [s.tick for s in spans] == [t0 - 1] + [t0] * 4 + [t0 + 1] * 4
    # each span reads the clock once at entry and once at exit
    assert [s.host_ms for s in spans[1:5]] == pytest.approx(
        [0.007, 0.003, 0.001, 0.001])
    assert [s.launches_end - s.launches_start for s in spans[1:5]] == \
        [2, 2, 2, 0]
    assert all(s.device_ms is None for s in spans)
    rows = {line.split()[0]: line.split()[1:]
            for line in timing.span_table(spans).splitlines()[3:]}
    # n, host ms, self ms (less the direct children), device ms, launches
    assert rows["fiesta.tick"] == ["2", "0.014", "0.006", "-", "4"]
    assert rows["fiesta.integrate"] == ["2", "0.006", "0.004", "-", "4"]
    assert rows["fiesta.update"] == ["2", "0.002", "0.002", "-", "0"]


@pytest.mark.parametrize("kind,extra,mode", [
    ("cloud", set(), "rebuild"),
    ("depth", {"fiesta.depth"}, "rebuild"),
    ("cloud", {"fiesta.update.relax", "fiesta.update.relax.changes"},
     "incremental")])
def test_span_names_of_one_cpu_tick(kind, extra, mode):
    cfg = _cfg(esdf_mode=mode)
    args, tick = _ticks(cfg, kind)
    want = CLOUD_TICK | extra
    if mode == "incremental":
        want = want - {"fiesta.update.edt"}
    state = ft.make_state(cfg, device="cpu")
    timing.enable(True)
    ticks = []
    for a in args:
        state, _ = tick(state, a)
        ticks.append(timing.drain())
    for spans in ticks:
        assert {s.name for s in spans} == want
        assert [s.name for s in spans].count(timing.TICK) == 1
        assert spans[0].name == timing.TICK and spans[0].parent is None
        assert all(s.parent is not None for s in spans[1:])
        assert len({s.tick for s in spans}) == 1
    assert ticks[1][0].tick == ticks[0][0].tick + 1


def test_spans_are_annotations_on_the_profilers_clock():
    timing.enable(True)
    x = torch.ones(64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("fiesta.outer"):
            with span("fiesta.inner"):
                y = x + 1
    assert float(y.sum()) == 128.0
    evs = list(prof.profiler.kineto_results.events())
    notes = {e.name(): e for e in evs if e.is_user_annotation()}
    assert {"fiesta.outer", "fiesta.inner"} <= set(notes)
    adds = [e for e in evs if e.name() == "aten::add"]
    assert adds
    for outer in ("fiesta.inner", "fiesta.outer"):
        n = notes[outer]
        for a in adds:
            assert n.start_ns() <= a.start_ns()
            assert a.end_ns() <= n.end_ns()
    assert [s.name for s in timing.drain()] == ["fiesta.outer",
                                                "fiesta.inner"]


class _FakeEvent:
    """A recorded CUDA event stand-in: complete once ``done``."""

    def __init__(self, t_ms, done=True):
        self.t_ms, self.done = t_ms, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        assert end.done
        return end.t_ms - self.t_ms


def test_timer_feeds_performance_text():
    """Host seconds from ``Timer`` on the CPU, as before; device seconds,
    where events give them, read without waiting until asked for, then
    shown in the marker and the table."""
    Timing.reset()
    with Timer("UpdateESDF", torch.device("cpu")):
        pass
    assert Timing.get_mean_device_seconds("UpdateESDF") is None
    host_ms = Timing.get_mean_seconds("UpdateESDF") * 1e3
    assert viz.performance_text(4.0).endswith(f"{host_ms:.3f} ms")
    Timing.add_device("UpdateESDF", _FakeEvent(1.0), _FakeEvent(3.0))
    late = _FakeEvent(10.0, done=False)
    Timing.add_device("UpdateESDF", _FakeEvent(4.0), late)
    assert not late.done and len(Timing._pending) == 1
    assert Timing.get_mean_device_seconds("UpdateESDF") == \
        pytest.approx(0.004)
    assert late.done and not Timing._pending
    assert viz.performance_text().endswith("Average update Time\n4.000 ms")
    row = [r for r in Timing.print_table().splitlines()
           if r.startswith("UpdateESDF")][0]
    assert row.endswith("4.000+- 2.828ms")
    Timing.reset()


def test_profile_dir_prints_the_span_table_and_traces_the_spans(tmp_path):
    prof = tmp_path / "prof"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert run.main(["--preset", "small", "--platform", "cpu",
                         "--frames", "6", "--method", "scanline",
                         "--profile-dir", str(prof)]) == 0
    assert "Timing\n" in err.getvalue()
    table = err.getvalue().split("Spans\n", 1)[1]
    for name in ("fiesta.update", "fiesta.update.edt",
                 "fiesta.integrate.carve"):
        assert f"\n{name} " in table
    with open(prof / "trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"fiesta.update", "fiesta.update.drain"} <= names
    assert not timing._on
