"""One run of one cell: set-up, the measured window, the traced slice,
the comparison, the result line.

The program under test is ``fiesta_tpu_torch``; its tick entry is
``fused_batch_step`` for point clouds and ``fused_depth_batch_step`` for
depth images, local-window update where the configuration's
``global_update`` is false, as its app calls them.  Where the traffic mix
has ``reads``, each tick is followed, inside the same call, by the
planner's read of the tick's map as the port's sampling MPC reads it
each solve (``ops/query.py``: ``distance_grid`` once, ``get_distance``
at every sample, ``get_dist_grad_trilinear`` along the refinement's
trajectories), which enqueues its work and reads nothing back.

Set-up makes the scans on the card from the seed, builds the map and
runs ``warm_orbits`` untimed orbits, which builds the kernels on a
checkout's first run and launches every shape the window uses.  The
window then dispatches tick after tick, cycling through the orbit, for
``seconds`` on the host clock; the host never waits inside it.  A CUDA
event after each call marks the tick's end on the device:

* ``tick_ms``: the window's time (host clock, first dispatch to the
  synchronise that ends it) over the ticks dispatched in it;
* ``tick_p95_ms``: the 95th percentile of the intervals between
  consecutive tick ends (the first from an event before the first
  dispatch), every tick of the window; they sum to its device span.

With ``trace``, two whole orbits inside the window run under the
profiler (``trace.py``: a device slice, then a host slice for the idle
gaps), and the per-layer metrics are read from them and from the host
clock around each call outside them.

Where the configuration's reference keeps the ESDF as state (FIESTA's
incremental map, ``check.keeps_esdf``), the harness runs
``check.STRETCH_TICKS`` more ticks once the window has closed and the
memory peak has been read, outside the timing, and keeps a copy of the
map before them and after each, which the check follows
(``check.chain``).  The traced run copies the map to the host before
its device slice, and the reference counts the relaxation's work in the
slice's first ticks from it (``check.relax_work``: ``relax_roofline``;
the check holds their sweeps).
"""

from __future__ import annotations

import gc
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

from . import check, generator, spec, trace

#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "fiesta_tpu")


def forbidden_modules(modules) -> list:
    """Names in ``modules`` whose top-level name (before the first dot)
    is, as a whole, one of FORBIDDEN."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    v = sorted(values)
    if len(v) == 1:
        return float(v[0])
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def tick_ms(window_s: float, ticks: int) -> float:
    """All the window's time over all the ticks completed in it."""
    return window_s * 1e3 / ticks


def tick_p95_ms(intervals_ms) -> float:
    """95th percentile of every tick's interval."""
    return percentile(intervals_ms, 95.0)


class Clock:
    """Tick-end marks: CUDA events on the card; the host clock after a
    synchronous CPU call (tests)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def intervals_ms(self, marks) -> list:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


#: the profiler range around the read, where ``Ticks.mark_read`` asks
READ_MARK = "esdfbench.read"


class Read(NamedTuple):
    """The planner's read of one tick's map at the orbit tick's positions
    (``generator.Reads.at``): the distance [H,K] at each sample, and the
    trilinear distance [R,H] and gradient [R,H,3] along each refinement
    trajectory."""

    orbit_tick: int
    dist: torch.Tensor
    trilinear: torch.Tensor
    grad: torch.Tensor


class Ticks:
    """The program's tick entry with each distinct tick's arguments made
    once: tick ``i`` takes the orbit's tick ``i % ticks_per_orbit``.
    Where the stream has reads, each call reads the new map too:
    ``last_read`` holds that read (``Read``), ``read_ms`` its host ms, and
    with ``mark_read`` it runs inside a profiler range ``READ_MARK``."""

    def __init__(self, cfg, stream):
        from fiesta_tpu_torch import pipeline

        k = stream.scans_per_tick
        f = stream.frames
        self.use_window = not cfg.global_update
        self.cfg = cfg
        self.args = []
        for j in range(stream.ticks_per_orbit):
            sl = slice(j * k, (j + 1) * k)
            pos = stream.positions[(j + 1) * k - 1]
            tfs = stream.transforms[sl]
            if stream.kind == "cloud":
                self.args.append((stream.points[sl], stream.valid[sl], tfs,
                                  pos))
            else:
                prev = (j * k - 1) % f    # the frame before the tick's first
                self.args.append((stream.depths[sl], tfs,
                                  stream.depths[prev],
                                  stream.transforms[prev], pos))
        self.depth = stream.kind == "depth"
        self.pipeline = pipeline
        self.reads = stream.reads
        self.last_read = None
        self.read_ms = None
        self.mark_read = False
        if stream.reads is not None:
            from fiesta_tpu_torch.ops import query

            self.query = query

    def __call__(self, state, i: int):
        j = i % len(self.args)
        a = self.args[j]
        if self.depth:
            out = self.pipeline.fused_depth_batch_step(
                self.cfg, state, *a, use_window=self.use_window,
                use_filter=self.cfg.use_depth_filter)
        else:
            out = self.pipeline.fused_batch_step(
                self.cfg, state, *a, use_window=self.use_window,
                method="scanline")
        if self.reads is not None:
            r0 = time.perf_counter()
            if self.mark_read:
                with torch.profiler.record_function(READ_MARK):
                    self.last_read = self.read(out[0], j)
            else:
                self.last_read = self.read(out[0], j)
            self.read_ms = (time.perf_counter() - r0) * 1e3
        return out

    def read(self, state, j: int) -> Read:
        """The planner's read of ``state`` at orbit tick ``j``'s positions,
        as ``planning/mpc.py`` makes it each solve: the distance grid,
        built once; the distance at every sample of the sampling stage
        (nearest voxel); the trilinear distance and gradient along the
        refinement's trajectories (out of the map -1, the planner's)."""
        q = self.query
        samples, refine = self.reads.at(j)
        grid = q.distance_grid(self.cfg, state.d2, state.seen)
        dist = q.get_distance(self.cfg, grid, samples)
        trilinear, grad = q.get_dist_grad_trilinear(self.cfg, grid, refine,
                                                    out_value=-1.0)
        return Read(j, dist, trilinear, grad)


def power_limit_w():
    """The card's power limit in W (nvidia-smi), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


class Reading:
    """What a per-layer metric reads: the traced slice, the host ms of
    each call outside the traced orbits and the tick intervals there
    (ms, CUDA events), the cell (configuration fields, traffic) and the
    names of the program's hand-written kernels.  ``kernel_dir``: the
    program's kernel sources (a reader finds a file's kernel names
    there); ``stats``: the window's ``UpdateStats`` [T,4] on the host;
    ``work``: where the reference keeps the ESDF, its count of the
    relaxation's work in the ticks that open the device slice
    (``check.relax_work``), else None."""

    def __init__(self, cell, slice_, dispatch_ms, hand_kernels, geometry,
                 intervals_ms=(), kernel_dir=None, stats=None, work=None):
        self.cell = cell
        self.slice = slice_
        self.dispatch_ms = dispatch_ms
        self.intervals_ms = list(intervals_ms)
        self.hand_kernels = hand_kernels
        self.geometry = geometry
        self.kernel_dir = kernel_dir
        self.stats = stats
        self.work = work


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool,
        device, started: float) -> dict:
    """One run; returns the result line's object.  ``started``: the host
    clock (``time.perf_counter``) at the process's start."""
    import fiesta_tpu_torch as ft
    from fiesta_tpu_torch import kernels

    cfg = ft.config_from_fields(cell.fields).validate()
    traffic = cell.traffic
    ref = spec.reference(cell)
    stateful = check.keeps_esdf(ref)
    stream = generator.make_stream(cell.fields, traffic, seed, device)
    ticks = Ticks(cfg, stream)
    per_orbit = stream.ticks_per_orbit
    clock = Clock(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    state = ft.make_state(cfg, device)
    stats = []
    warm = traffic["warm_orbits"] * per_orbit
    for i in range(warm):
        state, st = ticks(state, i)
        stats.append(st)
    sync(device)
    # set-up's objects (modules, the program, the scans) are not the
    # window's garbage: the collector's full passes skip them from here on
    gc.collect()
    gc.freeze()
    log(f"set-up done: {warm} warm ticks, "
        f"{time.perf_counter() - started:.2f} s since start")

    every = traffic["sample_every"]
    offset = int(seed) % every

    def sampled(t: int) -> bool:
        return (t - warm - offset) % every == 0

    keep = {}                 # the program's maps after sampled ticks
    before_slice = None       # stateful: (tick, map on the host) before it
    marks, dispatch, traced_ticks = [], [], set()
    slice_, attempts = None, 0
    i = warm
    marks.append(clock.mark())
    t0 = time.perf_counter()
    setup_s = t0 - started
    deadline = t0 + seconds
    while True:
        n = i - warm
        want_trace = traced and slice_ is None and attempts < 3
        if want_trace and n >= per_orbit and n % per_orbit == 0:
            attempts += 1

            def orbit(first, host_ops):
                def go():
                    nonlocal state
                    for j in range(first, first + per_orbit):
                        if host_ops:
                            with torch.profiler.record_function(trace.TICK):
                                state, st = ticks(state, j)
                        else:
                            state, st = ticks(state, j)
                        marks.append(clock.mark())
                        stats.append(st)
                        if sampled(j):
                            keep[j] = check.sample(state, ticks.last_read)
                        if stateful and not host_ops and \
                                j == first + check.STRETCH_TICKS - 1:
                            # the ticks whose relaxation the reference counts
                            trace.cut()
                return go

            traced_ticks.update(range(i, i + 2 * per_orbit))
            if stateful:
                before_slice = (i, check.esdf_copy(state, host=True))
            evs, wall = trace.profile(orbit(i, False), False)
            i += per_orbit
            found = trace.read_device(evs, wall, per_orbit)
            if found is not None:
                evs, _ = trace.profile(orbit(i, True), True)
                i += per_orbit
                gaps = trace.read_gaps(evs)
                if gaps is not None:
                    found.idle_gaps = gaps
                    slice_ = found
            del evs
            if slice_ is None:
                log(f"trace attempt {attempts}: no device operation seen")
            continue
        if not want_trace and time.perf_counter() >= deadline:
            break
        c0 = time.perf_counter()
        state, st = ticks(state, i)
        dispatch.append((time.perf_counter() - c0) * 1e3)
        marks.append(clock.mark())
        stats.append(st)
        if sampled(i):
            keep[i] = check.sample(state, ticks.last_read)
        i += 1
    sync(device)
    t_end = time.perf_counter()
    n_window = i - warm
    window_s = t_end - t0

    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    stretch = None
    if stateful:
        # the ticks the check follows, outside the window and its timing
        stretch = (i, check.esdf_copy(state), [])
        for _ in range(check.STRETCH_TICKS):
            state, st = ticks(state, i)
            stats.append(st)
            stretch[2].append(check.esdf_copy(state))
            i += 1
        sync(device)
    bad = forbidden_modules(sys.modules)
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {bad}")
    if traced and slice_ is None:
        raise SystemExit("the profiler saw no device operation in "
                         f"{attempts} traces: no per-layer reading")

    intervals = clock.intervals_ms(marks)
    metrics = {}
    result = {"correct": None, "attempted": n_window, "failed": None}
    if not traced:
        values = {"tick_ms": tick_ms(window_s, n_window),
                  "tick_p95_ms": tick_p95_ms(intervals),
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    # the window's pace in fifths (diagnostic): does it drift within a run?
    fifth = len(intervals) // 5
    if fifth:
        pace = [round(statistics.mean(intervals[k:k + fifth]), 3)
                for k in range(0, fifth * 5, fifth)]
        log(f"window pace by fifths (ms a tick): {pace}")
    log(f"window: {n_window} ticks in {window_s:.3f} s, tick_ms "
        f"{tick_ms(window_s, n_window):.4f}, p95 "
        f"{tick_p95_ms(intervals):.4f}, median "
        f"{statistics.median(intervals):.4f}, max {max(intervals):.4f}; "
        f"dispatch {statistics.mean(dispatch):.4f} ms a call; "
        f"set-up {setup_s:.2f} s; memory peak {memory_peak} B")

    program_stats = torch.stack([
        torch.stack([s.num_observed, s.num_inserted, s.num_deleted,
                     s.num_sweeps]) for s in stats]).to(torch.int64).cpu()
    obs = work = None
    if traced:
        geo = ref.Geometry(cell.fields)
        kernel_dir = Path(kernels.__file__).parent
        hand = trace.hand_kernel_names(kernel_dir)
        # the intervals of the ticks outside the traced orbits, and not
        # the first after one (it holds the profiler's close)
        untraced = [iv for j, iv in enumerate(intervals)
                    if warm + j not in traced_ticks
                    and warm + j - 1 not in traced_ticks]
        if before_slice is not None:
            w0 = time.perf_counter()
            obs = check.observations(ref, geo, stream)
            first = before_slice[0]
            work = (first, check.relax_work(ref, geo, obs, *before_slice,
                                            check.STRETCH_TICKS))
            log(f"relax work of ticks {first}-{first + len(work[1]) - 1} "
                f"(sweeps, candidates, voxels lowered): {work[1]}; "
                f"{time.perf_counter() - w0:.2f} s")
        reading = Reading(cell, slice_, dispatch, hand, geo, untraced,
                          kernel_dir, program_stats[warm:warm + n_window],
                          work[1] if work else None)
        for m in cell.per_layer:
            value = spec.metric_reader(cell, m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": slice_.device_ops,
                               "idle_gaps": slice_.idle_gaps}

    # the check: the program's outputs against the reference's replay
    last = i - 1
    keep[last] = check.sample(state, ticks.last_read)
    program = {"stats": program_stats, "samples": keep, "final": state,
               "stretch": stretch}
    log(f"check: {len(stats)} ticks, maps after ticks {sorted(keep)}")
    t_check = time.perf_counter()
    checks, ref_stats = check.compare(ref, cell, stream, program, obs=obs,
                                      work=work)
    window = slice(warm, warm + n_window)
    failed = int(check.differing_ticks(ref_stats[window],
                                       program_stats[window]).sum())
    log(f"check took {time.perf_counter() - t_check:.2f} s")
    result["correct"] = all(c.ok for c in checks)
    result["failed"] = failed
    result["metrics"] = metrics
    result["device"] = device_info(device, cell.chips, memory_peak)
    if traced:
        result["device"]["busy_s"] = slice_.busy_s
        result["device"]["window_s"] = slice_.window_s
    result["checks"] = {c.name: c.entry() for c in checks}
    result["_lines"] = [c.line() for c in checks]
    return result


def device_info(device, chips: int, memory_peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": memory_peak,
                "power_limit_w": power_limit_w()}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": memory_peak}
