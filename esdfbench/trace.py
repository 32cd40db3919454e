"""The traced slices: whole orbits of ticks under ``torch.profiler``,
read into device time by kernel, busy time, and the idle gaps labelled
by what the host was doing in them.

Two slices of one orbit each, back to back inside the traced run's
window:

* the device slice traces the card alone (CUDA activity), so the host's
  enqueue runs at nearly its untraced pace: device time by kernel, busy
  (the union of the device operations' intervals) and the slice's wall
  (host clock from a synchronise before its first tick to one after its
  last);
* the host slice traces the host's operations too, which slows the
  host's enqueue, and is read only for the idle gaps: each gap between
  device operations is labelled by the innermost host operation under
  way at its middle.

The profiler's trace can drop the first kernels launched in it (and has
been seen to hold none), so each trace opens with a few device sleeps,
which are left out of the reading: a trace in which no sleep is left, or
no other device operation, is refused (``None``) and the caller takes
another, or fails the run.  Nothing here reports a zero for a trace that
saw nothing.
"""

from __future__ import annotations

import dataclasses
import re
import time
from pathlib import Path

import torch

MARKS = 3                 # device sleeps that open each trace
MARK_CYCLES = 5_000_000   # ~2.5 ms each at the H100's 1.98 GHz
MARK_NAME = "spin_kernel"
CUT_CYCLES = 2_000        # a cut inside a slice (``cut``): ~1 us
SLICE = "esdfbench.slice"
TICK = "esdfbench.tick"


def hand_kernel_names(kernel_dir: Path, pattern: str = "*.cu*") -> set:
    """The ``__global__`` function names of the CUDA sources (and shared
    headers) in ``kernel_dir`` whose names match ``pattern``."""
    names = set()
    for src in Path(kernel_dir).glob(pattern):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
            src.read_text()))
    return names


def base_name(name: str) -> str:
    """A device operation's function name without return type, anonymous
    namespace, template or argument lists."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0]
    head = head.split("<")[0].strip()
    return head.split(" ")[-1] if head.startswith("void ") else head


@dataclasses.dataclass
class TraceSlice:
    ticks: int
    window_s: float          # the device slice's wall (host clock)
    busy_s: float            # union of its device operations
    by_name: dict            # device seconds by base name over the slice
    device_ops: list         # [[name, seconds]], the 10 largest
    idle_gaps: list          # [[what the host was doing, seconds]], 10
    # by base name, each operation's (start us, seconds) in start order
    series: dict = dataclasses.field(default_factory=dict)
    # the start (us) of each ``cut`` inside the slice, in order
    cuts: list = dataclasses.field(default_factory=list)


def cut():
    """A mark on the device between two ticks of a traced slice: the
    operations that start before it belong to the ticks before it.  Not
    one of the slice's operations (``_device_ops`` leaves marks out)."""
    torch.cuda._sleep(CUT_CYCLES)


def profile(run_ticks, host_ops: bool):
    """Run ``run_ticks()`` under the profiler after the marks, with the
    host's operations traced where ``host_ops`` (inside a ``SLICE``
    record_function).  Returns (raw events, wall seconds of the ticks)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host_ops:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(MARKS):
            torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if host_ops:
            with torch.profiler.record_function(SLICE):
                run_ticks()
                torch.cuda.synchronize()
        else:
            run_ticks()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return events(prof), wall


def events(prof) -> list:
    """(name, on the device, start us, end us, thread, is an annotation)
    of each raw event of a profile."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            s, d = e.start_us(), e.duration_us()
        name = e.name()
        note = (e.is_user_annotation() if hasattr(e, "is_user_annotation")
                else False)
        out.append((name, e.device_type() == cuda, s, s + d,
                    e.start_thread_id(), note or name in (SLICE, TICK)))
    return out


def _union(intervals):
    """Merged [start, end] intervals of a list sorted by start."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _device_ops(evs, lo=float("-inf"), hi=float("inf")):
    """(marked, [(start, end, name)]) of the device operations within
    [lo, hi], marks and annotations left out."""
    marked, ops = False, []
    for name, dev, a, b, _, note in evs:
        if not dev or note:
            continue
        if MARK_NAME in name:
            marked = True
        elif b > lo and a < hi:
            ops.append((max(a, lo), min(b, hi), name))
    ops.sort()
    return marked, ops


def read_device(evs, wall_s: float, ticks: int):
    """The device slice's reading, or None when the trace holds no mark
    or no device operation after them."""
    marked, ops = _device_ops(evs)
    if not marked or not ops:
        return None
    busy = _union([[a, b] for a, b, _ in ops])
    by_name, series = {}, {}
    for a, b, name in ops:
        key = base_name(name)
        by_name[key] = by_name.get(key, 0.0) + (b - a) * 1e-6
        series.setdefault(key, []).append((a, (b - a) * 1e-6))
    cuts = sorted(a for name, dev, a, _, _, note in evs
                  if dev and not note and MARK_NAME in name and a > ops[0][0])
    return TraceSlice(
        ticks=ticks, window_s=wall_s,
        busy_s=sum(b - a for a, b in busy) * 1e-6, by_name=by_name,
        device_ops=[[k, v] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[], series=series, cuts=cuts)


def read_gaps(evs):
    """The host slice's idle gaps labelled by host operation, or None when
    the trace holds no slice, no mark or no device operation in it."""
    span = [e for e in evs if e[0] == SLICE and not e[1]]
    if not span:
        return None
    _, _, s0, s1, thread, _ = span[0]
    marked, ops = _device_ops(evs, s0, s1)
    if not marked or not ops:
        return None
    host = [(a, b, name) for name, dev, a, b, th, note in evs
            if not dev and not note and th == thread
            and not name.startswith("cuda") and s0 <= a < s1]
    gaps, last = [], s0
    for a, b in _union([[a, b] for a, b, _ in ops]):
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if s1 > last:
        gaps.append((last, s1))
    return _label_gaps(gaps, host)


def _label_gaps(gaps, host):
    """Idle seconds summed by the innermost host operation under way at
    each gap's middle ("python" where the host ran no operation)."""
    host.sort(key=lambda h: (h[0], -h[1]))     # a parent before its child
    starts = [h[0] for h in host]
    by_label = {}
    stack, i = [], 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) / 2
        while i < len(host) and starts[i] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "python"
        by_label[label] = by_label.get(label, 0.0) + (g1 - g0) * 1e-6
    top = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    return [[k, v] for k, v in top]
