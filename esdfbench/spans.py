"""The program's own spans in the traced run: host time, device time,
launches and host synchronisations by layer of the tick.

The program (``fiesta_tpu_torch.timing``) records a span at each layer of
its tick, every name starting with ``fiesta.``; ``fiesta.tick`` is the
whole tick call.  After the traced run's window, the first per-layer
metric that reads them (``measure``) starts ``python3 -m esdfbench.spans``,
a process of its own on the same card that no profiler has touched (a
CUDA profile slows the host for the rest of its process), which runs the
cell on the program's tick entry: one orbit of scans made from the run's
seed, a new map, four whole orbits:

* a warm orbit, untraced, which launches every shape, then one more
  with the spans off, for the host ms around each call (and around the
  planner's read inside it, where the cell reads the map);
* the span orbit: the program's spans on, in memory only (no profiler, no
  CUDA events), so the host runs at nearly its untraced pace: host ms a
  tick by span (``host_ms``, inclusive of the span's children);
* the span-trace orbit: the spans on under ``torch.profiler`` with CPU
  and CUDA activity, each span a ``record_function`` range on the trace's
  clock, and the planner's read inside a range of the harness's own
  (``harness.READ_MARK``); ``read_spans`` reads it.

These ticks are not the window's: they change no end-to-end metric, no
``dispatch_ms`` and no other reader's slice, and the check does not
replay them.  Where the program records no span (it has no
``timing.enable``, or its ticks open none), ``measure`` gives None and
each metric reads nothing."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import generator, harness, spec, trace

PREFIX = "fiesta."
TICK = "fiesta.tick"
#: the harness's range around the planner's read (the program opens no
#: span there: the planner calls ``ops/query.py`` directly)
READ = harness.READ_MARK
#: runtime calls after which the host has waited for the device
SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
#: label of an idle gap in which no program span was open on the host
NO_SPAN = "outside spans"


def run_seed() -> int:
    """The run's ``--seed`` (``esdfbench.run``'s command line), else 0."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def events(prof) -> list:
    """(name, on the device, start us, end us, thread, correlation id, is
    an annotation) of each raw event of a profile."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        out.append((e.name(), e.device_type() == cuda, s,
                    s + e.duration_ns() / 1e3, e.start_thread_id(),
                    e.correlation_id(), e.is_user_annotation()))
    return out


def _parents(intervals) -> list:
    """The index of the innermost interval enclosing each of the nested
    intervals (start, end, ...), or None."""
    order = sorted(range(len(intervals)),
                   key=lambda i: (intervals[i][0], -intervals[i][1]))
    parent, stack = [None] * len(intervals), []
    for i in order:
        while stack and intervals[stack[-1]][1] <= intervals[i][0]:
            stack.pop()
        parent[i] = stack[-1] if stack else None
        stack.append(i)
    return parent


def _innermost(intervals, points) -> dict:
    """{key: index of the innermost of the nested ``intervals`` (start,
    end, ...) holding time t, or None} for each (t, key) of ``points``."""
    order = sorted(range(len(intervals)),
                   key=lambda i: (intervals[i][0], -intervals[i][1]))
    out, stack, j = {}, [], 0
    for t, key in sorted(points):
        while j < len(order) and intervals[order[j]][0] <= t:
            while stack and intervals[stack[-1]][1] < intervals[order[j]][0]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and intervals[stack[-1]][1] < t:
            stack.pop()
        out[key] = stack[-1] if stack else None
    return out


def read_spans(evs, ticks: int):
    """The span-trace orbit's reading, or None where the trace holds no
    program span.  The program's spans are the host annotations named
    ``fiesta.*`` of the thread that opened the slice (``trace.SLICE``),
    which issues every runtime call of the orbit.  Returns a dict:

    * ``spans``: per span name, a tick: ``host_self_ms`` (the spans' host
      time less their child spans'), ``device_ms`` and ``launches`` (the
      device operations, and their time, whose runtime call, found by its
      correlation id, the span is the innermost to enclose) and ``syncs``
      (the runtime synchronisations it is the innermost to enclose);
    * ``tick``: ``launches``, ``syncs`` and ``device_ms`` a tick under
      ``fiesta.tick`` and its children; ``ops``, the device operations of
      the trace, and ``unattributed``, those under no program span;
    * ``read``: ``launches``, ``syncs`` and ``device_ms`` a tick under the
      read's range (``READ``) and the spans inside it, or None where the
      trace holds none;
    * ``marked``: whether the trace holds a mark (``trace.MARK_NAME``);
    * ``span_gaps``: the device's idle gaps within the slice, seconds by
      the innermost program span open at each gap's middle (``NO_SPAN``
      where none), the 10 largest.
    """
    outer = [e for e in evs if e[0] == trace.SLICE and not e[1]]
    if not outer or not ticks:
        return None
    _, _, s0, s1, thread, _, _ = outer[0]
    spans = [(a, b, name) for name, dev, a, b, th, _, note in evs
             if not dev and th == thread
             and (name.startswith(PREFIX) or name == READ)]
    if not spans:
        return None
    parent = _parents(spans)

    def under(names):
        """Whether each span is one of ``names`` or lies inside one."""
        out = []
        for i in range(len(spans)):
            j = i
            while j is not None and spans[j][2] not in names:
                j = parent[j]
            out.append(j is not None)
        return out

    under_tick, under_read = under((TICK,)), under((READ,))
    rows = {}

    def row(name):
        return rows.setdefault(name, {"host_self_ms": 0.0, "device_ms": 0.0,
                                      "launches": 0, "syncs": 0})

    for i, (a, b, name) in enumerate(spans):
        row(name)["host_self_ms"] += (b - a) * 1e-3
        if parent[i] is not None:
            row(spans[parent[i]][2])["host_self_ms"] -= (b - a) * 1e-3
    # the CUDA runtime and driver calls (host operations number their
    # correlation ids apart, so only these are matched to the device's)
    called, syncs = {}, []
    for k, (name, dev, a, _, _, corr, _) in enumerate(evs):
        if dev or not name.startswith("cu") or not s0 <= a <= s1:
            continue
        if corr:
            called.setdefault(corr, a)
        if name in SYNCS:
            syncs.append((a, k))
    marked, ops = _device_ops(evs)
    at_call = _innermost(spans, [(called[c], c) for _, _, _, c in ops
                                 if c in called])
    tick = {"launches": 0, "syncs": 0, "device_ms": 0.0, "ops": len(ops),
            "unattributed": 0}
    read = {"launches": 0, "syncs": 0, "device_ms": 0.0}
    for a, b, _, corr in ops:
        i = at_call.get(corr)
        if i is None:
            tick["unattributed"] += 1
            continue
        r = row(spans[i][2])
        r["device_ms"] += (b - a) * 1e-3
        r["launches"] += 1
        for total, inside in ((tick, under_tick), (read, under_read)):
            if inside[i]:
                total["launches"] += 1
                total["device_ms"] += (b - a) * 1e-3
    for i in _innermost(spans, syncs).values():
        if i is not None:
            row(spans[i][2])["syncs"] += 1
            tick["syncs"] += under_tick[i]
            read["syncs"] += under_read[i]
    for r in rows.values():
        for k in ("host_self_ms", "device_ms", "launches", "syncs"):
            r[k] /= ticks
    for total in (tick, read):
        for k in ("launches", "syncs", "device_ms"):
            total[k] /= ticks
    return {"spans": rows, "tick": tick,
            "read": read if any(under_read) else None, "marked": marked,
            "span_gaps": _span_gaps(spans, ops, s0, s1)}


def _device_ops(evs):
    """(marked, [(start, end, name, correlation id)]) of the device
    operations, the marks, annotations and program spans left out."""
    marked, ops = False, []
    for name, dev, a, b, _, corr, note in evs:
        if not dev or note or name.startswith(PREFIX) or name == READ:
            continue
        if trace.MARK_NAME in name:
            marked = True
        else:
            ops.append((a, b, name, corr))
    ops.sort()
    return marked, ops


def _span_gaps(spans, ops, s0, s1):
    """The device's idle gaps within [s0, s1], seconds by the innermost
    of ``spans`` open at each gap's middle, the 10 largest."""
    busy = trace._union([[max(a, s0), min(b, s1)] for a, b, _, _ in ops
                         if b > s0 and a < s1])
    gaps, last = [], s0
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if s1 > last:
        gaps.append((last, s1))
    at = _innermost(spans, [((g0 + g1) / 2, k)
                            for k, (g0, g1) in enumerate(gaps)])
    by = {}
    for k, (g0, g1) in enumerate(gaps):
        label = NO_SPAN if at[k] is None else spans[at[k]][2]
        by[label] = by.get(label, 0.0) + (g1 - g0) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]]


def host_ms(spans, ticks: int) -> dict:
    """Host ms a tick by span name (each span's whole interval) over one
    ``timing.drain()`` of the span orbit."""
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-6
    return {k: v / ticks for k, v in out.items()}


def _profile(run_ticks, device):
    """``run_ticks()`` under the profiler (CPU activity, and CUDA's on the
    card, after the marks), inside a ``trace.SLICE`` range; raw events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = device.type == "cuda"
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            for _ in range(trace.MARKS):
                torch.cuda._sleep(trace.MARK_CYCLES)
            torch.cuda.synchronize()
        with torch.profiler.record_function(trace.SLICE):
            run_ticks()
            harness.sync(device)
    return events(prof)


def orbits(cell, seed: int, device):
    """The three orbits in this process (see the module's docstring):
    ``read_spans``' dict with ``host_ms`` (the span orbit's, by span name),
    ``call_ms`` (host ms around each call, as ``dispatch_ms`` times it:
    ``off`` in an orbit after the warm one, spans off, ``on`` in the span
    orbit), ``read_ms`` (host ms a tick around the planner's read in the
    ``off`` orbit, None where the cell does not read the map) and
    ``seconds`` (each phase's wall), or None where no span was
    recorded."""
    import fiesta_tpu_torch as ft
    from fiesta_tpu_torch import timing

    t0 = time.perf_counter()
    cfg = ft.config_from_fields(cell.fields).validate()
    stream = generator.make_stream(cell.fields, cell.traffic, seed, device)
    ticks = harness.Ticks(cfg, stream)
    n = stream.ticks_per_orbit
    state = ft.make_state(cfg, device)

    def orbit(calls=None, reads=None):
        nonlocal state
        for j in range(n):
            c0 = time.perf_counter()
            state, _ = ticks(state, j)
            if calls is not None:
                calls.append((time.perf_counter() - c0) * 1e3)
            if reads is not None and ticks.read_ms is not None:
                reads.append(ticks.read_ms)

    off, on, reads = [], [], []
    orbit()
    orbit(off, reads)
    harness.sync(device)
    t1 = time.perf_counter()
    try:
        timing.enable(True)
        orbit(on)
        harness.sync(device)
        hosts = host_ms(timing.drain(), n)
        t2 = time.perf_counter()
        found = None
        ticks.mark_read = True
        for _ in range(3):      # the profiler has been seen to trace nothing
            evs = _profile(orbit, device)
            timing.drain()
            found = read_spans(evs, n)
            del evs
            if found is not None and (device.type != "cuda" or (
                    found["marked"] and found["tick"]["ops"])):
                break
            found = None
    finally:
        timing.enable(False)
        timing.drain()
    if not hosts or found is None:
        return None
    return dict(found, host_ms=hosts,
                call_ms={"off": sum(off) / n, "on": sum(on) / n},
                read_ms=sum(reads) / n if reads else None,
                seconds={"warm": t1 - t0, "span": t2 - t1,
                         "span_trace": time.perf_counter() - t2})


def measure(reading, device=None, seed=None):
    """The span orbits' reading, cached on ``reading.spans``, or None where
    the program records no span.  They run in a process of their own
    (``python3 -m esdfbench.spans``), which no profiler has touched: a
    CUDA profile slows the host's enqueue for the rest of its process
    (by a half, PERF.md), and the window's traced slices have run in
    this one."""
    if hasattr(reading, "spans"):
        return reading.spans
    reading.spans = None
    from fiesta_tpu_torch import timing

    if not hasattr(timing, "enable"):
        return None
    import fiesta_tpu_torch as ft

    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    seed = run_seed() if seed is None else seed
    cell = reading.cell
    program = str(Path(ft.__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(cell.root), program, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "esdfbench.spans", "--workload", cell.name,
         "--seed", str(seed), "--root", str(cell.root), "--device",
         str(device)], cwd=cell.root, env=env, stdout=subprocess.PIPE,
        text=True, timeout=900)
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines:
        harness.log(f"span orbits: exit {out.returncode}, no reading")
        return None
    found = json.loads(lines[-1])
    if found is None:
        return None
    table = {name: dict(r, host_ms=found["host_ms"].get(name, 0.0))
             for name, r in found["spans"].items()}
    harness.log(f"span orbits: call ms a tick {found['call_ms']['off']:.4f} "
                f"spans off, {found['call_ms']['on']:.4f} on; read ms "
                f"{found['read_ms']}; seconds "
                f"{json.dumps(found['seconds'])}")
    harness.log(f"span orbits: spans {json.dumps(table)}; tick "
                f"{json.dumps(found['tick'])}; read "
                f"{json.dumps(found['read'])}; span_gaps "
                f"{json.dumps(found['span_gaps'])}")
    reading.spans = found
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=orbits.__doc__.split(".")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--device", required=True)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    torch.set_num_threads(1)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cell = spec.load_cell(args.workload, Path(args.root))
    print(json.dumps(orbits(cell, args.seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
