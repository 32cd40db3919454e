"""Profiling registry (reference component C19, include/timing.h + timing.cc)
and the port's spans.

The registry re-implements the voxblox-style timing facility the reference
instruments its pipeline with: RAII timers accumulate per-tag windowed
statistics into a process-wide registry, printable as a table with the same
columns (total, samples, mean +- stddev, min/max over the last window, Hz).
Tags used by the reference: ``depth`` (Fiesta.h:320), ``raycasting``
(Fiesta.h:288), ``UpdateESDF`` (Fiesta.h:508).  On a CUDA device the host
clock times only the enqueue, so a ``Timer`` given the device also records
CUDA events around its work, and the registry keeps the device seconds
beside the host's, read from the events once they have completed.

The spans split the map tick by layer.  ``span(name)`` is a context manager
that, while ``enable(True)`` holds, appends one ``Span`` to an in-process
list: its name (every name starts with ``fiesta.``), its parent's index,
the tick number (``fiesta.tick`` advances it, and every span opened after
it shares it), the host clock at entry and exit, the hand-written kernels'
launch totals (``kernels.LAUNCHES``) at entry and exit, and with
``enable(True, device=True)`` CUDA events at entry and exit on the current
stream.  While a ``torch.profiler`` records, each span also opens
``record_function(name)``, so it sits in the profiler's trace on the
trace's clock around the host operations and runtime calls made inside it.
``drain()`` returns the spans and clears the list; the events are read
there, never inside the tick.  Tracing is off by default, and then
``span`` returns one shared object after a single check.  Spans are
recorded from one thread at a time.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from io import StringIO
from typing import Dict, List, Optional

import torch

from . import kernels

#: the span of one map tick; it advances the tick number
TICK = "fiesta.tick"

_on = False            # spans recorded
_device = False        # with CUDA events
_spans: List["Span"] = []
_open: List[int] = []  # indices of the open spans, innermost last
_tick = 0
_in_tick = False       # a TICK span is open


class _Off:
    """The span handed out while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


def _launches() -> int:
    return sum(kernels.LAUNCHES.values())


def _event(device=None):
    """A timing CUDA event recorded on ``device``'s current stream (the
    current device's where None)."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class Span:
    """One recorded span: ``name``, ``parent`` (index in the list of
    records, or None), ``tick``, ``start_ns`` / ``end_ns`` (host,
    ``time.perf_counter_ns``), ``launches_start`` / ``launches_end`` (sum
    of ``kernels.LAUNCHES``) and ``device_ms`` (between its events, set
    by ``drain``; None without events)."""

    __slots__ = ("name", "parent", "tick", "start_ns", "end_ns",
                 "launches_start", "launches_end", "device_ms", "_events",
                 "_note")

    def __init__(self, name: str):
        self.name = name
        self.device_ms = None
        self._events = None
        self._note = None

    def __enter__(self) -> "Span":
        global _tick, _in_tick
        if self.name == TICK:
            _tick += 1
            _in_tick = True
        self.tick = _tick
        self.parent = _open[-1] if _open else None
        _open.append(len(_spans))
        _spans.append(self)
        self.launches_start = _launches()
        if torch.autograd.profiler._is_profiler_enabled:
            self._note = torch.profiler.record_function(self.name)
            self._note.__enter__()
        if _device:
            self._events = (_event(),)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _in_tick
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events += (_event(),)
        if self._note is not None:
            self._note.__exit__(None, None, None)
            self._note = None
        self.launches_end = _launches()
        _open.pop()
        if self.name == TICK:
            _in_tick = False
        return False

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


def span(name: str):
    """A context manager recording the span ``name`` (see the module's
    docstring); a shared no-op while tracing is off, and for a ``TICK``
    inside a ``TICK`` (one tick entry calling another: one span a
    tick)."""
    if not _on:
        return _OFF
    if name == TICK and _in_tick:
        return _OFF
    return Span(name)


def enable(on: bool, device: bool = False) -> None:
    """Turn span recording on or off; ``device``: CUDA events per span."""
    global _on, _device
    _on, _device = bool(on), bool(on and device)


def drain() -> List[Span]:
    """The spans recorded since the last drain, their device times read
    (this waits for their end events); clears the list.  Call between
    ticks, with no span open."""
    out = list(_spans)
    _spans.clear()
    for s in out:
        if s._events is not None and len(s._events) == 2:
            s._events[1].synchronize()
            s.device_ms = s._events[0].elapsed_time(s._events[1])
        s._events = None
    return out


def span_table(spans: List[Span]) -> str:
    """Per span name: spans, host ms (total and self: less the direct
    children's), device ms (CUDA events; "-" without) and hand-written
    kernel launches, over ``spans`` (one ``drain``'s list)."""
    child = [0] * len(spans)
    for s in spans:
        if s.parent is not None:
            child[s.parent] += s.end_ns - s.start_ns
    rows: Dict[str, list] = {}
    for i, s in enumerate(spans):
        r = rows.setdefault(s.name, [0, 0.0, 0.0, None, 0])
        r[0] += 1
        r[1] += s.host_ms
        r[2] += (s.end_ns - s.start_ns - child[i]) * 1e-6
        if s.device_ms is not None:
            r[3] = (r[3] or 0.0) + s.device_ms
        r[4] += s.launches_end - s.launches_start
    out = StringIO()
    out.write("Spans\n" + "-" * 85 + "\n")
    out.write(f"{'span':<26}{'n':>7}{'host ms':>12}{'self ms':>12}"
              f"{'device ms':>12}{'launches':>10}\n")
    for name in sorted(rows):
        n, host, own, dev, launches = rows[name]
        dev_txt = f"{dev:>12.3f}" if dev is not None else f"{'-':>12}"
        out.write(f"{name:<26}{n:>7}{host:>12.3f}{own:>12.3f}{dev_txt}"
                  f"{launches:>10}\n")
    return out.getvalue()


class Accumulator:
    """Windowed statistics accumulator (timing.h:37-104 semantics)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.total = 0.0
        self.count = 0
        self.sum_sq = 0.0
        self.recent = deque(maxlen=window)

    def add(self, value: float) -> None:
        self.total += value
        self.count += 1
        self.sum_sq += value * value
        self.recent.append(value)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def stddev(self) -> float:
        if self.count < 2:
            return 0.0
        var = (self.sum_sq - self.total * self.total / self.count) / (
            self.count - 1
        )
        return math.sqrt(max(var, 0.0))

    @property
    def rolling_min(self) -> float:
        return min(self.recent) if self.recent else 0.0

    @property
    def rolling_max(self) -> float:
        return max(self.recent) if self.recent else 0.0


class Timing:
    """Process-wide mutex-guarded registry (timing.cc singleton): host
    seconds per tag and, from ``Timer``s given a CUDA device, the device
    seconds of the work under the tag."""

    _lock = threading.Lock()
    _timers: Dict[str, Accumulator] = {}
    _device: Dict[str, Accumulator] = {}
    _pending: list = []       # (tag, start event, end event), in order

    @classmethod
    def add_sample(cls, tag: str, seconds: float) -> None:
        with cls._lock:
            cls._timers.setdefault(tag, Accumulator()).add(seconds)

    @classmethod
    def add_device(cls, tag: str, start, end) -> None:
        """The device seconds between two recorded CUDA events, read once
        ``end`` has completed (never waited for here)."""
        with cls._lock:
            cls._pending.append((tag, start, end))
            cls._resolve(wait=False)

    @classmethod
    def _resolve(cls, wait: bool) -> None:
        """Read the pending events in order up to the first one not yet
        complete; ``wait``: all of them, waiting for each.  Holds the
        lock."""
        done = 0
        for tag, start, end in cls._pending:
            if wait:
                end.synchronize()
            elif not end.query():
                break
            cls._device.setdefault(tag, Accumulator()).add(
                start.elapsed_time(end) * 1e-3)
            done += 1
        del cls._pending[:done]

    @classmethod
    def get_mean_seconds(cls, tag: str) -> float:
        """Mean host seconds (the enqueue, on a CUDA device)."""
        with cls._lock:
            acc = cls._timers.get(tag)
            return acc.mean if acc else 0.0

    @classmethod
    def get_mean_device_seconds(cls, tag: str) -> Optional[float]:
        """Mean device seconds of the work under ``tag`` (waits for its
        pending events), or None where it has none."""
        with cls._lock:
            cls._resolve(wait=True)
            acc = cls._device.get(tag)
            return acc.mean if acc else None

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._timers.clear()
            cls._device.clear()
            cls._pending.clear()

    @classmethod
    def print_table(cls) -> str:
        """Render the table (columns as timing.cc:173-207), the device
        mean +- std beside the host's where the tag has one (waits for
        its pending events)."""
        out = StringIO()
        out.write("Timing\n")
        out.write("-" * 104 + "\n")
        # header widths match the data-row field widths exactly (mean and
        # [min,max] render 19 chars each) so fixed-width parsers line up
        out.write(
            f"{'tag':<24}{'total':>9}{'n':>6}{'mean +- std':>19}"
            f"{'[min,max]':>19}{'Hz':>8}{'device mean +- std':>19}\n"
        )
        with cls._lock:
            cls._resolve(wait=True)
            for tag in sorted(cls._timers):
                a = cls._timers[tag]
                hz = a.count / a.total if a.total > 0 else 0.0
                d = cls._device.get(tag)
                dev = (f"{d.mean*1e3:>9.3f}+-{d.stddev*1e3:>6.3f}ms"
                       if d else f"{'-':>19}")
                out.write(
                    f"{tag:<24}{a.total:>9.3f}{a.count:>6}"
                    f"{a.mean*1e3:>9.3f}+-{a.stddev*1e3:>6.3f}ms"
                    f"  [{a.rolling_min*1e3:>6.3f},{a.rolling_max*1e3:>6.3f}]ms"
                    f"{hz:>8.1f}{dev}\n"
                )
        return out.getvalue()


class Timer:
    """Context-manager / RAII timer (timing.h:136-166 semantics)::

        with Timer("UpdateESDF", device):
            ...

    adds the host seconds under the tag and, where ``device`` is a CUDA
    device, CUDA events around the work on the current stream, read into
    the tag's device seconds once complete: no synchronise."""

    def __init__(self, tag: str, device=None):
        self.tag = tag
        device = None if device is None else torch.device(device)
        self.device = device if device and device.type == "cuda" else None
        self._start = None
        self._event = None

    def start(self) -> "Timer":
        if self.device is not None:
            self._event = _event(self.device)
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._start is None:
            return 0.0
        elapsed = time.perf_counter() - self._start
        Timing.add_sample(self.tag, elapsed)
        if self._event is not None:
            Timing.add_device(self.tag, self._event, _event(self.device))
            self._event = None
        self._start = None
        return elapsed

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
