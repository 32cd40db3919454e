"""Profiling registry (reference component C19, include/timing.h + timing.cc).

A copy of ``fiesta_tpu/timing.py`` (framework-free), so that the port's
engine times its stages under the same tags without importing the JAX
package.

Clean-room re-implementation of the voxblox-style timing facility the
reference instruments its pipeline with: RAII timers accumulate per-tag
windowed statistics into a process-wide registry, printable as a table with
the same columns (total, samples, mean +- stddev, min/max over the last
window, Hz).  Tags used by the reference: ``depth`` (Fiesta.h:320),
``raycasting`` (Fiesta.h:288), ``UpdateESDF`` (Fiesta.h:508).

On top of the wall-clock table, step functions may also report device-side
counters (relaxation sweeps, observed/inserted/deleted voxel counts) — the
analog of the reference's expanded-node accumulator (ESDFMap.cpp:393-395).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from io import StringIO
from typing import Dict


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
    """Process-wide mutex-guarded registry (timing.cc singleton)."""

    _lock = threading.Lock()
    _timers: Dict[str, Accumulator] = {}
    _counters: Dict[str, float] = {}

    @classmethod
    def add_sample(cls, tag: str, seconds: float) -> None:
        with cls._lock:
            cls._timers.setdefault(tag, Accumulator()).add(seconds)

    @classmethod
    def count(cls, tag: str, value: float) -> None:
        with cls._lock:
            cls._counters[tag] = cls._counters.get(tag, 0.0) + value

    @classmethod
    def get_mean_seconds(cls, tag: str) -> float:
        with cls._lock:
            acc = cls._timers.get(tag)
            return acc.mean if acc else 0.0

    @classmethod
    def get_total_seconds(cls, tag: str) -> float:
        with cls._lock:
            acc = cls._timers.get(tag)
            return acc.total if acc else 0.0

    @classmethod
    def get_num_samples(cls, tag: str) -> int:
        with cls._lock:
            acc = cls._timers.get(tag)
            return acc.count if acc else 0

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._timers.clear()
            cls._counters.clear()

    @classmethod
    def print_table(cls) -> str:
        """Render the table (columns as timing.cc:173-207)."""
        out = StringIO()
        out.write("Timing\n")
        out.write("-" * 85 + "\n")
        # header widths match the data-row field widths exactly (mean and
        # [min,max] render 19 chars each) so fixed-width parsers line up
        out.write(
            f"{'tag':<24}{'total':>9}{'n':>6}{'mean +- std':>19}"
            f"{'[min,max]':>19}{'Hz':>8}\n"
        )
        with cls._lock:
            for tag in sorted(cls._timers):
                a = cls._timers[tag]
                hz = a.count / a.total if a.total > 0 else 0.0
                out.write(
                    f"{tag:<24}{a.total:>9.3f}{a.count:>6}"
                    f"{a.mean*1e3:>9.3f}+-{a.stddev*1e3:>6.3f}ms"
                    f"  [{a.rolling_min*1e3:>6.3f},{a.rolling_max*1e3:>6.3f}]ms"
                    f"{hz:>8.1f}\n"
                )
            for tag in sorted(cls._counters):
                out.write(f"{tag:<24}{cls._counters[tag]:>12.0f}  (counter)\n")
        return out.getvalue()


class Timer:
    """Context-manager / RAII timer (timing.h:136-166 semantics)::

        with Timer("UpdateESDF"):
            ...
    """

    def __init__(self, tag: str, enabled: bool = True):
        self.tag = tag
        self.enabled = enabled
        self._start = None

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._start is None or not self.enabled:
            return 0.0
        elapsed = time.perf_counter() - self._start
        Timing.add_sample(self.tag, elapsed)
        self._start = None
        return elapsed

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
