#!/usr/bin/env python3
"""Where the port's time goes, on one CUDA card: the cow_and_lady tick,
the app engine's frames and the demo preset's windowed depth tick.

    python3 profile_torch.py [--ticks N]

Runs the tick stream of ``chip_smoke.py`` (same config, scans and seed):
one warm tick, then the timed ticks four times, each from a copy of the
warm state (a tick gives up the state it is handed), and prints one JSON
object:

* ``ms_per_tick``: the median of three windows of the timed ticks through
  ``fused_stream`` without the profiler (CUDA events around the stream;
  ``ms_per_tick_windows`` lists all three);
* ``profile``: ``torch.profiler`` over the same ticks run again: device
  time summed by kernel name (top 15), device busy time, the share of it
  in the hand-written kernels, and the wall time under the profiler
  (which adds host work per op).  Kernels that overlap would count twice
  in ``busy``; the tick runs on one stream;
* ``device_idle_share``: 1 - busy / ``ms_per_tick``, against the
  unprofiled tick, and ``other_ms_per_tick``: the unprofiled tick less
  the hand kernels' device time;
* ``derive_closest``: the lazy closest derivation on the final map, three
  calls under the profiler after a warm one: device busy and hand-kernel
  time per call, wall time per call, and the top kernels;
* ``demo``: the same for the demo preset's ``fused_depth_stream`` with
  the local window (``chip_smoke.demo_config``, depth ticks staged as
  there), per tick;
* ``engine``: ``FiestaPipeline(cfg, "scanline")`` streaming the replay's
  frames with ``update()`` every third (after three warm frames): ms per
  frame from the host clock around the whole run, ended by one
  synchronise (``process()`` never waits), then the device time of the
  same frames run again under the profiler, per frame;
* the card's name and power limit beside the numbers.

Kernel names are cut at their argument list.
"""

import argparse
import json
import re
import statistics
import time
from pathlib import Path

import torch

import chip_smoke
import fiesta_tpu_torch as ft
from fiesta_tpu_torch import kernels
from fiesta_tpu_torch.io import replay


def hand_kernel_names():
    """Names of the ``__global__`` functions in the port's CUDA sources
    and their shared header."""
    names = set()
    for src in Path(kernels.__file__).parent.glob("*.cu*"):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
            src.read_text()))
    return names


def summary(by_name, hand):
    """(busy ms, hand-kernel ms, top 15 kernels) of a profile."""
    hand_ms = sum(v for k, v in by_name.items()
                  if k.split("<")[0].split(" ")[-1] in hand)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return sum(by_name.values()), hand_ms, dict(top)


def stream_breakdown(run, units, hand):
    """Three unprofiled runs of ``units`` ticks (``run()`` returns the
    CUDA-event ms of its ticks, its input state made outside them), then
    one run under the profiler: per-tick ms, device busy, idle share,
    hand-kernel ms and the top kernels."""
    windows = []
    for _ in range(3):
        windows.append(run() / units)
    by_name, _, wall_ms = chip_smoke.profiled(run, 1)
    busy, hand_ms, top = summary({k: v / units for k, v in by_name.items()},
                                 hand)
    ms = statistics.median(windows)
    return {"ms_per_tick": ms, "ms_per_tick_windows": windows,
            "device_busy_ms_per_tick": busy or None,
            "device_idle_share": 1 - busy / ms if busy else None,
            "hand_kernels_ms_per_tick": hand_ms,
            "wall_ms_per_tick_under_profiler": wall_ms / units,
            "top_kernels_ms_per_tick": top}


def timed_events(fn):
    """ms of ``fn()`` between two CUDA events."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def demo_breakdown(ticks, dev, hand):
    dcfg = chip_smoke.demo_config()
    d, t, p = chip_smoke.demo_batches(dcfg, chip_smoke.DH, chip_smoke.DW,
                                      ticks + 1, dev)
    warm_state, _ = ft.fused_depth_stream(dcfg, ft.make_state(dcfg, dev),
                                          d[:1], t[:1], p[:1],
                                          use_window=True)

    def run():
        state = ft.copy_state(warm_state)
        return timed_events(lambda: ft.fused_depth_stream(
            dcfg, state, d[1:], t[1:], p[1:], use_window=True))

    return stream_breakdown(run, ticks, hand)


def engine_breakdown(cfg, frames, dev, hand):
    """Three warm frames, then the rest streamed twice (host clock, then
    the profiler), each into its own engine warmed the same way."""
    warm, rest = frames[:3], frames[3:]

    def engine():
        pipe = ft.FiestaPipeline(cfg, method="scanline", device=dev)
        feed(pipe, warm)
        pipe.sync_device()
        return pipe

    def feed(pipe, chunk):
        n = 0
        for i, (t, (pos, quat), scan) in enumerate(chunk):
            pipe.observe_pose(t, pos, quat)
            pipe.observe_cloud(t, scan)
            n += pipe.process()
            if i % 3 == 2:
                pipe.update()
        return n

    pipe = engine()
    t0 = time.perf_counter()
    n = feed(pipe, rest)
    pipe.sync_device()
    ms = (time.perf_counter() - t0) * 1e3 / n
    pipe = engine()
    by_name, _, wall_ms = chip_smoke.profiled(lambda: feed(pipe, rest),
                                              1)
    busy, hand_ms, top = summary({k: v / n for k, v in by_name.items()},
                                 hand)
    return {"frames": n, "ms_per_frame": ms,
            "device_busy_ms_per_frame": busy or None,
            "device_idle_share": 1 - busy / ms if busy else None,
            "hand_kernels_ms_per_frame": hand_ms,
            "wall_ms_per_frame_under_profiler": wall_ms / n,
            "top_kernels_ms_per_frame": top}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs a CUDA device")
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    cfg = chip_smoke.cow_config()
    _, frames = replay.make_sequence(
        cfg, n_frames=3 * (args.ticks + 1), n_boxes=20, seed=0,
        kind="cloud", height=chip_smoke.H, width=chip_smoke.W, period=12.0,
        orbit_radius=5.0)
    batches = replay.stage_update_batches(cfg, frames, device=dev)
    warm = tuple(b[:1] for b in batches)
    timed = tuple(b[1:] for b in batches)
    ticks = args.ticks

    # unprofiled windows
    warm_state, _ = ft.fused_stream(cfg, ft.make_state(cfg, dev), *warm)
    windows = []
    for _ in range(3):
        state = ft.copy_state(warm_state)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ft.fused_stream(cfg, state, *timed)
        b.record()
        b.synchronize()
        windows.append(a.elapsed_time(b) / ticks)
    ms_per_tick = statistics.median(windows)

    # the same ticks under the profiler, then the lazy closest derivation
    hand = hand_kernel_names()
    final = [ft.copy_state(warm_state)]
    tick, _, wall_ms = chip_smoke.profiled(
        lambda: final.append(ft.fused_stream(cfg, final[0], *timed)[0]), 1)
    busy, hand_ms, top = summary({k: v / ticks for k, v in tick.items()},
                                 hand)
    logodds = final[-1].logodds
    ft.derive_closest(cfg, logodds)
    closest, _, closest_wall = chip_smoke.profiled(
        lambda: ft.derive_closest(cfg, logodds), 3)
    c_busy, c_hand, c_top = summary(closest, hand)
    demo = demo_breakdown(ticks, dev, hand)
    engine = engine_breakdown(cfg, frames, dev, hand)
    print(json.dumps({
        "card": card, "ticks": ticks,
        "ms_per_tick": ms_per_tick,
        "ms_per_tick_windows": windows,
        "device_busy_ms_per_tick": busy or None,
        "device_idle_share": 1 - busy / ms_per_tick if busy else None,
        "hand_kernels_ms_per_tick": hand_ms,
        "other_ms_per_tick": ms_per_tick - hand_ms,
        "profile": {
            "wall_ms_per_tick": wall_ms / ticks,
            "device_idle_share_under_profiler":
                1 - busy * ticks / wall_ms if busy else None,
            "top_kernels_ms_per_tick": top,
        },
        "derive_closest": {
            "device_busy_ms": c_busy, "hand_kernels_ms": c_hand,
            "wall_ms_under_profiler": closest_wall,
            "top_kernels_ms": c_top,
        },
        "demo": demo,
        "engine": engine}, indent=1))


if __name__ == "__main__":
    main()
