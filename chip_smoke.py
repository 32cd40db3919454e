#!/usr/bin/env python3
"""Drive fiesta_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Thirteen paths are driven, eleven at cow_and_lady size (400x400x80 voxels
at 0.05 m, exact EDT truncated at 100 voxels) on replayed scans made from
seed 0: the mapping tick stream (3 scans of 192x256 rays per tick, lazy
closest), the closest-obstacle query path on the map it leaves, the same
stream with the sorted splat, the app engine (``FiestaPipeline``), the
same stream with the two-level EDT, the planner on the stream's map, the
stream and the engine with the incremental ESDF engine, the unbounded
world (the scrolling grid with its tile archive), the app itself
(``python -m fiesta_tpu_torch.run``, with its npz and ROS-bag inputs),
the soak drill (``soak_torch.py``) and the multi-device engine
(``fiesta_tpu_torch.parallel``) on virtual meshes of the one card; and
the demo preset's windowed depth tick (400x400x36 voxels at 0.1 m,
120x160 depth images); and the closest path on cow_and_lady's scans at
0.05 m on a 40 m floor (800x800x80 voxels), where the packed closest word
misses int32 and the wide transform runs.  Then the seven benchmark twins
(``bench*_torch.py``) run whole, each at its full size.
Each path's kernel launch counts are zeroed just before it and read just
after.  Phases, in order but for 15, which runs after 8, and 14, which
runs after 10; any failure raises and exits non-zero:

1. device and build: the card's name and power limit (nvidia-smi), then
   every kernel built with nvcc from the sources in this checkout (timed),
   and each kernel's registers and shared memory from ptxas;
2. the stream: ``fused_stream`` with the kernels, launch counts zeroed
   just before and read just after (each of its kernels must have
   launched); then the same ticks through the plain PyTorch versions on
   the card.  The final MapState and every tick's UpdateStats must be
   bit-equal and the map must hold more than 1000 occupied voxels;
3. the closest/query path on the final map, launch counts zeroed just
   before and read just after (each closest kernel must have launched):
   ``derive_closest``, two ticks in eager closest mode, and 2^19 query
   positions (the map plus a few outside it and a NaN) through
   ``get_distance``, ``get_dist_grad_trilinear`` and
   ``get_closest_obstacle``; then all of it through the plain versions.
   The closest grids, d2, the eager states and the query outputs must be
   bit-equal, and the eager closest equal to the lazy derivation on the
   same occupancy.  ``derive_closest`` is timed both ways, and its busy
   time and CUDA launches read from ``torch.profiler`` (the three packed
   passes and the closest decode);
4. the sorted splat: the phase-2 stream again with ``FIESTA_SPLAT=sorted``
   and ``FIESTA_SPLAT_SORT_IMPL=pallas`` (set on ``ops.raycast``); the sort
   kernel must launch and the final state and stats equal phase 2's;
5. the app engine: ``FiestaPipeline(cfg, "scanline")`` fed 9 frames of the
   phase-2 replay the way ``run.py`` feeds it (``observe_pose`` /
   ``observe_cloud`` / ``process()``, ``update()`` every third frame),
   then the three queries on the phase-3 positions; kernels, then plain.
   The final state, the closest grid and the query outputs must be
   bit-equal, and the tick's and the closest path's kernels must have
   launched, and neither ``process()`` nor ``update()`` may wait for the
   device; ms per ``process()`` frame and per ``update()``.  Then the
   ``dda`` and ``projective`` integrators on 3 frames each (plain
   PyTorch on the card): ms per frame and the occupied count;
6. the demo preset: ``fused_depth_stream`` with the local window, 5 ticks
   of 3 depth frames staged as ``bench_demo.py`` stages them; kernels,
   then plain: bit-equal states and stats, the windowed drain and the
   tick's kernels launched, ms/tick, and an occupied-voxel floor;
7. each kernel against its plain version on the card at the main path's
   own shapes (splat and sort on the first tick's rays, carve on the
   seeds the splat gives, the drain and box add on a tick of counters,
   the EDT and closest passes on the stream's final occupancy, the
   windowed drain at the demo's shapes): exact equality, and median
   times (CUDA events) beside the plain version's, a library call's where
   one computes the same function, and the card's bound.  A kernel's
   ``ms`` is host-paced (calls back to back, as the main path makes
   them); beside it, queued behind a device sleep, the card's time
   alone.  Each row traced by ``torch.profiler`` also prints its CUDA
   launches per call and device time by kernel name; the splat's zero
   fill has a row of its own, and the windowed drain's row takes the
   same timings.  The closest binary pass
   logs its column tiles and those holding a seed (the others only
   write).  The carve is also timed at the demo box (on the demo's first
   tick) and prints its wavefronts' steps; the depth kernel is timed at
   the demo cell's 3 frames of 480x640, filtered (``depth_row``), and
   the splat prep at the cow and demo cells' ticks (``prep_row``); the
   min-plus pass prints its window offsets per voxel (``minplus_taps``),
   the closest split pass those of each side (``split_taps``) and the
   closest window pass those of its two sides together
   (``window_taps``), each beside the
   brute-force window's, and both closest passes their time on the card
   alone with every value at cap (``far_device_ms``: load and store
   alone); the closest decode on the split pass's words, as
   ``derive_closest`` calls it (the packed grid out);
8. the two-level tick: the phase-2 stream with ``edt_fine_dist`` 2.0 m
   (exact to t = 40 on the grid, the far field at t = 50 on its
   200x200x40 half): 5 ticks with lazy closest, ``derive_closest`` and 2
   eager ticks, kernels then plain.  States, stats and closest grids
   bit-equal, the eager closest equal to the lazy derivation, the five
   EDT and closest kernels launched at both levels (counted by level);
   ms/tick beside the flat tick's (in turns), device busy of both, the
   voxels whose d2 differs from phase 2's exact d2 (none within the fine
   radius), and the five kernels at the coarse shapes against their
   plain versions, timed beside their bounds;
9. the planner on phase 2's final map at ``MPCConfig()`` (16384
   rollouts, horizon 30, 8 refine steps), p0 and goal as ``run.py``
   sets them, a CUDA generator seeded 0: one solve, ms per ``plan_step``,
   10 receding-horizon steps as ``run.py --fly`` runs them (ms per step),
   one signed solve and one with trilinear sampling, a solve's device
   busy time and CUDA launches and the sampling stage's time alone; every
   cost finite, best sample cost <= mean, and a solve from CPU draws on
   the card within 1e-3 of the same solve on the CPU; then the same
   check on a flight whose straight line crosses a mapped obstacle, where
   the collision term must be nonzero for a share of the samples and for
   the nominal, and the nominal's cost gradient on the card within 1e-5
   relative of the CPU's;
10. the incremental engine: the phase-2 stream with ``esdf_mode``
   "incremental" (FIESTA's insert/delete relaxation, swept to its
   fixpoint by the ``relax`` kernel in one cooperative launch a tick),
   globally and in the demo preset's window; kernels, then plain: states
   and every tick's UpdateStats (sweeps included) bit-equal, one relax
   launch a tick, every defined voxel's d2 equal to |v - closest|^2 with
   its closest occupied, and d2 never below the exact EDT where that is
   below t^2 (phase 2's, globally), counted over the grid and, windowed,
   inside the last update window too; the relax kernel, on each stream's
   tick with the most sweeps and its last, timed host-paced and on the
   card alone per call and per sweep, beside its two bounds (dense, and
   the frontier's: the dense first sweep and then the candidates of
   changed neighbours), the frontier's own bit tests and tile moves apart,
   and the plain loop, with the voxels that changed in each sweep (the
   plain loop on the card), the tiles the kernel visited and its grid's
   blocks an SM; one more tick's CUDA launches and busy time; the
   ``changes`` kernel (the tick's inserts and bucket resets) on one more
   tick of the global stream's map, against its plain version, its
   launches and times beside its bytes bound (``changes_row``); then
   ``FiestaPipeline`` in
   incremental mode on phase 5's frames, ``update()`` every third frame
   under sync debug mode "error", kernels then plain;
11. the unbounded world: ``ScrollingFiestaPipeline`` with a tile archive
   at cow_and_lady on 24 scans of an orbit of 8 m in a 60 m box world
   (past the grid's central box), ``update()`` every third frame, in
   rebuild then incremental mode: at least two scrolls and a restore;
   every entered strip holds what was evicted there; kernels, then plain:
   states, anchor, counts and tiles bit-equal; a checkpoint saved on the
   card loads back bit-equal with its anchor; ms per recenter with its
   drain, strip transfers and re-derive;
12. the app: ``fiesta_tpu_torch.run.main`` in this process at
   ``--preset cow_and_lady`` on 30 synthetic frames, an update every
   third, with ``--checkpoint-every 3``, ``--viz-dir``,
   ``--ground-truth-check`` and ``--mpc``, its replay loop under sync
   debug mode "error" (no ``process()`` or ``update()`` waits for the
   device): the stream's kernels launched, the oracle's count_under 0, a
   finite MPC cost; ms per frame (its steady-state line), per ``update()``
   (its timing table), the loop's seconds with those of its
   ``process()``, ``update()`` and periodic checkpoint saves apart (a save
   reads the map back, so it waits for the device), and the wall time.  Then the same run on the plain
   versions, and the same frames replayed from an ``.npz`` and from a ROS
   bag with the preset's topics (an update a frame): checkpoints
   bit-equal kernels == plain and npz == bag; and once with
   ``--esdf-mode incremental``, the relax kernel launched;
13. the soak: ``soak_torch.py``'s drill at cow scale (150 frames, 1.25
   orbits of 6 m): a reference leg, a victim leg SIGKILLed mid-flight and
   a leg resumed from its last checkpoint + archive pair, the C20 oracle
   along the way; at least two scrolls and a restore, and the resumed map
   bit-equal to the reference's;
14. (run after phase 10: it reads ``torch.profiler``, which on the card
   has traced nothing, three times in a row, now and then after phase
   12's in-process app runs) the multi-device engine on virtual meshes
   of the card (every shard on cuda:0; the halos, relays and gathers are
   copies on it): phase 2's ticks through ``sharded_fused_tick`` at 2
   and 8 shards (final state and every tick's stats bit-equal to phase
   2's, the sharded lazy ``derive_closest`` to phase 3's closest grid,
   each stream and closest kernel launched; ms a tick host-paced and
   busy, CUDA launches a tick, the copies' device time by kernel name);
   the two-level tick (phase 8's, bit-equal) and the demo window
   (bit-equal to the single-device windowed stream) at 8 shards, each
   run's launches read apart; ``sharded_esdf_update`` on phase 10's
   first insert tick (d2, closest and sweeps bit-equal to the
   single-device relax kernel's, one relax launch a sweep a shard, one
   host sync a sweep, timed); ``ShardedFiestaPipeline`` on phase 5's
   frames (bit-equal to the fused ticks on the same scan groups), the
   rollout-sharded planner at ``MPCConfig()`` (within PLAN_TOL of the
   single-device solve from the same generator), and
   ``ShardedScrollingFiestaPipeline`` at 2 shards on phase 11's frames,
   a tick a frame (states and tiles bit-equal to the single-device
   scrolling engine's); one tick through ``distributed_mesh`` on NCCL at
   world size 1 (bit-equal to phase 2's first tick, its collectives
   through ``torch.distributed``); the app with ``--devices 1`` (9
   frames, phase 12's other flags: stream kernels launched, the
   oracle's count_under 0); and each kernel at the 8-shard slab shapes
   against its plain version (the relax kernel with an x origin on a
   halo-extended slab, the box add with out-of-slab corners on a slab
   whose far face the boxes cross and on one whose low face they do),
   timed beside its flat-shape time;
15. (run after phase 8) the wide closest path: the cow config on a
   40 m floor (``WIDE_MAP_SIZE``: 800x800x80 voxels at t = 100, where the
   packed word needs 32 bits), phase 2's scans streamed into it, then
   ``derive_closest``, two eager ticks and ``get_closest_obstacle`` on
   2^19 positions, launch counts zeroed just before and read just after
   (the three wide kernels and the decode launched, no packed pass);
   then the same through the plain versions: every output bit-equal,
   the derived d2 equal to the tick's.  ``derive_closest`` timed and
   traced both ways, the path's peak memory both ways, and each wide
   kernel and the decode of its i64 words against its plain version at
   these shapes (bit-equal as 64-bit words), timed beside its bound.
   The wide split (on u32 tile words here) also on the card alone in
   turns with its u64 form (bit-equal to plain too), with its window
   offsets a side (mean, p99, most), its bytes and operations bounds and
   each launch's resident blocks and warps an SM, registers and spills;
   then its 64-bit leg: the map tiled 2x2 along x
   and y (1600x1600x80, s = 18, u64 tile words in chunks) through the
   wide binary and window kernels, and the split alone on it the same
   way, bit-equal to its plain version (timed once);
16. the benchmark twins (``bench*_torch.py``), each run whole at its
   full widths in a subprocess with a time limit (the accuracy and C++
   core twins on fewer frames, ``TWINS``): its last line must name
   this card and hold its contract (times above 0, the accuracy
   benchmark's four statements, the planner's same-schedule max |du|
   under 0.05, the scaling benchmark's pad-term states bit-equal and its
   counted collective bytes equal to the port's terms); each line is
   logged;
17. a JSON line of per-kernel numbers (with the launches, device times,
   carve steps and window offsets above, phases 8 to 15, and for each
   row its launches on the sharded path and its time at the slab
   shapes), the nvidia-smi line, and last ``{"ok": true, "device":
   {...}}``.

Bounds are ``esdfbench.roofline``'s peaks and rule (``bound_s``) applied
to each row's bytes and operations.  The script needs a CUDA card and the
rest of the repository; without either it exits non-zero and prints no
result.
"""

import collections
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from esdfbench.roofline import (ENVELOPE_OPS, F32_OPS_PER_S, HBM_BYTES_PER_S,
                                I32_OPS_PER_S, RELAX_OPS, bound_s,
                                carve_bound_s)
import fiesta_tpu_torch as ft
from fiesta_tpu_torch import checkpoint, kernels, pipeline
from fiesta_tpu_torch import run as fiesta_run
from fiesta_tpu_torch.io import replay, rosbag
from fiesta_tpu_torch.ops import edt, esdf, fusion, query, raycast, sort
from fiesta_tpu_torch.ops import depth as depth_ops
from fiesta_tpu_torch.parallel import sharding
from fiesta_tpu_torch.parallel.engine import (ShardedFiestaPipeline,
                                              ShardedScrollingFiestaPipeline)
from fiesta_tpu_torch.planning import mpc
from fiesta_tpu_torch.scrolling import ScrollingFiestaPipeline
from fiesta_tpu_torch.timing import Timing

H, W = 192, 256          # scan size of the cow_and_lady bench (bench.py)
TICKS = 5                # timed ticks of 3 scans each
EAGER_TICKS = 2          # ticks in eager closest mode on the final map
QUERIES = 2 ** 19        # ~ the MPC's 491 k lookups per solve (query.py)
STREAM_KERNELS = ("prep", "splat", "carve", "edt_binary", "edt_minplus",
                  "fuse", "boxadd")
CLOSEST_KERNELS = ("closest_binary", "closest_window", "closest_split",
                   "closest_decode")
MIN_OCCUPIED = 1000      # a representative scene (bench.py:184)
ENGINE_FRAMES = 9        # FiestaPipeline frames, update() every third
OTHER_FRAMES = 3         # frames each for the dda and projective engines
DH, DW = 120, 160        # depth size of the demo bench (bench_demo.py:39)
DEMO_TICKS = 5
DEMO_MIN_OCCUPIED = 80   # the first chip run mapped 88 (PERF.md)
HIER_FINE_DIST = 2.0     # the two-level tick's edt_fine_dist (m)
HIER_KERNELS = ("edt_binary", "edt_minplus") + CLOSEST_KERNELS
PLAN_SOLVES = 5          # timed plan_step solves, one sync each
FLY_STEPS = 10           # receding-horizon steps (run.py --fly)
PLAN_TOL = 1e-3          # card vs CPU solve: tests/test_torch_mpc.py's gate
GRAD_TOL = 1e-5          # card vs CPU cost gradient, relative L2: same gate
INCR_KERNELS = ("prep", "splat", "carve", "boxadd", "fuse", "changes",
                "relax")  # incremental
# int32 operations a voxel of the changes kernel: the insert test, the
# defined test, the occupancy index (two multiplies, two adds) and the
# selects of d2 and the three planes
CHANGES_OPS = 12
# phase 15: the demo preset's 40 m floor at cow_and_lady's 0.05 m, 800x800x80
# voxels at t = 100, where the packed closest word misses int32
WIDE_MAP_SIZE = (40.0, 40.0, 4.0)
WIDE_KERNELS = ("closest_binary_wide", "closest_window_wide",
                "closest_split_wide", "closest_decode")
# the JAX functions (XLA, no Pallas kernel) the wide kernels stand for
WIDE_REPLACES = {"closest_binary_wide": 966, "closest_window_wide": 994,
                 "closest_split_wide": 1020}
# int32 operations a voxel of the closest decode takes: the coordinates from
# the index (two multiply-highs and their products), the unpack, the
# defined test, da, db and their squares, dc2 and its clamp, c*, the axis
# selects and the packing
DECODE_OPS = 30
# phase 15's 64-bit leg: the wide map tiled 2x2 along x and y, 1600x1600x80
# (an 80 m floor at 0.05 m; s = 18)
WIDE_LONG_TILES = (2, 2, 1)
WORLD_FRAMES = 24        # phase 11: one orbit of WORLD_RADIUS in 0.8 s
WORLD_PERIOD = 0.8
WORLD_RADIUS = 8.0       # m: past the cow grid's central box (2.5 m)
WORLD_SIZE = 60.0        # m: the world the orbit's boxes fill (grid 20 m)
APP_FRAMES = 30          # phase 12: run.py's synthetic frames (>= 20 for its
                         # steady-state line), an update every third
SOAK_FRAMES = 150        # phase 13: 1.25 orbits of 6 m at cow scale
SOAK_CHECK_EVERY = 75    # C20 oracle interval (updates; one a frame)
SOAK_CK_EVERY = 25       # checkpoint + archive interval (updates)
SOAK_TIMEOUT_S = 480
SHARDS = (2, 8)          # phase 14: virtual meshes of the one card
# phase 16: the benchmark twins, each run whole as ``python3 <twin>
# <args>``; the two that feed the C++ core (5-17 s a batch on an H100
# machine's host CPU, PERF.md) on fewer frames than their defaults: 8
# (two ticks) of 26 and 15 (five, the fewest the port's tick there takes)
# of 49
TWINS = {"bench_torch.py": [], "bench_demo_torch.py": [],
         "bench_mpc_torch.py": [], "bench_e2e_torch.py": [],
         "bench_accuracy_torch.py": ["--frames", "8"],
         "bench_reference_cpu_torch.py": ["--frames", "15"],
         "bench_scaling_torch.py": []}
TWIN_TIMEOUT_S = 300
MPC_DU_TOL = 0.05        # bench_mpc.py's same-schedule tolerance
SHARD_APP_FRAMES = 9     # phase 14: run.py --devices 1
SLEEP_CYCLES = 40_000_000   # ~20 ms at the H100's 1.98 GHz boost clock
MARK_CYCLES = 5_000_000     # ~2.5 ms: each of the profiler's first kernels
MARKS = 8                   # sleeps that open a trace (the profiler drops
                            # its first kernel, on some cards two)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cow_config():
    cfg = dataclasses.replace(replay.scale_intrinsics(ft.COW_AND_LADY, H, W),
                              max_points_per_scan=H * W)
    return cfg.validate()


def demo_config():
    """``launch/demo.launch`` as ``bench_demo.py`` sizes it: depth images
    of 120x160, local-window updates."""
    cfg = dataclasses.replace(
        replay.scale_intrinsics(ft.DEMO_ONBOARD, DH, DW),
        max_points_per_scan=DH * DW)
    return cfg.validate()


#: (module, dispatch function, plain version) of every kernel wrapper
PLAIN = (
    (raycast, "_scanline_splat_prep", raycast._scanline_splat_prep_plain),
    (raycast, "splat_packed", raycast._splat_packed_plain),
    (raycast, "carve_free_mask_batch", raycast._carve_free_plain),
    (raycast, "apply_box_counts", raycast._apply_box_counts_plain),
    (fusion, "fuse_drain", fusion._fuse_drain_plain),
    (edt, "binary_pass", edt._binary_pass_plain),
    (edt, "minplus_pass", edt._minplus_pass_plain),
    (edt, "binary_packed", edt._binary_packed_plain),
    (edt, "window_packed", edt._window_packed_plain),
    (edt, "split_packed", edt._split_packed_plain),
    (edt, "decode_split", edt._decode_split_plain),
    (edt, "binary_wide", edt._binary_wide_plain),
    (edt, "window_wide", edt._window_wide_plain),
    (edt, "split_wide", edt._split_wide_plain),
    (sort, "sort_pairs", sort._sort_pairs_plain),
    (esdf, "relax_to_fixpoint", esdf._relax_to_fixpoint_plain),
    (esdf, "apply_occupancy_changes", esdf._apply_occupancy_changes_plain),
)


@contextlib.contextmanager
def plain_versions():
    """Route every kernel wrapper to its plain PyTorch version (for the
    reference runs on the card), restoring them afterwards."""
    saved = [getattr(mod, name) for mod, name, _ in PLAIN]
    for mod, name, plain in PLAIN:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(PLAIN, saved):
            setattr(mod, name, fn)


def run_stream(cfg, batches, dev, use_window=False):
    """fused_stream from an empty map; returns (state, stats, ms/tick)."""
    state = ft.make_state(cfg, dev)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, stats = ft.fused_stream(cfg, state, *batches,
                                   use_window=use_window)
    end.record()
    end.synchronize()
    return state, stats, start.elapsed_time(end) / batches[0].shape[0]


def time_ms(fn, calls=5, windows=5):
    """Median over ``windows`` of the mean time of ``calls`` back-to-back
    calls, from CUDA events, after one warm call."""
    fn()
    per_call = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / calls)
    return statistics.median(per_call)


def kernel_times(fn, calls=5, windows=5):
    """Times per call of ``fn``: ``ms`` host-paced (``time_ms``: the host
    enqueues while the card runs, so a call whose host cost exceeds its
    device time reads as its host time), ``device_ms``, the card's time
    alone: the median over windows that wait on the card behind a 20 ms
    device sleep, so that every call is enqueued before the first starts,
    and ``host_ms``, the host clock's median time to enqueue a call in
    those windows."""
    ms = time_ms(fn, calls, windows)
    device_ms, host_ms = queued_ms(fn, calls, windows)
    return dict(ms=ms, device_ms=device_ms, host_ms=host_ms)


def queued_ms(fn, calls=5, windows=5):
    """(the card's time alone a call, the host's time to enqueue one):
    medians over ``windows`` of ``calls`` calls queued behind a 20 ms
    device sleep."""
    device, host = [], []
    for _ in range(windows):
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / calls)
        b.record()
        b.synchronize()
        device.append(a.elapsed_time(b) / calls)
    return statistics.median(device), statistics.median(host)


def profiled(fn, calls, attempts=3):
    """Run ``fn`` ``calls`` times under ``torch.profiler``: returns (device
    ms per call by kernel name, launches per call by kernel name, names cut
    at their argument list, and wall ms per call).  The trace drops the
    first kernels launched in it, so ``MARKS`` device sleeps go first and
    are left out.  A trace in which no sleep is left, or no other kernel,
    may have dropped some of ``fn``'s: it is taken again, up to
    ``attempts`` times, and raises if none lists both."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(MARKS):
                torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name, count, marked = {}, {}, False
        for e in prof.key_averages():
            dt = getattr(e, "device_time_total", None)
            if dt is None:
                dt = getattr(e, "cuda_time_total", 0.0)
            if not dt or e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if "spin_kernel" in e.key:
                marked = True
                continue
            name = e.key.split("(")[0]
            by_name[name] = by_name.get(name, 0.0) + dt / 1e3 / calls
            count[name] = count.get(name, 0) + e.count / calls
        if by_name and marked:
            return by_name, count, wall_ms / calls
    raise RuntimeError(f"torch.profiler listed no kernel after its marks in "
                       f"{attempts} traces")


def max_abs_err(got, ref):
    """Largest |got - ref| over matching outputs; raises unless equal."""
    err = 0.0
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, (g.dtype, r.dtype)
        if g.dtype == torch.bool:
            g, r = g.to(torch.int32), r.to(torch.int32)
        err = max(err, float((g.double() - r.double()).abs().max()))
        assert torch.equal(g, r), f"kernel differs from plain: {err}"
    return err


def bit_equal(a, b, what):
    """Exact equality, f32 by bit pattern (NaN included)."""
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), f"{what} differs between kernels and plain"


def query_positions(cfg, dev):
    """QUERIES positions drawn from seed 0 over the map, the last few
    outside it (beyond each face, and a NaN)."""
    g = torch.Generator().manual_seed(0)
    lo = torch.tensor(cfg.origin, dtype=torch.float32)
    size = torch.tensor(cfg.map_size, dtype=torch.float32)
    pos = lo + torch.rand((QUERIES, 3), generator=g) * size
    pos[-7:] = torch.tensor([[-1.0, 0.5, 0.5], [2.0, 0.5, 0.5],
                             [0.5, -1.0, 0.5], [0.5, 2.0, 0.5],
                             [0.5, 0.5, -1.0], [0.5, 0.5, 2.0],
                             [float("nan")] * 3]) * size + lo
    return pos.to(dev)


def closest_path(cfg, state, eager, pos):
    """The closest/query path on ``state`` (left as it is): the lazy
    derivation, EAGER_TICKS eager ticks from the state and the lazy
    derivation on their occupancy, and the three queries."""
    d2, closest = pipeline.rebuild_esdf(
        cfg, ft.occupied_grid(cfg, state.logodds))
    lazy = pipeline.derive_closest(cfg, state.logodds)
    assert torch.equal(lazy, closest)
    cfg_e = dataclasses.replace(cfg, closest_mode="eager")
    e_state, _ = ft.fused_stream(cfg_e, ft.copy_state(state), *eager)
    dist = query.distance_grid(cfg, state.d2, state.seen)
    d, (dt, grad), (pts, cdist) = (
        query.get_distance(cfg, dist, pos),
        query.get_dist_grad_trilinear(cfg, dist, pos),
        query.get_closest_obstacle(cfg, closest, state.d2, state.seen, pos))
    return dict(d2=d2, closest=closest, eager_closest=e_state.closest,
                eager_d2=e_state.d2, eager_logodds=e_state.logodds,
                eager_lazy=pipeline.derive_closest(cfg, e_state.logodds),
                distance=d, trilinear=dt, gradient=grad, obstacle=pts,
                dist=cdist)


def closest_rows(cfg, occupied):
    """Rows of the three packed closest passes on the final occupancy."""
    t = edt.trunc_vox_for(cfg.resolution, cfg.trunc_dist)
    plan = edt.closest_plan(occupied.shape, t)
    a, b, c = plan["a"], plan["b"], plan["c"]
    cap, nvox = plan["cap"], occupied.numel()
    occ = occupied.view(torch.uint8)
    p1 = kernels.closest_binary(occ, plan, a)
    err = max(max_abs_err([p1], [edt._binary_packed_plain(occ, plan, a)]),
              max_abs_err([kernels.closest_binary(occ, plan, a, False)],
                          [edt._binary_packed_plain(occ, plan, a, False)]))
    by_name, counts, _ = profiled(
        lambda: kernels.closest_binary(occ, plan, a), 10)
    rows = [dict(
        name="closest_binary", source="fiesta_tpu_torch/kernels/closest.cu",
        replaces="fiesta_tpu/ops/pallas/edt.py:614", err=err,
        **kernel_times(lambda: kernels.closest_binary(occ, plan, a)),
        plain_ms=time_ms(lambda: edt._binary_packed_plain(occ, plan, a)),
        library_ms=None,
        bound=in_ms(bound_s(5 * nvox, 4 * nvox, I32_OPS_PER_S)),
        cuda_launches=sum(counts.values()), by_kernel=by_name,
        tiles=seed_tiles(occupied, plan, a))]
    p2 = kernels.closest_window(p1, plan, b)
    for name, line, kern, plain, x, axis, shift in (
            ("closest_window", 703, kernels.closest_window,
             edt._window_packed_plain, p1, b, plan["ba"]),
            ("closest_split", 773, kernels.closest_split,
             edt._split_packed_plain, p2, c, plan["s"])):
        # the cheapest exact pass is O(A) per column holding a value
        # below cap, as for the min-plus passes
        near_cols = int(((x >> shift) < cap).any(dim=axis).sum())
        # every value at cap: no sweep and no loop, the load and store
        # alone (the floor under the windows' work)
        far = torch.full_like(x, cap << shift)
        rows.append(dict(
            name=name, source="fiesta_tpu_torch/kernels/closest.cu",
            replaces=f"fiesta_tpu/ops/pallas/edt.py:{line}",
            err=max_abs_err([kern(x, plan, axis)], [plain(x, plan, axis)]),
            **kernel_times(lambda: kern(x, plan, axis)),
            plain_ms=time_ms(lambda: plain(x, plan, axis), calls=1,
                             windows=3),
            library_ms=None,
            far_device_ms=kernel_times(lambda: kern(far, plan, axis))[
                "device_ms"],
            bound=in_ms(bound_s(8 * nvox,
                                ENVELOPE_OPS * near_cols * x.shape[axis],
                                I32_OPS_PER_S))))
    for row, kern, x, axis, taps in (
            (rows[-2], kernels.closest_window, p1, b, window_taps),
            (rows[-1], kernels.closest_split, p2, c, split_taps)):
        by_name, counts, _ = profiled(lambda: kern(x, plan, axis), 10)
        row.update(cuda_launches=sum(counts.values()), by_kernel=by_name,
                   taps=taps(x, plan, axis))
    rows.append(decode_row(kernels.closest_split(p2, plan, c), plan,
                           ft.grid.closest_packed_state(cfg)))
    return rows


def decode_row(vps, plan, packed_out):
    """The closest decode of the split pass's words ``vps`` (i32 or i64)
    against its plain version, as ``derive_closest`` calls it: times,
    CUDA launches and the bytes bound (the word in, d2 and the packed grid
    or three i16 planes out)."""
    nvox = vps.numel()
    kern = lambda: kernels.closest_decode(vps, plan, packed_out)  # noqa
    plain = lambda: edt._decode_split_plain(vps, plan, packed_out)  # noqa
    by_name, counts, _ = profiled(kern, 10)
    nbytes = (vps.element_size() + 4 + (4 if packed_out else 6)) * nvox
    return dict(
        name="closest_decode", source="fiesta_tpu_torch/kernels/closest.cu",
        replaces="fiesta_tpu/ops/pallas/edt.py:871 (_reconstruct_closest, "
                 "with unpack_split :861; port-only: XLA in fiesta_tpu)",
        err=max_abs_err(list(kern()), list(plain())), **kernel_times(kern),
        plain_ms=time_ms(plain), library_ms=None,
        bound=in_ms(bound_s(nbytes, DECODE_OPS * nvox, I32_OPS_PER_S)),
        cuda_launches=sum(counts.values()), by_kernel=by_name)


def wide_closest_path(wcfg, state, eager, pos):
    """The closest path on a map whose closest transform takes the wide
    plan (``state`` left as it is): the rebuild and the lazy derivation,
    EAGER_TICKS eager ticks from the state and the lazy derivation on
    their occupancy, and ``get_closest_obstacle`` at ``pos``."""
    d2, closest = pipeline.rebuild_esdf(
        wcfg, ft.occupied_grid(wcfg, state.logodds))
    lazy = pipeline.derive_closest(wcfg, state.logodds)
    cfg_e = dataclasses.replace(wcfg, closest_mode="eager")
    e_state, _ = ft.fused_stream(cfg_e, ft.copy_state(state), *eager)
    pts, dist = query.get_closest_obstacle(wcfg, lazy, state.d2, state.seen,
                                           pos)
    return dict(d2=d2, closest=closest, lazy=lazy,
                eager_closest=e_state.closest, eager_d2=e_state.d2,
                eager_lazy=pipeline.derive_closest(cfg_e, e_state.logodds),
                obstacle=pts, dist=dist)


def peak_above(fn):
    """(fn(), the peak device memory in MiB that the call allocated above
    what was allocated before it)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - held) / 2**20


def wide_rows(occupied, plan):
    """The three wide passes and the decode of their i64 words on the
    wide map's final occupancy, each against its plain version (the pair
    passes packed into 64-bit words), with their bounds; the split with
    ``split_wide_detail``.  Returns the wide passes' rows and the decode's
    at these shapes."""
    a, b, c = plan["a"], plan["b"], plan["c"]
    cap, nvox = plan["cap"], occupied.numel()
    occ = occupied.view(torch.uint8)
    rows, x = [], occ
    for name, axis, kern, plain in (
            ("closest_binary_wide", a, kernels.closest_binary_wide,
             edt._binary_wide_plain),
            ("closest_window_wide", b, kernels.closest_window_wide,
             edt._window_wide_plain),
            ("closest_split_wide", c, kernels.closest_split_wide,
             edt._split_wide_plain)):
        extra = {}
        if name == "closest_binary_wide":
            # u8 in, i64 out; a few operations a voxel (the binary pass's)
            nbytes, ops = 9 * nvox, 4 * nvox
        else:
            # i64 in and out against the cheapest exact O(A) pass over the
            # columns holding a value below cap
            shift = plan["ba"] if name == "closest_window_wide" else plan["s"]
            near_cols = int(((x >> shift) < cap).any(dim=axis).sum())
            nbytes, ops = 16 * nvox, ENVELOPE_OPS * near_cols * x.shape[axis]
            if name == "closest_split_wide":
                extra = split_wide_detail(x, plan, axis,
                                          plain(x, plan, axis))
        by_name, counts, _ = profiled(lambda: kern(x, plan, axis), 10)
        rows.append(dict(
            name=name, source="fiesta_tpu_torch/kernels/closest.cu",
            replaces=f"fiesta_tpu/ops/pallas/edt.py:{WIDE_REPLACES[name]} "
                     f"(port-only: XLA in fiesta_tpu)",
            err=max_abs_err([kern(x, plan, axis)], [plain(x, plan, axis)]),
            **kernel_times(lambda: kern(x, plan, axis)),
            plain_ms=time_ms(lambda: plain(x, plan, axis), calls=1,
                             windows=3),
            library_ms=None, bound=in_ms(bound_s(nbytes, ops, I32_OPS_PER_S)),
            cuda_launches=sum(counts.values()), by_kernel=by_name,
            **({"split": extra} if extra else {})))
        x = kern(x, plan, axis)
    return rows, decode_row(x, plan, True)


def split_wide_detail(x, plan, axis, ref):
    """The wide split on its input ``x`` along ``axis`` (``ref``: the
    plain pass's words): its bytes bound and its operations bound (the
    cheapest exact pass, ENVELOPE_OPS a row of each column holding a value
    below cap), its window offsets a side (mean, p99 and most, beside the
    brute-force window's), the card's time alone in turns with its u64
    form where it takes u32, and each launch's residency.  The u64 form
    must equal ``ref``."""
    nvox = x.numel()
    bits = kernels.split_wide_word_bits(plan, x.shape[axis])
    near_cols = int(((x >> plan["s"]) < plan["cap"]).any(dim=axis).sum())
    ops = ENVELOPE_OPS * near_cols * x.shape[axis]

    def split(**kw):
        return lambda: kernels._closest_split_wide(x, plan, axis, **kw)

    fns = {"package": split()}
    residency = {
        "package": kernels.closest_split_wide_residency(x.shape, plan, axis)}
    if bits == 32:
        fns["package_u64"] = split(bits=64)
        residency["package_u64"] = kernels.closest_split_wide_residency(
            x.shape, plan, axis, bits=64)
    err = max(max_abs_err([fn()], [ref]) for fn in fns.values())
    turns = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            turns[k].append(queued_ms(fns[k], calls=5, windows=3)[0])
    return dict(word_bits=bits, ops=ops, taps=split_taps(x, plan, axis),
                ops_bound_ms=ops / I32_OPS_PER_S * 1e3,
                bytes_bound_ms=16 * nvox / HBM_BYTES_PER_S * 1e3, err=err,
                device_ms=turns, residency=residency)


def wide_long_split(occupied, t):
    """Phase 15's 64-bit leg: the wide map's occupancy tiled
    WIDE_LONG_TILES (1600x1600x80 at t = 100: s = 18, u64 tile words)
    through the wide binary and window kernels, then the wide split on its
    own: bit-equal to the plain pass (timed once), timed beside its bounds
    and CUDA launches, and ``split_wide_detail``."""
    occ = occupied.repeat(*WIDE_LONG_TILES).view(torch.uint8)
    shape = tuple(occ.shape)
    plan = edt.closest_plan_wide(shape, t)
    assert edt.closest_plan(shape, t) is None and plan is not None, shape
    a, b, c = plan["a"], plan["b"], plan["c"]
    assert kernels.split_wide_word_bits(plan, shape[c]) == 64, plan
    x = kernels.closest_window_wide(
        kernels.closest_binary_wide(occ, plan, a), plan, b)
    del occ
    split = lambda: kernels.closest_split_wide(x, plan, c)  # noqa: E731
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = edt._split_wide_plain(x, plan, c)
    end.record()
    end.synchronize()
    err = max_abs_err([split()], [ref])
    detail = split_wide_detail(x, plan, c, ref)
    del ref
    by_name, counts, _ = profiled(split, 3)
    out = dict(grid=list(shape), plan=plan, err=err,
               plain_ms=start.elapsed_time(end),
               **kernel_times(split, calls=3, windows=3),
               bound=in_ms(bound_s(16 * x.numel(), detail["ops"],
                                   I32_OPS_PER_S)),
               cuda_launches=sum(counts.values()), by_kernel=by_name,
               split=detail)
    del x
    torch.cuda.empty_cache()
    return out


def split_line(what, r, card):
    """The log line of a wide split row: times in turns, both bounds,
    taps and residency."""
    d = r["split"]
    return (
        f"closest_split_wide at {what} ({d['word_bits']}-bit tile words): "
        f"on the card alone in turns (forward, then backward) "
        f"{ {k: [round(x, 4) for x in v] for k, v in d['device_ms'].items()} }"
        f"; bounds: bytes {d['bytes_bound_ms']:.4f} ms, operations "
        f"{d['ops_bound_ms']:.4f} ({ENVELOPE_OPS} int32 a row of each "
        f"column with a value below cap); window offsets a voxel: side n "
        f"mean {d['taps']['n']['mean_taps']:.3f} p99 "
        f"{d['taps']['n']['p99_taps']} max {d['taps']['n']['max_taps']}, "
        f"side p mean {d['taps']['p']['mean_taps']:.3f} p99 "
        f"{d['taps']['p']['p99_taps']} max {d['taps']['p']['max_taps']}, "
        f"brute-force {d['taps']['brute_mean_taps']:.2f} a side; residency "
        f"{d['residency']}; {', '.join(d['device_ms'])} bit-equal to plain; "
        f"on {card}")


def wide_path(cfg, batches, eager, dev, card, rows, launches):
    """Phase 15: the closest path where the packed word misses int32 (the
    cow config on a 40 m floor, ``WIDE_MAP_SIZE``): phase 2's scans
    streamed into it, then ``derive_closest``, EAGER_TICKS eager ticks
    and ``get_closest_obstacle`` on QUERIES positions, launch counts
    zeroed just before and read just after (each wide kernel and the
    decode must have launched, no packed pass); then the same through
    the plain versions: every output bit-equal, the derived d2 equal to
    the tick's ``rebuild_d2``.  ``derive_closest`` timed and traced both
    ways, peak memory both ways, and each wide kernel against its plain
    version at these shapes (appended to ``rows``), then the split's
    64-bit leg (``wide_long_split``).  Returns a summary."""
    wcfg = dataclasses.replace(cfg, map_size=WIDE_MAP_SIZE).validate()
    shape = wcfg.grid_shape
    t = edt.trunc_vox_for(wcfg.resolution, wcfg.trunc_dist)
    plan = edt.closest_plan_wide(shape, t)
    assert edt.closest_plan(shape, t) is None and plan is not None, shape
    log(f"wide closest path: grid {shape} at t = {t}: "
        f"{edt.closest_capability(shape, t)['detail']}; plan {plan}")
    run_stream(wcfg, tuple(b[:1] for b in batches), dev)      # warm-up
    w_state, _, w_ms = run_stream(wcfg, batches, dev)
    pos = query_positions(wcfg, dev)
    kernels.reset_launch_counts()
    k_out, k_peak = peak_above(
        lambda: wide_closest_path(wcfg, w_state, eager, pos))
    got = read_launches(WIDE_KERNELS + CLOSEST_KERNELS)
    log(f"wide closest path (kernels): launches {got}")
    check_launched({k: got[k] for k in WIDE_KERNELS}, "the wide closest path")
    assert all(got[k] == 0 for k in CLOSEST_KERNELS[:3]), got
    launches.update({k: got[k] for k in WIDE_KERNELS})
    with plain_versions():
        p_out, p_peak = peak_above(
            lambda: wide_closest_path(wcfg, w_state, eager, pos))
    for name in k_out:
        bit_equal(k_out[name], p_out[name], f"wide {name}")
    assert torch.equal(k_out["d2"], w_state.d2), "wide derive d2 != tick d2"
    assert torch.equal(k_out["lazy"], k_out["closest"])
    assert torch.equal(k_out["eager_closest"], k_out["eager_lazy"]), \
        "wide eager closest differs from the lazy derivation"
    n_def = int((k_out["closest"] >= 0).sum())
    n_near = int((k_out["dist"] < wcfg.infinity_distance).sum())
    assert n_def > MIN_OCCUPIED and n_near > 0, (n_def, n_near)
    derive = lambda: pipeline.derive_closest(wcfg, w_state.logodds)  # noqa
    derive_ms = time_ms(derive)
    by_name, counts, _ = profiled(derive, 3)
    derive_peak = peak_above(derive)[1]
    with plain_versions():
        derive_plain_ms = time_ms(derive, calls=1, windows=3)
        p_by_name, p_counts, _ = profiled(derive, 1)
        derive_plain_peak = peak_above(derive)[1]
    occupied = ft.occupied_grid(wcfg, w_state.logodds)
    k_rows, decode = wide_rows(occupied, plan)
    rows.extend(k_rows)
    long_split = wide_long_split(occupied, t)
    out = dict(grid=list(shape), t=t, plan=plan, ms_per_tick=w_ms,
               launches=got, defined=n_def, queries_near=n_near,
               derive_closest_ms=derive_ms,
               derive_closest_busy_ms=sum(by_name.values()),
               derive_closest_cuda_launches=sum(counts.values()),
               derive_closest_by_kernel=by_name,
               derive_closest_plain_ms=derive_plain_ms,
               derive_closest_plain_busy_ms=sum(p_by_name.values()),
               derive_closest_plain_cuda_launches=sum(p_counts.values()),
               peak_mib=k_peak, plain_peak_mib=p_peak,
               derive_peak_mib=derive_peak,
               derive_plain_peak_mib=derive_plain_peak,
               decode=decode, long_split=long_split,
               kernels={r["name"]: {k: r[k] for k in (
                   "ms", "device_ms", "host_ms", "plain_ms", "bound",
                   "cuda_launches", "by_kernel", "split") if k in r}
                   for r in k_rows})
    log(f"wide closest path bit-equal to plain: {n_def} voxels with a "
        f"closest obstacle, {n_near} of {QUERIES} queries with one; "
        f"{w_ms:.3f} ms/tick; derive_closest {derive_ms:.3f} ms host-paced,"
        f" busy {out['derive_closest_busy_ms']:.3f} in "
        f"{out['derive_closest_cuda_launches']:g} CUDA launches (plain "
        f"{derive_plain_ms:.3f} ms, busy "
        f"{out['derive_closest_plain_busy_ms']:.3f} in "
        f"{out['derive_closest_plain_cuda_launches']:g} launches); peak "
        f"memory above what was held before, of the path "
        f"{k_peak:.0f} MiB on kernels, {p_peak:.0f} MiB plain, of a "
        f"derive_closest {derive_peak:.0f} / {derive_plain_peak:.0f} MiB; "
        f"on {card}")
    for r in k_rows + [decode]:
        log(f"{r['name']} at {tuple(shape)}: {r['ms']:.4f} ms host-paced, "
            f"{r['device_ms']:.4f} on the card alone, {r['host_ms']:.4f} to "
            f"enqueue (plain {r['plain_ms']:.4f}, bound {r['bound'][0]:.4f} "
            f"ms by {r['bound'][1]}), {r['cuda_launches']:g} CUDA launches a "
            f"call, device ms by kernel "
            f"{ {k: round(v, 4) for k, v in r['by_kernel'].items()} }, "
            f"bit-equal{' as 64-bit words' if r is not decode else ''}; "
            f"on {card}")
    log(split_line(tuple(shape), k_rows[-1], card))
    r = long_split
    log(f"closest_split_wide at {tuple(r['grid'])} (plan {r['plan']}): "
        f"{r['ms']:.4f} ms host-paced, {r['device_ms']:.4f} on the card "
        f"alone (plain {r['plain_ms']:.1f}, timed once; bound "
        f"{r['bound'][0]:.4f} ms by {r['bound'][1]}), "
        f"{r['cuda_launches']:g} CUDA launches a call, device ms by kernel "
        f"{ {k: round(v, 4) for k, v in r['by_kernel'].items()} }, "
        f"bit-equal as 64-bit words; on {card}")
    log(split_line(tuple(r["grid"]), r, card))
    return out


def seed_tiles(occupied, plan, axis):
    """The closest binary kernel's column tiles along ``axis`` (runs of
    ``kernels.closest_binary_tile_cols`` consecutive columns) and how many
    hold a seed: the others load and write only."""
    tc = kernels.closest_binary_tile_cols(occupied.shape, plan, axis)
    outer, a, inner = kernels._columns(occupied.shape, axis)
    cols = occupied.reshape(outer, a, inner).any(dim=1).reshape(-1)
    cols = torch.cat([cols, cols.new_zeros(-cols.numel() % tc)])
    tiles = cols.view(-1, tc).any(dim=1)
    return dict(tile_cols=tc, tiles=tiles.numel(),
                with_seed=int(tiles.sum()))


def box_union(starts, box, grid):
    """Grid voxels covered by at least one of the boxes at ``starts``
    [K,3] (the tick's boxes lie inside the grid), counted on the card."""
    cover = torch.zeros(grid, dtype=torch.bool, device=starts.device)
    for x, y, z in starts.tolist():
        cover[x:x + box[0], y:y + box[1], z:z + box[2]] = True
    return int(cover.sum())


def carve_steps(po, box):
    """Steps of each carve wavefront (the kernel's half-space walks: the
    forward one while f32(idx) - po <= 0, the reverse one while > 0) for
    sensors ``po`` [K,3] in a box: the most, the mean, and the cell visits
    per call (C2 * C3 cells a step)."""
    lengths, visits = [], 0
    for o in range(3):
        a = box[o]
        cells = box[0] * box[1] * box[2] // a
        d = torch.arange(a, dtype=torch.float32, device=po.device)[None] - \
            po[:, o, None]
        fwd = (d <= 0).sum(1).tolist()
        for n in fwd:
            lengths += [n, a - n]
        visits += a * cells * po.shape[0]
    return dict(max=max(lengths), mean=statistics.mean(lengths),
                visits=visits)


def taps_summary(taps):
    """Mean, most and a histogram of window offsets per voxel."""
    edges = [0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 1 << 30]
    tf = taps.reshape(-1)
    hist = {f"{lo}-{hi - 1}": int(((tf >= lo) & (tf < hi)).sum())
            for lo, hi in zip(edges[:-1], edges[1:])}
    cum = torch.bincount(tf.long()).cumsum(0)
    p99 = int((cum < 0.99 * tf.numel()).sum())
    return dict(mean_taps=float(tf.double().mean()), p99_taps=p99,
                max_taps=int(tf.max()), hist=hist)


def brute_mean_taps(near, axis, tl):
    """Offsets per voxel of the brute-force window (t_local for every
    voxel of a 32-column tile holding a value below far, ``near``)."""
    cols = near.any(dim=axis).reshape(-1)
    pad = -cols.numel() % 32
    tiles = torch.cat([cols, cols.new_zeros(pad)]).view(-1, 32).any(1)
    return min(int(tiles.sum()) * 32, cols.numel()) * near.shape[axis] * tl \
        / near.numel()


def minplus_taps(x, t, axis):
    """The min-plus kernel's work on input ``x`` along ``axis``: window
    offsets per voxel of the bounded loop (``edt.minplus_window_taps``),
    beside the brute-force window's."""
    _, taps = edt.minplus_window_taps(x, t, axis)
    tl = min(t, x.shape[axis] - 1)
    return dict(**taps_summary(taps), brute_mean_taps=brute_mean_taps(
        x < edt._INF_EDT, axis, tl))


def split_taps(x, plan, axis):
    """The closest split kernel's work on input ``x`` along ``axis``:
    window offsets per voxel of each side's bounded loop
    (``edt.split_window_taps``), beside the brute-force window's, a
    side."""
    _, taps_n, taps_p = edt.split_window_taps(x, plan, axis)
    tl = min(plan["t"], x.shape[axis] - 1)
    return dict(n=taps_summary(taps_n), p=taps_summary(taps_p),
                brute_mean_taps=brute_mean_taps(
                    (x >> plan["s"]) < plan["cap"], axis, tl))


def window_taps(x, plan, axis):
    """The closest window kernel's work on input ``x`` along ``axis``:
    window offsets per voxel of its two bounded loops together
    (``edt.closest_window_taps``; one load each), beside the brute-force
    window's (a pair of loads each)."""
    _, taps = edt.closest_window_taps(x, plan, axis)
    tl = min(plan["t"], x.shape[axis] - 1)
    return dict(**taps_summary(taps), brute_mean_taps=brute_mean_taps(
        (x >> plan["ba"]) < plan["cap"], axis, tl))


def demo_seeds(dcfg, dbatches):
    """The demo's first tick of three depth frames through the depth
    conversion and the splat: (seeds [3,BX,BY,BZ], po [3,3])."""
    depths, tfs = dbatches[0][0], dbatches[1][0]
    *xyz, vals = pipeline.depth_tick_components(
        dcfg, depths, tfs, depths[0], tfs[0], use_filter=False)
    _, po, seeds, _, _, _ = raycast._scanline_seeds_batch(
        dcfg, tuple(xyz), vals, transforms=tfs)
    return seeds, po


def depth_row(dev, card):
    """The depth kernel on the demo cell's tick, 3 frames of 480x640
    filtered against their predecessors: bit-equal to the plain version,
    then its times (``kernel_times``) beside the plain version's and its
    bytes bound (a depth read, a previous depth gathered, x, y and valid
    written: 17 bytes a pixel)."""
    cfg = dataclasses.replace(ft.DEMO_ONBOARD, max_points_per_scan=480 * 640)
    _, frames = replay.make_sequence(cfg, n_frames=4, n_boxes=20, seed=0,
                                     kind="depth", height=480, width=640,
                                     period=12.0, orbit_radius=5.0)
    depths = torch.from_numpy(np.stack([f[2] for f in frames])).to(dev)
    tfs = torch.from_numpy(np.stack(
        [replay.pose_to_matrix(*f[1]) for f in frames]).astype(np.float32)
    ).to(dev)
    args = (cfg, depths[1:], tfs[1:], depths[0], tfs[0], True)
    got = depth_ops.depth_tick_components(*args)
    for a, b, what in zip(got, depth_ops._depth_tick_plain(*args),
                          ("px", "py", "pz", "valid")):
        bit_equal(a, b, f"depth {what}")
    row = dict(frames=list(depths[1:].shape), valid=int(got[3].sum()),
               **kernel_times(lambda: depth_ops.depth_tick_components(*args)),
               plain_ms=time_ms(lambda: depth_ops._depth_tick_plain(*args)),
               bound_ms=17 * depths[1:].numel() / HBM_BYTES_PER_S * 1e3)
    log(f"depth {row['frames']}: {row['ms']:.4f} ms host-paced, "
        f"{row['device_ms']:.4f} on the card alone (bound "
        f"{row['bound_ms']:.4f} ms, bytes), plain {row['plain_ms']:.4f}; "
        f"bit-equal, {row['valid']} valid; on {card}")
    return row


def prep_row(dev, card):
    """The splat prep's kernel on the cow tick (3 clouds of 480x640
    sensor-frame points with transforms) and the demo tick (the depth
    kernel's components of 3 filtered 480x640 frames): bit-equal to the
    plain prep (val where a ray passes the gates), its CUDA launches a
    call, then its times (``kernel_times``) beside the plain version's and
    its bytes bound (3 f32 and a valid byte read, lin, val and rvalid
    written: 22 bytes a ray)."""
    h, w = 480, 640
    rows = {}
    for name, base in (("cow", ft.COW_AND_LADY), ("demo", ft.DEMO_ONBOARD)):
        cfg = dataclasses.replace(replay.scale_intrinsics(base, h, w),
                                  max_points_per_scan=h * w)
        kind = "cloud" if name == "cow" else "depth"
        _, frames = replay.make_sequence(cfg, n_frames=4, n_boxes=20, seed=0,
                                         kind=kind, height=h, width=w,
                                         period=12.0, orbit_radius=5.0)
        if kind == "cloud":
            pts, vals, tfs = (b[0] for b in replay.stage_update_batches(
                cfg, frames[1:], device=dev)[:3])
        else:
            depths = torch.from_numpy(
                np.stack([f[2] for f in frames])).to(dev)
            tfs = torch.from_numpy(np.stack(
                [replay.pose_to_matrix(*f[1]) for f in frames]).astype(
                    np.float32)).to(dev)
            *xyz, vals = depth_ops.depth_tick_components(
                cfg, depths[1:], tfs[1:], depths[0], tfs[0], True)
            pts, tfs = tuple(xyz), tfs[1:]
        args = (cfg, pts, vals)
        got = raycast._scanline_splat_prep(*args, transforms=tfs)
        ref = raycast._scanline_splat_prep_plain(*args, transforms=tfs)
        rv = ref[4].reshape(-1)
        for a, b, what in zip(got, ref, ("starts", "po_box", "lin", "val",
                                         "rvalid")):
            if what == "val":
                a, b = a[rv], b[rv]
            bit_equal(a, b, f"prep {name} {what}")
        by_kernel, launches, _ = profiled(
            lambda: raycast._scanline_splat_prep(*args, transforms=tfs), 10)
        rays = vals.numel()
        row = dict(rays=rays, valid=int(rv.sum()), by_kernel=by_kernel,
                   cuda_launches=launches,
                   **kernel_times(lambda: raycast._scanline_splat_prep(
                       *args, transforms=tfs)),
                   plain_ms=time_ms(lambda: raycast._scanline_splat_prep_plain(
                       *args, transforms=tfs)),
                   bound_ms=22 * rays / HBM_BYTES_PER_S * 1e3)
        log(f"prep ({name} tick, {rays} rays): {row['ms']:.4f} ms "
            f"host-paced, {row['device_ms']:.4f} on the card alone, host "
            f"{row['host_ms']:.4f} (bound {row['bound_ms']:.4f} ms, bytes), "
            f"plain {row['plain_ms']:.4f}; CUDA launches a call {launches}; "
            f"bit-equal, {row['valid']} valid; on {card}")
        rows[name] = row
    return rows


def in_ms(bound):
    """A ``roofline`` bound, (seconds, by), as (ms, by)."""
    return bound[0] * 1e3, bound[1]


def read_launches(names):
    """The launch counts of ``names`` since the last reset."""
    return {k: kernels.LAUNCHES[k] for k in names}


def check_launched(counts, what):
    for name, n in counts.items():
        assert n > 0, f"kernel {name} did not launch on {what}"


@contextlib.contextmanager
def sorted_splat():
    """The sorted splat with the bitonic sort (``FIESTA_SPLAT=sorted``,
    ``FIESTA_SPLAT_SORT_IMPL=pallas``), restored afterwards."""
    saved = raycast._SPLAT_ORDER, raycast._SPLAT_SORT_IMPL
    raycast._SPLAT_ORDER, raycast._SPLAT_SORT_IMPL = "sorted", "pallas"
    try:
        yield
    finally:
        raycast._SPLAT_ORDER, raycast._SPLAT_SORT_IMPL = saved


def run_engine(cfg, frames, method, dev, pos=None, no_sync=False):
    """``FiestaPipeline`` fed ``frames`` as ``run.py`` feeds it, with
    ``update()`` every third frame and once after a final pose releases the
    last frame.  Each ``process()`` and ``update()`` is timed to the
    device's end (host clock, synchronised).  ``no_sync``: they run under
    PyTorch's sync debug mode "error", so one that waits for the device
    raises.  Returns (pipe, outputs, ms per integrated frame, ms per
    update)."""
    pipe = ft.FiestaPipeline(cfg, method=method, device=dev)
    frame_ms, update_ms = [], []

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if no_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def update():
        stats, ms = timed(pipe.update)
        if stats is not None:
            update_ms.append(ms)

    for i, (t, (p, q), scan) in enumerate(frames):
        pipe.observe_pose(t, p, q)
        pipe.observe_cloud(t, scan)
        n, ms = timed(pipe.process)
        if n:
            frame_ms.append(ms / n)
        if i % 3 == 2:
            update()
    pipe.observe_pose(frames[-1][0] + 1.0, *frames[-1][1])
    n, ms = timed(pipe.process)
    frame_ms.append(ms / max(n, 1))
    update()
    out = {f: getattr(pipe.state, f) for f in ft.grid.FIELDS}
    if pos is not None:
        out["closest_grid"] = pipe.closest_grid()
        out["distance"] = pipe.query_distance(pos)
        out["trilinear"], out["gradient"] = pipe.query_dist_grad(pos)
        out["obstacle"], out["obstacle_dist"] = \
            pipe.query_closest_obstacle(pos)
    torch.cuda.synchronize()
    return pipe, out, statistics.median(frame_ms), statistics.median(
        update_ms)


def demo_batches(cfg, h, w, ticks, dev):
    """Depth ticks staged as ``bench_demo.py:47-59`` stages them: depths
    [N,3,H,W], transforms [N,3,4,4], positions [N,3] on ``dev``."""
    _, frames = replay.make_sequence(
        cfg, n_frames=3 * ticks, n_boxes=20, seed=0, kind="depth",
        height=h, width=w, period=12.0, orbit_radius=5.0)
    depths = np.stack([f[2] for f in frames]).reshape(ticks, 3, h, w)
    tfs = np.stack([replay.pose_to_matrix(*f[1]) for f in frames]
                   ).reshape(ticks, 3, 4, 4)
    poss = np.stack([frames[i * 3 + 2][1][0] for i in range(ticks)])
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                 for a in (depths, tfs, poss))


def run_demo(cfg, batches, dev):
    """``fused_depth_stream`` with the local window from an empty map;
    returns (state, stats, ms/tick)."""
    state = ft.make_state(cfg, dev)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, stats = ft.fused_depth_stream(
        cfg, state, *batches, use_window=not cfg.global_update)
    end.record()
    end.synchronize()
    return state, stats, start.elapsed_time(end) / batches[0].shape[0]


@contextlib.contextmanager
def launches_by_level(grid_shape):
    """Count the two-level EDT's kernel calls by level while inside: each
    of its five wrappers is wrapped to add one to ``"name:fine"`` for an
    input of the grid's shape, else to ``"name:coarse"`` (the main path's
    counts, ``kernels.LAUNCHES``, are the wrappers' own)."""
    counts = collections.Counter()
    saved = {name: getattr(kernels, name) for name in HIER_KERNELS}

    def counted(name, fn):
        def call(x, *args, **kw):
            fine = tuple(x.shape) == tuple(grid_shape)
            counts[f"{name}:{'fine' if fine else 'coarse'}"] += 1
            return fn(x, *args, **kw)
        return call

    for name, fn in saved.items():
        setattr(kernels, name, counted(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def hier_path(hcfg, batches, eager, dev):
    """The two-level tick: the stream with lazy closest from an empty map,
    ``derive_closest`` on its map, then EAGER_TICKS eager ticks from it and
    the lazy derivation on theirs.  Returns (outputs, stats, ms/tick)."""
    state, stats, ms = run_stream(hcfg, batches, dev)
    cfg_e = dataclasses.replace(hcfg, closest_mode="eager")
    e_state, e_stats = ft.fused_stream(cfg_e, ft.copy_state(state), *eager)
    out = {f: getattr(state, f) for f in ft.grid.FIELDS}
    out.update(closest_lazy=pipeline.derive_closest(hcfg, state.logodds),
               eager_d2=e_state.d2, eager_closest=e_state.closest,
               eager_lazy=pipeline.derive_closest(cfg_e, e_state.logodds))
    return out, tuple(stats) + tuple(e_stats), ms


def pass_row(kern, plain, nbytes, ops):
    """A pass at one level's shapes: equal to its plain version, its times
    (host-paced and on the card alone) beside the plain version's and the
    card's bound."""
    times = kernel_times(kern)
    b = in_ms(bound_s(nbytes, ops, I32_OPS_PER_S))
    return dict(err=max_abs_err([kern()], [plain()]), ms=times["ms"],
                device_ms=times["device_ms"],
                plain_ms=time_ms(plain, calls=1, windows=3), bound_ms=b[0],
                bound_by=b[1])


def level_rows(occ, t):
    """The five kernels of the two-level EDT on the occupancy ``occ`` of
    one level at truncation ``t``, each against its plain version, with
    bounds worked out as phase 7 works them out at the fine shapes."""
    nvox = occ.numel()
    f = torch.full(occ.shape, edt._INF_EDT, dtype=torch.int32,
                   device=occ.device).masked_fill_(occ, 0)
    rows = {"edt_binary": pass_row(
        lambda: kernels.edt_binary(f, t),
        lambda: edt._binary_pass_plain(f, t), 8 * nvox, 4 * nvox)}
    x = kernels.edt_binary(f, t)
    for axis in (1, 2):
        # as phase 7's row: columns near an obstacle only
        near_cols = int((x < edt._INF_EDT).any(dim=axis).sum())
        rows[f"edt_minplus_axis{axis}"] = pass_row(
            lambda x=x, axis=axis: kernels.edt_minplus(x, t, axis),
            lambda x=x, axis=axis: edt._minplus_pass_plain(x, t, axis),
            8 * nvox, ENVELOPE_OPS * near_cols * x.shape[axis])
        x = kernels.edt_minplus(x, t, axis)
    plan = edt.closest_plan(occ.shape, t)
    a, b, c, cap = plan["a"], plan["b"], plan["c"], plan["cap"]
    o8 = occ.view(torch.uint8)
    rows["closest_binary"] = pass_row(
        lambda: kernels.closest_binary(o8, plan, a),
        lambda: edt._binary_packed_plain(o8, plan, a), 5 * nvox, 4 * nvox)
    x = kernels.closest_binary(o8, plan, a)
    for name, kern, plain, axis, shift in (
            ("closest_window", kernels.closest_window,
             edt._window_packed_plain, b, plan["ba"]),
            ("closest_split", kernels.closest_split, edt._split_packed_plain,
             c, plan["s"])):
        near_cols = int(((x >> shift) < cap).any(dim=axis).sum())
        rows[name] = pass_row(
            lambda x=x, kern=kern, axis=axis: kern(x, plan, axis),
            lambda x=x, plain=plain, axis=axis: plain(x, plan, axis),
            8 * nvox, ENVELOPE_OPS * near_cols * x.shape[axis])
        x = kern(x, plan, axis)
    return rows


def busy_ms_per_tick(cfg, batches, dev):
    """Device busy of a tick (``torch.profiler``: device time summed over
    kernels, the stream from an empty map, per tick)."""
    by_name, _, _ = profiled(
        lambda: ft.fused_stream(cfg, ft.make_state(cfg, dev), *batches), 1)
    return sum(by_name.values()) / batches[0].shape[0]


def fly_start(cfg, dev):
    """p0 and goal as ``run.py --mpc/--fly`` sets them (``run.py:633-637``):
    1 m either side of the map's centre along y."""
    center = np.asarray(cfg.origin) + np.asarray(cfg.map_size) / 2
    return tuple(torch.tensor(center + [0.0, dy, 0.0], dtype=torch.float32,
                              device=dev) for dy in (-1.0, 1.0))


def crossing_endpoints(cfg, dist, span_m=1.0, clear_m=1.0):
    """p0 and goal span_m either side of a mapped obstacle voxel along x or
    y, both at least clear_m from the map, so that the straight flight
    between them passes through the obstacle: the first such voxel in the
    grid's order."""
    k = round(span_m / cfg.resolution)
    for axis in (0, 1):
        n = dist.shape[axis]
        at = lambda a, b: dist.narrow(axis, a, b - a)
        cand = ((at(k, n - k) == 0) & (at(0, n - 2 * k) >= clear_m)
                & (at(2 * k, n) >= clear_m))
        hits = cand.nonzero()
        if len(hits):
            o = hits[0].clone()
            o[axis] += k
            step = torch.zeros(3, dtype=o.dtype, device=o.device)
            step[axis] = k
            centre = lambda v: (torch.tensor(cfg.origin, device=dist.device)
                                + (v.float() + 0.5) * cfg.resolution)
            return centre(o - step), centre(o + step)
    raise AssertionError("no mapped obstacle with clear space on two sides")


def straight_controls(m, p0, goal):
    """Accelerate toward goal for the first half of the horizon and brake
    in the second: a nominal that flies the straight line from rest."""
    h = m.horizon // 2
    a = (goal - p0) / ((h * m.dt) ** 2)
    return torch.cat([a.expand(h, 3), -a.expand(m.horizon - h, 3)])


def card_vs_cpu(on_card, on_cpu):
    return dict(
        controls=float((on_card.controls.cpu() - on_cpu.controls).abs().max()),
        positions=float((on_card.positions.cpu() - on_cpu.positions).abs()
                        .max()),
        cost_rel=abs(float(on_card.cost) - float(on_cpu.cost))
        / abs(float(on_cpu.cost)))


def crossing_solve(cfg, m, dist, normals):
    """A full-width solve whose straight line crosses a mapped obstacle,
    on the card and on the CPU from the same draws: the collision term is
    nonzero for a share of the samples and for the nominal, whose cost
    gradient (autograd through ``get_dist_grad_trilinear``) agrees within
    GRAD_TOL relative and the solves within PLAN_TOL."""
    p0, goal = crossing_endpoints(cfg, dist)
    v0 = torch.zeros(3, device=dist.device)
    nominal = straight_controls(m, p0, goal)
    free = dataclasses.replace(m, w_collision=0.0)
    samples = torch.clamp(nominal[:, :, None] + normals.to(dist.device)
                          * m.sigma, -m.a_max, m.a_max)
    hit = (mpc._sample_costs_soa(cfg, m, dist, p0, v0, goal, samples)
           != mpc._sample_costs_soa(cfg, free, dist, p0, v0, goal, samples))
    share = float(hit.float().mean())

    def cost_grad(mc, grid, p, v, g, c):
        c = c.detach().requires_grad_(True)
        cost = mpc.trajectory_cost(cfg, mc, grid,
                                   mpc.rollout_positions(mc, p, v, c), c, g)
        return cost.detach(), torch.autograd.grad(cost, c)[0]

    cpu = [x.cpu() for x in (dist, p0, v0, goal, nominal)]
    cost, g_card = cost_grad(m, dist, p0, v0, goal, nominal)
    cost_free, _ = cost_grad(free, dist, p0, v0, goal, nominal)
    _, g_cpu = cost_grad(m, *cpu)
    collision = float(cost - cost_free)
    grad_rel = float(torch.linalg.norm(g_card.cpu() - g_cpu)
                     / torch.linalg.norm(g_cpu))
    assert share > 0 and collision > 0, (
        f"crossing solve reads no obstacle: share {share}, nominal "
        f"collision {collision}")
    assert grad_rel < GRAD_TOL, f"card vs CPU gradient: {grad_rel}"
    on_card = mpc._plan_step_impl(cfg, m, dist, p0, v0, goal, nominal,
                                  normals.to(dist.device))
    on_cpu = mpc._plan_step_impl(cfg, m, *cpu, normals)
    check_plan(on_card, "crossing plan_step")
    diff = card_vs_cpu(on_card, on_cpu)
    assert max(diff.values()) < PLAN_TOL, f"crossing card vs CPU: {diff}"
    return dict(p0=p0.tolist(), goal=goal.tolist(),
                colliding_sample_share=share,
                nominal_collision_cost=collision, grad_rel=grad_rel,
                cost=float(on_card.cost), card_vs_cpu=diff)


def check_plan(res, what):
    for name, x in res._asdict().items():
        assert bool(torch.isfinite(x).all()), f"{what}: {name} not finite"
    assert float(res.best_sample_cost) <= float(res.mean_sample_cost), what


def run_planner(cfg, state, dev):
    """The planner on ``state``'s map at ``MPCConfig()``: one solve, then
    ms per solve (CUDA events, one sync a solve), FLY_STEPS receding-horizon
    steps as ``run.py --fly`` runs them (``run.py:660-680``, host clock,
    one sync a step), one signed solve on the signed field and one with
    trilinear sampling, and a solve from CPU draws on the card and on the
    CPU, also through a mapped obstacle (``crossing_solve``); and a
    solve's device busy time and CUDA launches (profiler) and the
    sampling stage's time alone.  Every cost finite, best <= mean, card
    within PLAN_TOL of CPU."""
    m = mpc.MPCConfig()
    dist = query.distance_grid(cfg, state.d2, state.seen)
    p0, goal = fly_start(cfg, dev)
    v0 = torch.zeros(3, device=dev)
    nominal = torch.zeros((m.horizon, 3), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = mpc.plan_step(cfg, m, dist, p0, v0, goal, nominal, gen)
    check_plan(res, "plan_step")
    solve_ms = []
    for _ in range(PLAN_SOLVES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        check_plan(mpc.plan_step(cfg, m, dist, p0, v0, goal, nominal, gen),
                   "plan_step")
        b.record()
        b.synchronize()
        solve_ms.append(a.elapsed_time(b))
    # where a solve's time goes: the card's busy time and CUDA launches in
    # one solve (profiler), and the MPPI sampling stage alone (host-paced;
    # the rest of a solve is the refinement)
    by_name, counts, _ = profiled(
        lambda: mpc.plan_step(cfg, m, dist, p0, v0, goal, nominal, gen), 1)
    samples = torch.clamp(nominal[:, :, None] + torch.randn(
        (m.horizon, 3, m.n_rollouts), generator=gen, device=dev) * m.sigma,
        -m.a_max, m.a_max)
    sampling = kernel_times(lambda: mpc._sample_costs_soa(
        cfg, m, dist, p0, v0, goal, samples), calls=3, windows=3)
    breakdown = dict(busy_ms=sum(by_name.values()),
                     cuda_launches=sum(counts.values()),
                     sampling_ms=sampling["ms"],
                     sampling_device_ms=sampling["device_ms"],
                     sampling_host_ms=sampling["host_ms"])
    p, v, nom = p0, v0, nominal
    executed, step_ms = [p0], []
    for _ in range(FLY_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = mpc.plan_step(cfg, m, dist, p, v, goal, nom, gen)
        v = torch.clamp(v + r.controls[0] * m.dt, -m.v_max, m.v_max)
        p = p + v * m.dt
        nom = mpc.shift_nominal(r.controls)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check_plan(r, "fly step")
        executed.append(p)
        if float(torch.linalg.norm(p - goal)) < 0.3:
            break
    clear = float(query.get_distance(cfg, dist, torch.stack(executed)).min())
    sdf = pipeline._sdf_from_state(cfg, state)
    signed = mpc.plan_step(cfg, dataclasses.replace(m, signed=True), sdf,
                           p0, v0, goal, nominal, gen)
    check_plan(signed, "signed plan_step")
    tri = mpc.plan_step(cfg, dataclasses.replace(m, sample_query="trilinear"),
                        dist, p0, v0, goal, nominal, gen)
    check_plan(tri, "trilinear plan_step")
    normals = torch.randn((m.horizon, 3, m.n_rollouts),
                          generator=torch.Generator().manual_seed(1))
    on_card = mpc._plan_step_impl(cfg, m, dist, p0, v0, goal, nominal,
                                  normals.to(dev))
    on_cpu = mpc._plan_step_impl(
        cfg, m, dist.cpu(), p0.cpu(), v0.cpu(), goal.cpu(), nominal.cpu(),
        normals)
    diff = card_vs_cpu(on_card, on_cpu)
    assert max(diff.values()) < PLAN_TOL, f"card vs CPU solve: {diff}"
    crossing = crossing_solve(cfg, m, dist, normals)
    return dict(
        plan_ms=statistics.median(solve_ms), plan_ms_all=solve_ms,
        solve=breakdown,
        fly_step_ms=statistics.median(step_ms), fly_steps=len(step_ms),
        fly_start=p0.tolist(), goal=goal.tolist(), fly_end=p.tolist(),
        fly_clearance_m=clear, costs={
            name: {k: float(getattr(r, k)) for k in
                   ("cost", "best_sample_cost", "mean_sample_cost")}
            for name, r in (("nearest", res), ("signed", signed),
                            ("trilinear", tri))},
        card_vs_cpu=diff, crossing=crossing)


@contextlib.contextmanager
def recorded_relax():
    """Record the inputs of every relax kernel call while inside (the
    wrapper still launches and counts)."""
    calls, wrapped = [], kernels.relax_to_fixpoint

    def call(*args, **kw):
        out = wrapped(*args, **kw)
        calls.append((args, kw, out[2]))
        return out

    kernels.relax_to_fixpoint = call
    try:
        yield calls
    finally:
        kernels.relax_to_fixpoint = wrapped


def incremental_invariants(cfg, state, exact_d2, t, window=None):
    """FIESTA's consistency on an incremental map: every defined voxel's
    d2 is |v - closest|^2 and its closest is occupied, and where the exact
    d2 is below t^2 the map's d2 is at least that (the fixpoint never
    undercuts the exact EDT; the 24-stencil BFS overestimates).  Returns
    counts over the grid and, given ``window`` (the last update window's
    [X,Y,Z] mask; voxels outside it stay undefined by design), the same
    counts inside it."""
    c = state.closest.to(torch.int32)
    defined = c[0] >= 0
    assert torch.equal(defined, state.d2 < ft.grid.INF_D2), \
        "defined closest and finite d2 disagree"
    diff = ft.grid.coord_grids(cfg.grid_shape, state.device).to(
        torch.int32) - c
    dd = (diff * diff).sum(0)
    assert torch.equal(torch.where(defined, dd, 0),
                       torch.where(defined, state.d2, 0)), \
        "d2 != |v - closest|^2 on a defined voxel"
    _, gy, gz = cfg.grid_shape
    lin = torch.where(defined, c[0] * (gy * gz) + c[1] * gz + c[2], 0)
    occ = ft.occupied_grid(cfg, state.logodds)
    assert bool((torch.take(occ, lin.long()) | ~defined).all()), \
        "a closest obstacle is not occupied"
    near = exact_d2 < t * t
    assert bool((state.d2[near] >= exact_d2[near]).all()), \
        "the incremental d2 undercuts the exact EDT"
    out = dict(defined=int(defined.sum()), near=int(near.sum()),
               over_exact=int((state.d2[near] > exact_d2[near]).sum()),
               occupied=int(occ.sum()))
    if window is not None:
        near_in = near & window
        assert bool((state.d2[near_in] >= exact_d2[near_in]).all()), \
            "the incremental d2 undercuts the exact EDT in the window"
        out["in_window"] = dict(
            voxels=int(window.sum()), defined=int((defined & window).sum()),
            near=int(near_in.sum()),
            over_exact=int((state.d2[near_in] > exact_d2[near_in]).sum()),
            near_undefined=int((near_in & ~defined).sum()))
    return out


def relax_changed_per_sweep(d2, c, update, source, dirs, max_iters=0,
                            push_src=None, push_recv=None):
    """The voxels whose d2 fell in each sweep of the plain loop (on the
    tensors' device): what a frontier has to visit."""
    counts = []
    while True:
        nd2, c, _ = esdf.relax_once(d2, c, update, source, dirs, push_src,
                                    push_recv)
        counts.append(int((nd2 < d2).sum()))
        d2 = nd2
        if not counts[-1] or (max_iters and len(counts) >= max_iters):
            return counts


def relax_bounds(nvox, ndirs, sweeps, changed, visited):
    """The relax kernel's bounds for a call, each the larger of its bytes
    (d2 and closest read and written once) and its operations: the dense
    one (every sweep computes every candidate of every voxel) and the
    frontier one, the work the function needs: the dense first sweep,
    then each later sweep's candidates of the neighbours that changed in
    the sweep before.  Beside them, not in them, the frontier design's own
    extra work: one changed-bit test a direction for each voxel of a tile
    visited after the first sweep, and those tiles' d2 and closest read
    and written.  Returns (dense, frontier, extra), each (ms, by).

    Unlike the cell's ``roofline.relax_bound_s``, which counts only the
    candidates of the voxels that change, both count the dense first sweep
    and every voxel's bytes: they bound this kernel, which starts dense."""
    io_bytes = nvox * 20
    dense = in_ms(bound_s(io_bytes, RELAX_OPS * ndirs * nvox * sweeps,
                          I32_OPS_PER_S))
    frontier = in_ms(bound_s(io_bytes, RELAX_OPS * ndirs * (
        nvox + sum(changed[:sweeps - 1])), I32_OPS_PER_S))
    later = sum(visited[1:]) * int(np.prod(kernels.RELAX_TILE))
    extra = in_ms(bound_s(later * 20, ndirs * later, I32_OPS_PER_S))
    return dense, frontier, extra


def relax_logged(args, kw):
    """One relax kernel call through ``kernels.relax_sweeps``: (d2,
    closest, sweeps tensor, sweeps, the grid's blocks, tiles visited per
    sweep)."""
    d2, c, state = kernels.relax_sweeps(*args, **kw)
    st = state.cpu().tolist()
    return d2, c, state[1], st[1], st[2], st[3:3 + st[1]]


def relax_row(calls, nvox):
    """The relax kernel at the main path's shapes: on the recorded call
    with the most sweeps and on the last, timed beside the plain loop and
    the bounds, with the voxels that changed in each sweep (the plain loop
    on the card), the tiles the kernel visited and its cooperative grid's
    blocks an SM; one CUDA launch a call."""
    out = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    most = max(calls, key=lambda c: int(c[2]))
    for name, (args, kw, sweeps) in (("most", most), ("last", calls[-1])):
        sweeps = int(sweeps)
        kern = lambda: kernels.relax_to_fixpoint(*args, **kw)  # noqa: E731
        plain = lambda: esdf._relax_to_fixpoint_plain(*args, **kw)  # noqa
        ref = plain()
        *got, logged, blocks, visited = relax_logged(args, kw)
        err = max_abs_err(got, ref)
        changed = relax_changed_per_sweep(*args, **kw)
        assert logged == len(changed) == len(visited) == sweeps, \
            (logged, len(changed), len(visited), sweeps)
        times = kernel_times(kern, calls=2, windows=3)
        by_name, counts, _ = profiled(kern, 2)
        ndirs = len(args[4])
        ntiles = int(np.prod([-(-n // t) for n, t in zip(
            args[0].shape, kernels.RELAX_TILE)]))
        dense, frontier, extra = relax_bounds(nvox, ndirs, sweeps, changed,
                                              visited)
        out[name] = dict(
            sweeps=sweeps, err=err, ms=times["ms"],
            device_ms=times["device_ms"], host_ms=times["host_ms"],
            ms_per_sweep=times["ms"] / sweeps,
            device_ms_per_sweep=times["device_ms"] / sweeps,
            plain_ms=time_ms(plain, calls=1, windows=1),
            bound_ms=frontier[0], bound_by=frontier[1],
            bound_ms_per_sweep=frontier[0] / sweeps,
            dense_bound_ms=dense[0], dense_bound_by=dense[1],
            dense_bound_ms_per_sweep=dense[0] / sweeps,
            tile_extra_ms=extra[0], tile_extra_by=extra[1],
            changed_per_sweep=changed, tiles_per_sweep=visited,
            tiles=ntiles, tile_share=sum(visited) / (ntiles * sweeps),
            blocks_per_sm=blocks / sms, sms=sms,
            cuda_launches=sum(counts.values()), by_kernel=by_name,
            directions=ndirs)
    return out


def changes_row(cfg, state, batch):
    """The ``changes`` kernel as the incremental tick calls it, on one
    more tick ``batch`` of ``state``'s map: the one-pass drain's occupancy
    and the log-odds before it (``esdf.NewlyOccupied``), the map's d2 and
    closest.  Bit-equal to the plain version, its CUDA launches a call,
    then its times (``kernel_times``) beside the plain version's and its
    bytes bound (25 bytes a voxel: d2, the three closest planes, the
    occupancy and the old log-odds read, d2 and the planes written)."""
    ticked = pipeline.integrate_scan_batch(cfg, ft.copy_state(state),
                                           *batch[:3], batch[3])
    on, eq = ((cfg.min_occupancy_log, False) if cfg.probabilistic
              else (1.0, True))
    occ = fusion.fuse_drain(
        ticked.logodds, ticked.seen, ticked.hit_cnt, ticked.miss_cnt,
        l_hit=cfg.prob_hit_log, l_miss=cfg.prob_miss_log,
        clamp_min=cfg.clamp_min_log, clamp_max=cfg.clamp_max_log,
        occ_thresh=on, occ_is_eq=eq)[2]
    inserts = esdf.NewlyOccupied(ticked.logodds, on, eq)
    args = (state.d2, state.closest, occ, inserts)
    kern = lambda: esdf.apply_occupancy_changes(*args, mask=None)  # noqa
    plain = lambda: esdf._apply_occupancy_changes_plain(  # noqa: E731
        *args, mask="reset")
    ref = plain()
    by_kernel, counts, _ = profiled(kern, 10)
    nvox = state.d2.numel()
    return dict(
        name="changes", source="fiesta_tpu_torch/kernels/changes.cu",
        replaces="fiesta_tpu/ops/esdf.py:224 (apply_occupancy_changes; "
                 "port-only: XLA fusion in fiesta_tpu)",
        err=max_abs_err(list(kern()[:2]), list(ref[:2])),
        **kernel_times(kern), plain_ms=time_ms(plain), library_ms=None,
        cuda_launches=sum(counts.values()), by_kernel=by_kernel,
        bound=in_ms(bound_s(25 * nvox, CHANGES_OPS * nvox, I32_OPS_PER_S)),
        inserted=int(inserts.mask(occ).sum()), reset=int(ref[2].sum()))


def incremental_tick_launches(cfg, state, batch, use_window):
    """CUDA launches and device ms by kernel of one incremental tick from
    ``state`` (profiler)."""
    by_name, counts, wall = profiled(lambda: ft.fused_batch_step(
        cfg, ft.copy_state(state), *batch, use_window=use_window), 1)
    return dict(cuda_launches=sum(counts.values()),
                busy_ms=sum(by_name.values()), wall_ms=wall,
                relax_device_ms=sum(v for k, v in by_name.items()
                                    if "relax_sweeps" in k))


def world_frames(cfg, h, w):
    """Scans of an orbit of WORLD_RADIUS about the cow grid's centre in a
    WORLD_SIZE box world: the robot leaves the grid's central box."""
    world_cfg = dataclasses.replace(
        cfg, origin=(-WORLD_SIZE / 2, -WORLD_SIZE / 2, cfg.origin[2]),
        map_size=(WORLD_SIZE, WORLD_SIZE, cfg.map_size[2]))
    _, frames = replay.make_sequence(
        world_cfg, n_frames=WORLD_FRAMES, n_boxes=40, seed=0, kind="cloud",
        height=h, width=w, period=WORLD_PERIOD, orbit_radius=WORLD_RADIUS)
    return frames


def _paste(dst, dst_lo, src, src_lo):
    """Copy the overlap of box ``src`` at world corner ``src_lo`` into
    ``dst`` at ``dst_lo``."""
    a = np.maximum(dst_lo, src_lo)
    b = np.minimum(dst_lo + dst.shape, src_lo + src.shape)
    if (b <= a).any():
        return
    dst[tuple(slice(i, j) for i, j in zip(a - dst_lo, b - dst_lo))] = \
        src[tuple(slice(i, j) for i, j in zip(a - src_lo, b - src_lo))]


def run_world(cfg, frames, dev, timed=False):
    """``ScrollingFiestaPipeline`` with a tile archive over ``frames``,
    ``update()`` every third frame.  Checks that every entered strip holds
    what was evicted there (the latest store of each world voxel, unseen
    and 0 where none was); with ``timed`` each recenter and its drain,
    strip transfers and re-derive are timed to the device's end.  Returns
    (pipe, checks, times)."""
    pipe = ScrollingFiestaPipeline(cfg, method="scanline", archive=True,
                                   device=dev)
    stores, checks = [], collections.Counter()
    times = collections.defaultdict(list)
    store = pipe.archive.store

    def record(world_lo, lo, seen):
        stores.append((np.asarray(world_lo, np.int64), np.array(lo),
                       np.asarray(seen, bool)))
        store(world_lo, lo, seen)

    pipe.archive.store = record

    def clocked(name, fn):
        def call(*args):
            if not timed:
                return fn(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    restore = clocked("strips", pipe._restore_entered)

    def restore_checked(shift_vox):
        out = restore(shift_vox)
        for ax in range(3):
            if int(shift_vox[ax]) == 0:
                continue
            sl = pipe._axis_strip(shift_vox, ax, entering=True)
            lo0 = np.array([s.indices(n)[0] for s, n in
                            zip(sl, cfg.grid_shape)]) + pipe.origin_vox
            shape = tuple(len(range(*s.indices(n))) for s, n in
                          zip(sl, cfg.grid_shape))
            want_lo = np.zeros(shape, np.float32)
            want_seen = np.zeros(shape, bool)
            for w_lo, lo, seen in stores:
                _paste(want_lo, lo0, lo, w_lo)
                _paste(want_seen, lo0, seen, w_lo)
            got_lo = pipe.state.logodds[sl].cpu().numpy()
            got_seen = pipe.state.seen[sl].cpu().numpy().astype(bool)
            assert np.array_equal(got_lo.view(np.int32),
                                  want_lo.view(np.int32)), \
                "restored log-odds differ from the evicted"
            assert np.array_equal(got_seen, want_seen), \
                "restored seen differs from the evicted"
            checks["strips_checked"] += 1
            checks["restored_seen_voxels"] += int(want_seen.sum())
        return out

    pipe._restore_entered = restore_checked
    pipe._drain_counters = clocked("drain", pipe._drain_counters)
    pipe._archive_evicted = clocked("strips", pipe._archive_evicted)
    pipe._rederive_distances = clocked("rederive", pipe._rederive_distances)
    recenter = clocked("recenter", pipe.maybe_recenter)

    def maybe_recenter(pos):
        n = len(times["recenter"])
        moved = recenter(pos)
        if timed and not moved:
            del times["recenter"][n:]
        return moved

    pipe.maybe_recenter = maybe_recenter
    for i, (t, (p, q), scan) in enumerate(frames):
        pipe.observe_pose(t, p, q)
        pipe.observe_cloud(t, scan)
        if i + 1 < len(frames):
            pipe.observe_pose(frames[i + 1][0], *frames[i + 1][1])
        pipe.process()
        if i % 3 == 2:
            pipe.update()
    pipe.observe_pose(frames[-1][0] + 1.0, *frames[-1][1])
    pipe.process()
    pipe.update()
    torch.cuda.synchronize()
    return pipe, dict(checks), dict(times)


def world_path(cfg, frames, dev):
    """Phase 11 in one ``esdf_mode``: the persistent scrolling engine on
    the kernels (timed), then on the plain versions; states, anchor, counts
    and tiles bit-equal; a checkpoint of the map loads back bit-equal with
    its anchor.  Returns a summary."""
    kernels.reset_launch_counts()
    k_pipe, checks, times = run_world(cfg, frames, dev, timed=True)
    names = INCR_KERNELS if cfg.esdf_mode == "incremental" else \
        STREAM_KERNELS
    world_launches = read_launches(names)
    check_launched(world_launches, f"the {cfg.esdf_mode} unbounded world")
    assert k_pipe.scroll_count >= 2, k_pipe.scroll_count
    assert k_pipe.restore_count >= 1 and checks.get(
        "restored_seen_voxels", 0) > 0, checks
    with plain_versions():
        p_pipe, p_checks, _ = run_world(cfg, frames, dev)
    for f in ft.grid.FIELDS:
        bit_equal(getattr(k_pipe.state, f), getattr(p_pipe.state, f),
                  f"unbounded world {cfg.esdf_mode} {f}")
    assert np.array_equal(k_pipe.origin_vox, p_pipe.origin_vox)
    assert (k_pipe.scroll_count, k_pipe.restore_count) == \
        (p_pipe.scroll_count, p_pipe.restore_count)
    assert sorted(k_pipe.archive.tiles) == sorted(p_pipe.archive.tiles)
    for key, tile in k_pipe.archive.tiles.items():
        for name in ("logodds", "seen"):
            assert np.array_equal(tile[name], p_pipe.archive.tiles[key][name])
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/map.npz"
        checkpoint.save(path, cfg, k_pipe.state, origin_vox=k_pipe.origin_vox)
        cfg2, state2 = checkpoint.load(path)
        anchor = checkpoint.load_anchor(path)
    assert cfg2 == cfg and state2.device == k_pipe.state.device
    for f in ft.grid.FIELDS:
        bit_equal(getattr(state2, f), getattr(k_pipe.state, f),
                  f"checkpoint {f}")
    assert np.array_equal(anchor, k_pipe.origin_vox)
    med = {k: statistics.median(v) for k, v in times.items() if v}
    per = {k: sum(v) / max(len(times["recenter"]), 1)
           for k, v in times.items() if k != "recenter"}
    return dict(scrolls=k_pipe.scroll_count, restores=k_pipe.restore_count,
                origin_vox=k_pipe.origin_vox.tolist(),
                tiles=k_pipe.archive.num_tiles,
                archived_seen=k_pipe.archive.seen_voxels(),
                occupied=int(k_pipe.occupied().sum()), launches=world_launches,
                recenters=len(times.get("recenter", [])),
                recenter_ms_median=med.get("recenter"),
                per_recenter_ms=per, checks=checks)


def incremental_path(cfg, batches, k_state, frames, dev, card, rows,
                     launches):
    """Phase 10: the phase-2 stream in incremental mode, global and in the
    demo preset's window, kernels then plain; the invariants against phase
    2's exact d2 (``k_state``); the relax kernel's timings on each
    stream's calls and its row (the global stream's, appended to
    ``rows``); the incremental engine
    under sync debug mode "error".  Adds the launches to ``launches``;
    returns (summary, relax timings by stream)."""
    icfg = dataclasses.replace(cfg, esdf_mode="incremental").validate()
    wcfg = dataclasses.replace(icfg, global_update=False,
                               radius=ft.DEMO_ONBOARD.radius).validate()
    t_total = edt.trunc_vox_for(cfg.resolution, cfg.trunc_dist)
    incr, relax_calls = {}, {}
    for name, c in (("global", icfg), ("window", wcfg)):
        use_window = not c.global_update
        kernels.reset_launch_counts()
        with recorded_relax() as calls:
            i_state, i_stats, i_ms = run_stream(c, batches, dev, use_window)
        i_launches = read_launches(INCR_KERNELS)
        log(f"incremental {name} stream (kernels): {i_ms:.3f} ms/tick on "
            f"{card}; launches {i_launches}")
        check_launched(i_launches, f"the incremental {name} stream")
        assert i_launches["relax"] == i_launches["changes"] == \
            batches[0].shape[0], i_launches
        launches.update(i_launches)
        with plain_versions():
            ip_state, ip_stats, ip_ms = run_stream(c, batches, dev,
                                                   use_window)
        for f in ft.grid.FIELDS:
            bit_equal(getattr(i_state, f), getattr(ip_state, f),
                      f"incremental {name} {f}")
        for f, a, b in zip(i_stats._fields, i_stats, ip_stats):
            assert torch.equal(a, b), f"incremental {name} UpdateStats.{f}"
        if use_window:
            exact = edt.truncated_edt_d2(
                ft.occupied_grid(c, i_state.logodds), t_total)
        else:
            assert torch.equal(i_state.logodds, k_state.logodds), \
                "the incremental stream's log-odds differ from phase 2's"
            exact = k_state.d2
        wmask = (ft.grid.window_mask(c, *ft.local_window(c, batches[3][-1]))
                 if use_window else None)
        inv = incremental_invariants(c, i_state, exact, t_total, wmask)
        tick = incremental_tick_launches(c, i_state,
                                         tuple(b[-1] for b in batches),
                                         use_window)
        incr[name] = dict(
            ms_per_tick=i_ms, plain_ms_per_tick=ip_ms,
            sweeps=i_stats.num_sweeps.tolist(),
            inserted=i_stats.num_inserted.tolist(),
            deleted=i_stats.num_deleted.tolist(), launches=i_launches,
            invariants=inv, next_tick=tick)
        log(f"incremental {name} stream bit-equal to plain ({ip_ms:.3f} "
            f"ms/tick plain); sweeps per tick {incr[name]['sweeps']}, "
            f"inserted {incr[name]['inserted']}, deleted "
            f"{incr[name]['deleted']}; invariants {inv}; one more tick: "
            f"{tick['cuda_launches']:g} CUDA launches, busy "
            f"{tick['busy_ms']:.3f} ms (relax {tick['relax_device_ms']:.3f})"
            f"; on {card}")
        relax_calls[name] = calls
        if name == "global":
            changes = changes_row(c, i_state, tuple(b[-1] for b in batches))
            rows.append(changes)
            log(f"changes (one more tick of the global stream's map, "
                f"{changes['inserted']} inserts, {changes['reset']} "
                f"resets): {changes['ms']:.4f} ms host-paced, "
                f"{changes['device_ms']:.4f} on the card alone, host "
                f"{changes['host_ms']:.4f} (bound "
                f"{changes['bound'][0]:.4f} ms by {changes['bound'][1]}), "
                f"plain {changes['plain_ms']:.4f}; CUDA launches a call "
                f"{changes['cuda_launches']:g}; bit-equal; on {card}")
    # after both streams' launch counts were read
    relax = {name: relax_row(calls, i_state.d2.numel())
             for name, calls in relax_calls.items()}
    most = relax["global"]["most"]
    rows.append(dict(
        name="relax", source="fiesta_tpu_torch/kernels/relax.cu",
        replaces="fiesta_tpu/ops/esdf.py:187 (relax_to_fixpoint's "
                 "lax.while_loop; port-only: XLA fusion in fiesta_tpu)",
        err=max(r["err"] for rs in relax.values() for r in rs.values()),
        ms=most["ms"],
        device_ms=most["device_ms"], host_ms=most["host_ms"],
        plain_ms=most["plain_ms"], library_ms=None,
        bound=(most["bound_ms"], most["bound_by"]),
        dense_bound=(most["dense_bound_ms"], most["dense_bound_by"]),
        cuda_launches=most["cuda_launches"], by_kernel=most["by_kernel"]))
    for stream, rs in relax.items():
        for which, r in rs.items():
            label = {"most": "the tick with the most sweeps",
                     "last": "the last tick"}[which]
            log(f"relax ({stream}, {label}: {r['sweeps']} sweeps, "
                f"{r['directions']} directions): {r['ms']:.3f} ms "
                f"host-paced, {r['device_ms']:.3f} on the card alone "
                f"({r['ms_per_sweep']:.4f} / {r['device_ms_per_sweep']:.4f}"
                f" ms a sweep); frontier bound {r['bound_ms']:.3f} "
                f"ms by {r['bound_by']} ({r['bound_ms_per_sweep']:.4f} a "
                f"sweep), dense bound {r['dense_bound_ms']:.3f} ms by "
                f"{r['dense_bound_by']} ({r['dense_bound_ms_per_sweep']:.4f}"
                f" a sweep); apart from the bounds, the frontier's own "
                f"bit tests and tile moves {r['tile_extra_ms']:.3f} ms by "
                f"{r['tile_extra_by']}; plain loop {r['plain_ms']:.1f} ms; "
                f"{r['cuda_launches']:g} CUDA launches a call; voxels "
                f"changed per sweep (plain loop) {r['changed_per_sweep']}; "
                f"tiles visited per sweep (kernel, of {r['tiles']}) "
                f"{r['tiles_per_sweep']}, {100 * r['tile_share']:.1f} % of "
                f"the dense work; the cooperative grid's blocks an SM "
                f"({r['sms']} SMs) {r['blocks_per_sm']}; on {card}")
    kernels.reset_launch_counts()
    eng_frames = frames[:ENGINE_FRAMES]
    ie_pipe, ie_out, ie_frame_ms, ie_update_ms = run_engine(
        icfg, eng_frames, "scanline", dev, no_sync=True)
    ie_launches = read_launches(INCR_KERNELS)
    check_launched(ie_launches, "the incremental engine")
    assert ie_launches["relax"] == ie_pipe.esdf_cnt, ie_launches
    launches.update(ie_launches)
    with plain_versions():
        _, iep_out, iep_frame_ms, iep_update_ms = run_engine(
            icfg, eng_frames, "scanline", dev)
    for f in ie_out:
        bit_equal(ie_out[f], iep_out[f], f"incremental engine {f}")
    incr["engine"] = dict(frame_ms=ie_frame_ms, update_ms=ie_update_ms,
                          plain_frame_ms=iep_frame_ms,
                          plain_update_ms=iep_update_ms,
                          updates=ie_pipe.esdf_cnt, launches=ie_launches)
    log(f"incremental engine (kernels): {ie_frame_ms:.3f} ms per process() "
        f"frame, {ie_update_ms:.3f} ms per update(), neither waiting for "
        f"the device; bit-equal to plain ({iep_frame_ms:.3f} / "
        f"{iep_update_ms:.3f} ms); launches {ie_launches}; on {card}")
    return incr, relax


def unbounded_world(cfg, h, w, dev, card, launches):
    """Phase 11: the persistent scrolling engine at ``cfg`` on an orbit
    past its grid, in rebuild then incremental mode (``world_path``).
    Adds the launches to ``launches``; returns the summaries."""
    t0 = time.perf_counter()
    wframes = world_frames(cfg, h, w)
    log(f"unbounded world: {WORLD_FRAMES} scans on an orbit of "
        f"{WORLD_RADIUS} m in a {WORLD_SIZE} m world rendered in "
        f"{time.perf_counter() - t0:.1f} s")
    world = {}
    for mode in ("rebuild", "incremental"):
        mcfg = dataclasses.replace(cfg, esdf_mode=mode).validate()
        world[mode] = world_path(mcfg, wframes, dev)
        launches.update(world[mode]["launches"])
        parts = world[mode]["per_recenter_ms"]
        log(f"unbounded world ({mode}): {world[mode]['scrolls']} scrolls, "
            f"{world[mode]['restores']} restores "
            f"({world[mode]['checks']}), {world[mode]['tiles']} tiles; "
            f"kernels == plain and the checkpoint loads back bit-equal with "
            f"its anchor {world[mode]['origin_vox']}; "
            f"{world[mode]['recenters']} recenters, median "
            f"{world[mode]['recenter_ms_median']} ms, per recenter "
            f"{ {k: round(v, 3) for k, v in parts.items()} } ms; launches "
            f"{world[mode]['launches']}; on {card}")
    return world


@contextlib.contextmanager
def no_device_wait():
    """Run every ``FiestaPipeline.process()`` and ``update()`` under
    PyTorch's sync debug mode "error", so that one that waits for the
    device raises; restored afterwards."""
    cls = ft.FiestaPipeline
    saved = cls.process, cls.update

    def guarded(fn):
        def call(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    cls.process, cls.update = guarded(saved[0]), guarded(saved[1])
    try:
        yield
    finally:
        cls.process, cls.update = saved


@contextlib.contextmanager
def timed(owner, name, into):
    """Append the host seconds of every ``owner.<name>(...)`` call to the
    list ``into``; restored afterwards."""
    fn = getattr(owner, name)

    def call(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            into.append(time.perf_counter() - t0)

    setattr(owner, name, call)
    try:
        yield into
    finally:
        setattr(owner, name, fn)


def run_app(argv):
    """``fiesta_tpu_torch.run.main(argv)`` in this process with the
    timing registry reset; returns (its stderr, wall s)."""
    Timing.reset()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = fiesta_run.main(argv)
    wall = time.perf_counter() - t0
    assert rc == 0, err.getvalue()[-2000:]
    return err.getvalue(), wall


def same_checkpoint(a, b, what):
    """Two checkpoints (state, config, anchor) equal bit for bit."""
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files), what
        for k in x.files:
            assert x[k].dtype == y[k].dtype and \
                x[k].tobytes() == y[k].tobytes(), f"{what}: {k} differs"


def app_path(card, launches):
    """Phase 12: the app (``python -m fiesta_tpu_torch.run``) in this
    process at cow_and_lady: the kernel run with periodic checkpoints, the
    viz artifacts, the ground-truth oracle and an MPC solve, its
    ``process()`` and ``update()`` under sync debug mode "error", launch
    counts zeroed just before and read just after, the host seconds of
    its ``process()``, ``update()`` and checkpoint saves apart; the same
    frames on the plain versions, then replayed from an ``.npz`` and from
    a ROS bag with the preset's topics, and once in incremental mode.
    Checkpoints bit-equal kernels == plain and npz == bag.  Adds the
    launches to ``launches``; returns a summary."""
    base = ["--preset", "cow_and_lady", "--platform", "cuda",
            "--update-every", "3"]
    out = {}
    host = {"process": [], "update": [], "save": []}
    with tempfile.TemporaryDirectory() as tmp:
        synth = base + ["--frames", str(APP_FRAMES)]
        kernels.reset_launch_counts()
        with no_device_wait(), \
                timed(ft.FiestaPipeline, "process", host["process"]), \
                timed(ft.FiestaPipeline, "update", host["update"]), \
                timed(checkpoint, "save", host["save"]):
            err, wall = run_app(synth + [
                "--checkpoint", f"{tmp}/k.npz", "--checkpoint-every", "3",
                "--viz-dir", f"{tmp}/viz", "--ground-truth-check", "--mpc"])
        app_launches = read_launches(STREAM_KERNELS)
        check_launched(app_launches, "the app")
        launches.update(app_launches)
        # the update's device time (CUDA events), not its enqueue
        update_ms = Timing.get_mean_device_seconds("UpdateESDF") * 1e3
        steady = re.search(r"steady-state: (\S+) ms/frame", err)
        report = json.loads(re.search(r"^\{\n.*?^\}$", err,
                                      re.S | re.M).group(0))
        cost = float(re.search(r"MPC: \d+ rollouts, cost (\S+),",
                               err).group(1))
        assert report["count_under"] == 0, report
        assert np.isfinite(cost), cost
        for name in ("slice.npz", "occ_pc.npz", "slice_00010.npz"):
            assert (pathlib.Path(tmp) / "viz" / name).exists(), name
        processed = re.search(r"^processed .* in (\S+)s \(.*$", err, re.M)
        loop_s = float(processed.group(1))
        # the periodic saves run in the loop (each reads the map back from
        # the card); the last save is the final one, after the loop
        saves = host["save"][:-1]
        out["kernels"] = dict(
            wall_s=wall, steady_ms_per_frame=float(steady.group(1)),
            processed=processed.group(0), loop_s=loop_s,
            process_s=sum(host["process"]), update_s=sum(host["update"]),
            periodic_save_s=saves, update_ms=update_ms,
            launches=app_launches,
            rms_error=report["rms_error"], count_under=report["count_under"],
            count_over=report["count_over"], num_known=report["num_known"],
            mpc_cost=cost)
        log(f"app (kernels): {processed.group(0)}; steady state "
            f"{out['kernels']['steady_ms_per_frame']} ms/frame (median "
            f"host seconds a frame over the replay's 2nd half, frames with "
            f"a checkpoint save among them); the loop "
            f"{loop_s:.2f} s: process() {sum(host['process']):.3f} s and "
            f"update() {sum(host['update']):.3f} s over "
            f"{len(host['process'])} / {len(host['update'])} calls (host, "
            f"none waiting for the device), periodic checkpoint saves "
            f"{' + '.join(f'{x:.3f}' for x in saves)} s (each waits for "
            f"the device); {update_ms:.3f} "
            f"ms per update() (timing table, host enqueue), wall "
            f"{wall:.2f} s; oracle rms_error {report['rms_error']:.6f}, "
            f"count_under {report['count_under']}, count_over "
            f"{report['count_over']} of {report['num_known']}; MPC cost "
            f"{cost:.2f}; launches {app_launches}; on {card}")

        with plain_versions():
            _, p_wall = run_app(synth + ["--checkpoint", f"{tmp}/p.npz"])
        same_checkpoint(f"{tmp}/k.npz", f"{tmp}/p.npz", "app kernels/plain")
        out["plain_wall_s"] = p_wall
        log(f"app checkpoint bit-equal to the plain run's ({p_wall:.2f} s "
            "plain)")

        cfg, h, w = fiesta_run._preset_cfg("cow_and_lady")
        _, seq = replay.make_sequence(cfg, n_frames=APP_FRAMES, n_boxes=12,
                                      seed=0, height=h, width=w)
        np.savez(f"{tmp}/seq.npz", t=np.asarray([t for t, _, _ in seq]),
                 pos=np.stack([p for _, (p, _), _ in seq]),
                 quat=np.stack([q for _, (_, q), _ in seq]),
                 clouds=np.stack([c for _, _, c in seq]))
        sensor, pose = fiesta_run.PRESET_TOPICS["cow_and_lady"]
        rosbag.frames_to_bag(f"{tmp}/seq.bag", seq, kind="cloud",
                             sensor_topic=sensor, pose_topic=pose)
        # an update every frame: the npz replay integrates its last frame
        # after the loop, the bag replay at its flush, so with an update
        # every third frame the two group the last tick alike only when
        # the frame count is no multiple of 3 (run.py, as fiesta_tpu's)
        every = base[:-2] + ["--update-every", "1", "--sensor-topic",
                             sensor, "--pose-topic", pose]
        with no_device_wait():
            _, r_wall = run_app(every + ["--replay", f"{tmp}/seq.npz",
                                         "--checkpoint", f"{tmp}/r.npz"])
            _, b_wall = run_app(every + ["--bag", f"{tmp}/seq.bag",
                                         "--checkpoint", f"{tmp}/b.npz"])
        same_checkpoint(f"{tmp}/r.npz", f"{tmp}/b.npz", "app npz/bag")
        out["replay_wall_s"], out["bag_wall_s"] = r_wall, b_wall
        log(f"app --replay and --bag checkpoints bit-equal ({r_wall:.2f} / "
            f"{b_wall:.2f} s, topics {sensor} {pose})")

        kernels.reset_launch_counts()
        with no_device_wait():
            i_err, i_wall = run_app(synth + ["--esdf-mode", "incremental"])
        i_launches = read_launches(INCR_KERNELS)
        check_launched(i_launches, "the incremental app")
        launches.update(i_launches)
        out["incremental"] = dict(
            wall_s=i_wall, launches=i_launches,
            steady_ms_per_frame=float(re.search(
                r"steady-state: (\S+) ms/frame", i_err).group(1)))
        log(f"app --esdf-mode incremental: {out['incremental']}; on {card}")
    return out


def soak_path(card):
    """Phase 13: ``soak_torch.py``'s drill at cow scale (ref, victim
    SIGKILLed mid-flight, resume from its last checkpoint + archive pair)
    in a subprocess: at least two scrolls and a restore, the resumed map
    bit-equal to the reference's.  Returns the drill's summary."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).with_name(
                "soak_torch.py")), "--scale", "cow", "--platform", "cuda",
             "--frames", str(SOAK_FRAMES), "--check-every",
             str(SOAK_CHECK_EVERY), "--ck-every", str(SOAK_CK_EVERY),
             "--workdir", tmp],
            capture_output=True, text=True, timeout=SOAK_TIMEOUT_S)
        wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if line.startswith(("===", "[")):
            log(f"  soak {line}")
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["bitexact_after_resume"], summary["mismatched_fields"]
    ref = summary["ref"]
    assert ref["scrolls"] >= 2 and ref["restores"] >= 1, ref
    summary["drill_wall_s"] = wall
    log(f"soak drill: {SOAK_FRAMES} frames at {summary['scale']} scale in "
        f"{wall:.1f} s; ref "
        f"{ref['ms_per_frame']:.2f} ms/frame, {ref['scrolls']} scrolls, "
        f"{ref['restores']} restores, {ref['c20_checks']} C20 checks; "
        f"victim killed, resumed from frame {summary['resumed_from_frame']}"
        f"; resumed map bit-equal to the reference's; on {card}")
    return summary


def twin_line(twin, card):
    """Phase 16, one twin: ``python3 twin`` (with its ``TWINS``
    arguments) from this checkout on the card, its last stdout line read
    as its result and held to its contract: the card named as ``card``,
    times above 0, accuracy's four statements, mpc's same-schedule max
    |du| under ``MPC_DU_TOL``, scaling's pad-term states bit-equal and
    its counted collective bytes equal to the port's terms.  A twin that
    fails, times out or prints no line raises."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).with_name(twin)),
         *TWINS[twin]],
        cwd=pathlib.Path(__file__).parent, capture_output=True, text=True,
        timeout=TWIN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, (f"{twin} exited {proc.returncode}:\n"
                                  + proc.stderr[-3000:])
    lines = proc.stdout.strip().splitlines()
    assert lines, f"{twin} printed no line:\n{proc.stderr[-3000:]}"
    line = json.loads(lines[-1])
    check_twin_line(twin, line, card)
    return line, wall


def check_twin_line(twin, line, card):
    """``twin_line``'s contract on a twin's result ``line``."""
    assert line["device"] == card, (twin, line["device"], card)
    if twin == "bench_scaling_torch.py":
        assert all(v > 0 for key in ("tick_ms", "mpc_ms", "weak_tick_ms")
                   for v in line[key].values()), line
        assert line["pad_skip_term"]["states_bit_equal"], line
        assert line["collective_bytes_n8"] == line["port_model_bytes_n8"], \
            line
    elif twin == "bench_accuracy_torch.py":
        # an error: 0 where the port's EDT is exact over the whole domain
        c = line["checks"]
        assert line["value"] >= 0 and c["fine_unreachable"] == 0, line
        assert c["fine_max_err_m"] <= 1e-6, line
        assert c["fine_min_err_m"] >= -1e-6, line
        assert c["full_max_err_m"] <= c["coarse_bound_m"] + 1e-6, line
        assert c["reference_min_err_m"] >= -1e-6, line
    else:
        assert line["value"] > 0, line
    if twin == "bench_mpc_torch.py":
        assert line["parity_max_du_same_schedule"] < MPC_DU_TOL, line


def twins_path(card):
    """Phase 16: every benchmark twin at its full widths, one after
    another (each builds nothing: the kernels of this checkout are
    built), each line logged."""
    for twin in TWINS:
        torch.cuda.empty_cache()
        line, wall = twin_line(twin, card)
        log(f"twin {twin} ({wall:.1f} s): {json.dumps(line)}")


# ---------------------------------------------------------------------------
# phase 14: the multi-device engine on virtual meshes of the card
# ---------------------------------------------------------------------------


def virtual_mesh(n, dev):
    """n X-slab shards, all on the one card (``make_mesh``'s virtual
    form)."""
    return sharding.make_mesh(n, [dev] * n)


def sharded_stream(cfg, mesh, batches):
    """The phase-2 ticks through ``sharded_fused_tick`` from an empty map:
    (sharded state, UpdateStats stacked over the ticks, ms a tick from
    CUDA events, host-paced)."""
    step = sharding.sharded_fused_tick(cfg, mesh)
    state = sharding.shard_state(ft.make_state(cfg, mesh.devices[0]), mesh)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    per_tick = []
    for i in range(batches[0].shape[0]):
        state, stats = step(state, *(x[i] for x in batches))
        per_tick.append(stats)
    b.record()
    b.synchronize()
    return (state, pipeline._stack_stats(per_tick),
            a.elapsed_time(b) / batches[0].shape[0])


def gathered(mesh, xs):
    """A per-shard list gathered along x (the closest planes along 1)."""
    return sharding._gather_axis(mesh, xs, 1 if xs[0].dim() == 4 else 0)


def same_state(got, want, what):
    for f in ft.grid.FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what} {f}"
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f"{what}: {f} differs"


def same_stats(got, want, what):
    for f, a, b in zip(got._fields, got, want):
        assert torch.equal(a.to(b.device), b), f"{what}: UpdateStats.{f}"


def copy_kernel_ms(by_name):
    """Device ms of the copy kernels in a profile (the halos' and
    gathers' concatenations and plane copies), by name."""
    keys = ("Cat", "copy", "Copy", "fill", "nccl")
    return {k: round(v, 4) for k, v in by_name.items()
            if any(s in k for s in keys)}


def drive_synced(pipe, frames, every):
    """``tests/test_sharding.py``'s feed: each frame followed by the next
    pose (the last by one a second later), ``update()`` every ``every``
    frames."""
    for i, (t, (p, q), scan) in enumerate(frames):
        pipe.observe_pose(t, p, q)
        pipe.observe_cloud(t, scan)
        if i + 1 < len(frames):
            pipe.observe_pose(frames[i + 1][0], *frames[i + 1][1])
        else:
            pipe.observe_pose(t + 1.0, p, q)
        pipe.process()
        if i % every == every - 1:
            pipe.update()
    torch.cuda.synchronize()
    return pipe


def fused_groups(cfg, frames, dev):
    """The single-device fused ticks on the engine's scan groups of three
    (padded as the engine pads them)."""
    state = ft.make_state(cfg, dev)
    for i in range(0, len(frames), 3):
        group = frames[i:i + 3]
        pv = [replay.pad_cloud_np(cfg, np.ascontiguousarray(s, np.float32),
                                  np.isfinite(s).all(axis=-1))
              for _, _, s in group]
        tfs = np.stack([replay.pose_to_matrix(p, q)
                        for _, (p, q), _ in group]).astype(np.float32)
        state, _ = ft.fused_batch_step(
            cfg, state,
            *(torch.from_numpy(np.stack(x)).to(dev) for x in zip(*pv)),
            torch.from_numpy(tfs).to(dev),
            torch.tensor(group[-1][1][0], dtype=torch.float32, device=dev))
    return state


def slab_rows(cfg, mesh, batches, k_state, icfg, ext, rows, card):
    """The kernels at the sharded path's slab shapes (n = mesh.size, one
    shard's slab of the final map, one shard's scans), each against its
    plain version: host-paced ms and ms on the card alone, beside the
    row's time at the flat shape (phase 7).  ``ext``: (d2, closest, own
    mask, x_offset) of a halo-extended slab for the relax sweep.  The
    relax kernel's x-origin form and the box add's out-of-slab corners
    (on shard j's slab, and on the first whose low face a box crosses)
    are held to their plain versions here."""
    n, gx = mesh.size, cfg.grid_shape[0]
    lx = gx // n
    j = n // 2 - 1                          # an interior shard
    x0 = j * lx
    occ = ft.occupied_grid(cfg, k_state.logodds)[x0:x0 + lx].contiguous()
    flat = {r["name"]: r["ms"] for r in rows}
    out = {}

    def row(name, kern, plain, what=""):
        err = max_abs_err(*(list(v) if isinstance(v, tuple) else [v]
                            for v in (kern(), plain())))
        t = kernel_times(kern)
        out[name] = dict(shape=what, err=err, ms=t["ms"],
                         device_ms=t["device_ms"],
                         plain_ms=time_ms(plain, calls=1, windows=3),
                         flat_ms=flat.get(name))

    pts, vals, tfs, cur = (b[0] for b in batches)
    own = slice(0, 1)                  # one shard's scans at n >= 3 scans
    _, po, lin, val, _ = raycast._scanline_splat_prep(
        cfg, pts[own], vals[own], transforms=tfs[own])
    box = raycast._carve_box_shape(cfg)
    nb = box[0] * box[1] * box[2]
    thr = raycast._epfree_threshold(cfg)
    row("splat", lambda: kernels.splat(lin, val, nb, thr),
        lambda: raycast._splat_packed_plain(lin, val, nb, thr),
        "one scan's rays")
    seeds = kernels.splat(lin, val, nb, thr)[0].view((1,) + box)
    carve = (cfg.resolution, cfg.min_ray_length, cfg.max_ray_length)
    row("carve", lambda: kernels.carve(seeds, po, *carve),
        lambda: raycast._carve_free_plain(cfg, seeds, po), "one scan's box")
    t = edt.trunc_vox_for(cfg.resolution, cfg.trunc_dist)
    f = edt.binary_field(occ)
    row("edt_binary", lambda: kernels.edt_binary(f, t, False),
        lambda: edt._binary_pass_plain(f, t, False), f"raw, {lx} planes")
    p1 = edt.square_l1(kernels.edt_binary(f, t, False), t)
    row("edt_minplus", lambda: (kernels.edt_minplus(p1, t, 1),
                                kernels.edt_minplus(p1, t, 2)),
        lambda: (edt._minplus_pass_plain(p1, t, 1),
                 edt._minplus_pass_plain(p1, t, 2)), "y and z passes")
    s = [getattr(k_state, name)[x0:x0 + lx].contiguous()
         for name in ("logodds", "seen", "hit_cnt", "miss_cnt")]
    on, off_eq = ((cfg.min_occupancy_log, False) if cfg.probabilistic
                  else (1.0, True))
    drain = dict(l_hit=cfg.prob_hit_log, l_miss=cfg.prob_miss_log,
                 clamp_min=cfg.clamp_min_log, clamp_max=cfg.clamp_max_log,
                 occ_thresh=on, occ_is_eq=off_eq)
    row("fuse", lambda: kernels.fuse(*s, **drain),
        lambda: fusion._fuse_drain_plain(*s, **drain), "global drain")
    starts, hitc, missc, _, _ = raycast.scanline_batch_boxes(
        cfg, pts, vals, transforms=tfs)
    z = torch.zeros_like(s[2])
    bx = hitc.shape[1]

    def boxadd_row(name, i):
        """The box add on shard i's slab, the corners shifted by -x0."""
        shifted = (starts - torch.tensor([i * lx, 0, 0], dtype=torch.int32,
                                         device=starts.device)).contiguous()
        row(name, lambda: kernels.boxadd(z.clone(), z.clone(), shifted,
                                         hitc, missc),
            lambda: raycast._apply_box_counts_plain(z.clone(), z.clone(),
                                                    shifted, hitc, missc),
            f"{starts.shape[0]} boxes on shard {i}, corners x "
            f"{shifted[:, 0].tolist()}")

    # shard j's slab, and the first whose low face the boxes cross (their
    # corners below 0 there)
    boxadd_row("boxadd", j)
    cx = starts[:, 0].tolist()
    low = [i for i in range(n) if any(c < i * lx < c + bx for c in cx)]
    assert low, f"no box crosses a slab's low face: corners x {cx}"
    boxadd_row("boxadd_low_face", low[0])
    plan = edt.closest_plan(cfg.grid_shape, t)
    u8 = edt._as_u8(occ)
    row("closest_binary", lambda: kernels.closest_binary(u8, plan, 0, False),
        lambda: edt._binary_packed_plain(u8, plan, 0, False), "raw")
    c1 = edt.square_packed_l1(kernels.closest_binary(u8, plan, 0, False)
                              + x0, plan)
    row("closest_window",
        lambda: kernels.closest_window(c1, plan, plan["b"]),
        lambda: edt._window_packed_plain(c1, plan, plan["b"]))
    c2 = kernels.closest_window(c1, plan, plan["b"])
    row("closest_split", lambda: kernels.closest_split(c2, plan, plan["c"]),
        lambda: edt._split_packed_plain(c2, plan, plan["c"]))
    c3 = kernels.closest_split(c2, plan, plan["c"])
    row("closest_decode", lambda: kernels.closest_decode(c3, plan, x0=x0),
        lambda: edt._decode_split_plain(c3, plan, x0=x0),
        f"i16 planes, payloads of global x, x0 {x0}")
    d2e, ce, mask, xo = ext
    row("relax", lambda: esdf.relax_sweep(d2e, ce, mask, None, icfg.stencil,
                                          x_offset=xo),
        lambda: esdf.relax_once(d2e, ce, mask, None, icfg.stencil,
                                x_offset=xo),
        f"one sweep, halo-extended {tuple(d2e.shape)}, x_offset {xo}")
    for name, r in out.items():
        log(f"{name} at the n = {n} slab shapes ({r['shape'] or lx}): "
            f"{r['ms']:.4f} ms host-paced, {r['device_ms']:.4f} on the card "
            f"alone (plain {r['plain_ms']:.4f}; at the flat shape "
            f"{r['flat_ms']}), bit-equal to plain; on {card}")
    return out


def sharded_path(cfg, h, w, batches, k_state, k_stats, k_ms, closest_ref,
                 hcfg, h_out, h_stats, frames, dev, card, rows, launches,
                 sharded_launches):
    """Phase 14: the multi-device engine (``fiesta_tpu_torch.parallel``)
    on virtual meshes of the one card (every shard's slab on cuda:0, the
    halos, relays and gathers copies on it): phase 2's ticks at 2 and 8
    shards, the two-level and windowed ticks, the incremental update,
    the engines, the planner, the NCCL transport at world size 1, the app
    with ``--devices 1``, and the kernels at slab shapes.  Bit-equal to
    the single-device results throughout.  Adds the launches to
    ``launches`` and ``sharded_launches``; returns a summary."""
    import torch.distributed as dist

    out = dict(note="all shards share one card (a virtual mesh): the "
                    "collectives are copies on it; no scaling is measured")
    log("sharded path: every shard of these meshes lies on the one card "
        f"({card}); halos, relays and gathers are copies on it")
    flat_busy = busy_ms_per_tick(cfg, batches, dev)
    ticks = batches[0].shape[0]
    stream_names = STREAM_KERNELS + CLOSEST_KERNELS
    out["stream"] = {}
    for n in SHARDS:
        mesh = virtual_mesh(n, dev)
        sharded_stream(cfg, mesh, tuple(b[:1] for b in batches))   # warm-up
        kernels.reset_launch_counts()
        before = collections.Counter(sharding.COLLECTIVES)
        state, stats, ms = sharded_stream(cfg, mesh, batches)
        derive = sharding.sharded_derive_closest(cfg, mesh)
        cl = gathered(mesh, derive(state.logodds))
        got = read_launches(stream_names)
        check_launched(got, f"the sharded stream at n = {n}")
        launches.update(got)
        sharded_launches.update(got)
        same_state(sharding.gather_state(state, mesh), k_state,
                   f"sharded stream n = {n}")
        same_stats(stats, k_stats, f"sharded stream n = {n}")
        bit_equal(cl, closest_ref, f"sharded derive_closest n = {n}")
        coll = dict(sharding.COLLECTIVES - before)
        by_name, counts, _ = profiled(
            lambda: sharded_stream(cfg, mesh, batches), 1)
        derive_ms = time_ms(lambda: derive(state.logodds))
        out["stream"][n] = dict(
            ms_per_tick=ms, busy_ms_per_tick=sum(by_name.values()) / ticks,
            cuda_launches_per_tick=sum(counts.values()) / ticks,
            launches=got, collectives=coll, derive_closest_ms=derive_ms,
            copies_device_ms_per_tick={
                k: v / ticks for k, v in copy_kernel_ms(by_name).items()})
        log(f"sharded stream n = {n} (virtual mesh, one card): {ms:.3f} "
            f"ms/tick host-paced, busy "
            f"{out['stream'][n]['busy_ms_per_tick']:.3f} ms/tick, "
            f"{out['stream'][n]['cuda_launches_per_tick']:.0f} CUDA launches "
            f"a tick (phase 2's flat tick {k_ms:.3f} ms host-paced, busy "
            f"{flat_busy:.3f}); state, stats and derive_closest bit-equal to "
            f"phases 2 and 3; derive {derive_ms:.3f} ms; launches {got}; "
            f"collectives over the run {coll}; copy kernels' device ms a tick "
            f"{out['stream'][n]['copies_device_ms_per_tick']}; on {card}")
    out["flat_busy_ms_per_tick"] = flat_busy

    mesh8 = virtual_mesh(8, dev)
    # the two-level tick (phase 8) and the demo window on phase 2's frames,
    # each run's launches zeroed just before it and read just after
    wcfg = dataclasses.replace(cfg, global_update=False,
                               radius=ft.DEMO_ONBOARD.radius).validate()
    w_state, w_stats, w_flat_ms = run_stream(wcfg, batches, dev, True)
    kernels.reset_launch_counts()
    hs, hstats, h_ms = sharded_stream(hcfg, mesh8, batches)
    h_closest = gathered(mesh8, sharding.sharded_derive_closest(hcfg, mesh8)(
        hs.logodds))
    h_got = read_launches(stream_names)
    check_launched(h_got, "the sharded two-level tick")
    same_state(sharding.gather_state(hs, mesh8), ft.grid.MapState(
        **{f: h_out[f] for f in ft.grid.FIELDS}), "sharded two-level tick")
    same_stats(hstats, pipeline.UpdateStats(*h_stats[:4]),
               "sharded two-level tick")
    bit_equal(h_closest, h_out["closest_lazy"], "sharded two-level closest")
    kernels.reset_launch_counts()
    ws, wstats, w_ms = sharded_stream(wcfg, mesh8, batches)
    w_got = read_launches(STREAM_KERNELS)
    check_launched(w_got, "the sharded window tick")
    same_state(sharding.gather_state(ws, mesh8), w_state,
               "sharded window tick")
    same_stats(wstats, w_stats, "sharded window tick")
    for got in (h_got, w_got):
        launches.update(got)
        sharded_launches.update(got)
    out["two_level"] = dict(ms_per_tick=h_ms, launches=h_got)
    out["window"] = dict(ms_per_tick=w_ms, flat_ms_per_tick=w_flat_ms,
                         observed=w_stats.num_observed.tolist(),
                         launches=w_got)
    log(f"sharded two-level tick n = 8: {h_ms:.3f} ms/tick, bit-equal to "
        f"phase 8 (state, stats, closest), launches {h_got}; windowed tick "
        f"n = 8: {w_ms:.3f} ms/tick (single-device {w_flat_ms:.3f}), "
        f"bit-equal, launches {w_got}; on {card}")

    # the incremental update on phase 10's first insert tick (a voxel's
    # first hit stays under the occupancy threshold: the second tick)
    icfg = dataclasses.replace(cfg, esdf_mode="incremental").validate()
    state = ft.make_state(icfg, dev)
    for tick in range(ticks):
        s1 = pipeline.integrate_scan_batch(
            icfg, state, *(b[tick] for b in batches[:3]), batches[3][tick])
        fr = fusion.fuse_counts(icfg, s1.logodds, s1.seen, s1.hit_cnt,
                                s1.miss_cnt)
        if bool(fr.insert_mask.any()):
            break
        state, _ = pipeline.esdf_update(icfg, s1)
    d2_0, c_0 = s1.d2, s1.closest
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd2, sc, sit = esdf.update_esdf(d2_0, c_0, fr.occupied, fr.insert_mask,
                                    None, None, icfg.stencil)
    sit = int(sit)
    single_ms = (time.perf_counter() - t0) * 1e3
    assert kernels.LAUNCHES["relax"] == 1
    out["update"] = dict(tick=tick, sweeps=sit, single_device_ms=single_ms,
                         inserted=int(fr.insert_mask.sum()))
    for n in SHARDS:
        mesh = virtual_mesh(n, dev)
        lx = cfg.grid_shape[0] // n
        step = sharding.sharded_esdf_update(icfg, mesh)

        def slabs(x, axis=0):
            return [x.narrow(axis, i * lx, lx).contiguous()
                    for i in range(n)]

        args = (slabs(d2_0), slabs(c_0, 1), slabs(fr.occupied),
                slabs(fr.insert_mask))
        kernels.reset_launch_counts()
        syncs = sharding.COLLECTIVES["host_sync"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d2m, cm, itm = step(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        itm = int(itm)
        syncs = sharding.COLLECTIVES["host_sync"] - syncs
        relax_launches = kernels.LAUNCHES["relax"]
        bit_equal(torch.cat(d2m), sd2, f"sharded update d2 n = {n}")
        bit_equal(torch.cat(cm, 1), sc, f"sharded update closest n = {n}")
        assert itm == sit, (itm, sit)
        assert relax_launches == itm * n, (relax_launches, itm, n)
        assert syncs == itm
        launches["relax"] += relax_launches
        sharded_launches["relax"] += relax_launches
        by_name, counts, _ = profiled(lambda: step(*args), 1)
        # one sweep's read of the summed change flags, with the card idle
        flags = [torch.ones((), dtype=torch.int32, device=dev)] * n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            int(mesh.psum(flags)[0])
        sync_ms = (time.perf_counter() - t0) * 10
        out["update"][n] = dict(
            ms=ms, host_syncs=syncs, relax_launches=relax_launches,
            sync_ms=sync_ms, busy_ms=sum(by_name.values()),
            relax_device_ms=by_name.get("relax_sweeps", 0.0),
            cuda_launches=sum(counts.values()),
            copies_device_ms=copy_kernel_ms(by_name))
        log(f"sharded incremental update n = {n} (tick {tick}, "
            f"{out['update']['inserted']} inserts): {ms:.1f} ms a call, "
            f"{itm} sweeps (single-device relax kernel: {sit}, "
            f"{single_ms:.1f} ms a call), {relax_launches} relax launches "
            f"(one a sweep a shard), {syncs} host syncs a call (one a "
            f"sweep: the psum of the change flags, {sync_ms:.4f} ms each "
            f"with the card idle); {ms / itm:.3f} ms a sweep; busy "
            f"{out['update'][n]['busy_ms']:.1f} ms (relax "
            f"{out['update'][n]['relax_device_ms']:.1f}); copy kernels "
            f"{out['update'][n]['copies_device_ms']}; d2, closest and "
            f"sweeps bit-equal; on {card}")

    # the engines and the planner
    eng_frames = frames[:ENGINE_FRAMES]
    kernels.reset_launch_counts()
    sp = drive_synced(ShardedFiestaPipeline(cfg, mesh=mesh8,
                                            scans_per_tick=3),
                      eng_frames, 3)
    got = read_launches(STREAM_KERNELS)
    check_launched(got, "the sharded engine")
    launches.update(got)
    sharded_launches.update(got)
    same_state(sp.state, fused_groups(cfg, eng_frames, dev),
               "sharded engine")
    p0, goal = fly_start(cfg, dev)
    m = mpc.MPCConfig()
    dgrid = query.distance_grid(cfg, k_state.d2, k_state.seen)
    zeros = torch.zeros(3, device=dev)
    nominal = torch.zeros((m.horizon, 3), device=dev)
    single = mpc.plan_step(cfg, m, dgrid, p0, zeros, goal, nominal,
                           torch.Generator(device=dev).manual_seed(0))
    planner = mpc.make_sharded_planner(cfg, m, mesh8)
    sharded = planner(dgrid, p0, zeros, goal, nominal,
                      torch.Generator(device=dev).manual_seed(0))
    diff = max(float((sharded.controls - single.controls).abs().max()),
               float((sharded.positions - single.positions).abs().max()))
    rel = abs(float(sharded.cost) - float(single.cost)) / abs(
        float(single.cost))
    assert diff < PLAN_TOL and rel < PLAN_TOL, (diff, rel)
    plan_ms = time_ms(lambda: planner(
        dgrid, p0, zeros, goal, nominal,
        torch.Generator(device=dev).manual_seed(0)), calls=1, windows=3)
    out["planner"] = dict(max_abs_diff=diff, cost_rel_diff=rel,
                          ms=plan_ms, cost=float(sharded.cost))
    log(f"sharded engine n = 8 on phase 5's frames bit-equal to the fused "
        f"ticks on the same scan groups; sharded planner (MPCConfig(), "
        f"n = 8): {plan_ms:.3f} ms a solve, within {diff:.2e} (controls, "
        f"positions) and {rel:.2e} (cost, relative) of the single-device "
        f"solve from the same generator (gate {PLAN_TOL}); on {card}")

    wframes = world_frames(cfg, h, w)
    mesh2 = virtual_mesh(2, dev)
    kernels.reset_launch_counts()
    ssp = drive_synced(ShardedScrollingFiestaPipeline(
        cfg, mesh=mesh2, scans_per_tick=1, archive=True), wframes, 1)
    got = read_launches(STREAM_KERNELS)
    launches.update(got)
    sharded_launches.update(got)
    rsp = drive_synced(ScrollingFiestaPipeline(
        cfg, method="scanline", archive=True, device=dev), wframes, 1)
    same_state(ssp.state, rsp.state, "sharded scrolling engine")
    assert ssp.scroll_count == rsp.scroll_count >= 2
    assert ssp.restore_count == rsp.restore_count >= 1
    assert np.array_equal(ssp.origin_vox, rsp.origin_vox)
    assert sorted(ssp.archive.tiles) == sorted(rsp.archive.tiles)
    for key, tile in rsp.archive.tiles.items():
        for name in ("logodds", "seen"):
            assert np.array_equal(tile[name], ssp.archive.tiles[key][name])
    out["scrolling"] = dict(scrolls=ssp.scroll_count,
                            restores=ssp.restore_count,
                            tiles=ssp.archive.num_tiles)
    log(f"sharded scrolling engine n = 2 on phase 11's frames (a tick a "
        f"frame, the cadence on which both engines recenter alike): "
        f"{ssp.scroll_count} scrolls, {ssp.restore_count} restores, "
        f"{ssp.archive.num_tiles} tiles; states and tiles bit-equal to the "
        f"single-device scrolling engine's; on {card}")

    # the distributed transport: NCCL at world size 1
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    one_tick = run_stream(cfg, tuple(b[:1] for b in batches), dev)[0]
    with tempfile.TemporaryDirectory() as tmp:
        before = collections.Counter(sharding.COLLECTIVES)
        t0 = time.perf_counter()
        dmesh = sharding.distributed_mesh(init_method=f"file://{tmp}/store",
                                          world_size=1, rank=0)
        init_s = time.perf_counter() - t0
        try:
            backend = dist.get_backend()
            assert backend == "nccl", backend
            step = sharding.sharded_fused_tick(cfg, dmesh)
            res = []
            by_name, _, _ = profiled(lambda: res.append(step(
                sharding.shard_state(ft.make_state(cfg, dev), dmesh),
                *(b[0] for b in batches))), 1)
            dstate = sharding.gather_state(res[-1][0], dmesh)
        finally:
            dist.destroy_process_group()
    same_state(dstate, one_tick, "NCCL tick")
    coll = dict(sharding.COLLECTIVES - before)
    assert coll.get("nccl", 0) > 0, coll
    nccl_kernels = {k: round(v, 4) for k, v in by_name.items()
                    if "nccl" in k.lower()}
    out["nccl"] = dict(world_size=1, init_s=init_s, collectives=coll,
                       kernels=nccl_kernels)
    log(f"NCCL at world size 1 (file store): init {init_s:.2f} s, one tick "
        f"bit-equal to phase 2's first; collectives {coll}; NCCL kernels "
        f"(device ms) {nccl_kernels}; on {card}")

    # the app with --devices 1
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launch_counts()
        err, wall = run_app([
            "--preset", "cow_and_lady", "--platform", "cuda",
            "--update-every", "3", "--frames", str(SHARD_APP_FRAMES),
            "--devices", "1", "--checkpoint", f"{tmp}/k.npz",
            "--checkpoint-every", "3", "--viz-dir", f"{tmp}/viz",
            "--ground-truth-check", "--mpc"])
    got = read_launches(STREAM_KERNELS)
    check_launched(got, "the app with --devices 1")
    launches.update(got)
    sharded_launches.update(got)
    assert "sharded engine: 1-device X-slab mesh" in err
    report = json.loads(re.search(r"^\{\n.*?^\}$", err, re.S | re.M).group(0))
    assert report["count_under"] == 0, report
    cost = float(re.search(r"MPC: \d+ rollouts, cost (\S+),", err).group(1))
    assert np.isfinite(cost)
    out["app"] = dict(wall_s=wall, launches=got,
                      rms_error=report["rms_error"],
                      count_under=report["count_under"], mpc_cost=cost)
    log(f"app --devices 1 ({SHARD_APP_FRAMES} frames, phase 12's other "
        f"flags): {wall:.2f} s wall, oracle rms_error "
        f"{report['rms_error']:.6f}, count_under 0, MPC cost {cost:.2f}; "
        f"launches {got}; on {card}")

    # the kernels at the n = 8 slab shapes, the relax kernel's x origin and
    # the box add's out-of-slab corners among them
    lx = cfg.grid_shape[0] // 8
    pad = sharding._stencil_reach(icfg.stencil)
    x0 = (8 // 2 - 1) * lx
    d2g, cg, _ = esdf.apply_occupancy_changes(d2_0, c_0, fr.occupied,
                                              fr.insert_mask)
    ext_d2 = d2g[x0 - pad:x0 + lx + pad].contiguous()
    ext_c = cg[:, x0 - pad:x0 + lx + pad].contiguous()
    mask = torch.zeros(ext_d2.shape, dtype=torch.bool, device=dev)
    mask[pad:pad + lx] = True
    out["slab_rows"] = slab_rows(cfg, mesh8, batches, k_state, icfg,
                                 (ext_d2, ext_c, mask, x0 - pad), rows, card)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run(torch.device("cuda"), cow_config(), H, W, TICKS,
               demo_config(), DH, DW, DEMO_TICKS)


def run(dev, cfg, h, w, ticks, dcfg, dh, dw, dticks):
    """The phases on ``dev`` for ``cfg`` with ``ticks`` ticks of three
    h x w scans, and for the demo config ``dcfg`` with ``dticks`` ticks of
    three dh x dw depth images."""
    t_run = time.perf_counter()
    # -- phase 1: device and build ------------------------------------
    card = card_line()
    log(f"card: {card} ({torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda})")
    t0 = time.perf_counter()
    kernels.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(kernels.SOURCES)})")
    for src, text in sorted(kernels.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "smem" in line:
                log(f"  ptxas {src}: {line.strip()}")

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 2")
    # -- phase 2: the tick stream, kernels then plain --------------------
    t0 = time.perf_counter()
    _, frames = replay.make_sequence(
        cfg, n_frames=3 * ticks, n_boxes=20, seed=0, kind="cloud",
        height=h, width=w, period=12.0, orbit_radius=5.0)
    batches = replay.stage_update_batches(cfg, frames, device=dev)
    log(f"grid {cfg.grid_shape}, box {raycast._carve_box_shape(cfg)}, "
        f"{ticks} ticks x 3 scans x {h * w} rays staged in "
        f"{time.perf_counter() - t0:.1f} s")
    run_stream(cfg, tuple(b[:1] for b in batches), dev)      # warm-up

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    k_state, k_stats, k_ms = run_stream(cfg, batches, dev)
    stream_launches = read_launches(STREAM_KERNELS)
    log(f"stream (kernels): {k_ms:.3f} ms/tick on {card}; launches "
        f"{stream_launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    check_launched(stream_launches, "the main path")
    launches = collections.Counter(stream_launches)
    with plain_versions():
        p_state, p_stats, p_ms = run_stream(cfg, batches, dev)
    log(f"stream (plain PyTorch): {p_ms:.3f} ms/tick on {card}")
    for f in ft.grid.FIELDS:
        a, b = getattr(k_state, f), getattr(p_state, f)
        assert torch.equal(a, b), f"final state field {f} differs"
    for f, a, b in zip(k_stats._fields, k_stats, p_stats):
        assert torch.equal(a, b), f"UpdateStats.{f} differs"
    occupied = ft.occupied_grid(cfg, k_state.logodds)
    n_occ = int(occupied.sum())
    log(f"stream states bit-equal; occupied voxels {n_occ}; stats "
        f"{ {f: v.tolist() for f, v in zip(k_stats._fields, k_stats)} }")
    assert n_occ > MIN_OCCUPIED, f"scene mapped only {n_occ} occupied voxels"
    assert bool((k_state.d2 < ft.grid.INF_D2).any())

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 3")
    # -- phase 3: the closest/query path, kernels then plain ------------
    eager = tuple(b[:EAGER_TICKS] for b in batches)
    pos = query_positions(cfg, dev)
    kernels.reset_launch_counts()
    k_out = closest_path(cfg, k_state, eager, pos)
    closest_launches = read_launches(CLOSEST_KERNELS)
    log(f"closest path (kernels): launches {closest_launches}")
    check_launched(closest_launches, "the closest path")
    launches.update(closest_launches)
    with plain_versions():
        p_out = closest_path(cfg, k_state, eager, pos)
    for name in k_out:
        bit_equal(k_out[name], p_out[name], name)
    assert torch.equal(k_out["d2"], k_state.d2), "closest d2 != tick d2"
    assert torch.equal(k_out["eager_closest"], k_out["eager_lazy"]), \
        "eager closest differs from the lazy derivation"
    n_def = int((k_out["closest"] >= 0).sum())
    n_near = int((k_out["dist"] < cfg.infinity_distance).sum())
    log(f"closest path bit-equal: {n_def} voxels with a closest obstacle, "
        f"{n_near} of {QUERIES} queries with one")
    assert n_def > MIN_OCCUPIED and n_near > 0
    derive_ms = time_ms(lambda: pipeline.derive_closest(cfg, k_state.logodds))
    with plain_versions():
        derive_plain_ms = time_ms(
            lambda: pipeline.derive_closest(cfg, k_state.logodds),
            calls=1, windows=3)
    dist = query.distance_grid(cfg, k_state.d2, k_state.seen)
    query_ms = time_ms(lambda: (
        query.get_distance(cfg, dist, pos),
        query.get_dist_grad_trilinear(cfg, dist, pos),
        query.get_closest_obstacle(cfg, k_out["closest"], k_state.d2,
                                   k_state.seen, pos)))
    derive_kernels, derive_counts, _ = profiled(
        lambda: pipeline.derive_closest(cfg, k_state.logodds), 5)
    derive_busy = sum(derive_kernels.values())
    log(f"derive_closest: {derive_ms:.4f} ms (plain {derive_plain_ms:.3f} "
        f"ms); busy {derive_busy:.4f} ms in "
        f"{sum(derive_counts.values()):g} CUDA launches, device ms by kernel "
        f"{ {k: round(v, 4) for k, v in derive_kernels.items()} }; three "
        f"queries of {QUERIES} positions: {query_ms:.4f} ms; on {card}")

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 4")
    # -- phase 4: the sorted splat -----------------------------------------
    kernels.reset_launch_counts()
    with sorted_splat():
        s_state, s_stats, s_ms = run_stream(cfg, batches, dev)
    sort_launches = read_launches(("sort",) + STREAM_KERNELS)
    log(f"sorted-splat stream (kernels): {s_ms:.3f} ms/tick; launches "
        f"{sort_launches}")
    check_launched(sort_launches, "the sorted-splat stream")
    for f in ft.grid.FIELDS:
        bit_equal(getattr(s_state, f), getattr(k_state, f),
                  f"sorted-splat state {f} (against the direct splat)")
    for f, a, b in zip(k_stats._fields, s_stats, k_stats):
        assert torch.equal(a, b), f"sorted-splat UpdateStats.{f} differs"
    log("sorted-splat stream bit-equal to the direct splat's")
    launches.update(sort_launches)

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 5")
    # -- phase 5: the app engine ------------------------------------------
    eng_frames = frames[:ENGINE_FRAMES]
    kernels.reset_launch_counts()
    k_pipe, k_eng, frame_ms, update_ms = run_engine(
        cfg, eng_frames, "scanline", dev, pos, no_sync=True)
    engine_kernels = STREAM_KERNELS + CLOSEST_KERNELS
    engine_launches = read_launches(engine_kernels)
    log(f"engine (kernels, scanline): {frame_ms:.3f} ms per process() "
        f"frame, {update_ms:.3f} ms per update(), neither waiting for the "
        f"device, on {card}; launches {engine_launches}")
    check_launched(engine_launches, "the app engine")
    launches.update(engine_launches)
    with plain_versions():
        _, p_eng, p_frame_ms, p_update_ms = run_engine(
            cfg, eng_frames, "scanline", dev, pos)
    for name in k_eng:
        bit_equal(k_eng[name], p_eng[name], f"engine {name}")
    n_eng = int(k_pipe.occupied().sum())
    log(f"engine bit-equal to plain ({p_frame_ms:.3f} ms per frame, "
        f"{p_update_ms:.3f} ms per update plain); occupied {n_eng}; "
        f"{k_pipe.esdf_cnt} updates")
    assert n_eng > MIN_OCCUPIED, f"engine mapped only {n_eng} voxels"
    other = {}
    for method in ("dda", "projective"):
        o_pipe, _, o_ms, o_up = run_engine(cfg, frames[:OTHER_FRAMES],
                                           method, dev)
        n_o = int(o_pipe.occupied().sum())
        other[method] = dict(frame_ms=o_ms, update_ms=o_up, occupied=n_o)
        log(f"engine ({method}, plain PyTorch): {o_ms:.3f} ms per frame, "
            f"{o_up:.3f} ms per update; occupied {n_o}; on {card}")
        assert n_o > 0, f"the {method} engine mapped nothing"

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 6")
    # -- phase 6: the demo preset's windowed depth tick -------------------
    t0 = time.perf_counter()
    dbatches = demo_batches(dcfg, dh, dw, dticks, dev)
    log(f"demo grid {dcfg.grid_shape}, box {raycast._carve_box_shape(dcfg)}"
        f", window radius {dcfg.radius}, {dticks} ticks x 3 depth images of "
        f"{dh}x{dw} staged in {time.perf_counter() - t0:.1f} s")
    run_demo(dcfg, tuple(b[:1] for b in dbatches), dev)        # warm-up
    kernels.reset_launch_counts()
    d_state, d_stats, d_ms = run_demo(dcfg, dbatches, dev)
    demo_launches = read_launches(STREAM_KERNELS)
    log(f"demo stream (kernels): {d_ms:.3f} ms/tick on {card}; launches "
        f"{demo_launches}")
    check_launched(demo_launches, "the demo depth stream")
    launches.update(demo_launches)
    with plain_versions():
        pd_state, pd_stats, pd_ms = run_demo(dcfg, dbatches, dev)
    for f in ft.grid.FIELDS:
        bit_equal(getattr(d_state, f), getattr(pd_state, f), f"demo {f}")
    for f, a, b in zip(d_stats._fields, d_stats, pd_stats):
        assert torch.equal(a, b), f"demo UpdateStats.{f} differs"
    n_demo = int(ft.occupied_grid(dcfg, d_state.logodds).sum())
    log(f"demo stream bit-equal to plain ({pd_ms:.3f} ms/tick plain); "
        f"occupied {n_demo}; stats "
        f"{ {f: v.tolist() for f, v in zip(d_stats._fields, d_stats)} }")
    assert n_demo >= DEMO_MIN_OCCUPIED, f"demo mapped only {n_demo} voxels"

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 7")
    # -- phase 7: each kernel against its plain version ------------------
    rows = []
    pts, vals, tfs, _ = (b[0] for b in batches)
    starts, po, lin, val, _ = raycast._scanline_splat_prep(
        cfg, pts, vals, transforms=tfs)
    box = raycast._carve_box_shape(cfg)
    n = 3 * box[0] * box[1] * box[2]
    thr = raycast._epfree_threshold(cfg)
    got = kernels.splat(lin, val, n, thr)
    ref = raycast._splat_packed_plain(lin, val, n, thr)
    idx = torch.clamp(lin, max=n).long()
    splat_kernels, splat_counts, _ = profiled(
        lambda: kernels.splat(lin, val, n, thr), 10)
    library = kernel_times(lambda: torch.zeros(
        n + 1, device=dev).scatter_reduce_(0, idx, val, "amax"))
    rows.append(dict(
        name="splat", source="fiesta_tpu_torch/kernels/splat.cu",
        replaces="fiesta_tpu/ops/pallas/fill.py:39, "
                 "fiesta_tpu/ops/pallas/fill.py:66",
        err=max_abs_err(got, ref),
        **kernel_times(lambda: kernels.splat(lin, val, n, thr)),
        plain_ms=time_ms(lambda: raycast._splat_packed_plain(
            lin, val, n, thr)),
        library_ms=library["ms"], library_device_ms=library["device_ms"],
        cuda_launches=sum(splat_counts.values()), by_kernel=splat_kernels,
        bound=in_ms(bound_s(lin.numel() * 8 + n * 6, 0, F32_OPS_PER_S))))
    # its zero fill of the f32 target (fill.py:39): the card's time by
    # kernel name, beside torch.zeros of the same bytes on the card alone,
    # which is also its plain version (timed once, in both columns); the
    # splat row's equality covers its output
    zeros_ms = kernel_times(lambda: torch.zeros(n, device=dev))["device_ms"]
    rows.append(dict(
        name="splat_fill", counted_as="splat",
        source="fiesta_tpu_torch/kernels/splat.cu",
        replaces="fiesta_tpu/ops/pallas/fill.py:39", err=rows[-1]["err"],
        ms=splat_kernels["splat_fill"], device_ms=splat_kernels["splat_fill"],
        plain_ms=zeros_ms, library_ms=zeros_ms,
        bound=in_ms(bound_s(4 * n, 0, F32_OPS_PER_S))))

    # the sorted splat's sort on the same rays: keys and values bit-equal
    ksorted = kernels.sort_pairs(lin, val)
    psorted = sort._sort_pairs_plain(lin, val)
    err = max_abs_err([ksorted[0], ksorted[1].view(torch.int32)],
                      [psorted[0], psorted[1].view(torch.int32)])
    n_rays = lin.numel()
    sort_kernels, sort_counts, _ = profiled(
        lambda: kernels.sort_pairs(lin, val), 10)
    library = kernel_times(lambda: val[torch.sort(lin)[1]])
    rows.append(dict(
        name="sort", source="fiesta_tpu_torch/kernels/sort.cu",
        replaces="fiesta_tpu/ops/pallas/sort.py:54", err=err,
        **kernel_times(lambda: kernels.sort_pairs(lin, val)),
        plain_ms=time_ms(lambda: sort._sort_pairs_plain(lin, val),
                         calls=1, windows=3),
        library_ms=library["ms"], library_device_ms=library["device_ms"],
        cuda_launches=sum(sort_counts.values()), by_kernel=sort_kernels,
        # 8 bytes per pair in and out; the cheapest exact method is a radix
        # sort of the keys (below 2^24 here): 3 passes of ~10 integer
        # operations per pair
        bound=in_ms(bound_s(16 * n_rays, 30 * n_rays, I32_OPS_PER_S))))
    log(f"sort: {n_rays} pairs padded to "
        f"{kernels.sort_padded_size(n_rays)}, keys and values bit-equal")
    seeds = got[0].view((3,) + box)
    carve = (cfg.resolution, cfg.min_ray_length, cfg.max_ray_length)
    kfree = kernels.carve(seeds, po, *carve)
    pfree = raycast._carve_free_plain(cfg, seeds, po)
    carve_kernels, carve_counts, _ = profiled(
        lambda: kernels.carve(seeds, po, *carve), 10)
    rows.append(dict(
        name="carve", source="fiesta_tpu_torch/kernels/carve.cu",
        replaces="fiesta_tpu/ops/pallas/carve.py:76",
        err=max_abs_err([kfree], [pfree]),
        **kernel_times(lambda: kernels.carve(seeds, po, *carve)),
        plain_ms=time_ms(lambda: raycast._carve_free_plain(cfg, seeds, po),
                         calls=1, windows=3),
        library_ms=None, cuda_launches=sum(carve_counts.values()),
        by_kernel=carve_kernels, bound=in_ms(carve_bound_s(3, box))))
    steps = carve_steps(po, box)
    steps["cluster_size"] = kernels.carve_cluster_size(seeds.shape)
    log(f"carve: {int(kfree.sum())} free voxels of {n}; wavefront steps "
        f"and cluster size {steps}")
    # the same at the demo box, on the demo's first tick of depth frames
    dseeds, dpo = demo_seeds(dcfg, dbatches)
    dcarve = (dcfg.resolution, dcfg.min_ray_length, dcfg.max_ray_length)
    dn = dseeds.numel()
    carve_demo = dict(
        box=list(dseeds.shape), steps=carve_steps(dpo, dseeds.shape[1:]),
        err=max_abs_err([kernels.carve(dseeds, dpo, *dcarve)],
                        [raycast._carve_free_plain(dcfg, dseeds, dpo)]),
        **kernel_times(lambda: kernels.carve(dseeds, dpo, *dcarve)),
        bound_ms=in_ms(carve_bound_s(dseeds.shape[0], dseeds.shape[1:]))[0])
    log(f"carve at the demo box {carve_demo['box']}: "
        f"{carve_demo['ms']:.4f} ms host-paced, {carve_demo['device_ms']:.4f}"
        f" on the card alone (bound {carve_demo['bound_ms']:.4f} ms), "
        f"bit-equal; wavefront steps {carve_demo['steps']}; on {card}")
    depth_demo = depth_row(dev, card)
    prep_ticks = prep_row(dev, card)

    # the drain and the box add on one more tick of counters
    ticked = pipeline.integrate_scan_batch(cfg, ft.copy_state(k_state),
                                           pts, vals, tfs)
    on, eq = ((cfg.min_occupancy_log, False) if cfg.probabilistic
              else (1.0, True))
    kw = dict(l_hit=cfg.prob_hit_log, l_miss=cfg.prob_miss_log,
              clamp_min=cfg.clamp_min_log, clamp_max=cfg.clamp_max_log,
              occ_thresh=on, occ_is_eq=eq)
    fin = (ticked.logodds, ticked.seen, ticked.hit_cnt, ticked.miss_cnt)
    nvox = ticked.logodds.numel()
    rows.append(dict(
        name="fuse", source="fiesta_tpu_torch/kernels/fuse.cu",
        replaces="fiesta_tpu/ops/pallas/fuse.py:72",
        err=max_abs_err(kernels.fuse(*fin, **kw),
                        fusion._fuse_drain_plain(*fin, **kw)),
        **kernel_times(lambda: kernels.fuse(*fin, **kw)),
        plain_ms=time_ms(lambda: fusion._fuse_drain_plain(*fin, **kw)),
        library_ms=None,
        # 15 bytes per voxel; ~8 f32 operations (add, clamp, selects, two
        # threshold tests)
        bound=in_ms(bound_s(15 * nvox, 8 * nvox, F32_OPS_PER_S))))

    # the windowed drain at the demo's shapes, on its final map with a
    # tick's worth of counters, windowed around its last position
    g = torch.Generator(device=dev).manual_seed(0)
    dfin = (d_state.logodds, d_state.seen,
            torch.randint(0, 2, dcfg.grid_shape, generator=g, device=dev,
                          dtype=torch.uint8),
            torch.randint(0, 3, dcfg.grid_shape, generator=g, device=dev,
                          dtype=torch.uint8))
    dwin = ft.grid.local_window(dcfg, dbatches[2][-1])
    don, deq = ((dcfg.min_occupancy_log, False) if dcfg.probabilistic
                else (1.0, True))
    dkw = dict(l_hit=dcfg.prob_hit_log, l_miss=dcfg.prob_miss_log,
               clamp_min=dcfg.clamp_min_log, clamp_max=dcfg.clamp_max_log,
               occ_thresh=don, occ_is_eq=deq, window=dwin)
    dvox = d_state.logodds.numel()
    fuse_kernels, fuse_counts, _ = profiled(
        lambda: kernels.fuse(*dfin, **dkw), 10)
    fuse_window = dict(
        err=max_abs_err(kernels.fuse(*dfin, **dkw),
                        fusion._fuse_drain_plain(*dfin, **dkw)),
        **kernel_times(lambda: kernels.fuse(*dfin, **dkw)),
        plain_ms=time_ms(lambda: fusion._fuse_drain_plain(*dfin, **dkw)),
        # 15 bytes per voxel; ~8 f32 operations and ~14 integer ones (the
        # voxel's coordinates and six compares) per voxel
        bound_ms=max(15 * dvox / HBM_BYTES_PER_S,
                     8 * dvox / F32_OPS_PER_S + 14 * dvox / I32_OPS_PER_S)
        * 1e3,
        launches=demo_launches["fuse"],
        cuda_launches=sum(fuse_counts.values()), by_kernel=fuse_kernels)
    log(f"fuse (windowed, demo {dcfg.grid_shape}, window "
        f"{[w.tolist() for w in dwin]}): {fuse_window['ms']:.4f} ms "
        f"host-paced, {fuse_window['device_ms']:.4f} on the card alone, "
        f"{fuse_window['host_ms']:.4f} to enqueue on the host (plain "
        f"{fuse_window['plain_ms']:.4f}, bound "
        f"{fuse_window['bound_ms']:.4f} ms by bytes), bit-equal; "
        f"{fuse_window['launches']} launches on the demo stream, "
        f"{fuse_window['cuda_launches']:g} CUDA launches per call, device "
        f"ms by kernel { {k: round(v, 4) for k, v in fuse_kernels.items()} }"
        f"; on {card}")

    starts, hitc, missc, _, _ = raycast.scanline_batch_boxes(cfg, pts, vals,
                                                             tfs)
    bargs = (starts, hitc, missc)
    grids = (k_state.hit_cnt, k_state.miss_cnt)
    got = kernels.boxadd(*(g.clone() for g in grids), *bargs)
    ref = raycast._apply_box_counts_plain(*(g.clone() for g in grids),
                                          *bargs)
    # in place on a scratch pair: repeated adds saturate, same work
    scratch = tuple(g.clone() for g in grids)
    union = box_union(starts, hitc.shape[1:], grids[0].shape)
    log(f"boxadd: {hitc.shape[0]} boxes of {hitc[0].numel()} voxels at "
        f"{starts.tolist()}, union {union} voxels")
    box_kernels, box_counts, _ = profiled(
        lambda: kernels.boxadd(*scratch, *bargs), 10)
    rows.append(dict(
        name="boxadd", source="fiesta_tpu_torch/kernels/boxadd.cu",
        replaces="fiesta_tpu/ops/pallas/boxadd.py:101",
        err=max_abs_err(got, ref),
        **kernel_times(lambda: kernels.boxadd(*scratch, *bargs)),
        plain_ms=time_ms(lambda: raycast._apply_box_counts_plain(
            *scratch, *bargs)),
        library_ms=None,
        # the boxes' hit and miss bytes read once, and each grid voxel of
        # the boxes' union read and written once in each counter
        bound=in_ms(bound_s(2 * hitc.numel() + 4 * union, 2 * hitc.numel(),
                            I32_OPS_PER_S)),
        cuda_launches=sum(box_counts.values()), by_kernel=box_kernels))

    t = edt.trunc_vox_for(cfg.resolution, cfg.trunc_dist)
    f = torch.full(occupied.shape, edt._INF_EDT, dtype=torch.int32,
                   device=dev).masked_fill_(occupied, 0)
    p1 = kernels.edt_binary(f, t)
    err = max_abs_err([p1], [edt._binary_pass_plain(f, t)])
    err = max(err, max_abs_err([kernels.edt_binary(f, t, square=False)],
                               [edt._binary_pass_plain(f, t, False)]))
    nvox = f.numel()
    binary_kernels, binary_counts, _ = profiled(
        lambda: kernels.edt_binary(f, t), 10)
    rows.append(dict(
        name="edt_binary", source="fiesta_tpu_torch/kernels/edt.cu",
        replaces="fiesta_tpu/ops/pallas/edt.py:195", err=err,
        **kernel_times(lambda: kernels.edt_binary(f, t)),
        plain_ms=time_ms(lambda: edt._binary_pass_plain(f, t)),
        library_ms=None,
        bound=in_ms(bound_s(nvox * 8, 4 * nvox, I32_OPS_PER_S)),
        cuda_launches=sum(binary_counts.values()), by_kernel=binary_kernels))

    # the main path runs the min-plus pass along axis 1, then axis 2; the
    # row reports the mean over the two launches of a tick
    p2 = kernels.edt_minplus(p1, t, 1)
    err, times, plain_ms, bounds, taps, profs = 0.0, [], [], [], [], []
    for axis, x in ((1, p1), (2, p2)):
        err = max(err, max_abs_err([kernels.edt_minplus(x, t, axis)],
                                   [edt._minplus_pass_plain(x, t, axis)]))
        times.append(kernel_times(lambda: kernels.edt_minplus(x, t, axis)))
        profs.append(profiled(lambda: kernels.edt_minplus(x, t, axis), 10))
        plain_ms.append(time_ms(lambda: edt._minplus_pass_plain(x, t, axis),
                                calls=1, windows=3))
        # the cheapest exact pass is O(A) per column: the lower envelope
        # where the window covers the column (axis 2: A = 80 <= t), and a
        # min-plus convolution with the convex kernel k^2 (|k| <= t, SMAWK)
        # where it does not (axis 1); only columns holding a value below
        # "far" need it, where the cell's roofline.edt_bound_s counts
        # every column (both are bytes-bound)
        near_cols = int((x < edt._INF_EDT).any(dim=axis).sum())
        ops = ENVELOPE_OPS * near_cols * x.shape[axis]
        bounds.append(in_ms(bound_s(nvox * 8, ops, I32_OPS_PER_S)))
        taps.append(minplus_taps(x, t, axis))
    by_kernel = collections.Counter()
    for by_name, _, _ in profs:
        by_kernel.update({k: v / 2 for k, v in by_name.items()})
    rows.append(dict(
        name="edt_minplus", source="fiesta_tpu_torch/kernels/edt.cu",
        replaces="fiesta_tpu/ops/pallas/edt.py:105", err=err,
        **{k: statistics.mean(tm[k] for tm in times) for k in times[0]},
        plain_ms=statistics.mean(plain_ms),
        library_ms=None, bound=(statistics.mean(b for b, _ in bounds),
                                max(bounds)[1]),
        cuda_launches=statistics.mean(sum(c.values()) for _, c, _ in profs),
        by_kernel=dict(by_kernel)))
    log(f"edt_minplus per axis (1, 2): {times[0]['ms']:.4f} / "
        f"{times[1]['ms']:.4f} ms host-paced, "
        f"{times[0]['device_ms']:.4f} / {times[1]['device_ms']:.4f} on the "
        f"card alone; plain {plain_ms[0]:.3f} / {plain_ms[1]:.3f} ms, "
        f"bounds {bounds}; window offsets per voxel {taps}; on {card}")

    rows.extend(closest_rows(cfg, occupied))
    binary = next(r for r in rows if r["name"] == "closest_binary")
    log(f"closest_binary: {binary['tiles']['with_seed']} of "
        f"{binary['tiles']['tiles']} column tiles of "
        f"{binary['tiles']['tile_cols']} hold a seed")
    split = next(r for r in rows if r["name"] == "closest_split")
    log(f"closest_split window offsets per voxel: side n "
        f"{split['taps']['n']}, side p {split['taps']['p']}; the "
        f"brute-force window {split['taps']['brute_mean_taps']:.2f} a side;"
        f" {split['far_device_ms']:.4f} ms on the card alone with every "
        f"value at cap")
    window = next(r for r in rows if r["name"] == "closest_window")
    wtaps = dict(window["taps"])
    brute = wtaps.pop("brute_mean_taps")
    log(f"closest_window window offsets per voxel, both sides: {wtaps}; "
        f"the brute-force window {brute:.2f} (a pair of loads each); "
        f"{window['far_device_ms']:.4f} ms on the card alone with every "
        f"value at cap")

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 8")
    # -- phase 8: the two-level (hierarchical) cow tick -------------------
    hcfg = dataclasses.replace(cfg, edt_fine_dist=HIER_FINE_DIST).validate()
    t_fine, t_total = pipeline._levels(hcfg)
    t_coarse = -(-t_total // 2)
    coarse_shape = tuple(g // 2 for g in cfg.grid_shape)
    log(f"two-level EDT: fine {cfg.grid_shape} at t = {t_fine}, coarse "
        f"{coarse_shape} at t = {t_coarse}")
    run_stream(hcfg, tuple(b[:1] for b in batches), dev)      # warm-up
    kernels.reset_launch_counts()
    with launches_by_level(cfg.grid_shape) as by_level:
        h_out, h_stats, h_ms = hier_path(hcfg, batches, eager, dev)
    hier_launches = read_launches(HIER_KERNELS)
    log(f"two-level tick (kernels): {h_ms:.3f} ms/tick; launches "
        f"{hier_launches}; by level {dict(sorted(by_level.items()))}")
    check_launched(hier_launches, "the two-level tick")
    for name in HIER_KERNELS:
        for level in ("fine", "coarse"):
            assert by_level[f"{name}:{level}"] > 0, \
                f"kernel {name} did not launch at the {level} level"
    launches.update(hier_launches)
    with plain_versions():
        hp_out, hp_stats, hp_ms = hier_path(hcfg, batches, eager, dev)
    for name in h_out:
        bit_equal(h_out[name], hp_out[name], f"two-level {name}")
    for a, b in zip(h_stats, hp_stats):
        assert torch.equal(a, b), "two-level UpdateStats differ"
    assert torch.equal(h_out["eager_closest"], h_out["eager_lazy"]), \
        "two-level eager closest differs from the lazy derivation"
    assert torch.equal(h_out["logodds"], k_state.logodds)
    differ = h_out["d2"] != k_state.d2
    near = k_state.d2 <= t_fine * t_fine
    hier_d2 = dict(differ=int(differ.sum()),
                   differ_within_fine=int((differ & near).sum()),
                   within_fine=int(near.sum()),
                   finite=int((h_out["d2"] < ft.grid.INF_D2).sum()),
                   finite_flat=int((k_state.d2 < ft.grid.INF_D2).sum()))
    assert hier_d2["differ_within_fine"] == 0, hier_d2
    # flat and two-level ticks in turns (flat, two-level, two-level, flat)
    turns = [run_stream(c, batches, dev)[2] for c in (cfg, hcfg, hcfg, cfg)]
    busy = dict(flat=busy_ms_per_tick(cfg, batches, dev),
                two_level=busy_ms_per_tick(hcfg, batches, dev))
    occ_c = edt.downsample2_any(occupied)
    coarse_rows = level_rows(occ_c, t_coarse)
    hier = dict(ms_per_tick=h_ms, plain_ms_per_tick=hp_ms,
                turns_flat_two_level=turns, busy_ms_per_tick=busy,
                launches=hier_launches, by_level=dict(by_level), d2=hier_d2,
                coarse_shape=list(coarse_shape), t_fine=t_fine,
                t_coarse=t_coarse, coarse_kernels=coarse_rows)
    log(f"two-level tick bit-equal to plain ({hp_ms:.3f} ms/tick plain); "
        f"ms/tick flat, two-level, two-level, flat: "
        f"{[round(x, 3) for x in turns]} (phase 2's flat {k_ms:.3f}); "
        f"device busy per tick {busy}; d2 against phase 2's exact d2 "
        f"{hier_d2}; on {card}")
    for name, r in coarse_rows.items():
        log(f"{name} at the coarse level {coarse_shape}, t = {t_coarse}: "
            f"{r['ms']:.4f} ms host-paced, {r['device_ms']:.4f} on the card "
            f"alone (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
            f"ms by {r['bound_by']}), bit-equal; on {card}")

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 15")
    # -- phase 15: the wide closest path (800x800x80) ------------------------
    wide = wide_path(cfg, batches, eager, dev, card, rows, launches)

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 9")
    # -- phase 9: the planner on phase 2's final map ----------------------
    planner = run_planner(cfg, k_state, dev)
    log(f"planner (MPCConfig(): {mpc.MPCConfig().n_rollouts} rollouts, "
        f"horizon {mpc.MPCConfig().horizon}): {planner['plan_ms']:.3f} ms "
        f"per plan_step, {planner['fly_step_ms']:.3f} ms per fly step "
        f"({planner['fly_steps']} steps from {planner['fly_start']} toward "
        f"{planner['goal']}, ending at {planner['fly_end']}, map clearance "
        f"{planner['fly_clearance_m']:.3f} m); a solve: {planner['solve']}; "
        f"costs {planner['costs']}; "
        f"card vs CPU from the same draws {planner['card_vs_cpu']}; "
        f"through a mapped obstacle {planner['crossing']}; "
        f"on {card}")

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 10")
    # -- phase 10: the incremental cow stream ------------------------------
    incr, relax = incremental_path(cfg, batches, k_state, frames, dev, card,
                                   rows, launches)

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 14")
    # -- phase 14: the multi-device engine on virtual meshes of the card ---
    # (before phases 11-13, for the profiler: see the module docstring)
    sharded_launches = collections.Counter()
    sharded = sharded_path(cfg, h, w, batches, k_state, k_stats, k_ms,
                           k_out["closest"], hcfg, h_out, h_stats, frames,
                           dev, card, rows, launches, sharded_launches)

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 11")
    # -- phase 11: the unbounded world -------------------------------------
    world = unbounded_world(cfg, h, w, dev, card, launches)

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 12")
    # -- phase 12: the app at cow_and_lady --------------------------------
    app = app_path(card, launches)

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 13")
    # -- phase 13: the soak drill at cow scale ------------------------------
    soak = soak_path(card)

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 16")
    # -- phase 16: the benchmark twins ---------------------------------------
    twins_path(card)

    log(f"[{time.perf_counter() - t_run:.0f} s] phase 17")
    # -- phase 17: the per-kernel JSON line --------------------------------

    for r in rows:
        if "cuda_launches" not in r:
            continue
        log(f"{r['name']}: {r['cuda_launches']:g} CUDA launches per call; "
            f"{r['ms']:.4f} ms host-paced, "
            f"{r['device_ms']:.4f} ms on the card alone, {r['host_ms']:.4f} "
            f"ms to enqueue on the host; library "
            f"{r.get('library_ms')}, on the card alone "
            f"{r.get('library_device_ms')}; device ms by kernel "
            f"{ {k: round(v, 4) for k, v in r['by_kernel'].items()} }"
            f"; on {card}")

    out = []
    for r in rows:
        calls = launches[r.get("counted_as", r["name"])]
        log(f"{r['name']}: {r['ms']:.4f} ms/launch (on the card alone "
            f"{r['device_ms']:.4f}; plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']}, bound {r['bound'][0]:.4f} ms by "
            f"{r['bound'][1]}), {calls} launches, max abs err "
            f"{r['err']} on {card}")
        out.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": calls,
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
            "sharded_launches": sharded_launches[r.get("counted_as",
                                                       r["name"])],
            "slab_ms": sharded["slab_rows"].get(r["name"], {}).get("ms"),
            **({"dense_bound_ms": r["dense_bound"][0],
                "dense_bound_by": r["dense_bound"][1]}
               if "dense_bound" in r else {})})
    print(json.dumps({"kernels": out,
                      "device_ms": {r["name"]: r["device_ms"] for r in rows},
                      "host_ms": {r["name"]: r["host_ms"] for r in rows
                                  if "host_ms" in r},
                      "library_device_ms": {
                          r["name"]: r["library_device_ms"]
                          for r in rows if "library_device_ms" in r},
                      "cuda_launches_per_call": {
                          r["name"]: r["cuda_launches"]
                          for r in rows if "cuda_launches" in r},
                      "by_kernel_ms": {r["name"]: r["by_kernel"]
                                       for r in rows if "by_kernel" in r},
                      "ms_per_tick": k_ms,
                      "plain_ms_per_tick": p_ms, "ticks": ticks,
                      "sorted_ms_per_tick": s_ms,
                      "derive_closest_ms": derive_ms,
                      "derive_closest_plain_ms": derive_plain_ms,
                      "derive_closest_busy_ms": derive_busy,
                      "derive_closest_by_kernel": derive_kernels,
                      "query_ms": query_ms,
                      "engine_frame_ms": frame_ms,
                      "engine_update_ms": update_ms,
                      "engine_plain_frame_ms": p_frame_ms,
                      "engine_plain_update_ms": p_update_ms,
                      "engine_other": other,
                      "demo_ms_per_tick": d_ms,
                      "demo_plain_ms_per_tick": pd_ms,
                      "demo_occupied": n_demo,
                      "fuse_window_demo": fuse_window,
                      "carve_steps": steps, "carve_demo": carve_demo,
                      "depth_demo": depth_demo, "prep": prep_ticks,
                      "minplus_taps": taps, "split_taps": split["taps"],
                      "window_taps": window["taps"],
                      "far_device_ms": {r["name"]: r["far_device_ms"]
                                        for r in rows
                                        if "far_device_ms" in r},
                      "closest_binary_tiles": binary["tiles"],
                      "two_level": hier, "planner": planner,
                      "incremental": incr, "relax": relax,
                      "unbounded_world": world, "app": app, "soak": soak,
                      "sharded": sharded, "wide_closest": wide}))
    log(f"[{time.perf_counter() - t_run:.0f} s] phases done")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
