"""What the benchmark scripts (``bench*_torch.py`` at the repository's
root) share: the device they run on, the line that names it, their timer,
their configs and the one JSON line each prints.

Each script runs on the card unless given ``--platform cpu``, and without
a card it refuses to start rather than fall back to the CPU.  Times come
from CUDA events around the work on the card and from the host clock on
the CPU; the JSON line names the card (``nvidia-smi``'s name and power
limit) or the host CPU's model.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import platform
import subprocess
import sys
import time

import numpy as np
import torch

from .config import COW_AND_LADY, DEMO_ONBOARD, FiestaConfig
from .grid import make_state
from .io import replay
from .ops import fusion
from .pipeline import integrate_scan_batch


def log(*a) -> None:
    """Diagnostics go to stderr; stdout carries only the JSON line."""
    print(*a, file=sys.stderr, flush=True)


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                    help="the card (default), or the CPU, where every "
                         "kernel is replaced by its plain PyTorch version")
    return ap


def device(platform_name: str, script: str) -> torch.device:
    """The run's device; refuses (SystemExit) CUDA without a card."""
    if platform_name == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"no CUDA device available: {script} runs on the card by "
            "default; pass --platform cpu to run the plain PyTorch versions "
            "on the CPU")
    if platform_name == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return torch.device(platform_name)


def cpu_model() -> str:
    """The host CPU's model name from ``/proc/cpuinfo``; where the host
    does not report one (or reports it as "unknown"), its vendor, family
    and model numbers there, else its architecture."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                info.setdefault(key.strip(), val.strip())
    except OSError:
        pass
    name = info.get("model name", "")
    if name and name.lower() != "unknown":
        return name
    if "vendor_id" in info:
        return (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')} (model name not reported)")
    return f"{platform.machine()} (model name not reported)"


def describe(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    host CPU's model."""
    if dev.type == "cuda":
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    return f"cpu: {cpu_model()}"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev: torch.device):
    """(fn(), its milliseconds): CUDA events around it on the card (after
    a synchronise, so that only its own work is in the window), the host
    clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def emit(line: dict) -> None:
    """The script's one line on stdout."""
    print(json.dumps(line), flush=True)


def scan_config(base: FiestaConfig, h: int, w: int) -> FiestaConfig:
    """``base`` with its intrinsics scaled to h x w scans of h * w points,
    as the JAX benchmarks size their configs."""
    return dataclasses.replace(replay.scale_intrinsics(base, h, w),
                               max_points_per_scan=h * w).validate()


def cow_config(h: int = 192, w: int = 256) -> FiestaConfig:
    """cow_and_lady at 0.05 m (400x400x80 voxels), 192x256 scans."""
    return scan_config(COW_AND_LADY, h, w)


def demo_config(h: int = 120, w: int = 160) -> FiestaConfig:
    """``launch/demo.launch``: 400x400x36 voxels at 0.1 m, local-window
    updates, 120x160 depth images."""
    return scan_config(DEMO_ONBOARD, h, w)


def replay_frames(cfg: FiestaConfig, n_frames: int, h: int, w: int,
               kind: str = "cloud", n_boxes: int = 20, seed: int = 0,
               orbit_radius: float = 5.0):
    """The benchmarks' replay: ``n_frames`` frames at 30 Hz orbiting the
    box world of ``seed`` (``bench.py:136-139``)."""
    _, frames = replay.make_sequence(
        cfg, n_frames=n_frames, n_boxes=n_boxes, seed=seed, kind=kind,
        height=h, width=w, period=12.0, orbit_radius=orbit_radius)
    return frames


def stage_depth_ticks(frames, dev: torch.device):
    """Depth frames grouped into ticks of three (``bench_demo.py:53-59``):
    depths [N,3,H,W], camera-to-world transforms [N,3,4,4] and the tick's
    positions [N,3] (its last frame's), f32 on ``dev``."""
    n = len(frames) // 3
    h, w = frames[0][2].shape
    depths = np.stack([f[2] for f in frames[:n * 3]]).reshape(n, 3, h, w)
    tfs = np.stack([replay.pose_to_matrix(*f[1]) for f in frames[:n * 3]]
                   ).reshape(n, 3, 4, 4)
    poss = np.stack([frames[i * 3 + 2][1][0] for i in range(n)])
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                 for a in (depths, tfs, poss))


def occupancy_flips(cfg: FiestaConfig, frames, dev: torch.device):
    """The occupancy flips the reference's UpdateOccupancy hands its
    UpdateESDF (``bench_reference_cpu.py:78-105``): ``frames`` in ticks of
    three through the port's ``integrate_scan_batch`` (global) and
    ``fusion.fuse_counts`` on ``dev``.  Yields, a tick, (voxels [N,3] i32,
    flags [N] u8: 1 inserted, 0 deleted, the state after the tick)."""
    pts, vals, tfs, pos = replay.stage_update_batches(cfg, frames,
                                                      device=dev)
    state = make_state(cfg, dev)
    for i in range(pts.shape[0]):
        state = integrate_scan_batch(cfg, state, pts[i], vals[i], tfs[i],
                                     pos[i], use_window=False,
                                     method="scanline")
        fr = fusion.fuse_counts(cfg, state.logodds, state.seen,
                                state.hit_cnt, state.miss_cnt)
        ins = torch.nonzero(fr.insert_mask).cpu().numpy()
        dele = torch.nonzero(fr.delete_mask).cpu().numpy()
        state = dataclasses.replace(
            state, logodds=fr.logodds, seen=fr.seen,
            hit_cnt=torch.zeros_like(state.hit_cnt),
            miss_cnt=torch.zeros_like(state.miss_cnt))
        yield (np.concatenate([ins, dele]).astype(np.int32),
               np.concatenate([np.ones(len(ins), np.uint8),
                               np.zeros(len(dele), np.uint8)]), state)
