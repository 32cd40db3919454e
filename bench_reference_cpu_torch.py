#!/usr/bin/env python3
"""Self-measured reference baseline: the FIESTA queue algorithm on the
host CPU, beside fiesta_tpu_torch's tick on the card (the twin of
``bench_reference_cpu.py``).

    python3 bench_reference_cpu_torch.py [--platform cpu] [--frames N]

``native/fiesta_core.cpp`` is a clean-room C++17 -O3 implementation of the
reference's core (dual insert/delete queues, per-voxel doubly-linked
closest-obstacle lists, 24-neighbour BFS, the semantics of
src/ESDFMap.cpp:273-398).  ``bench_torch.py``'s update batches
(cow_and_lady scale: 12.8 M voxels, 3 scans of 49 k rays a 10 Hz tick;
its 49 frames, or ``--frames``, at least 15 for the port's tick) go
through the port's integration and ``fusion.fuse_counts``, and each
tick's occupancy flips through the C++ core's UpdateESDF equivalent
(through ``fiesta_tpu_torch.native``), timed a batch on the host clock.
The port's full tick (carve, fusion and EDT rebuild, which the CPU number
does not include) is measured in the same run, as ``bench_torch.py``
measures it.

Prints one JSON line: the C++ core's mean ms an update batch (the steady
batches after the first four) on the named host CPU, with
``vs_baseline`` = that / the port's full tick ms (how many times faster
the port's whole tick is than the reference algorithm's ESDF stage
alone); diagnostics go to stderr.
"""

import sys
import time

import numpy as np

import bench_torch
from fiesta_tpu_torch import benchtools as bt
from fiesta_tpu_torch import native

H, W = 192, 256
N_FRAMES = 49


def core_update_ms(cfg, frames, dev):
    """The C++ core's update time a batch over ``frames``' ticks (flips
    from the port's integration and ``fuse_counts`` on ``dev``).  Returns
    (ms of each batch with flips, total expanded nodes)."""
    core = native.NativeEsdf(cfg.grid_shape)
    cpu_ms, expanded_total = [], 0
    for i, (vox, flags, _) in enumerate(
            bt.occupancy_flips(cfg, frames, dev)):
        if not len(vox):
            continue
        core.set_occupancy(vox, flags)
        t0 = time.perf_counter()
        expanded = core.update()
        cpu_ms.append(1e3 * (time.perf_counter() - t0))
        expanded_total += expanded
        bt.log(f"batch {i}: flips={len(vox)} expanded={expanded} "
               f"cpu={cpu_ms[-1]:.2f} ms")
    return cpu_ms, expanded_total


def measure(cfg, frames, dev, warm_batches=bench_torch.WARM_BATCHES,
            reps=bench_torch.REPS, min_occupied=bench_torch.MIN_OCCUPIED):
    """The C++ core's ms a batch and the port's tick on the same frames.
    Returns the JSON line's fields."""
    cpu_ms, expanded = core_update_ms(cfg, frames, dev)
    steady = cpu_ms[4:] if len(cpu_ms) > 8 else cpu_ms
    mean_ms = float(np.mean(steady))
    host = bt.cpu_model()
    bt.log(f"C++ core UpdateESDF on {host}: mean {mean_ms:.3f} ms a batch "
           f"(max {max(steady):.3f}), total expanded {expanded}")
    tick, _ = bench_torch.measure(cfg, frames, dev, warm_batches, reps,
                                  min_occupied)
    bt.log(f"port full tick (carve + fusion + EDT rebuild): "
           f"{tick['value']:.3f} ms")
    return {
        "metric": "reference_algorithm_cpu_update_ms",
        "value": mean_ms,
        "unit": "ms",
        "vs_baseline": mean_ms / tick["value"],
        "host_cpu": host,
        "cpu_ms_per_batch": cpu_ms,
        "expanded_total": expanded,
        "port_tick_ms": tick["value"],
    }


def main(argv=None):
    ap = bt.parser(__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=N_FRAMES,
                    help="replayed frames, three a tick (default: "
                         "bench.py's 49)")
    args = ap.parse_args(argv)
    dev = bt.device(args.platform, "bench_reference_cpu_torch.py")
    card = bt.describe(dev)
    bt.log(f"device: {card}; host CPU: {bt.cpu_model()}")
    cfg = bt.cow_config(H, W)
    frames = bt.replay_frames(cfg, args.frames, H, W)
    line = measure(cfg, frames, dev)
    bt.emit({**line, "device": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
