#!/usr/bin/env python3
"""Multi-device structure of fiesta_tpu_torch's sharded engine, on virtual
meshes of one CUDA card (the twin of ``bench_scaling.py``).

    python3 bench_scaling_torch.py [--platform cpu]

A virtual mesh of n shards on one card (``make_mesh(n, [card] * n)``; on
the CPU ``[cpu] * n``) runs every shard's slab kernels and every
collective (a copy on the device) one after another on that device.  So
its wall times measure the sharded program's STRUCTURE: the work that
sharding adds (halo and edge planes, replicated scans, a launch for each
shard), not scaling across cards.  On ``bench_scaling.py``'s mesh-scale
problem (128x80x24 voxels at 0.1 m, three 60x80 scans, t = 20), at n = 1,
2, 4 and 8:

  * the sharded tick (``sharded_fused_tick``, 8 timed ticks after one);
  * the sharded planner (``make_sharded_planner``, ``MPCConfig(n_rollouts=
    2048, horizon=20, refine_steps=4)``, 8 timed solves after one);
  * weak scaling: 64 x-planes a shard, the world growing with n;
  * the pad term at n = 8 on the weak-scaled grid: k = 3 scans against
    k = 8 with the last five all-invalid (the final states bit-equal),
    the better of two interleaved timings each.

Work inflation is wall(n) / wall(1) (1.0: sharding adds no work); below
1.0 it means the n shards overlapped, not a speed-up.  In place of the
JAX benchmark's HLO audit, the collectives count the bytes they deliver
(``sharding.COLLECTIVE_BYTES``): one tick at n = 8 by kind, beside the
exact terms of the port's collectives (``port_model_bytes_n8``) and the
JAX benchmark's analytic terms.  Times are CUDA events on the card.

Prints one JSON line on stdout; diagnostics go to stderr.
"""

import dataclasses
import sys

import numpy as np
import torch

from fiesta_tpu_torch import benchtools as bt
from fiesta_tpu_torch.config import FiestaConfig
from fiesta_tpu_torch.grid import make_state
from fiesta_tpu_torch.io import replay
from fiesta_tpu_torch.ops import edt, raycast
from fiesta_tpu_torch.parallel import sharding
from fiesta_tpu_torch.planning import mpc

H, W = 60, 80
NS = (1, 2, 4, 8)
TICK_REPS = 8
MPC_REPS = 8
WEAK_REPS = 6
MPC_SCALING = mpc.MPCConfig(n_rollouts=2048, horizon=20, refine_steps=4)


def scaling_config(h=H, w=W):
    """``bench_scaling.py:86-104``: 1/5-scale cow, 128x80x24 voxels."""
    return bt.scan_config(FiestaConfig(
        resolution=0.1, origin=(-6.4, -4.0, -1.2), map_size=(12.8, 8.0, 2.4),
        min_ray_length=0.2, max_ray_length=2.5, trunc_dist=2.0,
        edt_fine_dist=2.0, esdf_mode="rebuild", global_update=True), h, w)


def scans(cfg, h=H, w=W):
    """Its three scans (``bench_scaling.py:105-113``): points [3,P,3] in the
    sensor frame, valids [3,P], transforms [3,4,4], numpy."""
    _, frames = replay.make_sequence(
        cfg, n_frames=6, n_boxes=6, seed=0, height=h, width=w,
        orbit_radius=1.5, period=6.0)
    pts = np.stack([f[2] for f in frames[:3]]).astype(np.float32)
    vals = np.isfinite(pts).all(-1)
    tfs = np.stack([replay.pose_to_matrix(*frames[i][1])
                    for i in range(3)]).astype(np.float32)
    return pts, vals, tfs


def weak_config(cfg, n):
    """The world n times as wide as half the base map, so that each of n
    shards holds the same slab (``bench_scaling.py:183-186``)."""
    half = cfg.map_size[0] / 2
    return dataclasses.replace(
        cfg, map_size=(half * n, cfg.map_size[1], cfg.map_size[2]),
        origin=(-half / 2 * n, cfg.origin[1], cfg.origin[2])).validate()


def virtual_mesh(n, dev):
    return sharding.make_mesh(n, [dev] * n)


def _tick_args(pts, vals, tfs, dev, k=3):
    """The scans on ``dev``, padded to ``k`` with all-invalid scans at
    identity."""
    extra = k - pts.shape[0]
    pts = np.concatenate([pts, np.zeros((extra,) + pts.shape[1:],
                                        np.float32)])
    vals = np.concatenate([vals, np.zeros((extra,) + vals.shape[1:], bool)])
    tfs = np.concatenate([tfs, np.broadcast_to(np.eye(4, dtype=np.float32),
                                               (extra, 4, 4))])
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (pts, vals, tfs, np.zeros(3, np.float32))]


def tick_ms(cfg, n, args, dev, reps):
    """ms of the sharded tick on a virtual mesh of n (after one settling
    tick), and the final sharded state and mesh."""
    mesh = virtual_mesh(n, dev)
    step = sharding.sharded_fused_tick(cfg, mesh)
    state, _ = step(sharding.shard_state(make_state(cfg, dev), mesh), *args)

    def run(st):
        for _ in range(reps):
            st, _ = step(st, *args)
        return st

    state, ms = bt.timed(lambda: run(state), dev)
    return ms / reps, state, mesh


def tick_collective_bytes(cfg, n, args, dev):
    """Bytes each kind of collective delivers in one sharded tick on a
    virtual mesh of n (from an empty map)."""
    mesh = virtual_mesh(n, dev)
    step = sharding.sharded_fused_tick(cfg, mesh)
    state = sharding.shard_state(make_state(cfg, dev), mesh)
    sharding.COLLECTIVE_BYTES.clear()
    step(state, *args)
    return dict(sharding.COLLECTIVE_BYTES)


def collective_model(cfg, n, k=3):
    """The bytes one tick's collectives deliver on a mesh of n (one EDT
    level, d2 only), term by term from the port's collectives:

      * all_gather: each shard receives every shard's box corners
        (k_pad x 3 i32) and packed u8 counter boxes (k_pad boxes);
      * ppermute: the x pass's edge planes ([Y,Z] i32), a plane each way
        at each doubling hop j <= h_need to the n - j shards that have a
        partner j away, then one more hop each way to the n - 1 shards
        with a neighbour;
      * psum: the three counts (3 i32) on each shard."""
    gx, gy, gz = cfg.grid_shape
    lx = gx // n
    t = edt.trunc_vox_for(cfg.resolution, cfg.trunc_dist)
    k_pad = k + (-k % n)
    box = int(np.prod(raycast._carve_box_shape(cfg)))
    plane = gy * gz * 4
    edges = 0
    if n > 1:
        h_need = min(n - 1, (t - 1) // lx + 1)
        j = 1
        while j <= h_need:
            edges += 2 * (n - j) * plane
            j *= 2
        edges += 2 * (n - 1) * plane
    return {"all_gather": n * (k_pad * 3 * 4 + k_pad * box),
            "ppermute": edges, "psum": n * 3 * 4}


def jax_model_terms(cfg):
    """``bench_scaling.py:288-322``'s analytic terms at n = 8: the edge
    planes counted on all 8 devices at (2 hops + 2), and the box gather."""
    t = int(np.ceil(cfg.trunc_dist / cfg.resolution))
    gy, gz = cfg.grid_shape[1], cfg.grid_shape[2]
    lx8 = cfg.grid_shape[0] // 8
    h_need = min(7, (t - 1) // lx8 + 1)
    hops, j = 0, 1
    while j <= h_need:
        hops += 1
        j *= 2
    bxs = raycast._carve_box_shape(cfg)
    k_pad = 3 + (-3 % 8)
    return (8 * (2 * hops + 2) * gy * gz * 4,
            8 * (k_pad * bxs[0] * bxs[1] * bxs[2] + k_pad * 3 * 4))


def planner_ms(cfg, m, n, dev, reps):
    """ms of the rollout-sharded solve on a virtual mesh of n."""
    mesh = virtual_mesh(n, dev)
    planner = mpc.make_sharded_planner(cfg, m, mesh)
    dist = torch.full(cfg.grid_shape, 10.0, dtype=torch.float32, device=dev)
    z = torch.zeros(3, device=dev)
    goal = torch.tensor([2.0, 1.0, 0.2], device=dev)
    nominal = torch.zeros((m.horizon, 3), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def run():
        for _ in range(reps):
            res = planner(dist, z, z, goal, nominal, gen)
        float(res.cost)

    run()
    _, ms = bt.timed(run, dev)
    return ms / reps


def pad_term(cfg, pts, vals, tfs, dev, reps):
    """The n = 8 weak-scaled tick with k = 3 scans and with k = 8 (five
    all-invalid): (ms k = 3, ms k = 8, final states bit-equal), the better
    of two interleaved timings each."""
    wcfg = weak_config(cfg, 8)
    ms, states = {3: [], 8: []}, {}
    for k in (3, 8, 3, 8):
        t, st, mesh = tick_ms(wcfg, 8, _tick_args(pts, vals, tfs, dev, k),
                              dev, reps)
        ms[k].append(t)
        states.setdefault(k, sharding.gather_state(st, mesh))
    equal = all(torch.equal(getattr(states[3], f), getattr(states[8], f))
                for f in ("d2", "logodds", "seen", "hit_cnt", "miss_cnt"))
    return min(ms[3]), min(ms[8]), equal


def measure(cfg, pts, vals, tfs, dev, ns=NS, tick_reps=TICK_REPS,
            mpc_cfg=MPC_SCALING, mpc_reps=MPC_REPS, weak_reps=WEAK_REPS):
    """Every measurement above at mesh sizes ``ns`` (the bytes and the
    pad term at the largest).  Returns the JSON line's fields."""
    args = _tick_args(pts, vals, tfs, dev)
    tick_t, mpc_t, weak_t = {}, {}, {}
    for n in ns:
        tick_t[n], _, _ = tick_ms(cfg, n, args, dev, tick_reps)
        bt.log(f"n={n}: sharded tick {tick_t[n]:.3f} ms")
    top = max(ns)
    counted = tick_collective_bytes(cfg, top, args, dev)
    model = collective_model(cfg, top)
    bt.log(f"collective bytes a tick (n={top}): {counted}; the port's "
           f"terms {model}")
    for n in ns:
        mpc_t[n] = planner_ms(cfg, mpc_cfg, n, dev, mpc_reps)
        bt.log(f"n={n}: sharded MPC solve {mpc_t[n]:.3f} ms")
    for n in ns:
        wcfg = weak_config(cfg, n)
        weak_t[n], _, _ = tick_ms(wcfg, n, args, dev, weak_reps)
        bt.log(f"n={n}: weak-scaled tick {wcfg.grid_shape} "
               f"{weak_t[n]:.3f} ms")
    t3, t8, equal = pad_term(cfg, pts, vals, tfs, dev, weak_reps)
    bt.log(f"pad term (n=8): wall k=3 {t3:.3f} vs k=8 {t8:.3f} ms; states "
           f"bit-equal={equal}")
    jax_halo, jax_gather = jax_model_terms(cfg)
    rest = [n for n in ns if n != 1]

    def inflation(ts):
        out = {str(n): ts[n] / ts[1] for n in rest}
        out["proxy_saturated"] = any(ts[n] / ts[1] < 1.0 for n in rest)
        return out

    return {
        "metric": "hlo_collective_audit_and_virtual_mesh_proxy",
        "collective_bytes_n8": counted,
        "port_model_bytes_n8": model,
        "model_edt_compose_bytes_n8": jax_halo,
        "model_scan_boxgather_bytes_n8": jax_gather,
        "tick_ms": {str(n): tick_t[n] for n in ns},
        "tick_work_inflation": inflation(tick_t),
        "mpc_ms": {str(n): mpc_t[n] for n in ns},
        "mpc_work_inflation": inflation(mpc_t),
        "weak_tick_ms": {str(n): weak_t[n] for n in ns},
        "weak_efficiency": {str(n): n * weak_t[1] / weak_t[n] for n in rest},
        "weak_proxy_saturated": any(n * weak_t[1] / weak_t[n] > 1.05
                                    for n in rest),
        "pad_skip_term": {"wall_ms_k3": t3, "wall_ms_k8_old_behavior": t8,
                          "states_bit_equal": equal},
        "note": ("virtual mesh of one device: the shards and their "
                 "collectives run one after another on it, so wall ratios "
                 "measure the sharded program's structure (added work), "
                 "not scaling across cards; collective bytes are counted "
                 "by the mesh's collectives, not read from an HLO"),
    }


def main(argv=None):
    args = bt.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = bt.device(args.platform, "bench_scaling_torch.py")
    card = bt.describe(dev)
    cfg = scaling_config()
    bt.log(f"device: {card}; grid {cfg.grid_shape}")
    line = measure(cfg, *scans(cfg), dev)
    bt.emit({**line, "device": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
