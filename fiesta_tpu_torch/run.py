"""CLI app: streaming ESDF mapping + MPC demo (port of
``fiesta_tpu/run.py``, reference components C22/C15).

The reference's app is ``test_fiesta.cpp`` — a ROS node fed by rosbag replay
(README.md:88-96).  Without ROS, this runner replays a synthetic sequence,
a recorded ``.npz`` sequence or a ROS bag through the pipeline at the
reference's cadences (sensor 30 Hz, ESDF tick 10 Hz), prints the timing
table, optionally dumps visualization artifacts, and can close the loop
with the MPC planner.  It runs on the CUDA card unless given
``--platform cpu``; without a card it refuses to start.

Usage::

    python -m fiesta_tpu_torch.run --preset cow_and_lady --frames 60 \
        --viz-dir viz --checkpoint map.npz
    python -m fiesta_tpu_torch.run --preset cow_and_lady --bag data.bag
    python -m fiesta_tpu_torch.run --bag data.bag --bag-info  # list topics
    python -m fiesta_tpu_torch.run --replay scans.npz    # recorded npz
    python -m fiesta_tpu_torch.run --preset demo --mpc   # one planner solve
    python -m fiesta_tpu_torch.run --preset small --fly  # closed-loop flight
    python -m fiesta_tpu_torch.run --scrolling ...       # unbounded world
    python -m fiesta_tpu_torch.run --scrolling --persist world.npz
    python -m fiesta_tpu_torch.run --platform cpu ...    # plain PyTorch, CPU
    python -m fiesta_tpu_torch.run --devices 8 ...       # sharded engine
    python -m fiesta_tpu_torch.run --platform cpu --devices 8 --mpc

Recorded sequence format (.npz): arrays ``t [N]``, ``pos [N,3]``,
``quat [N,4]`` (wxyz), and either ``clouds [N,P,3]`` (sensor frame) or
``depths [N,H,W]`` (meters).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", choices=["cow_and_lady", "demo", "small"],
                   default="small")
    p.add_argument("--replay", help="recorded .npz sequence to replay")
    p.add_argument("--bag", help="ROS bag (format 2.0) to replay — the "
                                 "reference's own input format "
                                 "(rosbag play, README.md:88-96)")
    p.add_argument("--bag-info", action="store_true",
                   help="print the bag's topic/type/count table and exit")
    p.add_argument("--sensor-topic",
                   help="PointCloud2/Image topic (default: the preset's "
                        "launch-file remap, else auto-pick by type)")
    p.add_argument("--pose-topic",
                   help="TransformStamped/PoseStamped/Odometry topic "
                        "(same defaulting)")
    p.add_argument("--frames", type=int, default=30,
                   help="synthetic frames to generate (no --replay)")
    p.add_argument("--method",
                   choices=["scanline", "projective", "dda"],
                   default="scanline")
    p.add_argument("--esdf-mode", choices=["rebuild", "incremental"],
                   default=None, help="override config esdf_mode")
    p.add_argument("--config", metavar="PARAMS.json",
                   help="JSON dict of FiestaConfig fields merged over the "
                        "preset — the launch-file tier of the reference's "
                        "config system (field names match the ROS params, "
                        "src/parameters.cpp)")
    p.add_argument("--set", action="append", metavar="FIELD=VALUE",
                   help="override one config field (repeatable); tuples "
                        "as comma lists, e.g. --set origin=-10,-10,-2")
    p.add_argument("--scrolling", action="store_true",
                   help="unbounded-world mode: the grid recenters around "
                        "the robot (the reference's HASH_TABLE analog); "
                        "the final report prints the world origin")
    p.add_argument("--persist", metavar="ARCHIVE.npz", nargs="?",
                   const="", default=None,
                   help="with --scrolling: persistent explored world via a "
                        "host tile directory (the reference HASH_TABLE "
                        "retains all explored blocks); optional path "
                        "loads/saves the directory across runs")
    p.add_argument("--update-every", type=int, default=3,
                   help="ESDF tick every N frames (10 Hz at 30 Hz sensor)")
    p.add_argument("--viz-dir", help="dump slice images + occupied cloud")
    p.add_argument("--profile-dir",
                   help="capture a torch.profiler trace of the replay into "
                        "this directory (trace.json, Chrome trace format; "
                        "the program's fiesta.* spans sit in it around the "
                        "ops of each layer; the span table, host and device "
                        "ms and kernel launches by span, prints at the end)")
    p.add_argument("--checkpoint", help="save the final map here")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also checkpoint after every N ESDF updates "
                        "(crash/resume protection; writes are atomic)")
    p.add_argument("--resume", help="start from a checkpoint")
    p.add_argument("--mpc", action="store_true",
                   help="run an MPC plan against the final ESDF")
    p.add_argument("--fly", action="store_true",
                   help="closed-loop flight across the mapped space: "
                        "receding-horizon MPC executing the first control "
                        "each step (BASELINE config 5)")
    p.add_argument("--fly-steps", type=int, default=60,
                   help="max control steps for --fly")
    p.add_argument("--sdf", action="store_true",
                   help="maintain a SIGNED distance field (component C18, "
                        "the reference's SIGNED_NEEDED inverse map): the "
                        "pipeline refreshes it every ESDF tick, --mpc/--fly "
                        "plan against it (graded interior penetration "
                        "cost), and --viz-dir gets an sdf_slice artifact")
    p.add_argument("--ground-truth-check", action="store_true",
                   help="print the accuracy oracle report (debug C20)")
    p.add_argument("--print-timing-every", type=int, default=0,
                   help="print the timing table after every N ESDF updates "
                        "(the reference prints after every one, Fiesta.h:521;"
                        " 0 = only at the end)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="where the map lives: the CUDA card (default; the "
                        "run refuses to start without one) or the CPU "
                        "(plain PyTorch versions of every kernel)")
    p.add_argument("--devices", type=int, default=0, metavar="N",
                   help="run the SHARDED engine over an N-shard X-slab mesh: "
                        "N cards with --platform cuda, a virtual mesh of N "
                        "shards on the CPU with --platform cpu")
    return p


def _preset_cfg(name: str):
    from . import COW_AND_LADY, DEMO_ONBOARD, FiestaConfig
    from .io.replay import scale_intrinsics

    if name == "cow_and_lady":
        cfg, h, w = COW_AND_LADY, 192, 256
    elif name == "demo":
        cfg, h, w = DEMO_ONBOARD, 120, 160
    else:
        cfg = FiestaConfig(
            resolution=0.1, origin=(-3.0, -3.0, -0.5),
            map_size=(6.0, 6.0, 2.0), min_ray_length=0.3,
        )
        h, w = 120, 160
    cfg = scale_intrinsics(cfg, h, w)
    cfg = dataclasses.replace(cfg, max_points_per_scan=h * w)
    return cfg, h, w


def _parse_value(text: str):
    """Parse a --set value: bool / int / float / comma-tuple / string."""
    t = text.strip()
    if t.lower() in ("true", "false"):
        return t.lower() == "true"
    if "," in t:
        return tuple(_parse_value(p) for p in t.split(","))
    for cast in (int, float):
        try:
            return cast(t)
        except ValueError:
            pass
    return t


def _apply_overrides(cfg, overrides: dict, source: str):
    """Merge a dict of FiestaConfig fields over the preset — the
    launch-file/param-server tier of the reference's config system
    (src/parameters.cpp:6-96; field names match the ROS param names).
    Unknown fields are an error, not a silent ignore."""
    valid = {f.name for f in dataclasses.fields(cfg)}
    bad = set(overrides) - valid
    if bad:
        raise SystemExit(
            f"{source}: unknown config field(s) {sorted(bad)}; valid "
            f"fields are the FiestaConfig dataclass fields (config.py)")
    fixed = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, tuple):
            v = tuple(v)
            if len(v) != len(cur):
                raise SystemExit(
                    f"{source}: {k} expects {len(cur)} values, got {len(v)}")
        fixed[k] = v
    return dataclasses.replace(cfg, **fixed)


#: per-preset launch-file topic remaps (cow_and_lady.launch:66-67,
#: demo.launch:70-72)
PRESET_TOPICS = {
    "cow_and_lady": ("/camera/depth_registered/points",
                     "/kinect/vrpn_client/estimated_transform"),
    "demo": ("/camera/depth/image_rect_raw", "/vins_estimator/camera_pose"),
}


def _device(args) -> torch.device:
    """The run's device; refuses (SystemExit) CUDA without a card."""
    if args.platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device available: fiesta_tpu_torch.run runs on the "
            "card by default; pass --platform cpu to run the plain PyTorch "
            "versions on the CPU")
    return torch.device(args.platform)


def _sharded_pipeline(args, cfg, dev, load_archive):
    """The sharded engine of ``--devices N`` (``fiesta_tpu/run.py:305-349``)
    with JAX's refusals: a virtual mesh of N shards on the CPU with
    ``--platform cpu``, N cards with ``--platform cuda``."""
    if args.esdf_mode == "incremental":
        raise SystemExit("--devices runs the sharded rebuild tick; "
                         "incremental mode is single-device")
    if args.method != "scanline":
        raise SystemExit("--devices uses the scanline integrator "
                         f"(got --method {args.method})")
    if args.mpc or args.fly:
        from .planning.mpc import MPCConfig

        if MPCConfig().n_rollouts % args.devices:
            raise SystemExit(
                f"--mpc/--fly with --devices {args.devices}: the "
                f"{MPCConfig().n_rollouts} MPPI rollouts must divide "
                "by the mesh size")
    from .parallel.engine import (ShardedFiestaPipeline,
                                  ShardedScrollingFiestaPipeline)
    from .parallel.sharding import make_mesh

    if dev.type == "cpu":
        devices = [dev] * args.devices
    else:
        n_avail = torch.cuda.device_count()
        if n_avail < args.devices:
            raise SystemExit(
                f"--devices {args.devices} but only {n_avail} devices "
                "visible (use --platform cpu for a virtual mesh)")
        devices = None
    if cfg.grid_shape[0] % args.devices:
        raise SystemExit(
            f"grid X={cfg.grid_shape[0]} must divide by --devices "
            f"{args.devices} (X-slab sharding)")
    mesh = make_mesh(args.devices, devices)
    if args.scrolling:
        archive = load_archive()
        pipe = ShardedScrollingFiestaPipeline(
            cfg, mesh=mesh, scans_per_tick=args.update_every,
            archive=None if args.resume else archive)
        if args.resume:
            pipe.archive = archive
        print(f"sharded scrolling engine: {args.devices}-device "
              "X-slab mesh, unbounded world", file=sys.stderr)
    else:
        pipe = ShardedFiestaPipeline(cfg, mesh=mesh,
                                     scans_per_tick=args.update_every)
        print(f"sharded engine: {args.devices}-device X-slab mesh",
              file=sys.stderr)
    return pipe


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    if args.persist is not None and not args.scrolling:
        raise SystemExit("--persist requires --scrolling (the fixed-AABB "
                         "grid never evicts, so the whole world is already "
                         "resident; use --checkpoint to persist it)")
    if args.persist and not args.persist.endswith(".npz"):
        # np.savez appends the suffix on save; normalize so the next run's
        # exists-check looks at the file that was actually written
        args.persist += ".npz"

    if args.bag_info:
        if not args.bag:
            raise SystemExit("--bag-info requires --bag")
        from .io import rosbag

        rosbag.print_bag_info(rosbag.bag_info(args.bag))
        return 0

    dev = _device(args)

    if args.checkpoint_every and not args.checkpoint:
        raise SystemExit("--checkpoint-every requires --checkpoint "
                         "(the path periodic saves write to)")

    from .io import replay
    from .pipeline import FiestaPipeline
    from . import timing
    from .timing import Timer, Timing

    cfg, h, w = _preset_cfg(args.preset)
    if args.config:
        with open(args.config) as fh:
            cfg = _apply_overrides(cfg, json.load(fh), source=args.config)
    for kv in args.set or []:
        if "=" not in kv:
            raise SystemExit(f"--set expects field=value, got {kv!r}")
        k, v = kv.split("=", 1)
        cfg = _apply_overrides(cfg, {k: _parse_value(v)}, source="--set")
    if args.esdf_mode:
        cfg = dataclasses.replace(cfg, esdf_mode=args.esdf_mode)
    if args.sdf:
        cfg = dataclasses.replace(cfg, signed_needed=True)

    if args.bag:
        frames, kind = None, None           # streamed, not materialized
    elif args.replay:
        data = np.load(args.replay)
        ts = data["t"]
        if len(ts) == 0:
            raise SystemExit(f"replay {args.replay} contains no frames")
        kind = "cloud" if "clouds" in data else "depth"
        if kind == "depth":
            # recorded depth resolution overrides the preset's: intrinsics
            # must match the actual image grid or back-projection is
            # silently wrong
            h2, w2 = data["depths"].shape[1:]
            if (h2, w2) != (h, w):
                cfg = dataclasses.replace(
                    replay.scale_intrinsics(cfg, h2, w2,
                                            base_height=h, base_width=w),
                    max_points_per_scan=int(h2) * int(w2),
                )
                h, w = h2, w2
        frames = []
        for i in range(len(ts)):
            scan = (data["clouds"][i] if "clouds" in data
                    else data["depths"][i])
            frames.append(
                (float(ts[i]), (data["pos"][i], data["quat"][i]), scan)
            )
    else:
        print(f"generating {args.frames} synthetic frames "
              f"({cfg.grid_shape} grid)...", file=sys.stderr)
        _, frames = replay.make_sequence(
            cfg, n_frames=args.frames, n_boxes=12, seed=args.seed,
            height=h, width=w,
        )
        kind = "cloud"

    def load_archive():
        """--persist plumbing of the scrolling engine."""
        if args.persist is None:
            return None
        from .archive import TileArchive

        if args.persist and os.path.exists(args.persist):
            a = TileArchive.from_file(args.persist)
            print(f"loaded archive: {a.num_tiles} tiles, "
                  f"{a.seen_voxels()} seen voxels", file=sys.stderr)
            return a
        return TileArchive()

    if args.devices:
        pipe = _sharded_pipeline(args, cfg, dev, load_archive)
    elif args.scrolling:
        from .scrolling import ScrollingFiestaPipeline

        archive = load_archive()
        # when resuming, keep the archive OUT of the constructor so
        # _hydrate_from_archive cannot fill the window at anchor 0; no
        # archive operation may run until the resume block below has
        # restored the checkpointed state and world anchor
        pipe = ScrollingFiestaPipeline(
            cfg, method=args.method,
            archive=None if args.resume else archive, device=dev)
        if args.resume:
            pipe.archive = archive
    else:
        pipe = FiestaPipeline(cfg, method=args.method, device=dev)
    if args.preset == "cow_and_lady" and (args.replay or args.bag):
        # recorded poses are vicon body poses; apply the dataset extrinsics
        # the reference hardcodes (src/parameters.cpp:67-75)
        from .config import COW_AND_LADY_T_D_B

        pipe.T_D_B = np.asarray(COW_AND_LADY_T_D_B, np.float64)
    if args.resume:
        from . import checkpoint

        ck_cfg, state = checkpoint.load(args.resume, device=dev)
        if ck_cfg.grid_shape != cfg.grid_shape:
            raise SystemExit("checkpoint grid does not match preset")
        pipe.state = state
        if hasattr(pipe, "_reshard_state"):
            pipe._reshard_state()   # sharded engines cut it into slabs
        if args.scrolling:
            anchor = checkpoint.load_anchor(args.resume)
            if anchor is not None:
                # the resumed window replaces any constructor hydration;
                # the archive's world-absolute tiles line up again once
                # the anchor is restored
                pipe.origin_vox = anchor
            elif args.persist is not None:
                raise SystemExit(
                    "--persist with --resume needs a checkpoint that "
                    "stores the scrolling world anchor; re-save the "
                    "checkpoint with this version first")

    viz_dir = args.viz_dir
    if viz_dir:
        os.makedirs(viz_dir, exist_ok=True)

    def dump_slice(tag: str) -> None:
        from . import viz

        img = viz.slice_image(cfg, pipe.state)
        np.savez_compressed(
            os.path.join(viz_dir, f"slice_{tag}.npz"), rgb=img,
            # the reference's on-screen perf marker (Fiesta.h:161-188),
            # published alongside the slice at visualization cadence
            perf_text=np.asarray(viz.performance_text()))

    t_start = time.perf_counter()
    n_updates = 0
    n_frames = 0

    def after_update(stats) -> None:
        nonlocal n_updates
        if stats is None:
            return
        n_updates += 1
        if (args.print_timing_every
                and n_updates % args.print_timing_every == 0):
            print(Timing.print_table(), file=sys.stderr)
        # periodic visualization (reference cadence:
        # visualize_every_n_updates, Fiesta.h:531-534)
        if (viz_dir and cfg.visualize_every_n_updates
                and n_updates % cfg.visualize_every_n_updates == 0):
            dump_slice(f"{n_updates:05d}")
        if (args.checkpoint and args.checkpoint_every
                and n_updates % args.checkpoint_every == 0):
            from . import checkpoint

            checkpoint.save(args.checkpoint, cfg, pipe.state,
                            origin_vox=getattr(pipe, "origin_vox", None))
            # keep the persistent world archive in lockstep: a crash-resume
            # pairing a fresh checkpoint with a stale archive would silently
            # lose every strip evicted since the run started
            if args.persist and getattr(pipe, "archive", None) is not None:
                pipe.archive.save(args.persist)

    profiler = None
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        timing.enable(True, device=dev.type == "cuda")
        profiler.__enter__()

    try:
        if args.bag:
            from .io import rosbag

            s_default, p_default = PRESET_TOPICS.get(args.preset, (None, None))
            sensor_topic, pose_topic = rosbag.pick_topics(
                rosbag.bag_connections(args.bag),
                args.sensor_topic or s_default,
                args.pose_topic or p_default,
            )
            print(f"replaying {args.bag}: sensor={sensor_topic} "
                  f"pose={pose_topic}", file=sys.stderr)
            last_pose = None
            since_update = 0
            for m in rosbag.read_messages(args.bag,
                                          topics=[sensor_topic, pose_topic]):
                if m.topic == pose_topic:
                    msg = m.msg
                    pipe.observe_pose(m.t, msg.pos, msg.quat_wxyz)
                    last_pose = (m.t, msg.pos, msg.quat_wxyz)
                    continue
                if m.datatype == "sensor_msgs/PointCloud2":
                    pipe.observe_cloud(m.t, m.msg.xyz())
                else:
                    img = m.msg
                    if (img.height, img.width) != (h, w):
                        # recorded image resolution overrides the preset's
                        cfg = dataclasses.replace(
                            replay.scale_intrinsics(
                                cfg, img.height, img.width,
                                base_height=h, base_width=w),
                            max_points_per_scan=img.height * img.width,
                        )
                        h, w = img.height, img.width
                        pipe.cfg = cfg
                    pipe.observe_depth(
                        m.t, img.depth_m(cfg.depth_scaling_factor))
                got = pipe.process()
                n_frames += got
                since_update += got
                if since_update >= args.update_every:
                    since_update = 0
                    after_update(pipe.update())
            if last_pose is not None:   # flush scans waiting on a newer pose
                pipe.observe_pose(last_pose[0] + 1.0, *last_pose[1:])
                n_frames += pipe.process()
            if n_frames == 0:
                raise SystemExit(
                    "no sensor frames matched a pose — check --sensor-topic/"
                    "--pose-topic (see --bag-info) and the bag's timestamps")
        else:
            n_frames = len(frames)
            # One-frame-ahead prefetch: pad + upload the NEXT scan on a
            # worker thread while the device integrates the current one
            # (the reference decouples its sensor callbacks from the
            # update timer the same way, Fiesta.h:53-54).  The worker
            # enqueues its copies on the stream this thread reads them on,
            # so they are ordered before the frame's kernels.
            prefetch = None
            if kind == "cloud" and len(frames) > 1:
                from concurrent.futures import ThreadPoolExecutor

                prefetch = ThreadPoolExecutor(max_workers=1)
                stream = (torch.cuda.current_stream(dev)
                          if dev.type == "cuda" else None)

                def preload(scan):
                    if stream is None:
                        return pipe.preload_cloud(scan)
                    with torch.cuda.stream(stream):
                        return pipe.preload_cloud(scan)

            fut = (prefetch.submit(preload, frames[0][2])
                   if prefetch else None)
            frame_wall = []
            t_prev = time.perf_counter()
            for i, (t, (pos, quat), scan) in enumerate(frames):
                pipe.observe_pose(t, pos, quat)
                if kind == "cloud":
                    data = fut.result() if fut is not None else scan
                    if fut is not None and i + 1 < len(frames):
                        fut = prefetch.submit(preload, frames[i + 1][2])
                    pipe.observe_cloud(t, data)
                else:
                    pipe.observe_depth(t, scan)
                if i + 1 < len(frames):
                    pipe.observe_pose(frames[i + 1][0], *frames[i + 1][1])
                pipe.process()
                if i % args.update_every == args.update_every - 1:
                    after_update(pipe.update())
                now = time.perf_counter()
                frame_wall.append(now - t_prev)
                t_prev = now
            if prefetch is not None:
                prefetch.shutdown(wait=False)
            if len(frame_wall) >= 20:
                # steady-state frame cost, separated from first calls:
                # median over the second half of the replay
                steady = sorted(frame_wall[len(frame_wall) // 2:])
                med = steady[len(steady) // 2]
                print(f"steady-state: {med * 1e3:.2f} ms/frame median "
                      f"(2nd half of {len(frame_wall)} frames)",
                      file=sys.stderr)
            pipe.observe_pose(frames[-1][0] + 1.0, *frames[-1][1])
            pipe.process()
        pipe.update()
        pipe.sync_device()
    finally:
        # finalize the trace even when replay fails (a leaked trace is
        # empty/corrupt with no indication why)
        if profiler is not None:
            profiler.__exit__(None, None, None)
            timing.enable(False)
            profiler.export_chrome_trace(
                os.path.join(args.profile_dir, "trace.json"))
            print(f"profiler trace in {args.profile_dir}", file=sys.stderr)
    wall = time.perf_counter() - t_start

    occ = int(pipe.occupied().sum().cpu().numpy())
    print(f"processed {n_frames} frames, {n_updates + 1} ESDF updates "
          f"in {wall:.2f}s ({wall / max(n_frames, 1) * 1e3:.1f} ms/frame); "
          f"{occ} occupied voxels", file=sys.stderr)
    if args.scrolling:
        print(f"scrolling grid: {pipe.scroll_count} recenters, world "
              f"origin now {np.round(pipe.world_origin, 3)} (checkpoints "
              "store the map in this frame)", file=sys.stderr)
        if pipe.archive is not None:
            # archive the CURRENT window too so a saved directory holds the
            # full explored world, not just evicted strips
            pipe.archive.store(
                pipe.origin_vox,
                pipe.state.logodds.cpu().numpy(),
                pipe.state.seen.cpu().numpy(),
            )
            print(f"world archive: {pipe.archive.num_tiles} tiles, "
                  f"{pipe.archive.seen_voxels()} seen voxels, "
                  f"{pipe.restore_count} restores "
                  f"({pipe.archive.nbytes() / 1e6:.1f} MB host)",
                  file=sys.stderr)
            if args.persist:
                pipe.archive.save(args.persist)
                print(f"archive saved to {args.persist}", file=sys.stderr)
    print(Timing.print_table(), file=sys.stderr)
    if profiler is not None:
        print(timing.span_table(timing.drain()), file=sys.stderr)

    if args.ground_truth_check:
        from .debug import check_with_ground_truth

        rep = check_with_ground_truth(cfg, pipe.state)
        print(json.dumps(rep, indent=1), file=sys.stderr)

    if args.viz_dir:
        from . import viz

        img = viz.slice_image(cfg, pipe.state)
        np.savez_compressed(
            os.path.join(args.viz_dir, "slice.npz"), rgb=img
        )
        pc = viz.occupied_pointcloud(cfg, pipe.state)
        np.savez_compressed(
            os.path.join(args.viz_dir, "occ_pc.npz"), points=pc
        )
        if args.sdf:
            # raw signed values (meters) at the slice level: consumers can
            # colormap penetration depth vs clearance directly
            zi = viz.slice_index(cfg)
            np.savez_compressed(
                os.path.join(args.viz_dir, "sdf_slice.npz"),
                sdf=pipe.sdf_grid()[:, :, zi].cpu().numpy(), z_index=zi,
            )
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.imsave(os.path.join(args.viz_dir, "slice.png"),
                       np.clip(img.transpose(1, 0, 2), 0, 1), origin="lower")
        except Exception:
            pass   # matplotlib is optional: the .npz artifacts stand alone
        print(f"viz artifacts in {args.viz_dir}", file=sys.stderr)

    if args.checkpoint:
        from . import checkpoint

        checkpoint.save(args.checkpoint, cfg, pipe.state,
                        origin_vox=getattr(pipe, "origin_vox", None))
        print(f"checkpoint saved to {args.checkpoint}", file=sys.stderr)

    if args.mpc or args.fly:
        from .planning import mpc as mpc_mod

        mpc_cfg = mpc_mod.MPCConfig(signed=args.sdf)
        center = np.asarray(cfg.origin) + np.asarray(cfg.map_size) / 2
        p0 = torch.tensor(center + [0.0, -1.0, 0.0], dtype=torch.float32,
                          device=dev)
        goal = torch.tensor(center + [0.0, 1.0, 0.0], dtype=torch.float32,
                            device=dev)
        # the sharded plan() replicates its own grid; materialise `dist`
        # only where this process reads it
        dist = ((pipe.sdf_grid() if args.sdf else pipe.distance_grid())
                if (not args.devices or args.fly) else None)
        v_zero = torch.zeros(3, device=dev)
        nominal_zero = torch.zeros((mpc_cfg.horizon, 3), device=dev)

    if args.mpc:
        with Timer("mpc_plan", dev):
            gen = torch.Generator(device=dev).manual_seed(0)
            if args.devices:
                # the rollouts split over the map's mesh
                res = pipe.plan(goal, mpc_cfg, p0=p0, generator=gen)
            else:
                res = mpc_mod.plan_step(cfg, mpc_cfg, dist, p0, v_zero,
                                        goal, nominal_zero, gen)
            pipe.sync_device()
        print(f"MPC: {mpc_cfg.n_rollouts} rollouts, cost "
              f"{float(res.cost.cpu().numpy()):.2f}, plan ends at "
              f"{res.positions[-1].cpu().numpy().round(2)}", file=sys.stderr)
        print(Timing.print_table(), file=sys.stderr)

    if args.fly:
        from .grid import f32_scalar
        from .ops.query import get_distance

        # receding horizon: solve, execute the first control, re-plan
        # (the closed loop of tests/test_full_loop.py as a CLI mode); the
        # draws come from a generator seeded with --seed
        p, v, nominal = p0, v_zero, nominal_zero
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        v_lo = f32_scalar(-mpc_cfg.v_max, p0)
        v_hi = f32_scalar(mpc_cfg.v_max, p0)
        executed = [p.cpu().numpy()]
        reached = False
        for _ in range(args.fly_steps):
            with Timer("fly_step", dev):
                if args.devices:
                    res = pipe.plan(goal, mpc_cfg, p0=p, v0=v,
                                    nominal=nominal, generator=gen)
                else:
                    res = mpc_mod.plan_step(cfg, mpc_cfg, dist, p, v, goal,
                                            nominal, gen)
                a = res.controls[0]
                v = torch.minimum(torch.maximum(v + a * mpc_cfg.dt, v_lo),
                                  v_hi)
                p = p + v * mpc_cfg.dt
                nominal = mpc_mod.shift_nominal(res.controls)
                pipe.sync_device()
            executed.append(p.cpu().numpy())
            if float(torch.linalg.norm(p - goal).cpu().numpy()) < 0.3:
                reached = True
                break
        executed = np.asarray(executed)
        # the flight was planned in the map's virtual frame against `dist`;
        # query that same grid directly (ScrollingFiestaPipeline's
        # world-frame query would shift the path a second time, and
        # re-deriving the distance grid would waste a full-grid pass)
        clear = float(get_distance(
            cfg, dist, torch.from_numpy(executed).to(dev)).min().cpu()
            .numpy())
        clear_txt = (f"{clear:.2f} m" if clear < 9999
                     else "unobstructed (no obstacle within range)")
        goal_np = goal.cpu().numpy()
        print(f"fly: {len(executed) - 1} control steps, "
              f"{'reached goal' if reached else 'goal not reached'} "
              f"(final err {np.linalg.norm(executed[-1] - goal_np):.2f} m), "
              f"min map clearance {clear_txt}", file=sys.stderr)
        print(Timing.print_table(), file=sys.stderr)
        if args.viz_dir:
            # store the path in WORLD coordinates (identical to the
            # virtual frame unless --scrolling has recentered)
            offset = (np.asarray(pipe.world_origin)
                      - np.asarray(cfg.origin)) if args.scrolling \
                else np.zeros(3)
            np.savez_compressed(
                os.path.join(args.viz_dir, "flight_path.npz"),
                path=executed + offset, goal=goal_np + offset)

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
