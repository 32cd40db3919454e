"""Long-soak robustness drill of fiesta_tpu_torch: scrolling + persist,
the C20 oracle, crash-resume.

The twin of ``soak.py``: a scrolling, persistent-archive run of the port
with the C20 oracle (``debug.check_consistency`` and
``check_with_ground_truth``) every ``--check-every`` updates, and a real
crash-resume drill.  A ``victim`` leg runs as a subprocess and is
SIGKILLed between two of its checkpoints; a ``resume`` leg continues from
its last checkpoint + archive pair; the resumed run's final map and
anchor must equal an uninterrupted ``ref`` leg's bit for bit.  (The
reference framework keeps its map in memory only and loses it on exit;
durability is this framework's own bar, SURVEY.md section 5.)

A leg saves each checkpoint and archive under names of their own (the
frames done), then names the pair in ``meta.json`` with one atomic
rename, so a kill at any instant leaves a consistent pair to resume from.

Usage:
  python soak_torch.py                      # full drill on the card
  python soak_torch.py --scale cow --frames 150
  python soak_torch.py --platform cpu       # CPU run (small scale forced)

Internal legs (spawned by the drill): --leg ref|victim|resume.
Prints ONE JSON line per leg and a final drill summary.
"""

import argparse
import glob
import json
import os
import signal
import subprocess
import sys
import tempfile
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_cfg(scale: str):
    """The scales of ``soak.py``: (config, scan height, width, orbit
    radius)."""
    import dataclasses

    from fiesta_tpu_torch import FiestaConfig
    from fiesta_tpu_torch.io import replay

    if scale == "small":
        h, w = 48, 64
        base = FiestaConfig(
            resolution=0.1,
            origin=(-3.2, -2.4, -1.2),
            map_size=(6.4, 4.8, 2.4),       # 64 x 48 x 24
            min_ray_length=0.2,
            max_ray_length=2.2,
            trunc_dist=1.2,
            edt_fine_dist=1.2,
        )
        orbit = 1.8
    elif scale == "mid":
        h, w = 96, 128
        base = FiestaConfig(
            resolution=0.05,
            origin=(-5.0, -5.0, -1.0),
            map_size=(10.0, 10.0, 2.0),     # 200 x 200 x 40 = 1.6 M vox
            min_ray_length=0.3,
            max_ray_length=4.0,
            trunc_dist=2.5,
            edt_fine_dist=2.5,
        )
        orbit = 3.0
    else:  # "cow": the cow_and_lady-scale window (launch/cow_and_lady.launch
        # grid and ray gates)
        h, w = 144, 192
        base = FiestaConfig(
            resolution=0.05,
            origin=(-10.0, -10.0, -1.0),
            map_size=(20.0, 20.0, 4.0),     # 400 x 400 x 80 = 12.8 M vox
            min_ray_length=0.5,
            max_ray_length=5.0,
        )
        orbit = 6.0
    cfg = dataclasses.replace(
        replay.scale_intrinsics(base, h, w), max_points_per_scan=h * w)
    return cfg, h, w, orbit


def make_frames(cfg, h, w, orbit, n_frames, seed=11):
    """A multi-orbit sweep wide enough that seen content scrolls out
    (eviction) and comes back (restore); deterministic, so every leg
    renders the same stream."""
    from fiesta_tpu_torch.io import replay

    _, frames = replay.make_sequence(
        cfg, n_frames=n_frames, n_boxes=14, seed=seed, height=h, width=w,
        orbit_radius=orbit, period=max(4.0, n_frames / 30.0 / 4.0))
    return frames


def save_pair(pipe, cfg, ck_dir: str, frames_done: int) -> None:
    """Checkpoint + archive under names of their own, then ``meta.json``
    naming them (one atomic rename), then the previous pair removed."""
    from fiesta_tpu_torch import checkpoint

    ck = os.path.join(ck_dir, f"ck_{frames_done:06d}.npz")
    arch = os.path.join(ck_dir, f"arch_{frames_done:06d}.npz")
    checkpoint.save(ck, cfg, pipe.state, origin_vox=pipe.origin_vox)
    pipe.archive.save(arch)
    meta = os.path.join(ck_dir, "meta.json")
    with open(meta + ".tmp", "w") as fh:
        json.dump({"frames_done": frames_done, "ck": ck, "archive": arch},
                  fh)
    os.replace(meta + ".tmp", meta)
    for old in glob.glob(os.path.join(ck_dir, "*_*.npz*")):
        if not old.startswith((ck, arch)):
            os.remove(old)


def run_leg(args):
    import numpy as np
    import torch

    from fiesta_tpu_torch import debug
    from fiesta_tpu_torch.archive import TileArchive
    from fiesta_tpu_torch.scrolling import ScrollingFiestaPipeline

    dev = torch.device(args.platform)
    cfg, h, w, orbit = build_cfg(args.scale)
    frames = make_frames(cfg, h, w, orbit, args.frames)

    if args.resume:
        from fiesta_tpu_torch import checkpoint

        pipe = ScrollingFiestaPipeline(cfg, method="scanline", archive=None,
                                       device=dev)
        pipe.archive = TileArchive.from_file(args.archive)
        ck_cfg, state = checkpoint.load(args.resume, device=dev)
        assert ck_cfg.grid_shape == cfg.grid_shape
        pipe.state = state
        anchor = checkpoint.load_anchor(args.resume)
        assert anchor is not None
        pipe.origin_vox = anchor
        start = args.start
        log(f"[{args.leg}] resumed at frame {start}, anchor {anchor}")
    else:
        pipe = ScrollingFiestaPipeline(
            cfg, method="scanline", archive=TileArchive(), device=dev)
        start = 0
    if args.ck_dir:
        os.makedirs(args.ck_dir, exist_ok=True)

    n_updates = 0
    checks = []
    t0 = time.perf_counter()
    for i in range(start, len(frames)):
        t, (pos, quat), scan = frames[i]
        pipe.observe_pose(t, pos, quat)
        pipe.observe_cloud(t, scan)
        if i + 1 < len(frames):
            pipe.observe_pose(frames[i + 1][0], *frames[i + 1][1])
        else:
            pipe.observe_pose(t + 1.0, pos, quat)
        pipe.process()
        stats = pipe.update()
        if stats is None:
            continue
        n_updates += 1
        if args.check_every and n_updates % args.check_every == 0:
            # C20 structural invariants: pass the derived closest so lazy
            # mode still faces the full closest-vs-d2 checks
            debug.check_consistency(cfg, pipe.state,
                                    closest=pipe.closest_grid())
            gt = debug.check_with_ground_truth(cfg, pipe.state)
            checks.append(dict(
                frame=i, num_known=gt["num_known"],
                rms=gt["rms_error"], max_under=gt["max_under"]))
            assert gt["max_under"] == 0.0, gt
            log(f"[{args.leg}] frame {i}: C20 ok "
                f"(known={gt['num_known']}, rms={gt['rms_error']:.4f}, "
                f"scrolls={pipe.scroll_count})")
        if args.ck_dir and n_updates % args.ck_every == 0:
            save_pair(pipe, cfg, args.ck_dir, i + 1)
    pipe.sync_device()
    wall = time.perf_counter() - t0

    # final C20 oracle
    debug.check_consistency(cfg, pipe.state, closest=pipe.closest_grid())
    gt = debug.check_with_ground_truth(cfg, pipe.state)

    final = {f: getattr(pipe.state, f).cpu().numpy()
             for f in ("logodds", "d2", "closest", "seen")}
    final["origin_vox"] = np.asarray(pipe.origin_vox)
    np.savez_compressed(args.out, **final)
    report = dict(
        leg=args.leg, device=(torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"),
        frames=len(frames) - start, updates=n_updates,
        wall_s=wall, ms_per_frame=1e3 * wall / max(len(frames) - start, 1),
        scrolls=pipe.scroll_count, restores=pipe.restore_count,
        archive_tiles=pipe.archive.num_tiles,
        final_known=gt["num_known"], final_rms=gt["rms_error"],
        final_max_under=gt["max_under"], c20_checks=len(checks) + 1,
    )
    print(json.dumps(report), flush=True)
    return 0


def frames_done(meta: str) -> int:
    """Frames through the last checkpoint pair a leg named, or -1."""
    try:
        with open(meta) as fh:
            return json.load(fh)["frames_done"]
    except FileNotFoundError:
        return -1


def drill(args):
    import numpy as np

    d = args.workdir or tempfile.mkdtemp(prefix="fiesta_soak_")
    os.makedirs(d, exist_ok=True)
    base = [sys.executable, os.path.abspath(__file__),
            "--frames", str(args.frames), "--scale", args.scale,
            "--platform", args.platform,
            "--check-every", str(args.check_every),
            "--ck-every", str(args.ck_every)]

    def leg(name, extra):
        cmd = base + ["--leg", name, "--out", f"{d}/final_{name}.npz"] + extra
        log(f"=== leg {name}: {' '.join(cmd)}")
        out = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                             check=True).stdout
        line = out.strip().splitlines()[-1]
        log(f"=== leg {name}: {line}")
        return json.loads(line)

    # 1) uninterrupted reference
    ref = leg("ref", ["--ck-dir", f"{d}/ref"])
    if ref["updates"] < 0.45 * args.frames + 2 * args.ck_every:
        raise SystemExit(f"{ref['updates']} updates leave no room to kill "
                         f"between checkpoints every {args.ck_every} "
                         "after 45 % of the run")

    # 2) victim: the same run, SIGKILLed mid-flight: half a checkpoint
    #    interval (at the reference's pace) after its first checkpoint
    #    past 45 % of the frames
    meta = f"{d}/victim/meta.json"
    target = int(0.45 * args.frames)
    delay = 0.5 * args.ck_every * ref["wall_s"] / ref["updates"]
    cmd = base + ["--leg", "victim", "--out", f"{d}/final_victim.npz",
                  "--ck-dir", f"{d}/victim"]
    log(f"=== leg victim: {' '.join(cmd)}")
    p = subprocess.Popen(cmd, stdout=subprocess.DEVNULL)
    try:
        while frames_done(meta) < target:
            if p.poll() is not None:
                raise SystemExit(f"victim ended (rc {p.returncode}) before "
                                 f"a checkpoint past frame {target}")
            time.sleep(0.01)
        time.sleep(delay)
        if p.poll() is not None:
            raise SystemExit("victim finished before the kill")
        p.send_signal(signal.SIGKILL)
    finally:
        if p.poll() is None:
            p.kill()
        p.wait()
    with open(meta) as fh:
        pair = json.load(fh)
    log(f"=== leg victim: SIGKILLed {delay:.2f} s after a checkpoint past "
        f"frame {target}; last pair through frame {pair['frames_done']}")

    # 3) resume from the victim's last checkpoint + archive pair
    res = leg("resume", ["--ck-dir", f"{d}/resume",
                         "--archive", pair["archive"],
                         "--resume", pair["ck"],
                         "--start", str(pair["frames_done"])])

    # 4) bit-exact equality with the uninterrupted run
    with np.load(f"{d}/final_ref.npz") as a, \
            np.load(f"{d}/final_resume.npz") as b:
        mismatches = [k for k in a.files
                      if a[k].tobytes() != b[k].tobytes()
                      or a[k].dtype != b[k].dtype]
    ok = not mismatches
    summary = dict(
        metric="soak_crash_resume_drill",
        frames=args.frames, scale=args.scale, platform=args.platform,
        ref=ref, resumed=res, killed_after_checkpoint_s=delay,
        resumed_from_frame=pair["frames_done"],
        bitexact_after_resume=ok, mismatched_fields=mismatches,
    )
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=1200)
    p.add_argument("--scale", choices=["small", "mid", "cow"],
                   default="mid")
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="cpu forces the small scale")
    p.add_argument("--check-every", type=int, default=150,
                   help="C20 oracle interval (updates)")
    p.add_argument("--ck-every", type=int, default=100,
                   help="checkpoint+archive save interval (updates)")
    p.add_argument("--workdir", help="drill files (default: a new "
                                     "temporary directory)")
    # internal leg interface
    p.add_argument("--leg", choices=["ref", "victim", "resume"])
    p.add_argument("--out")
    p.add_argument("--ck-dir")
    p.add_argument("--archive")
    p.add_argument("--resume")
    p.add_argument("--start", type=int, default=0)
    args = p.parse_args(argv)
    if args.platform == "cpu":
        args.scale = "small"
    if args.leg:
        return run_leg(args)
    return drill(args)


if __name__ == "__main__":
    sys.exit(main())
