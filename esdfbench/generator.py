"""The sensor stream of a traffic mix, generated on the card from a seed.

A copy, in PyTorch, of the synthetic scene of ``fiesta_tpu_torch``'s
``io/replay.py`` (itself the JAX package's): a walled room of boxes, a
sensor flying a closed circular orbit with its camera looking outward,
and exact ray-box depth rendering by the slab test.  One orbit of frames
is rendered once; the run cycles through it, a tick taking
``scans_per_tick`` consecutive frames.

The traffic file gives every parameter (image size, rate, orbit, box
count, placement and sizes).  The seed draws only the boxes (and the
planner's queries, below), so every seed gives the same amount of work: the same image size, frames, ticks
and orbit, another scene.

A mix with a ``reads`` object also has the planner read the map after
every tick, as the port's sampling MPC (``planning/mpc.py``) reads it
each solve: the distance grid once, the distance at every sample of the
sampling stage (``rollouts`` control sequences over ``horizon`` steps,
rolled out from rest at the tick's sensor position), and the trilinear
distance with its gradient along ``refine_steps`` + 1 trajectories of
the refinement (each Adam step's gradient, then the final cost).  The
displacements are drawn once from the seed on the device, as the
planner draws its controls (standard normals times ``sigma``, clipped
to ``a_max``; velocities clipped to ``v_max``, steps of ``dt``); each
tick reads them at its own sensor position.  The seed draws their
places, never their number.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Stream:
    """One orbit of frames on the device.

    ``transforms`` [F,4,4] f32 sensor-to-world, ``positions`` [F,3] f32;
    ``depths`` [F,H,W] f32 metres (NaN where nothing is hit) for depth
    input, ``points`` [F,H*W,3] f32 sensor-frame and ``valid`` [F,H*W]
    bool for point clouds.  ``boxes`` [B,2,3] f64 on the host.
    ``reads`` (``Reads``): the planner's queries after each tick, where
    the mix reads the map."""

    kind: str
    height: int
    width: int
    scans_per_tick: int
    transforms: torch.Tensor
    positions: torch.Tensor
    boxes: np.ndarray
    depths: torch.Tensor = None
    points: torch.Tensor = None
    valid: torch.Tensor = None
    reads: "Reads" = None

    @property
    def frames(self) -> int:
        return self.transforms.shape[0]

    @property
    def ticks_per_orbit(self) -> int:
        return self.frames // self.scans_per_tick


def _seed_words(seed: int) -> int:
    """Any whole number (also negative, or past 64 bits) as numpy's seed."""
    return int(seed) % (1 << 64)


def make_boxes(fields: dict, traffic: dict, seed: int) -> np.ndarray:
    """Walls, floor and ``count`` random boxes [B,2,3] (min, max corners)
    inside the map, drawn from ``seed``.  Box centres lie uniformly in the
    map, or in the ``focus`` annulus around its centre; a box is redrawn
    when its centre lies within ``keep_clear`` of the map's vertical axis
    or its footprint within ``orbit_clearance`` of the sensor's orbit."""
    spec = traffic["boxes"]
    rng = np.random.default_rng(_seed_words(seed))
    lo = np.asarray(fields["origin"], np.float64)
    size = np.asarray(fields["map_size"], np.float64)
    hi = lo + size
    center = lo + size / 2
    boxes = []
    if spec["walls"]:
        m, th = spec["room_margin"], spec["wall_thickness"]
        boxes += [
            ((lo[0] + m, lo[1] + m, lo[2] + m),
             (hi[0] - m, hi[1] - m, lo[2] + m + th)),            # floor
            ((lo[0] + m, lo[1] + m, lo[2] + m),
             (lo[0] + m + th, hi[1] - m, hi[2] - m)),            # -x wall
            ((hi[0] - m - th, lo[1] + m, lo[2] + m),
             (hi[0] - m, hi[1] - m, hi[2] - m)),                 # +x wall
            ((lo[0] + m, lo[1] + m, lo[2] + m),
             (hi[0] - m, lo[1] + m + th, hi[2] - m)),            # -y wall
            ((lo[0] + m, hi[1] - m - th, lo[2] + m),
             (hi[0] - m, hi[1] - m, hi[2] - m)),                 # +y wall
        ]
    radius = traffic["orbit"]["radius"]
    clear = spec["orbit_clearance"]
    ext_lo, ext_hi = spec["extent"]
    focus = spec.get("focus")
    want = len(boxes) + spec["count"]
    for _ in range(1000 * want):
        if len(boxes) == want:
            break
        if focus is not None:
            r = math.sqrt(rng.uniform(focus[0] ** 2, focus[1] ** 2))
            th = rng.uniform(0, 2 * math.pi)
            c = np.array([center[0] + r * math.cos(th),
                          center[1] + r * math.sin(th),
                          lo[2] + rng.random() * size[2]])
            c = np.clip(c, lo + 0.1, hi - 0.1)
        else:
            c = lo + rng.random(3) * size
        ext = rng.uniform(ext_lo, ext_hi, size=3)
        if np.linalg.norm(c[:2] - center[:2]) < spec["keep_clear"]:
            continue
        bmin = np.maximum(c - ext / 2, lo + 0.05)
        bmax = np.minimum(c + ext / 2, hi - 0.05)
        if not np.all(bmax > bmin):
            continue
        # the footprint's nearest and farthest distance from the axis
        near = np.clip(center[:2], bmin[:2], bmax[:2]) - center[:2]
        far = np.maximum(np.abs(bmin[:2] - center[:2]),
                         np.abs(bmax[:2] - center[:2]))
        if np.linalg.norm(near) - clear <= radius <= \
                np.linalg.norm(far) + clear:
            continue
        boxes.append((tuple(bmin), tuple(bmax)))
    if len(boxes) != want:
        raise ValueError(f"could not place {spec['count']} boxes")
    return np.asarray(boxes, np.float64)


def orbit(fields: dict, traffic: dict):
    """Sensor poses of one closed orbit: rotations [F,3,3] and positions
    [F,3] (f64, host), camera z forward (outward), x right, y down."""
    spec = traffic["orbit"]
    frames = int(round(spec["period_s"] * traffic["rate_hz"]))
    center = (np.asarray(fields["origin"], np.float64)
              + np.asarray(fields["map_size"], np.float64) / 2)
    ang = 2 * np.pi * np.arange(frames) / frames
    fwd = np.stack([np.cos(ang), np.sin(ang), np.zeros(frames)], 1)
    down = np.array([0.0, 0.0, -1.0])
    x_axis = np.cross(down[None], fwd)
    x_axis /= np.linalg.norm(x_axis, axis=1, keepdims=True)
    y_axis = np.cross(fwd, x_axis)
    rot = np.stack([x_axis, y_axis, fwd], axis=2)
    pos = np.stack([center[0] + spec["radius"] * np.cos(ang),
                    center[1] + spec["radius"] * np.sin(ang),
                    np.full(frames, spec["z"])], 1)
    return rot, pos


def render_depths(fields: dict, boxes: np.ndarray, rot: np.ndarray,
                  pos: np.ndarray, height: int, width: int,
                  max_depth: float, device, chunk: int = 24) -> torch.Tensor:
    """Pinhole depth images [F,H,W] f32 (NaN beyond ``max_depth`` or
    where no box is hit): the nearest slab-test entry along each pixel's
    ray, in f64 on the device, as z depth."""
    f64 = torch.float64
    cx, cy = fields["center_x"], fields["center_y"]
    fx, fy = fields["focal_x"], fields["focal_y"]
    u = (torch.arange(width, dtype=f64, device=device) - cx) / fx
    v = (torch.arange(height, dtype=f64, device=device) - cy) / fy
    uu, vv = torch.meshgrid(u, v, indexing="xy")           # [H,W]
    norm = torch.sqrt(uu * uu + vv * vv + 1.0)
    cam = [c.reshape(-1) / norm.reshape(-1) for c in (uu, vv,
                                                       torch.ones_like(uu))]
    bmin = torch.as_tensor(boxes[:, 0], dtype=f64, device=device)
    bmax = torch.as_tensor(boxes[:, 1], dtype=f64, device=device)
    rot_t = torch.as_tensor(rot, dtype=f64, device=device)
    pos_t = torch.as_tensor(pos, dtype=f64, device=device)
    out = torch.empty((rot.shape[0], height * width), dtype=torch.float32,
                      device=device)
    for s in range(0, rot.shape[0], chunk):
        r, o = rot_t[s:s + chunk], pos_t[s:s + chunk]
        dirs = [cam[0][None] * r[:, i, 0, None] + cam[1][None] * r[:, i, 1,
                None] + cam[2][None] * r[:, i, 2, None] for i in range(3)]
        inv = [1.0 / torch.where(d.abs() < 1e-12, 1e-12, d) for d in dirs]
        best = torch.full(dirs[0].shape, math.inf, dtype=f64, device=device)
        for b in range(boxes.shape[0]):
            tmin = torch.full_like(best, -math.inf)
            tmax = torch.full_like(best, math.inf)
            for i in range(3):
                t0 = (bmin[b, i] - o[:, i, None]) * inv[i]
                t1 = (bmax[b, i] - o[:, i, None]) * inv[i]
                tmin = torch.maximum(tmin, torch.minimum(t0, t1))
                tmax = torch.minimum(tmax, torch.maximum(t0, t1))
            hit = (tmax >= tmin) & (tmax > 0)
            best = torch.minimum(best, torch.where(
                hit, torch.clamp(tmin, min=0.0), math.inf))
        depth = best / norm.reshape(-1)[None]
        depth = torch.where(torch.isfinite(best) & (best <= max_depth),
                            depth, math.nan)
        out[s:s + chunk] = depth.to(torch.float32)
    return out.reshape(rot.shape[0], height, width)


def tick_positions(stream: Stream) -> torch.Tensor:
    """The sensor position [T,3] at the end of each tick of the orbit (its
    last frame's), where the tick's local window and reads centre."""
    k = stream.scans_per_tick
    return stream.positions[k - 1::k][:stream.ticks_per_orbit]


@dataclasses.dataclass
class Reads:
    """The planner's queries, as displacements from the tick's sensor
    position ``poses`` [T,3] f32: ``samples`` [H,K,3] f32, the sampling
    stage's rollouts (read for the distance at each), and ``refine``
    [R,H,3] f32, the refinement's trajectories (read for the trilinear
    distance and gradient)."""

    poses: torch.Tensor
    samples: torch.Tensor
    refine: torch.Tensor

    def at(self, tick: int):
        """(samples [H,K,3], refine [R,H,3]) world positions f32 of the
        orbit's tick ``tick``."""
        p = self.poses[tick]
        return p + self.samples, p + self.refine


def make_reads(spec: dict, poses: torch.Tensor, seed: int) -> Reads:
    """The planner's queries of a mix's ``reads`` on the device of
    ``poses`` [T,3]: ``rollouts`` control sequences of ``horizon`` steps
    drawn from the seed (standard normals [H,3,K] times ``sigma``, clipped
    to ``a_max``) and rolled out from rest (velocity clipped to ``v_max``,
    steps of ``dt``); the refinement's ``refine_steps`` + 1 trajectories
    are the first of them."""
    dev = poses.device
    h, k = int(spec["horizon"]), int(spec["rollouts"])
    r = int(spec["refine_steps"]) + 1
    dt, v_max = float(spec["dt"]), float(spec["v_max"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(_seed_words(seed))
    normals = torch.randn((h, 3, k), generator=gen, dtype=torch.float32,
                          device=dev)
    accel = torch.clamp(normals * float(spec["sigma"]),
                        -float(spec["a_max"]), float(spec["a_max"]))
    v = torch.zeros((3, k), dtype=torch.float32, device=dev)
    p = torch.zeros_like(v)
    path = []
    for a in accel:
        v = torch.clamp(v + a * dt, -v_max, v_max)
        p = p + v * dt
        path.append(p)
    samples = torch.stack(path).movedim(1, -1).contiguous()     # [H,K,3]
    refine = samples[:, :r].movedim(1, 0).contiguous()          # [R,H,3]
    return Reads(poses=poses.contiguous(), samples=samples, refine=refine)


def make_stream(fields: dict, traffic: dict, seed: int, device) -> Stream:
    """One orbit of the traffic mix's frames for ``seed``, on ``device``."""
    h, w = traffic["height"], traffic["width"]
    boxes = make_boxes(fields, traffic, seed)
    rot, pos = orbit(fields, traffic)
    k = traffic["scans_per_tick"]
    if rot.shape[0] % k:
        raise ValueError(f"an orbit of {rot.shape[0]} frames does not split "
                         f"into ticks of {k}")
    tf = np.zeros((rot.shape[0], 4, 4))
    tf[:, :3, :3] = rot
    tf[:, :3, 3] = pos
    tf[:, 3, 3] = 1.0
    depths = render_depths(fields, boxes, rot, pos, h, w,
                           traffic["max_depth"], device)
    stream = Stream(
        kind=traffic["input"], height=h, width=w, scans_per_tick=k,
        transforms=torch.as_tensor(tf, dtype=torch.float32, device=device),
        positions=torch.as_tensor(pos, dtype=torch.float32, device=device),
        boxes=boxes)
    if stream.kind == "depth":
        stream.depths = depths
    elif stream.kind == "cloud":
        cx, cy = fields["center_x"], fields["center_y"]
        fx = torch.full((), fields["focal_x"], dtype=torch.float32,
                        device=device)
        fy = torch.full((), fields["focal_y"], dtype=torch.float32,
                        device=device)
        u = torch.arange(w, dtype=torch.float32, device=device)[None, None]
        v = torch.arange(h, dtype=torch.float32, device=device)[None, :,
                                                                 None]
        x = (u - cx) * depths / fx
        y = (v - cy) * depths / fy
        stream.points = torch.stack([x, y, depths], dim=-1).reshape(
            rot.shape[0], h * w, 3)
        stream.valid = torch.isfinite(stream.points).all(dim=-1)
        del depths
    else:
        raise ValueError(f"unknown input {stream.kind!r}: cloud or depth")
    if traffic.get("reads") is not None:
        stream.reads = make_reads(traffic["reads"], tick_positions(stream),
                                  seed)
    return stream
