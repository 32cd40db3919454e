"""The comparison that decides ``correct``.

The plain reference replays every tick the program ran (the warm orbit,
the window and, in a traced run, the traced slice), from the same scans
and poses, and the program's outputs are held against it:

* ``stats``: ticks whose ``UpdateStats`` (voxels observed, inserted,
  deleted; sweeps) differ, over every tick;
* ``logodds``, ``seen``, ``d2``: voxels that differ (log-odds bit for
  bit) in the map after the last tick and after each sampled tick, the
  sample drawn from the seed;
* ``untouched``: counters left non-zero after the last drain, and, on a
  map whose configuration keeps no closest grid in its state (lazy
  closest, or none tracked), closest entries written there;
* ``mapped``: occupied voxels of the reference's last map, which has to
  reach the traffic mix's ``min_occupied``, so that a scene that maps
  nothing cannot pass.

Where a closest grid is kept (eager closest: ``state.closest``), and
where the mix reads the map, the same sampled maps are held to the
read's reference (``references/read.py``), built on the reference's own
map:

* ``closest``: voxels whose closest entry is not a voxel occupied in the
  reference's map at its exact squared distance, or not -1 exactly where
  that distance lies beyond the truncation (whatever the tie-break);
* ``query_dist``: sample positions whose distance (the nearest voxel's)
  differs, bit for bit, from the reference's;
* ``query_grad``: refinement positions whose trilinear distance or
  gradient differs, bit for bit, from the reference's.

Each difference's limit is 0: the reference computes the program's f32
arithmetic op for op and an exact EDT, so a correct program agrees bit
for bit, and the control (the same reference with its log-odds in
bfloat16) differs in millions of voxels.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import spec

#: the read's reference, ``references/<READ_REFERENCE>.py``
READ_REFERENCE = "read"


class Sample(NamedTuple):
    """A map after one tick: log-odds, seen, d2, the state's closest grid,
    and the tick's read (``harness.Read``) where the mix reads the map."""

    logodds: torch.Tensor
    seen: torch.Tensor
    d2: torch.Tensor
    closest: torch.Tensor
    read: Optional[object] = None


def sample(state, read=None) -> Sample:
    """The parts of a map state (and its read) that the check compares."""
    return Sample(state.logodds, state.seen, state.d2, state.closest, read)


def keeps_closest(fields: dict) -> bool:
    """Whether the configuration's tick writes a closest grid into the
    state: closest tracked, and not deferred to the query surface."""
    return bool(fields.get("track_closest", True)) and \
        fields.get("closest_mode", "lazy") != "lazy"


@dataclasses.dataclass
class Check:
    name: str
    value: int
    limit: int
    kind: str = "max"        # "max": value <= limit; "min": value >= limit

    @property
    def ok(self) -> bool:
        return self.value <= self.limit if self.kind == "max" \
            else self.value >= self.limit

    def line(self) -> str:
        rel = "<=" if self.kind == "max" else ">="
        return f"check {self.name} {self.value} {rel} {self.limit}"

    def entry(self) -> dict:
        return {"value": self.value, self.kind: self.limit}


def observations(ref, geo, stream, chunk_ticks: int = 20):
    """The reference's observations of each distinct tick of the orbit."""
    k = stream.scans_per_tick
    n_ticks = stream.ticks_per_orbit
    out = []
    for t0 in range(0, n_ticks, chunk_ticks):
        ticks = range(t0, min(n_ticks, t0 + chunk_ticks))
        frames = list(range(ticks[0] * k, (ticks[-1] + 1) * k))
        tf = stream.transforms[frames]
        if stream.kind == "cloud":
            pts = stream.points[frames]
            px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
            valid = stream.valid[frames]
        else:
            comps = [ref.depth_rays(
                geo, stream.depths[f], stream.transforms[f],
                stream.depths[f - 1], stream.transforms[f - 1])
                for f in frames]     # frame -1 is the orbit's last
            px, py, pz, valid = (torch.stack([c[i].reshape(-1)
                                              for c in comps])
                                 for i in range(4))
        windows = None
        if not geo.global_update:
            wins = [ref.local_window(geo, stream.positions[(t + 1) * k - 1])
                    for t in ticks]
            windows = tuple(torch.stack([w[i] for w in wins])
                            .repeat_interleave(k, 0) for i in range(2))
        starts, hits, misses = ref.scan_boxes(geo, px, py, pz, valid, tf,
                                              windows)
        for i, _ in enumerate(ticks):
            sl = slice(i * k, (i + 1) * k)
            out.append(ref.tick_observations(geo, starts[sl], hits[sl],
                                             misses[sl]))
        del starts, hits, misses, px, py, pz, valid
    return out


def replay(ref, geo, obs, n_ticks: int, sample_ticks, dtype=torch.float32):
    """Drain ``n_ticks`` ticks (cycling through ``obs``).  Returns (stats
    [n_ticks, 4] i64 on the host, the map, {tick: (log-odds f32, seen)}
    after each tick of ``sample_ticks``)."""
    dev = obs[0].idx.device
    m = ref.Map(geo, dev, dtype)
    counts = torch.zeros((n_ticks, 2), dtype=torch.int64, device=dev)
    observed = []
    snaps = {}
    for t in range(n_ticks):
        n_obs, n_ins, n_del = m.drain(obs[t % len(obs)])
        observed.append(n_obs)
        counts[t, 0] = n_ins
        counts[t, 1] = n_del
        if t in sample_ticks:
            snaps[t] = (m.logodds.to(torch.float32).clone(), m.seen.clone())
    stats = torch.zeros((n_ticks, 4), dtype=torch.int64)
    stats[:, 0] = torch.tensor(observed, dtype=torch.int64)
    stats[:, 1:3] = counts.cpu()
    return stats, m, snaps


def read_reference(cell):
    """The read's reference module (``references/read.py``)."""
    return spec.load_module(
        cell.bench_dir / "references" / f"{READ_REFERENCE}.py",
        f"esdfbench_reference_{READ_REFERENCE}")


def compare(ref, cell, stream, program, obs=None):
    """The checks of one run and the reference's stats [T,4].
    ``program``: ``stats`` [T,4] (host ints, every tick), ``samples``
    {tick: ``Sample``} of the program's map after those ticks (the last
    tick among them), ``final`` (the program's last map, with its
    counters and closest grid).  ``obs``: the reference's observations of
    the orbit, where already made."""
    geo = ref.Geometry(cell.fields)
    n_ticks = program["stats"].shape[0]
    if obs is None:
        obs = observations(ref, geo, stream)
    stats, m, snaps = replay(ref, geo, obs, n_ticks,
                             set(program["samples"]))
    stats_diff = int((stats != program["stats"]).any(dim=1).sum())
    reads = stream.reads is not None
    kept = keeps_closest(cell.fields)
    rd = read_reference(cell) if reads or kept else None
    lo_diff = seen_diff = d2_diff = 0
    closest_diff = dist_diff = grad_diff = 0
    for t, s in sorted(program["samples"].items()):
        r_lo, r_seen = snaps[t]
        lo_diff += int((s.logodds.reshape(-1).view(torch.int32)
                        != r_lo.view(torch.int32)).sum())
        seen_diff += int((s.seen.reshape(-1) != r_seen).sum())
        occ = (r_lo > geo.occ_thr).reshape(geo.grid)
        r_d2 = ref.edt_d2(occ, geo.trunc)
        d2_diff += int((s.d2 != r_d2).sum())
        if kept:
            closest_diff += rd.closest_errors(geo, s.closest, occ, r_d2)
        if reads:
            r = s.read
            samples, refine = stream.reads.at(r.orbit_tick)
            dist = rd.distance_grid(geo, r_d2, r_seen)
            dist_diff += rd.nearest_errors(geo, r.dist, dist, samples)
            grad_diff += rd.trilinear_errors(geo, r.trilinear, r.grad, dist,
                                             refine)
            del dist, samples, refine
        del r_lo, r_seen, occ, r_d2
    final = program["final"]
    untouched = (final.hit_cnt != 0).sum() + (final.miss_cnt != 0).sum()
    if not kept:
        untouched += (final.closest != -1).sum()
    mapped = int(m.occupied().sum())
    checks = [
        Check("stats", stats_diff, 0), Check("logodds", lo_diff, 0),
        Check("seen", seen_diff, 0), Check("d2", d2_diff, 0)]
    if kept:
        checks.append(Check("closest", closest_diff, 0))
    if reads:
        checks += [Check("query_dist", dist_diff, 0),
                   Check("query_grad", grad_diff, 0)]
    return checks + [
        Check("untouched", int(untouched), 0),
        Check("mapped", mapped, cell.traffic["min_occupied"], "min"),
    ], stats
