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

Where the configuration's reference keeps the ESDF as state
(``keeps_esdf``: FIESTA's incremental map, whose distances are a
fixpoint that depends on the map's history and not on the occupancy
alone), the occupancy is checked as above, and the ESDF by following
the program's own map through a stretch of ``STRETCH_TICKS``
consecutive ticks (the run's last; ``chain``): from a copy of the
program's distances and closest grid before the stretch, the reference
applies each tick's inserts and deletes (from its own occupancy before
and after the tick) and sweeps plain Jacobi relaxations to the
fixpoint, tick after tick, each from the map the tick before left:

* ``d2``, ``closest``: voxels whose distance or closest entry differs
  from the program's map, summed over the maps after each tick of the
  stretch;
* ``sweeps``: replayed ticks whose sweep count differs from the
  program's (``stats`` then holds the sweeps of these ticks), those of
  the traced slice's first ticks (``relax_work``) among them;
* the last map's invariants: ``closest_occupied`` (entries that are not
  -1 or a voxel occupied in the reference's map), ``d2_consistent``
  (defined voxels whose distance is not the squared distance to their
  closest entry, undefined ones whose is not ``INF_D2``), ``fixpoint``
  (voxels that one more plain sweep changes), ``below_edt`` (voxels
  below the exact untruncated EDT of the reference's occupancy) and
  ``undefined`` (voxels undefined where that EDT is finite).

How far the fixpoint lies above the exact EDT (FIESTA's approximation)
is logged, with no limit.
"""

from __future__ import annotations

import dataclasses
import sys
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


#: the ticks that the check follows from the program's map, where the
#: reference keeps the ESDF; also those that ``relax_work`` counts
STRETCH_TICKS = 10


def keeps_esdf(ref) -> bool:
    """Whether the reference keeps the ESDF as state, so that the check
    follows the program's own map (``chain``)."""
    return bool(getattr(ref, "KEEPS_ESDF", False))


def esdf_copy(state, host: bool = False):
    """A copy of the program's (d2, closest), from which the check
    follows its map: on its device, or on the host (no device memory;
    the host waits for the device to reach it)."""
    if host:
        return (state.d2.to("cpu", copy=True),
                state.closest.to("cpu", copy=True))
    return state.d2.clone(), state.closest.clone()


def differing_ticks(ref_stats, stats):
    """Ticks [T] bool whose stats differ where the reference knows them
    (a negative entry: not known, as the sweeps of a tick it did not
    replay)."""
    return ((ref_stats != stats) & (ref_stats >= 0)).any(dim=1)


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


def compare(ref, cell, stream, program, obs=None, work=None):
    """The checks of one run and the reference's stats [T,4].
    ``program``: ``stats`` [T,4] (host ints, every tick), ``samples``
    {tick: ``Sample``} of the program's map after those ticks (the last
    tick among them), ``final`` (the program's last map, with its
    counters and closest grid) and, where the reference keeps the ESDF,
    ``stretch`` (first tick, (d2, closest) before it, [(d2, closest)]
    after each tick): the program's maps through its last
    ``STRETCH_TICKS`` ticks.  ``obs``: the reference's
    observations of the orbit, where already made.  ``work``: (first
    tick, ``relax_work``'s list), the traced slice's replayed ticks,
    whose sweeps are held too."""
    geo = ref.Geometry(cell.fields)
    n_ticks = program["stats"].shape[0]
    if obs is None:
        obs = observations(ref, geo, stream)
    stateful = keeps_esdf(ref)
    wanted = set(program["samples"])
    if stateful:
        first = program["stretch"][0]
        wanted |= set(range(first - 1, n_ticks))
    stats, m, snaps = replay(ref, geo, obs, n_ticks, wanted)
    reads = stream.reads is not None
    kept = keeps_closest(cell.fields)
    held = kept and not stateful     # a closest grid held to the exact EDT
    rd = read_reference(cell) if reads or held else None
    lo_diff = seen_diff = d2_diff = 0
    closest_diff = dist_diff = grad_diff = 0
    for t, s in sorted(program["samples"].items()):
        r_lo, r_seen = snaps[t]
        lo_diff += int((s.logodds.reshape(-1).view(torch.int32)
                        != r_lo.view(torch.int32)).sum())
        seen_diff += int((s.seen.reshape(-1) != r_seen).sum())
        if stateful:
            continue
        occ = (r_lo > geo.occ_thr).reshape(geo.grid)
        r_d2 = ref.edt_d2(occ, geo.trunc)
        d2_diff += int((s.d2 != r_d2).sum())
        if held:
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
    if stateful:
        esdf = _esdf_checks(ref, geo, program, snaps, m, stats, work)
    else:
        esdf = [Check("d2", d2_diff, 0)]
        if held:
            esdf.append(Check("closest", closest_diff, 0))
    stats_diff = int(differing_ticks(stats, program["stats"]).sum())
    final = program["final"]
    untouched = (final.hit_cnt != 0).sum() + (final.miss_cnt != 0).sum()
    if not kept:
        untouched += (final.closest != -1).sum()
    mapped = int(m.occupied().sum())
    checks = [Check("stats", stats_diff, 0), Check("logodds", lo_diff, 0),
              Check("seen", seen_diff, 0)] + esdf
    if reads:
        checks += [Check("query_dist", dist_diff, 0),
                   Check("query_grad", grad_diff, 0)]
    return checks + [
        Check("untouched", int(untouched), 0),
        Check("mapped", mapped, cell.traffic["min_occupied"], "min"),
    ], stats


def _esdf_checks(ref, geo, program, snaps, m, stats, work):
    """The incremental map's checks (see the module's docstring); writes
    the replayed ticks' sweeps into ``stats``, -1 (not known) elsewhere."""
    first, start, after = program["stretch"]
    d2_diff = closest_diff = 0
    sweeps = []
    for (d2, closest, n, _), (p_d2, p_closest) in zip(
            chain(ref, geo, snaps, first, len(after), start), after):
        d2_diff += int((p_d2 != d2).sum())
        closest_diff += int((p_closest != closest).any(dim=0).sum())
        sweeps.append(n)
        del d2, closest
    stats[:, 3] = -1
    stats[first:, 3] = torch.tensor(sweeps, dtype=torch.int64)
    if work is not None:
        w_first, counts = work
        stats[w_first:w_first + len(counts), 3] = torch.tensor(
            [c[0] for c in counts], dtype=torch.int64)
    known = stats[:, 3] >= 0
    sweep_diff = int((stats[known, 3] != program["stats"][known, 3]).sum())
    last = program["samples"][max(program["samples"])]
    inv = ref.invariants(geo, last.d2, last.closest, m.occupied())
    print(f"check: the last map's fixpoint lies above the exact EDT in "
          f"{inv['above_edt']} voxels, by at most {inv['excess_max']} "
          f"(squared voxels; FIESTA's approximation, no limit)",
          file=sys.stderr, flush=True)
    return [Check("d2", d2_diff, 0), Check("closest", closest_diff, 0),
            Check("sweeps", sweep_diff, 0)] + [
        Check(name, inv[name], 0) for name in (
            "closest_occupied", "d2_consistent", "fixpoint", "below_edt",
            "undefined")]


def chain(ref, geo, snaps, first: int, ticks: int, start):
    """The reference's incremental map through ``ticks`` ticks from tick
    ``first``, each from the map the tick before left, starting from
    ``start`` (d2, closest: the program's map before ``first``), with the
    occupancy before and after each tick from ``snaps`` (``replay``'s,
    from ``first - 1`` on).  Yields, after each tick, (d2, closest,
    sweeps, work): ``work`` as ``references/incremental.relax`` counts
    it (candidate pairs, voxels changed)."""
    dev = snaps[first][0].device
    d2, closest = (x.to(dev) for x in start)
    for t in range(first, first + ticks):
        occ_b = (snaps[t - 1][0] > geo.occ_thr).reshape(geo.grid)
        occ_a = (snaps[t][0] > geo.occ_thr).reshape(geo.grid)
        work = {}
        d2, closest, n = ref.update(geo, d2, closest, occ_b, occ_a,
                                    work=work)
        yield d2, closest, n, work


def relax_work(ref, geo, obs, first: int, start, ticks: int) -> list:
    """The relaxation's work in ``ticks`` ticks from tick ``first``, by
    the reference following the program's map from before ``first``
    (``start``: d2, closest) on its own occupancy: per tick (sweeps,
    candidate pairs, voxels changed)."""
    last = first + ticks
    _, _, snaps = replay(ref, geo, obs, last, set(range(first - 1, last)))
    return [(n, w["pairs"], w["changed"])
            for _, _, n, w in chain(ref, geo, snaps, first, ticks, start)]
