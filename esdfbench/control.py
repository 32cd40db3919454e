"""The control of the check: the plain reference put in the program's
place with its log-odds in bfloat16, the precision below the f32 that
the configuration states, judged by the same comparison as a run.  It
has to come out not correct.  Where the configuration keeps a closest
grid, the read's reference gives the control's closest grid from the
control's own map; where the mix reads the map, it gives the read of
that map in bfloat16 too (the read is f32 in the configuration): the
distance grid's values rounded, and the trilinear interpolation run in
bfloat16.  Where the reference keeps the ESDF as state (the incremental
map), the control's map before the check's stretch is the fixpoint that
the reference's relaxation reaches from an empty map on the control's
occupancy there, and its maps through the stretch that fixpoint
followed (``check.chain``) on the control's occupancy; a full replay of
every tick would take tens of minutes a seed at the cell's size.

    python3 -m esdfbench.control --workload <cell> --ticks <n> \
        --seeds <s> [<s> ...]

replays ``n`` ticks (as many as a run of the cell dispatches, warm orbit
included) for each seed, on the card, and prints one JSON line a seed
with each number compared.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import types

import torch

from esdfbench import check, generator, harness, spec


def control_outputs(ref, geo, obs, n_ticks: int, samples, cell, stream):
    """What the reference in bfloat16 gives in the program's place: the
    stats of every tick and its map after each sampled tick, with the
    closest grid and the read worked out from that map."""
    stateful = check.keeps_esdf(ref)
    first = n_ticks - check.STRETCH_TICKS
    wanted = set(samples) | (set(range(first - 1, n_ticks)) if stateful
                             else set())
    stats, m, snaps = check.replay(ref, geo, obs, n_ticks, wanted,
                                   torch.bfloat16)
    dev = obs[0].idx.device
    rd = check.read_reference(cell)
    kept = check.keeps_closest(cell.fields)
    none = torch.full(geo.grid, -1, dtype=torch.int32, device=dev)
    stretch = None
    if stateful:
        empty = (torch.full(geo.grid, ref.INF_D2, dtype=torch.int32,
                            device=dev),
                 torch.full((3,) + geo.grid, ref.UNDEFINED,
                            dtype=torch.int16, device=dev))
        occ = (snaps[first - 1][0] > geo.occ_thr).reshape(geo.grid)
        start = ref.update(geo, *empty, torch.zeros_like(occ), occ)[:2]
        maps = list(check.chain(ref, geo, snaps, first, n_ticks - first,
                                start))
        stats[first:, 3] = torch.tensor([n for _, _, n, _ in maps],
                                        dtype=torch.int64)
        stretch = (first, start, [(d2, c) for d2, c, _, _ in maps])
    out = {}
    for t in sorted(samples):
        lo, seen = snaps[t]
        occ = (lo > geo.occ_thr).reshape(geo.grid)
        if stateful:
            # only the last map's distances are compared
            d2, closest = stretch[2][-1] if t == n_ticks - 1 else (none,
                                                                  none)
        else:
            d2 = ref.edt_d2(occ, geo.trunc)
            closest = rd.closest_grid(geo, occ) if kept else none
        read = None
        if stream.reads is not None:
            j = t % stream.ticks_per_orbit
            samples, refine = stream.reads.at(j)
            grid = rd.distance_grid(geo, d2, seen)
            dist = rd.nearest(geo, grid, samples, torch.bfloat16)
            trilinear, grad = rd.trilinear(geo, grid, refine, torch.bfloat16)
            read = harness.Read(j, dist, trilinear, grad)
            del grid, samples, refine
        out[t] = check.Sample(lo.reshape(geo.grid), seen.reshape(geo.grid),
                              d2, closest, read)
    final = types.SimpleNamespace(
        hit_cnt=torch.zeros(geo.grid, dtype=torch.uint8, device=dev),
        miss_cnt=torch.zeros(geo.grid, dtype=torch.uint8, device=dev),
        closest=none)
    return {"stats": stats, "samples": out, "final": final,
            "stretch": stretch}


def readings(cell, seed: int, n_ticks: int, device):
    """The control's check on one seed: (checks, correct)."""
    ref = spec.reference(cell)
    geo = ref.Geometry(cell.fields)
    stream = generator.make_stream(cell.fields, cell.traffic, seed, device)
    obs = check.observations(ref, geo, stream)
    warm = cell.traffic["warm_orbits"] * stream.ticks_per_orbit
    every = cell.traffic["sample_every"]
    samples = set(range(warm + int(seed) % every, n_ticks, every)) | \
        {n_ticks - 1}
    program = control_outputs(ref, geo, obs, n_ticks, samples, cell, stream)
    checks, _ = check.compare(ref, cell, stream, program, obs=obs)
    return checks, all(c.ok for c in checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--ticks", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        checks, ok = readings(cell, seed, args.ticks, device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "ticks": args.ticks, "correct": ok,
                          "checks": {c.name: c.entry() for c in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
