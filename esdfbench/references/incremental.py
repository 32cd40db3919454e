"""Plain reference of the incremental map tick (FIESTA's own algorithm:
``UpdateESDF``, ESDFMap.cpp:273-398, global update), in plain PyTorch.

It imports nothing of the program under test.  The occupancy half is
``rebuild.py``'s, run from its file beside this one: per scan the
scanline integrator's observations, per tick the fusion drain with its
counts of observed, inserted and deleted voxels.  The ESDF half is its
own, a copy of the semantics the port states:

* a tick's changes (``apply_changes``): an inserted voxel takes
  distance 0 and is its own closest obstacle; every voxel whose closest
  obstacle is no longer occupied (the bucket of a deleted obstacle)
  resets to ``INF_D2`` and undefined (-1);
* the relaxation (``relax``): Jacobi sweeps, each reading the map of
  the sweep before and writing a new one, in which every voxel pulls
  the candidate ``|v - closest[v + d]|^2`` from each neighbour ``d`` of
  the stencil (``connectivity`` 24: faces, edges and the faces two
  steps out) and of the long-range axis jumps (``accel_jumps``: +-4,
  +-8, ... voxels), every offset of reach 2 or less first, then the
  jumps, each group in table order; a candidate wins only when strictly
  smaller, so the first of equal candidates in that order decides; the
  sweeps go on until one lowers no distance, and that sweep is counted.

The check follows the program's own map through a stretch of ticks
with these (``update``), and holds the last map to invariants
(``invariants``) against the exact untruncated EDT (``exact_d2``).  Distances are
squared voxel counts (i32), closest entries int16 planes [3, X, Y, Z].
"""

from __future__ import annotations

import torch


def _sibling(name: str) -> dict:
    """The names that ``<name>.py`` beside this file defines, run from its
    file as plain Python."""
    path = __file__.rpartition("/")[0] + f"/{name}.py"
    namespace = {"__name__": f"esdfbench_reference_{name}",
                 "__file__": path}
    with open(path) as f:
        exec(compile(f.read(), path, "exec"), namespace)
    return namespace


_REBUILD = _sibling("rebuild")

# the occupancy half, as the check uses it
depth_rays = _REBUILD["depth_rays"]
local_window = _REBUILD["local_window"]
scan_boxes = _REBUILD["scan_boxes"]
tick_observations = _REBUILD["tick_observations"]
Map = _REBUILD["Map"]

#: the check replays ticks from the program's map (``check.keeps_esdf``)
KEEPS_ESDF = True
INF_D2 = _REBUILD["INF_D2"]      # the distance of an undefined voxel
UNDEFINED = -1
# the exact EDT's cap (rebuild.edt_d2's ``trunc``): 4095^2 lies below
# its "no obstacle" 2^24, so no distance within such a grid is cut
_EXACT_TRUNC = 4095

# FIESTA's 24-connectivity stencil (parameters.h), in the port's table
# order: the faces, the edges, the faces two steps out
STENCIL_24 = [
    (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1),
    (-1, -1, 0), (1, 1, 0), (0, -1, -1), (0, 1, 1), (-1, 0, -1), (1, 0, 1),
    (-1, 1, 0), (1, -1, 0), (0, -1, 1), (0, 1, -1), (1, 0, -1), (-1, 0, 1),
    (-2, 0, 0), (2, 0, 0), (0, -2, 0), (0, 2, 0), (0, 0, -2), (0, 0, 2)]


def jump_offsets(max_jump: int) -> list:
    """The long-range axis offsets +-4, +-8, ... +-``max_jump``: for each
    length, x then y then z, the negative first."""
    dirs, j = [], 4
    while j <= max_jump:
        for axis in range(3):
            for s in (-j, j):
                d = [0, 0, 0]
                d[axis] = s
                dirs.append(tuple(d))
        j *= 2
    return dirs


def relax_dirs(connectivity: int, accel_jumps: int, grid) -> list:
    """The offsets in the order a sweep considers them: the stencil's
    (reach 2 or less) in table order, then the jumps that fit inside the
    grid, in their order."""
    if connectivity != 24:
        raise ValueError(f"this reference covers connectivity 24, not "
                         f"{connectivity}")
    jumps = [d for d in jump_offsets(accel_jumps)
             if all(abs(o) < n for o, n in zip(d, grid))]
    return STENCIL_24 + jumps


def _regions(off, grid):
    """(receivers, sources): the index slices of the voxels v whose
    neighbour v + ``off`` lies in the grid, and of those neighbours; None
    where there are none."""
    recv = tuple(slice(max(0, -o), n - max(0, o)) for o, n in zip(off, grid))
    if any(r.start >= r.stop for r in recv):
        return None
    src = tuple(slice(r.start + o, r.stop + o) for r, o in zip(recv, off))
    return recv, src


class Geometry(_REBUILD["Geometry"]):
    """``rebuild.Geometry`` for an incremental map, with its relaxation's
    offsets (``dirs``, in consideration order)."""

    def __init__(self, fields: dict):
        if fields.get("esdf_mode") != "incremental":
            raise ValueError("this reference covers esdf_mode='incremental'")
        if not fields.get("global_update", True):
            raise ValueError("this reference covers the global update")
        super().__init__(dict(fields, esdf_mode="rebuild"))
        self.dirs = relax_dirs(int(fields["connectivity"]),
                               int(fields["accel_jumps"]), self.grid)
        if sum((n - 1) ** 2 for n in self.grid) > _EXACT_TRUNC ** 2:
            raise ValueError(f"grid {self.grid} too large for the exact EDT")
        self._degree = {}

    def axes(self, device, dtype=torch.int32):
        """Each axis's voxel coordinates, shaped to broadcast over the
        grid."""
        shapes = ((-1, 1, 1), (1, -1, 1), (1, 1, -1))
        return [torch.arange(n, dtype=dtype, device=device).reshape(s)
                for n, s in zip(self.grid, shapes)]

    def degree(self, device) -> torch.Tensor:
        """[X,Y,Z] i32: how many of each voxel's neighbours by ``dirs`` lie
        in the grid (by the offsets' symmetry, also how many voxels take a
        candidate from it)."""
        key = str(device)
        if key not in self._degree:
            deg = torch.zeros(self.grid, dtype=torch.int32, device=device)
            for off in self.dirs:
                found = _regions(off, self.grid)
                if found is not None:
                    deg[found[0]] += 1
            self._degree[key] = deg
        return self._degree[key]


def apply_changes(geo: Geometry, d2, closest, occupied, inserted):
    """A tick's inserts and deletes before the relaxation: (d2, closest,
    reset [X,Y,Z] bool).  ``occupied``: the occupancy after the tick;
    ``inserted``: the voxels that became occupied in it."""
    own = torch.stack([a.expand(geo.grid) for a in
                       geo.axes(d2.device, torch.int16)])
    d2 = torch.where(inserted, 0, d2)
    closest = torch.where(inserted[None], own, closest)
    defined = closest[0] >= 0
    c = closest.to(torch.int64)
    gx, gy, gz = geo.grid
    lin = torch.where(defined, (c[0] * gy + c[1]) * gz + c[2], 0)
    reset = defined & ~occupied.reshape(-1)[lin]
    d2 = torch.where(reset, INF_D2, d2)
    closest = torch.where(reset[None], UNDEFINED, closest)
    return d2, closest, reset


def sweep(geo: Geometry, d2, closest):
    """One Jacobi sweep: (d2, closest, lowered [X,Y,Z] bool), new tensors;
    every voxel takes the least candidate of its neighbours' closest
    entries in the sweep before, in ``geo.dirs`` order, where strictly
    below its distance."""
    best_d2, best_c = d2.clone(), closest.clone()
    axes = geo.axes(d2.device)
    for off in geo.dirs:
        found = _regions(off, geo.grid)
        if found is None:
            continue
        recv, src = found
        nb = closest[(slice(None),) + src]
        cand = 0
        for a in range(3):
            diff = axes[a].narrow(a, recv[a].start,
                                  recv[a].stop - recv[a].start) \
                - nb[a].to(torch.int32)
            cand = cand + diff * diff
        cur = best_d2[recv]
        better = (nb[0] >= 0) & (cand < cur)
        cur.copy_(torch.where(better, cand, cur))
        cc = best_c[(slice(None),) + recv]
        cc.copy_(torch.where(better[None], nb, cc))
    return best_d2, best_c, best_d2 < d2


def relax(geo: Geometry, d2, closest, seeds=None, work=None):
    """Sweeps until one lowers no distance, that sweep counted: (d2,
    closest, sweeps).  Where ``work`` (a dict) is given, it takes
    ``pairs``, the candidates the function's work needs: each in-grid
    neighbour pair of the first sweep's ``seeds`` (the tick's inserts
    and resets) and then of each sweep's lowered voxels, for the sweep
    after; and ``changed``, the voxels any sweep lowered."""
    sweeps, pairs = 0, 0
    if work is not None:
        deg = geo.degree(d2.device)
        front, touched = seeds, torch.zeros_like(seeds)
    while True:
        d2, closest, lowered = sweep(geo, d2, closest)
        sweeps += 1
        if work is not None:
            pairs += int(torch.where(front, deg, 0).sum(dtype=torch.int64))
            touched |= lowered
            front = lowered
        if not bool(lowered.any()):
            break
    if work is not None:
        work.update(pairs=pairs, changed=int(touched.sum()))
    return d2, closest, sweeps


def update(geo: Geometry, d2, closest, occ_before, occ_after, work=None):
    """One tick of the incremental map from (d2, closest) and the
    occupancy before and after the tick: its changes, then the
    relaxation to the fixpoint.  Returns (d2, closest, sweeps); ``work``
    as in ``relax``."""
    inserted = occ_after & ~occ_before
    d2, closest, reset = apply_changes(geo, d2, closest, occ_after, inserted)
    return relax(geo, d2, closest, seeds=inserted | reset, work=work)


def exact_d2(occupied) -> torch.Tensor:
    """The exact untruncated squared EDT [X,Y,Z] i32 of ``occupied``,
    ``INF_D2`` where nothing is occupied (``rebuild.edt_d2``, a different
    algorithm from the relaxation)."""
    return _REBUILD["edt_d2"](occupied, _EXACT_TRUNC)


def invariants(geo: Geometry, d2, closest, occupied) -> dict:
    """The counts of the last map's invariants (each has to be 0):
    ``closest_occupied``, ``d2_consistent``, ``fixpoint``, ``below_edt``,
    ``undefined`` (see ``check``'s docstring); and, logged with
    no limit, ``above_edt``, the voxels above the exact EDT, and
    ``excess_max``, the largest excess (squared voxels)."""
    defined = closest[0] >= 0
    c = closest.to(torch.int64)
    gx, gy, gz = geo.grid
    lin = torch.where(defined, (c[0] * gy + c[1]) * gz + c[2], 0)
    not_occ = defined & ~occupied.reshape(-1)[lin]
    dist = 0
    for a, axis in enumerate(geo.axes(d2.device)):
        diff = axis - closest[a].to(torch.int32)
        dist = dist + diff * diff
    wrong = torch.where(defined, d2 != dist, d2 != INF_D2)
    s_d2, s_c, _ = sweep(geo, d2, closest)
    moved = (s_d2 != d2) | (s_c != closest).any(dim=0)
    exact = exact_d2(occupied)
    excess = torch.where(defined, d2 - exact, 0)
    return {"closest_occupied": int(not_occ.sum()),
            "d2_consistent": int(wrong.sum()),
            "fixpoint": int(moved.sum()),
            "below_edt": int((d2 < exact).sum()),
            "undefined": int((~defined & (exact < INF_D2)).sum()),
            "above_edt": int((excess > 0).sum()),
            "excess_max": int(excess.max())}
