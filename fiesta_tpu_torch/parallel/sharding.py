"""Multi-device X-slab sharding of the ESDF grid (port of
``fiesta_tpu/parallel/sharding.py``).

The grid is cut into X-slabs over a one-axis mesh (axis ``"x"``), one slab
a shard, each on its shard's device:

  * fusion and masking are elementwise: each shard works on its slab;
  * the mapping tick shards its scans too: each shard splats and carves
    only its own scans, and the per-scan counter boxes are all-gathered;
  * the EDT's first pass along x composes across shards through log-hop
    edge planes (``_compose_l1_x``), the closest transform's split pass
    reads a multi-hop halo (``_halo_planes_x``), the incremental
    relaxation exchanges halo planes on every sweep;
  * the only reductions are the tick's three counts and the relaxation's
    change flags.

JAX's ``shard_map`` is one program over every slab.  Here one process
drives the shards it holds as per-shard lists of tensors, and the
collectives are methods of ``Mesh`` on such lists: ``shift`` (JAX's
``ppermute`` by k shards, a fill where no shard sends), ``psum`` /
``pmin`` / ``pmax``, the tiled ``all_gather`` and ``x0s`` (each shard's
``axis_index`` times the slab width).  An in-process mesh holds every
shard: on distinct cards its collectives are peer copies ordered against
both devices' streams; on a virtual mesh (several shards on one device,
as JAX's tests put shards on virtual CPU devices) they are copies on that
device.  ``distributed_mesh`` holds one shard a process and runs the same
collectives through ``torch.distributed`` (NCCL on cards, gloo on the
CPU).

Results are bit-equal to the single-device engine's and to the JAX
package's sharded engine: every per-slab kernel is the single-device one
at slab shapes, with global coordinates where a slab needs them (the
relax kernel's and the box add's x origin, the drain's window, the
closest payload).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence

import torch

from ..config import FiestaConfig
from ..grid import (FIELDS, INF_D2, UNDEFINED_COORD, Device, MapState,
                    closest_packed_state, local_window, occupied_grid,
                    pack_closest, resolve_device, sqrt_f32)
from ..ops import edt, esdf, fusion, query, raycast

#: collective calls by kind, across every mesh: "ppermute", "psum",
#: "all_gather", and "host_sync" (the relaxation's per-sweep read of its
#: change flags); "nccl" / "gloo" count the calls that went through
#: ``torch.distributed`` on that backend
COLLECTIVES: collections.Counter = collections.Counter()
#: bytes the collectives delivered, by the same kinds ("ppermute", "psum",
#: "all_gather"): for each shard that receives a result, that result's
#: bytes (a shift's fill, which no shard sends, counts nothing), summed
#: over shards; under ``torch.distributed`` each process counts its own
#: shard, and the processes' counts sum to the in-process mesh's
COLLECTIVE_BYTES: collections.Counter = collections.Counter()

Shards = List[torch.Tensor]


def _stencil_reach(dirs) -> int:
    """Halo width: the stencil's largest per-axis reach (2 for the
    reference's 24-stencil, 3 for the 62-stencil)."""
    return max(abs(int(c)) for off in dirs for c in off)


def _device(d: Device) -> torch.device:
    """A shard's device, with the CUDA index made explicit."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``: ``x`` itself where it lies there, else a copy.
    Between two cards the peer copy is ordered against both devices'
    current streams, so that it reads ``x`` after its producer and its
    consumers on ``dev`` read it after it lands."""
    if x.device == dev:
        return x
    if x.is_cuda and dev.type == "cuda":
        src = torch.cuda.current_stream(x.device)
        dst = torch.cuda.current_stream(dev)
        dst.wait_stream(src)
        y = x.to(dev, non_blocking=True)
        dst.wait_stream(src)
        src.wait_stream(dst)
        return y
    return x.to(dev)


class Mesh:
    """A one-axis mesh (axis name ``"x"``) of ``size`` shards; this
    process holds the shards ``local`` (every one in-process, its rank's
    under ``torch.distributed``) on ``devices`` (one per local shard)."""

    axis_names = ("x",)

    def __init__(self, devices: Sequence[Device],
                 distributed: bool = False, rank: int = 0,
                 world_size: Optional[int] = None):
        self.devices = tuple(_device(d) for d in devices)
        self.distributed = distributed
        if distributed:
            if len(self.devices) != 1:
                raise ValueError("a distributed mesh holds one shard a "
                                 "process")
            self.size = int(world_size)
            self.local = (int(rank),)
        else:
            self.size = len(self.devices)
            self.local = tuple(range(self.size))
        if self.size < 1:
            raise ValueError("a mesh needs at least one shard")

    def __repr__(self):
        where = (f"rank {self.local[0]} of {self.size}" if self.distributed
                 else ", ".join(str(d) for d in self.devices))
        return f"Mesh(x={self.size}: {where})"

    def x0s(self, lx: int) -> List[int]:
        """Each local shard's first global x plane (``axis_index * lx``)."""
        return [i * lx for i in self.local]

    def sync(self) -> None:
        """Wait for the work queued on every local card."""
        for d in set(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- collectives on per-local-shard lists --------------------------------

    def shift(self, xs: Shards, k: int, fill=None) -> list:
        """JAX's ``ppermute`` by ``k`` shards: shard i receives shard
        i - k's tensor (k < 0: shard i + |k|'s).  A shard with no such
        partner gets a tensor of ``fill`` shaped like its own, or None
        when ``fill`` is None."""
        COLLECTIVES["ppermute"] += 1
        n = self.size
        if not self.distributed:
            out = []
            for j, i in enumerate(self.local):
                if 0 <= i - k < n:
                    out.append(_to(xs[i - k], self.devices[j]))
                    COLLECTIVE_BYTES["ppermute"] += _nbytes(xs[i - k])
                else:
                    out.append(None if fill is None
                               else torch.full_like(xs[j], fill))
            return out
        import torch.distributed as dist

        i, x = self.local[0], xs[0]
        ops, recv = [], None
        if 0 <= i + k < n:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), i + k))
        if 0 <= i - k < n:
            recv = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            ops.append(dist.P2POp(dist.irecv, recv, i - k))
        if ops:
            COLLECTIVES[dist.get_backend()] += 1
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if recv is not None:
            COLLECTIVE_BYTES["ppermute"] += _nbytes(recv)
        if recv is None and fill is not None:
            recv = torch.full_like(x, fill)
        return [recv]

    def _reduce(self, xs: Shards, kind: str) -> Shards:
        COLLECTIVES["psum"] += 1
        if not self.distributed:
            dev0 = self.devices[0]
            acc = _to(xs[0], dev0)
            for x in xs[1:]:
                x = _to(x, dev0)
                acc = (acc + x if kind == "sum" else
                       torch.minimum(acc, x) if kind == "min" else
                       torch.maximum(acc, x))
            COLLECTIVE_BYTES["psum"] += len(self.devices) * _nbytes(acc)
            return [_to(acc, d) for d in self.devices]
        import torch.distributed as dist

        op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
              "max": dist.ReduceOp.MAX}[kind]
        y = xs[0].clone()
        COLLECTIVES[dist.get_backend()] += 1
        dist.all_reduce(y, op=op)
        COLLECTIVE_BYTES["psum"] += _nbytes(y)
        return [y]

    def psum(self, xs: Shards) -> Shards:
        """Sum over shards (JAX's ``psum``), on every local shard."""
        return self._reduce(xs, "sum")

    def pmin(self, xs: Shards) -> Shards:
        return self._reduce(xs, "min")

    def pmax(self, xs: Shards) -> Shards:
        return self._reduce(xs, "max")

    def all_gather(self, xs: Shards) -> Shards:
        """Tiled ``all_gather`` along axis 0: every local shard gets the
        shards' tensors concatenated in shard order (one tensor a device)."""
        COLLECTIVES["all_gather"] += 1
        if not self.distributed:
            full = {self.devices[0]: torch.cat(
                [_to(x, self.devices[0]) for x in xs])}
            for d in self.devices:
                if d not in full:
                    full[d] = _to(full[self.devices[0]], d)
            COLLECTIVE_BYTES["all_gather"] += \
                len(self.devices) * _nbytes(full[self.devices[0]])
            return [full[d] for d in self.devices]
        import torch.distributed as dist

        x = xs[0].contiguous()
        as_u8 = x.dtype == torch.bool
        if as_u8:
            x = x.view(torch.uint8)
        out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        COLLECTIVES[dist.get_backend()] += 1
        dist.all_gather_into_tensor(out, x)
        COLLECTIVE_BYTES["all_gather"] += _nbytes(out)
        return [out.view(torch.bool) if as_u8 else out]


def make_mesh(n_devices: int, devices: Optional[Sequence[Device]] = None
              ) -> Mesh:
    """A one-axis mesh of ``n_devices`` shards on ``devices``: by default
    the distinct cards ``cuda:0 ... cuda:n-1`` (refused when fewer are
    visible); ``[torch.device("cuda")] * n`` (or ``"cpu"``) is a virtual
    mesh of n shards on one device."""
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if avail < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only {avail} "
                "devices are visible (pass devices=[torch.device('cuda')] "
                "* n, or 'cpu', for a virtual mesh)")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for a {n_devices}-shard "
                         "mesh")
    return Mesh(devices)


def distributed_mesh(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device: Device = None) -> Mesh:
    """The mesh of a ``torch.distributed`` job, one shard a process
    (``sharding.py:50-74``): initialises the default process group where
    it is not yet (``init_method``, ``world_size`` and ``rank`` default to
    the ``torch.distributed`` environment variables), with NCCL for a card
    and gloo for the CPU.  ``device``: this rank's shard device, by
    default ``cuda:<rank mod visible cards>``; NCCL puts one rank on a
    card, so a job has at most as many ranks as cards."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if not dist.is_initialized():
        kw = dict(init_method=init_method, world_size=world_size, rank=rank)
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            **{k: v for k, v in kw.items() if v is not None})
    world, rank = dist.get_world_size(), dist.get_rank()
    if dev.type == "cuda":
        if world > torch.cuda.device_count():
            raise ValueError(
                f"{world} NCCL ranks on {torch.cuda.device_count()} cards: "
                "NCCL puts one rank on a card")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh([dev], distributed=True, rank=rank, world_size=world)


# ---------------------------------------------------------------------------
# The sharded state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedMapState:
    """X-slabs of a ``MapState``: each field a list of the local shards'
    slabs (``[lx, Y, Z]``; the closest planes ``[3, lx, Y, Z]``), each on
    its shard's device."""

    logodds: list
    d2: list
    closest: list
    seen: list
    hit_cnt: list
    miss_cnt: list


def state_shardings(state: Optional[MapState] = None,
                    closest_packed: Optional[bool] = None) -> dict:
    """The axis each MapState field is cut along (``sharding.py:77-96``):
    x (axis 0) for the [X,Y,Z] fields and the packed closest grid, axis 1
    for the [3,X,Y,Z] closest planes.  The closest format is read from
    ``state`` when given, else ``closest_packed`` (default: packed, the
    production format)."""
    if closest_packed is None:
        closest_packed = True if state is None else state.closest.dim() == 3
    axes = {f: 0 for f in FIELDS}
    axes["closest"] = 0 if closest_packed else 1
    return axes


def _slab_width(gx: int, mesh: Mesh) -> int:
    if gx % mesh.size:
        raise ValueError(f"grid X={gx} must divide by mesh size {mesh.size}")
    return gx // mesh.size


def shard_state(state: MapState, mesh: Mesh) -> ShardedMapState:
    """Cut a global MapState into the local shards' X-slabs, each copied
    onto its shard's device."""
    axes = state_shardings(state)
    lx = _slab_width(state.d2.shape[0], mesh)
    out = {f: [] for f in FIELDS}
    for x0, dev in zip(mesh.x0s(lx), mesh.devices):
        for f in FIELDS:
            part = getattr(state, f).narrow(axes[f], x0, lx)
            out[f].append(torch.empty(part.shape, dtype=part.dtype,
                                      device=dev).copy_(part))
    return ShardedMapState(**out)


def _gather_axis(mesh: Mesh, xs: Shards, axis: int) -> torch.Tensor:
    """The global tensor of slabs cut along ``axis``, on the first local
    shard's device."""
    if axis == 0:
        return mesh.all_gather(xs)[0]
    full = mesh.all_gather([x.movedim(axis, 0).contiguous() for x in xs])[0]
    return full.movedim(0, axis).contiguous()


def gather_state(sstate: ShardedMapState, mesh: Mesh) -> MapState:
    """The global MapState of a sharded one, on the first local shard's
    device (every process of a distributed mesh gets it whole)."""
    axes = state_shardings(closest_packed=sstate.closest[0].dim() == 3)
    return MapState(**{f: _gather_axis(mesh, getattr(sstate, f), axes[f])
                       for f in FIELDS})


# ---------------------------------------------------------------------------
# Halos
# ---------------------------------------------------------------------------


def _halo_exchange_x(mesh: Mesh, xs: Shards, pad: int, fill=UNDEFINED_COORD,
                     axis: int = 1) -> Shards:
    """Extend each local slab with ``pad`` planes from its x-neighbours
    along ``axis`` (``sharding.py:109-129``; the closest planes [3,lx,Y,Z]
    by default -> [3, lx+2*pad, Y, Z]); the outermost shards see
    ``fill``."""
    lx = xs[0].shape[axis]
    from_left = mesh.shift([x.narrow(axis, lx - pad, pad) for x in xs], 1,
                           fill)
    from_right = mesh.shift([x.narrow(axis, 0, pad) for x in xs], -1, fill)
    return [torch.cat([a, x, b], axis)
            for a, x, b in zip(from_left, xs, from_right)]


def _halo_refresh_x(mesh: Mesh, exts: Shards, pad: int, axis: int) -> None:
    """Rewrite, in place, the halo planes of halo-extended slabs
    (``_halo_exchange_x``'s layout) from their neighbours' current edge
    planes; the outermost halos keep their fill."""
    lx = exts[0].shape[axis] - 2 * pad
    from_left = mesh.shift([e.narrow(axis, lx, pad) for e in exts], 1)
    from_right = mesh.shift([e.narrow(axis, pad, pad) for e in exts], -1)
    for e, a, b in zip(exts, from_left, from_right):
        if a is not None:
            e.narrow(axis, 0, pad).copy_(a)
        if b is not None:
            e.narrow(axis, pad + lx, pad).copy_(b)


def _halo_planes_x(mesh: Mesh, fs: Shards, t: int, fill) -> Shards:
    """Extend each local slab [lx, Y, Z] with ``t`` planes from each side
    (``sharding.py:234-261``).  Multi-hop: when t exceeds lx, hop k relays
    the slab k shards away, so t is not bounded by the slab width.  The
    outermost shards see ``fill``."""
    if mesh.size == 1:
        return [torch.cat([torch.full((t,) + tuple(f.shape[1:]), fill,
                                      dtype=f.dtype, device=f.device), f,
                           torch.full((t,) + tuple(f.shape[1:]), fill,
                                      dtype=f.dtype, device=f.device)])
                for f in fs]
    lx = fs[0].shape[0]
    hops = -(-t // lx)
    left = [[] for _ in fs]
    right = [[] for _ in fs]
    for k in range(1, hops + 1):
        take = min(lx, t - (k - 1) * lx)
        blk_l = mesh.shift([f[lx - take:] for f in fs], k, fill)
        blk_r = mesh.shift([f[:take] for f in fs], -k, fill)
        for j in range(len(fs)):
            left[j].insert(0, blk_l[j])     # farthest hop first
            right[j].append(blk_r[j])
    return [torch.cat(lt + [f] + rt) for lt, f, rt in zip(left, fs, right)]


# ---------------------------------------------------------------------------
# The sharded EDT
# ---------------------------------------------------------------------------


def _compose_l1_x(mesh: Mesh, ps: Shards, t: int, lx: int,
                  ba: int = 0) -> Shards:
    """Cross-shard composition of slab-local raw L1 passes along x
    (``sharding.py:289-345``).  The global L1 distance of local plane i is

        min(local(i),  E_left + (i + 1),  F_right + (lx - i))

    with E_left the accumulated seed distance at the left neighbour's
    right edge over every shard to the left, F_right symmetrically.  The
    edge planes are a min-plus prefix scan over shards by log-hop
    doubling.  ``ba`` > 0: packed words ``l1 << ba | payload`` (the
    payload a global x), for which integer min is lexicographic and the
    offsets add above the payload, so the composed words equal a
    single-device pass over the whole axis.  ``ps``: [lx, Y, Z] i32."""
    n = mesh.size
    if n == 1:
        return ps
    big = (t + 1) << ba
    idx = list(mesh.local)
    e = [p[lx - 1] for p in ps]
    f = [p[0] for p in ps]

    def relax(cur, recv, ok, off):
        return [torch.minimum(c, r + off if good
                              else torch.full_like(c, big))
                for c, r, good in zip(cur, recv, ok)]

    h_need = min(n - 1, (t - 1) // lx + 1)
    j = 1
    while j <= h_need:
        off = (j * lx) << ba
        e_from_left = mesh.shift(e, j)
        f_from_right = mesh.shift(f, -j)
        e = relax(e, e_from_left, [i >= j for i in idx], off)
        f = relax(f, f_from_right, [i < n - j for i in idx], off)
        j *= 2
    # one more hop: the left neighbour's composed right edge and the right
    # neighbour's composed left edge
    e_prev = mesh.shift(e, 1, big)
    f_next = mesh.shift(f, -1, big)
    out = []
    for p, ep, fn in zip(ps, e_prev, f_next):
        iota = torch.arange(lx, dtype=torch.int32,
                            device=p.device)[:, None, None]
        cand_l = ep[None] + ((iota + 1) << ba)
        cand_r = fn[None] + ((lx - iota) << ba)
        out.append(torch.minimum(p, torch.minimum(cand_l, cand_r)))
    return out


def _edt_level(mesh: Mesh, occs: Shards, t: int) -> Shards:
    """Slab-local truncated EDT of an X-sharded occupancy
    (``_local_truncated_edt``, ``sharding.py:348-371``, and ``edt_level``,
    ``:637-644``): the raw binary pass along x, composed across shards,
    squared, then the two local min-plus passes."""
    lx = occs[0].shape[0]
    d = [edt.binary_pass(edt.binary_field(o), t, square=False)
         for o in occs]
    d = _compose_l1_x(mesh, d, t, lx)
    out = []
    for x in d:
        p3 = edt.minplus_pass(edt.minplus_pass(edt.square_l1(x, t), t, 1),
                              t, 2)
        out.append(torch.where(p3 <= t * t, p3, INF_D2))
    return out


def sharded_truncated_edt(cfg: FiestaConfig, mesh: Mesh, trunc_vox: int):
    """Exact truncated EDT over an X-sharded grid (``sharding.py:264-286``):
    occupancy slabs [lx,Y,Z] bool -> d2 slabs i32, equal to
    ``edt.truncated_edt_d2`` of the whole grid.  The x pass exchanges
    O(log) edge planes a shard, whatever t."""
    _slab_width(cfg.grid_shape[0], mesh)
    t = int(trunc_vox)
    return lambda occs: _edt_level(mesh, occs, t)


def sharded_closest_supported(cfg: FiestaConfig) -> bool:
    """Whether the sharded rebuild can track the closest obstacle
    (``sharding.py:374-396``): the packed argmin fits (``closest_plan``
    on the GLOBAL shape) and the sharded x axis carries the leading
    binary pass (plan a == 0) or the split pass (plan c == 0)."""
    if not cfg.track_closest:
        return False
    t_total = edt.trunc_vox_for(cfg.resolution, cfg.trunc_dist)
    t_fine = edt.trunc_vox_for(cfg.resolution, cfg.edt_fine_dist)
    gshape = cfg.grid_shape

    def ok(shape, t):
        plan = edt.closest_plan(shape, t)
        return plan is not None and (plan["a"] == 0 or plan["c"] == 0)

    if t_fine < t_total and all(g % 2 == 0 for g in gshape):
        coarse = tuple(g // 2 for g in gshape)
        return ok(gshape, t_fine) and ok(coarse, -(-t_total // 2))
    return ok(gshape, t_total)


def _local_edt_closest(shape, mesh: Mesh, trunc_vox: int):
    """Shard-local truncated EDT with the closest obstacle over an
    X-sharded grid of GLOBAL ``shape`` (``sharding.py:399-564``), in the
    layout ``closest_plan`` picks for the global shape:

      * a == 0: the packed binary pass along x in its raw form, its
        payload made global (+ x0) and composed across shards like the
        d2-only pass, then squared; the window and split passes local;
      * c == 0: the binary and window passes local, the split pass along
        x over a halo of t packed planes a side (``cap << s`` beyond the
        grid), the halo rows cropped.

    Returns local_fn(occs, x0s) -> (d2 slabs, closest planes [3,lx,Y,Z]
    i16), c* recovered by ``edt.decode_split`` with global x."""
    plan = edt.closest_plan(shape, trunc_vox)
    if plan is None or not (plan["a"] == 0 or plan["c"] == 0):
        raise ValueError(f"no sharded closest layout for {tuple(shape)} at "
                         f"t={trunc_vox} (sharded_closest_supported)")
    t, ba, s = plan["t"], plan["ba"], plan["s"]
    lx = _slab_width(shape[0], mesh)

    if plan["a"] == 0:
        # the payload is a global x: it must fit the global plan's ba bits
        # (the kernel's own check sees only the slab)
        if shape[0] > 1 << ba:
            raise ValueError(f"global x extent {shape[0]} exceeds the "
                             f"plan's {ba} payload bits")

        def local_fn(occs, x0s):
            p1 = [edt.binary_packed(edt._as_u8(o), plan, 0, square=False)
                  + x0 for o, x0 in zip(occs, x0s)]
            p1 = _compose_l1_x(mesh, p1, t, lx, ba=ba)
            out = []
            for p, x0 in zip(p1, x0s):
                p2 = edt.window_packed(edt.square_packed_l1(p, plan), plan,
                                       plan["b"])
                vps = edt.split_packed(p2, plan, plan["c"])
                out.append(edt.decode_split(vps, plan, x0=x0))
            return [o[0] for o in out], [o[1] for o in out]

        return local_fn

    cap_fill = plan["cap"] << s

    def local_fn(occs, x0s):
        p2 = [edt.window_packed(
            edt.binary_packed(edt._as_u8(o), plan, plan["a"]), plan,
            plan["b"]) for o in occs]
        ext = _halo_planes_x(mesh, p2, t, cap_fill)
        vps = [edt.split_packed(e, plan, 0)[t:-t] for e in ext]
        out = [edt.decode_split(v, plan, x0=x0) for v, x0 in zip(vps, x0s)]
        return [o[0] for o in out], [o[1] for o in out]

    return local_fn


def _coarse_up(d2c: torch.Tensor) -> torch.Tensor:
    return edt._upsample2(edt._coarse_d2(d2c))


def _local_rebuild_esdf(cfg: FiestaConfig, mesh: Mesh,
                        with_closest: Optional[bool] = None):
    """Shard-local distance derivation, feature for feature
    ``pipeline.rebuild_esdf`` (``sharding.py:567-653``): one- or
    two-level EDT, with the closest obstacle where supported.
    ``with_closest``: None = where supported (the eager tick), False =
    d2 only (the lazy tick), True = required (the lazy derive).  Returns
    local_fn(occs, x0s) -> (d2 slabs, closest planes or None)."""
    t_total = edt.trunc_vox_for(cfg.resolution, cfg.trunc_dist)
    t_fine = edt.trunc_vox_for(cfg.resolution, cfg.edt_fine_dist)
    gshape = cfg.grid_shape
    hier = t_fine < t_total and all(g % 2 == 0 for g in gshape)
    track = sharded_closest_supported(cfg) and with_closest is not False
    if with_closest and not track:
        raise ValueError(
            "closest derivation requested on a config the sharded argmin "
            "engine cannot serve (sharded_closest_supported)")
    lx = _slab_width(gshape[0], mesh)

    if not hier:
        if not track:
            return lambda occs, x0s: (_edt_level(mesh, occs, t_total), None)
        return _local_edt_closest(gshape, mesh, t_total)

    # two levels: the exact fine field and the half-resolution far field
    if lx % 2:
        raise ValueError(
            f"hierarchical sharded EDT needs an even per-device slab "
            f"(lx={lx}); use a mesh size where (X/n) is even")
    coarse_shape = tuple(g // 2 for g in gshape)
    t_coarse = -(-t_total // 2)

    if track:
        fine_fn = _local_edt_closest(gshape, mesh, t_fine)
        coarse_fn = _local_edt_closest(coarse_shape, mesh, t_coarse)

        def local_fn(occs, x0s):
            fine_d2, fine_cl = fine_fn(occs, x0s)
            d2c, clc = coarse_fn([edt.downsample2_any(o) for o in occs],
                                 [x0 // 2 for x0 in x0s])
            d2s, cls = [], []
            for fd, fc, cd, cc in zip(fine_d2, fine_cl, d2c, clc):
                use_fine = fd < INF_D2
                d2s.append(torch.where(use_fine, fd, _coarse_up(cd)))
                # coarse coordinates doubled to the winning block's even
                # corner, as edt.hierarchical_edt_d2_closest does
                cl_up = edt._upsample2(torch.where(cc < 0, UNDEFINED_COORD,
                                                   cc * 2))
                cls.append(torch.where(use_fine[None], fc, cl_up))
            return d2s, cls

        return local_fn

    def local_fn(occs, x0s):
        fine = _edt_level(mesh, occs, t_fine)
        d2c = _edt_level(mesh, [edt.downsample2_any(o) for o in occs],
                         t_coarse)
        return [torch.where(f < INF_D2, f, _coarse_up(c))
                for f, c in zip(fine, d2c)], None

    return local_fn


def _as_state_closest(cfg: FiestaConfig, cls: Optional[Shards]):
    """Closest planes in the state's format (packed where it packs)."""
    if cls is None or not closest_packed_state(cfg):
        return cls
    return [pack_closest(c) for c in cls]


def sharded_rebuild_esdf(cfg: FiestaConfig, mesh: Mesh):
    """Sharded distance re-derivation, ``pipeline.rebuild_esdf`` on the
    mesh (``sharding.py:656-693``; lazy closest: d2 only): occupancy slabs
    -> (d2 slabs, closest slabs in the state's format, or None).  Used by
    the scrolling engine's restores."""
    _slab_width(cfg.grid_shape[0], mesh)
    local = _local_rebuild_esdf(
        cfg, mesh, with_closest=False if cfg.lazy_closest else None)
    lx = cfg.grid_shape[0] // mesh.size

    def rebuild(occs):
        d2s, cls = local(occs, mesh.x0s(lx))
        return d2s, _as_state_closest(cfg, cls)

    return rebuild


def sharded_derive_closest(cfg: FiestaConfig, mesh: Mesh):
    """Sharded closest derivation for the lazy query path
    (``sharding.py:696-723``): log-odds slabs -> closest slabs (packed i32
    [lx,Y,Z] or i16 planes [3,lx,Y,Z]), bit for bit the slabs of the
    single-device ``pipeline.derive_closest``."""
    lx = _slab_width(cfg.grid_shape[0], mesh)
    local = _local_rebuild_esdf(cfg, mesh, with_closest=True)

    def derive(logodds):
        _, cls = local([occupied_grid(cfg, lo) for lo in logodds],
                       mesh.x0s(lx))
        return _as_state_closest(cfg, cls)

    return derive


# ---------------------------------------------------------------------------
# The sharded tick
# ---------------------------------------------------------------------------


def _pad_scans(points, valids, transforms, k_pad: int):
    """The scans padded by ``k_pad`` all-invalid scans at identity."""
    if not k_pad:
        return points, valids, transforms
    pts = torch.cat([points, points.new_zeros((k_pad,) + points.shape[1:])])
    val = torch.cat([valids, valids.new_zeros((k_pad,) + valids.shape[1:])])
    eye = torch.eye(4, dtype=transforms.dtype, device=transforms.device)
    tfs = torch.cat([transforms, eye.expand(k_pad, 4, 4)])
    return pts, val, tfs


def sharded_fused_tick(cfg: FiestaConfig, mesh: Mesh):
    """The production mapping tick over an X-sharded grid
    (``sharding.py:726-950``): scan integration, fusion drain and EDT
    rebuild, bit-equal to ``pipeline.fused_batch_step`` (scanline,
    rebuild mode), global or in the local window (``global_update``),
    one- or two-level EDT, lazy or eager closest.

      * the K scans are padded to a multiple of the mesh size with
        all-invalid scans and cut into one group a shard: each shard
        splats and carves only its own (``scanline_batch_boxes``);
      * the box corners and the packed u8 counts ``hit * 4 | miss`` are
        all-gathered, and each shard adds the first K (the real ones) to
        its slab with corners shifted by -x0 (the box add skips what lies
        outside the slab);
      * the drain runs on the slab, its window shifted into the slab;
      * the rebuild is the sharded EDT (d2 only with lazy closest);
      * the three counts are summed over shards.

    Returns step(sstate, points [K,P,3] sensor frame, valids [K,P],
    transforms [K,4,4], cur_pos [3]) -> (sstate, UpdateStats), the inputs
    on any device (each shard takes its scans to its own).  The counters
    of ``sstate`` are added to in place, as the JAX tick donates them."""
    from ..pipeline import UpdateStats

    n = mesh.size
    gx = cfg.grid_shape[0]
    lx = _slab_width(gx, mesh)
    if cfg.esdf_mode != "rebuild":
        raise ValueError("sharded_fused_tick implements the rebuild path; "
                         "use sharded_esdf_update for the incremental "
                         "engine")
    rebuild_local = _local_rebuild_esdf(
        cfg, mesh, with_closest=False if cfg.lazy_closest else None)
    on, off_eq = ((cfg.min_occupancy_log, False) if cfg.probabilistic
                  else (1.0, True))
    drain = dict(l_hit=cfg.prob_hit_log, l_miss=cfg.prob_miss_log,
                 clamp_min=cfg.clamp_min_log, clamp_max=cfg.clamp_max_log,
                 occ_thresh=on, occ_is_eq=off_eq)

    def step(state: ShardedMapState, points, valids, transforms, cur_pos):
        k = points.shape[0]
        points, valids, transforms = _pad_scans(points, valids, transforms,
                                                -k % n)
        kl = points.shape[0] // n
        x0s = mesh.x0s(lx)
        wins, starts, packed = [], [], []
        for i, dev in zip(mesh.local, mesh.devices):
            own = slice(i * kl, (i + 1) * kl)
            win = (None if cfg.global_update
                   else local_window(cfg, _to(cur_pos, dev).to(
                       torch.float32)))
            st, hitc, missc, _, _ = raycast.scanline_batch_boxes(
                cfg, _to(points[own], dev), _to(valids[own], dev),
                transforms=_to(transforms[own], dev), window=win)
            wins.append(win)
            starts.append(st)
            # the two counter boxes ride one u8: hit in {0,1}, miss in
            # {0,1,2}
            packed.append(hitc * 4 + missc)
        starts = mesh.all_gather(starts)
        packed = mesh.all_gather(packed)
        out = {f: [] for f in ("logodds", "seen", "hit_cnt", "miss_cnt")}
        occs, counts = [], []
        for j, (x0, dev) in enumerate(zip(x0s, mesh.devices)):
            shift = torch.zeros(3, dtype=torch.int32, device=dev)
            shift[0] = x0
            st = (starts[j][:k] - shift).contiguous()
            pk = packed[j][:k]
            hit, miss = raycast.apply_box_counts(
                state.hit_cnt[j], state.miss_cnt[j], st, pk >> 2, pk & 3)
            lo, seen, occ, hit0, miss0, n_obs, n_ins, n_del = \
                fusion.fuse_drain(state.logodds[j], state.seen[j], hit, miss,
                                  window=wins[j], x_offset=x0, **drain)
            for f, v in (("logodds", lo), ("seen", seen), ("hit_cnt", hit0),
                         ("miss_cnt", miss0)):
                out[f].append(v)
            occs.append(occ)
            counts.append(torch.stack([n_obs, n_ins, n_del]))
        d2s, cls = rebuild_local(occs, x0s)
        cls = _as_state_closest(cfg, cls)
        total = mesh.psum(counts)[0]
        stats = UpdateStats(num_observed=total[0], num_inserted=total[1],
                            num_deleted=total[2],
                            num_sweeps=torch.zeros((), dtype=torch.int32,
                                                   device=total.device))
        return ShardedMapState(d2=d2s, closest=state.closest if cls is None
                               else cls, **out), stats

    return step


# ---------------------------------------------------------------------------
# The sharded incremental relaxation
# ---------------------------------------------------------------------------


def sharded_relax_to_fixpoint(cfg: FiestaConfig, mesh: Mesh,
                              max_iters: int = 0, use_masks: bool = True):
    """The sharded relaxation (``sharding.py:178-231``): Jacobi sweeps of
    ``cfg.stencil`` with a halo exchange on every sweep, until no shard's
    d2 fell (the change flags summed over shards and read by the host
    once a sweep), or ``max_iters`` sweeps when > 0.

    Each shard keeps its slab extended by the stencil's reach on each
    side; a sweep is one ``esdf.relax_sweep`` a shard (the ``relax``
    kernel at ``max_iters`` 1 on a card) with the update mask on the
    slab's own planes and candidates in global coordinates (its x
    origin), then the neighbours' new edge planes are copied into the
    halos.  Returns relax(d2 slabs, closest planes [3,lx,Y,Z], update mask
    slabs, source mask slabs) -> (d2 slabs, closest slabs, sweeps 0-dim
    i32); the masks only when ``use_masks``."""
    dirs = cfg.stencil
    pad = _stencil_reach(dirs)
    lx = _slab_width(cfg.grid_shape[0], mesh)
    if lx < pad:
        raise ValueError(
            f"X-slab of {lx} planes cannot serve a reach-{pad} stencil halo "
            f"(need >= {pad} planes per device)")

    def relax(d2s, cls, update_masks=None, source_masks=None):
        if not use_masks and (update_masks is not None
                              or source_masks is not None):
            raise ValueError("built with use_masks=False")
        x0s = mesh.x0s(lx)
        ext_d2 = [torch.cat([torch.full((pad,) + tuple(d.shape[1:]), INF_D2,
                                        dtype=d.dtype, device=d.device), d,
                             torch.full((pad,) + tuple(d.shape[1:]), INF_D2,
                                        dtype=d.dtype, device=d.device)])
                  for d in d2s]
        ext_c = _halo_exchange_x(mesh, cls, pad)
        own = []
        for j, d in enumerate(d2s):
            m = torch.zeros(ext_d2[j].shape, dtype=torch.bool,
                            device=d.device)
            m[pad:pad + lx] = True if update_masks is None \
                else update_masks[j]
            own.append(m)
        src = (None if source_masks is None else
               _halo_exchange_x(mesh, source_masks, pad, False, axis=0))
        sweeps = 0
        while True:
            outs = [esdf.relax_sweep(ext_d2[j], ext_c[j], own[j],
                                     None if src is None else src[j], dirs,
                                     x_offset=x0s[j] - pad)
                    for j in range(len(d2s))]
            ext_d2 = [o[0] for o in outs]
            ext_c = [o[1] for o in outs]
            sweeps += 1
            changed = mesh.psum([o[2].to(torch.int32) for o in outs])[0]
            COLLECTIVES["host_sync"] += 1
            if not int(changed) or (max_iters and sweeps >= max_iters):
                break
            _halo_refresh_x(mesh, ext_c, pad, axis=1)
        return ([d[pad:pad + lx].contiguous() for d in ext_d2],
                [c[:, pad:pad + lx].contiguous() for c in ext_c],
                torch.full((), sweeps, dtype=torch.int32,
                           device=mesh.devices[0]))

    return relax


def sharded_esdf_update(cfg: FiestaConfig, mesh: Mesh, max_iters: int = 0):
    """The sharded incremental update (``sharding.py:953-974``): the
    insert/delete effects on each slab (the delete pass's occupancy
    lookup reads an all-gathered occupancy; inserts take global
    coordinates), then ``sharded_relax_to_fixpoint``.  Returns step(d2
    slabs, closest planes [3,lx,Y,Z], occupied slabs, insert mask slabs)
    -> (d2 slabs, closest slabs, sweeps 0-dim i32)."""
    relax = sharded_relax_to_fixpoint(cfg, mesh, max_iters=max_iters,
                                      use_masks=False)
    lx = cfg.grid_shape[0] // mesh.size

    def step(d2s, cls, occs, inserts):
        occ_all = mesh.all_gather([o.to(torch.bool) for o in occs])
        d2s, cls = zip(*(esdf.apply_occupancy_changes(
            d, c, g, ins.to(torch.bool), x_offset=x0)[:2]
            for d, c, g, ins, x0 in zip(d2s, cls, occ_all, inserts,
                                        mesh.x0s(lx))))
        return relax(list(d2s), list(cls))

    return step


# ---------------------------------------------------------------------------
# The sharded signed field
# ---------------------------------------------------------------------------


def sharded_sdf(cfg: FiestaConfig, mesh: Mesh):
    """The signed distance field on the mesh (C18,
    ``parallel/engine.py:276-307``): the interior EDT of the free space
    runs on the slabs like the exterior one.  Returns sdf(log-odds slabs,
    d2 slabs, seen slabs) -> SDF slabs, bit for bit
    ``query.signed_distance_grid``'s."""
    t = edt.trunc_vox_for(cfg.resolution, cfg.trunc_dist)
    inner = sharded_truncated_edt(cfg, mesh, t)

    def sdf(logodds, d2s, seens):
        occs = [occupied_grid(cfg, lo) for lo in logodds]
        d2_in = inner([~o for o in occs])
        out = []
        for occ, d2, seen, din in zip(occs, d2s, seens, d2_in):
            outside = query.distance_grid(cfg, d2, seen)
            inside = torch.clamp(
                sqrt_f32(din.to(torch.float32)) * cfg.resolution,
                max=cfg.trunc_dist)
            out.append(torch.where(occ, -inside, outside))
        return out

    return sdf
