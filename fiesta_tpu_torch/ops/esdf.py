"""Incremental ESDF: dense masked min-relaxation (port of
``fiesta_tpu/ops/esdf.py``).

Reference semantics (SURVEY.md C6, src/ESDFMap.cpp:273-398): inserts get
d2 = 0 and are their own closest obstacle; a delete resets every voxel
whose closest obstacle it was; the BFS then lets voxels pull a better
closest obstacle from their stencil neighbours until nothing changes.
The BFS computes the fixpoint of a monotone relaxation, so a dense Jacobi
sweep of the same relaxation, repeated until no d2 decreases, reaches the
same fixpoint: that is the engine here.

``relax_to_fixpoint`` runs the sweeps: on a CUDA tensor in ONE cooperative
launch of the ``relax`` kernel (``kernels/relax.cu``), which sweeps to the
fixpoint with a grid barrier between sweeps and keeps the "anything
changed" test and the sweep count on the device, as JAX's
``lax.while_loop`` does; on a CPU tensor ``relax_once`` in a host loop
(its plain version).  ``apply_occupancy_changes``, the inserts and bucket
resets before the sweeps, is one launch of the ``changes`` kernel
(``kernels/changes.cu``) on a CUDA tensor and its plain version on a CPU
tensor.  ``build_esdf`` is the exact separable min-plus EDT
with argmin tracking, plain PyTorch (the tests' oracle).

Distances are squared int32 voxel counts; closest coordinates are int16
planes [3, X, Y, Z], -1 where undefined.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..grid import (INF_D2, UNDEFINED_COORD, coord_grids, pack_closest,
                    unpack_closest)
from ..timing import span
from .edt import closest_capability

_PAD = 2  # stencil reach (the 24-stencil contains +-2 face offsets)


def consideration_order(dirs):
    """The order in which a sweep considers ``dirs``: every offset of
    reach <= 2 first, in ``dirs`` order, then the longer axis-aligned
    jumps in ``dirs`` order (``esdf.py:92-123``).  A candidate wins only
    when strictly smaller, so the first offset in this order with the
    least candidate decides a tie."""
    dirs = [tuple(int(o) for o in d) for d in dirs]
    small = [d for d in dirs if max(abs(o) for o in d) <= _PAD]
    jumps = [d for d in dirs if max(abs(o) for o in d) > _PAD]
    for d in jumps:
        if sum(1 for o in d if o) != 1:
            raise ValueError(f"long-range offsets must be axis-aligned: {d}")
    return small, jumps


def _shift_stack(padded: torch.Tensor, off, shape) -> torch.Tensor:
    """The neighbour at ``off`` of every voxel, sliced from a [C, X+2P,
    Y+2P, Z+2P] padded stack."""
    dx, dy, dz = (int(o) for o in off)
    gx, gy, gz = shape
    return padded[:, _PAD + dx:_PAD + dx + gx, _PAD + dy:_PAD + dy + gy,
                  _PAD + dz:_PAD + dz + gz]


def _shift_axis_stack(arr: torch.Tensor, axis: int, s: int,
                      fill) -> torch.Tensor:
    """out[v] = arr[v + s*e_axis] of a [C, X, Y, Z] stack, ``fill`` where
    that leaves the grid (the long-range jumps)."""
    ax = axis + 1
    n = arr.shape[ax]
    blk_shape = list(arr.shape)
    blk_shape[ax] = abs(s)
    blk = torch.full(blk_shape, fill, dtype=arr.dtype, device=arr.device)
    if s > 0:
        return torch.cat([arr.narrow(ax, s, n - s), blk], dim=ax)
    return torch.cat([blk, arr.narrow(ax, 0, n + s)], dim=ax)


def _relax_pass(d2, closest, src, dirs, shape, self_c):
    """Best (d2, closest) candidates pulling from ``src`` neighbours."""
    small, jumps = consideration_order(dirs)
    best_d2, best_c = d2, closest

    def consider(nb):
        nonlocal best_d2, best_c
        diff = self_c - nb.to(torch.int32)
        cand = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
        better = (nb[0] >= 0) & (cand < best_d2)
        best_d2 = torch.where(better, cand, best_d2)
        best_c = torch.where(better[None], nb, best_c)

    if small:
        padded = F.pad(src, (_PAD,) * 6, value=UNDEFINED_COORD)
        for off in small:
            consider(_shift_stack(padded, off, shape))
    for off in jumps:
        axis = next(i for i, o in enumerate(off) if o)
        consider(_shift_axis_stack(src, axis, off[axis], UNDEFINED_COORD))
    return best_d2, best_c


def relax_once(d2: torch.Tensor, closest: torch.Tensor, update_mask,
               source_mask, dirs, push_src_mask=None, push_recv_mask=None,
               x_offset: int = 0):
    """One Jacobi sweep of the closest-obstacle relaxation
    (``esdf.py:127-184``): every voxel pulls the best candidate
    ``|v - closest[v+d]|^2`` from its ``dirs`` neighbours.

    d2 [X,Y,Z] i32, closest [3,X,Y,Z] i16.  ``update_mask``: voxels
    allowed to improve; ``source_mask``: voxels readable as neighbours
    (None: all).  ``push_src_mask`` / ``push_recv_mask`` (windowed mode):
    a second pass from the unchanged state reads only ``push_src_mask``
    sources, and replaces the first pass's result where
    ``push_recv_mask`` holds and it is strictly smaller.  ``x_offset``:
    the global x of the first plane of an X-slab whose closest
    coordinates are global (``sharding.py:141-142``).  Returns (new_d2,
    new_closest, changed 0-dim bool)."""
    shape = tuple(d2.shape)
    self_c = _self_coords(shape, d2.device, x_offset)
    src = closest
    if source_mask is not None:
        src = torch.where(source_mask[None], closest, UNDEFINED_COORD)
    best_d2, best_c = _relax_pass(d2, closest, src, dirs, shape, self_c)
    if push_src_mask is not None:
        src2 = torch.where(push_src_mask[None], closest, UNDEFINED_COORD)
        p_d2, p_c = _relax_pass(d2, closest, src2, dirs, shape, self_c)
        take = push_recv_mask & (p_d2 < best_d2)
        best_d2 = torch.where(take, p_d2, best_d2)
        best_c = torch.where(take[None], p_c, best_c)
    if update_mask is not None:
        best_d2 = torch.where(update_mask, best_d2, d2)
        best_c = torch.where(update_mask[None], best_c, closest)
    return best_d2, best_c, torch.any(best_d2 < d2)


def _self_coords(shape, device, x_offset: int = 0) -> torch.Tensor:
    """[3, X, Y, Z] i32 voxel coordinates, x shifted by ``x_offset``."""
    c = coord_grids(shape, device).to(torch.int32)
    if x_offset:
        c[0] += int(x_offset)
    return c


def relax_sweep(d2: torch.Tensor, closest: torch.Tensor, update_mask,
                source_mask, dirs, x_offset: int = 0):
    """One sweep of ``relax_once`` (no push masks), as the sharded engine
    runs it on a halo-extended X-slab: (d2, closest, changed 0-dim bool).
    CUDA tensors: one launch of the ``relax`` kernel at ``max_iters`` 1,
    its "changed" word read from its state on the card; CPU:
    ``relax_once``."""
    if d2.is_cuda:
        d2, closest, state = kernels.relax_sweeps(
            d2, closest, update_mask, source_mask, dirs, max_iters=1,
            x_offset=x_offset)
        return d2, closest, state[0] > 0
    return relax_once(d2, closest, update_mask, source_mask, dirs,
                      x_offset=x_offset)


def _relax_to_fixpoint_plain(d2, closest, update_mask, source_mask, dirs,
                             max_iters: int = 0, push_src_mask=None,
                             push_recv_mask=None):
    """Plain version of ``relax_to_fixpoint``: ``relax_once`` in a host
    loop, reading "changed" back after every sweep."""
    sweeps, changed = 0, True
    while changed and (not max_iters or sweeps < max_iters):
        d2, closest, ch = relax_once(d2, closest, update_mask, source_mask,
                                     dirs, push_src_mask, push_recv_mask)
        changed = bool(ch)
        sweeps += 1
    return d2, closest, torch.full((), sweeps, dtype=torch.int32,
                                   device=d2.device)


def relax_to_fixpoint(d2: torch.Tensor, closest: torch.Tensor, update_mask,
                      source_mask, dirs, max_iters: int = 0,
                      push_src_mask=None, push_recv_mask=None):
    """Sweep ``relax_once`` until no d2 decreases, or ``max_iters`` sweeps
    when it is set (``esdf.py:187-221``).  Returns (d2, closest,
    num_sweeps 0-dim i32), counting the last sweep, which changed nothing.
    CUDA tensors: the ``relax`` kernel, one cooperative launch, no host
    readback; CPU: the plain version."""
    if d2.is_cuda:
        return kernels.relax_to_fixpoint(
            d2, closest, update_mask, source_mask, dirs, max_iters,
            push_src_mask, push_recv_mask)
    return _relax_to_fixpoint_plain(d2, closest, update_mask, source_mask,
                                    dirs, max_iters, push_src_mask,
                                    push_recv_mask)


class NewlyOccupied(NamedTuple):
    """The inserts of a tick drained in one pass (``fusion.fuse_drain``):
    the voxels occupied after the drain that the occupancy predicate
    (``logodds > occ_thresh``, or ``==`` with ``occ_is_eq``, the
    threshold rounded to f32) finds free in ``logodds``, the log-odds
    before it: ``fusion.fuse_counts``' ``insert_mask``."""
    logodds: torch.Tensor
    occ_thresh: float
    occ_is_eq: bool

    def mask(self, occupied: torch.Tensor) -> torch.Tensor:
        """The bool insert mask, given the occupancy after the drain."""
        thr = float(np.float32(self.occ_thresh))
        before = (self.logodds == thr) if self.occ_is_eq else \
            (self.logodds > thr)
        return occupied.to(torch.bool) & ~before


def apply_occupancy_changes(d2: torch.Tensor, closest: torch.Tensor,
                            occupied: torch.Tensor, insert_mask,
                            x_offset: int = 0, mask="reset"):
    """Insert and delete effects before relaxation (``esdf.py:224-264``):
    inserts take d2 = 0 and closest = self; every voxel whose recorded
    closest obstacle is no longer occupied (the reference's DLL bucket of
    a deleted obstacle) resets to INF_D2 / undefined.  On an X-slab whose
    first plane is global x ``x_offset``, ``occupied`` is the whole grid's
    (the sharded engine gathers it) and inserts take global coordinates.
    ``insert_mask``: bool [X,Y,Z], or ``NewlyOccupied`` (the whole grid).
    Returns (d2, closest, mask): ``mask`` "reset" the bool reset mask,
    "queued" resets | inserts (the windowed relaxation's queued voxels),
    None no mask (None).  CUDA tensors: one launch of the ``changes``
    kernel; CPU: the plain version."""
    if d2.is_cuda:
        if isinstance(insert_mask, NewlyOccupied):
            return kernels.changes(
                d2, closest, occupied, logodds=insert_mask.logodds,
                occ_thresh=insert_mask.occ_thresh,
                occ_is_eq=insert_mask.occ_is_eq, mask=mask)
        return kernels.changes(d2, closest, occupied, insert_mask,
                               x_offset=x_offset, mask=mask)
    return _apply_occupancy_changes_plain(d2, closest, occupied, insert_mask,
                                          x_offset, mask)


def _apply_occupancy_changes_plain(d2, closest, occupied, insert_mask,
                                   x_offset: int = 0, mask="reset"):
    """Plain version of ``apply_occupancy_changes``."""
    occupied = occupied.to(torch.bool)
    if isinstance(insert_mask, NewlyOccupied):
        insert_mask = insert_mask.mask(occupied)
    shape = tuple(d2.shape)
    d2 = torch.where(insert_mask, 0, d2)
    closest = torch.where(insert_mask[None],
                          _self_coords(shape, d2.device, x_offset).to(
                              closest.dtype), closest)
    defined = closest[0] >= 0
    _, gy, gz = shape
    c = closest.to(torch.int32)
    lin = torch.where(defined, c[0] * (gy * gz) + c[1] * gz + c[2], 0)
    reset = defined & ~torch.take(occupied, lin.to(torch.int64))
    d2 = torch.where(reset, INF_D2, d2)
    closest = torch.where(reset[None], UNDEFINED_COORD, closest)
    if mask == "queued":
        reset = reset | insert_mask
    return d2, closest, None if mask is None else reset


def update_esdf(d2: torch.Tensor, closest: torch.Tensor,
                occupied: torch.Tensor, insert_mask,
                delete_mask, window_mask, dirs, max_iters: int = 0):
    """Incremental ESDF update (UpdateESDF, ESDFMap.cpp:273-398;
    ``esdf.py:267-318``).  ``window_mask`` None: a global update; else
    in-window voxels relax against in-window sources, and queued
    out-of-window voxels (reset bucket members, inserts) re-seed from
    in-window sources and push their obstacle into the window.
    ``occupied`` bool or u8; ``insert_mask`` bool, or ``NewlyOccupied``.
    A packed closest (ndim 3) is unpacked on entry and repacked on return.
    Returns (d2, closest, num_sweeps)."""
    del delete_mask  # subsumed by the occupancy gather
    if closest.dim() == occupied.dim():
        d2p, planes, sweeps = update_esdf(
            d2, unpack_closest(closest), occupied, insert_mask, None,
            window_mask, dirs, max_iters=max_iters)
        return d2p, pack_closest(planes), sweeps
    with span("fiesta.update.relax.changes"):
        d2, closest, queued = apply_occupancy_changes(
            d2, closest, occupied, insert_mask,
            mask=None if window_mask is None else "queued")
    if window_mask is None:
        return relax_to_fixpoint(d2, closest, None, None, dirs,
                                 max_iters=max_iters)
    return relax_to_fixpoint(d2, closest, window_mask | queued, window_mask,
                             dirs, max_iters=max_iters,
                             push_src_mask=queued,
                             push_recv_mask=window_mask)


# ---------------------------------------------------------------------------
# Exact batch EDT (separable min-plus with argmin tracking, esdf.py:321-409)
# ---------------------------------------------------------------------------

# value * _PACK + index in one int32 minimum (values < 2^20, axes <= 512)
_PACK = 512
_INF_EDT = 1 << 20


def _minplus_axis(vals: torch.Tensor, axis: int, chunk: int):
    """out[i] = min_j vals[j] + (i-j)^2 along ``axis``, with the argmin
    (the smallest j at a tie).  Returns (min_vals i32, argmin i16);
    ``chunk`` output positions at a time."""
    v = torch.movedim(vals, axis, 0)
    n = v.shape[0]
    if n > _PACK:
        raise ValueError(
            f"oracle EDT packing (value*{_PACK}+index) cannot represent "
            f"axis {axis} of length {n}; "
            + closest_capability(vals.shape, _PACK)["detail"]
            + " — use ops.edt.truncated_edt_d2_closest[_wide] for large "
            "grids")
    bcast = (n,) + (1,) * (v.dim() - 1)
    j = torch.arange(n, dtype=torch.int32, device=v.device)
    vp = torch.clamp(v, max=_INF_EDT) * _PACK + j.reshape(bcast)
    out = torch.cat([
        torch.amin(vp[None] + ((i[:, None] - j[None, :]) ** 2 * _PACK
                               ).reshape((i.numel(),) + bcast), dim=1)
        for i in torch.arange(n, dtype=torch.int32,
                              device=v.device).split(chunk)])
    return (torch.movedim(out // _PACK, 0, axis),
            torch.movedim((out % _PACK).to(torch.int16), 0, axis))


def build_esdf(occupied: torch.Tensor,
               chunk: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 3-D EDT with closest-obstacle tracking of a bool [X,Y,Z]
    occupancy: (d2 i32, INF_D2 where no obstacle exists; closest
    [3,X,Y,Z] i16, -1 where none)."""
    f = torch.where(occupied, 0, _INF_EDT).to(torch.int32)
    dx, jx = _minplus_axis(f, 0, chunk)
    dxy, jy = _minplus_axis(dx, 1, chunk)
    cx_xy = torch.gather(jx, 1, jy.to(torch.int64))
    dxyz, jz = _minplus_axis(dxy, 2, chunk)
    jz64 = jz.to(torch.int64)
    cx = torch.gather(cx_xy, 2, jz64)
    cy = torch.gather(jy, 2, jz64)
    none = dxyz >= _INF_EDT
    d2 = torch.where(none, INF_D2, dxyz)
    closest = torch.where(none[None], UNDEFINED_COORD,
                          torch.stack([cx, cy, jz]))
    return d2, closest
