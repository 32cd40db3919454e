"""Exact truncated Euclidean distance transform, with and without the
closest obstacle (port of ``fiesta_tpu/ops/pallas/edt.py``).

    d2[v] = min_{|j - v|_inf <= T} (0 if occupied[j]) + |v - j|^2

computed separably: one binary first pass along axis 0 (the L1 distance to
the nearest obstacle on the column, squared), then one windowed min-plus
pass along each of axes 1 and 2:

    pass_axis(f)[i] = min_{|k| <= T} f[i + k] + k^2

Both passes have a hand-written CUDA kernel (``kernels/edt.cu``) and a
plain PyTorch version here.  ``binary_pass`` and ``minplus_pass`` launch
the kernel for a CUDA tensor and take the plain version for a CPU tensor;
d2 is a pure function of the occupancy, so both routes are bit-equal to
the JAX package's transform.

The closest transform (``truncated_edt_d2_closest``) runs three packed
passes of the same shape, each with a CUDA kernel (``kernels/closest.cu``)
and a plain version, dispatched the same way, and decodes the last pass's
word (``decode_split``: a kernel, or ``unpack_split`` and
``_reconstruct_closest``).  The wide transform, for grids past the int32
packing budget, runs the two-word passes of the JAX package (XLA there)
as three passes over one 64-bit word ``val << shift | payload`` (kernels
``closest_*_wide``; plain versions: the pair passes, packed into the
word), then the same decode.

The two-level EDT (``hierarchical_edt_d2`` and its closest form) runs the
same passes on the grid and on its 2x2x2 any-pooled half, and joins them
in plain PyTorch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import kernels
from ..grid import INF_D2, sqrt_f32

# "far" value inside the passes (ops/pallas/edt.py:44)
_INF_EDT = 1 << 20


def trunc_vox_for(resolution: float, trunc_dist: float) -> int:
    return int(math.ceil(trunc_dist / resolution))


# ---------------------------------------------------------------------------
# The two passes
# ---------------------------------------------------------------------------


def _lead_iota(n: int, ndim: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device).reshape(
        (n,) + (1,) * (ndim - 1))


def _padded(x: torch.Tensor, t: int, fill: int) -> torch.Tensor:
    """``x`` with ``t`` planes of ``fill`` before and after the leading
    axis: ``_padded(x)[t + i + k] == x[i + k]`` with ``fill`` beyond."""
    far = torch.full((t,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([far, x, far], 0)


def _binary_pass_plain(f: torch.Tensor, t: int,
                       square: bool = True) -> torch.Tensor:
    """Plain version of the binary first pass along axis 0 of [A, ...]:
    doubling min-plus with the |d| kernel (shifts 1, 2, 4, ... cover every
    offset up to the local reach), as ``_binary_pass_pallas`` computes it.

    Input is binary (0 / _INF_EDT).  ``square=True`` emits d^2, or
    _INF_EDT beyond ``t``; ``square=False`` emits the raw L1 distance, or
    ``t + 1`` beyond ``t`` (the composable form the sharded engine uses).
    """
    a = f.shape[0]
    sent = t + 1                      # the caller's t, not the local reach
    tl = min(t, a - 1)
    d = torch.clamp(f, max=tl + 1).to(torch.int32)
    s, reach = 1, 0
    while reach < tl:
        dp = _padded(d, s, tl + 1)
        d = torch.minimum(d, torch.minimum(dp[:a], dp[2 * s:2 * s + a]) + s)
        reach += s
        s *= 2
    if square:
        return torch.where(d > tl, _INF_EDT, d * d).to(torch.int32)
    return torch.where(d > tl, sent, d).to(torch.int32)


def _minplus_pass_plain(f: torch.Tensor, t: int, axis: int) -> torch.Tensor:
    """Plain version of the windowed min-plus pass along ``axis``:
    ``out[i] = min(f[i], min_{1<=k<=t} min(f[i-k], f[i+k]) + k^2)`` with
    _INF_EDT beyond the ends (``_minplus_pass_pallas``; inputs <= _INF_EDT,
    where a column with no finite value stays at _INF_EDT)."""
    x = f.movedim(axis, 0)
    a = x.shape[0]
    tl = min(t, a - 1)
    xp = _padded(x, tl, _INF_EDT)
    acc = x.clone()
    for k in range(1, tl + 1):
        pair = torch.minimum(xp[tl - k:tl - k + a], xp[tl + k:tl + k + a])
        acc = torch.minimum(acc, pair + k * k)
    return acc.movedim(0, axis).contiguous()


def _near_rows(near: torch.Tensor, idx: torch.Tensor, none: int = 1 << 20):
    """Per voxel of a [A, ...] mask, the nearest row at or below it and at
    or above it where ``near`` holds (``-none`` and ``A + none`` where
    there is none)."""
    a = near.shape[0]
    below = torch.where(near, idx, -none).cummax(0).values
    above = torch.where(near, idx, a + none).flip(0).cummin(0).values.flip(0)
    return below, above


def minplus_window_taps(f: torch.Tensor, t: int, axis: int):
    """The CUDA min-plus kernel's bounded window (``kernels/edt.cu``), as
    plain PyTorch on any device: each voxel's loop runs from
    k = max(1, k0), with k0 the distance along the column to the nearest
    value below _INF_EDT, while k <= t and k^2 < acc.  Returns (out, taps):
    ``out`` equals ``_minplus_pass_plain``; ``taps`` (i32) counts the
    offsets each voxel's loop needs (for t < 2047, the kernel's cap on
    k0; the kernel takes them four at a time, so it may evaluate up to
    three more).  The kernel's work model, for tests and for predicting
    its time."""
    x = f.movedim(axis, 0)
    a = x.shape[0]
    tl = min(t, a - 1)
    idx = _lead_iota(a, x.dim(), x.device).to(torch.int64).expand(x.shape)
    last, nxt = _near_rows(x < _INF_EDT, idx)
    k0 = torch.minimum(idx - last, nxt - idx)
    k = torch.clamp(k0, min=1)
    xp = _padded(x, tl, _INF_EDT)
    acc = x.clone()
    taps = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    live = (k <= tl) & (k * k < acc)
    while bool(live.any()):
        kk = torch.where(live, k, 0)
        pair = torch.minimum(xp.gather(0, tl + idx - kk),
                             xp.gather(0, tl + idx + kk))
        acc = torch.where(live, torch.minimum(acc, pair + (kk * kk).to(
            acc.dtype)), acc)
        taps += live.to(torch.int32)
        k = k + live.to(k.dtype)
        live = live & (k <= tl) & (k * k < acc)
    return (acc.movedim(0, axis).contiguous(),
            taps.movedim(0, axis).contiguous())


def binary_pass(f: torch.Tensor, t: int, square: bool = True) -> torch.Tensor:
    """First EDT pass along axis 0 of a binary (0 / _INF_EDT) i32 volume.
    CUDA tensor: the ``edt_binary`` kernel; CPU tensor: the plain version."""
    if f.is_cuda:
        return kernels.edt_binary(f, t, square)
    return _binary_pass_plain(f, t, square)


def minplus_pass(f: torch.Tensor, t: int, axis: int) -> torch.Tensor:
    """Windowed min-plus pass along ``axis`` of an i32 volume.  CUDA
    tensor: the ``edt_minplus`` kernel; CPU tensor: the plain version."""
    if f.is_cuda:
        return kernels.edt_minplus(f, t, axis)
    return _minplus_pass_plain(f, t, axis)


def binary_field(occupied: torch.Tensor) -> torch.Tensor:
    """The binary pass's input: 0 where ``occupied`` (bool, or u8 {0,1}),
    _INF_EDT elsewhere, i32."""
    if occupied.dtype == torch.uint8:
        occupied = occupied.view(torch.bool)
    return torch.full(occupied.shape, _INF_EDT, dtype=torch.int32,
                      device=occupied.device).masked_fill_(occupied, 0)


def square_l1(d: torch.Tensor, t: int) -> torch.Tensor:
    """Raw L1 distances (``binary_pass(..., square=False)``, possibly
    composed across shards) -> the squared form ``binary_pass`` gives
    (``ops/pallas/edt.py:342-345``)."""
    return torch.where(d > t, _INF_EDT, d * d).to(torch.int32)


def truncated_edt_d2(occupied: torch.Tensor, trunc_vox: int) -> torch.Tensor:
    """Exact squared EDT of ``occupied`` [X,Y,Z] (bool, or u8 {0,1} as the
    fusion drain gives it), truncated at ``trunc_vox``
    (``ops/pallas/edt.py:348-386``).

    Returns int32 [X,Y,Z]: exact |v - nearest obstacle|^2 in voxel units
    within trunc_vox of an obstacle, INF_D2 beyond.
    """
    t = int(trunc_vox)
    if t <= 0:
        return torch.full(occupied.shape, int(INF_D2), dtype=torch.int32,
                          device=occupied.device).masked_fill_(
                              occupied.to(torch.bool), 0)
    f = binary_field(occupied)
    # the JAX form clamps each pass's input at _INF_EDT; both passes emit
    # values <= _INF_EDT already, so the clamp is the identity here
    p1 = binary_pass(f, t)
    p2 = minplus_pass(p1, t, axis=1)
    p3 = minplus_pass(p2, t, axis=2)
    # min() guard: for t > 1024, t^2 exceeds _INF_EDT and "no obstacle in
    # window" values would otherwise read as finite distances
    return torch.where(p3 <= min(t * t, _INF_EDT - 1), p3, int(INF_D2))


# ---------------------------------------------------------------------------
# Closest-obstacle capability (pure Python; ops/pallas/edt.py:426-510).
# config.validate() refuses configs no closest engine can serve, so the
# port carries the same capability answers as the JAX package.
# ---------------------------------------------------------------------------


def _axis_layouts(shape):
    """Candidate (a_axis, b_axis, c_axis) assignments, preferred first:
    the x-lead layout, then the widest-C layout when they differ."""
    bits = [max(int(n - 1).bit_length(), 1) for n in shape]
    c_of_rest = 1 if bits[1] >= bits[2] else 2
    xlead = (0, 3 - c_of_rest, c_of_rest)
    c_w = int(np.argmax(bits))
    rest = [i for i in range(3) if i != c_w]
    widest = (rest[0], rest[1], c_w)
    layouts = [xlead] if xlead == widest else [xlead, widest]
    return [(a, b, c, bits[a], bits[b]) for a, b, c in layouts]


def closest_plan(shape, trunc_vox: int):
    """Axis assignment + bit layout for packed argmin tracking, or None if
    the packed representation cannot fit int32 for this (shape, t)."""
    t = int(trunc_vox)
    if t <= 0:
        return None
    cap = t * t + 1
    vbits = max(int(2 * t * t + 1).bit_length(),
                int(cap).bit_length() + 1)
    for a_axis, b_axis, c_axis, ba, bb in _axis_layouts(shape):
        if vbits + ba + bb <= 31:
            return dict(a=a_axis, b=b_axis, c=c_axis, ba=ba, bb=bb,
                        s=ba + bb, cap=cap, t=t)
    return None


def closest_plan_wide(shape, trunc_vox: int):
    """Layout for the two-word (value, payload) closest transform, or
    None when even the payload does not fit 31 bits."""
    t = int(trunc_vox)
    if t <= 0 or 2 * t * t + 1 >= 2**31:
        return None
    for a_axis, b_axis, c_axis, ba, bb in _axis_layouts(shape):
        if ba + bb <= 31:
            return dict(a=a_axis, b=b_axis, c=c_axis, ba=ba, bb=bb,
                        s=ba + bb, cap=t * t + 1, t=t)
    return None


def closest_capability(shape, trunc_vox: int) -> dict:
    """Whether closest-obstacle tracking can run on (shape, t), and with
    which engine: dict(packed, wide, oracle, detail)."""
    t = int(trunc_vox)
    packed = closest_plan(shape, t) is not None
    wide = closest_plan_wide(shape, t) is not None
    oracle = max(shape) <= 512
    ba, bb = min(((la[3], la[4]) for la in _axis_layouts(shape)),
                 key=lambda p: p[0] + p[1])
    vbits = max(int(2 * t * t + 1).bit_length(),
                int(t * t + 1).bit_length() + 1) if t > 0 else 0
    detail = (
        f"shape={tuple(shape)} t={t}: packed argmin needs value {vbits} "
        f"+ payload {ba}+{bb} = {vbits + ba + bb} bits of int32 "
        f"(limit 31) -> {'fits' if packed else 'does not fit'}; "
        f"two-word fallback needs payload {ba + bb} <= 31 -> "
        f"{'fits' if wide else 'does not fit'}; "
        f"oracle packing needs max axis {max(shape)} <= 512 -> "
        f"{'fits' if oracle else 'does not fit'}"
    )
    return dict(packed=packed, wide=wide, oracle=oracle, detail=detail)


# ---------------------------------------------------------------------------
# Packed closest transform (ops/pallas/edt.py:393-944)
#
# The argmin rides in the low bits of the int32 the distance rides in,
# ``packed = val << S | payload``, so integer min is lexicographic (value
# first, then the smaller payload).  Pass 1 (binary, along axis a) carries
# a*, pass 2 (window, along b) b* << ba | a*, and pass 3 (along c) runs two
# half-window accumulators so c* is recovered arithmetically from d2 and the
# sign of the winning side.  Each pass takes the axis it runs along, so the
# transform needs no transposes; per column the words are those of the JAX
# passes on the transposed volume.
# ---------------------------------------------------------------------------


def _binary_packed_plain(occ: torch.Tensor, plan, axis: int = 0,
                         square: bool = True) -> torch.Tensor:
    """Plain version of the packed binary pass along ``axis`` of an
    occupancy volume (bool or u8 {0,1}): the doubling steps of
    ``_binary_packed_xla``.  Returns i32 ``val << ba | a*`` with val the
    squared L1 distance to the nearest seed on the column, ``cap`` beyond
    the local reach; ``square=False`` gives the raw L1 distance and the
    caller's ``t + 1`` beyond it."""
    x = occ.movedim(axis, 0)
    a = x.shape[0]
    sent = plan["t"] + 1
    t = min(plan["t"], a - 1)
    ba, cap = plan["ba"], plan["cap"]
    fill = (t + 1) << ba
    packed = torch.where(x != 0, 0, fill).to(torch.int32) \
        | _lead_iota(a, x.dim(), x.device)
    s, reach = 1, 0
    while reach < t:
        xp = _padded(packed, s, fill)          # x[i - s] and x[i + s]
        pair = torch.minimum(xp[:a], xp[2 * s:2 * s + a])
        packed = torch.minimum(packed, pair + (s << ba))
        reach += s
        s *= 2
    d = packed >> ba
    astar = packed & ((1 << ba) - 1)
    if square:
        out = (torch.where(d > t, cap, d * d) << ba) | astar
    else:
        out = torch.where(d > t, (sent << ba) | astar, packed)
    return out.to(torch.int32).movedim(0, axis).contiguous()


def _window_packed_plain(p1: torch.Tensor, plan,
                         axis: int = 0) -> torch.Tensor:
    """Plain version of the packed paired window pass along ``axis``
    (``_window_packed_xla``): repack ``v << s | b << ba | a*``, window
    min with ``k^2 << s``, clamp the value at ``cap``."""
    packed = _window_repack(p1.movedim(axis, 0), plan)
    b = packed.shape[0]
    t = min(plan["t"], b - 1)
    s, cap = plan["s"], plan["cap"]
    xp = _padded(packed, t, cap << s)
    acc = packed
    for k in range(1, t + 1):
        pair = torch.minimum(xp[t - k:t - k + b], xp[t + k:t + k + b])
        acc = torch.minimum(acc, pair + ((k * k) << s))
    return _window_word(acc, s, cap).movedim(0, axis).contiguous()


def _window_repack(x: torch.Tensor, plan) -> torch.Tensor:
    """The window pass's words along the leading axis b: ``v << ba | a*``
    becomes ``v << s | b << ba | a*``."""
    ba, s = plan["ba"], plan["s"]
    return ((x >> ba) << s) | (_lead_iota(x.shape[0], x.dim(), x.device)
                                << ba) | (x & ((1 << ba) - 1))


def _window_word(acc: torch.Tensor, s: int, cap: int) -> torch.Tensor:
    """The window pass's output from its accumulator: the value clamped
    at ``cap``, the payload kept."""
    return (torch.clamp(acc >> s, max=cap) << s) | (acc & ((1 << s) - 1))


def _split_packed_plain(p2: torch.Tensor, plan,
                        axis: int = 0) -> torch.Tensor:
    """Plain version of the split-sign final pass along ``axis``
    (``_split_packed_xla``): one word ``val << (s+1) | sign << s | pay``,
    sign 1 when the winner lies at higher c (strict ``vp < vn``)."""
    x = p2.movedim(axis, 0)
    c = x.shape[0]
    t = min(plan["t"], c - 1)
    s, cap = plan["s"], plan["cap"]
    xp = _padded(x, t, cap << s)
    acc_n = acc_p = x
    for k in range(1, t + 1):
        kk = (k * k) << s
        acc_n = torch.minimum(acc_n, xp[t - k:t - k + c] + kk)
        acc_p = torch.minimum(acc_p, xp[t + k:t + k + c] + kk)
    return _split_word(acc_n, acc_p, s, cap).movedim(0, axis).contiguous()


def _split_word(acc_n: torch.Tensor, acc_p: torch.Tensor, s: int,
                cap: int) -> torch.Tensor:
    """The split pass's output from its two half-window accumulators:
    ``val << (s+1) | sign << s | pay``, sign 1 when the winner lies at
    higher c (strict ``vp < vn``: ties go to the negative side)."""
    vn, vp = acc_n >> s, acc_p >> s
    use_p = vp < vn
    val = torch.clamp(torch.minimum(vn, vp), max=cap)
    mask_s = (1 << s) - 1
    pay = torch.where(use_p, acc_p & mask_s, acc_n & mask_s)
    return (val << (s + 1)) | (use_p.to(torch.int32) << s) | pay


def _bounded_sides(x: torch.Tensor, tl: int, s: int, cap: int,
                   shared: bool):
    """The CUDA split and window kernels' bounded windows
    (``kernels/closest.cu``) along the leading axis of the words ``x``
    (values <= cap).  Side n runs from k0n, the distance to the nearest
    row below i whose value is below cap, side p from k0p, the nearest
    such row above i (none: no loop), each while k <= tl, the neighbour
    lies in the column and (k^2 << s) < the side's accumulator.  Side p
    starts from side n's accumulator when ``shared`` (the window pass),
    else from the centre (the split).  Returns (acc_n, acc_p, taps_n,
    taps_p), the taps (i32) counting the offsets each voxel's loops need
    (for tl < 254, the kernel's cap on k0p; the kernel takes them four at
    a time, so it may evaluate up to three more)."""
    a = x.shape[0]
    idx = _lead_iota(a, x.dim(), x.device).to(torch.int64).expand(x.shape)
    none = 1 << 20
    at_or_below, at_or_above = _near_rows((x >> s) < cap, idx, none)
    # strictly below / above: the centre is no neighbour of itself
    below = torch.cat([torch.full_like(idx[:1], -none), at_or_below[:-1]])
    above = torch.cat([at_or_above[1:], torch.full_like(idx[:1], a + none)])
    xp = _padded(x, tl, cap << s).to(torch.int64)
    acc = x.to(torch.int64)
    sides = []
    for k, kmax, sign in ((idx - below, torch.clamp(idx, max=tl), -1),
                          (above - idx, torch.clamp(a - 1 - idx, max=tl), 1)):
        if not shared:
            acc = x.to(torch.int64)
        taps = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
        live = (k <= kmax) & (((k * k) << s) < acc)
        while bool(live.any()):
            kk = torch.where(live, k, 0)
            cand = xp.gather(0, tl + idx + sign * kk) + ((kk * kk) << s)
            acc = torch.where(live, torch.minimum(acc, cand), acc)
            taps += live.to(torch.int32)
            k = k + live.to(k.dtype)
            live = live & (k <= kmax) & (((k * k) << s) < acc)
        sides.append((acc.to(torch.int32), taps))
    (acc_n, taps_n), (acc_p, taps_p) = sides
    return acc_n, acc_p, taps_n, taps_p


def split_window_taps(p2: torch.Tensor, plan, axis: int = 0):
    """The CUDA split kernel's bounded windows (``_bounded_sides``, each
    side on its own accumulator), as plain PyTorch on any device.
    Returns (out, taps_n, taps_p): ``out`` equals ``_split_packed_plain``;
    ``taps_*`` (i32) count the offsets each voxel's two loops need.  The
    kernel's work model, for tests and for predicting its time."""
    x = p2.movedim(axis, 0)
    s, cap = plan["s"], plan["cap"]
    acc_n, acc_p, taps_n, taps_p = _bounded_sides(
        x, min(plan["t"], x.shape[0] - 1), s, cap, shared=False)
    return tuple(v.movedim(0, axis).contiguous()
                 for v in (_split_word(acc_n, acc_p, s, cap), taps_n, taps_p))


def closest_window_taps(p1: torch.Tensor, plan, axis: int = 0):
    """The CUDA window kernel's bounded window (``_bounded_sides`` on the
    repacked words, side p starting from side n's accumulator), as plain
    PyTorch on any device.  Returns (out, taps): ``out`` equals
    ``_window_packed_plain``; ``taps`` (i32) counts the offsets each
    voxel's two loops need together.  The kernel's work model, for tests
    and for predicting its time."""
    x = _window_repack(p1.movedim(axis, 0), plan)
    s, cap = plan["s"], plan["cap"]
    _, acc, taps_n, taps_p = _bounded_sides(
        x, min(plan["t"], x.shape[0] - 1), s, cap, shared=True)
    return (_window_word(acc, s, cap).movedim(0, axis).contiguous(),
            (taps_n + taps_p).movedim(0, axis).contiguous())


def binary_packed(occ: torch.Tensor, plan, axis: int = 0,
                  square: bool = True) -> torch.Tensor:
    """Packed binary pass (closest pass 1) along ``axis``.  CUDA tensor
    (u8 {0,1}): the ``closest_binary`` kernel; CPU: the plain version."""
    if occ.is_cuda:
        return kernels.closest_binary(occ, plan, axis, square)
    return _binary_packed_plain(occ, plan, axis, square)


def window_packed(p1: torch.Tensor, plan, axis: int = 0) -> torch.Tensor:
    """Packed window pass (closest pass 2) along ``axis``.  CUDA tensor:
    the ``closest_window`` kernel; CPU: the plain version."""
    if p1.is_cuda:
        return kernels.closest_window(p1, plan, axis)
    return _window_packed_plain(p1, plan, axis)


def split_packed(p2: torch.Tensor, plan, axis: int = 0) -> torch.Tensor:
    """Split-sign final pass (closest pass 3) along ``axis``.  CUDA
    tensor: the ``closest_split`` kernel; CPU: the plain version."""
    if p2.is_cuda:
        return kernels.closest_split(p2, plan, axis)
    return _split_packed_plain(p2, plan, axis)


def square_packed_l1(packed: torch.Tensor, plan) -> torch.Tensor:
    """Raw packed L1 (``square=False``) -> the squared packed form the
    later passes take (``val << ba | a*``)."""
    ba, cap, t = plan["ba"], plan["cap"], plan["t"]
    d = packed >> ba
    val = torch.where(d > t, cap, d * d).to(torch.int32)
    return (val << ba) | (packed & ((1 << ba) - 1))


def unpack_split(vps: torch.Tensor, plan):
    """Decode the final word (i32 packed, or i64 wide) -> (val, sign, b*,
    a*), each i32."""
    s, ba, bb = plan["s"], plan["ba"], plan["bb"]
    parts = (vps >> (s + 1), (vps >> s) & 1, (vps >> ba) & ((1 << bb) - 1),
             vps & ((1 << ba) - 1))
    return tuple(p.to(torch.int32) for p in parts)


def _axis_iota(shape, axis: int, device, start: int = 0) -> torch.Tensor:
    view = [1, 1, 1]
    view[axis] = shape[axis]
    return torch.arange(start, start + shape[axis], dtype=torch.int32,
                        device=device).reshape(view)


def _reconstruct_closest(shape, plan, val, sign, bstar, astar,
                         packed_out: bool = False, x0: int = 0):
    """Recover c* from the winning (val, a*, b*) and the sign, and assemble
    (d2, closest) in [X,Y,Z] order: closest as one packed int32 grid
    (``grid.pack_closest`` layout, -1 undefined) when ``packed_out``, else
    int16 [3,X,Y,Z] planes.  ``x0``: the global x of the first plane of
    an X-slab whose payloads hold global x (the sharded engine)."""
    t = plan["t"]
    a_ax, b_ax, c_ax = plan["a"], plan["b"], plan["c"]
    dev = val.device
    ia, ib, ic = (_axis_iota(shape, ax, dev, x0 if ax == 0 else 0)
                  for ax in (a_ax, b_ax, c_ax))
    da, db = ia - astar, ib - bstar
    dc2 = val - da * da - db * db
    dc = torch.round(sqrt_f32(torch.clamp(dc2, min=0).to(torch.float32))
                     ).to(torch.int32)
    cstar = torch.where(sign > 0, ic + dc, ic - dc)
    valid = val <= t * t
    d2 = torch.where(valid, val, int(INF_D2))
    coords = [None, None, None]
    coords[a_ax], coords[b_ax], coords[c_ax] = astar, bstar, cstar
    if packed_out:
        if any(g > 1024 for g in shape):
            raise ValueError(f"packed closest needs every grid extent <= "
                             f"1024 (10-bit fields); got {tuple(shape)}")
        packed = (coords[0] << 20) | (coords[1] << 10) | coords[2]
        return d2, torch.where(valid, packed, -1)
    closest = torch.stack([torch.where(valid, c, -1).to(torch.int16)
                           for c in coords])
    return d2, closest


def _decode_split_plain(vps: torch.Tensor, plan, packed_out: bool = False,
                        x0: int = 0):
    """Plain version of the closest decode: ``unpack_split`` and
    ``_reconstruct_closest`` on the split pass's words ``vps`` [X,Y,Z]
    (i32, or i64 from the wide split)."""
    return _reconstruct_closest(vps.shape, plan, *unpack_split(vps, plan),
                                packed_out=packed_out, x0=x0)


def decode_split(vps: torch.Tensor, plan, packed_out: bool = False,
                 x0: int = 0):
    """(d2, closest) from the split pass's words ``vps`` [X,Y,Z] (i32, or
    i64 from the wide split), as ``_reconstruct_closest`` assembles them;
    ``x0`` as there.  CUDA tensor: the ``closest_decode`` kernel; CPU:
    the plain version."""
    if vps.is_cuda:
        return kernels.closest_decode(vps, plan, packed_out, x0)
    return _decode_split_plain(vps, plan, packed_out, x0)


def _as_u8(occupied: torch.Tensor) -> torch.Tensor:
    """Occupancy as a contiguous u8 tensor, nonzero = occupied (a bool
    tensor is viewed, not copied)."""
    occ = occupied.contiguous()
    if occ.dtype == torch.bool:
        return occ.view(torch.uint8)
    return occ if occ.dtype == torch.uint8 else (occ != 0).to(torch.uint8)


def truncated_edt_d2_closest(occupied: torch.Tensor, trunc_vox: int,
                             packed_out: bool = False):
    """Exact truncated squared EDT with per-voxel closest-obstacle
    coordinates (``ops/pallas/edt.py:912-944``).  ``occupied`` [X,Y,Z] bool
    or u8 {0,1}.  Returns (d2 i32 [X,Y,Z], closest): int16 [3,X,Y,Z] planes
    (-1 where d2 == INF_D2), or one packed int32 grid when ``packed_out``.
    d2 equals ``truncated_edt_d2``.  Needs ``closest_plan`` to fit."""
    plan = closest_plan(occupied.shape, trunc_vox)
    if plan is None:
        raise ValueError(
            f"packed closest tracking does not fit int32 for shape="
            f"{tuple(occupied.shape)} t={trunc_vox}; use "
            "truncated_edt_d2_closest_wide")
    p1 = binary_packed(_as_u8(occupied), plan, plan["a"])
    p2 = window_packed(p1, plan, plan["b"])
    vps = split_packed(p2, plan, plan["c"])
    return decode_split(vps, plan, packed_out)


# ---------------------------------------------------------------------------
# Wide (two-word) closest transform (ops/pallas/edt.py:947-1075): value and
# payload in separate int32 words, compared lexicographically; XLA in the
# JAX package.  Lexicographic min is integer min on the 64-bit word
# ``val << shift | payload`` (payload < 2^s, s <= 31, val <= 2t^2 + 1 <
# 2^31), so each pass runs on that word: a CUDA kernel for a CUDA tensor
# (``kernels.closest_*_wide``), else the pair pass below, packed into the
# word.  Each pass takes the axis it runs along, so the transform needs no
# transposes; per column the words are those of the pair passes on the
# transposed volume.
# ---------------------------------------------------------------------------


def _pair_min(h1, l1, h2, l2):
    """Lexicographic (value, payload) min."""
    take2 = (h2 < h1) | ((h2 == h1) & (l2 < l1))
    return torch.where(take2, h2, h1), torch.where(take2, l2, l1)


def _binary_pair(occ, plan):
    """Binary first pass, pair form: (val, a*) along the leading axis."""
    a = occ.shape[0]
    t = min(plan["t"], a - 1)
    l1inf = t + 1
    hi = torch.where(occ > 0, 0, l1inf).to(torch.int32)
    lo = _lead_iota(a, occ.dim(), occ.device).expand(occ.shape).contiguous()
    s, reach = 1, 0
    while reach < t:
        # the +s shift sees the -s shift's result, as in _binary_pair_xla
        for at in (0, 2 * s):                   # x[i - s], then x[i + s]
            hi, lo = _pair_min(hi, lo,
                               _padded(hi, s, l1inf)[at:at + a] + s,
                               _padded(lo, s, 0)[at:at + a])
        reach += s
        s *= 2
    return torch.where(hi > t, plan["cap"], hi * hi).to(torch.int32), lo


def _window_pair(hi, lo, plan):
    """Paired window pass, pair form: payload grows to b* << ba | a*."""
    b = hi.shape[0]
    t = min(plan["t"], b - 1)
    lo = (_lead_iota(b, hi.dim(), hi.device) << plan["ba"]) | lo
    hip, lop = _padded(hi, t, plan["cap"]), _padded(lo, t, 0)
    acc_h, acc_l = hi, lo
    for d in range(2 * t + 1):
        k = d - t
        acc_h, acc_l = _pair_min(acc_h, acc_l, hip[d:d + b] + k * k,
                                 lop[d:d + b])
    return torch.clamp(acc_h, max=plan["cap"]), acc_l


def _split_pair(hi, lo, plan):
    """Split-sign final pass, pair form: (val, sign, payload)."""
    c = hi.shape[0]
    t = min(plan["t"], c - 1)
    hip, lop = _padded(hi, t, plan["cap"]), _padded(lo, t, 0)
    an_h, an_l, ap_h, ap_l = hi, lo, hi, lo
    for k in range(1, t + 1):
        an_h, an_l = _pair_min(an_h, an_l, hip[t - k:t - k + c] + k * k,
                               lop[t - k:t - k + c])
        ap_h, ap_l = _pair_min(ap_h, ap_l, hip[t + k:t + k + c] + k * k,
                               lop[t + k:t + k + c])
    use_p = ap_h < an_h
    val = torch.clamp(torch.minimum(an_h, ap_h), max=plan["cap"])
    return val, use_p.to(torch.int32), torch.where(use_p, ap_l, an_l)


def _word(hi: torch.Tensor, lo: torch.Tensor, shift: int) -> torch.Tensor:
    """The 64-bit word ``hi << shift | lo`` of a (value, payload) pair."""
    return (hi.to(torch.int64) << shift) | lo.to(torch.int64)


def _unword(w: torch.Tensor, shift: int):
    """(value, payload) i32 of the 64-bit word ``value << shift | payload``."""
    return ((w >> shift).to(torch.int32),
            (w & ((1 << shift) - 1)).to(torch.int32))


def _binary_wide_plain(occ: torch.Tensor, plan, axis: int) -> torch.Tensor:
    """Plain version of the wide binary pass along ``axis`` of an occupancy
    volume (bool or u8 {0,1}): ``_binary_pair``'s (val, a*) as the i64
    word ``val << ba | a*``."""
    hi, lo = _binary_pair(occ.movedim(axis, 0), plan)
    return _word(hi, lo, plan["ba"]).movedim(0, axis).contiguous()


def _window_wide_plain(p1: torch.Tensor, plan, axis: int) -> torch.Tensor:
    """Plain version of the wide window pass along ``axis`` of the binary
    pass's i64 words: ``_window_pair`` as ``val << s | b* << ba | a*``."""
    hi, lo = _window_pair(*_unword(p1.movedim(axis, 0), plan["ba"]), plan)
    return _word(hi, lo, plan["s"]).movedim(0, axis).contiguous()


def _split_wide_plain(p2: torch.Tensor, plan, axis: int) -> torch.Tensor:
    """Plain version of the wide split pass along ``axis`` of the window
    pass's i64 words: ``_split_pair``'s (val, sign, payload) as
    ``val << (s+1) | sign << s | payload``."""
    s = plan["s"]
    val, sign, pay = _split_pair(*_unword(p2.movedim(axis, 0), s), plan)
    return _word(_word(val, sign, 1), pay, s).movedim(0, axis).contiguous()


def binary_wide(occ: torch.Tensor, plan, axis: int) -> torch.Tensor:
    """Wide binary pass along ``axis``.  CUDA tensor (u8 {0,1}): the
    ``closest_binary_wide`` kernel; CPU: the plain version."""
    if occ.is_cuda:
        return kernels.closest_binary_wide(occ, plan, axis)
    return _binary_wide_plain(occ, plan, axis)


def window_wide(p1: torch.Tensor, plan, axis: int) -> torch.Tensor:
    """Wide window pass along ``axis``.  CUDA tensor: the
    ``closest_window_wide`` kernel; CPU: the plain version."""
    if p1.is_cuda:
        return kernels.closest_window_wide(p1, plan, axis)
    return _window_wide_plain(p1, plan, axis)


def split_wide(p2: torch.Tensor, plan, axis: int) -> torch.Tensor:
    """Wide split pass along ``axis``.  CUDA tensor: the
    ``closest_split_wide`` kernel; CPU: the plain version."""
    if p2.is_cuda:
        return kernels.closest_split_wide(p2, plan, axis)
    return _split_wide_plain(p2, plan, axis)


def truncated_edt_d2_closest_wide(occupied: torch.Tensor, trunc_vox: int,
                                  packed_out: bool = False):
    """Exact truncated EDT + closest on grids past the int32 packing budget
    (``ops/pallas/edt.py:1047-1074``).  Same contract and results as
    ``truncated_edt_d2_closest`` where both are defined."""
    plan = closest_plan_wide(occupied.shape, trunc_vox)
    if plan is None:
        raise ValueError(
            "closest tracking unsupported even in wide form: "
            + closest_capability(occupied.shape, trunc_vox)["detail"])
    p1 = binary_wide(_as_u8(occupied), plan, plan["a"])
    p2 = window_wide(p1, plan, plan["b"])
    vps = split_wide(p2, plan, plan["c"])
    return decode_split(vps, plan, packed_out)


def edt_closest_auto(occupied: torch.Tensor, trunc_vox: int,
                     packed_out: bool = False):
    """One truncated EDT + closest: the packed transform when the int32
    budget fits, else the two-word fallback (identical results)."""
    if closest_plan(occupied.shape, trunc_vox) is not None:
        return truncated_edt_d2_closest(occupied, trunc_vox, packed_out)
    return truncated_edt_d2_closest_wide(occupied, trunc_vox, packed_out)


# ---------------------------------------------------------------------------
# Two-level (hierarchical) EDT (ops/pallas/edt.py:1089-1192): exact to
# t_fine voxels, and beyond it (up to t_total) the EDT of the 2x2x2
# any-pooled grid, upsampled.  Both levels run the passes above, so the
# kernels serve the coarse grid as they serve the fine one.
# ---------------------------------------------------------------------------


def _check_even(shape):
    if any(g % 2 for g in shape):
        raise ValueError(f"the hierarchical EDT needs even grid extents; "
                         f"got {tuple(shape)}")


def downsample2_any(occupied: torch.Tensor) -> torch.Tensor:
    """2x2x2 any-pool of an even [X,Y,Z] occupancy (bool, or u8 with
    nonzero occupied): bool [X/2,Y/2,Z/2], a block occupied when any of
    its eight voxels is (the reshape-``any`` of ``edt.py:1113-1116``, as
    a max over the u8 view)."""
    gx, gy, gz = occupied.shape
    blocks = _as_u8(occupied).reshape(gx // 2, 2, gy // 2, 2, gz // 2, 2)
    return blocks.amax(dim=(1, 3, 5)) != 0


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Each voxel of the last three axes repeated twice along each (the
    coarse level on the fine grid), one copy; leading axes kept."""
    *lead, a, b, c = x.shape
    v = x.reshape(*lead, a, 1, b, 1, c, 1).expand(*lead, a, 2, b, 2, c, 2)
    return v.reshape(*lead, 2 * a, 2 * b, 2 * c)


def _coarse_d2(d2c: torch.Tensor) -> torch.Tensor:
    """Coarse squared distances in fine voxel units (x4), INF_D2 kept."""
    return torch.where(d2c >= INF_D2, int(INF_D2), d2c * 4)


def hierarchical_edt_d2(occupied: torch.Tensor, t_fine: int,
                        t_total: int) -> torch.Tensor:
    """Two-level truncated EDT of an even [X,Y,Z] occupancy
    (``edt.py:1163-1192``): exact within ``t_fine`` voxels of an obstacle;
    beyond, up to ``t_total``, the coarse grid's EDT at ceil(t_total / 2)
    in fine units, within one coarse voxel of the truth.  i32, INF_D2
    beyond."""
    _check_even(occupied.shape)
    fine = truncated_edt_d2(occupied, t_fine)
    d2c = truncated_edt_d2(downsample2_any(occupied), -(-t_total // 2))
    return torch.where(fine < INF_D2, fine, _upsample2(_coarse_d2(d2c)))


def hierarchical_edt_d2_closest(occupied: torch.Tensor, t_fine: int,
                                t_total: int, packed_out: bool = False):
    """Two-level EDT with the closest obstacle (``edt.py:1089-1134``):
    each level through ``edt_closest_auto`` (packed passes or the wide
    fallback).  Within ``t_fine`` the closest is exact; beyond, the coarse
    level's, doubled to the even corner of the winning 2x2x2 block.
    Returns (d2, closest) as ``truncated_edt_d2_closest`` does; d2 equals
    ``hierarchical_edt_d2``.  ``packed_out`` doubles the coordinates inside
    the packed word, which stays within each 10-bit field only while every
    extent is <= 1024."""
    _check_even(occupied.shape)
    if packed_out and any(g > 1024 for g in occupied.shape):
        raise ValueError(f"packed_out needs every grid extent <= 1024; got "
                         f"{tuple(occupied.shape)}")
    fine_d2, fine_cl = edt_closest_auto(occupied, t_fine, packed_out)
    d2c, clc = edt_closest_auto(downsample2_any(occupied), -(-t_total // 2),
                                packed_out)
    use_fine = fine_d2 < INF_D2
    d2 = torch.where(use_fine, fine_d2, _upsample2(_coarse_d2(d2c)))
    # -1 is the undefined marker of both formats (grid.UNDEFINED_COORD)
    cl_up = _upsample2(torch.where(clc < 0, -1, clc * 2))
    return d2, torch.where(use_fine if packed_out else use_fine[None],
                           fine_cl, cl_up)
