"""Hand-written CUDA kernels of the port: build, load, launch.

Each ``*.cu`` file in this directory is compiled by ``nvcc`` for
``sm_90a`` (Hopper) into a shared library with a plain C interface, at
first use, into ``kernels/build/`` (one nvcc process per source, all
started together), and loaded with ``ctypes``.  A library is rebuilt only
when its source, the shared header or the flags change.

The wrappers below check their tensors (CUDA, dtype, contiguity, shape),
allocate outputs and scratch with ``torch.empty``, launch on PyTorch's
current stream without synchronising, raise if a launch was refused, and
add one to ``LAUNCHES[name]`` per call.  The ops modules call them for
CUDA tensors only; CPU tensors take the plain PyTorch versions there.

Flags: ``-fmad=false`` (no FMA contraction) and IEEE division / square
root, so the f32 arithmetic of the splat decode, the carve's free test,
the fusion step, the closest decode's root, the depth conversion and the
splat prep rounds exactly as the plain PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import itertools
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler=-fPIC", "-fmad=false", "-prec-div=true",
    "-prec-sqrt=true", "-Xptxas=-v",
)

#: per-kernel wrapper calls that launched on the card
LAUNCHES = {"splat": 0, "carve": 0, "edt_binary": 0, "edt_minplus": 0,
            "fuse": 0, "boxadd": 0, "closest_binary": 0,
            "closest_window": 0, "closest_split": 0, "closest_decode": 0,
            "closest_binary_wide": 0, "closest_window_wide": 0,
            "closest_split_wide": 0, "sort": 0, "relax": 0, "depth": 0,
            "prep": 0, "changes": 0}

#: compiler output (ptxas register/shared-memory report) per source
BUILD_LOG: dict = {}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: kernel -> (source, C symbol, argtypes); every symbol returns cudaError_t
_SIGNATURES = {
    "splat": ("splat.cu", "fiesta_splat",
              [_P, _P, _L, _P, _P, _L, _F, _P]),
    "carve": ("carve.cu", "fiesta_carve",
              [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P]),
    "edt_binary": ("edt.cu", "fiesta_edt_binary",
                   [_P, _P, _I, _L, _I, _I, _I, _P]),
    "edt_minplus": ("edt.cu", "fiesta_edt_minplus",
                    [_P, _P, _L, _I, _L, _I, _P]),
    "fuse": ("fuse.cu", "fiesta_fuse",
             [_P] * 11 + [_I, _I, _I, _F, _F, _F, _F, _F, _I, _P]),
    "boxadd": ("boxadd.cu", "fiesta_boxadd", [_P] * 5 + [_I] * 7 + [_P]),
    "closest_binary": ("closest.cu", "fiesta_closest_binary",
                       [_P, _P, _L, _I, _L, _I, _I, _I, _I, _I, _P]),
    "closest_window": ("closest.cu", "fiesta_closest_window",
                       [_P, _P, _L, _I, _L, _I, _I, _I, _I, _P]),
    "closest_split": ("closest.cu", "fiesta_closest_split",
                      [_P, _P, _L, _I, _L, _I, _I, _I, _P]),
    "closest_decode": ("closest.cu", "fiesta_closest_decode",
                       [_P, _I, _P, _P, _P] + [_I] * 12 + [_P]),
    "closest_binary_wide": ("closest.cu", "fiesta_closest_binary_wide",
                            [_P, _P, _L, _I, _L, _I, _I, _I, _I, _P]),
    "closest_window_wide": ("closest.cu", "fiesta_closest_window_wide",
                            [_P, _P, _L, _I, _L, _I, _I, _I, _I, _P]),
    "closest_split_wide": ("closest.cu", "fiesta_closest_split_wide",
                           [_P, _P, _L, _I, _L] + [_I] * 5 + [_P]),
    "sort": ("sort.cu", "fiesta_sort_pairs", [_P, _P, _L, _P, _P, _L, _P]),
    "relax": ("relax.cu", "fiesta_relax",
              [_P] * 10 + [_I] * 4 + [_P, _I, _I, _P, _I, _I, _I, _P, _P,
                                       _P]),
    "depth": ("depth.cu", "fiesta_depth",
              [_P] * 4 + [_I] * 3 + [_F] * 7 + [_I, _I] + [_P] * 4),
    "prep": ("prep.cu", "fiesta_prep",
             [_P] * 3 + [_I] + [_P] * 3 + [_I, _L] + [_I] * 10 + [_F] * 12
             + [_P] * 6),
    "changes": ("changes.cu", "fiesta_changes",
                [_P] * 8 + [_I] * 4 + [_F, _I, _I, _P]),
}
SOURCES = tuple(sorted({s for s, _, _ in _SIGNATURES.values()}))

_libs: dict = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build fiesta_tpu_torch's kernels")
    return path


def _compile(sources) -> dict:
    """Compile ``sources`` where needed, one nvcc process each, all
    started together, and load them.  Returns {source: ctypes.CDLL};
    raises with nvcc's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    headers = b"".join(h.read_bytes() for h in sorted(_HERE.glob("*.cuh")))
    targets, procs = {}, {}
    for src in sources:
        digest = hashlib.sha256((_HERE / src).read_bytes() + headers +
                                " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"{Path(src).stem}-{digest}.so"
        targets[src] = so
        log = so.with_name(f"{so.name}.log")
        if so.exists() and log.exists():  # built earlier: its report
            BUILD_LOG[src] = log.read_text()
        if not so.exists():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            procs[src] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_HERE / src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for src, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        BUILD_LOG[src] = out + err
        if proc.returncode:
            errors.append(f"{src}: nvcc exited {proc.returncode}\n{err}")
        else:
            os.replace(tmp, targets[src])
            targets[src].with_name(f"{targets[src].name}.log").write_text(
                BUILD_LOG[src])
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    libs = {}
    for src in sources:
        lib = ctypes.CDLL(str(targets[src]))
        lib.fiesta_cuda_error_string.argtypes = [_I]
        lib.fiesta_cuda_error_string.restype = ctypes.c_char_p
        if src == "carve.cu":
            lib.fiesta_carve_cluster_size.argtypes = [_I] * 4
            lib.fiesta_carve_cluster_size.restype = _I
        if src == "closest.cu":
            lib.fiesta_closest_binary_tile_cols.argtypes = [_I, _I]
            lib.fiesta_closest_binary_tile_cols.restype = _I
            lib.fiesta_closest_split_wide_fits_u32.argtypes = [_I] * 3
            lib.fiesta_closest_split_wide_fits_u32.restype = _I
            lib.fiesta_closest_split_wide_residency.argtypes = \
                [_I, _L] + [_I] * 3 + [_P]
            lib.fiesta_closest_split_wide_residency.restype = _I
        for s, sym, argtypes in _SIGNATURES.values():
            if s == src:
                getattr(lib, sym).argtypes = argtypes
                getattr(lib, sym).restype = _I
        libs[src] = lib
    return libs


def build() -> dict:
    """Compile (where needed) and load every kernel library.  Returns
    {source: ctypes.CDLL}; raises with nvcc's output if a build fails."""
    _libs.update(_compile([s for s in SOURCES if s not in _libs]))
    return _libs


def _launch(name: str, device: torch.device, *args) -> None:
    src, sym, _ = _SIGNATURES[name]
    lib = _libs.get(src) or build()[src]
    fn = getattr(lib, sym)
    # PyTorch's current stream on ``device``, as a raw handle; the launch
    # goes to the calling thread's current device, so switch only when the
    # tensors lie on another
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc:
        msg = lib.fiesta_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def _check(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _same_device(what: str, first: torch.Tensor, *rest: torch.Tensor):
    if any(t.device != first.device for t in rest):
        raise ValueError(f"{what}: tensors on different devices")


def _columns(shape, axis: int):
    """(outer, A, inner) of a contiguous volume walked along ``axis``."""
    axis = axis % len(shape)
    return (int(np.prod(shape[:axis], dtype=np.int64)), int(shape[axis]),
            int(np.prod(shape[axis + 1:], dtype=np.int64)))


def splat(lin: torch.Tensor, val: torch.Tensor, n: int, thr: float):
    """Zero-fill an f32 target of ``n`` cells, scatter-max ``val`` [R] at
    ``lin`` [R] (indices outside [0, n) dropped), decode into (seeds f32,
    hit u8, epfree u8) [n].  Replaces ``fill.zeros_f32``,
    ``fill.decode_packed_splat`` and the scatter-max between them.  With
    R = 0 only the zero fills launch (two CUDA launches, else four)."""
    _check(lin, torch.int32, "splat lin")
    _check(val, torch.float32, "splat val")
    if lin.shape != val.shape or lin.dim() != 1:
        raise ValueError("splat: lin and val must be matching 1-D tensors")
    if lin.device != val.device:
        raise ValueError("splat: lin and val on different devices")
    dev = lin.device
    # fresh allocations, 16-byte aligned as the fills' stores need: the
    # seeds with the gather's per-ray scratch after them, and both masks
    r = lin.numel()
    seeds = torch.empty(n + r, dtype=torch.float32, device=dev)
    masks = torch.empty((2, n), dtype=torch.uint8, device=dev)
    _launch("splat", dev, lin.data_ptr(), val.data_ptr(), r,
            seeds.data_ptr(), masks.data_ptr(), n, float(np.float32(thr)))
    hit, epfree = masks.unbind(0)
    return seeds[:n], hit, epfree


def carve(seeds: torch.Tensor, po: torch.Tensor, res: float,
          min_ray: float, max_ray: float) -> torch.Tensor:
    """Octant wavefront carve of K scans: seeds [K,BX,BY,BZ] f32, po [K,3]
    f32 (sensor in box index units) -> free mask [K,BX,BY,BZ] bool, in two
    CUDA launches (the mask's zero fill, then every wavefront's sweep).
    Allocates only the mask.  Replaces ``carve.octant_free_sweep_pallas``."""
    _check(seeds, torch.float32, "carve seeds")
    _check(po, torch.float32, "carve po")
    if seeds.dim() != 4 or tuple(po.shape) != (seeds.shape[0], 3):
        raise ValueError("carve: expected seeds [K,BX,BY,BZ] and po [K,3]")
    if po.device != seeds.device:
        raise ValueError("carve: seeds and po on different devices")
    k, bx, by, bz = seeds.shape
    # a fresh allocation: 16-byte aligned, as the zero fill's stores need
    free = torch.empty(seeds.shape, dtype=torch.uint8, device=seeds.device)
    _launch("carve", seeds.device, seeds.data_ptr(), po.data_ptr(), k, bx,
            by, bz, float(np.float32(res)), float(np.float32(1.0 / res)),
            float(np.float32((min_ray / res) ** 2)),
            float(np.float32((max_ray / res) ** 2)), free.data_ptr())
    return free.view(torch.bool)


def carve_cluster_size(shape) -> int:
    """Thread blocks per wavefront cluster of the carve's sweep for seeds
    of ``shape`` [K,BX,BY,BZ] on the current CUDA device (chosen once per
    device and shape)."""
    lib = _libs.get("carve.cu") or build()["carve.cu"]
    cs = lib.fiesta_carve_cluster_size(*(int(n) for n in shape))
    if cs <= 0:
        msg = lib.fiesta_cuda_error_string(-cs).decode() if cs else \
            "no cluster size fits the box"
        raise RuntimeError(f"carve cluster size for {tuple(shape)}: {msg}")
    return cs


_INF_EDT = 1 << 20


def edt_binary(f: torch.Tensor, t: int, square: bool = True) -> torch.Tensor:
    """Binary first EDT pass along axis 0 of a 0/_INF_EDT i32 volume:
    d^2 within ``t`` (else _INF_EDT), or the raw L1 distance (else t + 1)
    when ``square`` is False.  Replaces ``edt._binary_pass_pallas``."""
    _check(f, torch.int32, "edt_binary f")
    a = f.shape[0]
    out = torch.empty_like(f)
    tl = min(t, a - 1)
    far = _INF_EDT if square else t + 1
    _launch("edt_binary", f.device, f.data_ptr(), out.data_ptr(), a,
            f.numel() // a, tl, far, int(square))
    return out


def edt_minplus(f: torch.Tensor, t: int, axis: int) -> torch.Tensor:
    """Windowed min-plus pass ``min_{|k|<=t} f[i+k] + k^2`` along ``axis``
    of an i32 volume (values <= _INF_EDT), walking strided columns in
    place of transposes.  Replaces ``edt._minplus_pass_pallas``."""
    _check(f, torch.int32, "edt_minplus f")
    outer, a, inner = _columns(f.shape, axis)
    out = torch.empty_like(f)
    _launch("edt_minplus", f.device, f.data_ptr(), out.data_ptr(), outer, a,
            inner, min(t, a - 1))
    return out


def fuse(logodds: torch.Tensor, seen: torch.Tensor, hit_cnt: torch.Tensor,
         miss_cnt: torch.Tensor, l_hit: float, l_miss: float,
         clamp_min: float, clamp_max: float, occ_thresh: float,
         occ_is_eq: bool, window=None):
    """One-pass fusion drain over [X,Y,Z] grids: returns (new log-odds
    f32, new seen u8, occupancy u8, zeroed hit u8, zeroed miss u8,
    n_observed, n_inserted, n_deleted) with the counts as 0-dim i32.
    ``window`` (wmin [3] i32, wmax [3] i32 on the grids' device): only
    observations inside the inclusive window apply.  Every output is a new
    tensor; the inputs are left as they are.  Replaces
    ``fuse.fuse_counts_pallas`` (global and windowed)."""
    _check(logodds, torch.float32, "fuse logodds")
    for t, what in ((seen, "seen"), (hit_cnt, "hit_cnt"),
                    (miss_cnt, "miss_cnt")):
        _check(t, torch.uint8, f"fuse {what}")
        if t.shape != logodds.shape:
            raise ValueError(f"fuse: {what} shape {tuple(t.shape)} != "
                             f"{tuple(logodds.shape)}")
    if logodds.dim() != 3:
        raise ValueError("fuse: expected [X,Y,Z] grids")
    _same_device("fuse", logodds, seen, hit_cnt, miss_cnt)
    # the kernel reads four voxels per 16-byte f32 / 4-byte u8 access
    if any(t.data_ptr() % 16 for t in (logodds, seen, hit_cnt, miss_cnt)):
        raise ValueError("fuse: inputs must start 16-byte aligned")
    dev = logodds.device
    lo_o = torch.empty_like(logodds)
    seen_o, occ, hit_o, miss_o = (torch.empty_like(seen) for _ in range(4))
    counts = torch.zeros(3, dtype=torch.int32, device=dev)
    bounds = None        # global update: every observation applies
    if window is not None:
        bounds = torch.cat([w.reshape(3) for w in window])
        _check(bounds, torch.int32, "fuse window")
        _same_device("fuse", logodds, bounds)
    gx, gy, gz = logodds.shape
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    _launch("fuse", dev, logodds.data_ptr(), seen.data_ptr(),
            hit_cnt.data_ptr(), miss_cnt.data_ptr(), lo_o.data_ptr(),
            seen_o.data_ptr(), occ.data_ptr(), hit_o.data_ptr(),
            miss_o.data_ptr(), counts.data_ptr(),
            None if bounds is None else bounds.data_ptr(), gx, gy,
            gz, f32(l_hit), f32(l_miss), f32(clamp_min), f32(clamp_max),
            f32(occ_thresh), int(bool(occ_is_eq)))
    return (lo_o, seen_o, occ, hit_o, miss_o, counts[0], counts[1],
            counts[2])


def boxadd(hit_cnt: torch.Tensor, miss_cnt: torch.Tensor,
           starts: torch.Tensor, box_hit: torch.Tensor,
           box_miss: torch.Tensor):
    """Add K boxes' u8 counts [K,BX,BY,BZ] into the u8 grids [X,Y,Z] at
    the corners ``starts`` [K,3] i32, saturating at 255, as K in-order
    saturating adds.  Updates ``hit_cnt`` and ``miss_cnt`` IN PLACE and
    returns them.  Replaces ``boxadd.box_add_inplace``."""
    for t, what in ((hit_cnt, "hit_cnt"), (miss_cnt, "miss_cnt"),
                    (box_hit, "box_hit"), (box_miss, "box_miss")):
        _check(t, torch.uint8, f"boxadd {what}")
    _check(starts, torch.int32, "boxadd starts")
    if hit_cnt.dim() != 3 or miss_cnt.shape != hit_cnt.shape:
        raise ValueError("boxadd: expected two [X,Y,Z] grids")
    if box_hit.dim() != 4 or box_miss.shape != box_hit.shape or \
            tuple(starts.shape) != (box_hit.shape[0], 3):
        raise ValueError("boxadd: expected boxes [K,BX,BY,BZ] and starts "
                         "[K,3]")
    _same_device("boxadd", hit_cnt, miss_cnt, starts, box_hit, box_miss)
    k, bx, by, bz = box_hit.shape
    gx, gy, gz = hit_cnt.shape
    _launch("boxadd", hit_cnt.device, hit_cnt.data_ptr(),
            miss_cnt.data_ptr(), starts.data_ptr(), box_hit.data_ptr(),
            box_miss.data_ptr(), k, bx, by, bz, gx, gy, gz)
    return hit_cnt, miss_cnt


def _check_closest(t: torch.Tensor, axis: int, bits, what: str) -> None:
    """A 3-D volume whose extent along ``axis`` fits ``bits`` payload bits
    (``None``: the axis carries no payload)."""
    if t.dim() != 3:
        raise ValueError(f"{what}: expected an [X,Y,Z] volume")
    if bits is not None and t.shape[axis] > 1 << bits:
        raise ValueError(f"{what}: axis {axis} of extent {t.shape[axis]} "
                         f"does not fit the plan's {bits} payload bits")


def _binary_reach(t: int) -> int:
    """Total offset covered by the TPU pass's doubling steps 1, 2, 4, ...
    for local reach ``t``."""
    s, reach = 1, 0
    while reach < t:
        reach += s
        s *= 2
    return reach


def closest_binary(occ: torch.Tensor, plan, axis: int,
                   square: bool = True) -> torch.Tensor:
    """Packed binary closest pass along ``axis`` of an occupancy volume
    (u8 nonzero = occupied, or bool): i32 ``val << ba | a*``.  Replaces
    ``edt._binary_packed_pallas``."""
    if occ.dtype == torch.bool:
        occ = occ.view(torch.uint8)
    _check(occ, torch.uint8, "closest_binary occ")
    _check_closest(occ, axis, plan["ba"], "closest_binary")
    outer, a, inner = _columns(occ.shape, axis)
    tl = min(plan["t"], a - 1)
    out = torch.empty(occ.shape, dtype=torch.int32, device=occ.device)
    far = plan["cap"] if square else plan["t"] + 1
    _launch("closest_binary", occ.device, occ.data_ptr(), out.data_ptr(),
            outer, a, inner, tl, plan["ba"], far,
            int(_binary_reach(tl) > tl), int(square))
    return out


def closest_binary_tile_cols(shape, plan, axis: int) -> int:
    """Columns per thread block of the ``closest_binary`` kernel along
    ``axis`` of a volume of ``shape`` (its tiles are runs of that many
    consecutive columns, in [outer, inner] order)."""
    lib = _libs.get("closest.cu") or build()["closest.cu"]
    a = shape[axis]
    return lib.fiesta_closest_binary_tile_cols(a, min(plan["t"], a - 1))


def closest_window(p1: torch.Tensor, plan, axis: int) -> torch.Tensor:
    """Packed paired window closest pass along ``axis`` of an i32 volume
    (values <= cap): ``val << s | b* << ba | a*``.  Replaces
    ``edt._window_packed_pallas``."""
    _check(p1, torch.int32, "closest_window p1")
    _check_closest(p1, axis, plan["bb"], "closest_window")
    outer, a, inner = _columns(p1.shape, axis)
    out = torch.empty_like(p1)
    _launch("closest_window", p1.device, p1.data_ptr(), out.data_ptr(),
            outer, a, inner, min(plan["t"], a - 1), plan["ba"], plan["s"],
            plan["cap"])
    return out


def closest_split(p2: torch.Tensor, plan, axis: int) -> torch.Tensor:
    """Split-sign final closest pass along ``axis`` of an i32 volume
    (values <= cap): ``val << (s+1) | sign << s | pay``.  Replaces
    ``edt._split_packed_pallas``."""
    _check(p2, torch.int32, "closest_split p2")
    _check_closest(p2, axis, None, "closest_split")
    outer, a, inner = _columns(p2.shape, axis)
    out = torch.empty_like(p2)
    _launch("closest_split", p2.device, p2.data_ptr(), out.data_ptr(),
            outer, a, inner, min(plan["t"], a - 1), plan["s"], plan["cap"])
    return out


def _check_wide(plan, what: str) -> None:
    """A wide plan whose 64-bit words the kernels take: values up to
    2t^2 + 1 below 2^31 (so k^2, k <= t, fits an int) and a shift of at
    most 31, so every word and candidate lies below 2^62."""
    t, s = plan["t"], plan["s"]
    if 2 * t * t + 1 >= 1 << 31 or s > 31:
        raise ValueError(f"{what}: t = {t}, shift {s} do not fit the wide "
                         "kernels' 64-bit words")


def closest_binary_wide(occ: torch.Tensor, plan, axis: int) -> torch.Tensor:
    """Wide binary closest pass along ``axis`` of an occupancy volume (u8
    nonzero = occupied, or bool): i64 ``val << ba | a*``, the pair pass's
    (val, a*) as one word.  Replaces ``edt._binary_pair_xla`` (XLA, no
    Pallas kernel)."""
    if occ.dtype == torch.bool:
        occ = occ.view(torch.uint8)
    _check(occ, torch.uint8, "closest_binary_wide occ")
    _check_closest(occ, axis, plan["ba"], "closest_binary_wide")
    _check_wide(plan, "closest_binary_wide")
    outer, a, inner = _columns(occ.shape, axis)
    tl = min(plan["t"], a - 1)
    out = torch.empty(occ.shape, dtype=torch.int64, device=occ.device)
    _launch("closest_binary_wide", occ.device, occ.data_ptr(),
            out.data_ptr(), outer, a, inner, tl, plan["ba"], plan["cap"],
            int(_binary_reach(tl) > tl))
    return out


def closest_window_wide(p1: torch.Tensor, plan, axis: int) -> torch.Tensor:
    """Wide paired window closest pass along ``axis`` of an i64 volume
    (values <= cap): ``val << s | b* << ba | a*``.  Replaces
    ``edt._window_pair_xla`` (XLA, no Pallas kernel)."""
    _check(p1, torch.int64, "closest_window_wide p1")
    _check_closest(p1, axis, plan["bb"], "closest_window_wide")
    _check_wide(plan, "closest_window_wide")
    outer, a, inner = _columns(p1.shape, axis)
    out = torch.empty_like(p1)
    _launch("closest_window_wide", p1.device, p1.data_ptr(), out.data_ptr(),
            outer, a, inner, min(plan["t"], a - 1), plan["ba"], plan["s"],
            plan["cap"])
    return out


def split_wide_word_bits(plan, a: int) -> int:
    """Tile word bits of the wide split along a column of ``a`` rows: 32
    where every word it compares fits u32, else 64.  Its inputs are <= cap
    with payloads below 2^s, and a side adds k^2 << s for k <= tl =
    min(t, a - 1), so the largest is ((cap + tl^2 + 1) << s) - 1: 32 bits
    iff (cap + tl^2 + 1) << s <= 2^32."""
    tl = min(plan["t"], a - 1)
    return 32 if (plan["cap"] + tl * tl + 1) << plan["s"] <= 1 << 32 else 64


def split_wide_fits_u32(plan, a: int) -> bool:
    """The C launcher's own rule for u32 tile words along a column of
    ``a`` rows (``split_wide_fits_u32`` in ``closest.cu``), which refuses
    u32 words past it; ``split_wide_word_bits`` is the wrapper's, and the
    two must agree."""
    lib = _libs.get("closest.cu") or build()["closest.cu"]
    return bool(lib.fiesta_closest_split_wide_fits_u32(
        min(plan["t"], a - 1), plan["s"], plan["cap"]))


def _closest_split_wide(p2: torch.Tensor, plan, axis: int, bits=None,
                        rows=0) -> torch.Tensor:
    """``closest_split_wide`` with test overrides: ``bits`` 64 takes u64
    tile words where u32 would do, ``rows`` > 0 sets the chunk rows (0:
    the launcher's own)."""
    _check(p2, torch.int64, "closest_split_wide p2")
    _check_closest(p2, axis, None, "closest_split_wide")
    _check_wide(plan, "closest_split_wide")
    outer, a, inner = _columns(p2.shape, axis)
    fit = split_wide_word_bits(plan, a)
    bits = bits or fit
    if bits < fit:
        raise ValueError(f"closest_split_wide: the plan's words need {fit} "
                         f"bits; got {bits}")
    out = torch.empty_like(p2)
    _launch("closest_split_wide", p2.device, p2.data_ptr(), out.data_ptr(),
            outer, a, inner, min(plan["t"], a - 1), plan["s"], plan["cap"],
            bits // 8, rows)
    return out


def closest_split_wide(p2: torch.Tensor, plan, axis: int) -> torch.Tensor:
    """Wide split-sign final closest pass along ``axis`` of an i64 volume
    (values <= cap): ``val << (s+1) | sign << s | pay``, on u32 tile words
    where ``split_wide_word_bits`` allows, in row chunks the launcher sizes
    for residency (``closest.cu``'s ``split_tiles``).  Replaces
    ``edt._split_pair_xla`` (XLA, no Pallas kernel)."""
    return _closest_split_wide(p2, plan, axis)


def closest_split_wide_residency(shape, plan, axis: int, bits=None,
                                 rows=0) -> dict:
    """The wide split's launch along ``axis`` of a volume of ``shape`` as
    the card runs it (``bits`` and ``rows`` as ``_closest_split_wide``
    takes them): threads, shared bytes, resident blocks and warps an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local (spill) bytes a thread, tile word bytes, columns, chunk rows."""
    lib = _libs.get("closest.cu") or build()["closest.cu"]
    _, a, inner = _columns(shape, axis)
    tl = min(plan["t"], a - 1)
    bits = bits or split_wide_word_bits(plan, a)
    vals = (ctypes.c_int * 8)()
    rc = lib.fiesta_closest_split_wide_residency(a, inner, tl, bits // 8,
                                                 rows, vals)
    if rc:
        msg = lib.fiesta_cuda_error_string(rc).decode()
        raise RuntimeError(f"closest_split_wide residency: {msg} ({rc})")
    out = dict(zip(("threads", "smem_bytes", "blocks_per_sm", "registers",
                    "local_bytes", "word_bytes", "tile_cols", "chunk_rows"),
                   vals))
    out["warps_per_sm"] = out["blocks_per_sm"] * out["threads"] // 32
    return out


def closest_decode(vps: torch.Tensor, plan, packed_out: bool = False,
                   x0: int = 0):
    """Decode the split pass's words ``vps`` [X,Y,Z] (i32 packed, or i64
    from the wide split) into (d2 i32, closest): closest as one packed i32
    grid (``grid.pack_closest`` layout) when ``packed_out``, else i16
    [3,X,Y,Z] planes, -1 where d2 is INF_D2.  ``x0``: the global x of the
    first plane of an X-slab whose payloads hold global x.  Replaces
    ``edt._reconstruct_closest`` with ``unpack_split`` (XLA, no Pallas
    kernel)."""
    from ..grid import INF_D2

    if vps.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"closest_decode vps: expected int32 or int64, got "
                         f"{vps.dtype}")
    _check(vps, vps.dtype, "closest_decode vps")
    _check_closest(vps, 0, None, "closest_decode")
    shape = tuple(vps.shape)
    if packed_out and any(g > 1024 for g in shape):
        raise ValueError(f"packed closest needs every grid extent <= 1024 "
                         f"(10-bit fields); got {shape}")
    dev = vps.device
    d2 = torch.empty(shape, dtype=torch.int32, device=dev)
    if packed_out:
        closest = torch.empty(shape, dtype=torch.int32, device=dev)
        packed, planes = closest.data_ptr(), None
    else:
        closest = torch.empty((3,) + shape, dtype=torch.int16, device=dev)
        packed, planes = None, closest.data_ptr()
    _launch("closest_decode", dev, vps.data_ptr(),
            int(vps.dtype == torch.int64), d2.data_ptr(), packed, planes,
            *shape, plan["a"], plan["b"], plan["c"], plan["ba"], plan["bb"],
            plan["s"], plan["t"] * plan["t"], int(x0), int(INF_D2))
    return d2, closest


#: the sort's pad key; real keys must lie below it
SORT_SENTINEL = 0x7FFFFFFF


def sort_padded_size(n: int) -> int:
    """Padded length of the sort network: max(256, next power of two >=
    n) (``sort.py:70``)."""
    return max(256, 1 << max(n - 1, 0).bit_length())


def sort_pairs(keys: torch.Tensor, vals: torch.Tensor):
    """Bitonic sort of (keys i32 [N], vals f32 [N]) ascending by key, on a
    padded scratch of ``sort_padded_size(N)`` pairs (pad key
    ``SORT_SENTINEL``, pad value 0), in one cooperative CUDA launch.  Returns
    (keys [N], vals [N]), views of the scratch's first N pairs.  Replaces
    ``sort.sort_pairs``."""
    _check(keys, torch.int32, "sort keys")
    _check(vals, torch.float32, "sort vals")
    if keys.dim() != 1 or keys.shape != vals.shape or keys.numel() == 0:
        raise ValueError("sort: keys and vals must be matching non-empty "
                         "1-D tensors")
    _same_device("sort", keys, vals)
    n = keys.numel()
    n_pad = sort_padded_size(n)
    if n_pad > 1 << 30:
        raise ValueError(f"sort: {n} pairs exceed the kernel's 2^30")
    k_out = torch.empty(n_pad, dtype=torch.int32, device=keys.device)
    v_out = torch.empty(n_pad, dtype=torch.float32, device=keys.device)
    _launch("sort", keys.device, keys.data_ptr(), vals.data_ptr(), n,
            k_out.data_ptr(), v_out.data_ptr(), n_pad)
    return k_out[:n], v_out[:n]


#: directions a ``relax_to_fixpoint`` call takes, at most (``relax.cu``)
RELAX_MAX_DIRS = 128
#: the relax kernel's tile of voxels along (x, y, z): its unit of activity
#: (``relax.cu``: 256 threads, 4 voxels each, z the contiguous axis)
RELAX_TILE = (8, 8, 16)
#: tile offsets a call's marking table holds, at most (``relax.cu``)
RELAX_MAX_TILE_OFFSETS = 320
#: sweeps of a call whose visited tiles ``relax_sweeps``' state records
RELAX_LOG_SWEEPS = 1024


def relax_tile_offsets(dirs, tile=RELAX_TILE):
    """The tiles that a tile with a changed voxel activates for the next
    sweep, as offsets (dx, dy, dz) in tiles: for every direction d and
    every voxel u of a tile of shape ``tile``, the tile of the receiver
    u - d (which pulls from u), and the tile itself (visited in the next
    sweep, it brings its other buffer up to date).  Built from the call's
    own direction table; sorted."""
    offs = {(0, 0, 0)}
    for d in dirs:
        offs.update(itertools.product(*(
            sorted({(m - int(o)) // t for m in range(t)})
            for o, t in zip(d, tile))))
    return tuple(sorted(offs))


@functools.lru_cache(maxsize=64)
def _relax_tables(dirs):
    """The launch's host tables for the direction tuple ``dirs``, built
    and checked once (the sharded relaxation launches once a sweep a
    shard): (directions [3, n] i16 in ``esdf.consideration_order``, the
    count of reach <= 2 among them, tile offsets [3, m] i16)."""
    from ..ops.esdf import consideration_order

    small, jumps = consideration_order(dirs)
    order = small + jumps
    if len(order) > RELAX_MAX_DIRS:
        raise ValueError(f"relax: {len(order)} directions exceed the "
                         f"kernel's {RELAX_MAX_DIRS}")
    table = np.ascontiguousarray(np.array(order, np.int64).reshape(-1, 3).T)
    if np.abs(table).max(initial=0) >= 1 << 15:
        raise ValueError("relax: an offset does not fit the kernel's int16 "
                         "direction table")
    toffs = np.ascontiguousarray(
        np.array(relax_tile_offsets(order), np.int16).T)
    if toffs.shape[1] > RELAX_MAX_TILE_OFFSETS:
        raise ValueError(f"relax: {toffs.shape[1]} tile offsets exceed the "
                         f"kernel's {RELAX_MAX_TILE_OFFSETS}")
    table = table.astype(np.int16)
    table.flags.writeable = toffs.flags.writeable = False
    return table, len(small), toffs


def _relax_mask(mask, d2: torch.Tensor, what: str):
    """A bool or u8 [X,Y,Z] mask as the kernel's u8 pointer (None: 0)."""
    if mask is None:
        return None
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    _check(mask, torch.uint8, f"relax {what}")
    if mask.shape != d2.shape:
        raise ValueError(f"relax {what}: shape {tuple(mask.shape)} != "
                         f"{tuple(d2.shape)}")
    _same_device(f"relax {what}", d2, mask)
    return mask


def relax_to_fixpoint(d2: torch.Tensor, closest: torch.Tensor, update_mask,
                      source_mask, dirs, max_iters: int = 0,
                      push_src_mask=None, push_recv_mask=None,
                      x_offset: int = 0):
    """Sweep the incremental ESDF's relaxation (``esdf.relax_once``) to its
    fixpoint, or ``max_iters`` sweeps when > 0, in one cooperative CUDA
    launch: d2 [X,Y,Z] i32 and closest [3,X,Y,Z] i16 in, (d2, closest,
    num_sweeps 0-dim i32) out, new tensors, nothing read back.  ``dirs``
    are the stencil offsets (taken in ``esdf.consideration_order``);
    masks are bool or u8 [X,Y,Z] or None, the push masks both or neither.
    ``x_offset``: the global x of the grid's first plane when it is an
    X-slab of a larger grid whose closest coordinates are global (0: the
    whole grid).  Replaces ``esdf.relax_to_fixpoint``'s ``lax.while_loop``
    (no Pallas kernel)."""
    d2_out, c_out, state = relax_sweeps(
        d2, closest, update_mask, source_mask, dirs, max_iters,
        push_src_mask, push_recv_mask, x_offset=x_offset)
    return d2_out, c_out, state[1]


def relax_sweeps(d2: torch.Tensor, closest: torch.Tensor, update_mask,
                 source_mask, dirs, max_iters: int = 0, push_src_mask=None,
                 push_recv_mask=None, x_offset: int = 0):
    """``relax_to_fixpoint``'s launch, returning (d2, closest, state):
    ``state`` is the kernel's i32 scratch on the card, [3 +
    ``RELAX_LOG_SWEEPS``], holding the sweep count at [1], the
    cooperative grid's blocks at [2], the tiles visited in sweep k at
    [3 + k], and at [0] the last sweep, plus one, in which a d2 fell (with
    ``max_iters`` 1: 1 when the sweep changed something, else 0).  After the first, dense sweep the kernel visits only the
    tiles of ``RELAX_TILE`` voxels that ``relax_tile_offsets`` marks from
    the tiles that changed, and pulls only from neighbours that changed.
    ``x_offset`` as in ``relax_to_fixpoint``."""
    _check(d2, torch.int32, "relax d2")
    _check(closest, torch.int16, "relax closest")
    if d2.dim() != 3 or tuple(closest.shape) != (3,) + tuple(d2.shape):
        raise ValueError("relax: expected d2 [X,Y,Z] and closest [3,X,Y,Z]")
    _same_device("relax", d2, closest)
    gx, gy, gz = d2.shape
    # int16 coordinates, int32 voxel indices and int32 candidates, over the
    # x extent that the slab's global coordinates span
    xg = gx + abs(int(x_offset))
    if max(xg, gy, gz) >= 1 << 15 or d2.numel() >= 1 << 31 or \
            (xg - 1) ** 2 + (gy - 1) ** 2 + (gz - 1) ** 2 >= 1 << 31:
        raise ValueError(f"relax: grid {tuple(d2.shape)} does not fit the "
                         "kernel's int16 coordinates and int32 indices")
    if (push_src_mask is None) != (push_recv_mask is None):
        raise ValueError("relax: push_src_mask and push_recv_mask go "
                         "together")
    table, nsmall, toffs = _relax_tables(
        tuple(tuple(int(o) for o in d) for d in dirs))
    if not 0 <= int(max_iters) < 1 << 31:
        raise ValueError(f"relax: max_iters {max_iters} out of range")
    masks = [_relax_mask(m, d2, what) for m, what in (
        (update_mask, "update_mask"), (source_mask, "source_mask"),
        (push_src_mask, "push_src_mask"), (push_recv_mask, "push_recv_mask"))]
    d2_out, d2_scr = torch.empty_like(d2), torch.empty_like(d2)
    c_out = torch.empty_like(closest)
    # two buffers of packed closest words (8 bytes a voxel); state: the
    # changed stamp, the sweep count, the grid's blocks, tiles visited per
    # sweep; aux per
    # tile: the activity stamp, the changed stamp of each sweep parity, and
    # each parity's changed bits (a u16 per z row); three lists of tiles
    # to visit, with their counts and cursors
    words = torch.empty(2 * d2.numel(), dtype=torch.int64, device=d2.device)
    state = torch.empty(3 + RELAX_LOG_SWEEPS, dtype=torch.int32,
                        device=d2.device)
    ntiles = int(np.prod([-(-n // t)
                          for n, t in zip(d2.shape, RELAX_TILE)]))
    rows = RELAX_TILE[0] * RELAX_TILE[1]
    aux = torch.empty(ntiles * (6 + rows) + 6, dtype=torch.int32,
                      device=d2.device)
    _launch("relax", d2.device, d2.data_ptr(), closest.data_ptr(),
            d2_out.data_ptr(), c_out.data_ptr(), d2_scr.data_ptr(),
            words.data_ptr(),
            *(None if m is None else m.data_ptr() for m in masks),
            gx, gy, gz, int(x_offset), table.ctypes.data, table.shape[1],
            nsmall,
            toffs.ctypes.data, toffs.shape[1], int(max_iters),
            RELAX_LOG_SWEEPS, state.data_ptr(), aux.data_ptr())
    return d2_out, c_out, state


#: the mask ``changes`` writes: none, the resets, the resets and inserts
CHANGES_MASKS = (None, "reset", "queued")


def changes(d2: torch.Tensor, closest: torch.Tensor, occupied: torch.Tensor,
            insert_mask=None, logodds=None, *, occ_thresh: float = 0.0,
            occ_is_eq: bool = False, x_offset: int = 0, mask=None):
    """The incremental update's inserts and bucket resets in one launch:
    d2 [X,Y,Z] i32 and closest [3,X,Y,Z] i16 in, new d2 and closest out,
    with the u8 mask ``mask`` names (``CHANGES_MASKS``) viewed as bool,
    else None.  ``occupied`` (bool or u8): the whole grid's occupancy
    after the drain, of which the grid is the X-slab starting at global x
    ``x_offset``.  The inserts are ``insert_mask`` (bool or u8 [X,Y,Z]),
    or, given ``logodds`` (the f32 log-odds before the drain; the whole
    grid, ``x_offset`` 0), the voxels occupied that ``logodds >
    occ_thresh`` (``==`` with ``occ_is_eq``) finds free.  The inputs are
    left as they are.  Replaces the plain PyTorch ops of
    ``esdf.apply_occupancy_changes`` (the JAX package has no kernel
    here)."""
    _check(d2, torch.int32, "changes d2")
    _check(closest, torch.int16, "changes closest")
    if d2.dim() != 3 or tuple(closest.shape) != (3,) + tuple(d2.shape):
        raise ValueError("changes: expected d2 [X,Y,Z] and closest "
                         "[3,X,Y,Z]")
    if mask not in CHANGES_MASKS:
        raise ValueError(f"changes: mask {mask!r} not in {CHANGES_MASKS}")
    if (insert_mask is None) == (logodds is None):
        raise ValueError("changes: give insert_mask or logodds, not both")
    gx, gy, gz = d2.shape
    x_offset = int(x_offset)
    if occupied.dtype == torch.bool:
        occupied = occupied.view(torch.uint8)
    _check(occupied, torch.uint8, "changes occupied")
    if occupied.dim() != 3 or tuple(occupied.shape[1:]) != (gy, gz) or \
            not 0 <= x_offset <= occupied.shape[0] - gx:
        raise ValueError(f"changes: occupied {tuple(occupied.shape)} does "
                         f"not hold the slab {tuple(d2.shape)} at x "
                         f"{x_offset}")
    if max(occupied.shape) >= 1 << 15:
        raise ValueError(f"changes: grid {tuple(occupied.shape)} does not "
                         "fit the kernel's int16 coordinates")
    ins_ptr = lo_ptr = None
    if logodds is not None:
        _check(logodds, torch.float32, "changes logodds")
        if logodds.shape != d2.shape or occupied.shape != d2.shape:
            raise ValueError("changes: the drained form takes the whole "
                             "grid's logodds and occupancy")
        lo_ptr = logodds.data_ptr()
    else:
        if insert_mask.dtype == torch.bool:
            insert_mask = insert_mask.view(torch.uint8)
        _check(insert_mask, torch.uint8, "changes insert_mask")
        if insert_mask.shape != d2.shape:
            raise ValueError(f"changes: insert_mask shape "
                             f"{tuple(insert_mask.shape)} != "
                             f"{tuple(d2.shape)}")
        ins_ptr = insert_mask.data_ptr()
    _same_device("changes", d2, closest, occupied,
                 *(t for t in (insert_mask, logodds) if t is not None))
    d2_o, c_o = torch.empty_like(d2), torch.empty_like(closest)
    mask_o = None if mask is None else torch.empty(
        d2.shape, dtype=torch.uint8, device=d2.device)
    _launch("changes", d2.device, d2.data_ptr(), closest.data_ptr(),
            occupied.data_ptr(), ins_ptr, lo_ptr, d2_o.data_ptr(),
            c_o.data_ptr(), None if mask_o is None else mask_o.data_ptr(),
            gx, gy, gz, x_offset, float(np.float32(occ_thresh)),
            int(bool(occ_is_eq)), CHANGES_MASKS.index(mask))
    return d2_o, c_o, None if mask_o is None else mask_o.view(torch.bool)


def depth(depths: torch.Tensor, transforms, prev_depth, prev_transform, *,
          cx: float, cy: float, fx: float, fy: float, min_dist: float,
          max_dist: float, tol: float, use_filter: bool, margin: int):
    """Back-projection and consistency filter of K depth images [K,H,W]
    f32 in one launch: returns (px, py, valid), each [K, H*W] (x and y f32
    in the camera frame, valid bool); z is the depth itself.  With
    ``use_filter``, frame i is held against frame i - 1 and frame 0
    against ``prev_depth`` [H,W] f32, through the camera-to-world
    ``transforms`` [K,4,4] and ``prev_transform`` [4,4] f32; without it
    they are not read and may be None.  Replaces the plain PyTorch ops of
    ``ops.depth`` (the JAX package has no kernel here)."""
    _check(depths, torch.float32, "depth depths")
    if depths.dim() != 3:
        raise ValueError("depth: expected depths [K,H,W]")
    k, h, w = depths.shape
    if k > 65535 or h * w >= 1 << 31:
        raise ValueError(f"depth: {tuple(depths.shape)} exceeds the kernel's "
                         "65535 frames or 2^31 pixels a frame")
    ptrs = [None, None, None]
    if use_filter:
        for t, what, shape in ((transforms, "transforms", (k, 4, 4)),
                               (prev_depth, "prev_depth", (h, w)),
                               (prev_transform, "prev_transform", (4, 4))):
            _check(t, torch.float32, f"depth {what}")
            if tuple(t.shape) != shape:
                raise ValueError(f"depth: {what} shape {tuple(t.shape)} != "
                                 f"{shape}")
        _same_device("depth", depths, transforms, prev_depth, prev_transform)
        ptrs = [transforms.data_ptr(), prev_depth.data_ptr(),
                prev_transform.data_ptr()]
    dev = depths.device
    px = torch.empty((k, h * w), dtype=torch.float32, device=dev)
    py = torch.empty_like(px)
    valid = torch.empty((k, h * w), dtype=torch.bool, device=dev)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    _launch("depth", dev, depths.data_ptr(), *ptrs, k, h, w, f32(cx),
            f32(cy), f32(fx), f32(fy), f32(min_dist), f32(max_dist),
            f32(tol), int(bool(use_filter)), int(margin), px.data_ptr(),
            py.data_ptr(), valid.data_ptr())
    return px, py, valid


def prep(points, valid: torch.Tensor, origins=None, transforms=None, *,
         grid, box, extent, aligned: bool, origin, res: float,
         min_ray: float, max_ray: float):
    """The splat prep of K scans in one launch: gates, clip, carve-box
    placement, endpoint or box-exit voxel and packed value per ray.
    ``points``: world-frame [K,P,3] f32 with ``origins`` [K,3] f32, or
    sensor-frame with ``transforms`` [K,4,4] f32 (the sensor at their
    translations), as [K,P,3] or as the components (px, py, pz), each
    [K,P]; ``valid`` [K,P] bool.  ``grid``, ``box`` and ``extent`` (the
    placement extent min(grid, 2r + 1)) are per-axis voxel counts,
    ``aligned`` floors x/y corners to multiples of 8, ``origin`` is the
    map's.  Returns (starts [K,3] i32, po_box [K,3] f32, lin [K*P] i32
    (K*BX*BY*BZ for a dropped ray), val [K*P] f32, rvalid [K,P] bool).
    Replaces the plain PyTorch ops of ``ops.raycast`` (the JAX package
    has no kernel here)."""
    comps = points if isinstance(points, (tuple, list)) else None
    if comps is not None:
        if len(comps) != 3:
            raise ValueError("prep: expected the components (px, py, pz)")
        for c in comps:
            _check(c, torch.float32, "prep points")
        if comps[0].dim() != 2 or any(c.shape != comps[0].shape
                                      for c in comps):
            raise ValueError("prep: expected components of one shape [K,P]")
        k, p = comps[0].shape
        ptrs, ps = [c.data_ptr() for c in comps], 1
        first = comps[0]
    else:
        _check(points, torch.float32, "prep points")
        if points.dim() != 3 or points.shape[2] != 3:
            raise ValueError("prep: expected points [K,P,3]")
        k, p = points.shape[:2]
        base = points.data_ptr()
        ptrs, ps = [base, base + 4, base + 8], 3
        first = points
    _check(valid, torch.bool, "prep valid")
    if tuple(valid.shape) != (k, p):
        raise ValueError(f"prep: valid shape {tuple(valid.shape)} != {(k, p)}")
    if transforms is not None:
        _check(transforms, torch.float32, "prep transforms")
        if tuple(transforms.shape) != (k, 4, 4):
            raise ValueError("prep: expected transforms [K,4,4]")
        sensor, orig_ptr, tf_ptr = transforms, None, transforms.data_ptr()
    elif origins is not None:
        _check(origins, torch.float32, "prep origins")
        if tuple(origins.shape) != (k, 3):
            raise ValueError("prep: expected origins [K,3]")
        sensor, orig_ptr, tf_ptr = origins, origins.data_ptr(), None
    else:
        raise ValueError("prep: origins or transforms needed")
    _same_device("prep", first, valid, sensor,
                 *(comps[1:] if comps is not None else ()))
    if k > 65535:
        raise ValueError(f"prep: {k} scans exceed the kernel's 65535")
    dev = first.device
    starts = torch.empty((k, 3), dtype=torch.int32, device=dev)
    po_box = torch.empty((k, 3), dtype=torch.float32, device=dev)
    lin = torch.empty(k * p, dtype=torch.int32, device=dev)
    val = torch.empty(k * p, dtype=torch.float32, device=dev)
    rvalid = torch.empty((k, p), dtype=torch.bool, device=dev)
    _launch("prep", dev, *ptrs, ps, valid.data_ptr(), orig_ptr, tf_ptr, k,
            p, *grid, *box, *extent, int(bool(aligned)),
            *_prep_floats(tuple(origin), res, min_ray, max_ray, tuple(box)),
            starts.data_ptr(), po_box.data_ptr(), lin.data_ptr(),
            val.data_ptr(), rvalid.data_ptr())
    return starts, po_box, lin, val, rvalid


@functools.lru_cache(maxsize=64)
def _prep_floats(origin, res, min_ray, max_ray, box):
    """The prep's f32 arguments, rounded once per geometry as PyTorch
    rounds the plain prep's Python scalars: the origin, res, the ray
    limits, the 1e-9 floor, 0.5 * res, box * res and max_ray + res (each
    formed in double, then rounded)."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return (*(f32(o) for o in origin), f32(res), f32(min_ray), f32(max_ray),
            f32(1e-9), f32(0.5 * res), *(f32(b * res) for b in box),
            f32(max_ray + res))
