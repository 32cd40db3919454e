"""Voxel grid state and addressing (port of ``fiesta_tpu/grid.py``).

The map is a dataclass of dense [X, Y, Z] tensors with the JAX package's
dtypes, so a state converts between the two packages field by field
(``state_from_arrays`` / ``state_to_arrays``, keyed by the ``MapState``
field names that ``fiesta_tpu/checkpoint.py`` also uses).

Distances are squared distances in voxel units (int32): every comparison on
Euclidean distance is monotone in the squared integer, so integer
min-relaxation reproduces it exactly.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device and without that argument they raise.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import numpy as np
import torch

from .config import FiestaConfig

UNDEFINED_COORD = -1          # closest-obstacle "undefined" marker
INF_D2 = 1 << 29              # squared-distance infinity (voxel units)
UNDEFINED_DIST = -10000.0     # out-of-map query result (ESDFMap.cpp:182)

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (explicitly or by default)
    and no CUDA device is present: the port never falls back to the CPU on
    its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fiesta_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


@dataclasses.dataclass
class MapState:
    """Device-resident ESDF map state (``fiesta_tpu/grid.py:49-84``).

    Shapes: all [X, Y, Z] except ``closest`` in plane form [3, X, Y, Z].

      logodds  f32  occupancy log-odds
      d2       i32  squared distance, voxel units (INF_D2 = far)
      closest  i32  packed x<<20|y<<10|z, -1 undefined, when
                    ``closest_packed_state(cfg)``; else i16 [3,X,Y,Z]
      seen     u8   voxel ever observed, {0,1}
      hit_cnt  u8   per-tick hit counter (saturating)
      miss_cnt u8   per-tick miss counter (saturating)
    """

    logodds: torch.Tensor
    d2: torch.Tensor
    closest: torch.Tensor
    seen: torch.Tensor
    hit_cnt: torch.Tensor
    miss_cnt: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.d2.device


FIELDS = tuple(f.name for f in dataclasses.fields(MapState))


def closest_packed_state(cfg: FiestaConfig) -> bool:
    """Whether ``MapState.closest`` is the packed int32 grid (rebuild mode
    with closest tracking on a grid whose axes fit 10-bit fields)."""
    return (cfg.esdf_mode == "rebuild" and cfg.track_closest
            and all(g <= 1024 for g in cfg.grid_shape))


def pack_closest(planes: torch.Tensor) -> torch.Tensor:
    """[3, X, Y, Z] coordinate planes -> packed int32 [X, Y, Z]."""
    c = planes.to(torch.int32)
    return torch.where(c[0] >= 0, (c[0] << 20) | (c[1] << 10) | c[2], -1)


def unpack_closest(packed: torch.Tensor) -> torch.Tensor:
    """Packed int32 [...] -> [3, ...] int16 planes (-1 where undefined)."""
    defined = packed >= 0
    planes = torch.stack([packed >> 20, (packed >> 10) & 1023,
                          packed & 1023]).to(torch.int16)
    return torch.where(defined, planes, UNDEFINED_COORD).to(torch.int16)


def _shapes_dtypes(cfg: FiestaConfig):
    shape = tuple(cfg.grid_shape)
    if closest_packed_state(cfg):
        closest = (shape, torch.int32)
    else:
        closest = ((3,) + shape, torch.int16)
    return dict(logodds=(shape, torch.float32), d2=(shape, torch.int32),
                closest=closest, seen=(shape, torch.uint8),
                hit_cnt=(shape, torch.uint8), miss_cnt=(shape, torch.uint8))


def make_state(cfg: FiestaConfig, device: Device = None) -> MapState:
    """Allocate an empty map (reference ctor ESDFMap.cpp:171-213)."""
    dev = resolve_device(device)
    fill = dict(logodds=0, d2=INF_D2, closest=-1, seen=0, hit_cnt=0,
                miss_cnt=0)
    return MapState(**{
        name: torch.full(shape, fill[name], dtype=dtype, device=dev)
        for name, (shape, dtype) in _shapes_dtypes(cfg).items()})


def state_from_arrays(cfg: FiestaConfig, arrays: Mapping[str, np.ndarray],
                      device: Device = None) -> MapState:
    """A state from host arrays keyed by the MapState field names (a JAX
    state as numpy, or a checkpoint's npz fields).  Shapes and dtypes must
    be what ``make_state(cfg)`` allocates.  The state owns copies of the
    arrays (a tick writes its counters in place)."""
    dev = resolve_device(device)
    out = {}
    for name, (shape, dtype) in _shapes_dtypes(cfg).items():
        arr = np.asarray(arrays[name])
        want = torch.empty((), dtype=dtype).numpy().dtype
        if tuple(arr.shape) != shape or arr.dtype != want:
            raise ValueError(
                f"field {name}: got {arr.dtype}{list(arr.shape)}, expected "
                f"{want}{list(shape)} for this config")
        out[name] = torch.from_numpy(np.array(arr, order="C")).to(dev)
    return MapState(**out)


def state_to_arrays(state: MapState) -> dict:
    """Host numpy arrays keyed by the MapState field names."""
    return {name: getattr(state, name).cpu().numpy() for name in FIELDS}


def copy_state(state: MapState) -> MapState:
    """A copy of a MapState, for a caller that keeps a state it hands to a
    tick: the tick gives up its input (its counters are added to in
    place)."""
    return MapState(**{f: getattr(state, f).clone() for f in FIELDS})


# ---------------------------------------------------------------------------
# Coordinate conversions (reference ESDFMap.cpp:46-118)
# ---------------------------------------------------------------------------


def f32_scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim f32 tensor on ``like``'s device (made there: no
    host-to-device copy).  Divide by this, not by a Python float:
    ``cuda_tensor / float`` multiplies by the rounded reciprocal and
    ``float / tensor`` is ``reciprocal() * float``, neither of which is
    the IEEE division the JAX package computes."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, the IEEE ``sqrt`` the JAX
    package computes: through f64, where rounding the exact f64 root to f32
    is the correctly rounded f32 root.  PyTorch's vectorised f32 ``sqrt``
    on the CPU is not correctly rounded (ROADMAP C)."""
    return torch.sqrt(x.double()).float()


def pos_to_vox(cfg: FiestaConfig, pos: torch.Tensor) -> torch.Tensor:
    """World position [..., 3] f32 -> integer voxel [..., 3] i32."""
    origin = torch.stack([torch.full((), o, dtype=pos.dtype,
                                     device=pos.device) for o in cfg.origin])
    return torch.floor((pos - origin) / f32_scalar(cfg.resolution, pos)
                       ).to(torch.int32)


def const_vec(values, dtype: torch.dtype, like: torch.Tensor) -> torch.Tensor:
    """1-D tensor of ``values`` on ``like``'s device (made there: no
    host-to-device copy)."""
    return torch.stack([torch.full((), v, dtype=dtype, device=like.device)
                        for v in values])


def vox_to_pos(cfg: FiestaConfig, vox: torch.Tensor) -> torch.Tensor:
    """Voxel [..., 3] -> world position of the voxel centre, f32
    (ESDFMap.cpp:79-82)."""
    return ((vox.to(torch.float32) + 0.5) * cfg.resolution
            + const_vec(cfg.origin, torch.float32, vox))


def idx_to_vox(cfg: FiestaConfig, idx: torch.Tensor) -> torch.Tensor:
    """Linear index -> voxel [..., 3] (ESDFMap.cpp:109-118)."""
    _, gy, gz = cfg.grid_shape
    return torch.stack([idx // (gy * gz), (idx % (gy * gz)) // gz, idx % gz],
                       dim=-1)


def pos_in_map(cfg: FiestaConfig, pos: torch.Tensor) -> torch.Tensor:
    """Bounds check of world positions [..., 3] against the map's box,
    faces included (ESDFMap.cpp:46-61)."""
    lo = const_vec(cfg.origin, pos.dtype, pos)
    hi = lo + const_vec(cfg.map_size, pos.dtype, pos)
    return torch.all((pos >= lo) & (pos <= hi), dim=-1)


def vox_in_grid(cfg: FiestaConfig, vox: torch.Tensor) -> torch.Tensor:
    """Voxel bounds check against the allocated grid."""
    hi = const_vec(cfg.grid_shape, vox.dtype, vox)
    return torch.all((vox >= 0) & (vox < hi), dim=-1)


def vox_to_idx(cfg: FiestaConfig, vox: torch.Tensor) -> torch.Tensor:
    """Voxel [..., 3] -> linear index x*YZ + y*Z + z."""
    _, gy, gz = cfg.grid_shape
    v = vox.to(torch.int32)
    return v[..., 0] * (gy * gz) + v[..., 1] * gz + v[..., 2]


def vox_in_window(vox: torch.Tensor, min_vec: torch.Tensor,
                  max_vec: torch.Tensor) -> torch.Tensor:
    """Inclusive window check, reference VoxInRange (ESDFMap.cpp:63-72)."""
    return torch.all((vox >= min_vec) & (vox <= max_vec), dim=-1)


# ---------------------------------------------------------------------------
# Update-range windows (reference ESDFMap.cpp:792-824, component C17)
# ---------------------------------------------------------------------------


def full_window(cfg: FiestaConfig, device: Device = None):
    """SetOriginalRange (ESDFMap.cpp:812-824): the whole grid, as
    (min_vec [3] i32, max_vec [3] i32)."""
    dev = resolve_device(device)
    gx, gy, gz = cfg.grid_shape
    return (torch.zeros(3, dtype=torch.int32, device=dev),
            torch.tensor([gx - 1, gy - 1, gz - 1], dtype=torch.int32,
                         device=dev))


def local_window(cfg: FiestaConfig, center_pos: torch.Tensor):
    """SetUpdateRange(cur - radius, cur + radius) (ESDFMap.cpp:792-810) on
    the device of ``center_pos`` [3] f32: positions are clamped to the map
    box, then min gets Pos2Vox(min) and max gets Pos2Vox(max - res/2)."""
    radius = const_vec(cfg.radius, torch.float32, center_pos)
    lo = const_vec(cfg.origin, torch.float32, center_pos)
    hi = lo + const_vec(cfg.map_size, torch.float32, center_pos)
    min_pos = torch.clamp(center_pos - radius, lo, hi)
    max_pos = torch.clamp(center_pos + radius, lo, hi)
    return (pos_to_vox(cfg, min_pos),
            pos_to_vox(cfg, max_pos - 0.5 * cfg.resolution))


def local_window_np(cfg: FiestaConfig, center_pos):
    """Host (numpy) twin of ``local_window``, computed in f32 so the voxel
    bounds are bit-identical to it (``fiesta_tpu/grid.py:219-237``)."""
    center = np.asarray(center_pos, np.float32)
    radius = np.asarray(cfg.radius, np.float32)
    lo = np.asarray(cfg.origin, np.float32)
    hi = lo + np.asarray(cfg.map_size, np.float32)
    min_pos = np.clip(center - radius, lo, hi)
    max_pos = np.clip(center + radius, lo, hi)
    res = np.float32(cfg.resolution)
    min_vec = np.floor((min_pos - lo) / res).astype(np.int32)
    max_vec = np.floor(
        (max_pos - np.float32(0.5) * res - lo) / res).astype(np.int32)
    return min_vec, max_vec


def window_mask(cfg: FiestaConfig, min_vec: torch.Tensor,
                max_vec: torch.Tensor) -> torch.Tensor:
    """Dense [X, Y, Z] bool mask of the voxels inside the inclusive
    window."""
    gx, gy, gz = cfg.grid_shape
    dev = min_vec.device
    xs, ys, zs = (torch.arange(g, dtype=torch.int32, device=dev)
                  for g in (gx, gy, gz))
    mx = (xs >= min_vec[0]) & (xs <= max_vec[0])
    my = (ys >= min_vec[1]) & (ys <= max_vec[1])
    mz = (zs >= min_vec[2]) & (zs <= max_vec[2])
    return mx[:, None, None] & my[None, :, None] & mz[None, None, :]


def coord_grids(shape, device: Device = None) -> torch.Tensor:
    """[3, X, Y, Z] int16 self-coordinates (closest-obstacle seeding)."""
    dev = resolve_device(device)
    axes = [torch.arange(g, dtype=torch.int16, device=dev) for g in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"))


def occupied_grid(cfg: FiestaConfig, logodds: torch.Tensor) -> torch.Tensor:
    """Occupancy predicate ``Exist`` (ESDFMap.cpp:16-22)."""
    if cfg.probabilistic:
        return logodds > cfg.min_occupancy_log
    return logodds == 1.0


def state_bytes(state: MapState) -> int:
    """Bytes the map state holds on its device."""
    return sum(getattr(state, f).nbytes for f in FIELDS)


def check_same_device(state: MapState, *tensors: Optional[torch.Tensor]):
    """Raise unless every given tensor lies on the state's device."""
    dev = state.device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"input on {t.device}, state on {dev}")
