"""Map state checkpoint/resume (port of ``fiesta_tpu/checkpoint.py``).

One compressed npz holds the state's six fields under their ``MapState``
names, the config as JSON (``__config__``) and, for a scrolling grid, its
world anchor (``__origin_vox__``); a JSON sidecar of the config is written
beside it.  The layout is ``fiesta_tpu``'s, so a checkpoint written by
either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np
import torch

from .config import FiestaConfig, config_from_fields
from .grid import FIELDS, Device, MapState, resolve_device


def save(path: str, cfg: FiestaConfig, state: MapState,
         origin_vox=None) -> None:
    """Write state and config as ONE file, atomically (tmp + rename), and
    a JSON sidecar of the config.  ``origin_vox``: a scrolling grid's
    world anchor in voxels, so that a resumed window lands where it was
    (the persistent archive's tiles are world-absolute)."""
    tmp = path + ".tmp"
    arrays = {f: getattr(state, f).cpu().numpy() for f in FIELDS}
    if origin_vox is not None:
        arrays["__origin_vox__"] = np.asarray(origin_vox, np.int64)
    cfg_json = json.dumps(dataclasses.asdict(cfg))
    np.savez_compressed(tmp, __config__=np.asarray(cfg_json), **arrays)
    os.replace(tmp + ".npz", path)  # savez appends ".npz" to tmp

    tmp_json = path + ".json.tmp"
    with open(tmp_json, "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=1)
    os.replace(tmp_json, path + ".json")


def load(path: str, device: Device = None) -> Tuple[FiestaConfig, MapState]:
    """Load a checkpoint written by ``save`` (either package's) onto
    ``device`` (``cuda`` unless given ``"cpu"``).  A bool ``seen`` (from
    before its u8 migration) loads as u8."""
    dev = resolve_device(device)
    with np.load(path) as data:
        if "__config__" in data:
            raw = json.loads(str(data["__config__"]))
        else:  # older checkpoints: sidecar only
            with open(path + ".json") as fh:
                raw = json.load(fh)
        arrays = {f: np.asarray(data[f]) for f in FIELDS}
    if arrays["seen"].dtype != np.uint8:
        arrays["seen"] = arrays["seen"].astype(np.uint8)
    cfg = config_from_fields(raw)
    if tuple(arrays["logodds"].shape) != cfg.grid_shape:
        raise ValueError(f"checkpoint grid {arrays['logodds'].shape} != "
                         f"config grid {cfg.grid_shape}")
    return cfg, MapState(**{f: torch.from_numpy(a).to(dev)
                            for f, a in arrays.items()})


def load_anchor(path: str):
    """World anchor (``origin_vox`` int64[3]) stored with a scrolling-grid
    checkpoint, or None for fixed-grid and older checkpoints."""
    with np.load(path) as data:
        if "__origin_vox__" in data:
            return np.asarray(data["__origin_vox__"], np.int64)
    return None
