"""Persistent unbounded-world storage: a host-side tile directory.

A copy of ``fiesta_tpu/archive.py`` (numpy only), so that the port's
scrolling engine archives and restores tiles without importing the JAX
package; an archive file written by either package loads in the other.

The reference's unbounded-world mode (``#ifdef HASH_TABLE``,
src/ESDFMap.cpp:128-167, 704-783) keeps an ``unordered_map`` from 8^3-voxel
block ids to storage, so the *entire explored world* stays resident and
revisited space is remembered.  The scrolling dense grid (scrolling.py)
gives unbounded *extent* but forgets evicted content.  This module closes
that gap with an accelerator's memory split:

  * device memory holds the active window (the scrolling grid — all compute);
  * the host holds a directory of world-voxel-aligned tiles storing the
    persistent fields: ``logodds`` (f32) and ``seen`` (bool).

Derived state is deliberately NOT archived: ``d2``/``closest`` rebuild from
occupancy after a restore (exactly how the reference re-derives distances
from the block map), and the hit/miss counters are per-tick scratch
(drained by every fusion, ESDFMap.cpp:268-270).

Tiles are created lazily on first touch (the reference allocates blocks on
first touch, ESDFMap.cpp:704-742) and chunks that contain no observed voxel
are skipped, so storage scales with *explored* volume, not world volume.
Host<->device traffic happens only at recenter events — minutes apart at
typical robot speeds — never on the per-scan hot path.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

# 32x32x16 f32 = 64 KiB/tile/field: big enough that the directory stays
# small (hundreds of tiles for km-scale exploration), small enough that a
# partially-explored frontier doesn't waste host RAM.  The reference's 8^3
# blocks optimize pointer-chasing locality, which has no analog here.
DEFAULT_TILE_SHAPE = (32, 32, 16)

_Key = Tuple[int, int, int]


class TileArchive:
    """Host-side persistent map store keyed by world-voxel tile coords.

    World-voxel coordinates are unbounded signed integers: voxel ``v`` of a
    grid anchored at ``origin_vox`` has world-voxel index ``origin_vox + v``
    (world position ``cfg.origin + (origin_vox + v) * resolution``).
    """

    def __init__(self, tile_shape: Tuple[int, int, int] = DEFAULT_TILE_SHAPE):
        self.tile_shape = tuple(int(t) for t in tile_shape)
        self.tiles: Dict[_Key, Dict[str, np.ndarray]] = {}

    # -- geometry ------------------------------------------------------------

    def _chunks(
        self, world_lo: np.ndarray, shape: Tuple[int, int, int]
    ) -> Iterator[Tuple[_Key, Tuple[slice, ...], Tuple[slice, ...]]]:
        """Yield (tile_key, tile_slices, box_slices) covering the box
        ``[world_lo, world_lo + shape)`` chunk by tile-aligned chunk."""
        lo = np.asarray(world_lo, np.int64)
        hi = lo + np.asarray(shape, np.int64)
        ts = np.asarray(self.tile_shape, np.int64)
        t0 = lo // ts                      # floor division: negatives OK
        t1 = -((-hi) // ts)                # ceil division
        for tx in range(int(t0[0]), int(t1[0])):
            for ty in range(int(t0[1]), int(t1[1])):
                for tz in range(int(t0[2]), int(t1[2])):
                    base = np.array([tx, ty, tz], np.int64) * ts
                    a = np.maximum(lo, base)
                    b = np.minimum(hi, base + ts)
                    tile_sl = tuple(
                        slice(int(a[i] - base[i]), int(b[i] - base[i]))
                        for i in range(3)
                    )
                    box_sl = tuple(
                        slice(int(a[i] - lo[i]), int(b[i] - lo[i]))
                        for i in range(3)
                    )
                    yield (tx, ty, tz), tile_sl, box_sl

    # -- store / load ----------------------------------------------------------

    def store(
        self, world_lo, logodds: np.ndarray, seen: np.ndarray
    ) -> None:
        """Write a box of map content at world-voxel corner ``world_lo``.

        Chunks with no observed voxel are skipped unless the tile already
        exists (then the write must land: the region may have been
        *forgotten* since it was archived — observed-then-cleared content
        must overwrite stale tiles).
        """
        logodds = np.asarray(logodds, np.float32)
        seen = np.asarray(seen, bool)
        for key, tile_sl, box_sl in self._chunks(world_lo, logodds.shape):
            tile = self.tiles.get(key)
            if tile is None:
                if not seen[box_sl].any():
                    continue
                tile = {
                    "logodds": np.zeros(self.tile_shape, np.float32),
                    "seen": np.zeros(self.tile_shape, bool),
                }
                self.tiles[key] = tile
            tile["logodds"][tile_sl] = logodds[box_sl]
            tile["seen"][tile_sl] = seen[box_sl]

    def load(
        self, world_lo, shape: Tuple[int, int, int]
    ) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Read a box at world-voxel corner ``world_lo``.

        Returns (logodds, seen, any_data); never-archived space comes back
        as unknown (logodds 0, seen False), matching the reference's
        "block not in the hash map" answer (ESDFMap.cpp:92-107).
        """
        logodds = np.zeros(shape, np.float32)
        seen = np.zeros(shape, bool)
        any_data = False
        for key, tile_sl, box_sl in self._chunks(world_lo, shape):
            tile = self.tiles.get(key)
            if tile is None:
                continue
            logodds[box_sl] = tile["logodds"][tile_sl]
            seen[box_sl] = tile["seen"][tile_sl]
            # gate on actually-observed content: a tile allocated for a
            # neighboring chunk may overlap this box with only unseen
            # voxels, and callers use any_data to decide whether to pay a
            # full distance re-derivation
            any_data |= bool(tile["seen"][tile_sl].any())
        return logodds, seen, any_data

    # -- stats / persistence ---------------------------------------------------

    @property
    def num_tiles(self) -> int:
        return len(self.tiles)

    def seen_voxels(self) -> int:
        """Observed voxels currently archived (for logging)."""
        return int(sum(t["seen"].sum() for t in self.tiles.values()))

    def nbytes(self) -> int:
        return sum(
            t["logodds"].nbytes + t["seen"].nbytes
            for t in self.tiles.values()
        )

    def save(self, path: str) -> None:
        """Snapshot the directory to one ``.npz`` (checkpoint/resume).

        Atomic (tmp + rename) so a crash mid-write cannot leave a
        truncated archive next to a valid checkpoint.
        """
        import os

        arrays = {"__tile_shape__": np.asarray(self.tile_shape, np.int64)}
        for (tx, ty, tz), tile in self.tiles.items():
            arrays[f"lo_{tx}_{ty}_{tz}"] = tile["logodds"]
            arrays[f"sn_{tx}_{ty}_{tz}"] = tile["seen"]
        tmp = path + ".tmp"
        np.savez_compressed(tmp, **arrays)
        # numpy appends .npz to names without it
        if not tmp.endswith(".npz") and os.path.exists(tmp + ".npz"):
            tmp += ".npz"
        os.replace(tmp, path)

    @classmethod
    def from_file(cls, path: str) -> "TileArchive":
        data = np.load(path)
        arch = cls(tuple(int(t) for t in data["__tile_shape__"]))
        for name in data.files:
            if not name.startswith("lo_"):
                continue
            key = tuple(int(s) for s in name[3:].split("_"))
            arch.tiles[key] = {
                "logodds": np.asarray(data[name], np.float32),
                "seen": np.asarray(data["sn_" + name[3:]], bool),
            }
        return arch
