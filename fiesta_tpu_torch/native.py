"""ctypes binding to the repository's C++ FIESTA core (port of
``fiesta_tpu/native.py``).

``native/fiesta_core.cpp`` is the reference algorithm on the host: the
dual insert/delete queues, the per-voxel closest-obstacle lists and the
24-neighbour BFS of the reference's UpdateESDF.  The benchmarks use it as
the accuracy oracle and as the self-measured CPU baseline.  The shared
library is built on first use with ``native/Makefile`` (``make``, g++
-O3); a failed build raises to the caller.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfiesta_core.so")

_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    """``make`` into a file of this process, then one rename: processes
    that build at once never load a half-written library."""
    tmp = f"libfiesta_core.so.{os.getpid()}.tmp"
    subprocess.run(["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"], check=True,
                   capture_output=True, text=True)
    os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)


def load() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _build()
    lib = ctypes.CDLL(_LIB_PATH)
    lib.fiesta_esdf_create.restype = ctypes.c_void_p
    lib.fiesta_esdf_create.argtypes = [ctypes.c_int32] * 3
    lib.fiesta_esdf_destroy.restype = None
    lib.fiesta_esdf_destroy.argtypes = [ctypes.c_void_p]
    lib.fiesta_esdf_set_occupancy.restype = None
    lib.fiesta_esdf_set_occupancy.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    lib.fiesta_esdf_update.restype = ctypes.c_int64
    lib.fiesta_esdf_update.argtypes = [ctypes.c_void_p]
    for name in ("fiesta_esdf_get_dist2", "fiesta_esdf_get_closest"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library loads (builds) here."""
    try:
        load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


class NativeEsdf:
    """Incremental queue-based ESDF on the host (reference algorithm)."""

    def __init__(self, shape: Tuple[int, int, int]):
        self._lib = load()
        self.shape = tuple(int(s) for s in shape)
        self._h = self._lib.fiesta_esdf_create(*self.shape)
        if not self._h:
            raise RuntimeError("failed to create native ESDF")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.fiesta_esdf_destroy(h)
            self._h = None

    def set_occupancy(self, vox: np.ndarray, occ: np.ndarray) -> None:
        """Queue occupancy changes: vox [N,3] int, occ [N] {0,1}."""
        vox = np.ascontiguousarray(vox, np.int32)
        occ = np.ascontiguousarray(occ, np.uint8)
        if vox.shape != (len(occ), 3):
            raise ValueError(
                f"vox must be [{len(occ)},3] to match occ, got {vox.shape} "
                "(the native loop would read past the buffer)")
        self._lib.fiesta_esdf_set_occupancy(self._h, len(occ), vox, occ)

    def update(self) -> int:
        """Drain queues + BFS; returns expanded-node count."""
        return int(self._lib.fiesta_esdf_update(self._h))

    def dist2(self) -> np.ndarray:
        """Squared voxel distances [X,Y,Z]; -1 where unreachable."""
        out = np.empty(int(np.prod(self.shape)), np.int64)
        self._lib.fiesta_esdf_get_dist2(self._h, out)
        return out.reshape(self.shape)

    def closest(self) -> np.ndarray:
        """Closest-obstacle linear index per voxel [X,Y,Z]; -1 where
        undefined."""
        out = np.empty(int(np.prod(self.shape)), np.int64)
        self._lib.fiesta_esdf_get_closest(self._h, out)
        return out.reshape(self.shape)
