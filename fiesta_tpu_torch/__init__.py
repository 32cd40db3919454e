"""fiesta_tpu_torch: the PyTorch/CUDA port of fiesta_tpu.

The production mapping tick (scanline integration, occupancy fusion,
exact truncated EDT, lazy or eager closest obstacle) and the planner-
facing queries (``ops.query``, with ``derive_closest``) on an NVIDIA
Hopper card, with hand-written CUDA kernels for the splat, the carve, the
box add, the fusion drain, the two EDT passes and the three closest
passes (``fiesta_tpu_torch/kernels``).  The JAX package ``fiesta_tpu`` is
the reference the port is held against; this package imports none of it.

Entry points run on ``cuda`` unless given ``device="cpu"``, where every
kernel is replaced by its plain PyTorch version.
"""

from .config import COW_AND_LADY, DEMO_ONBOARD, FiestaConfig, config_from_fields
from .grid import (
    MapState,
    copy_state,
    make_state,
    occupied_grid,
    state_from_arrays,
    state_to_arrays,
)
from .pipeline import (
    UpdateStats,
    derive_closest,
    fused_batch_step,
    fused_stream,
    rebuild_tracks_closest,
)

__all__ = [
    "COW_AND_LADY",
    "DEMO_ONBOARD",
    "FiestaConfig",
    "MapState",
    "UpdateStats",
    "config_from_fields",
    "copy_state",
    "derive_closest",
    "fused_batch_step",
    "fused_stream",
    "make_state",
    "occupied_grid",
    "rebuild_tracks_closest",
    "state_from_arrays",
    "state_to_arrays",
]
