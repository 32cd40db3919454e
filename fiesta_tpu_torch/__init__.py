"""fiesta_tpu_torch: the PyTorch/CUDA port of fiesta_tpu.

The streaming engine (``FiestaPipeline``: pose/frame synchronisation,
per-frame integration with the scanline, DDA or projective integrator,
the 10 Hz update, the planner-facing queries), the batched cloud and
depth-image ticks (global or local-window update, exact truncated EDT,
lazy or eager closest obstacle) on an NVIDIA Hopper card, with
hand-written CUDA kernels for the splat, the carve, the box add, the
fusion drain, the two EDT passes, the three closest passes and the sorted
splat's bitonic sort (``fiesta_tpu_torch/kernels``).  The JAX package
``fiesta_tpu`` is the reference the port is held against; this package
imports none of it.

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
    FiestaPipeline,
    ScanSynchronizer,
    UpdateStats,
    derive_closest,
    fused_batch_step,
    fused_depth_batch_step,
    fused_depth_stream,
    fused_stream,
    integrate_scan,
    rebuild_tracks_closest,
)

__all__ = [
    "COW_AND_LADY",
    "DEMO_ONBOARD",
    "FiestaConfig",
    "FiestaPipeline",
    "MapState",
    "ScanSynchronizer",
    "UpdateStats",
    "config_from_fields",
    "copy_state",
    "derive_closest",
    "fused_batch_step",
    "fused_depth_batch_step",
    "fused_depth_stream",
    "fused_stream",
    "integrate_scan",
    "make_state",
    "occupied_grid",
    "rebuild_tracks_closest",
    "state_from_arrays",
    "state_to_arrays",
]
