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

The app is ``python -m fiesta_tpu_torch.run`` (``fiesta_tpu.run``'s flags;
synthetic, ``.npz`` and ROS-bag input).  Entry points run on ``cuda``
unless given ``device="cpu"`` (the app: ``--platform cpu``), where every
kernel is replaced by its plain PyTorch version.
"""

from .config import (
    COW_AND_LADY,
    DEMO_ONBOARD,
    FiestaConfig,
    config_from_fields,
    stencil_offsets,
)
from .grid import (
    INF_D2,
    UNDEFINED_COORD,
    MapState,
    copy_state,
    full_window,
    local_window,
    make_state,
    occupied_grid,
    pos_to_vox,
    state_from_arrays,
    state_to_arrays,
    vox_to_idx,
    vox_to_pos,
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



def __getattr__(name):
    # the scrolling and sharded engines and the archive load on first use,
    # as ``fiesta_tpu`` exports them
    if name == "ScrollingFiestaPipeline":
        from .scrolling import ScrollingFiestaPipeline
        return ScrollingFiestaPipeline
    if name == "ShardedFiestaPipeline":
        from .parallel.engine import ShardedFiestaPipeline
        return ShardedFiestaPipeline
    if name == "TileArchive":
        from .archive import TileArchive
        return TileArchive
    raise AttributeError(
        f"module 'fiesta_tpu_torch' has no attribute {name!r}")


__all__ = [
    "COW_AND_LADY",
    "DEMO_ONBOARD",
    "FiestaConfig",
    "FiestaPipeline",
    "INF_D2",
    "MapState",
    "ScanSynchronizer",
    "ScrollingFiestaPipeline",
    "ShardedFiestaPipeline",
    "TileArchive",
    "UNDEFINED_COORD",
    "UpdateStats",
    "config_from_fields",
    "copy_state",
    "derive_closest",
    "fused_batch_step",
    "fused_depth_batch_step",
    "fused_depth_stream",
    "full_window",
    "fused_stream",
    "integrate_scan",
    "local_window",
    "make_state",
    "occupied_grid",
    "pos_to_vox",
    "rebuild_tracks_closest",
    "state_from_arrays",
    "state_to_arrays",
    "stencil_offsets",
    "vox_to_idx",
    "vox_to_pos",
]
