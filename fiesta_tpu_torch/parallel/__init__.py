"""Multi-device execution: the sharded grid ops and the mesh engine (port
of ``fiesta_tpu/parallel``)."""

from .sharding import (  # noqa: F401
    Mesh,
    ShardedMapState,
    distributed_mesh,
    gather_state,
    make_mesh,
    shard_state,
    sharded_esdf_update,
    sharded_fused_tick,
    state_shardings,
)
