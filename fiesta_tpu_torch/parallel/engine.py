"""The streaming engine over an X-sharded mesh (port of
``fiesta_tpu/parallel/engine.py``).

``parallel.sharding`` holds the sharded steps; this module puts them
behind ``FiestaPipeline``'s observe / process / update API, so the same
application code runs on one card or a mesh::

    mesh = sharding.make_mesh(8)             # or distributed_mesh()
    pipe = ShardedFiestaPipeline(cfg, mesh=mesh)
    pipe.observe_pose(...); pipe.observe_cloud(...)
    pipe.process(); pipe.update()
    d, g = pipe.query_dist_grad(positions)

Differences from the single-device engine, as in the JAX package:

  * scans are buffered on the host and integrated at update time in
    groups of ``scans_per_tick`` (short groups padded with all-invalid
    scans, which add nothing);
  * depth images are back-projected and filtered at observe time, then
    buffered as cloud pairs for the sharded tick;
  * rebuild mode only (the incremental engine is
    ``sharding.sharded_esdf_update``); window mode, the two-level EDT,
    the closest obstacle and the signed field all shard.

The map lives as X-slabs (``sharding.ShardedMapState``).  ``state`` is
the gathered global MapState, gathered on first read after a tick and
cached until the next: the query surface, checkpoints and the oracle read
it.  Assigning ``state`` (a checkpoint, the scrolling engine's strip
writes) cuts it into slabs again before the next sharded step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import FiestaConfig
from ..grid import MapState, occupied_grid
from ..pipeline import FiestaPipeline, UpdateStats
from ..scrolling import ScrollingMixin
from ..timing import Timer
from . import sharding


class ShardedFiestaPipeline(FiestaPipeline):
    """Streaming ESDF engine over a mesh of X-slab shards
    (``engine.py:43-211``).  ``mesh``: a ``sharding.Mesh`` (default: one
    shard a visible card, or ``n_devices`` of them)."""

    def __init__(self, cfg: FiestaConfig, mesh: Optional[sharding.Mesh] = None,
                 n_devices: Optional[int] = None, scans_per_tick: int = 3):
        if mesh is None:
            mesh = sharding.make_mesh(n_devices or torch.cuda.device_count())
        self.mesh = mesh
        self._global: Optional[MapState] = None
        self._sharded: Optional[sharding.ShardedMapState] = None
        super().__init__(cfg, method="scanline", device=mesh.devices[0])
        self._reshard_state()
        self._tick = sharding.sharded_fused_tick(cfg, mesh)
        self.scans_per_tick = int(scans_per_tick)
        self._pending: list = []    # (points [P,3], valid [P], T [4,4])
        self._derive_closest_fn = None
        self._sdf_fn = None
        self._dist_cache = None     # plan()'s replicated grids
        self._dist_cache_signed = None
        self._planner = self._planner_cfg = None
        self._plan_gen = None

    # -- the state: X-slabs, gathered on demand ------------------------------

    @property
    def state(self) -> MapState:
        """The global map, gathered from the slabs (cached per tick)."""
        if self._global is None:
            self._global = sharding.gather_state(self._sharded, self.mesh)
        return self._global

    @state.setter
    def state(self, value: MapState) -> None:
        self._global = value
        self._sharded = None      # cut again before the next sharded step

    def _reshard_state(self) -> None:
        """Cut the global state into slabs where it was assigned."""
        if self._sharded is None:
            self._sharded = sharding.shard_state(self._global, self.mesh)

    @property
    def sharded_state(self) -> sharding.ShardedMapState:
        self._reshard_state()
        return self._sharded

    def _set_sharded(self, sstate: sharding.ShardedMapState) -> None:
        self._sharded = sstate
        self._global = None

    def sync_device(self) -> None:
        self.mesh.sync()

    def _derive_closest(self) -> torch.Tensor:
        """The lazy closest grid derived on the mesh, gathered."""
        if self._derive_closest_fn is None:
            self._derive_closest_fn = sharding.sharded_derive_closest(
                self.cfg, self.mesh)
        cls = self._derive_closest_fn(self.sharded_state.logodds)
        return sharding._gather_axis(self.mesh, cls,
                                     0 if cls[0].dim() == 3 else 1)

    # -- ingestion: buffer on the host, integrate at update time -----------

    def process(self) -> int:
        n = 0
        for payload, _, pos, quat in self.sync.drain():
            kind, data = payload
            transform = self._build_transform(pos, quat)
            if kind == "depth":
                converted = self._convert_depth(data, transform)
                if converted is None:
                    continue
                pts, valid = converted
            elif isinstance(data, tuple):      # pre-uploaded device pair
                pts, valid = data
            else:
                pts, valid = self._cloud_to_np(data)
            self._pending.append((pts, valid, transform))
            self.cur_pos = self._to_virtual(pos)
            self.new_msg = True
            n += 1
        return n

    def _as_device(self, x, dtype) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype)
        return self._upload(np.asarray(x)).to(dtype)

    def _run_tick(self, chunk) -> UpdateStats:
        k, p = self.scans_per_tick, self.cfg.max_points_per_scan
        pad = k - len(chunk)
        dev = self.device
        pts = torch.stack(
            [self._as_device(c[0], torch.float32) for c in chunk]
            + [torch.zeros((p, 3), dtype=torch.float32, device=dev)] * pad)
        valids = torch.stack(
            [self._as_device(c[1], torch.bool) for c in chunk]
            + [torch.zeros(p, dtype=torch.bool, device=dev)] * pad)
        tfs = self._upload(np.stack([c[2] for c in chunk]
                                    + [np.eye(4)] * pad).astype(np.float32))
        sstate, stats = self._tick(
            self.sharded_state, pts, valids, tfs,
            self._upload(np.asarray(self.cur_pos, np.float32)))
        self._set_sharded(sstate)
        return stats

    def update(self, max_iters: int = 0) -> Optional[UpdateStats]:
        """The sharded tick over the buffered scans, ``scans_per_tick`` at
        a time (``max_iters`` is the incremental engine's and unused)."""
        if not self.new_msg:
            return None
        self.new_msg = False
        self.esdf_cnt += 1
        self._dist_cache = None     # the map changes: plan() re-derives
        last: Optional[UpdateStats] = None
        with Timer("UpdateESDF"):
            while self._pending:
                chunk = self._pending[:self.scans_per_tick]
                self._pending = self._pending[self.scans_per_tick:]
                last = self._run_tick(chunk)
        if self.cfg.signed_needed:
            self.sdf_grid()
        return last

    def sdf_grid(self) -> torch.Tensor:
        """The signed distance field on the mesh (C18), gathered; cached
        per tick."""
        src = self.sharded_state.d2[0]
        if self._sdf_cache is not None and self._sdf_src is src:
            return self._sdf_cache
        if self._sdf_fn is None:
            self._sdf_fn = sharding.sharded_sdf(self.cfg, self.mesh)
        s = self.sharded_state
        self._sdf_cache = sharding._gather_axis(
            self.mesh, self._sdf_fn(s.logodds, s.d2, s.seen), 0)
        self._sdf_src = src
        return self._sdf_cache

    # -- rollout-sharded planning ------------------------------------------

    def plan(self, goal, mpc_cfg=None, p0=None, v0=None, nominal=None,
             generator: Optional[torch.Generator] = None):
        """One MPC solve against the current map, its K rollouts split
        over the mesh (``engine.py:145-199``).  The distance grid (the
        SDF for a signed planner) is replicated to the shards' devices
        once a tick.  ``p0`` defaults to the last sensor position; without
        a ``generator`` the draws come from the engine's own stream
        (seeded 0 on its first solve), fresh each solve."""
        from ..planning import mpc as mpc_mod

        if mpc_cfg is None:
            mpc_cfg = mpc_mod.MPCConfig()
        if mpc_cfg.n_rollouts % self.mesh.size:
            raise ValueError(
                f"n_rollouts={mpc_cfg.n_rollouts} must divide by the "
                f"{self.mesh.size}-device mesh")
        if self._planner_cfg != mpc_cfg:
            self._planner = mpc_mod.make_sharded_planner(self.cfg, mpc_cfg,
                                                         self.mesh)
            self._planner_cfg = mpc_cfg
        if (self._dist_cache is None
                or self._dist_cache_signed != mpc_cfg.signed):
            grid = self.sdf_grid() if mpc_cfg.signed else self.distance_grid()
            self._dist_cache = [sharding._to(grid, d)
                                for d in self.mesh.devices]
            self._dist_cache_signed = mpc_cfg.signed
        if generator is None:
            if self._plan_gen is None:
                self._plan_gen = torch.Generator(
                    device=self.device).manual_seed(0)
            generator = self._plan_gen
        def vec(x, shape):
            return (torch.zeros(shape, device=self.device) if x is None
                    else self._positions(x))

        return self._planner(
            self._dist_cache,
            vec(self.cur_pos if p0 is None else p0, 3), vec(v0, 3),
            vec(goal, 3), vec(nominal, (mpc_cfg.horizon, 3)), generator)


class ShardedScrollingFiestaPipeline(ScrollingMixin, ShardedFiestaPipeline):
    """The unbounded persistent world on a mesh (``engine.py:214-273``):
    the scrolling grid and tile archive (``scrolling.ScrollingMixin``)
    over the sharded tick.  The counter drain before an eviction is the
    sharded tick with no scans; the re-derive after a restore is
    ``sharding.sharded_rebuild_esdf``; recenters wait while scans are
    buffered (their transforms were built in the current virtual frame);
    the strips are read from and written to the gathered global state,
    which ``_reshard_state`` cuts into slabs again."""

    def __init__(self, cfg: FiestaConfig, mesh: Optional[sharding.Mesh] = None,
                 n_devices: Optional[int] = None, scans_per_tick: int = 3,
                 recenter_fraction: float = 0.25, archive=None):
        super().__init__(cfg, mesh=mesh, n_devices=n_devices,
                         scans_per_tick=scans_per_tick)
        self._rebuild = sharding.sharded_rebuild_esdf(cfg, self.mesh)
        self._init_scrolling(recenter_fraction, archive)

    def _drain_counters(self) -> None:
        self._run_tick([])

    def _reshard_state(self) -> None:
        ShardedFiestaPipeline._reshard_state(self)

    def _rederive_distances(self) -> None:
        self.restore_count += 1
        s = self.sharded_state
        d2s, cls = self._rebuild([occupied_grid(self.cfg, lo)
                                  for lo in s.logodds])
        self._set_sharded(dataclasses.replace(
            s, d2=d2s, closest=s.closest if cls is None else cls))

    def maybe_recenter(self, robot_pos) -> bool:
        if self._pending:
            return False
        return super().maybe_recenter(robot_pos)
