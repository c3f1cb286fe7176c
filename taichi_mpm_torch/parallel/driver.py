"""DistributedMPM: the MPM scene API over x-slabs or the pencils of a 2-D
mesh, one rank each (torch counterpart of
``taichi_mpm_tpu.parallel.driver``).

The JAX package drives all devices from one process under ``shard_map``.
The port is SPMD, as ``torchrun`` launches it: every rank runs the same
scene script, builds the same particle set from the same seed, keeps the
particles of its own slab or pencil, and steps it with the port's
kernels (``parallel.spatial_blocked.slab_frame``), meeting the other ranks in
the collectives of ``parallel.comm``. Every call of the scene API is made
by every rank; the read-outs return the global answer on every rank,
and files are written by rank 0.

3-D scenes run on 1-D slabs, or with ``mesh_shape=(Sx, Sy)`` on pencils
(``parallel.spatial_mesh2d``), on both routes (``TMT_FUSED``), with
load-balanced bounds by default. A scene with rigid bodies (CPIC) keeps
them replicated: every rank builds them, runs the host's rigid solves on
its copy and applies the impulses summed over the ranks, so the copies
stay equal in bits. Its frames route as the JAX driver's do
(``taichi_mpm_tpu/parallel/driver.py:257-322``):

=========  ========  ========  =============================================
layout     bounds    route     frame
=========  ========  ========  =============================================
slabs      either    fused     the packed CPIC frame
slabs      either    unfused   the pytree CPIC frame on uniform slabs (a
                               balanced scene falls back to uniform)
pencils    either    fused     the packed CPIC frame
pencils    uniform   unfused   the pytree CPIC frame
pencils    balanced  unfused   refused (ValueError), as in the JAX driver
=========  ========  ========  =============================================

Plain scenes run every route on every kind of bounds.
``DistributedAsyncMPM`` runs the per-block bucketed scheduler on uniform
slabs (``parallel.async_spatial``).
"""

from __future__ import annotations

import os
import types
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from taichi_mpm_torch.core.solver import MPM, mechanical_energy
from taichi_mpm_torch.core.state import FIELDS, Particles
from taichi_mpm_torch.ops import async_bucketed, blocked, packed
from taichi_mpm_torch.ops.rows import RACT
from taichi_mpm_torch.parallel import async_spatial, comm
from taichi_mpm_torch.parallel import spatial_blocked as sb
from taichi_mpm_torch.parallel import spatial_mesh2d as sm
from taichi_mpm_torch.parallel.spatial import shard_spatially
from taichi_mpm_torch.rigid import cpic_packed


def _round64(n: int) -> int:
    return -(-int(n) // 64) * 64


class DistributedMPM(MPM):
    """``MPM`` over x-slabs, or the pencils of a 2-D mesh, of the ranks of
    the current process group.

    Extra keywords:
      n_shards:   the number of slabs; must equal the group's world size
                  (default: the world size)
      mesh_shape: (Sx, Sy) for a 2-D pencil mesh instead of 1-D slabs:
                  Sx * Sy must equal the world size, and pencil (sx, sy)
                  is rank sx * Sy + sy. Per-axis balanced bounds unless
                  balanced=False or an axis's grid gives its bounds no
                  room (r_max < 1), then uniform pencils on both axes
                  (each res[ax] a multiple of 4 * S). ``mesh2d``, ``rx``
                  and ``ry`` say what was chosen.
      balanced:   load-balanced slab bounds (default True; uniform slabs
                  where the grid gives the bounds no room, r_max < 1, and
                  on the unfused route of a CPIC scene, as in the JAX
                  driver)
      r:          balance radius in block columns (default: the largest
                  the grid allows; on pencils clamped to each axis's
                  largest)
      slack:      each slab's initial capacity over the largest slab's
                  count (default 2.0). The JAX package's slabs keep that
                  capacity and raise when migration exhausts it; here a
                  slab grows where its arrivals need more lanes, so
                  slack only sizes the initial split.
      device:     this rank's device: default cuda:{LOCAL_RANK}
                  (``comm.rank_device``); "cpu" runs on the CPU.

    ``particles`` is this rank's slab or pencil (its lanes in its sorted
    order); ``slabs`` its layout (``spatial_blocked.Slabs`` or
    ``spatial_mesh2d.Pencils``);
    ``positions``, ``velocities``, ``energy`` and ``particle_count`` are
    global. A process group must exist (``torchrun`` and
    ``runner.mpm_class``, or ``comm.process_group``).
    """

    def __init__(self, res: Sequence[int], *args, n_shards: Optional[int] = None,
                 mesh_shape: Optional[tuple] = None, balanced: bool = True,
                 r: Optional[int] = None, slack: float = 2.0, device=None, **kw):
        if not dist.is_initialized():
            raise RuntimeError(
                "DistributedMPM runs one rank per process of a torch.distributed group, "
                "and none is initialized: launch with `torchrun --nproc-per-node N` "
                "(SHARDS=N through the runner), or start one with "
                "taichi_mpm_torch.parallel.comm.process_group")
        super().__init__(res, *args, device=comm.rank_device(device), **kw)
        if dist.get_backend() == "nccl":
            torch.cuda.set_device(self.device)  # NCCL's collectives run on the current device
        if self.cfg.dim != 3:
            raise ValueError("DistributedMPM is 3-D only")
        self.rank = comm.rank()
        self.slack = slack
        self.r = self.rx = self.ry = None
        self.mesh2d = mesh_shape is not None
        self.slab_stats = sb.SlabStats()
        self._bounds = self._hist = None  # the bounds and histogram of the split
        if self.mesh2d:
            self._init_pencils(mesh_shape, balanced, r)
            return
        self.n_shards = comm.world() if n_shards is None else int(n_shards)
        if self.n_shards != comm.world():
            raise ValueError(f"n_shards={self.n_shards} must equal the process group's "
                             f"world size {comm.world()}")
        if balanced:
            r_max = sb.max_radius(self.cfg, self.n_shards)
            r = r_max if r is None else r
            if r > r_max:
                raise ValueError(f"balance radius {r} > max {r_max}")
            self.r = int(r) if r >= 1 else None
        self.balanced = self.r is not None
        self.slabs = sb.Slabs(self.cfg, self.n_shards, self.rank, self.r)

    def _init_pencils(self, mesh_shape, balanced: bool, r: Optional[int]):
        """The pencil mesh, as the JAX driver chooses it
        (``taichi_mpm_tpu/parallel/driver.py:76-105``): each axis's radius
        the largest it allows, or `r` clamped to it; balanced only where
        both axes allow r >= 1, else uniform on both."""
        Sx, Sy = (int(n) for n in mesh_shape)
        if Sx * Sy != comm.world():
            raise ValueError(f"mesh_shape=({Sx}, {Sy}) must hold the process group's "
                             f"{comm.world()} ranks")
        self.mesh_shape = (Sx, Sy)
        self.n_shards = Sx * Sy
        rs = []
        for ax, S in ((0, Sx), (1, Sy)):
            if balanced and self.cfg.res[ax] % 4 == 0:
                r_max = sb.max_radius(self.cfg, S, ax)
                rs.append(min(r_max, r) if r is not None else r_max)
            else:
                rs.append(0)
        self.balanced = min(rs) >= 1
        if self.balanced:
            self.rx, self.ry = (int(v) for v in rs)
        else:
            for ax, S in ((0, Sx), (1, Sy)):
                if self.cfg.res[ax] % (4 * S):
                    raise ValueError(f"res[{ax}]={self.cfg.res[ax]} must divide into whole "
                                     f"blocks per pencil (4*{S})")
        self.slabs = self._layout()

    # -- the slab state: MPM's _pcarry holds (state, SlabCarry) after a frame ------

    @property
    def block_capacity(self) -> Optional[int]:
        return None if self._pcarry is None else self._pcarry[1].K

    def _layout(self):
        """The layout the frames run on: this rank's pencil on a mesh, else
        its slab with ``_slab_radius``."""
        if self.mesh2d:
            r = (self.rx, self.ry) if self.balanced else None
            return sm.Pencils(self.cfg, self.mesh_shape, self.rank, r)
        return sb.Slabs(self.cfg, self.n_shards, self.rank, self._slab_radius())

    def _slab_radius(self) -> Optional[int]:
        """The balance radius the frames run with: None (uniform slabs) on
        the unfused route of a CPIC scene, whose pytree frame the JAX
        driver runs on uniform slabs only; else ``r``."""
        if self.bodies is None or self.fused:
            return self.r
        if self.cfg.res[0] % (4 * self.n_shards):
            raise ValueError(
                "TMT_FUSED=0 routes CPIC scenes to the uniform-slab pytree frame: "
                f"res[0]={self.cfg.res[0]} must divide into whole blocks per shard "
                f"(4*{self.n_shards})")
        return None

    def _gather(self):
        """The global particle set on every rank: the ranks' lanes one
        after another, the JAX package's global layout. A collective."""
        p = self.particles
        rows = comm.all_gather_rows(packed.pack_particles(p).t().contiguous())
        return packed.unpack_particles(rows.t().contiguous(), rows.shape[0])

    def _shard(self):
        """Split the global particle set (self._particles, the same on
        every rank) into this rank's slab or pencil, leaving `slack`
        headroom (the JAX driver's ``_shard``)."""
        p = self._particles
        cfg = self.cfg
        self.slabs = self._layout()
        if self.mesh2d:
            self._shard_pencils(p)
            return
        if self.slabs.balanced:
            self._bounds = sb.balanced_bounds_host(p, cfg, self.n_shards, self.r)
            self._hist = torch.zeros((self.slabs.CB,), dtype=torch.int32, device=self.device)
            local, _ = sb.shard_spatially_bounds(p, cfg, self.n_shards, self.rank, self._bounds,
                                                 self.slack)
        else:
            self._bounds, self._hist = None, None
            local, _ = shard_spatially(p, cfg, self.n_shards, self.rank, self.slack)
        self._set_particles(local)

    def _shard_pencils(self, p):
        cfg, shape = self.cfg, self.mesh_shape
        if self.balanced:
            self._bounds = sm.balanced_bounds2d_host(p, cfg, shape, self.rx, self.ry)
            self._hist = torch.zeros((sum(self.slabs.CB),), dtype=torch.int32, device=self.device)
            local, _ = sm.shard_pencils_bounds(p, cfg, shape, self.rank, *self._bounds, self.slack)
        else:
            self._bounds, self._hist = None, None
            local, _ = sm.shard_pencils(p, cfg, shape, self.rank, self.slack)
        self._set_particles(local)

    def _finalize(self, capacity: Optional[int] = None, allow_empty: bool = False):
        super()._finalize(capacity, allow_empty)
        self._shard()

    def _finalize_for_load(self, snap_cap: int):
        """A scene a snapshot is loaded into: the global set (unsharded)."""
        if self._particles is None and self._pcarry is None or self._pending:
            MPM._finalize(self, self.capacity or (None if self._pending else snap_cap),
                          allow_empty=True)
        else:
            self._set_particles(self._gather())

    def _inject(self, batch: dict):
        """Emission after the first frame: the global set gathered, the
        batch written into its free lanes, the set split again (sources
        land on their owner)."""
        self._set_particles(self._gather())
        super()._inject(batch)
        self._shard()

    def load(self, path: str):
        """Resume a snapshot (the port's or the JAX package's, of one device
        or of slabs: snapshots hold the global set and the bodies), then
        split it; every rank restores the same bodies."""
        super().load(path)
        self._shard()

    # -- frames -------------------------------------------------------------------

    def _initial_K(self) -> int:
        return _round64(min(blocked.total_blocks_padded(self.slabs.lcfg),
                            max(256, self._active_block_cap())))

    def _rigid_caps(self):
        """The CPIC frames' capacities: the rigid page map's Kr estimated as
        ``MPM`` does, at most the slab's local block space."""
        if self.cpic_caps is None:
            self.cpic_caps = cpic_packed.Capacities(
                min(self._rigid_map_cap(), blocked.total_blocks_padded(self.slabs.lcfg)))
        return self.cpic_caps

    def step(self, frame_dt: Optional[float] = None):
        """One frame on every rank (``slab_frame``; the CPIC frame where the
        scene has rigid bodies). The rank's state stays in its carry;
        ``particles`` unpacks it when read, and ``bodies`` are this rank's
        copy of the replicated bodies."""
        if (self._particles is None and self._pcarry is None) or self._pending:
            self._finalize()
        if self.mesh2d and self.bodies is not None and self.balanced and not self.fused:
            raise ValueError(
                "TMT_FUSED=0 routes CPIC pencil scenes to the uniform frame; pass "
                "balanced=False (or re-enable the fused path) for unfused CPIC on a 2-D mesh")
        n_sub = max(1, int(round((frame_dt or self.frame_dt) / self.cfg.base_dt)))
        carry = None if self._pcarry is None else self._pcarry[1]
        if carry is None:
            p = self.particles
            state = (packed.pack_particles(p) if self.fused
                     else Particles(**{f: getattr(p, f).clone() for f in FIELDS}))
            carry = sb.SlabCarry(state, self._bounds, self._hist, self._initial_K())
        rigid = {}
        if self.bodies is not None:
            carry.bodies = self.bodies
            rigid = dict(scene=self.rigid_scene, caps=self._rigid_caps())
        st = self.slab_stats
        sorts0 = st.resorts
        st.n_near = st.n_coarse = st.n_r = 0
        carry, t, plast = sb.slab_frame(carry, self.t, self.slabs, tuple(self.colliders),
                                        self.cfg.base_dt, n_sub, self.fused, st, **rigid)
        if self.fused:
            self._cap_p = carry.state.shape[1]  # the lanes the packed state unpacks to
        if self.bodies is not None:
            self.bodies = carry.bodies
            self.cpic_stats = dict(n_near=st.n_near, n_coarse=st.n_coarse, n_r=st.n_r)
        self._end_frame((carry.state, carry), t, st.resorts - sorts0, comm.all_sum(plast))

    # -- read-out and I/O (every rank calls; the answers are global) ---------------

    def particle_count(self) -> int:
        self._ensure_finalized()
        st = None if self._pcarry is None else self._pcarry[0]
        act = (st[RACT] > 0.5) if isinstance(st, torch.Tensor) else self.particles.active
        return int(comm.all_sum(act.sum(dtype=torch.int64)))

    def positions(self) -> np.ndarray:
        self._ensure_finalized()
        p = self.particles
        return comm.all_gather_rows(p.x[p.active]).cpu().numpy()

    def velocities(self) -> np.ndarray:
        self._ensure_finalized()
        p = self.particles
        return comm.all_gather_rows(p.v[p.active]).cpu().numpy()

    def energy(self) -> float:
        """Mechanical energy of all slabs: each rank's sum, summed."""
        self._ensure_finalized()
        return float(comm.all_sum(mechanical_energy(self.particles, self.cfg)))

    def visualize(self, path: str, verbose: bool = False, write_rigid: bool = True,
                  writer: str = "native"):
        """The global particles to a BGEO file and, with rigid bodies and
        `write_rigid`, their meshes beside it (``MPM.visualize``), written
        by rank 0."""
        self._ensure_finalized()
        p = self._gather()
        if self.rank == 0:
            self._write_bgeo(p, path, verbose, writer)
            if write_rigid and self.bodies is not None:
                self.write_rigid_meshes(os.path.splitext(path)[0] + "_rigid")

    def save(self, path: str):
        """A snapshot of the global state (one device's format: the
        particles and the bodies), written by rank 0."""
        from taichi_mpm_torch.io.checkpoint import save_checkpoint

        self._ensure_finalized()
        p = self._gather()
        if self.rank == 0:
            save_checkpoint(path, types.SimpleNamespace(
                particles=p, bodies=self.bodies, t=self.t, cfg=self.cfg,
                frame_dt=self.frame_dt))


class DistributedAsyncMPM(DistributedMPM):
    """The per-block bucketed scheduler (``AsyncMPM(per_block=True)``) over
    uniform x-slabs of the ranks of the current process group
    (``parallel.async_spatial``): a power-of-two dt level per grid block,
    with neighbour monotonicity across the slab boundaries, and the tick
    loop in lockstep on every rank, the fused route's kernels on each
    rank's mini-states.

    Plain 3-D scenes on uniform slabs (``res[0]`` a multiple of 4 x the
    ranks); base_delta_t is the largest dt and unit_delta_t the
    power-of-two unit, snapped so that frame_dt = m * unit * 2^MAXLEV, as
    ``AsyncMPM`` snaps it. The JAX driver's `budgets` and `K_ctx` are
    accepted, so that scene code stays the same, and ignored: the sizes
    here follow the counts and no frame is re-run. ``update_counter`` sums
    the committed particle advances over the ranks and frames;
    ``last_frame_stats`` is this rank's ``async_bucketed.FrameStats`` of
    the newest frame (its level histograms this rank's, the schedule the
    same on every rank) and ``slab_stats`` counts the migrations.
    """

    def __init__(self, res, *args, unit_delta_t: float = 1e-6, strength_dt_mul: float = 1.0,
                 cfl_dt_mul: float = 1.0, budgets=None, K_ctx: Optional[int] = None, **kw):
        kw.setdefault("balanced", False)
        if kw["balanced"]:
            raise ValueError("bucketed async runs on uniform slabs (balanced bounds are a "
                             "uniform-dt frame feature so far)")
        if kw.get("mesh_shape") is not None:
            raise ValueError("bucketed async is slab-mesh (1-D) only")
        super().__init__(res, *args, **kw)
        self.unit_delta_t = unit_delta_t
        self.strength_dt_mul = strength_dt_mul
        self.cfl_dt_mul = cfl_dt_mul
        self.update_counter = 0
        self.last_substeps = 0
        self.last_dt_range = None
        self.last_frame_stats = None

    def bucket_unit(self) -> float:
        return async_bucketed.snapped_unit(self.frame_dt, self.unit_delta_t)

    def step(self, frame_dt: Optional[float] = None):
        """One bucketed frame on every rank (``bucketed_slab_frame``, which
        migrates and sorts first). Returns this rank's particles."""
        if frame_dt is not None and frame_dt != self.frame_dt:
            raise ValueError("frame_dt is baked into the bucketed tick loop")
        if (self._particles is None and self._pcarry is None) or self._pending:
            self._finalize()
        if self.bodies is not None:
            raise ValueError("adaptive dt + CPIC not supported yet")
        if self._pcarry is None:
            state, K = packed.pack_particles(self.particles), self._initial_K()
        else:
            state, K = self._pcarry[0], self._pcarry[1].K
        unit = self.bucket_unit()
        st, K, t, n_up, stats = async_spatial.bucketed_slab_frame(
            state, self.t, self.slabs, tuple(self.colliders), self.frame_dt, unit, K,
            self.strength_dt_mul, self.cfl_dt_mul, self.slab_stats)
        self._cap_p = st.shape[1]
        self._end_frame((st, sb.SlabCarry(st, None, None, K)), t, stats.sorts, 0)
        self.update_counter += n_up
        self.last_substeps = stats.n_substeps
        used = [L for L, n in enumerate(stats.advances) if n]
        self.last_dt_range = ((unit * (1 << used[0]), unit * (1 << used[-1])) if used
                              else None)
        self.last_frame_stats = stats
        return self.particles
