"""Particle data parallelism on the dense path (torch counterpart of
``taichi_mpm_tpu.parallel.sharding``): the particle lanes are split over
the ranks of the current process group, each rank scatters its
particles into a whole grid of its own, the grids are summed over the
ranks (``comm.all_sum``), and every rank runs the grid update on the sum
and G2P on its own particles. Correct for any split of the particles;
every rank holds the whole grid. The caller's process group is the mesh:
there is no ``make_mesh``.
"""

from __future__ import annotations

import numpy as np

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core import transfer
from taichi_mpm_torch.core.state import Particles
from taichi_mpm_torch.parallel import comm
from taichi_mpm_torch.parallel.spatial import active_particles


def shard_particles(p: Particles, n_shards: int, rank: int) -> Particles:
    """This rank's lanes of `p`: the rank-th of n_shards equal parts of the
    capacity, which n_shards must divide (pad before)."""
    if p.capacity % n_shards:
        raise ValueError(f"capacity {p.capacity} must divide by n_shards={n_shards}")
    c = p.capacity // n_shards
    return p.take(slice(rank * c, (rank + 1) * c))


def sharded_substep(p: Particles, t, cfg: SimConfig, colliders, dt, xg=None):
    """One substep on every rank together: local P2G (of the active
    particles, ``spatial.active_particles``), the grids summed over the
    ranks, the grid update, local G2P. Returns (p, t + dt, the plasticity
    count as a 0-d tensor)."""
    grid = comm.all_sum(transfer.p2g(active_particles(p), cfg, dt))
    grid_v, _ = transfer.grid_update(grid, cfg, colliders, t, dt, xg)
    p, count = transfer.g2p(p, grid_v, cfg, dt, return_count=True)
    return p, np.float32(t) + np.float32(dt), count


def build_sharded_frame(cfg: SimConfig, colliders, n_substeps: int):
    """The data-parallel frame: frame(p, t) -> (p, t), `p` this rank's lanes
    (``shard_particles``), n_substeps substeps of cfg.base_dt. The node
    positions are built once per frame."""

    def frame(p: Particles, t):
        xg = transfer.node_positions(cfg, p.device) if colliders else None
        for _ in range(n_substeps):
            p, t, _ = sharded_substep(p, t, cfg, colliders, cfg.base_dt, xg)
        return p, t

    return frame
