"""Spatial domain decomposition on the dense path (torch counterpart of
``taichi_mpm_tpu.parallel.spatial``): particle migration between
x-slabs, the host-side split of a particle set into slabs, and the dense
slab frame.

The domain is split into S slabs along x, one per rank of the process
group (``parallel.comm``). A particle whose cell column leaves its slab
migrates to the neighbouring rank (at the next re-sort of the blocked
slab frames, after every substep of the dense one); the bound on drift
between migrations keeps every move one hop.

The dense slab frame (``build_spatial_frame``, 2-D and 3-D scenes): each
rank keeps its slab's particles and a node window, its slab's node
columns and HALO = 2 columns each side, and runs ``core.transfer``'s
P2G, grid update and G2P on it. After P2G the 2 HALO + 1 columns that
neighbouring windows share are summed by one exchange each way
(``halo_allreduce``), so the whole window holds complete sums and the
rest is local; then the particles migrate. It runs neither the
per-particle collision nor the boundary clean-up, as the JAX package's
does not.

The JAX package migrates through fixed buffers of a budget, drops and
counts what does not fit, and its driver re-runs the frame with a larger
budget. Here the counts travel first and the buffers are sized to them,
and a rank whose free lanes are too few for its arrivals grows its
particle set: nothing is dropped and no frame is re-run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core import transfer
from taichi_mpm_torch.core.state import FIELDS, Particles, empty_particles
from taichi_mpm_torch.parallel import comm

HALO = 2  # node columns of stencil support each side of a slab


def slab_cells(cfg: SimConfig, n_shards: int) -> int:
    if cfg.res[0] % n_shards:
        raise ValueError(f"res[0]={cfg.res[0]} must divide by n_shards={n_shards}")
    return cfg.res[0] // n_shards


@dataclasses.dataclass
class Migration:
    """What one migration moved on this rank: particles sent to the left
    and to the right rank, particles received, and lanes added to hold
    them."""

    sent_left: int = 0
    sent_right: int = 0
    arrived: int = 0
    grown: int = 0


def lane_rows(p: Particles) -> torch.Tensor:
    """The lanes of `p` as rows (lanes, width) of float32, every field
    flattened in FIELDS order (integers bitcast, flags as 0 or 1): what a
    migration sends, for scenes of any dimension."""
    cols = []
    for f in FIELDS:
        a = getattr(p, f)
        a = a.view(torch.float32) if a.dtype == torch.int32 else a.to(torch.float32)
        cols.append(a.reshape(p.capacity, int(np.prod(a.shape[1:], dtype=np.int64))))
    return torch.cat(cols, 1)


def from_lane_rows(rows: torch.Tensor, like: Particles) -> dict:
    """``lane_rows``'s inverse: the fields of the lanes in `rows`, shaped
    and typed as `like`'s."""
    out, c = {}, 0
    for f in FIELDS:
        a = getattr(like, f)
        w = int(np.prod(a.shape[1:], dtype=np.int64))
        v = rows[:, c:c + w].reshape((rows.shape[0],) + tuple(a.shape[1:]))
        c += w
        out[f] = (v.contiguous().view(torch.int32) if a.dtype == torch.int32
                  else v > 0.5 if a.dtype == torch.bool else v.clone())
    return out


def _grow(p: Particles, n: int) -> Particles:
    """`p` with `n` free lanes appended (F = I, inactive)."""
    extra = empty_particles(n, p.dim, p.device)
    return Particles(**{f: torch.cat([getattr(p, f), getattr(extra, f)]) for f in FIELDS})


def migrate(p: Particles, cfg: SimConfig, n_shards: int, dest=None, axis=None):
    """Move the active particles whose owner is another rank to the left
    or right neighbour (the JAX package's ``migrate``); `dest` is each
    lane's owner (default: the uniform slab of its cell column), and only
    moves of one hop exist. Departures are deactivated where they lie;
    arrivals, those from the left rank first, each side in its sender's
    lane order, fill the free lanes in ascending order, as the JAX
    package places them. Each side sends its counts, then buffers of
    that size: the movers' fields as rows (``lane_rows``). `p`'s
    tensors are updated in place unless lanes must be added, which
    returns a grown set. Returns (p, Migration).

    On a pencil mesh (the JAX package's ``spatial_mesh2d._migrate_axis``)
    `axis` is the ``comm.Axis`` to move along, `n_shards` its size and
    `dest` each lane's owner along it; left and right are that axis's
    neighbours."""
    s = comm.rank() if axis is None else axis.index
    if dest is None:
        cx = torch.floor(p.x[:, 0] * cfg.inv_dx).to(torch.int32)
        dest = torch.clamp(torch.div(cx, slab_cells(cfg, n_shards), rounding_mode="floor"),
                           0, n_shards - 1)
    go_left = p.active & (dest < s)
    go_right = p.active & (dest > s)
    idx_l = torch.nonzero(go_left).flatten()
    idx_r = torch.nonzero(go_right).flatten()
    counts = torch.tensor([[idx_l.numel()], [idx_r.numel()]], dtype=torch.int64,
                          device=p.device)
    from_left, from_right = comm.neighbour_exchange(counts[0], counts[1], axis=axis)
    n_from_left, n_from_right = (int(v) for v in torch.cat([from_left, from_right]).tolist())
    buf_l, buf_r = (lane_rows(p.take(i)) for i in (idx_l, idx_r))
    width = buf_l.shape[1]
    recv_l, recv_r = comm.neighbour_exchange(buf_l, buf_r, (n_from_left, width),
                                             (n_from_right, width), axis=axis)
    p.active[idx_l] = False
    p.active[idx_r] = False

    arrived = torch.cat([recv_l, recv_r], 0)
    m = arrived.shape[0]
    free = torch.nonzero(~p.active).flatten()
    grown = max(0, m - free.numel())
    if grown:
        grown = -(-grown // 64) * 64
        p = _grow(p, grown)
        free = torch.nonzero(~p.active).flatten()
    if m:
        lanes = free[:m]
        for f, v in from_lane_rows(arrived, p).items():
            getattr(p, f)[lanes] = v
    return p, Migration(idx_l.numel(), idx_r.numel(), m, grown)


def split_host(p: Particles, slab, n_shards: int, rank: int, slack: float):
    """This rank's part of a particle set on the host (the JAX package's
    ``shard_spatially`` body): `slab` (numpy, per lane) names each lane's
    slab; every slab gets the local capacity max(ceil(slack x the largest
    slab's count), 8), its active particles first, in their order.
    Returns (the rank's Particles on p's device, local capacity)."""
    act = p.active.cpu().numpy()
    counts = np.bincount(slab[act], minlength=n_shards)
    cap = max(int(np.ceil(counts.max() * slack)), 8)
    sel = np.nonzero(act & (slab == rank))[0]
    out = empty_particles(cap, p.dim, p.device)
    idx = torch.as_tensor(sel, device=p.device)
    for f in FIELDS:
        getattr(out, f)[: sel.size] = getattr(p, f)[idx]
    return out, cap


def shard_spatially(p: Particles, cfg: SimConfig, n_shards: int, rank: int,
                    slack: float = 1.0):
    """This rank's uniform slab of the particle set `p` (the JAX package's
    ``shard_spatially``, whose global layout is the ranks' parts one after
    another). Returns (Particles, local capacity)."""
    Wc = slab_cells(cfg, n_shards)
    x = p.x[:, 0].cpu().numpy()
    cx = np.clip((x / cfg.dx).astype(np.int64), 0, cfg.res[0] - 1)
    slab = np.clip(cx // Wc, 0, n_shards - 1)
    return split_host(p, slab, n_shards, rank, slack)


# -- the dense slab frame ----------------------------------------------------------


def window_nodes(cfg: SimConfig, n_shards: int) -> int:
    """Node columns of a slab's window: the slab's, and 2 HALO + 1 shared
    with the neighbours' windows."""
    return slab_cells(cfg, n_shards) + 2 * HALO + 1


def _local_nodes(cfg: SimConfig, n_shards: int):
    return (window_nodes(cfg, n_shards),) + tuple(cfg.grid_nodes[1:])


def node_window(s: int, cfg: SimConfig, n_shards: int):
    """Slab s's node window (``core.transfer``'s `window`): its first
    global node column, s Wc - HALO, and its node counts."""
    return s * slab_cells(cfg, n_shards) - HALO, _local_nodes(cfg, n_shards)


def active_particles(p: Particles) -> Particles:
    """The active particles of `p`, in lane order (one host read), which
    the dense slab frames scatter: an inactive lane adds a zero at node 0,
    and the card's ordered scatter sums a node's values one after another,
    so a slab's free lanes would make node 0 one long serial sum (as
    ``MPM`` runs its dense frame on its live lanes). Without those zeros
    every node sums the same values in the same order."""
    return p.take(torch.nonzero(p.active).flatten())


def p2g_local(p: Particles, x_start: int, cfg: SimConfig, dt, n_shards: int):
    """The rank's particles scattered into its node window, whose column 0
    is global node column `x_start`."""
    return transfer.p2g(p, cfg, dt, window=(x_start, _local_nodes(cfg, n_shards)))


def grid_update_local(grid, x_start: int, cfg: SimConfig, colliders, t, dt, n_shards: int,
                      xg=None):
    """``transfer.grid_update`` on the window, the colliders at the nodes'
    global positions `xg` (``transfer.node_positions`` of the window,
    built here when not given). Returns the node velocities."""
    window = (x_start, _local_nodes(cfg, n_shards))
    if colliders and xg is None:
        xg = transfer.node_positions(cfg, grid.device, window)
    return transfer.grid_update(grid, cfg, colliders, t, dt, xg)[0]


def g2p_local(p: Particles, grid_v, x_start: int, cfg: SimConfig, dt, n_shards: int):
    """``transfer.g2p`` from the window's node velocities. Returns (p, the
    plasticity count as a 0-d tensor)."""
    return transfer.g2p(p, grid_v, cfg, dt, return_count=True,
                        window=(x_start, _local_nodes(cfg, n_shards)))


def halo_allreduce(grid):
    """Sum the 2 HALO + 1 node columns that neighbouring windows share:
    each rank sends its low columns left and its high columns right (the
    values before the exchange) and adds what arrives, in place; then
    every column of the window holds the complete sum."""
    k = 2 * HALO + 1
    from_left, from_right = comm.neighbour_exchange(grid[:k], grid[-k:])
    grid[:k] += from_left
    grid[-k:] += from_right
    return grid


def spatial_substep(p: Particles, t, cfg: SimConfig, colliders, dt, n_shards: int, xg=None):
    """One dense substep of this rank's slab: P2G of its active particles
    into the window, the halo sum, the grid update, G2P, then migration. Every rank calls it
    together. Returns (p, t + dt, plasticity count, Migration)."""
    x_start, _ = node_window(comm.rank(), cfg, n_shards)
    grid = halo_allreduce(p2g_local(active_particles(p), x_start, cfg, dt, n_shards))
    gv = grid_update_local(grid, x_start, cfg, colliders, t, dt, n_shards, xg)
    p, count = g2p_local(p, gv, x_start, cfg, dt, n_shards)
    p, mig = migrate(p, cfg, n_shards)
    return p, np.float32(t) + np.float32(dt), count, mig


def build_spatial_frame(cfg: SimConfig, colliders, n_substeps: int, n_shards: int = None):
    """The dense slab frame over the ranks of the current group, S slabs
    along x (S the world size unless given): frame(p, t) -> (p, t,
    dropped), `p` this rank's slab (``shard_spatially``). Migration is
    sized to its counts, so nothing is dropped: `dropped` is 0, where the
    JAX package's frame counts the particles past its budget. The
    node positions are built once per frame."""
    n_shards = comm.world() if n_shards is None else n_shards
    slab_cells(cfg, n_shards)

    def frame(p: Particles, t):
        xg = None
        if colliders:
            xg = transfer.node_positions(cfg, p.device, node_window(comm.rank(), cfg, n_shards))
        for _ in range(n_substeps):
            p, t, _, _ = spatial_substep(p, t, cfg, colliders, cfg.base_dt, n_shards, xg)
        return p, t, 0

    return frame
