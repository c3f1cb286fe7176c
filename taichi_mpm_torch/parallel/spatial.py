"""Spatial domain decomposition: particle migration between x-slabs and
the host-side split of a particle set into slabs (torch counterpart of
the parts of ``taichi_mpm_tpu.parallel.spatial`` that the slab frames
run: ``slab_cells``, ``migrate``, ``shard_spatially``).

The domain is split into S slabs along x, one per rank of the process
group (``parallel.comm``). A particle whose cell column leaves its slab
migrates to the neighbouring rank at the next re-sort; the bound on
drift between sorts keeps every move one hop.

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
from taichi_mpm_torch.core.state import FIELDS, Particles, empty_particles
from taichi_mpm_torch.ops import packed
from taichi_mpm_torch.ops.rows import NCH
from taichi_mpm_torch.parallel import comm


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


def _grow(p: Particles, n: int) -> Particles:
    """`p` with `n` free lanes appended (F = I, inactive)."""
    extra = empty_particles(n, p.dim, p.device)
    return Particles(**{f: torch.cat([getattr(p, f), getattr(extra, f)]) for f in FIELDS})


def migrate(p: Particles, cfg: SimConfig, n_shards: int, dest=None):
    """Move the active particles whose owner is another rank to the left
    or right neighbour (the JAX package's ``migrate``); `dest` is each
    lane's owner (default: the uniform slab of its cell column), and only
    moves of one hop exist. Departures are deactivated where they lie;
    arrivals, those from the left rank first, each side in its sender's
    lane order, fill the free lanes in ascending order, as the JAX
    package places them. Each side sends its counts, then buffers of
    that size: the packed rows of the movers (``ops.packed``). `p`'s
    tensors are updated in place unless lanes must be added, which
    returns a grown set. Returns (p, Migration)."""
    s = comm.rank()
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
    from_left, from_right = comm.neighbour_exchange(counts[0], counts[1])
    n_from_left, n_from_right = (int(v) for v in torch.cat([from_left, from_right]).tolist())
    buf_l, buf_r = (packed.pack_particles(p.take(i)) for i in (idx_l, idx_r))
    recv_l, recv_r = comm.neighbour_exchange(buf_l, buf_r, (NCH, n_from_left),
                                             (NCH, n_from_right))
    p.active[idx_l] = False
    p.active[idx_r] = False

    arrived = torch.cat([recv_l, recv_r], 1)
    m = arrived.shape[1]
    free = torch.nonzero(~p.active).flatten()
    grown = max(0, m - free.numel())
    if grown:
        grown = -(-grown // 64) * 64
        p = _grow(p, grown)
        free = torch.nonzero(~p.active).flatten()
    if m:
        q = packed.unpack_particles(arrived, m)
        lanes = free[:m]
        for f in FIELDS:
            getattr(p, f)[lanes] = getattr(q, f)
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
