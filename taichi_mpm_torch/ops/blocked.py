"""Blocked particle/grid layout: page map, neighbour table, halo merge and
window assembly (torch counterpart of ``taichi_mpm_tpu.ops.blocked``).

Particles are sorted by 4^3-cell grid block (``sort_particles`` for a
Particles set, ``ops.packed.sort_packed`` for the packed state). Each occupied block, dilated
by its 27-neighbourhood, owns one active slot of a page map of capacity K
(slot K is the sentinel: "no block"). Per slot:

* P2G writes a halo tile ``(7, 7, 7, 4)`` [i, j, k, c]: the nodes -1..5
  around the block (block-local node index = tile index - 1), channels
  momentum (3) and mass;
* the halo merge sums overlapping tiles into node records ``(K, 256)``,
  lane ``c*64 + lx*16 + ly*4 + lz`` (the JAX package's record layout);
* the window assembly copies each slot's 7^3 stencil support out of its
  neighbours' velocity records into ``(K, 3, 7, 7, 7)`` [c, wx, wy, wz].

The JAX package computes the merge and the assembly as 0/1 selection
matmuls shaped for the TPU's matrix unit (``merge_tiles_mm`` /
``windows_mm``). Here they are what those matmuls compute, stated as the
gathers and adds of ``tiles_to_records`` / ``records_to_windows``: every
tile node has exactly one record owner, every window node exactly one
record source, so the merge is 8 gathers summed in a fixed order and the
assembly one gather. Nothing is scattered, so the result is bitwise
reproducible.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig

BLOCK = 4  # cells per block per axis
TILE = 7  # nodes per axis touched by a block's particles (quadratic)
TILE_NODES = TILE ** 3  # 343
REC_LANES = 4 * 64  # 256: (c, lx, ly, lz), c-major
VREC_LANES = 3 * 64  # 192: velocity channels only
SENTINEL_ROW = 27  # extra neighbour-table row that always reads slot K


def num_blocks(cfg: SimConfig):
    return tuple(-(-r // BLOCK) for r in cfg.res)


def num_blocks_padded(cfg: SimConfig):
    """Block-id space for node records: one extra block per axis so the
    high-edge halo nodes (up to res+1) have owners."""
    return tuple(n + 1 for n in num_blocks(cfg))


def total_blocks_padded(cfg: SimConfig) -> int:
    nbx, nby, nbz = num_blocks_padded(cfg)
    return nbx * nby * nbz


def block_id_of(x, cfg: SimConfig):
    """Padded block id (int32) of world positions x (..., 3); the caller
    handles inactive particles."""
    nbp = num_blocks_padded(cfg)
    pos = x * cfg.inv_dx
    bid = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    for k, n in enumerate(nbp):
        cell = torch.clamp(torch.floor(pos[..., k]).to(torch.int32), 0, cfg.res[k] - 1)
        bid = bid * n + cell // BLOCK
    return bid


def sort_particles(p, cfg: SimConfig):
    """Sort a Particles set by block id, inactive particles (key = total)
    last, stably. Returns (sorted particles, sorted keys, permutation):
    the same order as the packed state's sort (``ops.packed.sort_packed``)."""
    keys = torch.where(p.active, block_id_of(p.x, cfg), total_blocks_padded(cfg))
    return sort_particles_by_keys(p, keys)


def sort_particles_by_keys(p, keys):
    """Sort a Particles set by precomputed keys, stably. Returns (sorted
    particles, sorted keys, permutation)."""
    keys_sorted, order = torch.sort(keys, stable=True)
    return p.take(order), keys_sorted, order


def _decode_ids(ids, cfg: SimConfig):
    """Decode PADDED block ids -> (bx, by, bz, valid)."""
    nbx, nby, nbz = num_blocks_padded(cfg)
    nbt = nbx * nby * nbz
    safe = torch.clamp(ids, max=nbt - 1)
    bz = safe % nbz
    by = (safe // nbz) % nby
    bx = safe // (nbz * nby)
    return bx, by, bz, ids < nbt


def _dilate27(occ: torch.Tensor) -> torch.Tensor:
    """Box-dilate a 3-D bool grid by one cell along each axis in turn."""
    for ax in range(occ.ndim):
        n = occ.shape[ax]
        out = occ.clone()
        out.narrow(ax, 0, n - 1).logical_or_(occ.narrow(ax, 1, n - 1))
        out.narrow(ax, 1, n - 1).logical_or_(occ.narrow(ax, 0, n - 1))
        occ = out
    return occ


def build_page_map(keys_sorted, cfg: SimConfig, K: int):
    """The page map from the sorted padded block ids (sentinel = total).

    Returns (ids, n_act, slot_map, s_arr, e_arr):
      ids      (K,) int32 active (occupied + 27-dilated) block ids,
               ascending, ``total`` in unused slots;
      n_act    0-d int32 tensor, true dilated occupancy (may exceed K);
      slot_map (total+1,) int32 block id -> slot (K = none);
      s_arr/e_arr (K,) int32 sorted particle range per slot; unused slots
               carry the empty range [n_active, n_active).
    """
    dev = keys_sorted.device
    nbp = num_blocks_padded(cfg)
    total = total_blocks_padded(cfg)
    cand = torch.arange(total + 1, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(keys_sorted, cand, side="left", out_int32=True)
    occ = ((starts[1:] - starts[:-1]) > 0).reshape(nbp)
    occ = _dilate27(occ).reshape(-1)
    # occupied ids first, ascending; then the rest (a stable partition)
    order = torch.argsort((~occ).to(torch.uint8), stable=True).to(torch.int32)
    if K > total:
        pad = torch.full((K - total,), total, dtype=torch.int32, device=dev)
        order = torch.cat([order, pad])
    n_act = occ.sum(dtype=torch.int32)
    slot_idx = torch.arange(K, dtype=torch.int32, device=dev)
    live_slot = slot_idx < n_act
    ids = torch.where(live_slot, order[:K], total)
    slot_map = torch.full((total + 1,), K, dtype=torch.int32, device=dev)
    # unused slots all write K at index `total`, so duplicates agree
    slot_map.scatter_(0, ids.long(), torch.where(live_slot, slot_idx, K))

    safe = torch.clamp(ids, max=total - 1).long()
    live = ids < total
    s_arr = torch.where(live, starts[safe], starts[total])
    e_arr = torch.where(live, starts[torch.clamp(safe + 1, max=total)], starts[total])
    return ids, n_act, slot_map, s_arr, e_arr


def neighbor_slots(ids, slot_map, cfg: SimConfig):
    """(27, K) int32 active-slot ids of each slot's 27-neighbourhood (row
    (ox*3+oy)*3+oz = block offset (ox-1, oy-1, oz-1)); K where the
    neighbour is out of domain or inactive."""
    nbx, nby, nbz = num_blocks_padded(cfg)
    nbt = nbx * nby * nbz
    bx, by, bz, valid = _decode_ids(ids, cfg)
    rows = []
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                X, Y, Z = bx + ox, by + oy, bz + oz
                inb = (
                    (X >= 0) & (X < nbx) & (Y >= 0) & (Y < nby)
                    & (Z >= 0) & (Z < nbz) & valid
                )
                nid = torch.where(inb, (X * nby + Y) * nbz + Z, nbt)
                rows.append(slot_map[nid.long()])
    return torch.stack(rows, 0)


def nbr_at(nbr, ox: int, oy: int, oz: int):
    """Neighbour slot row of offset index (ox, oy, oz), each in 0..2 for
    block offsets -1, 0, +1."""
    return nbr[(ox * 3 + oy) * 3 + oz]


def range_lanes(s_arr, e_arr, n=None):
    """(slot, lane) of every lane inside the slot ranges [s_arr, e_arr),
    slot by slot in slot order; `n`, where given, is their total count
    (else it is read on the host)."""
    counts = (e_arr - s_arr).clamp(min=0).long()
    K = s_arr.shape[0]
    slot = torch.repeat_interleave(torch.arange(K, device=s_arr.device), counts,
                                   output_size=n)
    n = slot.shape[0]
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=s_arr.device) - first[slot]
    return slot, s_arr.long()[slot] + rank


# -- static assembly tables --------------------------------------------------


def _axis_sources():
    """Per axis: record lane l <- [(neighbour offset o, tile index i)]
    (tile node i of the block at offset o-1 is lane l = i - 1 + 4(o-1)),
    and window node w <- (offset o, record lane l)."""
    rec = [[(o, l - 4 * (o - 1) + 1) for o in range(3)
            if 0 <= l - 4 * (o - 1) + 1 < TILE] for l in range(BLOCK)]
    win = [next((o, w - 1 - 4 * (o - 1)) for o in range(3)
                if 0 <= w - 1 - 4 * (o - 1) < BLOCK) for w in range(TILE)]
    return rec, win


@functools.lru_cache(maxsize=None)
def _merge_tables_np():
    """(8, 256) neighbour-row and tile-element indices: record lane r sums
    contributor m = (mx, my, mz) bits, one per axis choice. A missing
    contributor reads the sentinel row (a zero tile)."""
    rec, _ = _axis_sources()
    nb = np.full((8, REC_LANES), SENTINEL_ROW, np.int64)
    te = np.zeros((8, REC_LANES), np.int64)
    for c in range(4):
        for lx in range(BLOCK):
            for ly in range(BLOCK):
                for lz in range(BLOCK):
                    r = c * 64 + lx * 16 + ly * 4 + lz
                    for m in range(8):
                        sel = ((m >> 2) & 1, (m >> 1) & 1, m & 1)
                        srcs = (rec[lx], rec[ly], rec[lz])
                        if any(s >= len(src) for s, src in zip(sel, srcs)):
                            continue
                        (ox, ix), (oy, iy), (oz, iz) = (
                            src[s] for s, src in zip(sel, srcs))
                        nb[m, r] = (ox * 3 + oy) * 3 + oz
                        te[m, r] = ((ix * TILE + iy) * TILE + iz) * 4 + c
    return nb, te


@functools.lru_cache(maxsize=None)
def _window_tables_np():
    """(1029,) neighbour-row and record-lane index of each window node
    [c, wx, wy, wz]."""
    _, win = _axis_sources()
    nb = np.zeros(3 * TILE_NODES, np.int64)
    rl = np.zeros(3 * TILE_NODES, np.int64)
    for c in range(3):
        for wx in range(TILE):
            for wy in range(TILE):
                for wz in range(TILE):
                    (ox, lx), (oy, ly), (oz, lz) = win[wx], win[wy], win[wz]
                    w = ((c * TILE + wx) * TILE + wy) * TILE + wz
                    nb[w] = (ox * 3 + oy) * 3 + oz
                    rl[w] = c * 64 + lx * 16 + ly * 4 + lz
    return nb, rl


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    nb_m, te_m = _merge_tables_np()
    nb_w, rl_w = _window_tables_np()
    return tuple(torch.as_tensor(a, device=device)
                 for a in (nb_m, te_m, nb_w, rl_w))


def _neighbour_columns(nbr):
    """(K, 28) int64: the 27 neighbour slots of each slot plus a sentinel
    column (slot K)."""
    K = nbr.shape[1]
    sentinel = torch.full((1, K), K, dtype=nbr.dtype, device=nbr.device)
    return torch.cat([nbr, sentinel], 0).t().long()


def merge_tiles(tiles, nbr):
    """Halo tiles (K, 7, 7, 7, 4) -> node records (K, 256): each record
    node sums the (up to 8) tile nodes that land on it, taken from the
    neighbour slots in a fixed order."""
    K = tiles.shape[0]
    nb_m, te_m, _, _ = _tables(tiles.device)
    flat = torch.cat([tiles.reshape(K, -1), tiles.new_zeros(1, TILE_NODES * 4)])
    cols = _neighbour_columns(nbr)
    rec = None
    for m in range(8):
        part = flat[cols[:, nb_m[m]], te_m[m]]
        rec = part if rec is None else rec + part
    return rec


def windows(vrec, nbr):
    """Velocity records (K, 192) -> G2P windows (K, 3, 7, 7, 7): each
    window node copies its one record source."""
    K = vrec.shape[0]
    _, _, nb_w, rl_w = _tables(vrec.device)
    flat = torch.cat([vrec, vrec.new_zeros(1, VREC_LANES)])
    cols = _neighbour_columns(nbr)
    return flat[cols[:, nb_w], rl_w].reshape(K, 3, TILE, TILE, TILE)
