"""Diagnostics (torch counterpart of ``taichi_mpm_tpu.diagnostics``):
``stage_report``, the per-stage profile of a substep, and
``p2g_edge_inputs``, hand-made inputs at the P2G kernels' edges. The
other diagnostics of the JAX module (energy series, memory stats) are
not ported yet (ROADMAP.md queue 1 item 8)."""

from __future__ import annotations

import time

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.materials import models
from taichi_mpm_torch.ops import blocked, g2p, p2g, packed
from taichi_mpm_torch.ops.rows import (
    NCH, RACT, RAUX, RC, RF, RMASS, RMAT, RMATF, RORG, RPAR, RV, RVOL, RX,
)
from taichi_mpm_torch.ops.substep import grid_update_flat

STAGES = ("prep", "p2g", "merge", "grid", "windows", "g2p", "finish")


def _ms_per_call(fn, calls: int, repeats: int, device) -> float:
    """Best over `repeats` of the mean time of `calls` calls of fn, in ms:
    CUDA events on the card, the host clock on the CPU."""
    fn()  # warm-up: the first launch loads the kernel
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best / calls


def stage_report(sim, substeps: int = 20, repeats: int = 3) -> dict:
    """Per-stage substep times on the scene's current state, in ms per
    substep: the unfused pipeline's stages prep (operand build), p2g
    (kernel), merge (halo merge), grid (grid update), windows, g2p
    (gather-only kernel) and finish (plasticity, advection), their sum
    ``total_stages``, and the fused kernels ``p2g_fused`` and
    ``g2p_fused``. Each stage runs `substeps` times on the same inputs
    (the frozen state, sorted into a fresh page map), best of `repeats`.
    The state is not advanced."""
    sim._ensure_finalized()
    cfg = sim.cfg
    colliders = tuple(sim.colliders)
    dt = cfg.base_dt
    t = sim.t
    st, _, pm, _ = packed.pack_carry(sim.particles, cfg, sim._active_block_cap())
    s_arr, e_arr, nbr, ids, keys = pm["s_arr"], pm["e_arr"], pm["nbr"], pm["ids"], pm["slot_keys"]
    pdata = p2g.prep_packed(st, cfg, dt)
    tiles = p2g.p2g_blocked(s_arr, e_arr, pdata)
    rec = blocked.merge_tiles(tiles, nbr)
    vrec = grid_update_flat(rec, ids, cfg, colliders, t, dt)
    win = blocked.windows(vrec, nbr)
    pout = g2p.g2p_blocked(keys, st, win, cfg)
    scratch = st.clone()  # g2p_fused writes the state in place
    stages = {
        "prep": lambda: p2g.prep_packed(st, cfg, dt),
        "p2g": lambda: p2g.p2g_blocked(s_arr, e_arr, pdata),
        "merge": lambda: blocked.merge_tiles(tiles, nbr),
        "grid": lambda: grid_update_flat(rec, ids, cfg, colliders, t, dt),
        "windows": lambda: blocked.windows(vrec, nbr),
        "g2p": lambda: g2p.g2p_blocked(keys, st, win, cfg),
        "finish": lambda: g2p.finish_packed(st, pout, cfg, dt),
    }
    report = {name: _ms_per_call(fn, substeps, repeats, st.device)
              for name, fn in stages.items()}
    report["total_stages"] = sum(report.values())
    report["p2g_fused"] = _ms_per_call(lambda: p2g.p2g_fused(s_arr, e_arr, st, dt, cfg),
                                       substeps, repeats, st.device)
    report["g2p_fused"] = _ms_per_call(lambda: g2p.g2p_fused(keys, scratch, win, dt, cfg),
                                       substeps, repeats, st.device)
    return report


# -- hand-made inputs at the edges of the P2G kernels -------------------------

EDGE_RES = 32  # cells per axis: dx = 1/32 keeps the positions exact
EDGE_HALO = 0.45  # cells a particle strays outside its sort-time block


def p2g_edge_inputs(material: str = "jelly", seed: int = 0) -> dict:
    """Hand-made P2G inputs at the kernels' edges, as numpy arrays: a
    packed state (48, Pw) of one material on a res-32 grid, its slots'
    sorted particle ranges and their neighbour table; for holding a
    kernel against its plain twin (``chip_smoke.py``) and the twin
    against the JAX package (``tests/port/test_torch_p2g_edges.py``).
    Positions are exact in float32, so the block-local position the
    kernels form is the one chosen here. The slots, in order:

    * 1,200 particles in one block, uniform within 0.45 cell around it
      (the block-local positions -0.45 and 4.45 on every axis among
      them), so that supports reach tile nodes 0 and 6 (block-local
      nodes -1 and 5) and one slot spans many staging rounds;
    * 128 particles on exact half-cells, 64 on all three axes and 64 on
      one, where a support weight per such axis is exactly 0;
    * an empty slot (s == e) among live neighbours;
    * four one-particle slots: at opposite corners 0.45 cell outside
      their blocks, on half-cells, and a mix of both;
    * 33 particles (one more than a warp's staging round);
    * a lone block with one particle and no neighbours;
    * four empty slots at the end, so K = 13 is odd.

    Returns dict(st, s_arr, e_arr, nbr, cfg): st float32 (48, n + 5)
    (five inactive lanes past the ranges), s_arr/e_arr int32 (K,), nbr
    int32 (27, K) (the slot of each neighbour block, row (ox*3+oy)*3+oz
    for offset (ox-1, oy-1, oz-1); K where there is none) and the
    SimConfig of the grid and material."""
    rng = np.random.default_rng(seed)
    lo, hi = -EDGE_HALO, blocked.BLOCK + EDGE_HALO

    def uniform(n):
        return rng.uniform(lo, hi, (n, 3)).astype(np.float32)

    corners = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi) for z in (lo, hi)],
                       np.float32)
    big = uniform(1200)
    big[:8] = corners
    halves = np.stack(np.meshgrid(*[np.arange(4) + 0.5] * 3, indexing="ij"), -1).reshape(64, 3)
    one_axis = uniform(64)
    one_axis[np.arange(64), np.arange(64) % 3] = rng.integers(0, 4, 64) + 0.5
    slots = [  # (block, block-local positions)
        ((2, 2, 2), big),
        ((3, 2, 2), np.concatenate([halves, one_axis]).astype(np.float32)),
        ((2, 3, 2), np.zeros((0, 3), np.float32)),
        ((3, 3, 2), np.array([[lo, hi, lo]], np.float32)),
        ((2, 2, 3), np.array([[hi, lo, hi]], np.float32)),
        ((3, 2, 3), np.array([[0.5, 3.5, 2.5]], np.float32)),
        ((3, 3, 3), np.array([[hi, 0.5, lo]], np.float32)),
        ((2, 3, 3), uniform(33)),
        ((6, 6, 6), uniform(1)),
    ]
    n_empty_tail = 4
    K = len(slots) + n_empty_tail

    origin = np.concatenate([np.full((len(p), 3), blocked.BLOCK * np.array(b), np.float32)
                             for b, p in slots])
    # grid positions origin + pos rounded once, so that x * inv_dx - origin
    # (both exact here) is the block-local position the kernels see
    grid = origin + np.concatenate([p for _, p in slots])
    n = grid.shape[0]
    counts = np.array([len(p) for _, p in slots] + [0] * n_empty_tail)
    e_arr = np.cumsum(counts).astype(np.int32)
    s_arr = (e_arr - counts).astype(np.int32)

    index = {b: k for k, (b, _) in enumerate(slots)}
    nbr = np.full((27, K), K, np.int32)
    for (bx, by, bz), k in index.items():
        for row in range(27):
            o = (row // 9 - 1, (row // 3) % 3 - 1, row % 3 - 1)
            nbr[row, k] = index.get((bx + o[0], by + o[1], bz + o[2]), K)

    mid, params, aux0 = models.pack_params(
        material, **(dict(E=2e4, nu=0.35) if material == "jelly" else {}))
    cfg = SimConfig(res=(EDGE_RES,) * 3, base_dt=1e-4, active_materials=(mid,))
    vol = np.float32(cfg.dx ** 3 / 8)
    st = np.zeros((NCH, n + 5), np.float32)
    st[RX:RX + 3, :n] = (grid / np.float32(EDGE_RES)).T
    st[RV:RV + 3, :n] = 0.5 * rng.standard_normal((3, n))
    st[RF:RF + 9, :n] = np.eye(3, dtype=np.float32).reshape(9, 1) \
        + 0.05 * rng.standard_normal((9, n))
    st[RC:RC + 9, :n] = 0.5 * rng.standard_normal((9, n))
    st[RAUX, :n] = aux0 + (0.1 * rng.standard_normal(n) if material == "water" else 0.0)
    st[RMASS, :n] = 1000.0 * vol
    st[RVOL, :n] = vol
    st[RMAT].view(np.int32)[:n] = mid
    st[RPAR:RPAR + 8, :n] = np.asarray(params, np.float32)[:, None]
    st[RACT, :n] = 1.0
    st[RORG:RORG + 3, :n] = origin.T
    st[RMATF, :n] = float(mid)
    return dict(st=st, s_arr=s_arr, e_arr=e_arr, nbr=nbr, cfg=cfg)
