"""Diagnostics (torch counterpart of ``taichi_mpm_tpu.diagnostics``):
``stage_report``, the per-stage profile of a substep. The other
diagnostics of the JAX module (energy series, memory stats) are not
ported yet (ROADMAP.md queue 1 item 8)."""

from __future__ import annotations

import time

import torch

from taichi_mpm_torch.ops import blocked, g2p, p2g, packed
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
