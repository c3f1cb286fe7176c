"""Diagnostics (torch counterpart of ``taichi_mpm_tpu.diagnostics``):
``FrameProfiler``, the wall clock and particle-steps per second of
frames; ``trace``, a ``torch.profiler`` trace of the device's work;
``device_memory_report``, the card's memory in use and its peak;
``simulate_with_energy``, a frame loop that reads the mechanical energy
after each frame; ``stage_report``, the per-stage profile of a substep;
``p2g_edge_inputs`` and ``g2p_edge_inputs``, hand-made inputs at the P2G
and G2P kernels' edges; ``g2p_staged_share``, the share of lanes whose
window the fused G2P kernel stages in shared memory;
``sand_knife_edges`` and ``sand_edges_per_substep``, the sand lanes whose
plastic event is within rounding of its edges."""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.materials import cforms, models
from taichi_mpm_torch.ops import blocked, g2p, p2g, packed
from taichi_mpm_torch.ops.rows import (
    NCH, RACT, RAUX, RC, RF, RMASS, RMAT, RMATF, RORG, RPAR, RV, RVOL, RX,
)
from taichi_mpm_torch.ops.substep import grid_update_flat

STAGES = ("prep", "p2g", "merge", "grid", "windows", "g2p", "finish")


# -- frames, traces, memory and energy -----------------------------------------


@dataclass
class FrameProfiler:
    """Wall clock per frame and particle-steps per second (the
    reference's work metric over time), with a rolling report."""

    substeps_per_frame: int = 1
    frames: List[dict] = field(default_factory=list)

    @contextlib.contextmanager
    def frame(self, n_particles: int):
        """Time the block as one frame of `n_particles` particles; a
        frame on the card should end in ``sim.sync()`` inside the block."""
        t0 = time.perf_counter()
        yield
        wall = time.perf_counter() - t0
        self.frames.append(dict(wall=wall, particles=n_particles,
                                psteps=n_particles * self.substeps_per_frame))

    @property
    def update_counter(self) -> int:
        """Total particle updates (the reference's work metric)."""
        return int(sum(f["psteps"] for f in self.frames))

    def particle_steps_per_sec(self, skip_first: int = 1) -> float:
        fs = self.frames[skip_first:] or self.frames
        wall = sum(f["wall"] for f in fs)
        return sum(f["psteps"] for f in fs) / max(wall, 1e-12)

    def report(self) -> str:
        if not self.frames:
            return "no frames recorded"
        walls = np.asarray([f["wall"] for f in self.frames])
        return "\n".join([
            f"frames: {len(self.frames)}  "
            f"wall/frame: median {np.median(walls)*1e3:.1f} ms "
            f"(min {walls.min()*1e3:.1f}, max {walls.max()*1e3:.1f})",
            f"particle updates: {self.update_counter:,}",
            f"throughput: {self.particle_steps_per_sec()/1e6:.2f} M particle-steps/s",
        ])


@contextlib.contextmanager
def trace(log_dir: str = "taichi_mpm_torch_trace"):
    """A ``torch.profiler`` trace of the block (the CPU's and, where
    there is a card, its kernels), written to `log_dir` as a Chrome trace
    (``trace.json``); the profiler is yielded, so ``key_averages()`` can
    be read after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[taichi_mpm_torch] trace written to {path}")


def device_memory_report(device=None) -> Optional[dict]:
    """The card's memory (``torch.cuda.memory_stats``): bytes in use, the
    peak since the last reset and the card's total; None without one."""
    if not torch.cuda.is_available():
        return None
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }


def simulate_with_energy(sim, num_frames: int, frame_update=None):
    """`num_frames` frames, each after frame_update(sim, f) where given;
    returns the mechanical energy after each (``MPM.energy``)."""
    energies = []
    for f in range(num_frames):
        if frame_update is not None:
            frame_update(sim, f)
        sim.step()
        energies.append(sim.energy())
    return np.asarray(energies)


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


# -- sand's knife edges --------------------------------------------------------

SAND_EDGE_TOL = 1e-6  # |tr|, |delta_gamma| this close to 0 are within rounding


def sand_knife_edges(keys, st, win, dt, cfg: SimConfig, tol: float = SAND_EDGE_TOL) -> int:
    """The active sand lanes of a fused G2P step on `st` (keys, windows
    `win`) whose return map decides within `tol` of an edge: |tr| or
    |delta_gamma| at most `tol` (``cforms.sand_edges``), evaluated by the
    twin's formulas on the cdg of its gather. tr and delta_gamma are sums
    of logarithms of singular values near 1, exact to ~1e-7, so two
    roundings of one state (a kernel and its twin, the card and the CPU)
    may put such a lane on either side, and count its plastic event or
    not; ``tol`` is 10 times that. (On the 1,200-particle sand frame of
    ``tests/port/test_torch_materials_frame.py`` the port and JAX count 4
    events apart, with 22 lanes within 1e-6 of an edge over its 6
    substeps and 4 within 3e-7.)"""
    if cforms.SAND not in cfg.active_materials:
        return 0
    acc = g2p._gather_plain(keys, st, win, cfg)
    k = g2p._k_cdg(cfg, dt)
    cdg = tuple(e - k * b for e, b in zip(g2p._EYE, acc[3:]))
    tr, dg = cforms.sand_edges(tuple(st[RF + i] for i in range(9)), cdg, st[RAUX],
                               tuple(st[RPAR + i] for i in range(8)))
    sand = st[RACT] > 0.5
    if len(cfg.active_materials) > 1:
        sand &= st[RMAT].view(torch.int32) == cforms.SAND
    near = (tr.abs() <= tol) | (dg.abs() <= tol)
    return int((sand & near).sum())


@contextlib.contextmanager
def sand_edges_per_substep():
    """Within the block, each fused G2P step first appends its
    ``sand_knife_edges`` count to the yielded list: over a frame, the
    number of sand events that another rounding of the same frame may
    count otherwise. It wraps ``ops.g2p.g2p_fused`` for the block's
    duration, and adds the twin's gather and SVD to every step."""
    counts = []
    fused = g2p.g2p_fused

    def counted(keys, st, win, dt, cfg):
        counts.append(sand_knife_edges(keys, st, win, dt, cfg))
        return fused(keys, st, win, dt, cfg)

    g2p.g2p_fused = counted
    try:
        yield counts
    finally:
        g2p.g2p_fused = fused


# -- hand-made inputs at the edges of the P2G kernels -------------------------

EDGE_RES = 32  # cells per axis: dx = 1/32 keeps the positions exact
EDGE_HALO = 0.45  # cells a particle strays outside its sort-time block


def p2g_edge_inputs(material: str = "jelly", seed: int = 0) -> dict:
    """Hand-made P2G inputs at the kernels' edges, as numpy arrays: a
    packed state (48, Pw) of `material` (see ``edge_material_names``) on a
    res-32 grid, its slots' sorted particle ranges and their neighbour
    table; for holding a kernel against its plain twin (``chip_smoke.py``)
    and the twin against the JAX package
    (``tests/port/test_torch_p2g_edges.py``, ``test_torch_material_edges.py``).
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

    nbr = _neighbours([b for b, _ in slots], K)

    st, cfg = _edge_state(material, grid, origin, n + 5, rng)
    return dict(st=st, s_arr=s_arr, e_arr=e_arr, nbr=nbr, cfg=cfg)


def _neighbours(blocks, K: int) -> np.ndarray:
    """(27, K) int32: the slot of each neighbour block of the slots whose
    blocks are `blocks` (row (ox*3+oy)*3+oz for offset (ox-1, oy-1,
    oz-1)); K where there is none."""
    index = {b: k for k, b in enumerate(blocks)}
    nbr = np.full((27, K), K, np.int32)
    for (bx, by, bz), k in index.items():
        for row in range(27):
            o = (row // 9 - 1, (row // 3) % 3 - 1, row % 3 - 1)
            nbr[row, k] = index.get((bx + o[0], by + o[1], bz + o[2]), K)
    return nbr


EDGE_MATERIALS = tuple(models.MATERIAL_NAMES)  # the eight, in id order


def edge_material_names(material: str) -> tuple:
    """The materials of edge inputs `material`: one of the eight, "mixed"
    (jelly and water) or "all" (the eight on successive lanes)."""
    if material == "mixed":
        return ("jelly", "water")
    if material == "all":
        return EDGE_MATERIALS
    return (material,)


def _edge_state(material: str, grid, origin, pw: int, rng):
    """A packed state (48, pw) whose first len(grid) lanes are active
    particles at grid positions `grid` (cells, exact in float32) with
    sort-time origins `origin`, of `material` (see edge_material_names;
    several materials take lanes in turn), with random v, F near I, C and
    aux spread where the material keeps state in it: water's J around 1;
    and for the other materials, whose draws come after these, snow's Jp
    around 1, sand's log Jp around 0 (so that the return map meets both
    tr >= 0 and tr < 0) and visco's yield stress tau over [0, 2e4] (so
    that |P| lies on both sides of it); and the SimConfig of the res-32
    grid and materials."""
    n = grid.shape[0]
    names = edge_material_names(material)
    packed = [models.pack_params(m, **(dict(E=2e4, nu=0.35) if m == "jelly" else {}))
              for m in names]
    which = np.arange(n) % len(names)
    mid = np.array([packed[i][0] for i in which], np.int32)
    cfg = SimConfig(res=(EDGE_RES,) * 3, base_dt=1e-4,
                    active_materials=tuple(sorted(p[0] for p in packed)))
    vol = np.float32(cfg.dx ** 3 / 8)
    st = np.zeros((NCH, pw), np.float32)
    st[RX:RX + 3, :n] = (grid / np.float32(EDGE_RES)).T
    st[RV:RV + 3, :n] = 0.5 * rng.standard_normal((3, n))
    st[RF:RF + 9, :n] = np.eye(3, dtype=np.float32).reshape(9, 1) \
        + 0.05 * rng.standard_normal((9, n))
    st[RC:RC + 9, :n] = 0.5 * rng.standard_normal((9, n))
    water = mid == models.MATERIAL_NAMES["water"]
    st[RAUX, :n] = np.array([packed[i][2] for i in which], np.float32) \
        + np.where(water, 0.1 * rng.standard_normal(n), 0.0)
    if set(names) - {"jelly", "water"}:
        spread = {"snow": 0.1 * rng.standard_normal(n), "sand": 0.05 * rng.standard_normal(n),
                  "visco": rng.uniform(0.0, 2e4, n) - 1000.0}
        for name, noise in spread.items():
            lanes = mid == models.MATERIAL_NAMES[name]
            st[RAUX, :n][lanes] += noise[lanes].astype(np.float32)
    st[RMASS, :n] = 1000.0 * vol
    st[RVOL, :n] = vol
    st[RMAT].view(np.int32)[:n] = mid
    st[RPAR:RPAR + 8, :n] = np.array([packed[i][1] for i in which], np.float32).T
    st[RACT, :n] = 1.0
    st[RORG:RORG + 3, :n] = origin.T
    st[RMATF, :n] = mid.astype(np.float32)
    return st, cfg


# -- hand-made inputs at the edges of the fused G2P kernel --------------------

G2P_EDGE_LANES = 2048  # Pw: a multiple of the JAX kernel's 512-lane chunk


def g2p_edge_inputs(material: str = "jelly", seed: int = 0) -> dict:
    """Hand-made inputs at the fused G2P kernel's edges, as numpy arrays:
    a sorted packed state (48, Pw) on a res-32 grid, its lanes' slot keys,
    velocity records and the slots' neighbour table; for holding the
    kernel against its plain twin (``chip_smoke.py``) and the twin against
    the JAX package (``tests/port/test_torch_g2p_edges.py``,
    ``test_torch_material_edges.py``). `material` is one of the eight,
    "mixed" (jelly and water on alternate lanes) or "all" (the eight in
    turn); the state of each material reaches its return map's branches
    (``_edge_state``).
    Positions are exact in float32, as in ``p2g_edge_inputs``. The lanes,
    in order:

    * a slot of 600 lanes, more than a CUDA block of the kernel holds,
      uniform within 0.45 cell around its block (block-local -0.45 and
      4.45 on every axis among them: supports reaching window nodes 0 and
      6), four of them inactive among the active ones, one with a NaN in
      F (the finish must deactivate and reset it; on "all" one of each
      material);
    * 128 lanes on exact half-cells (64 on all three axes, 64 on one),
      where a support weight per such axis is exactly 0;
    * 48 slots of 1 to 9 lanes in a row, so that the CUDA blocks over
      them span more slots than the kernel stages; an inactive lane in
      some of them;
    * four one-lane slots, at opposite corners 0.45 cell outside their
      blocks and on half-cells;
    * 16 lanes whose first support node is clamped or lies outside the
      window (block-local positions -1.3, -0.8, 7.6 and 8.9 on one axis:
      base -2 and 7);
    * 6 active lanes with key K (no slot: they gather v = B = 0);
    * inactive lanes with key K up to Pw.

    Returns dict(st, keys, vrec, nbr, cfg): st float32 (48, Pw), keys
    int32 (Pw,) in ascending order, vrec float32 (K, 192) random velocity
    records, nbr int32 (27, K) (as in ``p2g_edge_inputs``) and the
    SimConfig; windows come from ``ops.blocked.windows(vrec, nbr)``."""
    rng = np.random.default_rng(seed)
    lo, hi = -EDGE_HALO, blocked.BLOCK + EDGE_HALO

    def uniform(n):
        return rng.uniform(lo, hi, (n, 3)).astype(np.float32)

    big = uniform(600)
    big[:8] = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi) for z in (lo, hi)])
    halves = np.stack(np.meshgrid(*[np.arange(4) + 0.5] * 3, indexing="ij"), -1).reshape(64, 3)
    one_axis = uniform(64)
    one_axis[np.arange(64), np.arange(64) % 3] = rng.integers(0, 4, 64) + 0.5
    clamp = uniform(16)
    clamp[np.arange(16), np.arange(16) % 3] = np.tile([-1.3, -0.8, 7.6, 8.9], 4)
    slots = [  # (block, block-local positions)
        ((1, 1, 1), big),
        ((2, 1, 1), np.concatenate([halves, one_axis])),
    ]
    small = [(bx, by, bz) for bx in range(3, 7) for by in range(3, 7) for bz in range(4, 7)]
    slots += [(b, uniform(int(c))) for b, c in zip(small, rng.integers(1, 10, len(small)))]
    slots += [((1, 2, 1), np.array([[lo, hi, lo]])), ((2, 2, 1), np.array([[hi, lo, hi]])),
              ((1, 1, 2), np.array([[0.5, 3.5, 2.5]])), ((2, 1, 2), np.array([[hi, 0.5, lo]])),
              ((0, 0, 0), clamp)]
    K = len(slots)
    n_keyless = 6
    origin = np.concatenate([np.full((len(p), 3), blocked.BLOCK * np.array(b), np.float32)
                             for b, p in slots] + [np.full((n_keyless, 3), 8.0, np.float32)])
    local = np.concatenate([p for _, p in slots] + [uniform(n_keyless)]).astype(np.float32)
    grid = origin + local
    n = grid.shape[0]
    keys = np.full(G2P_EDGE_LANES, K, np.int32)
    keys[:n - n_keyless] = np.repeat(np.arange(K), [len(p) for _, p in slots])

    st, cfg = _edge_state(material, grid, origin, G2P_EDGE_LANES, rng)
    st[RACT, [5, 300, 301, 599]] = 0.0  # inactive among the active lanes
    # a NaN in F: on lane 17, and on "all" on one lane of each material
    st[RF + 4, np.arange(16, 24) if material == "all" else 17] = np.nan
    runs = np.flatnonzero(np.diff(keys[:n]) != 0) + 1  # first lane of each slot but 0
    st[RACT, runs[2:2 + len(small):7] + 1] = 0.0  # inside some small slots
    vrec = (0.3 * rng.standard_normal((K, blocked.VREC_LANES))).astype(np.float32)
    return dict(st=st, keys=keys, vrec=vrec, nbr=_neighbours([b for b, _ in slots], K),
                cfg=cfg)


def g2p_staged_share(keys, st, lanes_per_block: int, staged: int, K: int) -> float:
    """The share of the active lanes with a slot that the fused G2P kernel
    gathers from shared memory: by its rule, a block of `lanes_per_block`
    lanes stages the windows of slots [lo, lo + n), lo the smallest key
    among its active lanes with a slot, n = min(largest - lo + 1,
    `staged`); any other such lane gathers from device memory. 1.0 where
    no lane has a slot."""
    pw = keys.shape[0]
    keyed = (st[RACT] > 0.5) & (keys >= 0) & (keys < K)
    n_blocks = -(-pw // lanes_per_block)
    pad = n_blocks * lanes_per_block - pw
    k = keys.long()
    kmin = torch.nn.functional.pad(torch.where(keyed, k, K), (0, pad), value=K)
    kmax = torch.nn.functional.pad(torch.where(keyed, k, -1), (0, pad), value=-1)
    lo = kmin.view(n_blocks, lanes_per_block).amin(1)
    n = torch.clamp(kmax.view(n_blocks, lanes_per_block).amax(1) - lo + 1, 0, staged)
    blk = torch.arange(pw, device=keys.device) // lanes_per_block
    on_chip = keyed & (k >= lo[blk]) & (k - lo[blk] < n[blk])
    n_keyed = int(keyed.sum())
    return float(on_chip.sum()) / n_keyed if n_keyed else 1.0
