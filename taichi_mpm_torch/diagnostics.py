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
plastic event is within rounding of its edges (``packed_sand_edges_per_substep``
at every packed finish on the CPU; on the dense path
``dense_sand_knife_edges`` and ``dense_sand_edges_per_substep``)."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core import transfer
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


# -- the coupled dense CPIC substep, stage by stage, card against CPU -------------

# the stages of ``rigid.cpic.cpic_substep`` in the order they run, each
# (stage, field); ``stage_values`` gives each its value and the largest
# addend that fed it (None: an integer stage, compared for equality)
STAGE_ORDER = (
    ("cdf", "grid_rid"), ("cdf", "grid_states"), ("cdf", "grid_dist"), ("cdf", "states"),
    ("cdf", "near_b"), ("cdf", "bdist"), ("cdf", "bnormal"),
    ("p2g", "force"), ("p2g", "addends"), ("p2g", "grid"), ("p2g", "offset_J"), ("p2g", "offset_tau"), ("p2g", "J"), ("p2g", "tau"),
    ("p2g", "body_vel"), ("p2g", "body_omega"),
    ("grid_update", "v"),
    ("g2p", "x"), ("g2p", "v"), ("g2p", "C"), ("g2p", "F"), ("g2p", "J"), ("g2p", "tau"),
    ("end", "x"), ("end", "v"), ("end", "F"), ("end", "C"),
    ("end", "body_pos"), ("end", "body_vel"), ("end", "body_omega"), ("end", "body_rot"),
)


def _amax(x) -> float:
    x = x[torch.isfinite(x)] if x.is_floating_point() else x
    return float(x.abs().max()) if x.numel() else 0.0


def stage_values(stages: dict) -> dict:
    """(stage, field) -> (value, largest addend or None) of one substep's
    ``cpic_substep(stages=...)``: particle fields over the lanes active at
    the substep's start, the grids whole."""
    pin = stages["cdf_particles"]
    act = pin.active
    grid_dist, grid_rid, grid_states = stages["cdf_planes"]
    rows = {k: stages[k + "_rows"] for k in ("p2g", "g2p")}
    addend = {k: (_amax(rows[k][1]), _amax(rows[k][2])) for k in rows}
    Jk, tk = stages["p2g_offset_totals"]
    J1, tau1 = stages["p2g_totals"]
    J2, tau2 = stages["g2p_totals"]
    pg, pe = stages["g2p_particles"], stages["particles"]
    b1, be = stages["p2g_bodies"], stages["bodies"]

    def own(v):
        return v, _amax(v)

    out = {("cdf", "grid_rid"): (grid_rid, None), ("cdf", "grid_states"): (grid_states, None),
           ("cdf", "grid_dist"): own(grid_dist), ("cdf", "states"): (pin.states[act], None),
           ("cdf", "near_b"): (pin.near_b[act], None), ("cdf", "bdist"): own(pin.bdist[act]),
           ("cdf", "bnormal"): own(pin.bnormal[act]),
           ("p2g", "force"): own(stages["p2g_force"][act]),
           ("p2g", "addends"): own(stages["p2g_scatter_addends"][:, act]),
           ("p2g", "grid"): (stages["p2g_grid"], _amax(stages["p2g_scatter_addends"])),
           ("p2g", "offset_J"): (Jk, addend["p2g"][0]), ("p2g", "offset_tau"): (tk, addend["p2g"][1]),
           ("p2g", "J"): (J1, addend["p2g"][0]), ("p2g", "tau"): (tau1, addend["p2g"][1]),
           ("p2g", "body_vel"): own(b1.vel), ("p2g", "body_omega"): own(b1.omega),
           ("grid_update", "v"): own(stages["grid_v"]),
           ("g2p", "x"): own(pg.x[act]), ("g2p", "v"): (pg.v[act],
                                                       _amax(stages["g2p_gather_addends"])),
           ("g2p", "C"): own(pg.C[act]), ("g2p", "F"): own(pg.F[act]),
           ("g2p", "J"): (J2, addend["g2p"][0]), ("g2p", "tau"): (tau2, addend["g2p"][1])}
    for name in ("x", "v", "F", "C"):
        out["end", name] = own(getattr(pe, name)[act])
    for name in ("pos", "vel", "omega", "rot"):
        out["end", "body_" + name] = own(getattr(be, name))
    return out


def parting(a, b, scale) -> dict:
    """How far value `a` parts from `b`: for an integer stage (scale
    None) whether they are equal; else the max abs difference over the
    entries finite in both (inf where the finite entries differ), and that
    difference in ulps of `scale` (float32 spacing at the largest addend)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if scale is None:
        return dict(equal=bool(torch.equal(a, b)))
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        return dict(diff=float("inf"), scale=scale, ulps=float("inf"))
    diff = float((a[fa].double() - b[fb].double()).abs().max()) if fa.any() else 0.0
    ulp = float(np.spacing(np.float32(scale))) if scale > 0 else float(np.spacing(np.float32(0)))
    return dict(diff=diff, scale=scale, ulps=diff / ulp)


def masked_body_sums(rid, J, tau, R: int):
    """The body totals as per-body masked sums (torch's reductions: a tree
    on the card), the summation the dense CPIC path used on the card
    before ``ops.body_sums``; for comparison only."""
    return tuple(torch.stack([torch.where((rid == r)[..., None], v, 0.0).sum(-2)
                              for r in range(R)], -2) for v in (J, tau))


def _to(obj, device):
    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).to(device)
                                       for f in dataclasses.fields(obj)})


def substep_partings(cpu_stages: dict, card_stages: dict, R: int, device) -> dict:
    """One substep's partings, "stage.field" -> ``parting``: each stage of
    the card's substep against the CPU's (both from the CPU's state at the
    substep's start), then the sum order alone (``sum_order.*``): the body
    totals of the CPU's own addends summed on the card by
    ``ops.body_sums.body_totals`` and by ``masked_body_sums``, against the
    CPU's totals."""
    from taichi_mpm_torch.ops import body_sums

    cpu, card = stage_values(cpu_stages), stage_values(card_stages)
    out = {f"{st}.{f}": parting(card[st, f][0], cpu[st, f][0], cpu[st, f][1])
           for st, f in STAGE_ORDER}
    for key, totals in (("p2g", "p2g_offset_totals"), ("g2p", "g2p_totals")):
        rows = [r.to(device) for r in cpu_stages[key + "_rows"]]
        want = cpu_stages[totals]
        scales = (_amax(rows[1]), _amax(rows[2]))
        for how, got in (("kernel", body_sums.body_totals(*rows, R)),
                         ("masked_sum", masked_body_sums(*rows, R))):
            for name, g, w, sc in zip(("J", "tau"), got, want, scales):
                out[f"sum_order.{key}_{how}_{name}"] = parting(g, w, sc)
    return out


@contextlib.contextmanager
def _each_cpic_substep(hook):
    """Every ``rigid.cpic.cpic_substep`` call of the block goes through
    hook(substep, *args), which runs it."""
    from taichi_mpm_torch.rigid import cpic

    real = cpic.cpic_substep
    cpic.cpic_substep = lambda *args, **kw: hook(real, *args, **kw)
    try:
        yield
    finally:
        cpic.cpic_substep = real


def coupled_stage_partings(make, snapshot: str, frame: int = 0, source=None, device="cuda"):
    """Where the card and the CPU part in a dense CPIC frame, substep by
    substep: `make(device)` builds the scene (``MPM`` or ``AsyncMPM``),
    both copies load `snapshot` (and take ``source(sim, frame)`` where
    given), and the CPU steps one frame; before each of its substeps the
    CPU's state (particles, bodies, t) is copied to the card, which runs
    the same substep (the CPU's dt) on it, so each substep's partings are
    its own. Returns (a list with each substep's ``substep_partings``, the
    CPU scene after the frame)."""
    cpu, card = make("cpu"), make(device)
    for sim in (cpu, card):
        sim.load(snapshot)
        if source is not None:
            source(sim, frame)
    card._prepare_frame()  # the card's rigid scene and node positions
    R = card.bodies.num
    out = []

    def hook(real, p, bodies, t, cfg, scene, dt, xg=None):
        cpu_stages, card_stages = {}, {}
        result = real(p, bodies, t, cfg, scene, dt, xg, stages=cpu_stages)
        real(_to(p, card.device), _to(bodies, card.device), t, card.cfg, card.rigid_scene, dt,
             card._xg, stages=card_stages)
        out.append(substep_partings(cpu_stages, card_stages, R, card.device))
        return result

    with _each_cpic_substep(hook):
        cpu.step()
    return out, cpu


def substep_stages(sim, dt=None) -> dict:
    """The stages (``cpic_substep(stages=...)``) of one dense CPIC substep
    of dt (default base_dt) from the scene's state, on its live lanes; the
    scene is not advanced."""
    from taichi_mpm_torch.core.state import FIELDS, Particles
    from taichi_mpm_torch.rigid import cpic

    sim._prepare_frame()
    n = sim._live_lanes()
    p = Particles(**{f: getattr(sim._particles, f)[:n] for f in FIELDS})
    stages = {}
    cpic.cpic_substep(p, sim.bodies, sim.t, sim.cfg, sim.rigid_scene,
                      np.float32(dt or sim.cfg.base_dt), sim._xg, stages=stages)
    return stages


def body_totals_edge_inputs(seed: int = 0) -> dict:
    """Inputs of ``ops.body_sums.body_totals`` at its edges, label ->
    (rid (L, N) int64, J (L, N, ca), tau (L, N, cb) float32, R), in numpy:
    several offsets and bodies, lanes of no body (rid -1), a body with no
    lane, a row where one body holds most lanes, one lane, a row of one
    body alone, no valid lane at all; N about the kernels' units (a mask
    word of 32 lanes, a tile of 2,048, a batch's 8,192 hits, a chunk of
    256 tiles that one pass over the tile counts covers): 31, 32, 33,
    1,025, 2,048, 2,049, 8,193 and 524,289; hits on the first and the last
    lane only; one body on every lane of a 100,000-lane row (the longest
    chain of adds); 8 bodies; the 2-D shape (9 offsets, 2 + 1 components)
    and G2P's (one row of 100,000 lanes, a few valid). Values over six
    decades of both signs, so that the order of a sum shows in its bits,
    and NaN in J on half the lanes of no body, which the sums must not
    read."""
    rng = np.random.default_rng(seed)

    def values(shape):
        return (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)

    def case(L, N, R, ca, cb, invalid=0.4, empty=(), crowd=None, only=None):
        rid = rng.integers(0, R, (L, N))
        for r in empty:
            rid[rid == r] = (r + 1) % R
        if crowd is not None:  # (row, body): that body holds 95% of the row's lanes
            row, r = crowd
            rid[row] = np.where(rng.uniform(size=N) < 0.95, r, rid[row])
        rid[rng.uniform(size=(L, N)) < invalid] = -1
        if only is not None:  # only these lanes of each row hold a body
            keep = rid[:, only].copy()
            rid[:] = -1
            rid[:, only] = keep
        J, tau = values((L, N, ca)), values((L, N, cb))
        J[(rid < 0) & (rng.uniform(size=(L, N)) < 0.5)] = np.nan  # never read
        return rid, J, tau, R

    cases = {
        "offsets_2d": case(9, 1000, 3, 2, 1, empty=(1,)),
        "offsets_3d": case(27, 777, 4, 3, 3, empty=(3,), crowd=(5, 0)),
        "one_row": case(1, 5000, 2, 3, 3, invalid=0.9),
        "one_lane": case(2, 1, 1, 2, 1, invalid=0.0),
        "one_body": case(3, 600, 1, 3, 3, invalid=0.2),
        "none_valid": case(3, 300, 2, 3, 3, invalid=1.0),
    }
    for n in (31, 32, 33, 1025, 2048, 2049):
        cases[f"lanes_{n}"] = case(2, n, 3, 3, 3, invalid=0.3)
    cases.update(
        lanes_8193=case(1, 8193, 1, 3, 3, invalid=0.0),
        lanes_524289=case(1, 256 * 2048 + 1, 2, 3, 3, invalid=0.0,
                          only=np.r_[0:256 * 2048:997, 256 * 2048]),
        first_and_last=case(3, 4097, 2, 3, 3, invalid=0.0, only=[0, -1]),
        longest_chain=case(1, 100_000, 1, 3, 3, invalid=0.0),
        bodies_8=case(4, 3000, 8, 3, 3, empty=(5,)),
        offsets_2d_wheel=case(9, 2361, 2, 2, 1, invalid=0.9),
        g2p_row=case(1, 100_000, 3, 3, 3, invalid=0.998),
    )
    return cases


def first_parting(partings: list, ulps: float = 4.0):
    """The first (substep, "stage.field") in the stages' order whose parting
    exceeds `ulps` (or whose integers differ), or None."""
    for n, sub in enumerate(partings):
        for st, f in STAGE_ORDER:
            r = sub[f"{st}.{f}"]
            if not r.get("equal", True) or r.get("ulps", 0.0) > ulps:
                return n, f"{st}.{f}"
    return None


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
    return _row_sand_edges(st, g2p._gather_plain(keys, st, win, cfg), dt, cfg, tol)


def _row_sand_edges(st, acc, dt, cfg: SimConfig, tol: float = SAND_EDGE_TOL) -> int:
    """``sand_knife_edges`` of the gathered rows `acc` (v, B) of `st`."""
    if cforms.SAND not in cfg.active_materials:
        return 0
    k = g2p._k_cdg(cfg, dt)
    cdg = tuple(e - k * b for e, b in zip(g2p._EYE, acc[3:]))
    tr, dg = cforms.sand_edges(tuple(st[RF + i] for i in range(9)), cdg, st[RAUX],
                               tuple(st[RPAR + i] for i in range(8)))
    sand = st[RACT] > 0.5
    if len(cfg.active_materials) > 1:
        sand &= st[RMAT].view(torch.int32) == cforms.SAND
    near = (tr.abs() <= tol) | (dg.abs() <= tol)
    return int((sand & near).sum())


WATER_EDGE_TOL = 1e-6


def water_knife_edges(p, cfg: SimConfig, tol: float = WATER_EDGE_TOL) -> int:
    """The active water particles whose J (aux) lies within `tol` of 1:
    water's return map counts a plastic event where J > 1, and J is
    aux * (trace(cdg) - 2) of a gathered B exact to ~1e-7, so two
    roundings of one substep (a kernel and its twin, the card and the
    CPU) may count such a particle or not; ``tol`` is 10 times that."""
    if cforms.WATER not in cfg.active_materials:
        return 0
    water = p.active & (p.mat == cforms.WATER)
    return int((water & ((p.aux - 1.0).abs() <= tol)).sum())


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


def dense_sand_knife_edges(p, grid_v, cfg: SimConfig, dt, tol: float = SAND_EDGE_TOL) -> int:
    """The active sand particles of a dense G2P step (``core.transfer.g2p``
    on node velocities `grid_v`) whose return map decides within `tol` of
    an edge (``models.sand_edges``), as ``sand_knife_edges`` counts them
    on the blocked path."""
    _, b = transfer.gather(p, grid_v, cfg)
    return _sand_edges_of(p, b, cfg, dt, tol)


def _sand_edges_of(p, b, cfg: SimConfig, dt, tol: float = SAND_EDGE_TOL) -> int:
    if models.SAND not in cfg.active_materials:
        return 0
    tr, dg = models.sand_edges(p.F, transfer.cdg_of(b, cfg, dt), p.aux, p.params)
    near = (tr.abs() <= tol) | (dg.abs() <= tol)
    return int((p.active & (p.mat == models.SAND) & near).sum())


@contextlib.contextmanager
def dense_sand_edges_per_substep():
    """``sand_edges_per_substep`` on the dense path: within the block,
    each dense G2P step (plain or CPIC) first appends its count of
    ``dense_sand_knife_edges`` to the yielded list (it wraps
    ``core.transfer.g2p_finish``, where both end, and counts from the
    gathered B it is given)."""
    counts = []
    finish = transfer.g2p_finish

    def counted(p, v_new, b_new, cfg, dt, *args, **kw):
        counts.append(_sand_edges_of(p, b_new, cfg, dt))
        return finish(p, v_new, b_new, cfg, dt, *args, **kw)

    transfer.g2p_finish = counted
    try:
        yield counts
    finally:
        transfer.g2p_finish = finish


@contextlib.contextmanager
def packed_sand_edges_per_substep():
    """``sand_edges_per_substep`` for every packed G2P step on the CPU:
    within the block, each call of ``ops.g2p.finish_packed`` (the finish
    of the unfused route and of the packed CPIC frame, and of the fused
    kernel's twin) first appends its ``sand_knife_edges`` count, from the
    gathered rows it is given, to the yielded list."""
    counts = []
    finish = g2p.finish_packed

    def counted(st, acc, cfg, dt, *args, **kw):
        counts.append(_row_sand_edges(st, acc, dt, cfg))
        return finish(st, acc, cfg, dt, *args, **kw)

    g2p.finish_packed = counted
    try:
        yield counts
    finally:
        g2p.finish_packed = finish


# -- hand-made inputs at the edges of the P2G kernels -------------------------

EDGE_RES = 32  # cells per axis: dx = 1/32 keeps the positions exact
EDGE_HALO = 0.45  # cells a particle strays outside its sort-time block


# F at the SVD's edges (math/cmat3.c_svd, csrc/cmat3.cuh): (name, F, F
# singular), each exact in float32. A zero column gives s2 = 0 exactly;
# two zero columns reach the Gram-Schmidt fallback of u1 (|b1| <= 1e-12)
# and F = 0 that of u0 too; det < 0 the flip of V's last column and
# sign(s2) = sign(det); equal singular values the sort network's ties
# (strict <); an off-diagonal below 1e-20 the trivial rotation; I all
# three. Their null spaces lie on the axes, so the SVD's rotations leave
# them exact: a rank-1 F whose null space does not (say u w^T) turns the
# Hencky force into rounding noise times 1e6 (1 / s clamped at 1e-6;
# float32 and float64 part by 8% of |force|), which no bound can hold.
SVD_EDGE_F = (
    ("zero_column", ((1.125, 0.0, 0.25), (0.125, 0.0, 0.875), (0.0625, 0.0, 1.0)), True),
    ("two_zero_columns", ((0.0, 0.75, 0.0), (0.0, -0.5, 0.0), (0.0, 1.25, 0.0)), True),
    ("zero", ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)), True),
    ("inverted", ((0.875, 0.125, 0.0), (0.0625, 1.125, 0.03125), (0.0, 0.03125, -1.0)), False),
    ("equal_pair", ((1.25, 0.0, 0.0), (0.0, 1.25, 0.0), (0.0, 0.0, 0.75)), False),
    ("equal_pair_permuted", ((0.0, 0.75, 0.0), (1.25, 0.0, 0.0), (0.0, 0.0, 1.25)), False),
    ("tiny_off_diagonal", ((1.0, 1e-21, 0.0), (0.0, 0.875, 0.0), (0.0, 0.0, 1.125)), False),
    ("identity", ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)), False),
)
# the materials whose kernels run an SVD on F: the Hencky force (P2G) and
# the return maps (G2P; visco's |P| inverts F, so it takes no singular F)
SVD_FORCE_MATERIALS = ("elastic", "sand", "von_mises")
SVD_PLAST_MATERIALS = ("snow", "sand", "von_mises", "visco")
# slots the Hencky P2G kernel stages in whole rounds: its producer warps'
# rounds (3 x 32 particles) and its ring (4 x 32), each and one more
SVD_EDGE_SLOTS = (96, 97, 128, 129)


def _set_svd_edge_f(st, lanes, materials) -> int:
    """F of SVD_EDGE_F on the lanes `lanes` of `st` whose material is one
    of `materials` (names), each material's lanes taking them in turn; a
    singular F only on lanes of a material other than visco. Returns the
    lanes set."""
    visco = models.MATERIAL_NAMES["visco"]
    turn = {}
    mats = st[RMAT].view(np.int32)
    for lane in lanes:
        m = int(mats[lane])
        if models.MATERIAL_IDS[m] not in materials:
            continue
        choices = [F for _, F, singular in SVD_EDGE_F if not (singular and m == visco)]
        k = turn.get(m, 0)
        st[RF:RF + 9, lane] = np.asarray(choices[k % len(choices)], np.float32).reshape(9)
        turn[m] = k + 1
    return sum(turn.values())


def p2g_edge_inputs(material: str = "jelly", seed: int = 0, svd: bool = False) -> dict:
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
    * with `svd`, slots of SVD_EDGE_SLOTS particles (the Hencky kernel's
      staging batches and one more), and F of SVD_EDGE_F on lanes of the
      1,200-particle slot whose material runs the Hencky force;
    * four empty slots at the end, so K = 13 is odd (17 with `svd`).

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
    if svd:  # blocks with no neighbour slot, as the lone block's
        blocks = ((1, 6, 1), (6, 1, 1), (1, 1, 6), (5, 1, 5))
        slots += [(b, uniform(n)) for b, n in zip(blocks, SVD_EDGE_SLOTS)]
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
    if svd:
        _set_svd_edge_f(st, range(8, 200), SVD_FORCE_MATERIALS)
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


def g2p_edge_inputs(material: str = "jelly", seed: int = 0, svd: bool = False) -> dict:
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
    * with `svd`, 8 x len(SVD_EDGE_F) more such lanes, whose F is one of
      SVD_EDGE_F where their material's return map runs an SVD (cdg = I
      there, so the SVD sees F itself);
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
    if svd:  # drawn apart, so that the lanes above keep their values
        n_svd = 8 * len(SVD_EDGE_F)
        svd_rng = np.random.default_rng(seed + 1)
        svd_origin = np.full((n_svd, 3), 8.0, np.float32)
        svd_grid = svd_origin + svd_rng.uniform(lo, hi, (n_svd, 3)).astype(np.float32)
        st[:, n:n + n_svd] = _edge_state(material, svd_grid, svd_origin, n_svd, svd_rng)[0]
        _set_svd_edge_f(st, range(n, n + n_svd), SVD_PLAST_MATERIALS)
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
