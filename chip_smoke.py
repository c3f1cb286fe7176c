#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``taichi_mpm_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. ``card``: the card's name and power limit (nvidia-smi), then ``build``:
   the CUDA kernels compiled from ``taichi_mpm_torch/csrc``, one library
   per source and material set (the material-free one, each material,
   jelly and water, snow, visco and sand, all eight), one nvcc each, all
   started together, with the seconds of each and its registers, spills
   and shared memory (``-Xptxas -v``); ``p2g_checksums`` and ``g2p_checksums``:
   the SHA-256 of the four kernels' outputs on fixed inputs
   (``p2g_checksums``, ``g2p_checksums``), to compare with another
   tree's; ``p2g_edges``: both P2G kernels against their twins on
   hand-made inputs at their edges (``diagnostics.p2g_edge_inputs``: a
   slot of 1,200 particles, supports reaching tile nodes 0 and 6, exact
   half-cells, one-particle slots, empty slots inside and after the live
   ones, K odd), each material, jelly and water, and all eight: merged
   records to 1e-5 x max|record|,
   bits equal over two launches, empty slots' tiles zero. ``g2p_edges``:
   ``g2p_fused`` against its twin on the G2P edge inputs
   (``diagnostics.g2p_edge_inputs``: a slot of 600 lanes, CUDA blocks
   spanning more slots than the kernel stages, one-lane slots, inactive
   lanes among and after the active ones, active lanes with key K,
   supports at the clamp edges, half-cells, a NaN in F, each material's
   state reaching its return map's branches), each material, jelly and
   water, all eight, and those three again with the lanes in a random
   order (keys unsorted): rows to x 5e-6, v 5e-5, F 5e-6, C 5e-4, aux
   5e-6, vmax to 1e-6 relative, the active mask exactly, the NaN lanes
   scrubbed, the plasticity count exactly but for sand's lanes within
   rounding of its knife edges (``diagnostics.sand_knife_edges``), two
   launches bit-identical, inactive lanes untouched, and on the unsorted
   lanes the bits of the sorted run, permuted; with the share of lanes
   that gathered from shared memory.
2. ``cube25``: ``benchmark_cube(cells=25)`` (125k jelly particles), one
   frame of 6 substeps on the card and the same frame on the CPU (the
   kernels' plain twins), held to x 5e-6, v 5e-5, F 5e-6, C 5e-4, aux 5e-6
   with equal sort and plasticity counts; a second card frame must give
   the same bits (the path is deterministic). The same frame on the
   unfused route (``TMT_FUSED=0``: the operand prep, ``p2g_blocked``,
   ``g2p_blocked`` and the finish) on the card, held to the same bounds
   against the fused card frame and against the unfused CPU frame. Then
   each kernel against
   its plain PyTorch version on the same CUDA inputs: that state stirred
   (see ``stirred``) so that C and F - I are far from 0. P2G records to
   1e-5 x max|record| and bit-identical over two launches (the kernel is
   deterministic), ``p2g_blocked`` so too at the page map's K and at a K
   of the other residue mod 4 (empty slots appended, whose tiles must be
   zero); G2P rows to x 5e-6, v 5e-5, F 5e-6, C 5e-4 and
   1e-3 x max|C|, aux 5e-6, the other rows exactly, vmax to 1e-5
   relative, the plasticity count exactly; the gather-only G2P's rows v to
   5e-5 and B to min(5e-4, 1e-3 x max|B|); max|v|, max|F - I| and max|C|
   are printed beside the errors. ``water25``: the same kernel checks on a
   125k water cube after one card frame, stirred with aux (the water's J)
   spread around 1, so that the equation-of-state force and the return
   map are far from rest; then on that state with every other lane jelly,
   through the kernels compiled for a scene of both materials.
   ``materials25``: for each of the six other materials, the set of
   ``scripts/async/combo.py`` (snow, visco, sand) and all eight (dealt over
   the cube's lattice in turn), one 6-substep frame of the 125k cube on
   the card against the CPU's and the unfused card frame, at the bounds of
   ``cube25`` with plastic events equal but for sand's knife edges over
   the CPU frame; then the four kernels against their twins on that state
   stirred, two launches bit-identical.
3. ``main_path``: ``benchmark_cube(cells=100, res=125)``, the 8M-particle
   jelly cube, with frame_dt = 20 base_dt: every launch count set to 0, one
   warm-up frame and 15 timed frames (host clock, fenced by
   torch.cuda.synchronize), the counts read right after. Each kernel of
   the path must have launched once per substep; all 8,000,000 particles
   must stay active, with finite positions inside [0, res dx].
4. ``breakdown``: CUDA-event times of each stage of a substep at 8M;
   ``profile``: one more frame under torch.profiler, the device's busy
   time against the frame's wall time (the idle share) and the kernels
   that take the most of it.
5. ``kernel_checks``: the checks of phase 2 on the 8M state, stirred,
   the kernels' times there, and the share of lanes whose window
   ``g2p_fused`` staged in shared memory. ``material_kernels``: both
   fused kernels on that state made of each material in turn (rows 24,
   27, 28-35 and 47 rewritten), their times and bounds.
6. ``main_path_unfused``: the 8M jelly cube built under ``TMT_FUSED=0``,
   one warm-up and 5 timed frames, each kernel of that route launched
   once per substep and none of the fused route; ``stage_report``: its
   stages at 8M (``taichi_mpm_torch.diagnostics.stage_report``).
   ``sand_path``: the 8M sand cube (friction angle 35) on the fused route,
   a warm-up and 5 timed frames: each kernel once per substep, all
   8,000,000 particles active, finite and in the domain, plastic events
   in every frame, a second cube's first frame bit-identical; the kernels'
   times on its state and the sand libraries' registers and spills;
   ``sand_profile``: the idle share of one more frame.
7. ``dam_check``: the adaptive dam break (``scenes.water_dam``) at res 32,
   one adaptive frame of 5e-4 s on the card on each route and on the CPU:
   equal substep counts, the bounds of phase 2. ``dam``: the dam at res
   128 (1,410,048 water particles), a warm-up frame and 3 timed frames of
   0.01 s on each route; per frame its substeps, smallest and largest dt,
   ms per substep, host syncs per substep and the update counter; after
   the fused frames, the four kernels' CUDA-event times on the dam's
   state and ``g2p_fused``'s staged share there.
8. ``cpic_check``: the CPIC frame on a small wheel scene (10,000 water
   particles placed on the wheel's paddles, falling at 1 m/s, res 96, the
   lazy rigid page map on): 6 substeps on the card and on the CPU, held
   to x 5e-6, v 5e-4, F 5e-5, states and near_b exactly, body vel and
   omega 1e-5, pos 1e-6, the counts of the frame equal; a second card run
   must give the same bits. ``cpic_sand_check``: the same with sand
   (density 2000, friction angle 35) in place of the water, the coupled
   frame of ``scripts/mls-cpic/sand_*.py``. ``sand_column_check``: one
   adaptive frame of ``scenes.sand_column`` (``scripts/async/sand.py`` at
   res 64, 7,488 particles on a lattice) on each route against the CPU,
   with equal substep counts.
9. ``cpic_path``: ``scenes.cpic_wheel()`` (100,000 water particles over a
   hub and a 6-paddle wheel joined by a rotation articulation, res 96),
   frames of 20 substeps: every launch count set to 0, warm-up frames
   until the water has reached the wheel, then timed frames, the counts
   read right after. Each kernel of the path must have launched once per
   substep; all 100,000 particles active, finite and in the domain; the
   wheel must turn (omega_z != 0). Then the kernel checks of phase 2 on
   the wheel's state, stirred with aux spread around 1: the P2G kernel's
   water branch and the gather-only G2P at the shapes this path gives
   them. Printed: ms/substep, particle-substeps per second, host syncs
   per substep, the largest near sets (exact and coarse) and the rigid
   page map's occupancy against its capacity Kr. ``cpic_breakdown``:
   CUDA-event time of each stage of a
   coupled substep, per substep over one frame; ``cpic_profile``: the
   idle share of one frame.
10. ``cpic_adaptive``: the wheel's 100k water and
   bodies through ``AsyncMPM`` on the fused route, the water placed on
   the paddles as in ``cpic_check`` (from the default placement it would
   take ~2,800 adaptive substeps to reach the wheel): a warm-up frame and
   3 timed frames of 2e-3 s, with their substeps, ms and host syncs per
   substep, which must not exceed the fixed-dt frames'. Each kernel of
   an adaptive path must have launched once per substep, no other.
11. ``script_dam``: ``scripts/async/water.py`` at res 128 through the
   port's runner (``scenes.water_script``, ``runner.simulate``): seeded
   from its texture (1,056,758 particles, bit for bit the CPU's seeding),
   a warm-up frame and 3 timed frames of 0.01 s, a verbose BGEO every
   frame into a temporary directory, a snapshot after frame 1, the energy
   every frame: ``p2g_fused`` and ``g2p_fused`` once per substep, all
   particles active, finite and in the domain, the last BGEO read back
   equal to the scene in bits, the energy finite; printed: ms per
   substep, particle-steps/s and host syncs per substep beside the
   lattice dam's (phase ``dam``), seconds to seed, BGEO ms and MB/s, save
   ms and bytes, energy ms, the memory peak. ``script_resume``: from that
   snapshot, two fresh scenes step a 5e-4 s frame with the same bits and
   substeps, and the scene copied at the snapshot steps it within the
   bounds of phase 2 (particles matched by an index tag in a parameter
   slot no material reads) with the same substeps; the same on the 125k
   jelly cube over 6 substeps at fixed dt. ``energy_check``: each
   material's 125k cube, ``energy()`` of the card's frame against the
   CPU's, and of the card's state stirred against that state on the
   CPU, within 1e-5 of the sum of the terms' magnitudes.
   ``emission_check``: ``scripts/mls-cpic/sand_paddles.py`` at res 64
   (two scripted paddle wheels, capacity 50,000, the sand source every
   frame), 3 frames of 1e-3 s on the card and on the CPU: equal emitted
   counts, the CPIC bounds of ``cpic_check``, the CPIC kernels once per
   substep.

Then the ``kernels`` line: per kernel its launches on each path, its
CUDA-event time at the 8M shapes (and at the dam's), its plain version's
time, its max abs error against the plain version there (from
``kernel_checks``), and its bound (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, the
larger; the state rows counted for the scene's materials, the halo tiles
and windows for the live slots only, as no other slot is read), and for
the fused kernels the same at the 8M state of each material
(``by_material``). Then the card's name and power limit once more, and
last ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero; without a CUDA device it exits 2 and prints no
result.

``python3 chip_smoke.py --kernel-tree [DIR]`` runs only the four kernels
of the package under DIR (a checkout's root; default this one): their
checksums on the fixed inputs (and the fused kernels' on the 125k cube of
each other material the package runs), and their CUDA-event times on the
8M jelly cube and the 1.4M adaptive dam, each after one frame. Run it on two
trees in one call (parent, change, change, parent) to show that a change
kept the kernels' bits and to time both on one card.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
N_TIMED_FRAMES = 15
N_TIMED_FRAMES_UNFUSED = 5
SUBSTEPS_PER_FRAME = 20
CPIC_WARM_FRAMES = 50  # 1000 substeps: the water falls onto the wheel
CPIC_TIMED_FRAMES = 5
ADAPTIVE_TIMED_FRAMES = 3  # after one warm-up frame
N_SAND_FRAMES = 5  # timed frames of the 8M sand cube, after one warm-up frame

# float32 operations per particle, counted from the kernels' formulas (an
# FMA is 2; a square root, division, log, exp or pow 1): see the notes in
# taichi_mpm_torch/csrc/p2g.cu, g2p.cu and materials.cuh.
# Material ids (taichi_mpm_torch.materials.cforms) and names.
ELASTIC, JELLY, SNOW, WATER, SAND, VON_MISES, LINEAR, VISCO = range(8)
MATERIALS = ("elastic", "jelly", "snow", "water", "sand", "von_mises", "linear", "visco")
SVD_OPS = 1120  # F^T F, 18 Jacobi rotations (~53 each), sort, flip, Gram-Schmidt U, s
POLAR_OPS = 6 * 115  # 6 scaled Newton iterations
P2G_OPS_WEIGHTS = 54  # the 9 support weights, from the block-local position
P2G_OPS_SCATTER = 27 * 31  # 27 support nodes: weight, offset, 3 + 1 channel FMAs
# the force and the affine A (36) per material; + the weights
P2G_OPS_FORCE = {
    JELLY: POLAR_OPS + 146, VISCO: POLAR_OPS + 146, SNOW: POLAR_OPS + 150,
    WATER: 50,
    LINEAR: 139,
    ELASTIC: SVD_OPS + 173, SAND: SVD_OPS + 173, VON_MISES: SVD_OPS + 173,
}
P2G_OPERAND_ROWS = 16  # p2g_blocked's operand: m v, m, A, block-local pos
G2P_OPS_GATHER = 6 + 54 + 27 * 29  # position, weights, 27 nodes: v and B FMAs
# the finish per material: damping, cdg, the return map, advection, checks
G2P_OPS_FINISH = {
    JELLY: 150, ELASTIC: 150, LINEAR: 150, WATER: 110,
    SNOW: 150 + SVD_OPS + 68, SAND: 150 + SVD_OPS + 100, VON_MISES: 150 + SVD_OPS + 84,
    # exp(cdg - I) F, |P| (polar Newton, inverse), two SVDs, the flow
    VISCO: 105 + 86 + 45 + 2 * SVD_OPS + POLAR_OPS + 112 + 160,
}
# state rows each kernel must read and write per particle, by material.
# The kernels are compiled for the scene's material set: one material
# reads its own rows only, and only a mixed set also reads the material
# row 47 (see material_rows).
P2G_ROWS_READ = {  # act, x, v, C, mass, vol, parameters 0-1, origin (23), and
    ELASTIC: 32, JELLY: 32, SAND: 32, VON_MISES: 32, LINEAR: 32, VISCO: 32,  # F
    SNOW: 34,  # F, aux, parameter 2
    WATER: 24,  # aux
}
G2P_ROWS_READ = {  # x, origin, F (15) and aux and the return map's parameters
    JELLY: 15, ELASTIC: 15, LINEAR: 15, WATER: 16,
    SNOW: 20, SAND: 21, VON_MISES: 17, VISCO: 20,
}  # besides act and the key
G2P_ROWS_WRITTEN = {  # x, v, C (15) and F and aux
    JELLY: 24, ELASTIC: 24, LINEAR: 24, VON_MISES: 24, WATER: 16,
    SNOW: 25, SAND: 25, VISCO: 25,
}
GATHER_ROWS_READ, GATHER_ROWS_WRITTEN = 6, 12  # x, origin (+ key) / v, B
# the material sets the smoke run builds: the material-free library, each
# material, jelly and water, scripts/async/combo.py's (snow, visco, sand)
# and all eight
COMBO = ("snow", "visco", "sand")
LIBRARY_SETS = (0, *(1 << m for m in range(8)), (1 << JELLY) | (1 << WATER),
                (1 << SNOW) | (1 << VISCO) | (1 << SAND), 255)


def material_ops(st, lanes, table, base=0):
    """float32 operations of a kernel over the lanes `lanes` (bool (Pw,)):
    `base` plus `table` of each lane's material (row 47)."""
    import torch

    mat = st[47][lanes].to(torch.int64)
    return sum((base + table[m]) * int((mat == m).sum()) for m in table)


def material_rows(st, lanes, table, read=True):
    """State rows the kernel must move for the lanes `lanes` (bool (Pw,)),
    by each lane's material (row 47) and `table`; where it reads them, row
    47 itself for every lane when the lanes hold more than one material."""
    import torch

    mat = st[47][lanes].to(torch.int64)
    counts = {m: int((mat == m).sum()) for m in table}
    if sum(counts.values()) != int(lanes.sum()):
        fail("a lane of a material the kernels do not run")
    rows = sum(table[m] * n for m, n in counts.items())
    mixed = sum(1 for n in counts.values() if n) > 1
    return rows + (int(lanes.sum()) if read and mixed else 0)


def counters():
    from taichi_mpm_torch.ops import g2p, p2g

    return {"p2g_fused": p2g.stats, "g2p_fused": g2p.stats, "g2p_blocked": g2p.blocked_stats,
            "p2g_blocked": p2g.blocked_stats}


ROUTE_KERNELS = {True: ("p2g_fused", "g2p_fused"), False: ("p2g_blocked", "g2p_blocked")}


def route_failures(launches, fused, substeps, kernels=None):
    """Each kernel of the route (or of `kernels`) launched once per
    substep, every other kernel never."""
    kernels = kernels or ROUTE_KERNELS[fused]
    return [f"{name} launched {n} times in {substeps} substeps"
            for name, n in launches.items() if n != (substeps if name in kernels else 0)]


def on_route(fused, make):
    """make() with TMT_FUSED set for the route, as a user selects it (the
    solver reads it at construction)."""
    old = os.environ.get("TMT_FUSED")
    os.environ["TMT_FUSED"] = "1" if fused else "0"
    try:
        return make()
    finally:
        if old is None:
            del os.environ["TMT_FUSED"]
        else:
            os.environ["TMT_FUSED"] = old


def zero_counts():
    for c in counters().values():
        c.launches = 0


def read_counts():
    return {name: c.launches for name, c in counters().items()}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(f"chip_smoke check failed: {msg}")


def raise_failures(failures):
    if failures:
        fail("; ".join(failures))


def nvidia_smi(query="name,power.limit"):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=1):
    """Mean CUDA-event time of fn() in ms over `reps` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


ROW_BOUNDS = (("x", 0, 3, 5e-6), ("v", 3, 3, 5e-5), ("F", 6, 9, 5e-6), ("C", 15, 9, 5e-4),
              ("aux", 24, 1, 5e-6))
C_REL = 1e-3  # G2P's C is also held to this share of max|C|
SPIN = 50.0  # rad/s, the stirred state's spin


def stirred(st, seed=0, aux_sd=0.0):
    """A copy of the sorted state `st` on which the kernels meet values
    far from rest: every particle spins at SPIN rad/s about a tilted axis
    through the particles' centre (on top of its own v), F gets N(0, 0.05)
    and C N(0, 0.01) noise, and aux (water's J) N(0, aux_sd) noise. A
    falling cube keeps C near 0, F near I and J near 1, where a wrong C,
    F or force could pass an absolute bound. Positions and everything
    else stay, so the page map still holds."""
    import torch

    from taichi_mpm_torch.ops.rows import RACT, RAUX, RC, RF, RV, RX

    gen = torch.Generator(device=st.device).manual_seed(seed)
    act = st[RACT] > 0.5
    x = st[RX:RX + 3]
    r = x - x[:, act].mean(dim=1, keepdim=True)
    axis = torch.tensor([1.0, 2.0, 3.0], device=st.device)
    w = (SPIN / axis.norm() * axis)[:, None].expand_as(r)
    out = st.clone()
    out[RV:RV + 3] += torch.linalg.cross(w, r, dim=0)
    out[RF:RF + 9] += 0.05 * torch.randn((9, st.shape[1]), generator=gen, device=st.device)
    out[RC:RC + 9] += 0.01 * torch.randn((9, st.shape[1]), generator=gen, device=st.device)
    if aux_sd:
        out[RAUX] += aux_sd * torch.randn((st.shape[1],), generator=gen, device=st.device)
    return out


def compare_kernels(sim, st, failures, cfg=None):
    """Each kernel against its plain version on the same CUDA inputs: the
    sorted state `st` on the page map of `sim`, under `cfg` (default
    sim.cfg); each twice, for equal bits. The plasticity counts must be
    equal, but for the sand lanes within rounding of the return map's
    knife edges (diagnostics.sand_knife_edges, printed). Returns the errors
    and the scales of what G2P wrote; a broken bound is appended to
    `failures`."""
    import torch

    from taichi_mpm_torch import diagnostics
    from taichi_mpm_torch.ops import blocked, g2p, p2g
    from taichi_mpm_torch.ops.rows import RACT, RC, RF, RV
    from taichi_mpm_torch.ops.substep import grid_update_flat

    cfg = cfg or sim.cfg
    dt = cfg.base_dt
    pm = sim.packed_carry[2]
    tiles = p2g.p2g_fused(pm["s_arr"], pm["e_arr"], st, dt, cfg)
    tiles2 = p2g.p2g_fused(pm["s_arr"], pm["e_arr"], st, dt, cfg)
    tiles_p = p2g.p2g_fused_plain(pm["s_arr"], pm["e_arr"], st, dt, cfg)
    torch.cuda.synchronize()
    if not torch.equal(tiles.view(torch.int32), tiles2.view(torch.int32)):
        failures.append("P2G gave other bits on a second launch")
    rec = blocked.merge_tiles(tiles, pm["nbr"])
    rec_p = blocked.merge_tiles(tiles_p, pm["nbr"])
    p2g_err = max_abs(rec, rec_p)
    scale = float(rec_p.abs().max())
    if not p2g_err <= 1e-5 * scale:
        failures.append(f"P2G records differ by {p2g_err} > 1e-5 x {scale}")
    del tiles, tiles2, tiles_p, rec_p
    blocked_err, blocked_K = blocked_p2g_checks(pm, p2g.prep_packed(st, cfg, dt), failures)

    vrec = grid_update_flat(rec, pm["ids"], cfg, tuple(sim.colliders), sim.t, dt)
    win = blocked.windows(vrec, pm["nbr"])
    st_k, st_k2, st_p = st.clone(), st.clone(), st.clone()
    edges = diagnostics.sand_knife_edges(pm["slot_keys"], st, win, dt, cfg)
    vmax, plast = g2p.g2p_fused(pm["slot_keys"], st_k, win, dt, cfg)
    vmax2, plast2 = g2p.g2p_fused(pm["slot_keys"], st_k2, win, dt, cfg)
    vmax_p, plast_p = g2p.g2p_fused_plain(pm["slot_keys"], st_p, win, dt, cfg)
    torch.cuda.synchronize()
    if not (torch.equal(st_k.view(torch.int32), st_k2.view(torch.int32))
            and torch.equal(vmax, vmax2) and torch.equal(plast, plast2)):
        failures.append("g2p_fused gave other bits on a second launch")
    del st_k2
    live = st_p[:, st_p[RACT] > 0.5]
    eye = torch.eye(3, device=st.device).reshape(9, 1)
    g2p_scale = {"max|v|": float(live[RV:RV + 3].abs().max()),
                 "max|F-I|": float((live[RF:RF + 9] - eye).abs().max()),
                 "max|C|": float(live[RC:RC + 9].abs().max())}
    errs = {}
    for name, r0, n, bound in ROW_BOUNDS:
        if name == "C":
            bound = min(bound, C_REL * g2p_scale["max|C|"])
        errs[name] = max_abs(st_k[r0:r0 + n], st_p[r0:r0 + n])
        if not errs[name] <= bound:
            failures.append(f"G2P row {name} differs by {errs[name]} > {bound}")
    if not torch.equal(st_k[25:].view(torch.int32), st_p[25:].view(torch.int32)):
        failures.append("G2P changed rows it must leave alone")
    vk, vp = float(vmax), float(vmax_p)
    if not abs(vk - vp) <= 1e-5 * vp:
        failures.append(f"vmax {vk} vs plain {vp}")
    if not abs(int(plast) - int(plast_p)) <= edges:
        failures.append(f"plasticity count {int(plast)} vs plain {int(plast_p)}, "
                        f"{edges} sand lanes at the knife edges")

    out = g2p.g2p_blocked(pm["slot_keys"], st, win, cfg)
    out2 = g2p.g2p_blocked(pm["slot_keys"], st, win, cfg)
    out_p = g2p.g2p_blocked_plain(pm["slot_keys"], st, win, cfg)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), out2.view(torch.int32)):
        failures.append("the gather-only G2P gave other bits on a second launch")
    b_scale = float(out_p[3:].abs().max())
    gather_err = {"v": max_abs(out[:3], out_p[:3]), "B": max_abs(out[3:], out_p[3:])}
    for name, bound in (("v", 5e-5), ("B", min(5e-4, C_REL * b_scale))):
        if not gather_err[name] <= bound:
            failures.append(f"gather-only G2P row {name} differs by {gather_err[name]} > {bound}")
    return dict(p2g_max_abs_err=p2g_err, p2g_record_scale=scale,
                p2g_blocked_max_abs_err=max(blocked_err.values()), p2g_blocked_err=blocked_err,
                p2g_blocked_slots=blocked_K,
                g2p_max_abs_err=max(errs.values()), g2p_row_err=errs, g2p_scale=g2p_scale,
                vmax=vk, vmax_plain=vp, plast=int(plast), plast_plain=int(plast_p),
                sand_knife_edges=edges,
                g2p_blocked_max_abs_err=max(gather_err.values()),
                g2p_blocked_row_err=gather_err, max_abs_B=b_scale)


def blocked_p2g_checks(pm, pdata, failures):
    """p2g_blocked against its plain version on the operand `pdata` of the
    page map `pm`: at the map's K and, with empty slots appended, at a K
    of the other residue mod 4 (the TPU dispatched on K % 4; the port has
    one kernel). Records to 1e-5 x max|record|, two launches bit-identical,
    the appended slots' tiles zero. Returns the errors and the Ks."""
    import torch

    from taichi_mpm_torch.ops import blocked, p2g

    K = pm["s_arr"].shape[0]
    errs = {}
    for n in (K, K + (1 if K % 4 == 0 else 4 - K % 4)):
        pad = pm["e_arr"][-1:].expand(n - K)
        s_arr, e_arr = torch.cat([pm["s_arr"], pad]), torch.cat([pm["e_arr"], pad])
        tiles = p2g.p2g_blocked(s_arr, e_arr, pdata)
        tiles2 = p2g.p2g_blocked(s_arr, e_arr, pdata)
        tiles_p = p2g.p2g_blocked_plain(s_arr, e_arr, pdata)
        torch.cuda.synchronize()
        if not torch.equal(tiles.view(torch.int32), tiles2.view(torch.int32)):
            failures.append(f"p2g_blocked gave other bits on a second launch (K={n})")
        if bool(tiles[K:].any()):
            failures.append(f"p2g_blocked wrote into empty slots (K={n})")
        rec = blocked.merge_tiles(tiles[:K].contiguous(), pm["nbr"])
        rec_p = blocked.merge_tiles(tiles_p[:K].contiguous(), pm["nbr"])
        errs[f"K={n}"] = err = max_abs(rec, rec_p)
        scale = float(rec_p.abs().max())
        if not err <= 1e-5 * scale:
            failures.append(f"p2g_blocked records differ by {err} > 1e-5 x {scale} (K={n})")
        del tiles, tiles2, tiles_p, rec, rec_p
    return errs, [K, n]


def p2g_checksums():
    """SHA-256 of both P2G kernels' tiles on a fixed input: the 125k jelly
    cube (benchmark_cube(cells=25)), packed and sorted, stirred with seed
    0; p2g_blocked on its operand (prep_packed). It uses only the port's
    API of its first three slices, so it can be pointed at an older tree's
    package (``--kernel-tree``) to show that a change left the kernels' bits
    as they were."""
    import torch

    from taichi_mpm_torch.ops import p2g, packed

    sim = cube(25, "cuda", 6)
    sim._ensure_finalized()
    cfg, dt = sim.cfg, sim.cfg.base_dt
    st, _, pm, _ = packed.pack_carry(sim.particles, cfg, sim._active_block_cap())
    st = stirred(st)
    tiles = {"p2g_fused": p2g.p2g_fused(pm["s_arr"], pm["e_arr"], st, dt, cfg),
             "p2g_blocked": p2g.p2g_blocked(pm["s_arr"], pm["e_arr"],
                                            p2g.prep_packed(st, cfg, dt))}
    torch.cuda.synchronize()
    return {name: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
            for name, t in tiles.items()}


def g2p_windows(sim, st, pm):
    """The velocity windows of one P2G (``p2g_fused``), halo merge, grid
    update and assembly on the sorted state `st` with page map `pm` of
    `sim`."""
    from taichi_mpm_torch.ops import blocked, p2g
    from taichi_mpm_torch.ops.substep import grid_update_flat

    cfg, dt = sim.cfg, sim.cfg.base_dt
    rec = blocked.merge_tiles(p2g.p2g_fused(pm["s_arr"], pm["e_arr"], st, dt, cfg), pm["nbr"])
    vrec = grid_update_flat(rec, pm["ids"], cfg, tuple(sim.colliders), sim.t, dt)
    return blocked.windows(vrec, pm["nbr"])


def g2p_checksums():
    """SHA-256 of both G2P kernels' outputs on fixed inputs: the 125k
    jelly cube stirred (seed 0) and the 125k water cube stirred with aux
    (J) spread by 0.1, packed and sorted; windows from one P2G, merge,
    grid update and assembly on that state (g2p_windows); ``g2p_fused``
    on a copy of the state (the checksum covers the state, vmax and the
    plasticity count), ``g2p_blocked`` on the windows. Like
    p2g_checksums it uses only the port's API of its first slices."""
    import torch

    from taichi_mpm_torch.ops import g2p, packed

    out = {}
    for material in ("jelly", "water"):
        sim = cube(25, "cuda", 6, material=material)
        sim._ensure_finalized()
        cfg, dt = sim.cfg, sim.cfg.base_dt
        st, _, pm, _ = packed.pack_carry(sim.particles, cfg, sim._active_block_cap())
        st = stirred(st, aux_sd=0.1 if material == "water" else 0.0)
        win = g2p_windows(sim, st, pm)
        new = st.clone()
        vmax, plast = g2p.g2p_fused(pm["slot_keys"], new, win, dt, cfg)
        gathered = g2p.g2p_blocked(pm["slot_keys"], st, win, cfg)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in (new, vmax, plast):
            h.update(t.cpu().numpy().tobytes())
        out[f"g2p_fused_{material}"] = h.hexdigest()
        out[f"g2p_blocked_{material}"] = hashlib.sha256(
            gathered.cpu().numpy().tobytes()).hexdigest()
    return out


def g2p_block_shape():
    """(lanes per CUDA block, windows staged per block) of the built
    g2p_fused kernel."""
    from taichi_mpm_torch.ops import cuda_build

    lib = cuda_build.load("g2p")
    return lib.g2p_block_lanes(), lib.g2p_staged_windows()


def staged_share(keys, st, K):
    """The share of the active keyed lanes of `st` whose window g2p_fused
    stages in shared memory (diagnostics.g2p_staged_share)."""
    from taichi_mpm_torch import diagnostics

    return diagnostics.g2p_staged_share(keys, st, *g2p_block_shape(), K)


EDGE_SETS = (*MATERIALS, "mixed", "all")  # diagnostics.edge_material_names


def phase_g2p_edges():
    """g2p_fused against its twin on the hand-made G2P edge inputs
    (diagnostics.g2p_edge_inputs): each material, jelly and water, all
    eight, and jelly, jelly and water and all eight again with the lanes in
    a random order."""
    import torch

    from taichi_mpm_torch import diagnostics
    from taichi_mpm_torch.ops import blocked, g2p
    from taichi_mpm_torch.ops.rows import RACT, RF

    failures, out, sorted_runs = [], {}, {}
    perm = np.random.default_rng(1).permutation(diagnostics.G2P_EDGE_LANES)
    for label in (*EDGE_SETS, "jelly_unsorted", "mixed_unsorted", "all_unsorted"):
        material = label.removesuffix("_unsorted")
        e = diagnostics.g2p_edge_inputs(material)
        cfg, dt = e["cfg"], e["cfg"].base_dt
        keys, st = e["keys"], e["st"]
        if label.endswith("unsorted"):
            keys, st = keys[perm], np.ascontiguousarray(st[:, perm])
        keys, st = torch.as_tensor(keys, device="cuda"), torch.as_tensor(st, device="cuda")
        win = blocked.windows(torch.as_tensor(e["vrec"], device="cuda"),
                              torch.as_tensor(e["nbr"], device="cuda"))
        edges = diagnostics.sand_knife_edges(keys, st, win, dt, cfg)
        runs = []
        for fn in (g2p.g2p_fused, g2p.g2p_fused, g2p.g2p_fused_plain):
            new = st.clone()
            runs.append((new, *fn(keys, new, win, dt, cfg)))
        torch.cuda.synchronize()
        (k1, vm1, pl1), (k2, vm2, pl2), (kp, vmp, plp) = runs
        what = f"g2p_fused on the {label} edge inputs"
        if not (torch.equal(k1.view(torch.int32), k2.view(torch.int32))
                and torch.equal(vm1, vm2) and torch.equal(pl1, pl2)):
            failures.append(f"{what}: other bits on a second launch")
        idle = st[RACT] <= 0.5
        if not torch.equal(k1[:, idle].view(torch.int32), st[:, idle].view(torch.int32)):
            failures.append(f"{what}: an inactive lane changed")
        if not torch.equal(k1[RACT], kp[RACT]):
            failures.append(f"{what}: other lanes active than the twin's")
        errs = {}
        for name, r0, n, bound in ROW_BOUNDS:
            errs[name] = max_abs(k1[r0:r0 + n], kp[r0:r0 + n])
            if not errs[name] <= bound:
                failures.append(f"{what}: row {name} differs by {errs[name]} > {bound}")
        if not torch.equal(k1[25:].view(torch.int32), kp[25:].view(torch.int32)):
            failures.append(f"{what}: rows it must leave alone changed")
        if not abs(float(vm1) - float(vmp)) <= 1e-6 * float(vmp):
            failures.append(f"{what}: vmax {float(vm1)} vs twin {float(vmp)}")
        if not abs(int(pl1) - int(plp)) <= edges:
            failures.append(f"{what}: plasticity count {int(pl1)} vs twin {int(plp)}, "
                            f"{edges} sand lanes at the knife edges")
        n_nan = int((~torch.isfinite(st[RF:RF + 9])).any(0)[~idle].sum())
        n_scrubbed = int((k1[RACT, ~idle] == 0).sum())
        if not n_scrubbed >= n_nan >= 1:
            failures.append(f"{what}: {n_scrubbed} lanes scrubbed, {n_nan} with a NaN in F")
        if material not in sorted_runs:
            sorted_runs[material] = (k1, vm1, pl1)
        else:  # the unsorted lanes must give the sorted run's bits, permuted
            ks, vms, pls = sorted_runs[material]
            p_t = torch.as_tensor(perm, device="cuda")
            if not (torch.equal(k1.view(torch.int32), ks[:, p_t].view(torch.int32))
                    and torch.equal(vm1, vms) and torch.equal(pl1, pls)):
                failures.append(f"{what}: not the sorted run's bits")
        out[label] = dict(
            row_err=errs, vmax=float(vm1), plast=int(pl1), plast_twin=int(plp),
            sand_knife_edges=edges, nan_lanes=n_nan, scrubbed=n_scrubbed,
            staged_share=staged_share(keys, st, win.shape[0]))
    emit(dict(phase="g2p_edges", block_shape=g2p_block_shape(), **out, failures=failures))
    raise_failures(failures)


def phase_p2g_edges():
    """Both P2G kernels against their twins on the hand-made edge inputs
    (diagnostics.p2g_edge_inputs), each material, jelly and water, and all
    eight: merged records to 1e-5 x max|record|, two launches
    bit-identical, empty slots zero."""
    import torch

    from taichi_mpm_torch import diagnostics
    from taichi_mpm_torch.ops import blocked, p2g

    failures, out = [], {}
    for material in EDGE_SETS:
        e = diagnostics.p2g_edge_inputs(material)
        cfg, dt = e["cfg"], e["cfg"].base_dt
        st, s_arr, e_arr, nbr = (torch.as_tensor(e[k], device="cuda")
                                 for k in ("st", "s_arr", "e_arr", "nbr"))
        pdata = p2g.prep_packed(st, cfg, dt)
        runs = {
            "p2g_fused": (lambda: p2g.p2g_fused(s_arr, e_arr, st, dt, cfg),
                          lambda: p2g.p2g_fused_plain(s_arr, e_arr, st, dt, cfg)),
            "p2g_blocked": (lambda: p2g.p2g_blocked(s_arr, e_arr, pdata),
                            lambda: p2g.p2g_blocked_plain(s_arr, e_arr, pdata)),
        }
        empty = e_arr <= s_arr
        for name, (kernel, plain) in runs.items():
            label = f"{name} on the {material} edge inputs"
            tiles, tiles2, tiles_p = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            if not torch.equal(tiles.view(torch.int32), tiles2.view(torch.int32)):
                failures.append(f"{label}: other bits on a second launch")
            if bool(tiles[empty].any()):
                failures.append(f"{label}: an empty slot's tile is not zero")
            rec, rec_p = blocked.merge_tiles(tiles, nbr), blocked.merge_tiles(tiles_p, nbr)
            err, scale = max_abs(rec, rec_p), float(rec_p.abs().max())
            if not err <= 1e-5 * scale:
                failures.append(f"{label}: records differ by {err} > 1e-5 x {scale}")
            out[f"{material}_{name}"] = dict(max_abs_err=err, record_scale=scale,
                                             tile_err=max_abs(tiles, tiles_p))
    emit(dict(phase="p2g_edges", slots=int(s_arr.shape[0]), empty_slots=int(empty.sum()),
              particles=int((e_arr - s_arr).sum()), **out, failures=failures))
    raise_failures(failures)


def kernel_states():
    """(label, sim) of the states the kernels are timed on beside the
    main run: the 8M jelly cube and the 1.4M adaptive dam break, each
    after one frame (so with the sort and page map of the main paths)."""
    from taichi_mpm_torch import scenes

    for label, make in (("jelly_8m", lambda: cube(100, "cuda", SUBSTEPS_PER_FRAME)),
                        ("dam_1.4m", lambda: scenes.water_dam(res=128, device="cuda"))):
        sim = make()
        sim.step()
        yield label, sim


def p2g_launches(sim):
    """Both P2G kernels on the sorted state of `sim`, as calls."""
    from taichi_mpm_torch.ops import p2g

    cfg, dt = sim.cfg, sim.cfg.base_dt
    st, _, pm, _ = sim.packed_carry
    s_arr, e_arr = pm["s_arr"], pm["e_arr"]
    pdata = p2g.prep_packed(st, cfg, dt)
    return {"p2g_fused": lambda: p2g.p2g_fused(s_arr, e_arr, st, dt, cfg),
            "p2g_blocked": lambda: p2g.p2g_blocked(s_arr, e_arr, pdata)}


def g2p_launches(sim):
    """Both G2P kernels on the sorted state of `sim` and its windows
    (g2p_windows), as calls; g2p_fused updates a copy of the state."""
    from taichi_mpm_torch.ops import g2p

    cfg, dt = sim.cfg, sim.cfg.base_dt
    st, _, pm, _ = sim.packed_carry
    keys, win, scratch = pm["slot_keys"], g2p_windows(sim, st, pm), st.clone()
    return {"g2p_fused": lambda: g2p.g2p_fused(keys, scratch, win, dt, cfg),
            "g2p_blocked": lambda: g2p.g2p_blocked(keys, st, win, cfg)}


def kernel_ms(sim):
    """The four kernels' CUDA-event times (10 launches each, after one)
    on the state of `sim`."""
    calls = {**p2g_launches(sim), **g2p_launches(sim)}
    return {name: cuda_ms(fn, 10) for name, fn in calls.items()}


def material_checksums():
    """SHA-256 of p2g_fused's tiles and of g2p_fused's state, vmax and
    plasticity count on the 125k cube of each material that the package's
    kernels run besides jelly and water (its ``ops.p2g.DEVICE_MATERIALS``;
    none before this port's sixth slice), stirred with aux spread by 0.05;
    windows as in g2p_checksums."""
    import torch

    from taichi_mpm_torch.ops import g2p, p2g, packed

    out = {}
    for mid in p2g.DEVICE_MATERIALS:
        name = MATERIALS[mid]
        if name in ("jelly", "water"):
            continue
        sim = cube(25, "cuda", 6, material=name)
        sim._ensure_finalized()
        cfg, dt = sim.cfg, sim.cfg.base_dt
        st, _, pm, _ = packed.pack_carry(sim.particles, cfg, sim._active_block_cap())
        st = stirred(st, aux_sd=0.05)
        tiles = p2g.p2g_fused(pm["s_arr"], pm["e_arr"], st, dt, cfg)
        new = st.clone()
        vmax, plast = g2p.g2p_fused(pm["slot_keys"], new, g2p_windows(sim, st, pm), dt, cfg)
        torch.cuda.synchronize()
        out[f"p2g_fused_{name}"] = hashlib.sha256(tiles.cpu().numpy().tobytes()).hexdigest()
        h = hashlib.sha256()
        for t in (new, vmax, plast):
            h.update(t.cpu().numpy().tobytes())
        out[f"g2p_fused_{name}"] = h.hexdigest()
    return out


def kernel_tree(root=None):
    """The four kernels of the package under `root` (default: this
    checkout): their checksums (and those of the other materials where the
    package has them), and their CUDA-event times on the states of
    kernel_states."""
    if root is not None:
        sys.path.insert(0, os.path.abspath(root))
    import taichi_mpm_torch

    out = dict(phase="kernel_tree", package=os.path.dirname(taichi_mpm_torch.__file__),
               checksums={**p2g_checksums(), **g2p_checksums()},
               material_checksums=material_checksums())
    for label, sim in kernel_states():
        out[f"ms_{label}"] = kernel_ms(sim)
        out[f"slots_{label}"] = sim.block_capacity
        del sim
    emit(dict(out, clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit")))


# the cubes' material parameters besides the defaults: jelly's of the main
# path, sand's of the slice's sand cube
CUBE_KW = {"jelly": dict(E=2e4, nu=0.35), "sand": dict(friction_angle=35.0)}


def cube(cells, device, substeps, material="jelly"):
    """benchmark_cube at res 125 with frames of `substeps`, the material
    at CUBE_KW; a tuple of materials dealt over the lattice in turn, at
    their defaults."""
    from taichi_mpm_torch import scenes

    kw = CUBE_KW.get(material, {})
    sim = scenes.benchmark_cube(cells=cells, res=125, material=material, device=device, **kw)
    sim.frame_dt = substeps * sim.cfg.base_dt
    return sim


FRAME_BOUNDS = (("x", 5e-6), ("v", 5e-5), ("F", 5e-6), ("C", 5e-4), ("aux", 5e-6))


def frame_errors(a, b, label, failures, bounds=FRAME_BOUNDS, plast_slack=0):
    """Two scenes after the same frame: the same particles alive, the
    same sort counts, plasticity counts that differ by no more than
    `plast_slack` (sand's lanes at its knife edges over the frame), the
    fields within `bounds`. Returns the errors; a broken bound is appended
    to `failures`."""
    pa, pb = a.particles, b.particles
    act = pa.active.cpu().numpy()
    if not np.array_equal(pb.active.cpu().numpy(), act):
        failures.append(f"{label}: the frames keep other particles")
    act &= pb.active.cpu().numpy()
    errs = {}
    for name, bound in bounds:
        ea = getattr(pa, name).cpu().numpy()[act].astype(np.float64)
        eb = getattr(pb, name).cpu().numpy()[act].astype(np.float64)
        errs[name] = float(np.abs(ea - eb).max())
        if not errs[name] <= bound:
            failures.append(f"{label}: {name} differs by {errs[name]} > {bound}")
    if a.n_sorts != b.n_sorts:
        failures.append(f"{label}: the frames count other sorts")
    if not abs(a.plasticity_counter - b.plasticity_counter) <= plast_slack:
        failures.append(f"{label}: plastic events {a.plasticity_counter} vs "
                        f"{b.plasticity_counter}, {plast_slack} at sand's knife edges")
    return errs


def phase_cube25():
    """One 6-substep frame on the card and on the CPU, on each route;
    then the kernels against their plain versions at the card's state."""
    from taichi_mpm_torch import convert

    sims = {dev: cube(25, dev, 6) for dev in ("cuda", "cpu")}
    unfused = {dev: on_route(False, lambda: cube(25, dev, 6)) for dev in ("cuda", "cpu")}
    rerun = cube(25, "cuda", 6)
    for sim in (*sims.values(), rerun, unfused["cpu"]):
        sim.step()
    zero_counts()
    unfused["cuda"].step()
    failures = route_failures(read_counts(), False, 6)
    g = sims["cuda"].particles
    first = convert.particles_to_numpy(g)
    for name, arr in convert.particles_to_numpy(rerun.particles).items():
        if arr.tobytes() != first[name].tobytes():
            failures.append(f"the card's frame is not deterministic: {name} differs on a rerun")
    gs = sims["cuda"]
    out = dict(phase="cube25", particles=int(g.active.sum()), K=gs.block_capacity,
               n_sorts=gs.n_sorts, plast=gs.plasticity_counter,
               frame_vs_cpu=frame_errors(gs, sims["cpu"], "card vs CPU frame", failures),
               unfused_vs_fused=frame_errors(unfused["cuda"], gs, "unfused vs fused card frame",
                                             failures),
               unfused_vs_cpu=frame_errors(unfused["cuda"], unfused["cpu"],
                                           "unfused card vs CPU frame", failures))
    out.update(compare_kernels(gs, stirred(gs.packed_carry[0]), failures))
    emit(dict(out, failures=failures))
    raise_failures(failures)


def mixed(st):
    """A copy of `st` with every other lane turned jelly (rows 27 and 47),
    for the kernels compiled for a scene of jelly and water."""
    import torch

    from taichi_mpm_torch.ops.rows import RMAT, RMATF

    out = st.clone()
    lanes = torch.arange(st.shape[1], device=st.device) % 2 == 0
    out[RMAT].view(torch.int32)[lanes] = JELLY
    out[RMATF, lanes] = float(JELLY)
    return out


def phase_water25():
    """One 6-substep frame of a 125k water cube on the card (the kernels'
    water branches on the main loop), then the kernels against their plain
    versions on that state stirred, with aux spread around 1; then again
    with every other lane jelly, on the kernels compiled for both."""
    import torch

    from taichi_mpm_torch.ops.rows import RACT, RAUX

    sim = cube(25, "cuda", 6, material="water")
    sim.step()
    st = stirred(sim.packed_carry[0], aux_sd=0.1)
    live = st[RAUX, st[RACT] > 0.5]
    failures = []
    out = dict(phase="water25", particles=int((st[RACT] > 0.5).sum()),
               aux_min=float(live.min()), aux_max=float(live.max()),
               frame_plast=sim.plasticity_counter)
    out.update(compare_kernels(sim, st, failures))
    if out["plast"] == 0:
        failures.append("the water state made no plastic event: the return map went untested")
    out["jelly_and_water"] = compare_kernels(sim, mixed(st), failures,
                                             cfg=sim.cfg.with_materials((JELLY, WATER)))
    torch.cuda.synchronize()
    emit(dict(out, failures=failures))
    raise_failures(failures)


# -- the six other materials ---------------------------------------------------

# each of the six materials other than jelly and water, the mixed set of
# scripts/async/combo.py and all eight, on the cube's lattice in turn
MATERIAL_SETS25 = (("elastic",), ("snow",), ("sand",), ("von_mises",), ("linear",),
                   ("visco",), COMBO, MATERIALS)


def set_label(names):
    return names[0] if len(names) == 1 else "all" if len(names) == 8 else "+".join(names)


def phase_materials25():
    """For each set of MATERIAL_SETS25: one 6-substep frame of the 125k
    cube (benchmark_cube(cells=25), the set's materials dealt over the
    lattice in turn) on the card, each fused kernel launched once per
    substep, held to the same frame on the CPU and to the unfused card
    frame at the cube25 bounds, with plastic events equal but for sand's
    knife edges over the CPU frame; then the four kernels against their
    twins on that state stirred (compare_kernels: bounds, two launches
    bit-identical)."""
    from taichi_mpm_torch import diagnostics

    out, failures = {}, []
    for names in MATERIAL_SETS25:
        label = set_label(names)
        material = names[0] if len(names) == 1 else names
        t0 = time.perf_counter()
        card, cpu = cube(25, "cuda", 6, material), cube(25, "cpu", 6, material)
        unfused = on_route(False, lambda: cube(25, "cuda", 6, material))
        zero_counts()
        card.step()
        f = route_failures(read_counts(), True, 6)
        zero_counts()
        unfused.step()
        f += route_failures(read_counts(), False, 6)
        with diagnostics.sand_edges_per_substep() as edges:
            cpu.step()
        slack = sum(edges)
        res = dict(particles=int(card.particles.active.sum()), plast=card.plasticity_counter,
                   plast_cpu=cpu.plasticity_counter, plast_unfused=unfused.plasticity_counter,
                   sand_knife_edges=slack,
                   frame_vs_cpu=frame_errors(card, cpu, "card vs CPU frame", f,
                                             plast_slack=slack),
                   unfused_vs_fused=frame_errors(unfused, card, "unfused vs fused card frame",
                                                 f, plast_slack=slack))
        del cpu, unfused
        res["kernels"] = compare_kernels(card, stirred(card.packed_carry[0], aux_sd=0.05), f)
        res["seconds"] = time.perf_counter() - t0
        out[label] = res
        failures += [f"{label}: {msg}" for msg in f]
        del card
    emit(dict(phase="materials25", **out, failures=failures))
    raise_failures(failures)


def as_material(st, name):
    """A copy of the packed state `st` with every lane made of material
    `name` (rows 24, 27, 28-35 and 47: aux, id, parameters, id as a value),
    at CUBE_KW."""
    import torch

    from taichi_mpm_torch.materials import models
    from taichi_mpm_torch.ops.rows import RAUX, RMAT, RMATF, RPAR

    mid, params, aux0 = models.pack_params(name, **CUBE_KW.get(name, {}))
    out = st.clone()
    out[RMAT].view(torch.int32).fill_(mid)
    out[RMATF] = float(mid)
    out[RPAR:RPAR + 8] = torch.tensor(params, dtype=torch.float32, device=st.device)[:, None]
    out[RAUX] = aux0
    return out


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fused_work(st, pm):
    """(bytes, float32 operations) that the fused kernels must move and
    compute on the sorted state `st` with page map `pm`: the state rows of
    each lane's material read and written once (row 47 where the lanes
    hold more than one), the live slots' halo tiles written and windows
    read once, the operations of each lane's material."""
    import torch

    from taichi_mpm_torch.ops import p2g

    K = pm["ids"].shape[0]
    n_live = min(int(pm["n_act"]), K)  # slots whose tiles and windows are read
    pw = st.shape[1]
    in_ranges = torch.zeros((pw,), dtype=torch.bool, device=st.device)
    in_ranges[p2g._slot_lanes(pm["s_arr"], pm["e_arr"])[1]] = True
    act = st[36] > 0.5
    return {
        "p2g_fused": (4 * (material_rows(st, in_ranges, P2G_ROWS_READ) + 2 * K
                           + n_live * 343 * 4),
                      material_ops(st, in_ranges, P2G_OPS_FORCE,
                                   P2G_OPS_WEIGHTS + P2G_OPS_SCATTER)),
        "g2p_fused": (4 * (pw + int(act.sum()) + material_rows(st, act, G2P_ROWS_READ)
                           + material_rows(st, act, G2P_ROWS_WRITTEN, read=False)
                           + n_live * 3 * 343),
                      material_ops(st, act, G2P_OPS_FINISH, G2P_OPS_GATHER)),
    }


def phase_material_kernels(sim, card):
    """p2g_fused and g2p_fused at the 8M state of `sim` (the jelly cube
    after its frames) made of each material in turn (as_material), each
    on the library of that material: CUDA-event time (10 launches after
    one) beside its bound. Returns them by kernel and material."""
    from taichi_mpm_torch.ops import blocked, g2p, p2g
    from taichi_mpm_torch.ops.substep import grid_update_flat

    st0, _, pm, _ = sim.packed_carry
    dt = sim.cfg.base_dt
    keys, s_arr, e_arr = pm["slot_keys"], pm["s_arr"], pm["e_arr"]
    out = {"p2g_fused": {}, "g2p_fused": {}}
    for mid, name in enumerate(MATERIALS):
        st = as_material(st0, name)
        cfg = sim.cfg.with_materials((mid,))
        rec = blocked.merge_tiles(p2g.p2g_fused(s_arr, e_arr, st, dt, cfg), pm["nbr"])
        win = blocked.windows(grid_update_flat(rec, pm["ids"], cfg, tuple(sim.colliders),
                                               sim.t, dt), pm["nbr"])
        scratch = st.clone()
        ms = {"p2g_fused": cuda_ms(lambda: p2g.p2g_fused(s_arr, e_arr, st, dt, cfg), 10),
              "g2p_fused": cuda_ms(lambda: g2p.g2p_fused(keys, scratch, win, dt, cfg), 10)}
        for kernel, (nbytes, ops) in fused_work(st, pm).items():
            b_ms, b_by = bound(nbytes, ops)
            out[kernel][name] = dict(ms=ms[kernel], bound_ms=b_ms, bound_by=b_by,
                                     bytes=nbytes, ops=ops)
        del st, scratch, rec, win
    emit(dict(phase="material_kernels", card=card, **out))
    return out


def phase_sand_path(card):
    """The 8M sand cube (cube(100, material="sand"): 8,000,000 sand
    particles at friction angle 35 in the sticky box, dt 1e-4) on the
    fused route: a warm-up frame and N_SAND_FRAMES timed frames of 20
    substeps, the launch counts read right after. Each kernel of the path
    launched once per substep; all particles active, finite and in the
    domain; plastic events in every frame (the return map ran); a second
    cube's first frame gives the first frame's bits. Then the kernels'
    times on its state, the registers and spills of the sand libraries,
    and the idle share of one more frame (profile). Returns (sim,
    launches)."""
    import torch

    from taichi_mpm_torch.ops import cuda_build

    t0 = time.perf_counter()
    sim = cube(100, "cuda", SUBSTEPS_PER_FRAME, "sand")
    sim._ensure_finalized()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    sim.step()
    sim.sync()
    warm_s = time.perf_counter() - t0
    first = sim.packed_carry[0].clone()
    plast = [sim.plasticity_counter]
    t0 = time.perf_counter()
    for _ in range(N_SAND_FRAMES):
        sim.step()
        plast.append(sim.plasticity_counter - sum(plast))
    sim.sync()
    timed_s = time.perf_counter() - t0
    launches = read_counts()

    substeps = (1 + N_SAND_FRAMES) * SUBSTEPS_PER_FRAME
    failures = route_failures(launches, True, substeps)
    x = check_domain(sim, 8_000_000, failures)
    if not min(plast) > 0:
        failures.append(f"a frame without plastic events: {plast}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rerun = cube(100, "cuda", SUBSTEPS_PER_FRAME, "sand")
    rerun.step()
    if not torch.equal(rerun.packed_carry[0].view(torch.int32), first.view(torch.int32)):
        failures.append("the sand cube's first frame gave other bits on a rerun")
    del rerun, first
    n_timed = N_SAND_FRAMES * SUBSTEPS_PER_FRAME
    mats = 1 << SAND
    emit(dict(
        phase="sand_path", card=card, fused=sim.fused, particles=int(x.shape[0]),
        K=sim.block_capacity, substeps=substeps, timed_substeps=n_timed,
        ms_per_substep=timed_s * 1e3 / n_timed,
        particle_steps_per_s=x.shape[0] * n_timed / timed_s, n_sorts=sim.n_sorts,
        plast_per_frame=plast, warmup_frame_s=warm_s, setup_s=setup_s, peak_mem_gb=peak_gb,
        y_min=float(x[:, 1].min()), launches=launches, kernel_ms=kernel_ms(sim),
        ptxas={src: cuda_build.ptxas_report(src, mats) for src in ("p2g", "g2p")},
        clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"), failures=failures))
    raise_failures(failures)
    phase_profile(sim, card, phase="sand_profile")
    return launches


# One 0.01 s frame of the sand column is 20 adaptive substeps of sand at
# rest on a floor, near its return map's knife edges: moving each F of the
# input by one ulp moves the CPU's own frame by F 1.0-1.22e-5 and aux
# 7.0-7.45e-6 (tests/port/sand_rounding.py --column; v 7.5-9.0e-6, C
# 2.6-2.9e-6). Its F and aux bounds are twice that noise; x, v and C keep
# the cube frames' bounds.
SAND_COLUMN_BOUNDS = (("x", 5e-6), ("v", 5e-5), ("F", 2.5e-5), ("C", 5e-4), ("aux", 1.5e-5))


def phase_sand_column_check():
    """One adaptive frame of the sand column (scenes.sand_column, res 64,
    7,488 particles, frame 0.01 s) on the card on each route, against the
    CPU: equal substep counts, SAND_COLUMN_BOUNDS, plastic events equal
    but for sand's knife edges over the CPU frame, each kernel of the
    route launched once per substep."""
    from taichi_mpm_torch import diagnostics, scenes

    cpu = scenes.sand_column(device="cpu")
    with diagnostics.sand_edges_per_substep() as edges:
        cpu.step()
    failures = []
    out = dict(phase="sand_column_check", particles=int(cpu.particles.count()),
               substeps=cpu.last_substeps, dt_range=cpu.last_dt_range,
               plast_cpu=cpu.plasticity_counter, sand_knife_edges=sum(edges))
    for fused in (True, False):
        card = on_route(fused, lambda: scenes.sand_column(device="cuda"))
        route = "fused" if fused else "unfused"
        zero_counts()
        card.step()
        failures += route_failures(read_counts(), fused, card.last_substeps)
        if card.last_substeps != cpu.last_substeps:
            failures.append(f"sand column {route}: {card.last_substeps} substeps on the card, "
                            f"{cpu.last_substeps} on the CPU")
        out[f"{route}_plast"] = card.plasticity_counter
        out[f"{route}_vs_cpu"] = frame_errors(card, cpu, f"sand column {route} card vs CPU",
                                              failures, SAND_COLUMN_BOUNDS, sum(edges))
    if cpu.plasticity_counter == 0:
        failures.append("the sand column made no plastic event: the return map went untested")
    emit(dict(out, failures=failures))
    raise_failures(failures)



def check_domain(sim, n_expected, failures):
    """All n_expected particles active, with finite positions inside
    [0, res dx]. Returns the active positions."""
    import torch

    p = sim.particles
    n_active = int(p.active.sum())
    if n_active != n_expected:
        failures.append(f"{n_active} particles active, not {n_expected:,}")
    x = p.x[p.active]
    hi = sim.cfg.res[0] * sim.cfg.dx
    if not (bool(torch.isfinite(x).all()) and float(x.min()) >= 0.0 and float(x.max()) <= hi):
        failures.append("positions not finite or outside the domain")
    return x


def phase_main_path(card, fused=True):
    """The 8M-particle jelly cube on one route: warm-up frame, timed
    frames, checks."""
    import torch

    t0 = time.perf_counter()
    sim = on_route(fused, lambda: cube(100, "cuda", SUBSTEPS_PER_FRAME))
    sim._ensure_finalized()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    n_frames = N_TIMED_FRAMES if fused else N_TIMED_FRAMES_UNFUSED
    zero_counts()
    t0 = time.perf_counter()
    sim.step()  # warm-up: pack, first sort, page map
    sim.sync()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_frames):
        sim.step()
    sim.sync()
    timed_s = time.perf_counter() - t0
    launches = read_counts()

    substeps = (1 + n_frames) * SUBSTEPS_PER_FRAME
    failures = route_failures(launches, fused, substeps)
    x = check_domain(sim, 8_000_000, failures)
    n_timed = n_frames * SUBSTEPS_PER_FRAME
    emit(dict(
        phase="main_path" if fused else "main_path_unfused", card=card, fused=sim.fused,
        particles=int(x.shape[0]), K=sim.block_capacity,
        substeps=substeps, timed_substeps=n_timed, ms_per_substep=timed_s * 1e3 / n_timed,
        particle_steps_per_s=x.shape[0] * n_timed / timed_s, n_sorts=sim.n_sorts,
        warmup_frame_s=warm_s, setup_s=setup_s,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        y_min=float(x[:, 1].min()), launches=launches,
        clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"), failures=failures,
    ))
    raise_failures(failures)
    return sim, launches


def phase_stage_report(sim, card):
    """The unfused pipeline's stages at the 8M state, ms per substep."""
    from taichi_mpm_torch import diagnostics

    emit(dict(phase="stage_report", card=card,
              ms=diagnostics.stage_report(sim, substeps=5, repeats=2)))


def phase_breakdown(sim, card):
    """CUDA-event time of each stage of one substep at the main path's
    state (5 repetitions each; the sort 2)."""
    from taichi_mpm_torch.ops import blocked, g2p, p2g
    from taichi_mpm_torch.ops import packed
    from taichi_mpm_torch.ops.substep import grid_update_flat

    cfg, dt = sim.cfg, sim.cfg.base_dt
    st, _, pm, _ = sim.packed_carry
    col = tuple(sim.colliders)
    K = pm["ids"].shape[0]
    tiles = p2g.p2g_fused(pm["s_arr"], pm["e_arr"], st, dt, cfg)
    rec = blocked.merge_tiles(tiles, pm["nbr"])
    vrec = grid_update_flat(rec, pm["ids"], cfg, col, sim.t, dt)
    win = blocked.windows(vrec, pm["nbr"])
    scratch = st.clone()
    stages = {
        "p2g_kernel": cuda_ms(lambda: p2g.p2g_fused(pm["s_arr"], pm["e_arr"], st, dt, cfg), 5),
        "merge_tiles": cuda_ms(lambda: blocked.merge_tiles(tiles, pm["nbr"]), 5),
        "grid_update": cuda_ms(lambda: grid_update_flat(rec, pm["ids"], cfg, col, sim.t, dt), 5),
        "windows": cuda_ms(lambda: blocked.windows(vrec, pm["nbr"]), 5),
        "g2p_kernel": cuda_ms(lambda: g2p.g2p_fused(pm["slot_keys"], scratch, win, dt, cfg), 5),
        "sort_and_map": cuda_ms(lambda: packed.sort_and_map(st, cfg, K), 2),
    }
    emit(dict(phase="breakdown", card=card, ms=stages,
              substep_stages_ms=sum(v for k, v in stages.items() if k != "sort_and_map")))


def phase_profile(sim, card, phase="profile"):
    """One frame under torch.profiler: the device's busy time (the sum of
    its kernels' and copies' times) over the frame's wall time, and the
    kernels that take the most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step()
        sim.sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    by_name = {}  # kernel names cut to 80 characters; templates that share a head add up
    for e in on_device:
        by_name[e.key[:80]] = by_name.get(e.key[:80], 0.0) + e.self_device_time_total / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])
    emit(dict(
        phase=phase, card=card, frame_wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=(1.0 - busy_ms / wall_ms) if busy_ms > 0 else None,
        top_ms_per_frame=top,
    ))


def phase_kernels(sim, card):
    """Each kernel at the 8M shapes: its time, its plain version's time,
    its error against the plain version (on the state stirred), and its
    bound. Returns the measurements of each kernel."""
    import torch

    from taichi_mpm_torch.ops import g2p, p2g

    cfg, dt = sim.cfg, sim.cfg.base_dt
    st, _, pm, _ = sim.packed_carry
    K = pm["ids"].shape[0]
    n_live = min(int(pm["n_act"]), K)  # slots whose tiles and windows are read
    pw = st.shape[1]
    n_in = int((pm["e_arr"] - pm["s_arr"]).sum())  # particles in slot ranges
    n_act = int((st[36] > 0.5).sum())
    n_keyed = int((pm["slot_keys"] < K).sum())  # lanes whose window the gather reads

    win = g2p_windows(sim, st, pm)
    scratch = st.clone()
    keys = pm["slot_keys"]
    pdata = p2g.prep_packed(st, cfg, dt)
    s_arr, e_arr = pm["s_arr"], pm["e_arr"]
    times = {
        "p2g_fused": (cuda_ms(lambda: p2g.p2g_fused(pm["s_arr"], pm["e_arr"], st, dt, cfg), 10),
                      cuda_ms(lambda: p2g.p2g_fused_plain(pm["s_arr"], pm["e_arr"], st, dt, cfg),
                              3)),
        "g2p_fused": (cuda_ms(lambda: g2p.g2p_fused(keys, scratch, win, dt, cfg), 10),
                      cuda_ms(lambda: g2p.g2p_fused_plain(keys, scratch, win, dt, cfg), 3)),
        "g2p_blocked": (cuda_ms(lambda: g2p.g2p_blocked(keys, st, win, cfg), 10),
                        cuda_ms(lambda: g2p.g2p_blocked_plain(keys, st, win, cfg), 3)),
        "p2g_blocked": (cuda_ms(lambda: p2g.p2g_blocked(s_arr, e_arr, pdata), 10),
                        cuda_ms(lambda: p2g.p2g_blocked_plain(s_arr, e_arr, pdata), 3)),
    }
    share = staged_share(keys, st, K)
    del win, scratch, pdata

    failures = []
    checks = compare_kernels(sim, stirred(st), failures)
    emit(dict(phase="kernel_checks", card=card, particles=n_act, **checks,
              g2p_fused_staged_share=share,
              ms={k: v[0] for k, v in times.items()},
              plain_ms={k: v[1] for k, v in times.items()}, failures=failures))
    raise_failures(failures)
    torch.cuda.synchronize()

    windows_bytes = n_live * 3 * 343
    fused = fused_work(st, pm)
    work = {
        "p2g_fused": (*fused["p2g_fused"], checks["p2g_max_abs_err"]),
        "g2p_fused": (*fused["g2p_fused"], checks["g2p_max_abs_err"]),
        "g2p_blocked": (4 * (pw + GATHER_ROWS_READ * n_keyed + GATHER_ROWS_WRITTEN * pw
                             + windows_bytes),
                        G2P_OPS_GATHER * n_keyed, checks["g2p_blocked_max_abs_err"]),
        # the operand rows of each lane in a slot range read once, the live
        # slots' tiles written once, the ranges read
        "p2g_blocked": (4 * (P2G_OPERAND_ROWS * n_in + 2 * K + n_live * 343 * 4),
                        (P2G_OPS_WEIGHTS + P2G_OPS_SCATTER) * n_in,
                        checks["p2g_blocked_max_abs_err"]),
    }
    out = {}
    for name, (nbytes, ops, err) in work.items():
        b_ms, b_by = bound(nbytes, ops)
        out[name] = dict(ms=times[name][0], plain_ms=times[name][1], max_abs_err=err,
                         bound_ms=b_ms, bound_by=b_by,
                         bytes=nbytes, ops=ops, live_slots=n_live, slots=K)
    return out


KERNEL_SOURCES = {
    "p2g_fused": ("taichi_mpm_torch/csrc/p2g.cu", "taichi_mpm_tpu/ops/fused_pallas.py:301"),
    "g2p_fused": ("taichi_mpm_torch/csrc/g2p.cu", "taichi_mpm_tpu/ops/fused_pallas.py:377"),
    "g2p_blocked": ("taichi_mpm_torch/csrc/g2p.cu", "taichi_mpm_tpu/ops/g2p_pallas.py:277"),
    # one kernel for both TPU entry points (p2g_blocked_batched, p2g_blocked)
    "p2g_blocked": ("taichi_mpm_torch/csrc/p2g.cu",
                    "taichi_mpm_tpu/ops/p2g_pallas.py:318, taichi_mpm_tpu/ops/p2g_pallas.py:362"),
}


def kernels_line(measured, launches_by_path, dam_ms, by_material):
    """The kernels line: each kernel's measurements at 8M, its time at
    the 1.4M dam's state, its launches on each main path (``launches``
    is their sum), and for the fused kernels their time and bound at the
    8M state made of each material (``by_material``)."""
    line = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        by_path = {path: counts[name] for path, counts in launches_by_path.items()}
        m = measured[name]
        line.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=sum(by_path.values()), launches_by_path=by_path,
                         max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
                         bound_ms=m["bound_ms"], bound_by=m["bound_by"], library_ms=None,
                         dam_ms=dam_ms[name],
                         bytes=m["bytes"], ops=m["ops"], live_slots=m["live_slots"],
                         slots=m["slots"], by_material=by_material.get(name)))
    return line


# -- the CPIC path ----------------------------------------------------------------

CPIC_BOUNDS = (("x", 5e-6), ("v", 5e-4), ("F", 5e-5))
CPIC_KERNELS = ("p2g_fused", "g2p_blocked")
BODY_BOUNDS = (("vel", 1e-5), ("omega", 1e-5), ("pos", 1e-6))


def cpic_check_scene(device, material="water"):
    """The small wheel scene of the card-vs-CPU check: the CPIC benchmark
    scene with 10,000 water (or sand) particles placed on the right-hand
    paddles and falling at 1 m/s, so that the coupling acts from the
    first substep."""
    from taichi_mpm_torch import scenes

    sim = scenes.cpic_wheel(n=10_000, res=96, lo=(0.5, 0.3, 0.42), hi=(0.68, 0.62, 0.58),
                            vel=(0.0, -1.0, 0.0), device=device, material=material)
    sim.frame_dt = 6 * sim.cfg.base_dt
    return sim


def phase_cpic_check(material="water"):
    """6 coupled substeps on the card and on the CPU; the card twice, the
    first time with each kernel of the CPIC frame launched once per
    substep. With sand in place of the water it is the coupled frame of
    scripts/mls-cpic/sand_*.py (phase cpic_sand_check)."""
    from taichi_mpm_torch import convert

    sims = {dev: cpic_check_scene(dev, material) for dev in ("cuda", "cpu")}
    rerun = cpic_check_scene("cuda", material)
    zero_counts()
    sims["cuda"].step()
    failures = route_failures(read_counts(), True, 6, CPIC_KERNELS)
    for sim in (sims["cpu"], rerun):
        sim.step()
    gs, cs = sims["cuda"], sims["cpu"]
    g, c = gs.particles, cs.particles
    first = convert.particles_to_numpy(g)
    deterministic = True
    for name, arr in convert.particles_to_numpy(rerun.particles).items():
        if arr.tobytes() != first[name].tobytes():
            deterministic = False
            failures.append(f"the card's CPIC frame is not deterministic: {name} differs")
    for name in ("pos", "vel", "rot", "omega"):
        if not np.array_equal(getattr(gs.bodies, name).cpu().numpy(),
                              getattr(rerun.bodies, name).cpu().numpy()):
            deterministic = False
            failures.append(f"the card's CPIC frame is not deterministic: body {name} differs")
    act = c.active.numpy()
    if not np.array_equal(g.active.cpu().numpy(), act):
        failures.append("card and CPU CPIC frames keep other particles")
    act &= g.active.cpu().numpy()
    errs = {}
    for name, bound in CPIC_BOUNDS:
        errs[name] = float(np.abs(getattr(g, name).cpu().numpy()[act].astype(np.float64)
                                  - getattr(c, name).numpy()[act].astype(np.float64)).max())
        if not errs[name] <= bound:
            failures.append(f"card vs CPU CPIC frame: {name} differs by {errs[name]} > {bound}")
    for name in ("states", "near_b"):
        if not np.array_equal(getattr(g, name).cpu().numpy()[act], getattr(c, name).numpy()[act]):
            failures.append(f"card vs CPU CPIC frame: {name} differ")
    for name, bound in BODY_BOUNDS:
        errs["body_" + name] = float(np.abs(getattr(gs.bodies, name).cpu().numpy()
                                            - getattr(cs.bodies, name).numpy()).max())
        if not errs["body_" + name] <= bound:
            failures.append(f"card vs CPU CPIC frame: body {name} differs by "
                            f"{errs['body_' + name]} > {bound}")
    if gs.cpic_stats != cs.cpic_stats or gs.n_sorts != cs.n_sorts:
        failures.append(f"card and CPU CPIC frames count otherwise: {gs.cpic_stats} vs "
                        f"{cs.cpic_stats}")
    if gs.cpic_stats["n_near"] == 0:
        failures.append("no particle was near the wheel: the coupling went untested")
    emit(dict(phase="cpic_check" if material == "water" else f"cpic_{material}_check",
              particles=int(act.sum()), frame_vs_cpu=errs,
              deterministic=deterministic, stats=gs.cpic_stats,
              Kr=gs.cpic_caps.Kr, near_b=int(g.near_b.sum()),
              wheel_omega_z=float(gs.bodies.omega[2, 2]), failures=failures))
    raise_failures(failures)


def phase_cpic_path(card):
    """The full CPIC benchmark scene: warm-up frames, timed frames,
    checks. Returns (sim, launches)."""
    import torch

    from taichi_mpm_torch import scenes
    from taichi_mpm_torch.utils import HostSyncs

    t0 = time.perf_counter()
    sim = scenes.cpic_wheel(device="cuda")
    sim.frame_dt = SUBSTEPS_PER_FRAME * sim.cfg.base_dt
    sim._ensure_finalized()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    peak = dict(n_near=0, n_coarse=0, n_r=0)
    t0 = time.perf_counter()
    for _ in range(CPIC_WARM_FRAMES):
        sim.step()
        peak = {k: max(v, sim.cpic_stats[k]) for k, v in peak.items()}
    sim.sync()
    warm_s = time.perf_counter() - t0
    HostSyncs.count = 0
    t0 = time.perf_counter()
    for _ in range(CPIC_TIMED_FRAMES):
        sim.step()
        peak = {k: max(v, sim.cpic_stats[k]) for k, v in peak.items()}
    sim.sync()
    timed_s = time.perf_counter() - t0
    syncs = HostSyncs.count
    launches = read_counts()
    failures = []
    # the kernels against their plain versions at this path's shapes: the
    # wheel's state after the timed frames, stirred, with aux spread
    kernel_checks = compare_kernels(sim, stirred(sim.packed_carry[0], aux_sd=0.1), failures)

    substeps = (CPIC_WARM_FRAMES + CPIC_TIMED_FRAMES) * SUBSTEPS_PER_FRAME
    failures += route_failures(launches, True, substeps, CPIC_KERNELS)
    x = check_domain(sim, 100_000, failures)
    n_active = int(x.shape[0])
    omega_z = float(sim.bodies.omega[2, 2])
    if not (np.isfinite(omega_z) and omega_z != 0.0):
        failures.append(f"the wheel does not turn: omega_z = {omega_z}")
    n_timed = CPIC_TIMED_FRAMES * SUBSTEPS_PER_FRAME
    emit(dict(
        phase="cpic_path", card=card, particles=n_active, K=sim.block_capacity,
        substeps=substeps, timed_substeps=n_timed, ms_per_substep=timed_s * 1e3 / n_timed,
        particle_steps_per_s=n_active * n_timed / timed_s,
        host_syncs_per_substep=syncs / n_timed, n_sorts=sim.n_sorts,
        max_n_near=peak["n_near"], max_n_coarse=peak["n_coarse"],
        max_n_r=peak["n_r"], Kr_capacity=sim.cpic_caps.Kr, wheel_omega_z=omega_z,
        hub_omega_z=float(sim.bodies.omega[1, 2]), warmup_s=warm_s, setup_s=setup_s,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, y_min=float(x[:, 1].min()),
        launches=launches, kernel_checks=kernel_checks,
        clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"), failures=failures,
    ))
    raise_failures(failures)
    return sim, launches, syncs / n_timed


def phase_cpic_breakdown(sim, card):
    """CUDA-event time of each stage of the coupled substep, summed over
    one frame and divided by its substeps (the state is not advanced).
    The first stage, the prologue, also holds the frame's reads between
    substeps (drift, staleness)."""
    import torch

    from taichi_mpm_torch.rigid import cpic_packed

    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    torch.cuda.synchronize()
    mark("start")
    t0 = time.perf_counter()
    cpic_packed.cpic_packed_frame_carry(
        sim.packed_carry, sim.bodies, sim.t, sim.cfg, sim.rigid_scene, sim.cfg.base_dt,
        SUBSTEPS_PER_FRAME, sim.cpic_caps, marks=mark)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stages = {}
    for (_, a), (name, b) in zip(events, events[1:]):
        stages[name] = stages.get(name, 0.0) + a.elapsed_time(b) / SUBSTEPS_PER_FRAME
    emit(dict(phase="cpic_breakdown", card=card, ms_per_substep=stages,
              stages_sum_ms=sum(stages.values()), frame_wall_ms_per_substep=wall_ms
              / SUBSTEPS_PER_FRAME))


# -- global adaptive dt ---------------------------------------------------------


def phase_dam_check():
    """One adaptive frame of the dam at res 32 on the card, on each route,
    against the CPU: the same substeps, the bounds of the cube frames."""
    from taichi_mpm_torch import scenes

    def dam(device, fused):
        sim = on_route(fused, lambda: scenes.water_dam(res=32, device=device))
        sim.frame_dt = 5e-4
        sim.step()
        return sim

    cpu = dam("cpu", True)
    failures, out = [], dict(phase="dam_check", particles=int(cpu.particles.count()),
                             substeps=cpu.last_substeps, dt_range=cpu.last_dt_range)
    for fused in (True, False):
        card = dam("cuda", fused)
        route = "fused" if fused else "unfused"
        if card.last_substeps != cpu.last_substeps:
            failures.append(f"dam {route}: {card.last_substeps} substeps on the card, "
                            f"{cpu.last_substeps} on the CPU")
        out[f"{route}_vs_cpu"] = frame_errors(card, cpu, f"dam {route} card vs CPU", failures)
    emit(dict(out, failures=failures))
    raise_failures(failures)


def adaptive_frames(sim, n_frames):
    """Step `sim` (an AsyncMPM) `n_frames` frames; per frame its substeps,
    dt range, wall time (fenced), ms and host syncs per substep."""
    from taichi_mpm_torch.utils import HostSyncs

    frames = []
    for _ in range(n_frames):
        syncs = HostSyncs.count
        t0 = time.perf_counter()
        sim.step()
        sim.sync()
        wall = time.perf_counter() - t0
        n = sim.last_substeps
        frames.append(dict(substeps=n, dt_min=sim.last_dt_range[0], dt_max=sim.last_dt_range[1],
                           wall_s=wall, ms_per_substep=wall * 1e3 / n,
                           host_syncs_per_substep=(HostSyncs.count - syncs) / n,
                           update_counter=sim.update_counter))
    return frames


def summary(frames, n_particles):
    """ms and host syncs per substep, particle-steps/s over `frames`."""
    n = sum(f["substeps"] for f in frames)
    wall = sum(f["wall_s"] for f in frames)
    syncs = sum(f["host_syncs_per_substep"] * f["substeps"] for f in frames)
    return dict(timed_substeps=n, ms_per_substep=wall * 1e3 / n,
                particle_steps_per_s=n_particles * n / wall, host_syncs_per_substep=syncs / n)


def phase_dam(card, fused):
    """The dam break at res 128 (1,410,048 water particles) on one route:
    a warm-up frame and ADAPTIVE_TIMED_FRAMES timed frames of 0.01 s."""
    import torch

    from taichi_mpm_torch import scenes

    t0 = time.perf_counter()
    sim = on_route(fused, lambda: scenes.water_dam(res=128, device="cuda"))
    sim._ensure_finalized()
    n = int(sim.particles.count())
    setup_s = time.perf_counter() - t0
    zero_counts()
    frames = adaptive_frames(sim, 1 + ADAPTIVE_TIMED_FRAMES)
    launches = read_counts()
    substeps = sum(f["substeps"] for f in frames)
    failures = route_failures(launches, fused, substeps)
    x = check_domain(sim, n, failures)
    if sim.update_counter != substeps * n:
        failures.append(f"update counter {sim.update_counter} != {substeps} x {n}")
    kernels = {}
    if fused:  # the kernels on the dam's state, after the counts are read
        st, _, pm, _ = sim.packed_carry
        kernels = dict(kernel_ms=kernel_ms(sim), g2p_fused_staged_share=staged_share(
            pm["slot_keys"], st, pm["ids"].shape[0]))
    timed = summary(frames[1:], n)
    emit(dict(phase="dam", card=card, fused=sim.fused, particles=n, K=sim.block_capacity,
              substeps=substeps, frames=frames, **timed,
              n_sorts=sim.n_sorts, setup_s=setup_s, y_min=float(x[:, 1].min()),
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
              **kernels, clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"),
              failures=failures))
    raise_failures(failures)
    return launches, kernels.get("kernel_ms"), timed


def phase_cpic_adaptive(card, fixed_syncs):
    """The CPIC wheel's 100k water and bodies through AsyncMPM (fused
    route), the water placed on the paddles: a warm-up frame and
    ADAPTIVE_TIMED_FRAMES timed frames of 20 base dt (2e-3 s). Its host
    syncs per substep must not exceed the fixed-dt frames' (`fixed_syncs`,
    measured in this run)."""
    from taichi_mpm_torch import scenes
    from taichi_mpm_torch.core.adaptive import AsyncMPM

    sim = scenes.cpic_wheel(device="cuda", lo=(0.5, 0.3, 0.42), hi=(0.68, 0.62, 0.58),
                            vel=(0.0, -1.0, 0.0), solver=AsyncMPM, unit_delta_t=1e-6)
    sim.frame_dt = SUBSTEPS_PER_FRAME * sim.cfg.base_dt
    zero_counts()
    frames = adaptive_frames(sim, 1 + ADAPTIVE_TIMED_FRAMES)
    launches = read_counts()
    substeps = sum(f["substeps"] for f in frames)
    failures = route_failures(launches, True, substeps, CPIC_KERNELS)
    check_domain(sim, 100_000, failures)
    timed = summary(frames[1:], 100_000)
    if timed["host_syncs_per_substep"] > fixed_syncs:
        failures.append(f"adaptive CPIC makes {timed['host_syncs_per_substep']} host syncs "
                        f"per substep, the fixed-dt frame {fixed_syncs}")
    if sim.cpic_stats["n_near"] == 0:
        failures.append("no particle was near the wheel: the coupling went untested")
    emit(dict(phase="cpic_adaptive", card=card, particles=100_000, substeps=substeps,
              frames=frames, **timed, fixed_dt_host_syncs_per_substep=fixed_syncs,
              stats=sim.cpic_stats, wheel_omega_z=float(sim.bodies.omega[2, 2]),
              launches=launches, failures=failures))
    raise_failures(failures)
    return launches

# -- the scene-script path ------------------------------------------------------

SCRIPT_DAM_PARTICLES = 1_056_758  # scripts/async/water.py's seeding at res 128 (CPU numpy)
SCRIPT_DAM_TIMED_FRAMES = 3  # after one warm-up frame
RESUME_FRAME_DT = 5e-4
ID_ROW_PARAM = 7  # a params slot no material reads: each particle's index goes there
# tests/port/test_torch_energy.py's tolerance: |E_card - E_cpu| over the sum
# of the magnitudes of the kinetic, elastic and gravitational terms
ENERGY_RTOL = 1e-5
EMISSION_FRAMES = 3
EMISSION_FRAME_DT = 1e-3  # the runner's --frame-dt for the sand paddles


class Timed:
    """A scene whose step, visualize, save and energy calls are timed on
    the host clock, fenced by torch.cuda.synchronize, with each step's
    substeps and host syncs; every other attribute is the scene's, so
    ``runner.simulate`` drives it as the scene itself."""

    TIMED = ("step", "visualize", "save", "energy")

    def __init__(self, sim):
        object.__setattr__(self, "sim", sim)
        object.__setattr__(self, "ms", {name: [] for name in self.TIMED})
        object.__setattr__(self, "energies", [])
        object.__setattr__(self, "steps", [])

    def __getattr__(self, name):
        attr = getattr(self.sim, name)
        if name not in self.TIMED:
            return attr

        def timed(*a, **k):
            import torch

            from taichi_mpm_torch.utils import HostSyncs

            torch.cuda.synchronize()
            syncs, t0 = HostSyncs.count, time.perf_counter()
            out = attr(*a, **k)
            torch.cuda.synchronize()
            self.ms[name].append((time.perf_counter() - t0) * 1e3)
            if name == "step":
                self.steps.append(dict(substeps=self.sim.last_substeps,
                                       host_syncs=HostSyncs.count - syncs))
            if name == "energy":
                self.energies.append(out)
            return out

        return timed

    def __setattr__(self, name, value):
        setattr(self.sim, name, value)


def tag_ids(sim):
    """Write each particle's slot index into params[:, ID_ROW_PARAM] of a
    finalized scene, so that a resumed run (sorted afresh) can be matched
    to the run it was cut from particle by particle."""
    import torch

    p = sim.particles
    p.params[:, ID_ROW_PARAM] = torch.arange(p.capacity, dtype=torch.float32, device=p.device)
    sim._set_particles(p)


def id_errors(a, b, label, failures, bounds=FRAME_BOUNDS):
    """Two scenes' particles matched by their id tags: the same particles
    alive, the fields within `bounds`. Returns the errors."""
    from taichi_mpm_torch import convert

    def by_id(sim):
        arr = convert.particles_to_numpy(sim.particles)
        act = arr["active"]
        order = np.argsort(arr["params"][act, ID_ROW_PARAM], kind="stable")
        return {k: v[act][order] for k, v in arr.items()}

    pa, pb = by_id(a), by_id(b)
    if not np.array_equal(pa["params"][:, ID_ROW_PARAM], pb["params"][:, ID_ROW_PARAM]):
        failures.append(f"{label}: other particles alive")
        return {}
    errs = {}
    for name, bnd in bounds:
        errs[name] = float(np.abs(pa[name].astype(np.float64) - pb[name].astype(np.float64)).max())
        if not errs[name] <= bnd:
            failures.append(f"{label}: {name} differs by {errs[name]} > {bnd}")
    return errs


def same_bits(a, b, label, failures):
    """Two scenes' particles (every field) and times equal in bits."""
    from taichi_mpm_torch import convert

    pa, pb = convert.particles_to_numpy(a.particles), convert.particles_to_numpy(b.particles)
    diff = [name for name in pa if pa[name].tobytes() != pb[name].tobytes()]
    if diff or a.t != b.t:
        failures.append(f"{label}: not the same bits ({diff}, t {a.t} vs {b.t})")
    return not diff


def phase_script_dam(card, lattice):
    """scripts/async/water.py at res 128 through runner.simulate on the
    card: seeded from its texture (1,056,758 particles, the CPU's seeding
    bit for bit), a warm-up frame and SCRIPT_DAM_TIMED_FRAMES timed frames
    of 0.01 s, verbose BGEO every frame into a temporary directory, a
    snapshot after frame 1 and a copy of the scene there (the
    uninterrupted run of ``script_resume``), the energy every frame.
    `lattice` is the lattice dam's summary (phase ``dam``) of this run.
    Returns the launches and what script_resume needs."""
    import copy
    import tempfile

    import torch

    from taichi_mpm_torch import diagnostics, runner, scenes
    from taichi_mpm_torch.io import bgeo

    failures = []
    t0 = time.perf_counter()
    bgeo.native_lib()  # built with g++ at first use: outside the frames' BGEO times
    bgeo_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = scenes.water_script(res=128, device="cuda")
    seed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim._ensure_finalized()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    cpu_seed = scenes.water_script(res=128, device="cpu")._pending[0]["x"]
    n = sim.particles.count()
    if not n == len(cpu_seed) == SCRIPT_DAM_PARTICLES:
        failures.append(f"{n:,} particles seeded, the CPU seeds {len(cpu_seed):,}")
    elif not np.array_equal(sim.positions(), cpu_seed):
        failures.append("the seeded positions differ from the CPU's")
    tag_ids(sim)
    torch.cuda.reset_peak_memory_stats()

    out = tempfile.TemporaryDirectory(prefix="chip_smoke_script_dam_")
    args = runner.parse_args(["--frames", str(1 + SCRIPT_DAM_TIMED_FRAMES), "--out", out.name,
                              "--verbose-bgeo"])
    timed = Timed(sim)
    kept = dict(dir=out, snapshot=runner.snapshot_path(out.name, 1))

    def snapshot_after_frame_1(s, f):
        if f == 2:
            s.save(kept["snapshot"])
            kept["uninterrupted"] = copy.deepcopy(sim)

    zero_counts()
    runner.simulate(timed, args, frame_update=snapshot_after_frame_1, print_energy=True)
    launches = read_counts()
    substeps = [st["substeps"] for st in timed.steps]
    failures += route_failures(launches, True, sum(substeps))
    check_domain(sim, n, failures)
    if sim.update_counter != sum(substeps) * n:
        failures.append(f"update counter {sim.update_counter} != {sum(substeps)} x {n}")
    if not all(np.isfinite(e) for e in timed.energies) or len(timed.energies) != len(substeps):
        failures.append(f"energies {timed.energies}")
    last = runner.frame_path(out.name, SCRIPT_DAM_TIMED_FRAMES)
    pos, attrs = bgeo.read_bgeo(last)
    p = sim.particles
    act = p.active
    want = {"v": p.v[act], "mass": p.mass[act], "boundary": p.near_b[act].float(),
            "distance": p.bdist[act]}
    if not np.array_equal(pos, sim.positions()):
        failures.append("the last BGEO's positions are not the scene's")
    for name, a in want.items():
        if not np.array_equal(attrs[name], a.cpu().numpy()):
            failures.append(f"the last BGEO's {name} is not the scene's")

    timed_steps = timed.steps[1:]
    step_s = sum(timed.ms["step"][1:]) / 1e3
    n_timed = sum(st["substeps"] for st in timed_steps)
    bgeo_bytes = os.path.getsize(last)
    save_bytes = os.path.getsize(kept["snapshot"])
    emit(dict(phase="script_dam", card=card, particles=n, seed_s=seed_s, upload_s=upload_s,
              bgeo_build_s=bgeo_build_s,
              K=sim.block_capacity, substeps=substeps, timed_substeps=n_timed,
              ms_per_substep=step_s * 1e3 / n_timed,
              particle_steps_per_s=n * n_timed / step_s,
              host_syncs_per_substep=sum(st["host_syncs"] for st in timed_steps) / n_timed,
              lattice_dam=lattice, frame_ms=timed.ms["step"],
              bgeo_ms=timed.ms["visualize"], bgeo_bytes=bgeo_bytes,
              bgeo_mb_per_s=[bgeo_bytes / 1e3 / ms for ms in timed.ms["visualize"]],
              save_ms=timed.ms["save"], save_bytes=save_bytes, energy_ms=timed.ms["energy"],
              energies=timed.energies, n_sorts=sim.n_sorts,
              memory=diagnostics.device_memory_report(), launches=launches,
              kernel_ms=kernel_ms(sim),
              clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"), failures=failures))
    raise_failures(failures)
    return launches, kept


def resume_check(make, snapshot, uninterrupted, frame_dt, label, failures):
    """Two fresh scenes (make()) load `snapshot` and step a frame of
    `frame_dt`: the same bits and substeps; the uninterrupted scene steps
    the same frame: within the frame bounds, particle by particle, with
    the same substeps. Returns the errors and load times."""
    import torch

    resumed, load_ms = [], []
    for _ in range(2):
        sim = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.load(snapshot)
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t0) * 1e3)
        sim.step(frame_dt)
        resumed.append(sim)
    a, b = resumed
    out = dict(load_ms=load_ms, load_bytes=os.path.getsize(snapshot),
               bits_equal=same_bits(a, b, f"{label}: two resumes", failures))
    uninterrupted.step(frame_dt)
    subs = [getattr(s, "last_substeps", None) for s in (a, b, uninterrupted)]
    if len(set(subs)) != 1:
        failures.append(f"{label}: substeps {subs} (resumed, resumed, uninterrupted)")
    if uninterrupted.t != a.t:
        failures.append(f"{label}: t {a.t} resumed, {uninterrupted.t} uninterrupted")
    out.update(substeps=subs[0], vs_uninterrupted=id_errors(
        a, uninterrupted, f"{label}: resumed vs uninterrupted", failures))
    return out


def phase_script_resume(kept):
    """From script_dam's snapshot, a frame of RESUME_FRAME_DT: two fresh
    scenes that load it give the same bits and substeps, and the scene
    copied at the snapshot (the uninterrupted run) stays within the frame
    bounds of them with the same substeps. The same on the 125k jelly cube
    at fixed dt, snapshot after one 6-substep frame, over 6 substeps."""
    import copy

    from taichi_mpm_torch import scenes

    failures = []
    out = dict(phase="script_resume")
    out["dam"] = resume_check(lambda: scenes.water_script(res=128, device="cuda"),
                              kept["snapshot"], kept.pop("uninterrupted"), RESUME_FRAME_DT,
                              "dam", failures)
    jelly = cube(25, "cuda", 6)
    jelly._ensure_finalized()
    tag_ids(jelly)
    jelly.step()
    path = os.path.join(kept["dir"].name, "jelly.npz")
    jelly.save(path)
    out["jelly_125k"] = resume_check(lambda: cube(25, "cuda", 6), path, copy.deepcopy(jelly),
                                     None, "jelly cube", failures)
    kept["dir"].cleanup()
    emit(dict(out, failures=failures))
    raise_failures(failures)


def energy_of(p, cfg):
    """(MPM.energy's mechanical energy, the sum of the magnitudes of its
    kinetic, elastic and gravitational terms) of particles `p`."""
    import torch

    from taichi_mpm_torch.core.solver import mechanical_energy
    from taichi_mpm_torch.materials import models

    act = p.active
    m = torch.where(act, p.mass, 0.0).double()
    pot = models.dispatch_potential_energy(cfg.active_materials, p.mat, p.F, p.aux, p.params,
                                           p.vol)
    g = torch.tensor(cfg.gravity, dtype=torch.float64, device=p.device)
    scale = float((0.5 * m * (p.v.double() ** 2).sum(-1)).abs().sum()
                  + torch.where(act, pot, 0.0).double().abs().sum()
                  + (m * (p.x.double() @ g)).abs().sum())
    return float(mechanical_energy(p, cfg)), scale


def phase_energy_check():
    """For each material: the 125k cube after one 6-substep frame on the
    card and on the CPU, MPM.energy() of each (within ENERGY_RTOL); then
    the card's state stirred (F far from I, spinning), its energy on the
    card against the same state's on the CPU (within ENERGY_RTOL)."""
    from taichi_mpm_torch.ops import packed

    failures, out = [], {}
    for name in MATERIALS:
        card, cpu = cube(25, "cuda", 6, name), cube(25, "cpu", 6, name)
        card.step()
        cpu.step()
        e_card, e_cpu = card.energy(), cpu.energy()
        _, scale = energy_of(cpu.particles, cpu.cfg)
        st = stirred(card.packed_carry[0], aux_sd=0.05)
        p = packed.unpack_particles(st, card.particles.capacity)
        s_card, s_scale = energy_of(p, card.cfg)
        s_cpu, _ = energy_of(packed.unpack_particles(st.cpu(), card.particles.capacity), card.cfg)
        res = dict(frame_card=e_card, frame_cpu=e_cpu, frame_rel=abs(e_card - e_cpu) / scale,
                   stirred_card=s_card, stirred_cpu=s_cpu,
                   stirred_rel=abs(s_card - s_cpu) / s_scale)
        for key in ("frame_rel", "stirred_rel"):
            if not res[key] <= ENERGY_RTOL:
                failures.append(f"{name}: {key} {res[key]} > {ENERGY_RTOL}")
        out[name] = res
        del card, cpu, st, p
    emit(dict(phase="energy_check", **out, failures=failures))
    raise_failures(failures)


def phase_emission_check():
    """scripts/mls-cpic/sand_paddles.py at res 64 (two scripted paddle
    wheels, sand from a source every frame), EMISSION_FRAMES frames of
    EMISSION_FRAME_DT on the card and on the CPU: the same sand emitted
    every frame, the frames within the CPIC bounds of cpic_check, states
    and near_b equal, the bodies within 1e-5 / 1e-6; on the card each
    kernel of the CPIC frame launched once per substep."""
    from taichi_mpm_torch import scenes

    sims = {dev: scenes.sand_paddles(res=64, device=dev) for dev in ("cuda", "cpu")}
    failures, frames = [], []
    zero_counts()
    for f in range(EMISSION_FRAMES):
        counts = {}
        for dev, sim in sims.items():
            sim.frame_dt = EMISSION_FRAME_DT
            before = sim.particles.count() if sim.particles is not None else 0
            scenes.sand_paddles_source(sim, f)
            sim.step()
            counts[dev] = sim.particles.count() - before
        g, c = sims["cuda"], sims["cpu"]
        if counts["cuda"] != counts["cpu"] or counts["cuda"] <= 0:
            failures.append(f"frame {f}: emitted {counts}")
        gp, cp = g.particles, c.particles
        act = gp.active.cpu().numpy()
        if not np.array_equal(act, cp.active.numpy()):
            failures.append(f"frame {f}: card and CPU keep other particles")
            break
        errs = {}
        for name, bnd in CPIC_BOUNDS:
            errs[name] = max_abs(getattr(gp, name)[gp.active].cpu(), getattr(cp, name)[cp.active])
            if not errs[name] <= bnd:
                failures.append(f"frame {f} card vs CPU: {name} differs by {errs[name]} > {bnd}")
        for name in ("states", "near_b"):
            if not np.array_equal(getattr(gp, name).cpu().numpy()[act],
                                  getattr(cp, name).numpy()[act]):
                failures.append(f"frame {f} card vs CPU: {name} differ")
        for name, bnd in BODY_BOUNDS:
            errs["body_" + name] = max_abs(getattr(g.bodies, name).cpu(), getattr(c.bodies, name))
            if not errs["body_" + name] <= bnd:
                failures.append(f"frame {f}: body {name} differs by {errs['body_' + name]}")
        frames.append(dict(emitted=counts["cuda"], particles=g.particles.count(), **errs))
    substeps = EMISSION_FRAMES * round(EMISSION_FRAME_DT / sims["cuda"].cfg.base_dt)
    launches = read_counts()  # the CPU frames launch no kernel
    failures += route_failures(launches, True, substeps, CPIC_KERNELS)
    emit(dict(phase="emission_check", frames=frames, launches=launches, failures=failures))
    raise_failures(failures)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--kernel-tree"]:
        kernel_tree(*sys.argv[2:3])
        return 0
    # the port itself: fails here when the script stands outside a checkout
    from taichi_mpm_torch.ops import cuda_build

    card = nvidia_smi()
    print(card, flush=True)
    emit(dict(phase="card", card=card, torch=torch.__version__, cuda=torch.version.cuda))
    t0 = time.perf_counter()
    libraries = [(src, mats) for src in ("p2g", "g2p") for mats in LIBRARY_SETS]
    per_library = cuda_build.build(*libraries)
    emit(dict(phase="build", seconds=time.perf_counter() - t0, seconds_per_library=per_library,
              ptxas={f"{src}_{mats}": cuda_build.ptxas_report(src, mats)
                     for src, mats in libraries}))
    emit(dict(phase="p2g_checksums", sha256=p2g_checksums()))
    emit(dict(phase="g2p_checksums", sha256=g2p_checksums()))
    phase_p2g_edges()
    phase_g2p_edges()

    launches = {}
    phase_cube25()
    phase_water25()
    phase_materials25()
    sim, launches["jelly_8m"] = phase_main_path(card)
    phase_profile(sim, card)  # steps one more frame: before the phases that share its state
    phase_breakdown(sim, card)
    measured = phase_kernels(sim, card)
    by_material = phase_material_kernels(sim, card)
    del sim
    sim, launches["jelly_8m_unfused"] = phase_main_path(card, fused=False)
    phase_stage_report(sim, card)
    del sim
    launches["sand_8m"] = phase_sand_path(card)
    phase_dam_check()
    launches["dam_fused"], dam_ms, lattice = phase_dam(card, fused=True)
    launches["dam_unfused"], _, _ = phase_dam(card, fused=False)
    launches["script_dam"], kept = phase_script_dam(card, lattice)
    phase_script_resume(kept)
    phase_energy_check()
    phase_emission_check()
    phase_cpic_check()
    phase_cpic_check("sand")
    phase_sand_column_check()
    sim, launches["cpic_wheel"], fixed_syncs = phase_cpic_path(card)
    phase_cpic_breakdown(sim, card)
    phase_profile(sim, card, phase="cpic_profile")
    del sim
    launches["cpic_wheel_adaptive"] = phase_cpic_adaptive(card, fixed_syncs)
    emit({"kernels": kernels_line(measured, launches, dam_ms, by_material)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
