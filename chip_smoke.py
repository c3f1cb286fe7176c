#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``taichi_mpm_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

The run has two blocks. The check block runs every phase that times
nothing (``CHECK_PHASES``: the card held to the CPU and to the kernels'
twins, the slab and pencil checks with the ranks they spawn) in
CHECK_LANES spawned processes at once, each phase's lines printed when
the block ends, while this process warms the CPIC wheel and the balls
for the timed paths (``cpic_warm_snapshot``, ``balls_snapshot``), then
runs the short checks itself (``PARENT_CHECK_PHASES``), and the rank
groups of the timed rank paths start up (``RankGroup``). The
timed block then runs every phase that times something, one at a time,
alone on the card. Phases, each printed as one JSON line:

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
   that gathered from shared memory. ``body_totals_check``: the kernel
   ``body_totals`` (``csrc/body_totals.cu``, the dense CPIC path's body
   impulse totals in particle order) against its twin on the CPU, in
   bits, on its edge inputs (``diagnostics.body_totals_edge_inputs``) and
   on the addends of both 2-D scripts' coupled substeps; two launches
   equal in bits.
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
   ``materials25`` (two lines, each half of the sets): for each of the
   six other materials, the set of
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
   0.01 s on the fused route, one on the unfused; per frame its substeps,
   smallest and largest dt,
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
   frames of 20 substeps: 50 warm-up frames, until the water has reached
   the wheel, in the check block (their launches counted there), saved;
   then, resumed from that state, every launch count set to 0, a frame
   and 5 timed frames, the counts read right after. Each kernel of the
   path must have launched once per substep, in the warm-up frames too;
   all 100,000 particles active, finite and in the domain; the
   wheel must turn (omega_z != 0). Then the kernel checks of phase 2 on
   the wheel's state, stirred with aux spread around 1: the P2G kernel's
   water branch and the gather-only G2P at the shapes this path gives
   them. Printed: ms/substep, particle-substeps per second, host syncs
   per substep, the largest near sets (exact and coarse) and the rigid
   page map's occupancy against its capacity Kr. ``cpic_breakdown``:
   CUDA-event time of each stage of a
   coupled substep, per substep over one frame; ``cpic_profile``: the
   idle share of one frame of 5 substeps.
10. ``cpic_adaptive``: the wheel's 100k water and
   bodies through ``AsyncMPM`` on the fused route, the water placed on
   the paddles as in ``cpic_check`` (from the default placement it would
   take ~2,800 adaptive substeps to reach the wheel): a warm-up frame and
   a timed frame of 2e-3 s, with their substeps, ms and host syncs per
   substep, which must not exceed the fixed-dt frames'. Each kernel of
   an adaptive path must have launched once per substep, no other.
11. ``script_dam``: ``scripts/async/water.py`` at res 128 through the
   port's runner (``scenes.water_script``, ``runner.simulate``): seeded
   from its texture (1,056,758 particles, bit for bit the CPU's seeding),
   a warm-up frame and 2 timed frames of 0.01 s, a verbose BGEO every
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
   jelly cube over 6 substeps at fixed dt. ``energy_check`` (two lines,
   after each ``materials25`` line, whose frames of the single-material
   cubes it reuses): each material's 125k cube, ``energy()`` of the
   card's frame against the CPU's, and of the card's state stirred
   against that state on the CPU, within 1e-5 of the sum of the terms'
   magnitudes.
   ``emission_check``: ``scripts/mls-cpic/sand_paddles.py`` at res 64
   (two scripted paddle wheels, capacity 50,000, the sand source every
   frame), 3 frames of 1e-3 s on the card and on the CPU: equal emitted
   counts, the CPIC bounds of ``cpic_check``, the CPIC kernels once per
   substep.
12. The dense path (``core/transfer.py``: torch scatters and gathers over
   the whole grid, as the JAX package's are XLA ops; it launches none of
   the kernels, and each dense phase checks that). ``dense_check``: a
   3-D scene of all eight materials (4,000 particles, res 32, a sticky
   box, the per-particle collision and the boundary clean-up on) at
   B-spline orders 1, 2 and 3, and the 2-D tetris scene
   (``demos/tetris.py``): one 6-substep frame on the card against the
   CPU's, held to the frame bounds of phase 2 (sand's aux to 7e-6,
   ``DENSE_SAND_BOUNDS``), plastic events equal but for sand's knife
   edges, a second card frame equal in bits; beside the sand lanes' gap,
   their one-ulp noise on the card and on the CPU, and a control frame
   with CUDA's approximate rsqrt, which must break the sand bounds.
   ``dense_vs_blocked``: the 125k jelly cube at rest (3 substeps),
   ``dense_all8`` at order 2 and ``oscillating_jello`` at res 50 (a frame
   each), each on the dense and on the fused route, both on the card,
   particles matched by id, within ``DENSE_VS_BLOCKED_BOUNDS`` (set from
   the card's, the CPU twins' and the JAX package's readings, under the
   bounds the JAX package holds its blocked path to). ``dense_path``:
   ``scripts/benchmark/colliding_balls_energy.py`` at res 100 through
   ``runner.simulate`` with its energy (67,044 Poisson-seeded jelly
   particles, 33 substeps per 0.01 s frame): a warm-up and 10 timed
   frames, ms per substep, particle-steps/s, host syncs per substep, the
   memory peak, each frame's energy and its drift, the first frame's
   energy against the CPU's within 1e-5 of its terms' magnitudes, every
   particle active, finite and in the domain. ``dense_adaptive``:
   ``AsyncMPM`` on the dense path, tests/test_adaptive.py's 2-D block and
   ``scripts/benchmark/oscillating_jello.py`` at res 50, a frame each on
   the card against the CPU's, with equal substep counts. ``dense_scale``:
   the 8M jelly cube on the dense path, a 6-substep frame beside the
   fused route's ms per substep of ``main_path``, the memory peak and the
   stages' CUDA-event ms.
13. The dense CPIC path (``rigid/cpic.py``: the coloured transfers over the
   dense grid CDF, 2-D bodies; its one kernel is ``body_totals``, twice a
   substep, and each phase checks that it launches no other).
   ``dense_cpic_check``: tests/test_cpic.py's 2-D plate,
   ``scripts/async/wheel.py`` and ``scripts/mls-cpic/sand_wheel_2D.py``
   at res 128 and the 10k wheel of ``cpic_check`` with optimized=False,
   the card against the CPU at the CPIC bounds of ``cpic_check``, equal
   adaptive substeps, reruns equal in bits. ``dense_cpic_vs_fused``: the
   10k wheel's 4 substeps on the dense and the fused CPIC frame on the
   card, at tests/test_cpic.py's oracle-vs-blocked bounds, beside the JAX
   package's own pair (``JAX_CPIC_PAIR``). ``wheel_2d_path``: both 2-D
   scripts through ``runner.simulate`` at res 128, resumed from their
   coupled snapshots (``WHEEL_2D_SNAPSHOTS``, the sand on the wheel) in
   0.01 s frames (ms per substep, particle-steps/s, host syncs, substeps
   and dt range, the wheel's omega, which must be finite and nonzero with
   sand near the wheel). ``wheel_2d_coupled``: both scripts from those
   snapshots, three 1e-3 s frames on the card against the CPU at the CPIC
   and body bounds, a rerun in bits; then each substep of the first frame
   from the CPU's state, stage by stage
   (``diagnostics.coupled_stage_partings``), gated (``stage_failures``).
   ``dense_cpic_scale``: the 100k CPIC wheel with optimized=False, a
   20-substep frame beside the fused CPIC frame's ms per substep of
   ``cpic_path``, the memory peak and the stages' CUDA-event ms, and
   ``body_totals`` timed on a substep's P2G and G2P totals of that state
   and of ``cpic_path``'s snapshot, beside its twin, ``index_add_`` and
   its bound.
14. The slabs (``DistributedMPM`` over ``torch.distributed``; the script
   needs one GPU, so its ranks share it and nothing here is a scaling
   number). ``dist_check``: the 125k cube (``benchmark_cube(cells=25,
   res=128)``) drifting at 12 m/s along x and spinning at 163 rad/s about
   z (``dist_cube``), 3 frames of 12 substeps on each route with uniform
   and balanced bounds, (a) one rank over NCCL in this process and (b)
   two ranks sharing the card over gloo, spawned (``comm.run_ranks``),
   the default route twice: each run held to ``MPM``'s frames on the
   card at the bounds of phase 2 (particles matched by an id tag), each
   kernel of its route once per substep per rank and no other, every
   particle kept, active, finite and in the domain, on two ranks
   migrants both ways and a balanced bound moved, the two default runs
   equal in bits. ``dist_path``: the 8M jelly cube at res 128 (125 does
   not divide into slab blocks) on two ranks sharing the card, fused and
   balanced, a warm-up and a timed frame of 20 substeps: ms and host
   syncs (``utils.HostSyncs``) per substep, re-sorts, migrants and
   bounds, each kernel once per substep per rank; one frame under
   torch's sync debug mode, whose warnings count every synchronizing
   CUDA call; one frame with a device sync around each record exchange
   and migration, for their ms per substep; all 8,000,000 particles
   kept, finite and in the domain; beside it the same scene through
   ``MPM``.
15. CPIC on slabs (``DistributedMPM`` with rigid bodies: the bodies
   replicated on every rank, the impulses all-reduced twice a substep;
   again no scaling number). ``dist_cpic_check``: the 10k wheel of
   ``cpic_check``, its water moved to straddle the slab boundary and
   sheared (``dist_cpic_scene``), 3 frames of 12 substeps on each CPIC
   slab frame (the packed frame on balanced and uniform bounds, the
   pytree frame on uniform bounds), (a) one rank over NCCL in this
   process, with its errors against ``MPM`` and whether they are 0 (and
   ``resort_and_shift``: ``MPM`` re-sorted at each frame's start, as the
   slab frames are, against ``MPM``; the one rank against it on the
   wheel and, equal in bits, on ``exact_shift_scene``, whose shift into
   the slab's frame is exact), and (b) two ranks sharing the card over gloo, the default route twice:
   each run held to ``MPM``'s CPIC frames on the card at the CPIC bounds
   of phase 8, each kernel of its route once per substep per rank, every
   particle kept; on two ranks the bodies equal in bits on both ranks
   after every frame, migrants both ways, a balanced bound moved, both
   near sets used, the default runs equal in bits. ``dist_cpic_path``:
   the 100k CPIC wheel (``scenes.cpic_wheel()``) from phase 9's state
   (its snapshot: the water on the wheel) on two ranks sharing the card,
   fused and balanced, 1 + 1 frames of 20 substeps, both ranks' near
   sets used: ms and host
   syncs per substep per rank (``HostSyncs`` and torch's own count), the
   exchange's, the impulse all-reduces' and the migration's ms per
   substep in a synced frame, beside ``MPM``'s CPIC frame from the same
   snapshot. Then, in the same two ranks (``phase_slab_cpic_paths``),
   ``water_wheel_slabs``: ``scripts/mls-cpic/water_wheel.py``
   at res 64 through the runner's scene, resumed (``--continue``) from a
   snapshot whose first emission was moved down onto a paddle, with
   SHARDS=2 on two ranks sharing the card, 3 frames of 2e-3 s with its
   source, against the same through ``MPM``: equal particle counts, the
   water near the paddles, the wheel turning, its omega within 1e-5.
16. The pencils (``DistributedMPM(mesh_shape=(Sx, Sy))``; four ranks
   share the one card, so again no scaling number). ``mesh_check``: the
   scenes of ``MESH_SCENES`` (``driver_jelly`` and ``pencil_drift``, the
   JAX package's pencil tests' res-32 scenes; ``corner_crossing``, whose
   blobs reach the diagonal pencil within a re-sort; ``corner_cluster``;
   the free plate, and one across the four pencils' corner;
   ``diagonal_pair``, a corner held by two diagonal pencils alone) on
   every pencil route (four plain, three CPIC; the fourth CPIC row must
   raise), (a) one rank over NCCL on a (1, 1) mesh and (b) four gloo
   ranks sharing the card on a (2, 2) mesh: each run held to ``MPM``'s
   frames on the card and on the CPU at the frame or CPIC bounds, each
   kernel of its route once per substep per rank, particles migrating on
   both axes with diagonal migrants, the cluster's bounds off the uniform
   split on both axes, the bodies equal in bits on all four ranks.
   ``mesh_path``: the 8M cube at res 128 and ``mesh_cpic_path``: the 100k
   CPIC wheel from ``cpic_path``'s snapshot, each on four ranks, fused
   and balanced, as ``dist_path`` and ``dist_cpic_path`` time them (ms,
   host syncs, exchange, migration and impulse all-reduce ms, migrants
   per axis, peak memory, near sets per rank).
17. The other 3-D scene scripts (``SCRIPT_KINDS``: ``scripts/async``'s
   combo, sand, slope and stork; ``scripts/mls-cpic``'s banana,
   bunny_split, buoyancy, goo_blocks, robot, robot_reversed, sand_stir and
   sand_sweep; ``sand_layers.py``; ``colliding_balls_3d_test.py``) and
   the demos. ``scripts_check``: each at the port tests' res, one frame
   of a few substeps on the card against the CPU at the frame, sand or
   CPIC bounds, a rerun in bits; robot and sand_layers also on
   TMT_FUSED=0, so that all four kernels launch. ``scripts_path``: each
   through ``runner.main`` at its own res, a warm-up frame and a timed
   frame (the CPIC scripts' cut to 10 substeps): ms and host syncs per
   substep of the timed frame, sorts, the bodies of robot and buoyancy. ``demo_mpm88``: both
   torch demos, one frame on the card against the CPU and a rerun in
   bits.
   Then
   ``timing``: the seconds of the check block, of the timed block and of
   the whole script.

Every phase line ends with ``elapsed_s`` (seconds since the start),
``phase_s`` (the phase's wall seconds), ``cpu_reference_s`` (of which
CPU reference frames) and ``ranks_s`` and ``rank_spawns`` (spawned rank
groups); ``rank_startup`` measures what a spawned group of 2 and of 4
ranks costs before it works.

Then the ``kernels`` line: per kernel its launches on each path (the
slab and pencil phases' per rank: summed over ``dist_check``'s,
``dist_cpic_check``'s and ``mesh_check``'s runs, and ``dist_path``'s,
``dist_cpic_path``'s, ``mesh_path``'s and ``mesh_cpic_path``'s timed
frames and ``water_wheel_slabs``' frames by rank), its
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
``python3 chip_smoke.py --dense-cpic-tree [DIR [SNAPSHOT]]`` times the
dense 100k CPIC wheel of the package under DIR (``dense_cpic_tree``) and
that package's ``body_totals`` on a substep of it and of SNAPSHOT, which
``python3 chip_smoke.py --wheel-snapshot SNAPSHOT`` writes
(``cpic_path_snapshot``: the water on the wheel, as ``dense_cpic_scale``
finds it), to compare two trees' dense CPIC substep and kernel the same
way.
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
CPIC_PROFILE_SUBSTEPS = 5  # the profiled CPIC frame (cpic_profile)
ADAPTIVE_TIMED_FRAMES = 3  # after one warm-up frame
DAM_UNFUSED_TIMED_FRAMES = 1  # the unfused dam's, after one warm-up frame
CPIC_ADAPTIVE_TIMED_FRAMES = 1  # after one warm-up frame
N_SAND_FRAMES = 5  # timed frames of the 8M sand cube, after one warm-up frame

# float32 operations per particle, counted from the kernels' formulas (an
# FMA is 2; a square root, division, log, exp or pow 1): see the notes in
# taichi_mpm_torch/csrc/p2g.cu, g2p.cu and materials.cuh.
# Material ids (taichi_mpm_torch.materials.cforms) and names.
ELASTIC, JELLY, SNOW, WATER, SAND, VON_MISES, LINEAR, VISCO = range(8)
MATERIALS = ("elastic", "jelly", "snow", "water", "sand", "von_mises", "linear", "visco")
SVD_OPS = 1120  # F^T F, 18 Jacobi rotations (~53 each), sort, flip, Gram-Schmidt U, s
POLAR_OPS = 6 * 115  # 6 scaled Newton iterations
# SASS instructions that one particle executes in each fused build, by
# kernel and material: counted by tools/sass_count.py from cuobjdump -sass
# of the libraries built on the card (see its note for the rules: the
# path of one particle, loops times their trips, slow paths not taken; a
# P2G round's staging over its 32 particles and 32 scatter iterations).
SASS_PER_PARTICLE = {
    "p2g_fused": dict(elastic=4066, jelly=3382, snow=3410, water=2070, sand=4066,
                      von_mises=4066, linear=2075, visco=3382),
    "g2p_fused": dict(elastic=1625, jelly=1625, snow=3581, water=1603, sand=3772,
                      von_mises=3722, linear=1625, visco=7473),
}
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
    from taichi_mpm_torch.ops import body_sums, g2p, p2g

    return {"p2g_fused": p2g.stats, "g2p_fused": g2p.stats, "g2p_blocked": g2p.blocked_stats,
            "p2g_blocked": p2g.blocked_stats, "body_totals": body_sums.stats}


ROUTE_KERNELS = {True: ("p2g_fused", "g2p_fused"), False: ("p2g_blocked", "g2p_blocked")}
TRANSFER_KERNELS = ("p2g_fused", "g2p_fused", "p2g_blocked", "g2p_blocked")


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


T_START = time.time()  # the run's start; a check lane is given the parent's
# what the phase now running has spent so far: the seconds of scene frames
# on the CPU (the references the card's frames are held to) and of rank
# groups, and the groups spawned for it; read and reset by each phase line
PHASE_CLOCK = dict(start=time.perf_counter(), cpu_reference_s=0.0, ranks_s=0.0, rank_spawns=0)
LINES = None  # a check lane keeps its phase lines here for the parent to print


def emit(obj):
    """One JSON line; a phase's line also says when it ended, in seconds
    since the script started, and what the phase took: its wall seconds
    since the line before in its process (``phase_s``), of which CPU
    reference frames (``cpu_reference_s``) and rank groups (``ranks_s``,
    with ``rank_spawns``, the groups spawned for it)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = dict(obj, elapsed_s=time.time() - T_START, phase_s=now - PHASE_CLOCK["start"],
                   **{k: obj.get(k, PHASE_CLOCK[k])
                      for k in ("cpu_reference_s", "ranks_s", "rank_spawns")})
        PHASE_CLOCK.update(start=now, cpu_reference_s=0.0, ranks_s=0.0, rank_spawns=0)
    if LINES is not None:
        LINES.append(json.dumps(obj))
    else:
        print(json.dumps(obj), flush=True)


def clock_cpu_frames():
    """Count into PHASE_CLOCK every frame a scene steps on the CPU (the
    solvers' ``step``, the outermost call only)."""
    import functools

    from taichi_mpm_torch import MPM
    from taichi_mpm_torch.core.adaptive import AsyncMPM
    from taichi_mpm_torch.parallel.driver import DistributedAsyncMPM, DistributedMPM

    depth = [0]

    def timed_step(step):
        @functools.wraps(step)
        def wrapper(self, *args, **kw):
            if depth[0] or self.device.type != "cpu":
                return step(self, *args, **kw)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return step(self, *args, **kw)
            finally:
                depth[0] -= 1
                PHASE_CLOCK["cpu_reference_s"] += time.perf_counter() - t0
        return wrapper

    for cls in (MPM, AsyncMPM, DistributedMPM, DistributedAsyncMPM):
        if "step" in vars(cls):
            cls.step = timed_step(vars(cls)["step"])


# -- rank groups and check lanes: what runs beside the parent ---------------------------

DIST_TIMEOUT_S = 600  # a rank group's task, or a spawned group's run
RANK_GROUPS = {}  # world -> RankGroup, in the parent while its timed rank paths run
RANK_GROUP_TIMEOUT_S = 3000  # a group lives from the check block to the end of the run


def rank_server(tasks, results):
    """A rank of a RankGroup: runs each task that arrives on its queue (the
    name of a function of this module and its arguments), puts (rank,
    result, traceback) on `results`, and returns at None."""
    import traceback

    import torch

    from taichi_mpm_torch.parallel import comm

    r = comm.rank()
    while True:
        task = tasks[r].get()
        if task is None:
            return None
        name, args = task
        try:
            results.put((r, globals()[name](*args), None))
        except Exception:  # reported to the parent, which raises it
            results.put((r, None, traceback.format_exc()))
        torch.cuda.empty_cache()


class RankGroup:
    """`world` gloo ranks sharing the card, spawned once (``comm.run_ranks``
    of ``rank_server`` in a thread) and kept until ``close``: ``run(fn,
    *args)`` runs fn(*args) on every rank, as ``comm.run_ranks`` would,
    without a spawn and a start-up each time. A rank that fails, dies or
    outlives the timeout raises in ``run``."""

    def __init__(self, world):
        import multiprocessing as mp
        import threading

        from taichi_mpm_torch.parallel import comm

        ctx = mp.get_context("spawn")
        self.world, self.error = world, None
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()

        def serve():
            try:
                comm.run_ranks(rank_server, world, "gloo", args=(self.tasks, self.results),
                               timeout_s=RANK_GROUP_TIMEOUT_S)
            except Exception as e:  # raised in run, by the thread that waits
                self.error = e
            self.results.put(None)

        self.thread = threading.Thread(target=serve, daemon=True)
        self.thread.start()

    def run(self, fn, *args, timeout_s=DIST_TIMEOUT_S):
        import queue

        for q in self.tasks:
            q.put((fn.__name__, args))
        out, deadline = {}, time.monotonic() + timeout_s
        while len(out) < self.world:
            try:
                item = self.results.get(timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"{fn.__name__}: ranks {sorted(set(range(self.world)) - set(out))}"
                                   f" did not finish within {timeout_s} s") from None
            if item is None:
                raise RuntimeError(f"the group of {self.world} ranks ended: {self.error}")
            r, value, err = item
            if err is not None:
                raise RuntimeError(f"{fn.__name__}: rank {r} failed:\n{err}")
            out[r] = value
        return [out[r] for r in range(self.world)]

    def close(self):
        for q in self.tasks:
            q.put(None)
        self.thread.join(timeout=120)


def ranks_of(fn, world, args=()):
    """fn(*args) on `world` gloo ranks sharing the card: in this process's
    open RankGroup of that size, else in ranks spawned for the call
    (``comm.run_ranks``). Returns the ranks' results in rank order."""
    from taichi_mpm_torch.parallel import comm

    t0 = time.perf_counter()
    try:
        if world in RANK_GROUPS:
            return RANK_GROUPS[world].run(fn, *args)
        PHASE_CLOCK["rank_spawns"] += 1
        return comm.run_ranks(fn, world, "gloo", args=args, timeout_s=DIST_TIMEOUT_S)
    finally:
        PHASE_CLOCK["ranks_s"] += time.perf_counter() - t0


CHECK_LANES = 4  # processes that run the check block's phases at once
CHECK_BLOCK_TIMEOUT_S = 900  # the longest wait for a check phase's result
LANE_THREADS = 2  # torch's CPU threads in each


def lane_init(start, threads):
    """A check lane: the parent's start time, phase lines kept for the
    parent, `threads` CPU threads, CPU frames counted."""
    global LINES, T_START
    import torch

    T_START, LINES = start, []
    torch.set_num_threads(threads)
    clock_cpu_frames()


def lane_phase(name, args):
    """phase `name`(*args) in a check lane. Returns its lines, its value
    and its traceback if it failed."""
    import traceback

    del LINES[:]
    PHASE_CLOCK.update(start=time.perf_counter(), cpu_reference_s=0.0, ranks_s=0.0,
                       rank_spawns=0)
    try:
        value, err = globals()[name](*args), None
    except Exception:  # reported to the parent, which prints the lines and raises
        value, err = None, traceback.format_exc()
    return list(LINES), value, err


def check_block(tasks, parent_work):
    """The check block: each phase of `tasks` ((name, args), none timed)
    in CHECK_LANES processes at once, the longest first, while this
    process runs parent_work(). Prints each phase's lines in the order of
    `tasks` and raises if any failed. Returns (the phases' values in the
    order of `tasks`, parent_work's value)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(CHECK_LANES, mp_context=mp.get_context("spawn"),
                               initializer=lane_init, initargs=(T_START, LANE_THREADS))
    done = False
    try:
        futures = [(name, pool.submit(lane_phase, name, args)) for name, args in tasks]
        mine = parent_work()
        values, errors = [], []
        for name, fut in futures:
            lines, value, err = fut.result(timeout=CHECK_BLOCK_TIMEOUT_S)
            values.append(value)
            for line in lines:
                print(line, flush=True)
            if err is not None:
                errors.append(f"{name}:\n{err}")
        done = True
    finally:
        if not done:  # a lane that hangs must not hold the run: stop every lane
            for proc in list(pool._processes.values()):
                proc.terminate()
        pool.shutdown(wait=done, cancel_futures=True)
    if errors:
        fail("\n".join(errors))
    return values, mine


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
    a random order; then the builds with an SVD in their return map (and
    all eight, sorted and not) on the inputs with F at the SVD's edges
    (``svd=True``)."""
    import torch

    from taichi_mpm_torch import diagnostics
    from taichi_mpm_torch.ops import blocked, g2p
    from taichi_mpm_torch.ops.rows import RACT, RF

    failures, out, sorted_runs = [], {}, {}
    perm = np.random.default_rng(1).permutation(diagnostics.G2P_EDGE_LANES)
    labels = (*EDGE_SETS, "jelly_unsorted", "mixed_unsorted", "all_unsorted",
              *(f"{m}/svd" for m in (*diagnostics.SVD_PLAST_MATERIALS, "all")),
              "all/svd_unsorted")
    for label in labels:
        case = label.removesuffix("_unsorted")
        material, _, svd = case.partition("/")
        e = diagnostics.g2p_edge_inputs(material, svd=svd == "svd")
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
        if case not in sorted_runs:
            sorted_runs[case] = (k1, vm1, pl1)
        else:  # the unsorted lanes must give the sorted run's bits, permuted
            ks, vms, pls = sorted_runs[case]
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
    eight, and the Hencky builds (and all eight) on the inputs with F at
    the SVD's edges and slots of the Hencky kernel's staging batches
    (``svd=True``): merged records to 1e-5 x max|record|, two launches
    bit-identical, empty slots zero."""
    import torch

    from taichi_mpm_torch import diagnostics
    from taichi_mpm_torch.ops import blocked, p2g

    failures, out = [], {}
    svd_cases = (f"{m}/svd" for m in (*diagnostics.SVD_FORCE_MATERIALS, "all"))
    for case in (*EDGE_SETS, *svd_cases):
        material, _, svd = case.partition("/")
        e = diagnostics.p2g_edge_inputs(material, svd=svd == "svd")
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
            label = f"{name} on the {case} edge inputs"
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
            out[f"{case}_{name}"] = dict(max_abs_err=err, record_scale=scale,
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
    package has them), their CUDA-event times on the states of
    kernel_states, and on the 8M jelly state ``material_builds`` with the
    two-pass yardstick of the Hencky builds (tools/p2g_operand.cu built
    against that package's csrc)."""
    if root is not None:
        sys.path.insert(0, os.path.abspath(root))
    import taichi_mpm_torch

    yardstick = yardstick_libraries()
    out = dict(phase="kernel_tree", package=os.path.dirname(taichi_mpm_torch.__file__),
               checksums={**p2g_checksums(), **g2p_checksums()},
               material_checksums=material_checksums())
    for label, sim in kernel_states():
        out[f"ms_{label}"] = kernel_ms(sim)
        out[f"slots_{label}"] = sim.block_capacity
        if label == "jelly_8m":
            out["material_builds_8m"] = material_builds(sim, yardstick)
        del sim
    emit(dict(out, clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit")))


DENSE_CPIC_TREE_FRAMES = 5


def dense_cpic_tree(root=None, snapshot=None):
    """The dense 100k CPIC wheel (``scenes.cpic_wheel(optimized=False)``)
    of the package under `root` (default: this checkout), as phase
    dense_cpic_scale steps it: a 1-substep warm-up frame, then
    DENSE_CPIC_TREE_FRAMES frames of DENSE_CPIC_SCALE_SUBSTEPS, the ms per
    substep of each (host clock, fenced); then that package's
    ``body_totals`` timed (``body_totals_timing``) on a substep of the
    state reached ("fresh": no particle near the wheel yet) and, given
    `snapshot` (``cpic_path_snapshot``'s file: the water on the wheel, as
    phase dense_cpic_scale times it), on a substep of that state
    resumed."""
    if root is not None:
        sys.path.insert(0, os.path.abspath(root))
    import taichi_mpm_torch
    from taichi_mpm_torch import diagnostics, scenes

    sim = scenes.cpic_wheel(device="cuda", optimized=False)
    sim._ensure_finalized()
    sim.step(frame_dt=sim.cfg.base_dt)
    sim.sync()
    ms = []
    for _ in range(DENSE_CPIC_TREE_FRAMES):
        t0 = time.perf_counter()
        sim.step(frame_dt=DENSE_CPIC_SCALE_SUBSTEPS * sim.cfg.base_dt)
        sim.sync()
        ms.append((time.perf_counter() - t0) * 1e3 / DENSE_CPIC_SCALE_SUBSTEPS)
    totals = dict(fresh=body_totals_timing(diagnostics.substep_stages(sim), sim.bodies.num))
    if snapshot is not None:
        coupled = scenes.cpic_wheel(device="cuda", optimized=False)
        coupled.load(snapshot)
        totals["snapshot"] = body_totals_timing(diagnostics.substep_stages(coupled),
                                                coupled.bodies.num)
    emit(dict(phase="dense_cpic_tree", package=os.path.dirname(taichi_mpm_torch.__file__),
              ms_per_substep=ms, near_b=int(sim.particles.near_b.sum()), body_totals=totals,
              clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit")))


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


def frame_errors(a, b, label, failures, bounds=FRAME_BOUNDS, plast_slack=0, lanes=None):
    """Two scenes after the same frame: the same particles alive, the
    same sort counts, plasticity counts that differ by no more than
    `plast_slack` (sand's lanes at its knife edges over the frame), the
    fields within `bounds` (over the lanes `lanes`, a bool mask, where
    given). Returns the errors; a broken bound is appended to
    `failures`."""
    pa, pb = a.particles, b.particles
    act = pa.active.cpu().numpy().copy()  # a CPU tensor's numpy() shares its memory
    if not np.array_equal(pb.active.cpu().numpy(), act):
        failures.append(f"{label}: the frames keep other particles")
    act &= pb.active.cpu().numpy()
    if lanes is not None:
        act &= lanes
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


def phase_materials25(part=0, parts=1):
    """For each set of MATERIAL_SETS25[part::parts] (the check block runs
    the sets in two halves at once): one 6-substep frame of the 125k
    cube (benchmark_cube(cells=25), the set's materials dealt over the
    lattice in turn) on the card, each fused kernel launched once per
    substep, held to the same frame on the CPU and to the unfused card
    frame at the cube25 bounds, with plastic events equal but for sand's
    knife edges over the CPU frame; then the four kernels against their
    twins on that state stirred (compare_kernels: bounds, two launches
    bit-identical). A set of one material also gives its energy record
    (``energy_record``, from the same two frames); then
    ``phase_energy_check`` of those materials and of this part's share of
    the materials no set holds alone."""
    from taichi_mpm_torch import diagnostics

    out, failures, energies = {}, [], {}
    for names in MATERIAL_SETS25[part::parts]:
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
        if len(names) == 1:  # energy_check's frames of this material, the same cubes
            energies[material] = energy_record(card, cpu, material, [])
        del cpu, unfused
        res["kernels"] = compare_kernels(card, stirred(card.packed_carry[0], aux_sd=0.05), f)
        res["seconds"] = time.perf_counter() - t0
        out[label] = res
        failures += [f"{label}: {msg}" for msg in f]
        del card
    emit(dict(phase="materials25", **out, failures=failures))
    raise_failures(failures)
    alone = [m for m in MATERIALS if (m,) not in MATERIAL_SETS25]
    phase_energy_check(energies, (*energies, *alone[part::parts]))


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


def gpu_digest(*tensors):
    """A digest of the bits of CUDA tensors, computed on the card: per
    tensor, its 32-bit words times fixed pseudo-random 64-bit weights,
    summed (mod 2^64), in hex. Equal bits give equal digests; a difference
    anywhere changes one with probability about 1 - 2^-64 (for the 8M
    states, where copying to the host and hashing would take seconds)."""
    import torch

    out = []
    for t in tensors:
        words = t.contiguous().view(torch.int32).reshape(-1)
        g = torch.Generator(device=t.device).manual_seed(len(out) + 1)
        total = torch.zeros((), dtype=torch.int64, device=t.device)
        for chunk in torch.split(words, 1 << 24):
            w = torch.randint(-(1 << 62), 1 << 62, chunk.shape, generator=g, device=t.device,
                              dtype=torch.int64)
            total += (chunk.to(torch.int64) * w).sum()
        out.append(f"{int(total) & (2 ** 64 - 1):016x}")
    return "".join(out)


# SM issue: 4 schedulers per SM, each one warp instruction (32 lanes) a cycle
SCHEDULERS_PER_SM = 4


def sm_clock_mhz():
    """The SM clock nvidia-smi reads now, in MHz."""
    return float(nvidia_smi("clocks.sm").split()[0])


def issue_floor_ms(kernel, material, particles, mhz):
    """The instruction-issue floor of a fused build: SASS_PER_PARTICLE
    instructions per particle over the card's SMs x 4 schedulers x 32
    lanes at `mhz`; None where the build has no count."""
    import torch

    n = SASS_PER_PARTICLE.get(kernel, {}).get(material)
    if n is None or not mhz:
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n * particles / (sms * SCHEDULERS_PER_SM * 32 * mhz * 1e6) * 1e3


YARDSTICK_MATERIALS = ("elastic", "sand", "von_mises")  # the Hencky builds


def yardstick_libraries():
    """Build tools/p2g_operand.cu (the two-pass yardstick) against the
    csrc of the imported package, one library per Hencky material, all
    at once; returns them by material."""
    import ctypes

    from taichi_mpm_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR / "yardstick"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "p2g_operand.cu")
    procs = {}
    for name in YARDSTICK_MATERIALS:
        mats = 1 << MATERIALS.index(name)
        lib = out_dir / f"p2g_operand_m{mats}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-DTMT_MATS={mats}",
               f"-I{cuda_build.CSRC}", "-o", str(lib), src]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            fail(f"nvcc failed for the yardstick of {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def operand_pass(lib, st, dt, cfg):
    """The yardstick's first pass on the sorted state `st`: the (16, Pw)
    P2G operand built by tools/p2g_operand.cu."""
    import ctypes

    import torch

    from taichi_mpm_torch.ops import cuda_build, p2g

    pd = torch.empty((16, st.shape[1]), dtype=torch.float32, device=st.device)
    fn = lib.p2g_operand_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_float] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    mats = p2g.material_set(cfg)
    rc = fn(st.data_ptr(), st.shape[1], pd.data_ptr(), *p2g._launch_args(cfg, dt), mats,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(rc, "p2g_operand", mats)
    return pd


def material_builds(sim, yardstick=None):
    """p2g_fused and g2p_fused at the 8M state of `sim` (the jelly cube
    after its frames) made of each material in turn (as_material), each
    on the library of that material: CUDA-event time (10 launches after
    one) beside its bound and its issue floor (SASS_PER_PARTICLE at the
    SM clock read right after), the library's registers and spills, and a
    digest of one launch's output (``gpu_digest``:
    the tiles; the state, vmax and plasticity count), to hold two trees'
    builds to the same bits at 8M. Given `yardstick` (its libraries by
    Hencky material), also the two-pass alternative of each Hencky build:
    the operand pass and p2g_blocked, each timed alone and together, and
    whether its tiles have p2g_fused's bits."""
    import torch

    from taichi_mpm_torch.ops import blocked, cuda_build, g2p, p2g
    from taichi_mpm_torch.ops.substep import grid_update_flat

    st0, _, pm, _ = sim.packed_carry
    dt = sim.cfg.base_dt
    keys, s_arr, e_arr = pm["slot_keys"], pm["s_arr"], pm["e_arr"]
    n_in = int((e_arr - s_arr).sum())
    n_act = int((st0[36] > 0.5).sum())
    out = {"p2g_fused": {}, "g2p_fused": {}}
    for mid, name in enumerate(MATERIALS):
        st = as_material(st0, name)
        cfg = sim.cfg.with_materials((mid,))
        tiles = p2g.p2g_fused(s_arr, e_arr, st, dt, cfg)
        rec = blocked.merge_tiles(tiles, pm["nbr"])
        win = blocked.windows(grid_update_flat(rec, pm["ids"], cfg, tuple(sim.colliders),
                                               sim.t, dt), pm["nbr"])
        scratch = st.clone()
        vmax, plast = g2p.g2p_fused(keys, scratch, win, dt, cfg)
        digests = {"p2g_fused": gpu_digest(tiles),
                   "g2p_fused": gpu_digest(scratch, vmax, plast)}
        ms = {"p2g_fused": cuda_ms(lambda: p2g.p2g_fused(s_arr, e_arr, st, dt, cfg), 10),
              "g2p_fused": cuda_ms(lambda: g2p.g2p_fused(keys, scratch, win, dt, cfg), 10)}
        mhz = sm_clock_mhz()
        particles = {"p2g_fused": n_in, "g2p_fused": n_act}
        for kernel, (nbytes, ops) in fused_work(st, pm).items():
            src = kernel[:3]
            b_ms, b_by = bound(nbytes, ops)
            ptx = cuda_build.ptxas_report(src, 1 << mid).get(kernel, {})
            out[kernel][name] = dict(
                ms=ms[kernel], bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops,
                issue_floor_ms=issue_floor_ms(kernel, name, particles[kernel], mhz),
                sass_per_particle=SASS_PER_PARTICLE.get(kernel, {}).get(name), sm_mhz=mhz,
                registers=ptx.get("registers"), spill_stores=ptx.get("spill_stores"),
                spill_loads=ptx.get("spill_loads"), digest=digests[kernel])
        if yardstick is not None and name in yardstick:
            lib = yardstick[name]
            pd = operand_pass(lib, st, dt, cfg)
            two = p2g.p2g_blocked(s_arr, e_arr, pd)
            out["p2g_fused"][name]["two_pass"] = dict(
                ms=cuda_ms(lambda: p2g.p2g_blocked(s_arr, e_arr, operand_pass(lib, st, dt, cfg)),
                           10),
                operand_ms=cuda_ms(lambda: operand_pass(lib, st, dt, cfg), 10),
                p2g_blocked_ms=cuda_ms(lambda: p2g.p2g_blocked(s_arr, e_arr, pd), 10),
                same_bits_as_fused=torch.equal(two.view(torch.int32), tiles.view(torch.int32)))
            del pd, two
        del st, scratch, rec, win, tiles
    return out


def phase_material_kernels(sim, card):
    """``material_builds`` at the 8M state of `sim`. Returns them by
    kernel and material."""
    out = material_builds(sim)
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
    return sim, launches, timed_s * 1e3 / n_timed


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


def phase_profile(sim, card, phase="profile", substeps=None):
    """One frame (of `substeps`, default the scene's frame) under
    torch.profiler: the device's busy time (the sum of its kernels' and
    copies' times) over the frame's wall time, and the kernels that take
    the most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(frame_dt=substeps and substeps * sim.cfg.base_dt)
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
        phase=phase, card=card, substeps=substeps, frame_wall_ms=wall_ms, device_busy_ms=busy_ms,
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
    # replaces no TPU kernel: sums the dense CPIC body totals in the order of
    # the JAX package's scatter-add (rigid/body.py accumulate_impulses)
    "body_totals": ("taichi_mpm_torch/csrc/body_totals.cu",
                    "none (the order of taichi_mpm_tpu/rigid/body.py:141 accumulate_impulses)"),
}


def kernels_line(measured, launches_by_path, dam_ms, by_material):
    """The kernels line: each kernel's measurements (the four transfer
    kernels at 8M, ``body_totals`` at the dense 100k wheel's P2G totals),
    the transfer kernels' time at the 1.4M dam's state, its launches on
    each main path (``launches`` is their sum), and for the fused kernels
    their time and bound at the 8M state made of each material
    (``by_material``)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    line = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        by_path = {path: counts.get(name, 0) for path, counts in launches_by_path.items()}
        m = measured[name]
        line.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=sum(by_path.values()), launches_by_path=by_path,
                         **{k: m[k] for k in keys}, library_ms=m.get("library_ms"),
                         dam_ms=dam_ms.get(name), by_material=by_material.get(name),
                         **{k: v for k, v in m.items() if k not in keys + ("library_ms",)}))
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


def cpic_warm_snapshot(path):
    """The CPIC benchmark scene (``scenes.cpic_wheel()``, frames of 20
    substeps) through CPIC_WARM_FRAMES warm-up frames on the card, every
    launch count set to 0 first, while the water falls onto the wheel;
    saved to `path` for ``phase_cpic_path``. Returns the seconds, the
    largest near sets and page map, the substeps and the launches."""
    import torch

    from taichi_mpm_torch import scenes

    t0 = time.perf_counter()
    sim = scenes.cpic_wheel(device="cuda")
    sim.frame_dt = SUBSTEPS_PER_FRAME * sim.cfg.base_dt
    sim._ensure_finalized()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    zero_counts()
    peak = dict(n_near=0, n_coarse=0, n_r=0)
    t0 = time.perf_counter()
    for _ in range(CPIC_WARM_FRAMES):
        sim.step()
        peak = {k: max(v, sim.cpic_stats[k]) for k, v in peak.items()}
    sim.sync()
    warm_s = time.perf_counter() - t0
    sim.save(path)
    return dict(setup_s=setup_s, warmup_s=warm_s, peak=peak, launches=read_counts(),
                substeps=CPIC_WARM_FRAMES * SUBSTEPS_PER_FRAME)


def cpic_path_snapshot(path):
    """``cpic_warm_snapshot``'s warm-up, then phase cpic_path's 1 +
    CPIC_TIMED_FRAMES frames from it, saved to `path`: the water on the
    wheel, as the phases that resume cpic_path's state find it (less the
    few substeps of cpic_breakdown and cpic_profile). Returns the warm-up's
    record and the particles near the wheel."""
    from taichi_mpm_torch import scenes

    warm = cpic_warm_snapshot(path)
    sim = scenes.cpic_wheel(device="cuda")
    sim.frame_dt = SUBSTEPS_PER_FRAME * sim.cfg.base_dt
    sim.load(path)
    for _ in range(1 + CPIC_TIMED_FRAMES):
        sim.step()
    sim.sync()
    sim.save(path)
    return dict(warm, near_b=int(sim.particles.near_b.sum()))


def phase_cpic_path(card, warm, snapshot):
    """The full CPIC benchmark scene from its warm-up (``cpic_warm_snapshot``:
    `warm` its record, `snapshot` its state, the water on the wheel),
    every launch count set to 0 first: a frame after the resume, then
    CPIC_TIMED_FRAMES timed frames, and the checks. Returns (sim,
    launches, host syncs per substep, ms per substep)."""
    import torch

    from taichi_mpm_torch import scenes
    from taichi_mpm_torch.utils import HostSyncs

    sim = scenes.cpic_wheel(device="cuda")
    sim.frame_dt = SUBSTEPS_PER_FRAME * sim.cfg.base_dt
    sim.load(snapshot)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    peak = dict(warm["peak"])
    sim.step()  # the resume's first frame packs and sorts afresh
    sim.sync()
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

    substeps = (1 + CPIC_TIMED_FRAMES) * SUBSTEPS_PER_FRAME
    failures += [f"warm-up: {f}" for f in route_failures(warm["launches"], True,
                                                         warm["substeps"], CPIC_KERNELS)]
    failures += route_failures(launches, True, substeps, CPIC_KERNELS)
    x = check_domain(sim, 100_000, failures)
    n_active = int(x.shape[0])
    omega_z = float(sim.bodies.omega[2, 2])
    if not (np.isfinite(omega_z) and omega_z != 0.0):
        failures.append(f"the wheel does not turn: omega_z = {omega_z}")
    n_timed = CPIC_TIMED_FRAMES * SUBSTEPS_PER_FRAME
    emit(dict(
        phase="cpic_path", card=card, particles=n_active, K=sim.block_capacity,
        substeps=warm["substeps"] + substeps, timed_substeps=n_timed,
        ms_per_substep=timed_s * 1e3 / n_timed,
        particle_steps_per_s=n_active * n_timed / timed_s,
        host_syncs_per_substep=syncs / n_timed, n_sorts=sim.n_sorts,
        max_n_near=peak["n_near"], max_n_coarse=peak["n_coarse"],
        max_n_r=peak["n_r"], Kr_capacity=sim.cpic_caps.Kr, wheel_omega_z=omega_z,
        hub_omega_z=float(sim.bodies.omega[1, 2]), warmup_s=warm["warmup_s"],
        setup_s=warm["setup_s"], peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        y_min=float(x[:, 1].min()), warmup_launches=warm["launches"], launches=launches,
        kernel_checks=kernel_checks, clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"),
        failures=failures,
    ))
    raise_failures(failures)
    return sim, launches, syncs / n_timed, timed_s * 1e3 / n_timed


def cpic_stage_ms(sim, substeps=SUBSTEPS_PER_FRAME):
    """CUDA-event time of each stage of the coupled substep, summed over
    one frame of `substeps` from the scene's state and divided by them
    (the state is not advanced), and the frame's host-clock ms per
    substep. The first stage, the prologue, also holds the frame's reads
    between substeps (drift, staleness)."""
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
        substeps, sim.cpic_caps, marks=mark)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stages = {}
    for (_, a), (name, b) in zip(events, events[1:]):
        stages[name] = stages.get(name, 0.0) + a.elapsed_time(b) / substeps
    return stages, wall_ms / substeps


def phase_cpic_breakdown(sim, card):
    """``cpic_stage_ms`` of the wheel's state."""
    stages, wall = cpic_stage_ms(sim)
    emit(dict(phase="cpic_breakdown", card=card, ms_per_substep=stages,
              stages_sum_ms=sum(stages.values()), frame_wall_ms_per_substep=wall))


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
    a warm-up frame and ADAPTIVE_TIMED_FRAMES (fused) or
    DAM_UNFUSED_TIMED_FRAMES (unfused) timed frames of 0.01 s."""
    import torch

    from taichi_mpm_torch import scenes

    t0 = time.perf_counter()
    sim = on_route(fused, lambda: scenes.water_dam(res=128, device="cuda"))
    sim._ensure_finalized()
    n = int(sim.particles.count())
    setup_s = time.perf_counter() - t0
    zero_counts()
    frames = adaptive_frames(sim, 1 + (ADAPTIVE_TIMED_FRAMES if fused
                                       else DAM_UNFUSED_TIMED_FRAMES))
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
    CPIC_ADAPTIVE_TIMED_FRAMES timed frames of 20 base dt (2e-3 s). Its host
    syncs per substep must not exceed the fixed-dt frames' (`fixed_syncs`,
    measured in this run)."""
    from taichi_mpm_torch import scenes
    from taichi_mpm_torch.core.adaptive import AsyncMPM

    sim = scenes.cpic_wheel(device="cuda", lo=(0.5, 0.3, 0.42), hi=(0.68, 0.62, 0.58),
                            vel=(0.0, -1.0, 0.0), solver=AsyncMPM, unit_delta_t=1e-6)
    sim.frame_dt = SUBSTEPS_PER_FRAME * sim.cfg.base_dt
    zero_counts()
    frames = adaptive_frames(sim, 1 + CPIC_ADAPTIVE_TIMED_FRAMES)
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
SCRIPT_DAM_TIMED_FRAMES = 2  # after one warm-up frame
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
                self.steps.append(dict(substeps=getattr(self.sim, "last_substeps", None),
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


def tagged(p):
    """The active particles of a Particles set as numpy arrays, ordered by
    their id tag."""
    from taichi_mpm_torch import convert

    a = convert.particles_to_numpy(p)
    act = a["active"]
    order = np.argsort(a["params"][act, ID_ROW_PARAM], kind="stable")
    return {k: v[act][order] for k, v in a.items()}


def tagged_errors(ref, got, label, failures, bounds=FRAME_BOUNDS):
    """Two tagged particle sets: the same particles, the fields within
    `bounds`. Returns the errors."""
    if not np.array_equal(ref["params"][:, ID_ROW_PARAM], got["params"][:, ID_ROW_PARAM]):
        failures.append(f"{label}: other particles alive")
        return {}
    errs = {}
    for name, bnd in bounds:
        diff = ref[name].astype(np.float64) - got[name].astype(np.float64)
        errs[name] = float(np.abs(diff).max())
        if not errs[name] <= bnd:
            failures.append(f"{label}: {name} differs by {errs[name]} > {bnd}")
    return errs


def id_errors(a, b, label, failures, bounds=FRAME_BOUNDS):
    """Two scenes' particles matched by their id tags: the same particles
    alive, the fields within `bounds`. Returns the errors."""
    return tagged_errors(tagged(a.particles), tagged(b.particles), label, failures, bounds)


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
    kept["substeps"] = substeps
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


def energy_record(card, cpu, name, failures):
    """energy_check's record of one material's 125k cube after one
    6-substep frame on the card (`card`) and on the CPU (`cpu`):
    MPM.energy() of each (within ENERGY_RTOL); then the card's state
    stirred (F far from I, spinning), its energy on the card against the
    same state's on the CPU (within ENERGY_RTOL)."""
    from taichi_mpm_torch.ops import packed

    e_card, e_cpu = card.energy(), cpu.energy()
    _, scale = energy_of(cpu.particles, cpu.cfg)
    st = stirred(card.packed_carry[0], aux_sd=0.05)
    p = packed.unpack_particles(st, card.particles.capacity)
    s_card, s_scale = energy_of(p, card.cfg)
    s_cpu, _ = energy_of(packed.unpack_particles(st.cpu(), card.particles.capacity), card.cfg)
    res = dict(frame_card=e_card, frame_cpu=e_cpu, frame_rel=abs(e_card - e_cpu) / scale,
               stirred_card=s_card, stirred_cpu=s_cpu, stirred_rel=abs(s_card - s_cpu) / s_scale)
    for key in ("frame_rel", "stirred_rel"):
        if not res[key] <= ENERGY_RTOL:
            failures.append(f"{name}: {key} {res[key]} > {ENERGY_RTOL}")
    return res


def phase_energy_check(energies, names=MATERIALS):
    """``energy_check``: ``energy_record`` for each material of `names`,
    those of `energies` (name -> record) taken by ``phase_materials25``
    from its own frames of the same cubes, the others here."""
    failures, out = [], {}
    for name in names:
        if name in energies:
            out[name] = energies[name]
            continue
        card, cpu = cube(25, "cuda", 6, name), cube(25, "cpu", 6, name)
        card.step()
        cpu.step()
        out[name] = energy_record(card, cpu, name, failures)
        del card, cpu
    failures += [f"{name}: {key} {out[name][key]} > {ENERGY_RTOL}" for name in energies
                 for key in ("frame_rel", "stirred_rel") if not out[name][key] <= ENERGY_RTOL]
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

# -- the dense path -------------------------------------------------------------

ALL8 = ("elastic", "jelly", "snow", "water", "sand", "von_mises", "linear", "visco")
DENSE_CHECK_SUBSTEPS = 6
DENSE_VS_BLOCKED_SUBSTEPS = 3
DENSE_PATH_RES = 100  # scripts/benchmark/colliding_balls_energy.py's default
DENSE_PATH_TIMED_FRAMES = 10  # after one warm-up frame
DENSE_SCALE_SUBSTEPS = 6
# dense_check's sand lanes sit near the return map's knife edges, where
# the frame's rounding reaches their aux: moving each component of the
# input F by one ulp moves sand's aux by 4.5-5.0e-6 on the card and
# 4.8-6.5e-6 on the CPU at orders 1-3 (``nudged``), the card-CPU gap is
# 4.4-5.1e-6, and the control frame with CUDA's approximate rsqrt
# (``approximate_rsqrt_frame``) moves it by 8.0-8.5e-6 (F 7.0-9.0e-6;
# PERF.md, PR 8). Sand's aux is held to 7e-6, above every sound reading
# and below the control; every other field and lane keeps the frame
# bounds, and the control must break the sand bounds.
DENSE_SAND_BOUNDS = tuple((name, 7e-6 if name == "aux" else bound)
                          for name, bound in FRAME_BOUNDS)


def dense_all8(device, order, optimized=False):
    """A 3-D scene of all eight materials (dealt over 4,000 particles
    uniform in [0.3, 0.6]^3 from default_rng(8), velocities 0.5 N(0, 1)) at
    B-spline `order`, res 32, dt 1e-4, inside a sticky box [0.32, 0.7]^3
    that some particles start outside of, with the per-particle collision
    and the boundary clean-up on; on the dense path unless `optimized`."""
    from taichi_mpm_torch import MPM
    from taichi_mpm_torch.core import levelset

    rng = np.random.default_rng(8)
    pos = rng.uniform(0.3, 0.6, (4000, 3)).astype(np.float32)
    vel = (0.5 * rng.standard_normal((4000, 3))).astype(np.float32)
    sim = MPM(res=(32, 32, 32), base_delta_t=1e-4, frame_dt=DENSE_CHECK_SUBSTEPS * 1e-4,
              kernel_order=order, optimized=optimized, particle_collision=True,
              clean_boundary=True, device=device)
    for i, name in enumerate(ALL8):
        sim.add_particles(name, pos=pos[i::8], vel=vel[i::8], density=1000.0)
    sim.add_collider(levelset.box_domain((0.32,) * 3, (0.7,) * 3, friction=-1.0))
    return sim


def dense_tetris(device):
    from taichi_mpm_torch import scenes

    sim = scenes.tetris(device=device)
    sim.frame_dt = DENSE_CHECK_SUBSTEPS * sim.cfg.base_dt
    return sim


def no_launches(launches):
    """The dense path launches no kernel of the port."""
    return [f"{name} launched {n} times on the dense path" for name, n in launches.items() if n]


def dense_cpic_launches(launches, substeps):
    """The dense CPIC path launches ``body_totals`` twice a substep (P2G's
    impulse totals and G2P's penalty totals) and no other kernel."""
    return [f"{name} launched {n} times in {substeps} dense CPIC substeps"
            for name, n in launches.items()
            if n != (2 * substeps if name == "body_totals" else 0)]


def nudged(sim, seed=0):
    """`sim` finalized, each component of every F moved by one ulp up or
    down at random (default_rng(seed)): a frame from it against the
    frame from `sim` as it was measures that frame's rounding noise."""
    import torch

    sim._ensure_finalized()
    p = sim.particles
    F = p.F.cpu().numpy()
    toward = np.where(np.random.default_rng(seed).random(F.shape) < 0.5,
                      np.float32(-np.inf), np.float32(np.inf)).astype(np.float32)
    p.F = torch.as_tensor(np.nextafter(F, toward)).to(p.device)
    sim._set_particles(p)
    return sim


def lane_errors(a, b, lanes, names=("F", "aux")):
    """The largest difference of each field in `names` over the lanes
    alive in both scenes and in `lanes`."""
    pa, pb = a.particles, b.particles
    act = pa.active.cpu().numpy() & pb.active.cpu().numpy() & lanes
    return {name: float(np.abs(getattr(pa, name).cpu().numpy()[act].astype(np.float64)
                               - getattr(pb, name).cpu().numpy()[act]).max())
            for name in names}


def approximate_rsqrt_frame(make):
    """A card frame of `make("cuda")` with the dense SVD's 1/sqrt taken by
    torch.rsqrt, CUDA's approximate rsqrtf (the card-only fault that
    ``math.cmat3._rsqrt`` avoids): the control the sand bounds must
    catch."""
    import torch

    from taichi_mpm_torch.math import cmat3

    exact = cmat3._rsqrt
    cmat3._rsqrt = torch.rsqrt
    try:
        sim = make("cuda")
        sim.step()
    finally:
        cmat3._rsqrt = exact
    return sim


def phase_dense_check():
    """Each dense scene (all eight materials in 3-D at orders 1, 2 and 3;
    the 2-D tetris scene): one 6-substep frame on the card and on the
    CPU, held to the frame bounds (sand lanes to DENSE_SAND_BOUNDS) with
    the same particles alive and the plastic events equal but for sand's
    knife edges (counted on the CPU frame,
    ``diagnostics.dense_sand_edges_per_substep``); a second card frame
    equal in bits; no kernel launched. For the 3-D scenes, beside the
    sand lanes' gap: their one-ulp noise (``nudged``) on the card and on
    the CPU, and the control frame (``approximate_rsqrt_frame``), whose
    sand lanes must break DENSE_SAND_BOUNDS."""
    from taichi_mpm_torch import diagnostics

    failures, out = [], {}
    makes = {f"all8_order{k}": (lambda dev, k=k: dense_all8(dev, k)) for k in (1, 2, 3)}
    makes["tetris_2d"] = dense_tetris
    zero_counts()
    for label, make in makes.items():
        card, cpu, rerun = make("cuda"), make("cpu"), make("cuda")
        card.step()
        rerun.step()
        with diagnostics.dense_sand_edges_per_substep() as edges:
            cpu.step()
        sand = cpu.particles.mat.numpy() == SAND
        errs = frame_errors(card, cpu, f"{label} card vs CPU", failures,
                            plast_slack=sum(edges), lanes=~sand)
        same_bits(card, rerun, f"{label} rerun", failures)
        out[label] = dict(particles=card.particles.count(), plast=card.plasticity_counter,
                          plast_cpu=cpu.plasticity_counter, sand_knife_edges=sum(edges),
                          errors=errs, dense=card.packed_carry is None)
        if not sand.any():
            continue
        out[label]["sand_errors"] = frame_errors(
            card, cpu, f"{label} card vs CPU, sand", failures, DENSE_SAND_BOUNDS,
            plast_slack=sum(edges), lanes=sand)
        noise = {}
        for dev, base in (("cuda", card), ("cpu", cpu)):
            moved = nudged(make(dev))
            moved.step()
            noise[dev] = lane_errors(base, moved, sand)
        control = approximate_rsqrt_frame(make)
        control_errs = lane_errors(control, cpu, sand, [name for name, _ in DENSE_SAND_BOUNDS])
        if all(control_errs[name] <= bound for name, bound in DENSE_SAND_BOUNDS):
            failures.append(f"{label}: the approximate-rsqrt control passes the sand bounds "
                            f"({control_errs})")
        out[label].update(sand_noise_card=noise["cuda"], sand_noise_cpu=noise["cpu"],
                          control_sand_errors=control_errs)
    launches = read_counts()
    failures += no_launches(launches)
    emit(dict(phase="dense_check", **out, launches=launches, failures=failures))
    raise_failures(failures)
    return launches


# dense_vs_blocked: the same frame on the dense route and on the fused
# route, both on the card. Each scene is held to twice the largest of
# three readings of that difference (x at least two ulps of a position in
# [0.5, 1)): the card's, the port's CPU dense frame against the fused
# kernels' twins, and the JAX package's dense substeps against its fused
# Pallas kernels in interpret mode (tests/port/port_helpers.py
# jax-dense-vs-blocked; PERF.md, PR 8). The bounds the JAX package holds
# its blocked path to against its dense one (tests/test_blocked.py) are
# the ceiling.
DENSE_VS_BLOCKED_CEILING = dict(x=2e-6, v=2e-4, F=2e-5, C=2e-3, aux=2e-5)
DENSE_VS_BLOCKED_BOUNDS = {
    "cube25": dict(x=1.2e-7, v=6e-9, F=5e-10, C=8e-9),
    "all8_order2": dict(x=1.2e-7, v=3e-6, F=1.1e-5, C=2.5e-6, aux=1e-5),
    "jello50": dict(x=2.5e-7, v=1.3e-6, F=2e-6, C=7e-7),
}
assert all(b <= DENSE_VS_BLOCKED_CEILING[k]
           for bounds in DENSE_VS_BLOCKED_BOUNDS.values() for k, b in bounds.items())


def jello50(device, optimized):
    from taichi_mpm_torch import scenes

    sim = scenes.oscillating_jello(res=50, device=device)
    sim.optimized = optimized  # the path is chosen at the first frame
    return sim


def phase_dense_vs_blocked():
    """Three scenes, each one frame on the dense route and on the fused
    route, both on the card, particles matched by id, within
    DENSE_VS_BLOCKED_BOUNDS: benchmark_cube(cells=25) (125k jelly at
    rest, 3 substeps), dense_all8 at order 2 (every material's stress,
    F update and return map; sand's plastic events may differ by its
    knife edges, counted on the dense frame) and
    scripts/benchmark/oscillating_jello.py at res 50 (a stretched jelly
    block, a frame of 20 substeps)."""
    from taichi_mpm_torch import diagnostics

    makes = {
        "cube25": lambda opt: cube(25, "cuda", DENSE_VS_BLOCKED_SUBSTEPS),
        "all8_order2": lambda opt: dense_all8("cuda", 2, optimized=opt),
        "jello50": lambda opt: jello50("cuda", opt),
    }
    failures, out = [], {}
    for label, make in makes.items():
        fused, dense = make(True), make(True)
        dense.optimized = False
        for sim in (fused, dense):
            sim._ensure_finalized()
            tag_ids(sim)
        fused.step()
        with diagnostics.dense_sand_edges_per_substep() as edges:
            dense.step()
        if dense.packed_carry is not None or fused.packed_carry is None:
            failures.append(f"{label}: the scenes did not take the dense and the fused path")
        bounds = tuple(DENSE_VS_BLOCKED_BOUNDS[label].items())
        errs = id_errors(dense, fused, f"{label} dense vs fused card frame", failures, bounds)
        slack = sum(edges)
        if not abs(dense.plasticity_counter - fused.plasticity_counter) <= slack:
            failures.append(f"{label}: plastic events {dense.plasticity_counter} vs "
                            f"{fused.plasticity_counter}, {slack} at sand's knife edges")
        out[label] = dict(particles=dense.particles.count(),
                          substeps=round(dense.frame_dt / dense.cfg.base_dt), errors=errs,
                          bounds=dict(bounds), plast=dense.plasticity_counter,
                          plast_fused=fused.plasticity_counter, sand_knife_edges=slack)
    emit(dict(phase="dense_vs_blocked", **out, failures=failures))
    raise_failures(failures)


def dense_path_reference():
    """The CPU's first frame of phase dense_path's scene: (its energy, the
    sum of its terms' magnitudes, the seconds the frame took)."""
    from taichi_mpm_torch import scenes

    cpu = scenes.colliding_balls_energy(res=DENSE_PATH_RES, device="cpu")
    t0 = time.perf_counter()
    cpu.step()
    return (*energy_of(cpu.particles, cpu.cfg), time.perf_counter() - t0)


def phase_dense_path(card, reference):
    """The slice at full size: scripts/benchmark/colliding_balls_energy.py
    at res 100 (two Poisson-seeded jelly balls, dt 3e-4, 33 substeps per
    0.01 s frame) through runner.simulate with print_energy, a warm-up
    frame and DENSE_PATH_TIMED_FRAMES timed frames, every launch count set
    to 0 first: ms per substep, particle-steps/s, host syncs per substep
    (0 at fixed dt), peak device memory, each frame's energy and its
    drift from frame 0; the first frame's energy against the CPU's frame
    (`reference`: ``dense_path_reference``, run in the check block) within
    ENERGY_RTOL of its terms' magnitudes; every particle active, finite
    and in the domain; no kernel launched. Returns the launches."""
    import io
    from contextlib import redirect_stdout

    import torch

    from taichi_mpm_torch import runner, scenes

    failures = []
    t0 = time.perf_counter()
    sim = scenes.colliding_balls_energy(res=DENSE_PATH_RES, device="cuda")
    sim._ensure_finalized()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n = sim.particles.count()
    substeps = max(1, int(round(sim.frame_dt / sim.cfg.base_dt)))
    e_cpu, scale, cpu_frame_s = reference
    torch.cuda.reset_peak_memory_stats()
    timed = Timed(sim)
    args = runner.parse_args(["--frames", str(1 + DENSE_PATH_TIMED_FRAMES)])
    zero_counts()
    log = io.StringIO()
    with redirect_stdout(log):
        runner.simulate(timed, args, print_energy=True)
    launches = read_counts()
    failures += no_launches(launches)
    check_domain(sim, n, failures)
    energies = timed.energies
    rel = abs(energies[0] - e_cpu) / scale
    if not rel <= ENERGY_RTOL:
        failures.append(f"the first frame's energy {energies[0]} vs the CPU's {e_cpu}: {rel}")
    if not all(np.isfinite(energies)):
        failures.append(f"energies {energies}")
    steps = timed.steps[1:]
    step_s = sum(timed.ms["step"][1:]) / 1e3
    n_timed = DENSE_PATH_TIMED_FRAMES * substeps
    emit(dict(phase="dense_path", card=card, particles=n, res=DENSE_PATH_RES,
              substeps_per_frame=substeps, timed_substeps=n_timed,
              ms_per_substep=step_s * 1e3 / n_timed, particle_steps_per_s=n * n_timed / step_s,
              host_syncs_per_substep=sum(st["host_syncs"] for st in steps) / n_timed,
              warmup_frame_ms=timed.ms["step"][0], frame_ms=timed.ms["step"],
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, setup_s=setup_s,
              energies=energies, drift=[e - energies[0] for e in energies],
              energy_cpu_frame0=e_cpu, energy_rel_vs_cpu=rel, cpu_frame_s=cpu_frame_s,
              runner_lines=log.getvalue().splitlines()[-2:], launches=launches,
              clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"), failures=failures))
    raise_failures(failures)
    return launches


def phase_dense_adaptive():
    """AsyncMPM on the dense path, one frame each on the card and the CPU:
    tests/test_adaptive.py's 2-D scene (a 64-particle jelly block, res
    64^2, base_delta_t 1e-3, frame_dt 5e-3, unit 1e-6) and
    scripts/benchmark/oscillating_jello.py at res 50 (optimized=False):
    equal substep counts, the frame bounds, the dt range printed."""
    from taichi_mpm_torch import scenes
    from taichi_mpm_torch.core.adaptive import AsyncMPM

    def block(device):
        sim = AsyncMPM(res=(64, 64), base_delta_t=1e-3, frame_dt=5e-3, unit_delta_t=1e-6,
                       device=device)
        pos = np.stack(np.meshgrid(np.linspace(0.4, 0.6, 8), np.linspace(0.6, 0.8, 8)),
                       -1).reshape(-1, 2)
        sim.add_particles("jelly", pos=pos, E=5e4, nu=0.3)
        return sim

    def jello(device):
        return scenes.oscillating_jello(res=50, device=device, solver=AsyncMPM,
                                        unit_delta_t=1e-6)

    failures, out = [], {}
    for label, make in (("block_2d", block), ("jello_res50", jello)):
        card, cpu = make("cuda"), make("cpu")
        card.step()
        cpu.step()
        if card.last_substeps != cpu.last_substeps:
            failures.append(f"{label}: {card.last_substeps} substeps vs the CPU's "
                            f"{cpu.last_substeps}")
        out[label] = dict(particles=card.particles.count(), substeps=card.last_substeps,
                          dt_range=card.last_dt_range, dt_range_cpu=cpu.last_dt_range,
                          errors=frame_errors(card, cpu, f"{label} card vs CPU", failures))
    emit(dict(phase="dense_adaptive", **out, failures=failures))
    raise_failures(failures)


def dense_stage_ms(sim):
    """CUDA-event ms of each stage of a dense substep on the scene's state:
    the force, the rest of P2G (the stencil values and the ordered
    scatter), the grid update, the gather and the G2P finish."""
    from taichi_mpm_torch.core import transfer
    from taichi_mpm_torch.materials import models

    p, cfg, dt = sim.particles, sim.cfg, sim.cfg.base_dt
    cols = tuple(sim.colliders)
    grid = transfer.p2g(p, cfg, dt)
    grid_v, _ = transfer.grid_update(grid, cfg, cols, sim.t, dt, sim._xg)
    v, b = transfer.gather(p, grid_v, cfg)
    ms = dict(
        force=cuda_ms(lambda: models.dispatch_force(cfg.active_materials, p.mat, p.F, p.aux,
                                                    p.params, p.vol), 2),
        p2g=cuda_ms(lambda: transfer.p2g(p, cfg, dt), 2),
        grid=cuda_ms(lambda: transfer.grid_update(grid, cfg, cols, sim.t, dt, sim._xg), 2),
        gather=cuda_ms(lambda: transfer.gather(p, grid_v, cfg), 2),
        finish=cuda_ms(lambda: transfer.g2p_finish(p, v, b, cfg, dt, return_count=True), 2))
    ms["p2g_without_force"] = ms["p2g"] - ms["force"]
    return ms


def phase_dense_scale(card, fused_ms):
    """benchmark_cube(cells=100) (8M jelly) on the dense path: a 1-substep
    warm-up frame, then one DENSE_SCALE_SUBSTEPS-substep frame timed, its
    ms per substep and peak memory beside the fused route's ms per
    substep of this run (`fused_ms`, phase main_path); no bound on its
    speed. All particles active, finite and in the domain; the stages'
    CUDA-event ms on the state after the frame (``dense_stage_ms``)."""
    import torch

    from taichi_mpm_torch import scenes

    failures = []
    sim = scenes.benchmark_cube(cells=100, res=125, device="cuda", **CUBE_KW["jelly"])
    sim.optimized = False
    sim._ensure_finalized()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    sim.step(frame_dt=sim.cfg.base_dt)
    sim.sync()
    t0 = time.perf_counter()
    sim.step(frame_dt=DENSE_SCALE_SUBSTEPS * sim.cfg.base_dt)
    sim.sync()
    frame_s = time.perf_counter() - t0
    launches = read_counts()
    failures += no_launches(launches)
    check_domain(sim, 8_000_000, failures)
    if sim.packed_carry is not None:
        failures.append("the 8M cube did not take the dense path")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit(dict(phase="dense_scale", card=card, particles=sim.particles.count(),
              substeps=DENSE_SCALE_SUBSTEPS, ms_per_substep=frame_s * 1e3 / DENSE_SCALE_SUBSTEPS,
              fused_ms_per_substep=fused_ms, peak_mem_gb=peak_gb,
              stage_ms=dense_stage_ms(sim), launches=launches, failures=failures))
    raise_failures(failures)
    return launches


# -- the dense CPIC path ----------------------------------------------------------

DENSE_CPIC_SUBSTEPS = 6  # the 10k 3-D wheel's frame in dense_cpic_check
# the 2-D scripts' snapshots with their sand on the wheel (the port's CPU
# run of each script in 1e-3 s frames to 0.19 s and 0.15 s,
# tests/port/port_helpers.py wheel-2d-snapshot): path, frames done
WHEEL_2D_SNAPSHOTS = {
    "sand_wheel_2d": ("tests/fixtures/sand_wheel_2d_coupled.npz", 190),
    "async_wheel": ("tests/fixtures/async_wheel_coupled.npz", 150),
}
COUPLED_FRAMES = 3  # of COUPLED_FRAME_DT from each snapshot in wheel_2d_coupled
COUPLED_FRAME_DT = 1e-3
COUPLED_MIN_NEAR = 40  # grains near the wheel (the CPU's frames: 61 and 265)
# wheel_2d_coupled's stage-by-stage check (diagnostics.coupled_stage_partings,
# the card's substep from the CPU's state): what each stage may part from
# the CPU's by, in ulps of the largest addend that fed it. The integer
# stages (the CDF's tags and owners, the particles' states and near_b)
# must be equal. The body totals summed on the card from the CPU's own
# addends (sum_order.*_kernel_*) must give the CPU's bits: the kernel sums
# in the CPU's order, so 0 ulps. Every other stage: STAGE_ULPS.
STAGE_ULPS = 64.0
SAND_WHEEL_CHECK_FRAMES = 10
SAND_WHEEL_CHECK_FRAME_DT = 2e-3  # 20 substeps a frame, the source emitting each frame
DENSE_CPIC_VS_FUSED_SUBSTEPS = 4
WHEEL_2D_TIMED_FRAMES = 2  # sand_wheel_2D.py's 0.01 s frames, after one warm-up frame
ASYNC_WHEEL_TIMED_FRAMES = 2
DENSE_CPIC_SCALE_SUBSTEPS = 20
# The JAX package's own pair on dense_cpic_vs_fused's scene: its oracle
# cpic_substep (jitted on the CPU) against its packed CPIC frame (the
# Pallas kernels in interpret mode), 4 substeps, particles sorted by id
# (PYTHONPATH=. python tests/port/port_helpers.py jax-cpic-dense-vs-blocked
# on the CPU; PERF.md, section 6).
JAX_CPIC_PAIR = dict(x=5.960464477539063e-08, v=1.1205673217773438e-05, F=0.0,
                     states_differ=0, body_omega=3.5762786865234375e-07, body_vel=0.0)


def plate_2d(device):
    """tests/test_cpic.py::test_particles_rest_on_thin_plate's scene: 32
    jelly particles falling at 0.5 m/s onto a scripted segment, res 32^2,
    one frame of 20 substeps."""
    from taichi_mpm_torch import MPM
    from taichi_mpm_torch.rigid.mesh import segment_mesh_2d

    sim = MPM(res=(32, 32), base_delta_t=1e-4, frame_dt=2e-3, gravity=(0, -10.0), device=device)
    xs, ys = np.linspace(0.4, 0.6, 8), np.linspace(0.53, 0.6, 4)
    sim.add_particles("jelly", pos=np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2),
                      vel=(0.0, -0.5), E=1e4, nu=0.3)
    sim.add_particles("rigid", mesh=segment_mesh_2d((-0.3, 0.0), (0.3, 0.0)),
                      scripted_position=lambda t: (0.5, 0.5), codimensional=True, friction=0.0)
    return sim


def sand_wheel_check(device):
    from taichi_mpm_torch import scenes

    sim = scenes.sand_wheel_2d(res=128, device=device)
    sim.frame_dt = SAND_WHEEL_CHECK_FRAME_DT
    return sim


def run_frames(sim, frames, source=None):
    for f in range(frames):
        if source is not None:
            source(sim, f)
        sim.step()
    return sim


def cpic_errors(a, b, label, failures, plast_slack=0):
    """Two CPIC scenes after the same frames: frame_errors at the CPIC
    bounds, states and near_b equal, the bodies within BODY_BOUNDS."""
    errs = frame_errors(a, b, label, failures, CPIC_BOUNDS, plast_slack)
    act = a.particles.active.cpu().numpy() & b.particles.active.cpu().numpy()
    for name in ("states", "near_b"):
        if not np.array_equal(getattr(a.particles, name).cpu().numpy()[act],
                              getattr(b.particles, name).cpu().numpy()[act]):
            failures.append(f"{label}: {name} differ")
    for name, bnd in BODY_BOUNDS:
        errs["body_" + name] = float(np.abs(getattr(a.bodies, name).cpu().numpy().astype(
            np.float64) - getattr(b.bodies, name).cpu().numpy()).max())
        if not errs["body_" + name] <= bnd:
            failures.append(f"{label}: body {name} differs by {errs['body_' + name]} > {bnd}")
    return errs


def phase_dense_cpic_check():
    """The dense CPIC frame (``rigid/cpic.py``: the coloured transfers over
    the dense grid CDF) on the card against the CPU: the 2-D plate of
    tests/test_cpic.py (a 20-substep frame), scripts/async/wheel.py at res
    128 (2,361 sand particles, one 0.01 s frame at adaptive dt),
    scripts/mls-cpic/sand_wheel_2D.py at res 128 (10 frames of 2e-3 s,
    its source emitting each frame) and the 10k water wheel of
    ``cpic_check`` with optimized=False (6 substeps; it and the plate
    must have particles near their bodies: the scripts' sand starts above
    its wheel): the CPIC bounds of
    ``cpic_check`` (x 5e-6, v 5e-4, F 5e-5, states and near_b equal,
    bodies 1e-5 / 1e-6), plastic events equal but for sand's knife edges
    (counted on the CPU frame), equal adaptive substep counts, a second
    card run equal in bits (bodies too), ``body_totals`` launched twice a
    substep and no other kernel."""
    from taichi_mpm_torch import diagnostics, scenes

    def wheel3d(device):
        sim = cpic_check_scene(device)
        sim.optimized = False
        sim.frame_dt = DENSE_CPIC_SUBSTEPS * sim.cfg.base_dt
        return sim

    cases = {
        "plate_2d": (plate_2d, 1, None),
        "async_wheel_res128": (lambda dev: scenes.async_wheel(res=128, device=dev), 1, None),
        "sand_wheel_2d_res128": (sand_wheel_check, SAND_WHEEL_CHECK_FRAMES,
                                 scenes.sand_wheel_2d_source),
        "wheel_3d_10k_unoptimized": (wheel3d, 1, None),
    }
    failures, out = [], {}
    zero_counts()
    card_substeps = 0
    for label, (make, frames, source) in cases.items():
        t0 = time.perf_counter()
        card = run_frames(make("cuda"), frames, source)
        card_s = time.perf_counter() - t0
        rerun = run_frames(make("cuda"), frames, source)
        t0 = time.perf_counter()
        with diagnostics.dense_sand_edges_per_substep() as edges:
            cpu = run_frames(make("cpu"), frames, source)
        cpu_s = time.perf_counter() - t0
        errs = cpic_errors(card, cpu, f"{label} card vs CPU", failures, plast_slack=sum(edges))
        same_bits(card, rerun, f"{label} rerun", failures)
        for name in ("pos", "vel", "rot", "omega"):
            if not np.array_equal(getattr(card.bodies, name).cpu().numpy(),
                                  getattr(rerun.bodies, name).cpu().numpy()):
                failures.append(f"{label} rerun: body {name} differs")
        substeps = getattr(card, "last_substeps", None)
        if substeps != getattr(cpu, "last_substeps", None):
            failures.append(f"{label}: {substeps} substeps vs the CPU's {cpu.last_substeps}")
        card_substeps += 2 * (substeps if substeps is not None  # the card run and its rerun
                              else frames * round(card.frame_dt / card.cfg.base_dt))
        if card.packed_carry is not None:
            failures.append(f"{label}: not on the dense path")
        if label in ("plate_2d", "wheel_3d_10k_unoptimized") and not card.particles.near_b.any():
            failures.append(f"{label}: no particle near the body: the coupling went untested")
        out[label] = dict(particles=card.particles.count(), frames=frames,
                          adaptive_substeps=substeps,
                          dt_range=getattr(card, "last_dt_range", None),
                          near_b=int(card.particles.near_b.sum()), errors=errs,
                          plast=card.plasticity_counter, plast_cpu=cpu.plasticity_counter,
                          sand_knife_edges=sum(edges), card_s=card_s, cpu_s=cpu_s)
    launches = read_counts()
    failures += dense_cpic_launches(launches, card_substeps)
    emit(dict(phase="dense_cpic_check", **out, launches=launches, failures=failures))
    raise_failures(failures)
    return launches


def phase_dense_cpic_vs_fused():
    """``cpic_check``'s 10k water wheel, 4 substeps on the card, on the
    dense CPIC frame (optimized=False) and on the fused CPIC frame,
    particles matched by id: the bounds of tests/test_cpic.py::
    test_matches_oracle_cpic (x 5e-6, v 5e-4, F 5e-5, states equal, body
    omega and vel 1e-5), printed beside the JAX package's own pair on the
    same scene (JAX_CPIC_PAIR)."""
    from taichi_mpm_torch import convert

    def make(optimized):
        sim = cpic_check_scene("cuda")
        sim.optimized = optimized
        sim.frame_dt = DENSE_CPIC_VS_FUSED_SUBSTEPS * sim.cfg.base_dt
        sim._ensure_finalized()
        tag_ids(sim)
        sim.step()
        return sim

    failures = []
    dense, fused = make(False), make(None)
    if dense.packed_carry is not None or fused.packed_carry is None:
        failures.append("the scenes did not take the dense and the fused path")
    errs = id_errors(dense, fused, "dense vs fused CPIC frame", failures, CPIC_BOUNDS)

    def states_by_id(sim):
        a = convert.particles_to_numpy(sim.particles)
        act = a["active"]
        return a["states"][act][np.argsort(a["params"][act, ID_ROW_PARAM], kind="stable")]

    if not np.array_equal(states_by_id(dense), states_by_id(fused)):
        failures.append("dense vs fused CPIC frame: states differ")
    for name in ("omega", "vel"):
        errs["body_" + name] = float(np.abs(getattr(dense.bodies, name).cpu().numpy().astype(
            np.float64) - getattr(fused.bodies, name).cpu().numpy()).max())
        if not errs["body_" + name] <= 1e-5:
            failures.append(f"dense vs fused CPIC frame: body {name} differs by "
                            f"{errs['body_' + name]}")
    emit(dict(phase="dense_cpic_vs_fused", particles=dense.particles.count(),
              substeps=DENSE_CPIC_VS_FUSED_SUBSTEPS, errors=errs,
              near_b=int(dense.particles.near_b.sum()), jax_pair=JAX_CPIC_PAIR,
              failures=failures))
    raise_failures(failures)


def wheel_2d_scene(name, device, frame_dt=COUPLED_FRAME_DT):
    """sand_wheel_2D.py or async/wheel.py (WHEEL_2D_SNAPSHOTS' `name`) at
    res 128 on `device`, frames of `frame_dt`."""
    from taichi_mpm_torch import scenes

    sim = getattr(scenes, name)(res=128, device=device)
    sim.frame_dt = frame_dt
    return sim


def wheel_2d_source(name):
    from taichi_mpm_torch import scenes

    return scenes.sand_wheel_2d_source if name == "sand_wheel_2d" else None


def coupled_run(name, device):
    """The script `name` from its coupled snapshot, COUPLED_FRAMES frames
    (its source emitting each frame). Returns the scene and its
    substeps."""
    path, first = WHEEL_2D_SNAPSHOTS[name]
    sim, source, substeps = wheel_2d_scene(name, device), wheel_2d_source(name), 0
    sim.load(path)
    for f in range(first, first + COUPLED_FRAMES):
        if source is not None:
            source(sim, f)
        sim.step()
        substeps += getattr(sim, "last_substeps", None) or round(sim.frame_dt / sim.cfg.base_dt)
    return sim, substeps


def stage_failures(label, partings, failures):
    """wheel_2d_coupled's gate on each substep's stage partings: integer
    stages equal, the kernel's sums of the CPU's addends in the CPU's bits,
    every other stage within STAGE_ULPS. Returns each stage's largest
    parting over the substeps (ulps, or whether always equal)."""
    worst = {}
    for n, sub in enumerate(partings):
        for key, r in sub.items():
            if "equal" in r:
                worst[key] = worst.get(key, True) and r["equal"]
                if not r["equal"]:
                    failures.append(f"{label} substep {n}: {key} differs")
                continue
            worst[key] = max(worst.get(key, 0.0), r["ulps"])
            bound = 0.0 if "_kernel_" in key else (None if "_masked_sum_" in key else STAGE_ULPS)
            if bound is not None and not r["ulps"] <= bound:
                failures.append(f"{label} substep {n}: {key} parts by {r['ulps']} ulps of "
                                f"{r['scale']} > {bound}")
    return worst


def phase_body_totals_check():
    """``body_totals_check``: the kernel ``body_totals`` against its plain
    twin on the same inputs, the twin on the CPU (the order that defines
    the sums): ``diagnostics.body_totals_edge_inputs`` (several offsets and
    bodies, lanes of no body, a body with no lane, a row where one body
    holds 95% of the lanes, one lane, no valid lane, N about the kernels'
    word, tile, batch and chunk, hits on the first and last lane only, one
    body on every lane of a 100,000-lane row, 8 bodies, the 2-D and the
    G2P shapes) and the addends of both 2-D scripts' first coupled substep
    (P2G's per-offset totals and G2P's penalty totals, taken on the CPU):
    equal bits, and equal bits over two launches. Beside each, how far
    torch's masked sums on the card part from the twin (the sums the card
    took before)."""
    import torch

    from taichi_mpm_torch import diagnostics
    from taichi_mpm_torch.ops import body_sums

    cases = {k: (*(torch.as_tensor(a) for a in v[:3]), v[3])
             for k, v in diagnostics.body_totals_edge_inputs().items()}
    for name, (path, _) in WHEEL_2D_SNAPSHOTS.items():
        sim = wheel_2d_scene(name, "cpu")
        sim.load(path)
        stages = diagnostics.substep_stages(sim)
        for key in ("p2g", "g2p"):
            cases[f"{name}_{key}"] = (*stages[f"{key}_rows"], sim.bodies.num)
    failures, out = [], {}
    for label, (rid, J, tau, R) in cases.items():
        want = body_sums.body_totals_plain(rid, J, tau, R)
        dev = [a.cuda() for a in (rid, J, tau)]
        got = body_sums.body_totals(*dev, R)
        again = body_sums.body_totals(*dev, R)
        masked = diagnostics.masked_body_sums(*dev, R)
        torch.cuda.synchronize()
        got, again, masked = ([a.cpu() for a in v] for v in (got, again, masked))
        bits, rerun = (all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                           for g, w in zip(x, y))
                       for x, y in ((got, want), (got, again)))
        if not bits:
            failures.append(f"{label}: the kernel's totals are not the twin's bits")
        if not rerun:
            failures.append(f"{label}: two launches differ")
        out[label] = dict(
            rows=list(rid.shape), bodies=R, components=[J.shape[-1], tau.shape[-1]],
            valid=int((rid >= 0).sum()), bits=bits, rerun_bits=rerun,
            max_abs_err=max(max_abs(g, w) for g, w in zip(got, want)),
            masked_sum_max_abs_err=max(max_abs(m, w) for m, w in zip(masked, want)))
    emit(dict(phase="body_totals_check", cases=out, failures=failures))
    raise_failures(failures)


def phase_wheel_2d_coupled(card):
    """``wheel_2d_coupled``: both 2-D scripts from their coupled snapshots
    (WHEEL_2D_SNAPSHOTS, the sand on the wheel), COUPLED_FRAMES frames of
    1e-3 s (the sand source emitting each frame), on the card against the
    CPU: the CPIC bounds (x 5e-6, v 5e-4, F 5e-5, states and near_b equal,
    plastic events but for sand's knife edges) and the body bounds (vel
    and omega 1e-5, pos 1e-6), equal substeps, at least COUPLED_MIN_NEAR
    grains near the wheel, a second card run equal in bits (bodies too),
    ``body_totals`` twice a substep and no other kernel. Then the first
    frame substep by substep (``diagnostics.coupled_stage_partings``: each
    card substep from the CPU's state), gated by ``stage_failures``, with
    the first stage that parts by more than 4 ulps and how far torch's
    masked sums of the same addends part (``sum_order.*_masked_sum_*``).
    Returns the launches of the coupled frames."""
    from taichi_mpm_torch import diagnostics

    failures, out = [], {}
    zero_counts()
    card_substeps = 0
    for name in WHEEL_2D_SNAPSHOTS:
        t0 = time.perf_counter()
        dev, n = coupled_run(name, "cuda")
        card_s = time.perf_counter() - t0
        rerun, n_rerun = coupled_run(name, "cuda")
        card_substeps += n + n_rerun
        with diagnostics.dense_sand_edges_per_substep() as edges:
            cpu, n_cpu = coupled_run(name, "cpu")
        errs = cpic_errors(dev, cpu, f"{name} card vs CPU", failures, plast_slack=sum(edges))
        same_bits(dev, rerun, f"{name} rerun", failures)
        for b in ("pos", "vel", "rot", "omega"):
            if not np.array_equal(getattr(dev.bodies, b).cpu().numpy(),
                                  getattr(rerun.bodies, b).cpu().numpy()):
                failures.append(f"{name} rerun: body {b} differs")
        if n != n_cpu:
            failures.append(f"{name}: {n} substeps vs the CPU's {n_cpu}")
        near = int(cpu.particles.near_b.sum())
        if near < COUPLED_MIN_NEAR:
            failures.append(f"{name}: {near} grains near the wheel on the CPU, fewer than "
                            f"{COUPLED_MIN_NEAR}: the coupling went untested")
        out[name] = dict(particles=dev.particles.count(), substeps=n, near_b=near,
                         near_b_card=int(dev.particles.near_b.sum()),
                         omega=float(dev.bodies.omega[1, 0]),
                         omega_cpu=float(cpu.bodies.omega[1, 0]), errors=errs,
                         plast=dev.plasticity_counter, plast_cpu=cpu.plasticity_counter,
                         sand_knife_edges=sum(edges), card_s=card_s)
    launches = read_counts()
    failures += dense_cpic_launches(launches, card_substeps)
    stages = {}
    for name, (path, first) in WHEEL_2D_SNAPSHOTS.items():
        partings, _ = diagnostics.coupled_stage_partings(
            lambda dev, name=name: wheel_2d_scene(name, dev), path, first, wheel_2d_source(name),
            device="cuda")
        stages[name] = dict(substeps=len(partings),
                            first_parting_over_4_ulps=diagnostics.first_parting(partings),
                            worst=stage_failures(f"{name} stages", partings, failures))
    emit(dict(phase="wheel_2d_coupled", card=card, **out, stages=stages, stage_ulps=STAGE_ULPS,
              launches=launches, failures=failures))
    raise_failures(failures)
    return launches


def phase_wheel_2d_path(card):
    """The 2-D CPIC scene scripts through ``runner.simulate`` on the card,
    every launch count set to 0 first, each resumed (``--continue``) from
    its coupled snapshot (WHEEL_2D_SNAPSHOTS: the sand on the wheel, at
    0.19 s and 0.15 s) in the scripts' own 0.01 s frames:
    scripts/mls-cpic/sand_wheel_2D.py at res 128 (its source emitting each
    frame, 100 substeps a frame), a warm-up frame and WHEEL_2D_TIMED_FRAMES
    timed frames, and scripts/async/wheel.py at res 128 (global adaptive
    dt), a warm-up frame and ASYNC_WHEEL_TIMED_FRAMES: ms per substep,
    particle-steps/s, host syncs per substep, particles, substeps per frame
    and dt range (adaptive), the wheel's omega, which must be finite and
    nonzero with sand near the wheel, every particle finite and in the
    domain, ``body_totals`` twice a substep and no other kernel. Returns
    the launches."""
    import io
    import shutil
    import tempfile
    from contextlib import redirect_stdout

    from taichi_mpm_torch import runner

    failures, out = [], {}
    zero_counts()
    substeps = 0
    for label, timed_frames in (("sand_wheel_2d", WHEEL_2D_TIMED_FRAMES),
                                ("async_wheel", ASYNC_WHEEL_TIMED_FRAMES)):
        sim = wheel_2d_scene(label, "cuda", frame_dt=0.01)
        source = wheel_2d_source(label)
        path, done = WHEEL_2D_SNAPSHOTS[label]
        cont = round(done * COUPLED_FRAME_DT / sim.frame_dt) - 1  # the last 0.01 s frame done
        counts = []  # each frame's particles, after its emission

        def update(s, f, source=source, counts=counts):
            s.frame_dt = 0.01  # the snapshot's own frame_dt was 1e-3
            if source is not None:
                source(s, f)
            counts.append(s.particles.count() if s.particles is not None
                          else sum(b["x"].shape[0] for b in s._pending))

        timed = Timed(sim)
        log = io.StringIO()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_wheel_2d_") as d:
            shutil.copy(path, runner.snapshot_path(d, cont))
            args = runner.parse_args(["--frames", str(cont + 2 + timed_frames), "--continue",
                                      str(cont), "--out", d])
            with redirect_stdout(log):
                runner.simulate(timed, args, frame_update=update)
        per_frame = [st["substeps"] or round(sim.frame_dt / sim.cfg.base_dt)
                     for st in timed.steps]
        substeps += sum(per_frame)
        n_timed = sum(per_frame[1:])
        step_s = sum(timed.ms["step"][1:]) / 1e3
        psteps = sum(n * k for n, k in zip(counts[1:], per_frame[1:]))
        check_domain(sim, sim.particles.count(), failures)
        omega = float(sim.bodies.omega[1, 0])
        reached = int(sim.particles.near_b.sum()) > 0
        if not (np.isfinite(omega) and omega != 0.0 and reached):
            failures.append(f"{label}: the wheel's omega is {omega} (sand near it: {reached})")
        out[label] = dict(
            particles=sim.particles.count(), resumed_at_t=float(np.float32(done * COUPLED_FRAME_DT)),
            frames=1 + timed_frames, timed_substeps=n_timed,
            substeps_per_frame=per_frame, ms_per_substep=step_s * 1e3 / n_timed,
            particle_steps_per_s=psteps / step_s,
            host_syncs_per_substep=sum(st["host_syncs"] for st in timed.steps[1:]) / n_timed,
            dt_range=getattr(sim, "last_dt_range", None), warmup_frame_ms=timed.ms["step"][0],
            frame_ms=timed.ms["step"], wheel_omega=omega, sand_near_wheel=reached,
            near_b=int(sim.particles.near_b.sum()),
            y_min=float(sim.particles.x[sim.particles.active][:, 1].min()),
            runner_lines=log.getvalue().splitlines()[-1:])
    launches = read_counts()
    failures += dense_cpic_launches(launches, substeps)
    emit(dict(phase="wheel_2d_path", card=card, **out, launches=launches,
              clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"), failures=failures))
    raise_failures(failures)
    return launches


def dense_cpic_stage_ms(sim):
    """CUDA-event ms of each stage of a dense CPIC substep on the scene's
    state (not advanced): the rigid prologue and CDF (the host's rigid
    solves, the rasterize, the gather), P2G (+ impulses), the grid update,
    G2P (+ penalty) and the rigid advance."""
    import dataclasses

    from taichi_mpm_torch.core import transfer
    from taichi_mpm_torch.rigid import body, cdf, cpic
    from taichi_mpm_torch.rigid.cpic_blocked import _solve_bodies

    p, b, cfg, scene, dt = sim.particles, sim.bodies, sim.cfg, sim.rigid_scene, sim.cfg.base_dt
    R = b.num

    def prologue():
        bb = _solve_bodies(b, scene, dt)
        xb, _, elem = body.boundary_particle_world(bb, scene.bp_rid, scene.bp_offset,
                                                   scene.bp_normal, scene.bp_elem)
        planes = cdf.rasterize_rigid_boundary(xb, elem, scene.bp_rid, R, cfg)
        nd = cdf.stencil_node_data(p.x, cdf.DenseNodeCDF(*planes, cfg), cfg)
        return planes, nd, cdf.gather_cdf_lookup(p.x, p.states, R, cfg, nd)

    planes, nd, (st, bd, bn, nb) = prologue()
    q = dataclasses.replace(p, states=st, bdist=bd, bnormal=bn, near_b=nb)
    grid, _, _ = cpic.p2g_cpic(q, b, planes[1], planes[2], cfg, dt, nd)
    grid_v, _ = transfer.grid_update(grid, cfg, scene.colliders, sim.t, dt, sim._xg)
    return dict(
        prologue_cdf=cuda_ms(prologue, 2),
        p2g=cuda_ms(lambda: cpic.p2g_cpic(q, b, planes[1], planes[2], cfg, dt, nd), 2),
        grid=cuda_ms(lambda: transfer.grid_update(grid, cfg, scene.colliders, sim.t, dt,
                                                  sim._xg), 2),
        g2p=cuda_ms(lambda: cpic.g2p_cpic(q, b, grid_v, planes[1], planes[2], cfg, dt, nd=nd), 2),
        advance=cuda_ms(lambda: body.advance(b, sim.t, dt, scene.pos_funcs, scene.rot_funcs,
                                             cfg.gravity), 2))


# cycles the stream sleeps before queued calls are timed (~10 ms at 1.98 GHz):
# longer than the host takes to queue them
QUEUE_SLEEP_CYCLES = 20_000_000


def queued_ms(fn, reps):
    """(device ms, host ms) per call of fn() over `reps` calls, after one
    warm-up call: the calls queued behind a sleep on the stream, so the
    card runs them back to back whatever the host's pace (CUDA events
    around them), and the host's time to queue each. Raises when the sleep
    ran out before the calls were queued (the device time would then be
    the host's pace)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    queued = not start.query()
    end.record()
    torch.cuda.synchronize()
    if not queued:
        raise RuntimeError(f"queued_ms: the stream's sleep ran out while {reps} calls were "
                           f"queued ({host_s * 1e3:.3f} ms)")
    return start.elapsed_time(end) / reps, host_s * 1e3 / reps


def body_totals_rows_timing(rows, R):
    """``body_totals`` on one call's addends `rows` (rid, J, tau on the
    card): ``ms``, CUDA events around 20 calls made back to back at the
    host's pace (the way the dense CPIC path calls it, and the way the
    kernel has been timed since it was written), ``device_ms``, the same
    calls queued behind a sleep (``queued_ms``: the kernels' own time), and
    ``host_ms``, the host's time to make a call; the plain twin's ms on the
    card, one ``index_add_`` (the library call that computes the same sums,
    in atomics' order) timed as ``ms``, the largest difference from the
    twin on the CPU (which sets the order) and equal bits, and the bound:
    the bytes the function must move (rid whole, the values of the valid
    lanes, the totals) over 3.35 TB/s, or its adds over 67 TFLOP/s, the
    larger. ``share`` is the bound over ``ms``, ``device_share`` over
    ``device_ms``."""
    import torch

    from taichi_mpm_torch.ops import body_sums

    rid, J, tau = rows
    L, n = rid.shape[:-1].numel(), rid.shape[-1]
    ct = J.shape[-1] + tau.shape[-1]
    got = body_sums.body_totals(rid, J, tau, R)
    want = body_sums.body_totals_plain(*(a.cpu() for a in (rid, J, tau)), R)
    valid = int((rid >= 0).sum())
    flat = torch.where(rid >= 0, torch.arange(L, device=rid.device).reshape(rid.shape[:-1] + (1,))
                       * R + rid, L * R).reshape(-1)
    vals = torch.cat([J, tau], -1).reshape(-1, ct)
    nbytes = rid.numel() * rid.element_size() + valid * ct * 4 + L * R * ct * 4
    ops = valid * ct
    b_ms, bound_by = bound(nbytes, ops)
    ms = cuda_ms(lambda: body_sums.body_totals(rid, J, tau, R), 20)
    device_ms, host_ms = queued_ms(lambda: body_sums.body_totals(rid, J, tau, R), 20)
    return dict(
        ms=ms, device_ms=device_ms, host_ms=host_ms,
        plain_ms=cuda_ms(lambda: body_sums.body_totals_plain(rid, J, tau, R), 1, warmup=0),
        library_ms=cuda_ms(lambda: torch.zeros((L * R + 1, ct), device=rid.device).index_add_(
            0, flat, vals), 20),
        max_abs_err=max(max_abs(g.cpu(), w) for g, w in zip(got, want)),
        bits=all(torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
                 for g, w in zip(got, want)),
        bound_ms=b_ms, bound_by=bound_by, share=b_ms / ms, device_share=b_ms / device_ms,
        bytes=nbytes, ops=ops, rows=L, lanes=n, bodies=R, valid_lanes=valid)


def body_totals_timing(stages, R):
    """``body_totals_rows_timing`` on one substep's P2G addends (the
    per-offset totals, ``stages``' p2g_rows) and G2P's (the penalty
    totals, one row: g2p_rows), as "p2g" and "g2p"."""
    return {key: body_totals_rows_timing(stages[f"{key}_rows"], R) for key in ("p2g", "g2p")}


def phase_dense_cpic_scale(card, fused_ms, wheel_snapshot):
    """The CPIC benchmark scene (``scenes.cpic_wheel()``: 100k water, res
    96, the hub and the 6-paddle wheel under a rotation articulation, a
    colliding pair) with optimized=False: a 1-substep warm-up frame, then
    one frame of 20 substeps timed, its ms per substep beside the fused
    CPIC frame's of phase ``cpic_path`` in this run (`fused_ms`), host
    syncs per substep, the memory peak and the stages' CUDA-event ms
    (``dense_cpic_stage_ms``); every particle finite and in the domain,
    ``body_totals`` twice a substep and no other kernel. Then the kernel
    ``body_totals`` timed (``body_totals_timing``) on the P2G and the G2P
    addends of a substep of this state and of the same scene resumed from
    ``cpic_path``'s snapshot (`wheel_snapshot`: the water on the wheel),
    where it must give the twin's bits. Returns the launches and the
    kernel's measurement on the snapshot's P2G addends, its G2P addends'
    as ``g2p_rows``."""
    import torch

    from taichi_mpm_torch import diagnostics, scenes
    from taichi_mpm_torch.utils import HostSyncs

    failures = []
    sim = scenes.cpic_wheel(device="cuda", optimized=False)
    sim._ensure_finalized()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    sim.step(frame_dt=sim.cfg.base_dt)
    sim.sync()
    syncs = HostSyncs.count
    t0 = time.perf_counter()
    sim.step(frame_dt=DENSE_CPIC_SCALE_SUBSTEPS * sim.cfg.base_dt)
    sim.sync()
    frame_s = time.perf_counter() - t0
    syncs = HostSyncs.count - syncs
    launches = read_counts()
    failures += dense_cpic_launches(launches, 1 + DENSE_CPIC_SCALE_SUBSTEPS)
    check_domain(sim, 100_000, failures)
    if sim.packed_carry is not None:
        failures.append("the CPIC wheel did not take the dense path")
    ms = frame_s * 1e3 / DENSE_CPIC_SCALE_SUBSTEPS
    peak = torch.cuda.max_memory_allocated() / 1e9
    stage_ms = dense_cpic_stage_ms(sim)
    fresh = body_totals_timing(diagnostics.substep_stages(sim), sim.bodies.num)
    coupled = scenes.cpic_wheel(device="cuda", optimized=False)
    coupled.load(wheel_snapshot)
    measured = body_totals_timing(diagnostics.substep_stages(coupled), coupled.bodies.num)
    for label, by_rows in (("fresh", fresh), ("from the snapshot", measured)):
        for key, m in by_rows.items():
            if not m["bits"]:
                failures.append(f"body_totals {label}, {key} rows: not the twin's bits "
                                f"({m['max_abs_err']})")
    if not measured["p2g"]["valid_lanes"]:
        failures.append("body_totals: no valid lane in the snapshot's substep")
    emit(dict(phase="dense_cpic_scale", card=card, particles=sim.particles.count(),
              substeps=DENSE_CPIC_SCALE_SUBSTEPS, ms_per_substep=ms,
              fused_cpic_ms_per_substep=fused_ms, dense_over_fused=ms / fused_ms,
              particle_steps_per_s=1e5 * DENSE_CPIC_SCALE_SUBSTEPS / frame_s,
              host_syncs_per_substep=syncs / DENSE_CPIC_SCALE_SUBSTEPS,
              peak_mem_gb=peak, stage_ms=stage_ms, near_b=int(sim.particles.near_b.sum()),
              wheel_omega_z=float(sim.bodies.omega[2, 2]), launches=launches,
              body_totals=dict(fresh=fresh, snapshot=measured), failures=failures))
    raise_failures(failures)
    return launches, dict(measured["p2g"], g2p_rows=measured["g2p"])


# -- per-block bucketed async and the pytree CPIC frame ---------------------------

BUCKET_DRIFT = 3.0  # m/s along x added to the 125k cube: re-sorts inside the frame
BUCKET_LEVEL = 0  # the single-level check's level: 64 advances of the cube's dt
BUCKETED_TIMED_FRAMES = 1  # after one warm-up frame
UNFUSED_CPIC_KERNELS = ("p2g_blocked", "g2p_blocked")
UNFUSED_CPIC_TIMED_FRAMES = 3  # after one warm-up frame, from cpic_path's state
# The JAX package's own pytree-vs-packed CPIC pair on cpic_check's 10k
# wheel, 6 substeps, on the CPU (``PYTHONPATH=. python
# tests/port/port_helpers.py jax-cpic-unfused-vs-fused``).
JAX_CPIC_UNFUSED_PAIR = dict(x=2.9802322387695312e-08, v=4.76837158203125e-07, F=0.0,
                             states_differ=0, body_omega=0.0, body_vel=0.0)


def by_id_bits(a, b):
    """The fields of two particle sets' active particles, matched by id
    tag, whose bits differ (and the ids themselves, where they differ)."""
    from taichi_mpm_torch import convert

    def by_id(p):
        arr = convert.particles_to_numpy(p)
        act = arr["active"]
        order = np.argsort(arr["params"][act, ID_ROW_PARAM], kind="stable")
        return {k: v[act][order] for k, v in arr.items()}

    pa, pb = by_id(a), by_id(b)
    if pa["x"].shape != pb["x"].shape:
        return ["active"]
    return [name for name in pa if pa[name].tobytes() != pb[name].tobytes()]


def first_parting(sa, sb):
    """The first (tick, level) advance where two bucketed frames' schedules
    part, or None."""
    for x, y in zip(sa.schedule, sb.schedule):
        if x != y:
            return [x, y]
    if len(sa.schedule) != len(sb.schedule):
        return ["lengths", len(sa.schedule), len(sb.schedule)]
    return None


def phase_bucketed_check():
    """Per-block bucketed async against its definitions, on the card.
    Single level: the 125k jelly cube moving at BUCKET_DRIFT m/s, every
    slot at level BUCKET_LEVEL (``lev_fn``), unit = the cube's dt / 2^L: the
    bucketed frame equals the port's packed frame at dt in bits on both
    routes (particles matched by id), with re-sorts inside the frame,
    updates = active x steps, each advance launching its route's two
    kernels once. Natural levels: scripts/async/balls.py's scene at its
    own res 64, one per-block frame on the card and on the CPU, at the
    frame bounds of phase 2, the level histogram at the first sort, the
    update counter and the re-sorts equal (the first advance where the
    schedules part is printed); a second card run equal in bits."""
    import torch

    from taichi_mpm_torch import scenes
    from taichi_mpm_torch.ops import async_bucketed as ab
    from taichi_mpm_torch.ops import packed

    failures = []
    sim = cube(25, "cuda", 6)
    sim._ensure_finalized()
    tag_ids(sim)
    p = sim.particles
    p.v[:, 0] += BUCKET_DRIFT
    cfg, L = sim.cfg, BUCKET_LEVEL
    unit = cfg.base_dt / (1 << L)
    K = sim._active_block_cap()
    n_steps = (1 << ab.MAXLEV) >> L
    n_act = p.count()
    single = {}
    for fused in (True, False):
        route = "fused" if fused else "unfused"
        zero_counts()
        pb, tb, n_up, stats = ab.bucketed_frame(
            p, np.float32(0.0), cfg, (), unit * (1 << ab.MAXLEV), unit, K,
            lev_fn=lambda pm: torch.full_like(pm["ids"], L), fused=fused)
        failures += [f"single level, {route}: {f}"
                     for f in route_failures(read_counts(), fused, n_steps)]
        pr, tr, _, n_sorts, _ = packed.packed_frame(p, np.float32(0.0), cfg, (), cfg.base_dt,
                                                    n_steps, K, fused=fused)
        diff = by_id_bits(pb, pr)
        if diff or tb != tr:
            failures.append(f"single level, {route}: the bucketed frame differs from the packed "
                            f"frame in {diff} (t {tb} vs {tr})")
        if n_up != n_act * n_steps:
            failures.append(f"single level, {route}: {n_up} updates, not {n_act} x {n_steps}")
        if stats.n_resorts < 1:
            failures.append(f"single level, {route}: no re-sort inside the frame")
        single[route] = dict(advances=stats.advances, n_resorts=stats.n_resorts,
                             packed_sorts=n_sorts, updates=n_up, differing_fields=diff)
    del sim, p, pb, pr

    def balls(device):
        s = scenes.async_balls(res=64, device=device, per_block=True)
        s._ensure_finalized()
        tag_ids(s)
        s.step()
        return s

    g, c, r = balls("cuda"), balls("cpu"), balls("cuda")
    gs, cs = g.last_frame_stats, c.last_frame_stats
    errs = id_errors(g, c, "balls, card vs CPU", failures)
    parting = first_parting(gs, cs)
    if parting or g.update_counter != c.update_counter or gs.n_resorts != cs.n_resorts:
        failures.append(f"balls, card vs CPU: updates {g.update_counter} vs {c.update_counter}, "
                        f"re-sorts {gs.n_resorts} vs {cs.n_resorts}, first parting {parting}")
    if gs.level_hist[0] != cs.level_hist[0]:
        failures.append(f"balls: level histograms {gs.level_hist[0]} vs {cs.level_hist[0]}")
    rerun_diff = by_id_bits(g.particles, r.particles)
    if rerun_diff or g.t != r.t:
        failures.append(f"balls: a second card frame differs in {rerun_diff}")
    emit(dict(phase="bucketed_check", cube_particles=n_act, level=L, unit=unit,
              single_level=single, balls_particles=g.particles.count(),
              balls_frame_vs_cpu=errs, balls_level_hist=gs.level_hist,
              balls_advances=gs.advances, balls_updates=g.update_counter,
              balls_resorts=gs.n_resorts, balls_rerun_equal=not rerun_diff,
              failures=failures))
    raise_failures(failures)


def bucketed_frames(sim, n_frames):
    """Warm-up frame, then n_frames timed frames (host clock, fenced):
    (seconds, FrameStats of each timed frame, host syncs, updates)."""
    import torch

    from taichi_mpm_torch.utils import HostSyncs

    sim.step()
    sim.sync()
    zero_counts()
    HostSyncs.count = 0
    n0 = sim.update_counter
    stats = []
    t0 = time.perf_counter()
    for _ in range(n_frames):
        sim.step()
        stats.append(sim.last_frame_stats)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, stats, HostSyncs.count, sim.update_counter - n0


def phase_bucketed_path(card, script_dam_substeps):
    """AsyncMPM(per_block=True) at full size on the card: the 1,056,758
    water particles of scripts/async/water.py (``scenes.water_script(res=
    128, per_block=True)``) and scripts/async/balls.py at res 128, a
    warm-up frame and BUCKETED_TIMED_FRAMES timed frames of the scripts'
    frame_dt each: ms per frame and per advance, advances per level, the
    update counter beside the same scene's global-adaptive updates
    (the dam's from phase script_dam's substeps of this run, the balls'
    from their own global frames here), host syncs per advance, the
    memory peak. Gates: every particle active, finite and in the domain;
    p2g_fused and g2p_fused launched once per advance with a context.
    Returns the launches."""
    import torch

    from taichi_mpm_torch import scenes

    failures = []
    out = dict(phase="bucketed_path", card=card)
    launches = {}
    for name in ("dam", "balls"):
        t0 = time.perf_counter()
        if name == "dam":
            sim = scenes.water_script(res=128, device="cuda", per_block=True)
        else:
            sim = scenes.async_balls(res=128, device="cuda", per_block=True)
        sim._ensure_finalized()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        n = sim.particles.count()
        torch.cuda.reset_peak_memory_stats()
        secs, stats, syncs, updates = bucketed_frames(sim, BUCKETED_TIMED_FRAMES)
        launches[name] = read_counts()
        kernel_advances = sum(st.n_substeps - st.empty_advances for st in stats)
        failures += [f"{name}: {f}"
                     for f in route_failures(launches[name], True, kernel_advances)]
        check_domain(sim, n, failures)
        if name == "dam":
            global_updates = [k * n for k in script_dam_substeps[1:1 + BUCKETED_TIMED_FRAMES]]
        else:
            ref = scenes.async_balls(res=128, device="cuda")
            ref.step()
            u0 = ref.update_counter
            for _ in range(BUCKETED_TIMED_FRAMES):
                ref.step()
            global_updates = [(ref.update_counter - u0) // BUCKETED_TIMED_FRAMES] * \
                BUCKETED_TIMED_FRAMES
            del ref
        n_adv = sum(st.n_substeps for st in stats)
        out[name] = dict(
            particles=n, frame_dt=sim.frame_dt, unit=sim.bucket_unit(), setup_s=setup_s,
            ms_per_frame=secs * 1e3 / BUCKETED_TIMED_FRAMES,
            ms_per_advance=secs * 1e3 / max(1, kernel_advances),
            advances_per_level=[st.advances for st in stats],
            empty_advances=sum(st.empty_advances for st in stats),
            level_hist_first_sort=stats[0].level_hist[0], resorts=[st.n_resorts for st in stats],
            update_counter=updates, global_adaptive_updates=sum(global_updates),
            updates_ratio=updates / max(1, sum(global_updates)),
            host_syncs_per_advance=syncs / max(1, n_adv),
            sort_reads_per_advance=sum(st.sort_reads for st in stats) / max(1, n_adv),
            max_mini_lanes=max(st.max_lanes for st in stats),
            max_mini_slots=max(st.max_slots for st in stats),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches[name])
        del sim
    out.update(clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"), failures=failures)
    emit(out)
    raise_failures(failures)
    return launches


def phase_cpic_unfused_check():
    """The pytree CPIC frame (TMT_FUSED=0) on cpic_check's 10k wheel: 6
    substeps on the card against the CPU at the CPIC bounds of
    ``cpic_check`` (states and near_b equal, the frame's counts equal, the
    plastic events but for the water particles at the count's knife edge,
    ``diagnostics.water_knife_edges``, summed over the CPU's substeps),
    p2g_blocked and g2p_blocked once per substep and no other kernel, a
    second card run equal in bits; then against the fused CPIC frame on
    the card, particles matched by id, beside the JAX package's own pair
    (JAX_CPIC_UNFUSED_PAIR)."""
    def make(device, fused):
        sim = on_route(fused, lambda: cpic_check_scene(device))
        sim._ensure_finalized()
        tag_ids(sim)
        return sim

    from taichi_mpm_torch import diagnostics

    gs, cs, rerun, fused = make("cuda", False), make("cpu", False), make("cuda", False), \
        make("cuda", True)
    zero_counts()
    gs.step()
    failures = route_failures(read_counts(), False, 6, UNFUSED_CPIC_KERNELS)
    for sim in (rerun, fused):
        sim.step()
    # the CPU's frame as 6 frames of one substep (the carry and its drift
    # go on across frames, so it is the same frame): after each, the water
    # particles at the knife edge of the plastic-event count
    cs.frame_dt = cs.cfg.base_dt
    edges = 0
    stats = dict(n_act=0, n_near=0, n_coarse=0, n_r=0)
    for _ in range(6):
        cs.step()
        edges += diagnostics.water_knife_edges(cs.particles, cs.cfg)
        stats = {k: max(v, cs.cpic_stats[k]) for k, v in stats.items()}
    errs = cpic_errors(gs, cs, "unfused CPIC card vs CPU", failures, plast_slack=edges)
    if gs.cpic_stats != stats:
        failures.append(f"unfused CPIC card vs CPU counts: {gs.cpic_stats} vs {stats}")
    if gs.cpic_stats["n_near"] == 0:
        failures.append("no particle was near the wheel: the coupling went untested")
    deterministic = True
    if not same_bits(gs, rerun, "the card's unfused CPIC frame on a rerun", failures):
        deterministic = False
    for name in ("pos", "vel", "rot", "omega"):
        if not np.array_equal(getattr(gs.bodies, name).cpu().numpy(),
                              getattr(rerun.bodies, name).cpu().numpy()):
            deterministic = False
            failures.append(f"the card's unfused CPIC frame is not deterministic: body {name}")
    pair = id_errors(gs, fused, "unfused vs fused CPIC frame", failures, CPIC_BOUNDS)
    for name, bnd in BODY_BOUNDS:
        pair["body_" + name] = float(np.abs(getattr(gs.bodies, name).cpu().numpy().astype(
            np.float64) - getattr(fused.bodies, name).cpu().numpy()).max())
        if not pair["body_" + name] <= bnd:
            failures.append(f"unfused vs fused CPIC frame: body {name} differs by "
                            f"{pair['body_' + name]} > {bnd}")
    emit(dict(phase="cpic_unfused_check", particles=gs.particles.count(), frame_vs_cpu=errs,
              plast=[gs.plasticity_counter, cs.plasticity_counter], water_knife_edges=edges,
              deterministic=deterministic, stats=gs.cpic_stats, fused_stats=fused.cpic_stats,
              unfused_vs_fused=pair, jax_pair=JAX_CPIC_UNFUSED_PAIR, failures=failures))
    raise_failures(failures)


def phase_cpic_unfused_path(card, wheel_snapshot, fused_ms):
    """``scenes.cpic_wheel()`` (100k) on the pytree CPIC frame (TMT_FUSED=0)
    from phase cpic_path's state (its snapshot `wheel_snapshot` loaded,
    the water on the wheel): a warm-up frame and UNFUSED_CPIC_TIMED_FRAMES timed frames of
    20 substeps, ms per substep beside cpic_path's fused figure, host
    syncs, the near sets; p2g_blocked and g2p_blocked once per substep and
    no other kernel; every particle active, finite and in the domain.
    Returns the launches."""
    import torch

    from taichi_mpm_torch import scenes
    from taichi_mpm_torch.utils import HostSyncs

    failures = []
    sim = on_route(False, lambda: scenes.cpic_wheel(device="cuda"))
    sim.frame_dt = SUBSTEPS_PER_FRAME * sim.cfg.base_dt
    sim.load(wheel_snapshot)
    sim.step()
    sim.sync()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    HostSyncs.count = 0
    peak = dict(n_near=0, n_coarse=0, n_r=0)
    t0 = time.perf_counter()
    for _ in range(UNFUSED_CPIC_TIMED_FRAMES):
        sim.step()
        peak = {k: max(v, sim.cpic_stats[k]) for k, v in peak.items()}
    sim.sync()
    secs = time.perf_counter() - t0
    launches = read_counts()
    n_sub = UNFUSED_CPIC_TIMED_FRAMES * SUBSTEPS_PER_FRAME
    failures += route_failures(launches, False, n_sub, UNFUSED_CPIC_KERNELS)
    x = check_domain(sim, 100_000, failures)
    if sim.packed_carry is None or sim.fused:
        failures.append("the wheel did not run the pytree CPIC frame")
    emit(dict(phase="cpic_unfused_path", card=card, particles=int(x.shape[0]),
              substeps=n_sub, ms_per_substep=secs * 1e3 / n_sub, fused_ms_per_substep=fused_ms,
              particle_steps_per_s=x.shape[0] * n_sub / secs,
              host_syncs_per_substep=HostSyncs.count / n_sub, max_n_near=peak["n_near"],
              max_n_coarse=peak["n_coarse"], max_n_r=peak["n_r"], n_sorts=sim.n_sorts,
              wheel_omega_z=float(sim.bodies.omega[2, 2]),
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
              clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"), failures=failures))
    raise_failures(failures)
    return launches


# -- slabs: DistributedMPM over torch.distributed ------------------------------------

DIST_SUBSTEPS = 12  # a frame of the 125k check
DIST_FRAMES = 3
# the 125k check's motion: the cube drifts along +x at DIST_DRIFT m/s and
# spins about its z axis at DIST_SPIN rad/s (its lower face at -4 m/s, its
# upper at +28), a rigid motion that strains the jelly little. Particles
# cross the slab boundary both ways, the frames re-sort every other
# substep, and the equal-count split moves right, so a balanced bound moves.
DIST_DRIFT = 12.0
DIST_SPIN = 163.0
DIST_ROUTES = {"fused_balanced": (True, True), "fused_uniform": (True, False),
               "unfused_uniform": (False, False), "unfused_balanced": (False, True)}
DIST_DEVICE = "cuda:0"  # every rank of the shared-card group runs on the one card
DIST_PATH_RES = 128  # the 8M cube's res on slabs: 125 does not divide into slab blocks
DIST_PATH_TIMED_FRAMES = 1  # after one warm-up frame


def dist_cube(solver, device):
    """The 125k slab check's scene: benchmark_cube(cells=25, res=128) built
    by `solver`, frames of DIST_SUBSTEPS, moving at DIST_DRIFT and
    spinning at DIST_SPIN, each particle's index in params[:, ID_ROW_PARAM]."""
    from taichi_mpm_torch import scenes

    sim = scenes.benchmark_cube(cells=25, res=128, device=device, solver=solver,
                                **CUBE_KW["jelly"])
    sim.frame_dt = DIST_SUBSTEPS * sim.cfg.base_dt
    batch = sim._pending[0]
    r = batch["x"] - batch["x"].mean(0)
    batch["v"][:, 0] = DIST_DRIFT - DIST_SPIN * r[:, 1]
    batch["v"][:, 1] = DIST_SPIN * r[:, 0]
    batch["params"][:, ID_ROW_PARAM] = np.arange(r.shape[0], dtype=np.float32)
    return sim


def state_arrays(sim, particles):
    """A run's state as numpy arrays: the active particles by id tag
    (``tagged``) and, where the scene has rigid bodies, the bodies'
    fields as ``body_<field>``."""
    arrays = tagged(particles)
    if sim.bodies is not None:
        arrays.update({"body_" + k: getattr(sim.bodies, k).cpu().numpy()
                       for k in ("pos", "vel", "rot", "omega")})
    return arrays


def held_to(ref, got, label, bounds, failures):
    """Two runs' ``state_arrays``: the particles within `bounds`, the
    bodies (where there are) within BODY_BOUNDS. Returns the errors and
    whether the two are equal in bits."""
    errs = tagged_errors(ref, got, label, failures, bounds)
    for k, bound in BODY_BOUNDS:
        if "body_" + k in ref:
            errs["body_" + k] = float(np.abs(ref["body_" + k].astype(np.float64)
                                             - got["body_" + k]).max())
            if not errs["body_" + k] <= bound:
                failures.append(f"{label}: body {k} differs by {errs['body_' + k]} > {bound}")
    same = bool(errs) and all(np.array_equal(ref[k], got[k]) for k in ref)
    return errs, same


def ref_path(ref_dir, kind, fused, resorted=False):
    return os.path.join(ref_dir, f"{kind}_fused{int(fused)}{'_resorted' * resorted}.npz")


def load_ref(path):
    with np.load(path) as ref:
        return dict(ref)


def dist_refs(kind, ref_dir, device, routes=(True, False), resorted=()):
    """MPM's frames of the scene of DIST_KINDS[`kind`] on each route of
    `routes` (fused or not; DIST_FRAMES frames), saved in `ref_dir`
    (``state_arrays``), and on each route of `resorted` the same frames
    with a re-sort at each frame's start, as the slab frames do (the
    carry dropped after each frame, so that the next one packs and sorts
    afresh). Returns the particle count."""
    from taichi_mpm_torch import MPM

    scene = DIST_KINDS[kind][0]
    for fused, resort in [(f, False) for f in routes] + [(f, True) for f in resorted]:
        ref = on_route(fused, lambda: scene(MPM, device))
        for f in range(DIST_FRAMES):
            if resort and f:
                ref._particles, ref._pcarry = ref.particles, None
            ref.step()
        np.savez(ref_path(ref_dir, kind, fused, resort), **state_arrays(ref, ref.particles))
        n = ref.particle_count()
        del ref
    return n


def dist_routes(kind, ref_dir, runs, device=DIST_DEVICE):
    """On every rank of the current group: for each (route, repeat) of
    `runs`, the scene of DIST_KINDS[`kind`] on DistributedMPM over
    DIST_FRAMES frames, every launch count set to 0 before; with rigid
    bodies each rank hashes its bodies after every frame. Rank 0 holds
    the gathered state to the one-device frames that ``dist_refs`` saved
    in `ref_dir` (the kind's bounds; ``held_to``), and on one rank also to
    the frames re-sorted at each frame's start, where they were saved;
    every particle must stay finite and in the domain. Returns per run:
    this rank's launches, slab events (and body hashes), and on rank 0
    the errors, whether they are 0 (MPM's bits), the failures and the
    SHA-256 of the gathered state."""
    import functools

    import torch

    from taichi_mpm_torch.parallel import comm
    from taichi_mpm_torch.parallel.driver import DistributedMPM
    from taichi_mpm_torch.utils import HostSyncs

    scene, routes, bounds = DIST_KINDS[kind]
    out = {}
    for name, rep in runs:
        fused, balanced = routes[name]
        solver = functools.partial(DistributedMPM, balanced=balanced)
        sim = on_route(fused, lambda: scene(solver, device))
        sim._ensure_finalized()
        zero_counts()
        syncs = HostSyncs.count
        shas = []
        for _ in range(DIST_FRAMES):
            sim.step()
            if sim.bodies is not None:
                shas.append(bodies_sha(sim))
        if device != "cpu":
            torch.cuda.synchronize()
        syncs = HostSyncs.count - syncs
        launches = read_counts()
        g = sim._gather()
        st = sim.slab_stats
        res = dict(launches=launches, fused=sim.fused, balanced=sim.slabs.balanced,
                   substeps=st.substeps, resorts=st.resorts, sent=(st.sent_left, st.sent_right),
                   arrived=st.arrived, grown=st.grown, bounds=st.bounds[:1] + st.bounds[-1:],
                   bounds_moved=len(set(st.bounds)) > 1, count=sim.particle_count(),
                   host_syncs_per_substep=syncs / st.substeps)
        if sim.bodies is not None:
            res.update(n_near=st.n_near, n_coarse=st.n_coarse, body_sha=shas,
                       omega_max=float(sim.bodies.omega.abs().max()))
        if sim.rank == 0:
            failures = []
            got = state_arrays(sim, g)
            res["errors"], res["mpm_bits"] = held_to(
                load_ref(ref_path(ref_dir, kind, fused)), got, name, bounds, failures)
            if comm.world() == 1 and os.path.exists(ref_path(ref_dir, kind, fused, True)):
                res["vs_resorted"], res["resorted_bits"] = held_to(
                    load_ref(ref_path(ref_dir, kind, fused, True)), got, name, bounds, [])
            x = got["x"]
            hi = sim.cfg.res[0] * sim.cfg.dx
            if not (np.isfinite(x).all() and x.min() >= 0.0 and x.max() <= hi):
                failures.append(f"{name}: positions not finite or outside the domain")
            res["failures"] = failures
            res["sha256"] = hashlib.sha256(b"".join(
                np.ascontiguousarray(v).tobytes() for v in got.values())).hexdigest()
        out[f"{name}_{rep}"] = res
        del sim, g
    return out


def dist_failures(label, res, n_expected, substeps, failures):
    """The checks of one rank's run of dist_routes: each kernel of its
    route (the CPIC frame's where the scene has bodies) once per substep,
    rank 0's failures, every particle kept, every substep run."""
    kernels = None
    if "body_sha" in res:
        kernels = CPIC_KERNELS if res["fused"] else UNFUSED_CPIC_KERNELS
    failures += [f"{label}: {f}"
                 for f in route_failures(res["launches"], res["fused"], substeps, kernels)]
    failures += [f"{label}: {f}" for f in res.get("failures", [])]
    if res["count"] != n_expected:
        failures.append(f"{label}: {res['count']} particles, not {n_expected}")
    if res["substeps"] != substeps:
        failures.append(f"{label}: {res['substeps']} substeps, not {substeps}")


def phase_dist_check(card, kind="plain"):
    """``dist_check`` (`kind` "plain": ``dist_cube``, the moving, spinning
    125k cube, each route with uniform and balanced bounds) or
    ``dist_cpic_check`` ("cpic": ``dist_cpic_scene``, the 10k CPIC wheel,
    on each CPIC slab frame) on DistributedMPM, DIST_FRAMES frames of
    DIST_SUBSTEPS: (a) one rank over NCCL in this process; (b) two ranks
    sharing the card over gloo (spawned; the default route twice). Each
    run held to MPM's frames on the card (the kind's bounds, particles
    matched by id; the bodies within BODY_BOUNDS), each kernel of its
    route once per substep per rank and no other, every particle kept,
    finite and in the domain; on two ranks migrants both ways, a bound
    moved, the two default runs equal in bits, and with bodies: the
    bodies equal in bits on both ranks after every frame and both ranks'
    near sets used. The one-rank runs print whether they give MPM's bits;
    on CPIC scenes, ``resort_and_shift`` names what differs. Returns the
    launches by path."""
    import tempfile

    from taichi_mpm_torch.parallel import comm

    phase = "dist_check" if kind == "plain" else "dist_cpic_check"
    cpic = kind == "cpic"
    failures = []
    n_sub = DIST_FRAMES * DIST_SUBSTEPS
    t0 = time.perf_counter()
    isolation = None
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{phase}_") as d:
        n_expected = dist_refs(kind, d, "cuda", resorted=(True,) if cpic else ())
        if cpic:
            dist_refs("cpic_exact", d, "cuda", routes=(True,), resorted=(True,))
        runs = [(name, 0) for name in DIST_KINDS[kind][1]]
        with comm.process_group("nccl", 0, 1, comm.free_port(), timeout_s=DIST_TIMEOUT_S):
            nccl = dist_routes(kind, d, runs)
            if cpic:
                exact = dist_routes("cpic_exact", d, [("fused_balanced", 0)])["fused_balanced_0"]
        gloo = ranks_of(dist_routes, 2, args=(kind, d, runs + [("fused_balanced", 1)]))
        if cpic:
            isolation = resort_and_shift(d, nccl, exact, failures)
    for key, res in nccl.items():
        dist_failures(f"nccl {key}", res, n_expected, n_sub, failures)
    for r, ranks in enumerate(gloo):
        for key, res in ranks.items():
            dist_failures(f"gloo rank {r} {key}", res, n_expected, n_sub, failures)
    for key in gloo[0]:
        sent = [gloo[r][key]["sent"] for r in range(2)]
        if not (sent[0][1] > 0 and sent[1][0] > 0):
            failures.append(f"gloo {key}: no migrants both ways ({sent})")
        if gloo[0][key]["balanced"] and not gloo[0][key]["bounds_moved"]:
            failures.append(f"gloo {key}: no bound moved ({gloo[0][key]['bounds']})")
        if cpic:
            if gloo[0][key]["body_sha"] != gloo[1][key]["body_sha"]:
                failures.append(f"gloo {key}: the ranks' bodies differ in bits")
            if min(gloo[r][key]["n_near"] for r in range(2)) == 0:
                failures.append(f"gloo {key}: a rank's near set stayed empty")
    if gloo[0]["fused_balanced_0"]["sha256"] != gloo[0]["fused_balanced_1"]["sha256"]:
        failures.append("gloo fused_balanced: two runs not equal in bits")
    launches = {f"{phase}_nccl": {}, f"{phase}_gloo": {}}
    for path, runs_of in ((f"{phase}_nccl", [nccl]), (f"{phase}_gloo", gloo)):
        for ranks in runs_of:
            for res in ranks.values():
                for k, v in res["launches"].items():
                    launches[path][k] = launches[path].get(k, 0) + v

    def shown(r):
        return {k: v for k, v in r.items() if k not in ("launches", "body_sha")}

    emit(dict(phase=phase, card=card, particles=n_expected, substeps_per_run=n_sub,
              seconds=time.perf_counter() - t0,
              nccl={k: shown(r) for k, r in nccl.items()},
              gloo=[{k: shown(r) for k, r in ranks.items()} for ranks in gloo],
              resort_and_shift=isolation, launches=launches, failures=failures))
    raise_failures(failures)
    return launches


def torch_synced_frame(sim):
    """One frame of `sim` under torch's sync debug mode: the synchronizing
    CUDA calls torch itself reports (each a warning), per substep. It sees
    the waits that ``utils.HostSyncs`` does not count: a boolean-mask
    index's nonzero, a blocking copy to the host, a read of a count."""
    import warnings

    import torch

    from taichi_mpm_torch.parallel.spatial_blocked import SlabStats

    sim.slab_stats = SlabStats()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sim.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
    return n / sim.slab_stats.substeps


def slab_path_frames(sim, setup_s):
    """The timed part of a slab path on each rank: a warm-up frame,
    DIST_PATH_TIMED_FRAMES timed frames (ms and host syncs per substep,
    the launches), one frame under torch's sync debug mode
    (``torch_synced_frame``), then one frame with a device sync around
    each exchange, migration and impulse all-reduce, for their ms; the
    particles outside the domain or not finite, summed over the ranks."""
    import torch

    from taichi_mpm_torch.parallel import comm
    from taichi_mpm_torch.parallel.spatial_blocked import SlabStats
    from taichi_mpm_torch.utils import HostSyncs

    sim.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    sim.slab_stats = st = SlabStats()
    comm.all_max(torch.zeros((), device=DIST_DEVICE))  # the ranks start the clock together
    syncs = HostSyncs.count
    t0 = time.perf_counter()
    for _ in range(DIST_PATH_TIMED_FRAMES):
        sim.step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    syncs = HostSyncs.count - syncs
    launches = read_counts()
    torch_syncs = torch_synced_frame(sim)
    sim.slab_stats = split = SlabStats(timed=True)
    t0 = time.perf_counter()
    sim.step()
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    p = sim.particles
    x = p.x[p.active]
    hi = sim.cfg.res[0] * sim.cfg.dx
    bad = int((~(torch.isfinite(x).all(-1) & (x >= 0).all(-1) & (x <= hi).all(-1))).sum())
    bad = int(comm.all_sum(torch.tensor(bad, device=DIST_DEVICE)))
    n = st.substeps
    return dict(rank=sim.rank, substeps=n, ms_per_substep=secs * 1e3 / n,
                host_syncs_per_substep=syncs / n, torch_syncs_per_substep=torch_syncs,
                exchange_ms_per_substep=split.exchange_s * 1e3 / split.substeps,
                migrate_ms_per_substep=split.migrate_s * 1e3 / split.substeps,
                impulse_sum_ms_per_substep=split.impulse_sum_s * 1e3 / split.substeps,
                synced_ms_per_substep=split_s * 1e3 / split.substeps, resorts=st.resorts,
                sent=(st.sent_left, st.sent_right), sent_y=(st.sent_low_y, st.sent_high_y),
                diagonal=int(st.diagonal), arrived=st.arrived, grown=st.grown,
                bounds=st.bounds, n_near=st.n_near, local_particles=int(p.active.sum()),
                count=sim.particle_count(), outside_or_nan=bad, launches=launches,
                K=int(sim.block_capacity), setup_s=setup_s, fused=sim.fused,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def dist_path_rank(mesh_shape=None):
    """On each rank of the shared-card group: the 8M jelly cube at res 128
    on DistributedMPM (fused route, balanced; on pencils with
    `mesh_shape`), ``slab_path_frames``."""
    import functools

    import torch

    from taichi_mpm_torch import scenes
    from taichi_mpm_torch.parallel.driver import DistributedMPM

    t0 = time.perf_counter()
    sim = on_route(True, lambda: scenes.benchmark_cube(
        cells=100, res=DIST_PATH_RES, device=DIST_DEVICE,
        solver=functools.partial(DistributedMPM, mesh_shape=mesh_shape), **CUBE_KW["jelly"]))
    sim.frame_dt = SUBSTEPS_PER_FRAME * sim.cfg.base_dt
    sim._ensure_finalized()
    torch.cuda.synchronize()
    return slab_path_frames(sim, time.perf_counter() - t0)


def phase_dist_path(card):
    """``dist_path``: the 8M jelly cube at res 128 on two ranks sharing the
    card (gloo), fused and balanced, 1 + DIST_PATH_TIMED_FRAMES frames of
    20 substeps (ms and host syncs per substep, re-sorts, migrants and the
    bounds), one frame for torch's count of syncs and one for the
    exchange's and the migration's ms; each kernel once per substep per
    rank; all 8,000,000 particles kept, finite and in the domain. Beside
    it the same scene through MPM on the card. The two ranks time-share
    one H100: this is no scaling number. Returns the launches by rank
    and MPM's ms per substep."""
    import torch

    from taichi_mpm_torch import scenes

    failures = []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = ranks_of(dist_path_rank, 2)
    ranks_s = time.perf_counter() - t0
    n_timed = DIST_PATH_TIMED_FRAMES * SUBSTEPS_PER_FRAME
    for r in ranks:
        failures += [f"rank {r['rank']}: {f}" for f in route_failures(r["launches"], True, n_timed)]
        if r["count"] != 8_000_000 or r["outside_or_nan"]:
            failures.append(f"rank {r['rank']}: {r['count']} particles, "
                            f"{r['outside_or_nan']} outside the domain or not finite")
    if sum(r["local_particles"] for r in ranks) != 8_000_000:
        failures.append("the slabs do not hold 8,000,000 particles between them")

    sim = on_route(True, lambda: scenes.benchmark_cube(cells=100, res=DIST_PATH_RES, device="cuda",
                                                       **CUBE_KW["jelly"]))
    sim.frame_dt = SUBSTEPS_PER_FRAME * sim.cfg.base_dt
    sim.step()
    sim.sync()
    t0 = time.perf_counter()
    for _ in range(DIST_PATH_TIMED_FRAMES):
        sim.step()
    sim.sync()
    one_ms = (time.perf_counter() - t0) * 1e3 / n_timed
    del sim
    emit(dict(phase="dist_path", card=card, what="two processes time-sharing one H100, "
              "not a scaling number", particles=8_000_000, res=DIST_PATH_RES,
              timed_substeps=n_timed, ranks=ranks, one_device_ms_per_substep=one_ms,
              ranks_s=ranks_s, clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"),
              failures=failures))
    raise_failures(failures)
    return {f"dist_path_rank{r['rank']}": r["launches"] for r in ranks}, one_ms


# -- CPIC on slabs: DistributedMPM with rigid bodies ------------------------------------

DIST_CPIC_ROUTES = {"fused_balanced": (True, True), "fused_uniform": (True, False),
                    "unfused_uniform": (False, False)}
# the check's water: cpic_check_scene's 10k particles in a box as wide
# (0.18 x 0.16 in x and z), on the wheel's upper right paddles above the
# hub (x from 0.493, y 0.46 to 0.62), falling at 1 m/s: 373 of them lie
# left of the uniform slab boundary at x = 0.5, and the equal-count split
# sits 2 particles short of the column edge at x = 0.5833 (the balanced
# bound starts at column 15); its lower half (y < 0.54) moves at -1.2 m/s
# along x and its upper half at +0.5. It crosses both kinds of boundary
# both ways, more of it leftwards, so the equal-count split, and the
# balanced bound, moves left (15 -> 14). Most of the water stays right of
# the axle, so the wheel's torques do not cancel (near-cancelling torques
# would leave the bodies' rounding large beside their net spin).
DIST_CPIC_LO, DIST_CPIC_HI = (0.493, 0.46, 0.42), (0.673, 0.62, 0.58)
DIST_CPIC_SHEAR = (-1.2, 0.5)  # below, above the box's middle height
WATER_WHEEL_FRAMES = 3
WATER_WHEEL_FRAME_DT = 2e-3  # the runner's --frame-dt: 40 substeps of the script's 5e-5 s
WATER_WHEEL_DROP = 0.3  # the snapshot's water moved down this far, onto the paddles


def dist_cpic_scene(solver, device):
    """The slab CPIC check's scene (DIST_CPIC_LO, DIST_CPIC_HI,
    DIST_CPIC_SHEAR): the CPIC wheel of cpic_check_scene built by
    `solver`, frames of DIST_SUBSTEPS, each particle's index in
    params[:, ID_ROW_PARAM]."""
    from taichi_mpm_torch import scenes

    sim = scenes.cpic_wheel(n=10_000, res=96, lo=DIST_CPIC_LO, hi=DIST_CPIC_HI,
                            vel=(0.0, -1.0, 0.0), device=device, solver=solver)
    sim.frame_dt = DIST_SUBSTEPS * sim.cfg.base_dt
    batch = sim._pending[0]
    lower = batch["x"][:, 1] < 0.5 * (DIST_CPIC_LO[1] + DIST_CPIC_HI[1])
    batch["v"][:, 0] = np.where(lower, *DIST_CPIC_SHEAR)
    batch["params"][:, ID_ROW_PARAM] = np.arange(batch["x"].shape[0], dtype=np.float32)
    return sim


# the shift check's scene: a free plate and 3,000 water particles all in
# x in [0.5, 0.9375) at res 64, so that the slab frame's shift by
# world_off (-4 cells, -1/16) is exact in float32 for every particle,
# boundary particle and node it moves (x and x + 1/16 in one binade)
EXACT_SHIFT_RES = 64
EXACT_SHIFT_PARTICLES = 3_000


def exact_shift_scene(solver, device):
    """``dist_cpic_check``'s scene for the shift: 3,000 water particles in
    [0.58, 0.82] x [0.41, 0.49] x [0.4, 0.6] falling at 1 m/s onto a plate
    (half size 0.1, normal y, free to turn) at (0.66, 0.4, 0.5), res
    EXACT_SHIFT_RES, dt 1e-4, penalty 1e3, frames of DIST_SUBSTEPS; ids
    tagged."""
    from taichi_mpm_torch.rigid.mesh import plate_mesh

    n = EXACT_SHIFT_PARTICLES
    rng = np.random.default_rng(11)
    sim = solver(res=(EXACT_SHIFT_RES,) * 3, base_delta_t=1e-4, gravity=(0, -10.0, 0),
                 penalty=1e3, device=device)
    sim.frame_dt = DIST_SUBSTEPS * sim.cfg.base_dt
    pos = (rng.uniform(0.0, 1.0, (n, 3)) * [0.24, 0.08, 0.2] + [0.58, 0.41, 0.4]).astype(
        np.float32)
    sim.add_particles("water", pos=pos, vel=(0.0, -1.0, 0.0), density=1000)
    sim.add_particles("rigid", mesh=plate_mesh(half_u=0.1, half_v=0.1, axis=1),
                      scripted_position=lambda t: (0.66, 0.4, 0.5), codimensional=True,
                      friction=0.2)
    sim._pending[0]["params"][:, ID_ROW_PARAM] = np.arange(n, dtype=np.float32)
    return sim


def resort_and_shift(ref_dir, nccl, exact, failures):
    """What parts one NCCL rank's CPIC frames from MPM's. The slab frame
    re-sorts at each frame's start (MPM's carry on drift only) and shifts
    positions into its slab's frame by world_off (-4 cells). Held apart:
    MPM re-sorted at each frame's start against MPM (the re-sort alone);
    on ``exact_shift_scene``, whose shift is exact, the one rank against
    the re-sorted MPM, which must be equal in bits (nothing else
    differs); on the wheel (res 96: the shift, 1/24, rounds) the one rank
    against the re-sorted MPM, the shift's part."""
    resort_errs, resort_bits = held_to(load_ref(ref_path(ref_dir, "cpic", True)),
                                       load_ref(ref_path(ref_dir, "cpic", True, True)),
                                       "re-sorted MPM", CPIC_BOUNDS, [])
    dist_failures("nccl cpic_exact", exact, EXACT_SHIFT_PARTICLES, DIST_FRAMES * DIST_SUBSTEPS,
                  failures)
    if not exact["resorted_bits"]:
        failures.append("cpic_exact: one NCCL rank differs from MPM re-sorted at each frame's "
                        f"start: {exact['vs_resorted']}")
    if exact["n_near"] == 0 or exact["omega_max"] == 0.0:
        failures.append("cpic_exact: the water did not reach the plate")

    def split(r):
        return {k: r[k] for k in ("errors", "mpm_bits", "vs_resorted", "resorted_bits")}

    return dict(resorted_mpm_vs_mpm=resort_errs, resorted_mpm_bits=resort_bits,
                wheel={k: split(r) for k, r in nccl.items() if "vs_resorted" in r},
                exact_shift=dict(split(exact), n_near=exact["n_near"],
                                 omega_max=exact["omega_max"]))


DIST_KINDS = {"plain": (dist_cube, DIST_ROUTES, FRAME_BOUNDS),
              "cpic": (dist_cpic_scene, DIST_CPIC_ROUTES, CPIC_BOUNDS),
              "cpic_exact": (exact_shift_scene, {"fused_balanced": (True, True)}, CPIC_BOUNDS)}


def bodies_sha(sim):
    return hashlib.sha256(b"".join(getattr(sim.bodies, k).cpu().numpy().tobytes()
                                   for k in ("pos", "vel", "rot", "omega"))).hexdigest()


def dist_cpic_path_rank(wheel_snapshot, mesh_shape=None):
    """On each rank of the shared-card group: the 100k CPIC wheel
    (scenes.cpic_wheel(), res 96) on DistributedMPM, fused and balanced
    (on pencils with `mesh_shape`), from `wheel_snapshot`
    (``DistributedMPM.load``: every rank restores the bodies),
    ``slab_path_frames``, with the bodies' hash and the rigid map's
    capacity."""
    import functools

    import torch

    from taichi_mpm_torch import scenes
    from taichi_mpm_torch.parallel.driver import DistributedMPM

    t0 = time.perf_counter()
    sim = on_route(True, lambda: scenes.cpic_wheel(
        device=DIST_DEVICE, solver=functools.partial(DistributedMPM, mesh_shape=mesh_shape)))
    sim.frame_dt = SUBSTEPS_PER_FRAME * sim.cfg.base_dt
    sim.load(wheel_snapshot)
    torch.cuda.synchronize()
    out = slab_path_frames(sim, time.perf_counter() - t0)
    out.update(body_sha=bodies_sha(sim), Kr=sim.cpic_caps.Kr)
    return out


def slab_cpic_rank(wheel_snapshot, water_wheel_dir):
    """On each rank of the shared-card group: ``dist_cpic_path_rank``, then
    ``water_wheel_rank`` resumed from the snapshot in `water_wheel_dir`
    (the group, the card and the kernels already warm)."""
    return dict(path=dist_cpic_path_rank(wheel_snapshot),
                water_wheel=water_wheel_rank(2, water_wheel_dir))


def phase_slab_cpic_paths(card, wheel_snapshot):
    """The two CPIC slab paths in one spawned group of two ranks sharing
    the card (gloo), ``slab_cpic_rank``: ``dist_cpic_path`` from
    `wheel_snapshot`, then ``water_wheel_slabs`` from
    ``water_wheel_snapshot``. Returns the launches by path and rank."""
    import shutil
    import tempfile

    from taichi_mpm_torch.runner import snapshot_path

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_water_wheel_") as d:
        emitted = water_wheel_snapshot(os.path.join(d, "warm"))
        for run in ("slabs", "mpm"):
            os.makedirs(os.path.join(d, run))
            shutil.copyfile(snapshot_path(os.path.join(d, "warm"), 0),
                            snapshot_path(os.path.join(d, run), 0))
        snap_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = ranks_of(slab_cpic_rank, 2, args=(wheel_snapshot, os.path.join(d, "slabs")))
        ranks_s = time.perf_counter() - t0
        launches = phase_dist_cpic_path(card, wheel_snapshot, [r["path"] for r in ranks], ranks_s)
        launches.update(phase_water_wheel_slabs(card, [r["water_wheel"] for r in ranks],
                                                os.path.join(d, "mpm"), emitted, snap_s))
    return launches


def phase_dist_cpic_path(card, wheel_snapshot, ranks, ranks_s):
    """``dist_cpic_path``: the 100k CPIC wheel (scenes.cpic_wheel(), res 96,
    bench.py's CPIC scene) from phase cpic_path's state (`wheel_snapshot`:
    the water on the wheel) on two ranks sharing the card (gloo), fused
    and balanced, 1 + DIST_PATH_TIMED_FRAMES frames of 20 substeps (each
    rank's result of ``dist_cpic_path_rank`` in `ranks`, the group's
    seconds `ranks_s`): ms and host syncs per substep per rank
    (HostSyncs and torch's own count), the exchange's, the impulse
    all-reduces' and the migration's ms (a synced frame), each kernel
    once per substep per rank; all 100,000 particles kept, finite and in
    the domain, the bodies equal in bits on both ranks, both ranks' near
    sets used. Beside it the same frames from the same snapshot through
    MPM's CPIC frame. The two ranks time-share one H100: this is no
    scaling number. Returns the launches by rank."""
    import torch

    from taichi_mpm_torch import scenes
    from taichi_mpm_torch.utils import HostSyncs

    failures = []
    torch.cuda.empty_cache()
    n_timed = DIST_PATH_TIMED_FRAMES * SUBSTEPS_PER_FRAME
    for r in ranks:
        failures += [f"rank {r['rank']}: {f}"
                     for f in route_failures(r["launches"], True, n_timed, CPIC_KERNELS)]
        if r["count"] != 100_000 or r["outside_or_nan"]:
            failures.append(f"rank {r['rank']}: {r['count']} particles, "
                            f"{r['outside_or_nan']} outside the domain or not finite")
    if sum(r["local_particles"] for r in ranks) != 100_000:
        failures.append("the slabs do not hold 100,000 particles between them")
    if ranks[0]["body_sha"] != ranks[1]["body_sha"]:
        failures.append("the ranks' bodies differ in bits")
    if min(r["n_near"] for r in ranks) == 0:
        failures.append(f"a rank's near set stayed empty: {[r['n_near'] for r in ranks]}")

    sim = on_route(True, lambda: scenes.cpic_wheel(device="cuda"))
    sim.frame_dt = SUBSTEPS_PER_FRAME * sim.cfg.base_dt
    sim.load(wheel_snapshot)
    sim.step()
    sim.sync()
    syncs = HostSyncs.count
    t0 = time.perf_counter()
    for _ in range(DIST_PATH_TIMED_FRAMES):
        sim.step()
    sim.sync()
    one_ms = (time.perf_counter() - t0) * 1e3 / n_timed
    one_syncs = (HostSyncs.count - syncs) / n_timed
    one_near = sim.cpic_stats["n_near"]
    del sim
    emit(dict(phase="dist_cpic_path", card=card, what="two processes time-sharing one H100, "
              "not a scaling number", particles=100_000, res=96, timed_substeps=n_timed,
              ranks=[{k: v for k, v in r.items() if k != "body_sha"} for r in ranks],
              one_device_ms_per_substep=one_ms, one_device_host_syncs_per_substep=one_syncs,
              one_device_n_near=one_near, ranks_s=ranks_s, clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"),
              failures=failures))
    raise_failures(failures)
    return {f"dist_cpic_path_rank{r['rank']}": r["launches"] for r in ranks}


def water_wheel_run(shards, out, argv, device=DIST_DEVICE):
    """scripts/mls-cpic/water_wheel.py through the runner's scene
    (``runner.SCENES["water_wheel"]``, its source, ``runner.simulate``) at
    res 64 with the runner's arguments `argv` and ``--out`` `out`, with
    SHARDS=`shards` (DistributedMPM on the current group, every rank on
    `device`; 1: MPM), every launch count set to 0 before. Returns the
    particle count, the bodies, their hash, the substeps, the near sets,
    the seconds and the launches."""
    import torch

    from taichi_mpm_torch import runner

    os.environ["SHARDS"] = str(shards)
    try:
        args = runner.parse_args(["water_wheel", "--out", out, *argv], scene=True)
        args.device = device
        sim, frame_update = on_route(True, lambda: runner.SCENES["water_wheel"](args))
        zero_counts()
        t0 = time.perf_counter()
        runner.simulate(sim, args, frame_update=frame_update)
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        os.environ.pop("SHARDS", None)
    st = getattr(sim, "slab_stats", None)
    return dict(type=type(sim).__name__, count=sim.particle_count(), seconds=secs,
                omega=sim.bodies.omega.cpu().numpy(), body_sha=bodies_sha(sim),
                substeps=None if st is None else st.substeps, launches=read_counts(),
                n_near=sim.cpic_stats["n_near"] if st is None else st.n_near)


def water_wheel_snapshot(out, device="cuda"):
    """The water wheel with its water on the paddles, as the runner's
    snapshot of frame 0 in `out`: MPM through the runner's scene for one
    frame of WATER_WHEEL_FRAME_DT (the source's first emission, at y 0.81
    to 0.89), then that water moved down by WATER_WHEEL_DROP, onto the
    paddle left of the axle (y = 0.5), each particle at the speed of that
    fall. Returns the particle count."""
    from taichi_mpm_torch.runner import snapshot_path

    n = water_wheel_run(1, out, ["--frames", "1", "--snapshot-interval", "1",
                                 "--frame-dt", str(WATER_WHEEL_FRAME_DT)], device)["count"]
    path = snapshot_path(out, 0)
    with np.load(path) as data:
        arrays = dict(data)
    act = arrays["p.active"]
    arrays["p.x"][act, 1] -= np.float32(WATER_WHEEL_DROP)
    vy = arrays["p.v"][act, 1]
    arrays["p.v"][act, 1] = -np.sqrt(vy * vy + 2.0 * 9.8 * WATER_WHEEL_DROP).astype(np.float32)
    np.savez_compressed(path, **arrays)
    return n


def water_wheel_rank(shards, out, device=DIST_DEVICE):
    """``water_wheel_run`` resumed from the snapshot of frame 0 in `out`
    (the runner's --continue 0) for WATER_WHEEL_FRAMES frames of the
    snapshot's frame_dt (WATER_WHEEL_FRAME_DT), the source emitting each
    frame."""
    return water_wheel_run(shards, out, ["--continue", "0", "--frames",
                                         str(1 + WATER_WHEEL_FRAMES)], device)


def phase_water_wheel_slabs(card, ranks, mpm_dir, emitted, snap_s):
    """``water_wheel_slabs``: scripts/mls-cpic/water_wheel.py's scene
    through the runner, resumed from ``water_wheel_snapshot`` (its water
    on the paddles; `emitted` particles, made in `snap_s` s) for
    WATER_WHEEL_FRAMES frames of WATER_WHEEL_FRAME_DT with SHARDS=2 on two
    ranks sharing the card (gloo; each rank's ``water_wheel_rank`` in
    `ranks`), and with SHARDS unset (MPM) on the card from the snapshot's
    copy in `mpm_dir`: the same particle count, the wheel turning, its
    omega within the body bounds of MPM's, a near set on a rank, the
    bodies equal in bits on both ranks, each CPIC kernel once per
    substep per rank. Returns the launches by rank."""
    failures = []
    t0 = time.perf_counter()
    ref = water_wheel_rank(1, mpm_dir, "cuda")
    bound = dict(BODY_BOUNDS)["omega"]
    for r, res in enumerate(ranks):
        if res["type"] != "DistributedMPM":
            failures.append(f"rank {r}: the runner built {res['type']}")
        if res["count"] != ref["count"]:
            failures.append(f"rank {r}: {res['count']} particles, MPM {ref['count']}")
        err = float(np.abs(res["omega"] - ref["omega"]).max())
        if not err <= bound:
            failures.append(f"rank {r}: omega differs from MPM's by {err} > {bound}")
        failures += [f"rank {r}: {f}" for f in
                     route_failures(res["launches"], True, res["substeps"], CPIC_KERNELS)]
    if ranks[0]["body_sha"] != ranks[1]["body_sha"]:
        failures.append("the ranks' bodies differ in bits")
    if ref["count"] <= emitted:
        failures.append("the source emitted nothing after the snapshot")
    if max(r["n_near"] for r in ranks) == 0 or ref["n_near"] == 0:
        failures.append("no water reached the paddles: the coupling went untested")
    if ref["omega"][2, 2] == 0.0:
        failures.append("the wheel does not turn")
    emit(dict(phase="water_wheel_slabs", card=card, frames=WATER_WHEEL_FRAMES,
              particles=ref["count"], snapshot_particles=emitted,
              mpm_phase_s=time.perf_counter() - t0, snapshot_s=snap_s,
              mpm_seconds=ref["seconds"], ranks_seconds=[r["seconds"] for r in ranks],
              substeps_per_rank=ranks[0]["substeps"], n_near=[r["n_near"] for r in ranks],
              mpm_n_near=ref["n_near"], wheel_omega_z=float(ranks[0]["omega"][2, 2]),
              mpm_wheel_omega_z=float(ref["omega"][2, 2]), failures=failures))
    raise_failures(failures)
    return {f"water_wheel_rank{r}": res["launches"] for r, res in enumerate(ranks)}


# -- pencils: DistributedMPM(mesh_shape=(Sx, Sy)) over torch.distributed -------------

MESH_GLOO = (2, 2)  # four ranks sharing the card; one NCCL rank runs (1, 1)
MESH_CORNER_PLATE = (0.5, 0.49, 0.5)  # the plate across the four pencils' corner
# scene -> (routes, frames, bounds): the plain routes on the two res-32
# scenes of the JAX package's pencil tests and on corner_crossing (its
# particles reach the diagonal pencil within a re-sort), the balanced
# ones on corner_cluster, the three CPIC pencil frames on the free plate
# (and one across the four pencils' corner); with the refused fourth,
# every route of the driver's table. diagonal_pair's corner nodes take
# mass from two diagonal pencils while the two between hold nothing
MESH_SCENES = {
    "driver_jelly": (DIST_ROUTES, 2, FRAME_BOUNDS),
    "pencil_drift": (DIST_ROUTES, 3, FRAME_BOUNDS),
    "corner_crossing": (DIST_ROUTES, 2, FRAME_BOUNDS),
    "corner_cluster": ({k: DIST_ROUTES[k] for k in ("fused_balanced", "unfused_balanced")}, 3,
                       FRAME_BOUNDS),
    "plate": (DIST_CPIC_ROUTES, 2, CPIC_BOUNDS),
    "corner_plate": ({"fused_uniform": (True, False)}, 2, CPIC_BOUNDS),
    "diagonal_pair": ({k: DIST_ROUTES[k] for k in ("fused_uniform", "unfused_uniform")}, 1,
                      FRAME_BOUNDS),
}


def mesh_scene(name, solver, device):
    """A scene of MESH_SCENES built by `solver` on `device` (ids tagged):
    the free plate of ``scenes.plate_scene`` for "plate" (at
    MESH_CORNER_PLATE for "corner_plate"), else the scene of that name."""
    from taichi_mpm_torch import scenes
    from taichi_mpm_torch.rigid.mesh import plate_mesh

    if name in ("plate", "corner_plate"):
        center = MESH_CORNER_PLATE if name == "corner_plate" else (0.5, 0.4, 0.5)
        return scenes.plate_scene(solver, plate_mesh, free=True, center=center, device=device)
    return getattr(scenes, name)(solver, device=device)


def mesh_ref_path(ref_dir, scene, device, fused):
    return os.path.join(ref_dir, f"{scene}_{device}_fused{int(fused)}.npz")


def mesh_refs(ref_dir, device):
    """MPM's frames of each scene of MESH_SCENES on each route its runs
    take, on `device` (the CPU runs the kernels' plain twins), saved in
    `ref_dir` (``state_arrays``). Returns the particle count of each
    scene."""
    from taichi_mpm_torch import MPM

    counts = {}
    for scene, (routes, frames, _) in MESH_SCENES.items():
        for fused in sorted({f for f, _ in routes.values()}):
            ref = on_route(fused, lambda: mesh_scene(scene, MPM, device))
            for _ in range(frames):
                ref.step()
            np.savez(mesh_ref_path(ref_dir, scene, device, fused),
                     **state_arrays(ref, ref.particles))
            counts[scene] = ref.particle_count()
    return counts


def mesh_routes(ref_dir, runs, device=DIST_DEVICE):
    """On every rank of the current group, a (1, 1) mesh on one rank and
    MESH_GLOO on four: each (scene, route) of `runs` on
    DistributedMPM(mesh_shape=...), every launch count set to 0 before;
    with bodies each rank hashes them after every frame. Rank 0 holds the
    gathered state to MPM's frames on the card and on the CPU that
    ``mesh_refs`` saved (the scene's bounds; ``held_to``); every particle
    must stay finite and in the domain. Returns per run this rank's
    launches and events (migrants per axis, diagonal ones, bounds and
    whether each axis's left the uniform split), and on rank 0 the
    errors, whether they are 0 and the failures."""
    import functools

    import torch

    from taichi_mpm_torch.parallel import comm
    from taichi_mpm_torch.parallel.driver import DistributedMPM
    from taichi_mpm_torch.utils import HostSyncs

    mesh = (1, 1) if comm.world() == 1 else MESH_GLOO
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // comm.world()))  # ranks share the cores
    out = {}
    for scene, route in runs:
        routes, frames, bounds = MESH_SCENES[scene]
        fused, balanced = routes[route]
        solver = functools.partial(DistributedMPM, mesh_shape=mesh, balanced=balanced)
        sim = on_route(fused, lambda: mesh_scene(scene, solver, device))
        sim._ensure_finalized()
        local_start = int(sim.particles.active.sum())
        zero_counts()
        syncs = HostSyncs.count
        shas = []
        for _ in range(frames):
            sim.step()
            if sim.bodies is not None:
                shas.append(bodies_sha(sim))
        if device != "cpu":
            torch.cuda.synchronize()
        syncs = HostSyncs.count - syncs
        st = sim.slab_stats
        res = dict(launches=read_counts(), fused=sim.fused, balanced=sim.balanced,
                   substeps=st.substeps, resorts=st.resorts, sent_x=(st.sent_left, st.sent_right),
                   sent_y=(st.sent_low_y, st.sent_high_y), diagonal=int(st.diagonal),
                   arrived=st.arrived, grown=st.grown, count=sim.particle_count(),
                   local_start=local_start, host_syncs_per_substep=syncs / st.substeps,
                   expected_substeps=frames * max(1, round(sim.frame_dt / sim.cfg.base_dt)))
        if sim.balanced:
            res.update(bounds=st.bounds[:1] + st.bounds[-1:], off_uniform=[
                tuple(b) != tuple(int(v) for v in u)
                for b, u in zip(st.bounds[-1], sim.slabs.uniform)])
        if sim.bodies is not None:
            res.update(n_near=st.n_near, body_sha=shas,
                       omega_max=float(sim.bodies.omega.abs().max()))
        g = sim._gather()
        if sim.rank == 0:
            failures = []
            got = state_arrays(sim, g)
            label = f"{scene} {route}"
            res["errors"], res["mpm_bits"] = held_to(
                load_ref(mesh_ref_path(ref_dir, scene, "cuda", fused)), got, label, bounds,
                failures)
            res["cpu_errors"], res["cpu_bits"] = held_to(
                load_ref(mesh_ref_path(ref_dir, scene, "cpu", fused)), got, f"{label} vs CPU",
                bounds, failures)
            x = got["x"]
            if not (np.isfinite(x).all() and x.min() >= 0.0
                    and (x <= np.asarray(sim.cfg.res) * sim.cfg.dx).all()):
                failures.append(f"{label}: positions not finite or outside the domain")
            res["failures"] = failures
        out[f"{scene}_{route}"] = res
        del sim, g
    return out


def mesh_refused(device=DIST_DEVICE):
    """The fourth CPIC row: TMT_FUSED=0 on balanced pencils with a body.
    Returns the ValueError's message, None where the frame ran."""
    import functools

    from taichi_mpm_torch.parallel.driver import DistributedMPM

    sim = on_route(False, lambda: mesh_scene(
        "plate", functools.partial(DistributedMPM, mesh_shape=(1, 1)), device))
    try:
        sim.step()
    except ValueError as e:
        return str(e)
    return None


def phase_mesh_check(card):
    """``mesh_check``: each scene of MESH_SCENES on its pencil routes, every
    route of the driver's table, on DistributedMPM(mesh_shape=...): (a) one
    rank over NCCL in this process, a (1, 1) mesh; (b) four ranks sharing
    the card over gloo, spawned, a (2, 2) mesh. Each run held to MPM's
    frames on the card and on the CPU (the kernels' plain twins) at the
    frame bounds (plain) or the CPIC and body bounds, each kernel of its
    route once per substep per rank and no other, every particle kept,
    finite and in the domain; on four ranks particles migrate along x and
    along y, with diagonal migrants (corner_crossing), both axes' bounds
    off the uniform split on corner_cluster, and the bodies equal in bits
    on all four ranks after every frame; on diagonal_pair the pencils
    between hold nothing. The refused route raises the JAX driver's
    ValueError. Whether the one NCCL rank gives MPM's bits is
    printed per run. Returns the launches by path."""
    import tempfile

    from taichi_mpm_torch.parallel import comm

    failures = []
    t0 = time.perf_counter()
    runs = [(scene, route) for scene, (routes, _, _) in MESH_SCENES.items() for route in routes]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_check_") as d:
        counts = mesh_refs(d, "cuda")
        t_cpu = time.perf_counter()
        mesh_refs(d, "cpu")
        cpu_s = time.perf_counter() - t_cpu
        with comm.process_group("nccl", 0, 1, comm.free_port(), timeout_s=DIST_TIMEOUT_S):
            nccl = mesh_routes(d, runs)
            refused = mesh_refused()
        gloo = ranks_of(mesh_routes, 4, args=(d, runs))
    if refused is None or not refused.startswith("TMT_FUSED=0 routes CPIC pencil scenes"):
        failures.append(f"unfused balanced CPIC pencils not refused: {refused}")
    for label, ranks in [("nccl", [nccl])] + [(f"gloo rank {r}", [g]) for r, g in enumerate(gloo)]:
        for res_of in ranks:
            for key, res in res_of.items():
                scene = next(s for s in MESH_SCENES if key.startswith(s + "_"))
                dist_failures(f"{label} {key}", res, counts[scene], res["expected_substeps"],
                              failures)
    for key in gloo[0]:
        if "body_sha" in gloo[0][key] and len({tuple(g[key]["body_sha"]) for g in gloo}) != 1:
            failures.append(f"gloo {key}: the ranks' bodies differ in bits")
    crossing = [g[k] for g in gloo for k in g if k.startswith("corner_crossing")]
    moved = dict(x=sum(sum(r["sent_x"]) for r in crossing), y=sum(sum(r["sent_y"]) for r in crossing),
                 diagonal=sum(r["diagonal"] for r in crossing))
    if not (moved["x"] and moved["y"] and moved["diagonal"]):
        failures.append(f"corner_crossing: migrants {moved}, none on an axis or none diagonal")
    for key in (k for k in gloo[0] if k.startswith("diagonal_pair")):
        if [g[key]["local_start"] for g in gloo][1:3] != [0, 0]:
            failures.append(f"gloo {key}: the pencils between the pair hold particles")
    for key in (k for k in gloo[0] if k.startswith("corner_cluster")):
        if not all(gloo[0][key]["off_uniform"]):
            failures.append(f"gloo {key}: bounds {gloo[0][key]['bounds']} left the uniform "
                            "split on an axis only")
    launches = {"mesh_check_nccl": {}, "mesh_check_gloo": {}}
    for path, ranks in (("mesh_check_nccl", [nccl]), ("mesh_check_gloo", gloo)):
        for res_of in ranks:
            for res in res_of.values():
                for k, v in res["launches"].items():
                    launches[path][k] = launches[path].get(k, 0) + v

    def shown(res_of):
        return {k: {n: v for n, v in r.items() if n not in ("launches", "body_sha")}
                for k, r in res_of.items()}

    emit(dict(phase="mesh_check", card=card, particles=counts, seconds=time.perf_counter() - t0,
              cpu_reference_s=cpu_s, what="a (1, 1) mesh on one NCCL rank and a (2, 2) mesh on "
              "four gloo ranks sharing one H100, not a scaling number",
              nccl_mpm_bits={k: r["mpm_bits"] for k, r in nccl.items()},
              nccl=shown(nccl), gloo=[shown(g) for g in gloo], gloo_migrants=moved,
              refused=refused, launches=launches, failures=failures))
    raise_failures(failures)
    return launches


def mesh_path_rank():
    """``dist_path_rank`` on a MESH_GLOO mesh of pencils, the host's cores
    shared between the ranks."""
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // 4))
    return dist_path_rank(MESH_GLOO)


def phase_mesh_path(card, one_ms):
    """``mesh_path``: the 8M jelly cube at res 128 on a (2, 2) mesh, four
    ranks sharing the card (gloo), fused and balanced, 1 +
    DIST_PATH_TIMED_FRAMES frames of 20 substeps (``slab_path_frames``:
    ms and host syncs per substep, HostSyncs and torch's count, the
    exchange's and the migration's ms in a synced frame, migrants per
    axis, peak memory), beside one device's ms per substep from
    ``dist_path`` (`one_ms`); each kernel once per substep per rank; all
    8,000,000 particles kept, finite and in the domain. The four ranks
    time-share one H100: this is no scaling number. Returns the launches
    by rank."""
    import torch

    failures = []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = ranks_of(mesh_path_rank, 4)
    ranks_s = time.perf_counter() - t0
    n_timed = DIST_PATH_TIMED_FRAMES * SUBSTEPS_PER_FRAME
    for r in ranks:
        failures += [f"rank {r['rank']}: {f}" for f in route_failures(r["launches"], True, n_timed)]
        if r["count"] != 8_000_000 or r["outside_or_nan"]:
            failures.append(f"rank {r['rank']}: {r['count']} particles, "
                            f"{r['outside_or_nan']} outside the domain or not finite")
    if sum(r["local_particles"] for r in ranks) != 8_000_000:
        failures.append("the pencils do not hold 8,000,000 particles between them")
    emit(dict(phase="mesh_path", card=card, what="four processes time-sharing one H100, "
              "not a scaling number", particles=8_000_000, res=DIST_PATH_RES, mesh=MESH_GLOO,
              timed_substeps=n_timed, ranks=ranks, one_device_ms_per_substep=one_ms,
              ranks_s=ranks_s, clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"),
              failures=failures))
    raise_failures(failures)
    return {f"mesh_path_rank{r['rank']}": r["launches"] for r in ranks}


def mesh_cpic_path_rank(wheel_snapshot):
    """``dist_cpic_path_rank`` on a MESH_GLOO mesh of pencils, the host's
    cores shared between the ranks."""
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // 4))
    return dist_cpic_path_rank(wheel_snapshot, MESH_GLOO)


def phase_mesh_cpic_path(card, wheel_snapshot):
    """``mesh_cpic_path``: the 100k CPIC wheel (scenes.cpic_wheel(), res 96)
    from phase cpic_path's state (`wheel_snapshot`: the water on the
    wheel) on a (2, 2) mesh, four ranks sharing the card (gloo), fused and
    balanced, 1 + DIST_PATH_TIMED_FRAMES frames of 20 substeps
    (``slab_path_frames``, with the impulse all-reduces' ms and each
    rank's near set), beside MPM's CPIC frames from the same snapshot;
    each CPIC kernel once per substep per rank; all 100,000 particles
    kept, finite and in the domain; the bodies equal in bits on all four
    ranks; a near set used. The four ranks time-share one H100: this is
    no scaling number. Returns the launches by rank."""
    import torch

    from taichi_mpm_torch import scenes

    failures = []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = ranks_of(mesh_cpic_path_rank, 4, args=(wheel_snapshot,))
    ranks_s = time.perf_counter() - t0
    n_timed = DIST_PATH_TIMED_FRAMES * SUBSTEPS_PER_FRAME
    for r in ranks:
        failures += [f"rank {r['rank']}: {f}"
                     for f in route_failures(r["launches"], True, n_timed, CPIC_KERNELS)]
        if r["count"] != 100_000 or r["outside_or_nan"]:
            failures.append(f"rank {r['rank']}: {r['count']} particles, "
                            f"{r['outside_or_nan']} outside the domain or not finite")
    if sum(r["local_particles"] for r in ranks) != 100_000:
        failures.append("the pencils do not hold 100,000 particles between them")
    if len({r["body_sha"] for r in ranks}) != 1:
        failures.append("the ranks' bodies differ in bits")
    if max(r["n_near"] for r in ranks) == 0:
        failures.append("no rank's near set held a particle")

    sim = on_route(True, lambda: scenes.cpic_wheel(device="cuda"))
    sim.frame_dt = SUBSTEPS_PER_FRAME * sim.cfg.base_dt
    sim.load(wheel_snapshot)
    sim.step()
    sim.sync()
    t1 = time.perf_counter()
    for _ in range(DIST_PATH_TIMED_FRAMES):
        sim.step()
    sim.sync()
    one_ms = (time.perf_counter() - t1) * 1e3 / n_timed
    del sim
    emit(dict(phase="mesh_cpic_path", card=card, what="four processes time-sharing one H100, "
              "not a scaling number", particles=100_000, res=96, mesh=MESH_GLOO,
              timed_substeps=n_timed, ranks=[{k: v for k, v in r.items() if k != "body_sha"}
                                             for r in ranks],
              one_device_ms_per_substep=one_ms, ranks_s=ranks_s,
              clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"), failures=failures))
    raise_failures(failures)
    return {f"mesh_cpic_path_rank{r['rank']}": r["launches"] for r in ranks}


# -- per-block async on slabs: DistributedAsyncMPM ----------------------------------------

DIST_ASYNC_FRAMES = 2
DIST_ASYNC_BOUNDS = (("x", 1e-5), ("v", 5e-4))  # JAX's own, its slab vs one-device frames
ASYNC_DAM_CHECK_RES = 32
ASYNC_PATH_RES = 128  # balls.py's 94k particles and water.py's 1,056,758
BALLS_RESUME_FRAMES = 12  # 0.06 s at 3 m/s: the stiff ball's front reaches x = 0.5


def async_blobs(solver, device, soft_x=(0.15, 0.49), stiff_x=(0.51, 0.80), **kw):
    """tests/test_async_spatial.py's driver scene: a soft (E 4e3, 1,200
    particles, x in `soft_x`) and a stiff (E 4e5, 300, x in `stiff_x`)
    elastic blob either side of x = 0.5 at res 32, moving slowly, no
    gravity; frames of 64 units of 5e-4 s."""
    from taichi_mpm_torch import scenes

    rng = np.random.default_rng(7)
    sim = solver(res=(32, 32, 32), base_delta_t=1e-3, frame_dt=scenes.SLAB_UNIT * 64,
                 unit_delta_t=scenes.SLAB_UNIT, gravity=(0.0, 0.0, 0.0), device=device, **kw)
    soft = rng.uniform((soft_x[0], 0.3, 0.3), (soft_x[1], 0.7, 0.7),
                       (1200, 3)).astype(np.float32)
    stiff = rng.uniform((stiff_x[0], 0.4, 0.4), (stiff_x[1], 0.6, 0.6),
                        (300, 3)).astype(np.float32)
    sim.add_particles("elastic", pos=soft, vel=(0.1, -0.05, 0.02), E=4e3, nu=0.3, density=1000)
    sim.add_particles("elastic", pos=stiff, vel=(-0.1, 0.05, 0.0), E=4e5, nu=0.3, density=1000)
    return scenes.tag_pending(sim)


def async_scene(name, solver, device, **kw):
    """A scene of ASYNC_SCENES: the blobs; the blobs apart (the soft one
    in x <= 0.40, the stiff one in x >= 0.60: no grid node takes mass from
    both slabs, so every boundary record is one rank's sum plus the
    other's zeros); the crossing blob (tests/test_async_spatial.py:110-139:
    re-sorts, and particles cross x = 0.5); scripts/async/water.py's dam
    at res 32 (the right slab starts empty), frames of 5e-4 s."""
    from taichi_mpm_torch import scenes

    if name == "blobs":
        return async_blobs(solver, device, **kw)
    if name == "apart":
        return async_blobs(solver, device, (0.15, 0.40), (0.60, 0.80), **kw)
    if name == "crossing":
        return scenes.crossing_blob(solver, device, **kw)
    return scenes.dam_frame(ASYNC_DAM_CHECK_RES, solver, device, **kw)


ASYNC_SCENES = ("blobs", "apart", "crossing", "dam")
# where two gloo ranks must give one device's bits: no node sums two ranks' halves
ASYNC_ONE_SIDED = ("apart", "dam")


def async_run(sim, frames):
    """Frames of a per-block scene (AsyncMPM or DistributedAsyncMPM), every
    launch count set to 0 before: per frame the updates, the schedule,
    the sorts and this rank's level histograms; the kernel advances, the
    launches, and the state by id tag (gathered on slabs)."""
    sim._ensure_finalized()
    local = int(sim.particles.active.sum())
    zero_counts()
    out = dict(updates=[], schedule=[], sorts=[], level_hist=[], empty=0, kernel_advances=0)
    for _ in range(frames):
        n0 = sim.update_counter
        sim.step()
        st = sim.last_frame_stats
        out["updates"].append(sim.update_counter - n0)
        out["schedule"].append(st.schedule)
        out["sorts"].append(st.sorts)
        out["level_hist"].append(st.level_hist)
        out["empty"] += st.empty_advances
        out["kernel_advances"] += st.n_substeps - st.empty_advances
    out["launches"] = read_counts()
    slabs = getattr(sim, "slab_stats", None)
    if slabs is not None:
        out.update(sent=(slabs.sent_left, slabs.sent_right), arrived=slabs.arrived,
                   local_start=local, rank=sim.rank)
    out["state"] = tagged(sim._gather() if slabs is not None else sim.particles)
    out["count"] = sim.particle_count()
    out["t"] = float(sim.t)
    out["sha256"] = hashlib.sha256(b"".join(
        np.ascontiguousarray(v).tobytes() for v in out["state"].values())).hexdigest()
    return out


def dist_async_runs(runs, device=DIST_DEVICE):
    """On every rank of the current group: each (scene, repeat) of `runs`
    on DistributedAsyncMPM for DIST_ASYNC_FRAMES frames (``async_run``)."""
    from taichi_mpm_torch.parallel.driver import DistributedAsyncMPM

    return {f"{name}_{rep}": async_run(async_scene(name, DistributedAsyncMPM, device),
                                       DIST_ASYNC_FRAMES)
            for name, rep in runs}


def async_failures(label, res, ref, hist, failures):
    """One rank's run held to one device's: the updates, schedule and
    sorts of every frame, the level histograms summed over the ranks
    (`hist`), every particle kept, x and v within DIST_ASYNC_BOUNDS, each
    fused kernel once per advance with a context and no other kernel."""
    for key in ("updates", "schedule", "sorts"):
        if res[key] != ref[key]:
            failures.append(f"{label}: {key} differ from one device's")
    if hist != ref["level_hist"]:
        failures.append(f"{label}: level histograms {hist} vs {ref['level_hist']}")
    if res["count"] != ref["count"]:
        failures.append(f"{label}: {res['count']} particles, one device {ref['count']}")
    failures += [f"{label}: {f}"
                 for f in route_failures(res["launches"], True, res["kernel_advances"])]
    return tagged_errors(ref["state"], res["state"], label, failures, DIST_ASYNC_BOUNDS)


def plain_errors(label, res, plain, bounds, failures):
    """A run held to the same frames on the CPU (AsyncMPM(per_block=True),
    the kernels' plain twins): the updates, schedule and sorts of every
    frame equal, every particle kept, the fields within `bounds`. Returns
    the errors."""
    for key in ("updates", "schedule", "sorts"):
        if res[key] != plain[key]:
            failures.append(f"{label}: {key} differ from the CPU frames'")
    return tagged_errors(plain["state"], res["state"], f"{label} vs CPU", failures, bounds)


def phase_dist_async_check(card):
    """``dist_async_check``: DistributedAsyncMPM against AsyncMPM(per_block=
    True) on the card, DIST_ASYNC_FRAMES frames of each scene of
    ASYNC_SCENES, (a) on one rank over NCCL in this process, (b) on two
    ranks sharing the card over gloo (spawned; the dam twice): the
    updates, the schedule of (tick, level), the sorts and the level
    histograms of every sort (summed over the ranks) equal, x within 1e-5
    and v within 5e-4 (JAX's bounds between these two paths; the errors
    printed, and whether the bits are one device's), every particle
    kept, each fused kernel once per advance with a context; the crossing
    blob re-sorts and migrates; on the dam the right slab starts empty,
    its frames end on both ranks, and the second run has the first's
    bits. One NCCL rank gives one device's bits, and so do two gloo ranks
    on the scenes of ASYNC_ONE_SIDED, where no node takes mass from both
    slabs: what parts the others is the sum of a boundary node's two
    halves. Since one device's card frame launches the same kernels, every
    run is also held to AsyncMPM(per_block=True) on the CPU, where the
    kernels' plain twins run: the updates, schedule and sorts equal, the
    NCCL run within the frame bounds (FRAME_BOUNDS), the gloo runs within
    x 1e-5 and v 5e-4. Returns the launches by path."""
    from taichi_mpm_torch.core.adaptive import AsyncMPM
    from taichi_mpm_torch.parallel import comm

    failures = []
    t0 = time.perf_counter()
    refs = {name: async_run(async_scene(name, AsyncMPM, "cuda", per_block=True),
                            DIST_ASYNC_FRAMES) for name in ASYNC_SCENES}
    t_plain = time.perf_counter()
    plain = {name: async_run(async_scene(name, AsyncMPM, "cpu", per_block=True),
                             DIST_ASYNC_FRAMES) for name in ASYNC_SCENES}
    plain_s = time.perf_counter() - t_plain
    runs = [(name, 0) for name in ASYNC_SCENES]
    with comm.process_group("nccl", 0, 1, comm.free_port(), timeout_s=DIST_TIMEOUT_S):
        nccl = dist_async_runs(runs)
    gloo = ranks_of(dist_async_runs, 2, args=(runs + [("dam", 1)],))
    shown = {}
    for key, res in nccl.items():
        ref = refs[key[:-2]]
        errs = async_failures(f"nccl {key}", res, ref, res["level_hist"], failures)
        shown[f"nccl_{key}"] = dict(
            errors=errs, bits=res["sha256"] == ref["sha256"], updates=res["updates"],
            vs_plain=plain_errors(f"nccl {key}", res, plain[key[:-2]], FRAME_BOUNDS, failures))
        if not shown[f"nccl_{key}"]["bits"]:
            failures.append(f"nccl {key}: not one device's bits")
    for key in gloo[0]:
        ref = refs[key[:-2]]
        hist = [[[x + y for x, y in zip(a, b)] for a, b in zip(f0, f1)]
                for f0, f1 in zip(gloo[0][key]["level_hist"], gloo[1][key]["level_hist"])]
        for r in range(2):
            errs = async_failures(f"gloo rank {r} {key}", gloo[r][key], ref, hist, failures)
            vs_plain = plain_errors(f"gloo rank {r} {key}", gloo[r][key], plain[key[:-2]],
                                    DIST_ASYNC_BOUNDS, failures)
        g = gloo[0][key]
        shown[f"gloo_{key}"] = dict(
            errors=errs, vs_plain=vs_plain, bits=g["sha256"] == ref["sha256"],
            updates=g["updates"],
            sorts=g["sorts"], sent=[gloo[r][key]["sent"] for r in range(2)],
            local_start=[gloo[r][key]["local_start"] for r in range(2)],
            empty_advances=[gloo[r][key]["empty"] for r in range(2)], level_hist=hist)
        if key[:-2] in ASYNC_ONE_SIDED and not shown[f"gloo_{key}"]["bits"]:
            failures.append(f"gloo {key}: not one device's bits, though no node has two halves")
    crossing = gloo[0]["crossing_0"]
    if max(crossing["sorts"]) < 2 or crossing["sent"][1] == 0:
        failures.append(f"crossing: sorts {crossing['sorts']}, sent {crossing['sent']}: "
                        "no re-sort or no migrant")
    dam = [gloo[r]["dam_0"] for r in range(2)]
    if dam[1]["local_start"] != 0 or dam[1]["empty"] == 0:
        failures.append(f"dam: the right slab started with {dam[1]['local_start']} particles")
    if gloo[0]["dam_0"]["sha256"] != gloo[0]["dam_1"]["sha256"]:
        failures.append("dam: a second run on the card differs in bits")
    launches = {"dist_async_check_nccl": {}, "dist_async_check_gloo": {}}
    for path, ranks in (("dist_async_check_nccl", [nccl]), ("dist_async_check_gloo", gloo)):
        for by_run in ranks:
            for res in by_run.values():
                for k, v in res["launches"].items():
                    launches[path][k] = launches[path].get(k, 0) + v
    emit(dict(phase="dist_async_check", card=card, frames=DIST_ASYNC_FRAMES,
              particles={k: r["count"] for k, r in refs.items()},
              one_device_updates={k: r["updates"] for k, r in refs.items()},
              one_device_sorts={k: r["sorts"] for k, r in refs.items()},
              runs=shown, plain_seconds=plain_s, seconds=time.perf_counter() - t0,
              launches=launches, failures=failures))
    raise_failures(failures)
    return launches


def async_path_scene(name, solver, device, balls_snapshot, **kw):
    """balls.py resumed from `balls_snapshot`, or water.py's dam, at
    ASYNC_PATH_RES."""
    from taichi_mpm_torch import scenes

    if name == "dam":
        return scenes.water_script(res=ASYNC_PATH_RES, device=device, solver=solver, **kw)
    sim = scenes.async_balls(res=ASYNC_PATH_RES, device=device, solver=solver, **kw)
    sim.load(balls_snapshot)
    return sim


def balls_snapshot(path):
    """balls.py at ASYNC_PATH_RES after BALLS_RESUME_FRAMES frames of
    AsyncMPM(per_block=True) on the card, saved to `path`: the stiff
    ball's front at the slab boundary x = 0.5, so that the frames after it
    migrate particles and sum boundary nodes from both slabs. Returns the
    stiff ball's largest x and the seconds taken."""
    from taichi_mpm_torch import scenes

    t0 = time.perf_counter()
    sim = scenes.async_balls(res=ASYNC_PATH_RES, device="cuda", per_block=True)
    for _ in range(BALLS_RESUME_FRAMES):
        sim.step()
    sim.save(path)
    p = sim.particles
    front = float(p.x[p.active & (p.v[:, 0] > 1.5), 0].max())
    return front, time.perf_counter() - t0


def async_path_frames(sim):
    """A warm-up frame under torch's sync debug mode (the synchronizing
    calls torch reports, per advance), then one timed frame (host clock,
    fenced): ms per frame and per advance, advances, host syncs per
    advance, updates of both frames, launches of the timed frame."""
    import warnings

    import torch

    from taichi_mpm_torch.utils import HostSyncs

    sim._ensure_finalized()
    n = sim.particle_count()
    torch.cuda.synchronize()
    n0 = sim.update_counter
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sim.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    warm = sim.last_frame_stats
    torch_syncs = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
    warm_updates = sim.update_counter - n0
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    if hasattr(sim, "slab_stats"):
        from taichi_mpm_torch.parallel import comm

        comm.all_max(torch.zeros((), device=sim.device))  # the ranks start the clock together
    slabs = getattr(sim, "slab_stats", None)
    sent0 = 0 if slabs is None else slabs.sent_left + slabs.sent_right
    syncs, n0 = HostSyncs.count, sim.update_counter
    t0 = time.perf_counter()
    sim.step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = sim.last_frame_stats
    adv = st.n_substeps
    p = sim.particles
    x = p.x[p.active]
    hi = sim.cfg.res[0] * sim.cfg.dx
    bad = int((~(torch.isfinite(x).all(-1) & (x >= 0).all(-1) & (x <= hi).all(-1))).sum())
    return dict(particles=n, ms_per_frame=secs * 1e3, ms_per_advance=secs * 1e3 / adv,
                advances_per_level=st.advances, empty_advances=st.empty_advances,
                kernel_advances=adv - st.empty_advances, sorts=st.sorts,
                host_syncs_per_advance=(HostSyncs.count - syncs) / adv,
                torch_syncs_per_advance=torch_syncs / warm.n_substeps,
                warm_updates=warm_updates, updates=sim.update_counter - n0,
                migrants=None if slabs is None else slabs.sent_left + slabs.sent_right - sent0,
                launches=read_counts(), local_particles=int(p.active.sum()),
                count=sim.particle_count(), outside_or_nan=bad,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def dist_async_path_rank(snapshot):
    """On each rank of the shared-card group: balls.py (resumed from
    `snapshot`) and water.py's dam at ASYNC_PATH_RES on
    DistributedAsyncMPM, ``async_path_frames`` each, and the migrants."""
    import torch

    from taichi_mpm_torch.parallel.driver import DistributedAsyncMPM

    out = {}
    for name in ("balls", "dam"):
        t0 = time.perf_counter()
        sim = async_path_scene(name, DistributedAsyncMPM, DIST_DEVICE, snapshot)
        sim._ensure_finalized()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        res = async_path_frames(sim)
        st = sim.slab_stats
        res.update(rank=sim.rank, setup_s=setup_s, sent=(st.sent_left, st.sent_right),
                   arrived=st.arrived, grown=st.grown)
        out[name] = res
        del sim
        torch.cuda.empty_cache()
    return out


def phase_dist_async_path(card, snapshot, front, snapshot_s):
    """``dist_async_path``: scripts/async/balls.py (94k particles) resumed
    where the stiff ball's front reaches the slab boundary (`snapshot`,
    made by ``balls_snapshot`` in the check block, with the front's x and
    its seconds: it crosses into the right slab in both frames)
    and scripts/async/water.py's dam (1,056,758 particles) at res 128 through
    DistributedAsyncMPM on two ranks sharing the card (gloo), a warm-up
    frame and a timed frame each (``async_path_frames``), beside
    AsyncMPM(per_block=True) on the card: ms per frame and per advance,
    advances per level, host syncs per advance (HostSyncs and torch's
    count), migrants and updates per rank. Gates: the warm-up frame's
    updates equal one device's (the same input; the timed frame's are
    printed: its input differs by the slabs' rounding); every particle
    kept, finite and in the domain; each fused kernel once per advance
    with a context on each rank; balls: particles migrate in the timed
    frame. The two ranks time-share one H100: this is no scaling number.
    Returns the launches by scene and rank."""

    import torch

    from taichi_mpm_torch.core.adaptive import AsyncMPM

    failures = []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = ranks_of(dist_async_path_rank, 2, args=(snapshot,))
    ranks_s = time.perf_counter() - t0
    one = {}
    for name in ("balls", "dam"):
        sim = async_path_scene(name, AsyncMPM, "cuda", snapshot, per_block=True)
        one[name] = async_path_frames(sim)
        del sim
        torch.cuda.empty_cache()
        for r in ranks:
            res = r[name]
            label = f"{name} rank {res['rank']}"
            failures += [f"{label}: {f}"
                         for f in route_failures(res["launches"], True, res["kernel_advances"])]
            if res["count"] != one[name]["count"] or res["outside_or_nan"]:
                failures.append(f"{label}: {res['count']} particles (one device "
                                f"{one[name]['count']}), {res['outside_or_nan']} outside the "
                                "domain or not finite")
            if res["warm_updates"] != one[name]["warm_updates"]:
                failures.append(f"{label}: {res['warm_updates']} updates in the first frame, "
                                f"one device {one[name]['warm_updates']}")
        if sum(r[name]["local_particles"] for r in ranks) != one[name]["count"]:
            failures.append(f"{name}: the slabs do not hold every particle between them")
    if sum(r["balls"]["migrants"] for r in ranks) == 0:
        failures.append(f"balls: no particle migrated in the timed frame (the stiff ball's "
                        f"front at x = {front} after the snapshot's frames)")
    emit(dict(phase="dist_async_path", card=card, what="two processes time-sharing one H100, "
              "not a scaling number", res=ASYNC_PATH_RES,
              ranks=[{n: {k: v for k, v in r[n].items() if k != "launches"} for n in r}
                     for r in ranks],
              one_device={n: {k: v for k, v in o.items() if k != "launches"}
                          for n, o in one.items()},
              balls_resume_frames=BALLS_RESUME_FRAMES, balls_front_x=front,
              balls_snapshot_s=snapshot_s, ranks_s=ranks_s,
              clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"), failures=failures))
    raise_failures(failures)
    return {f"dist_async_path_{name}_rank{r[name]['rank']}": r[name]["launches"]
            for r in ranks for name in r}


# -- the dense slab frames: parallel.spatial and parallel.sharding --------------------

DENSE_STRIP_FRAMES = 4  # of DENSE_STRIP_SUBSTEPS, tests/test_spatial.py's
DENSE_STRIP_SUBSTEPS = 10
DENSE_CUBE_SUBSTEPS = 5  # tests/test_sharding.py's
DENSE_SLAB_TIMED_SUBSTEPS = 10  # colliding balls at res 100, after one warm-up substep
DENSE_SLAB_BOUNDS = FRAME_BOUNDS[:3]  # x, v, F


def dense_strip(device):
    """tests/test_spatial.py's 2-D strip (scenes.spatial_strip: 400 jelly
    particles moving at 1 m/s along x, res 64), each particle's index
    tagged."""
    from taichi_mpm_torch import MPM, scenes

    sim = scenes.tag_pending(scenes.spatial_strip(MPM, device=device))
    sim._ensure_finalized()
    return sim


def dense_cube(device):
    """tests/test_sharding.py's cube (scenes.sharding_cube: 512 jelly
    particles in a sticky box), each particle's index tagged."""
    from taichi_mpm_torch import scenes

    sim = scenes.tag_pending(scenes.sharding_cube(device))
    sim._finalize(capacity=512)
    return sim


def dense_balls(device):
    """colliding_balls_energy.py at its res 100 (67,044 particles), with an
    even capacity (the data-parallel frame halves it)."""
    from taichi_mpm_torch import scenes

    sim = scenes.colliding_balls_energy(res=DENSE_PATH_RES, device=device)
    sim._finalize(capacity=67_044)
    return sim


def dense_slab_runs(device=DIST_DEVICE, timed=False):
    """On every rank of the current group: the dense slab frame
    (``parallel.spatial``) on the strip, DENSE_STRIP_FRAMES frames, and the
    data-parallel frame (``parallel.sharding``) on the cube,
    DENSE_CUBE_SUBSTEPS substeps, from the same global particles; each
    returns the global state by id tag, the count and the launches. With
    `timed`, both frames on colliding balls at res 100: ms per substep on
    this rank (host clock, fenced), after a warm-up substep."""
    import torch

    from taichi_mpm_torch.parallel import comm, sharding, spatial

    s, n = comm.rank(), comm.world()
    out = {}
    zero_counts()
    sim = dense_strip(device)
    local, _ = spatial.shard_spatially(sim.particles, sim.cfg, n, s, slack=2.0)
    frame = spatial.build_spatial_frame(sim.cfg, (), DENSE_STRIP_SUBSTEPS)
    t = np.float32(0.0)
    for _ in range(DENSE_STRIP_FRAMES):
        local, t, dropped = frame(local, t)
    out["strip"] = dict(state=tagged(_gathered(local)), t=float(t), dropped=dropped,
                        local=int(local.active.sum()))
    sim = dense_cube(device)
    p = sharding.shard_particles(sim.particles, n, s)
    p, t = sharding.build_sharded_frame(sim.cfg, tuple(sim.colliders), DENSE_CUBE_SUBSTEPS)(
        p, np.float32(0.0))
    out["cube"] = dict(state=tagged(_gathered(p)), t=float(t))
    out["launches"] = read_counts()
    if timed:
        sim = dense_balls(device)
        cfg, colls = sim.cfg, tuple(sim.colliders)
        for name in ("spatial", "sharded"):
            if name == "spatial":
                q, _ = spatial.shard_spatially(sim.particles, cfg, n, s, slack=2.0)
                one = spatial.build_spatial_frame(cfg, colls, 1)
                step = lambda q, t: one(q, t)[:2]  # noqa: E731
            else:
                q = sharding.shard_particles(sim.particles, n, s)
                step = sharding.build_sharded_frame(cfg, colls, 1)
            q, t = step(q, np.float32(0.0))
            torch.cuda.synchronize()
            comm.all_max(torch.zeros((), device=device))  # the ranks start the clock together
            t0 = time.perf_counter()
            for _ in range(DENSE_SLAB_TIMED_SUBSTEPS):
                q, t = step(q, t)
            torch.cuda.synchronize()
            out[f"balls_{name}"] = dict(
                ms_per_substep=(time.perf_counter() - t0) * 1e3 / DENSE_SLAB_TIMED_SUBSTEPS,
                local=int(q.active.sum()),
                count=int(comm.all_sum(q.active.sum(dtype=torch.int64))))
    return out


def _gathered(p):
    """A rank's particle set gathered over the ranks, in rank order."""
    from taichi_mpm_torch.core.state import Particles
    from taichi_mpm_torch.parallel import comm, spatial

    return Particles(**spatial.from_lane_rows(comm.all_gather_rows(spatial.lane_rows(p)), p))


def phase_dist_dense_check(card):
    """``dist_dense_check``: the two dense slab frames that no driver
    reaches, ``dense_slab_runs``, (a) on one rank over NCCL in this
    process, (b) on two ranks sharing the card over gloo (spawned),
    against the port's dense ``frame_fn`` on the card from the same
    particles: the strip within the frame bounds (x, v, F), the cube
    within tests/test_sharding.py's (x 1e-6, v 1e-5, F 1e-5), whether
    each gives one device's bits, every particle kept, nothing dropped,
    no kernel of the port launched (the dense path has none). Then
    colliding_balls_energy.py at res 100 through both frames on the two
    ranks: ms per substep per rank beside one device's ``frame_fn``. The
    two ranks time-share one H100: this is no scaling number. Returns
    the launches by path."""
    import torch

    from taichi_mpm_torch.core import transfer
    from taichi_mpm_torch.core.solver import frame_fn
    from taichi_mpm_torch.parallel import comm

    failures = []
    t0 = time.perf_counter()
    sim = dense_strip("cuda")
    p, t = sim.particles, np.float32(0.0)
    for _ in range(DENSE_STRIP_FRAMES):
        p, t, _ = frame_fn(p, t, sim.cfg, (), sim.cfg.base_dt, DENSE_STRIP_SUBSTEPS)
    ref = dict(strip=(tagged(p), float(t)))
    sim = dense_cube("cuda")
    xg = transfer.node_positions(sim.cfg, sim.device)
    p, t, _ = frame_fn(sim.particles, np.float32(0.0), sim.cfg, tuple(sim.colliders),
                       sim.cfg.base_dt, DENSE_CUBE_SUBSTEPS, xg)
    ref["cube"] = (tagged(p), float(t))
    sim = dense_balls("cuda")
    p, t, _ = frame_fn(sim.particles, np.float32(0.0), sim.cfg, (), sim.cfg.base_dt, 1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    p, t, _ = frame_fn(p, t, sim.cfg, (), sim.cfg.base_dt, DENSE_SLAB_TIMED_SUBSTEPS)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t1) * 1e3 / DENSE_SLAB_TIMED_SUBSTEPS
    n_balls = sim.particle_count()
    del sim, p
    with comm.process_group("nccl", 0, 1, comm.free_port(), timeout_s=DIST_TIMEOUT_S):
        nccl = dense_slab_runs()
    gloo = ranks_of(dense_slab_runs, 2, args=(DIST_DEVICE, True))
    bounds = dict(strip=DENSE_SLAB_BOUNDS, cube=(("x", 1e-6), ("v", 1e-5), ("F", 1e-5)))
    shown = {}
    for label, res in [("nccl", nccl)] + [(f"gloo rank {r}", g) for r, g in enumerate(gloo)]:
        failures += [f"{label}: {f}" for f in no_launches(res["launches"])]
        for name in ("strip", "cube"):
            want, t_want = ref[name]
            got = res[name]["state"]
            errs = tagged_errors(want, got, f"{label} {name}", failures, bounds[name])
            shown[f"{label} {name}"] = dict(
                errors=errs, bits=all(np.array_equal(want[k], got[k]) for k in want),
                count=len(got["x"]), local=res[name].get("local"))
            if res[name]["t"] != t_want:
                failures.append(f"{label} {name}: t {res[name]['t']} vs {t_want}")
        if res["strip"]["dropped"] or len(res["strip"]["state"]["x"]) != 400:
            failures.append(f"{label} strip: {len(res['strip']['state']['x'])} particles kept")
    balls = {}
    for name in ("spatial", "sharded"):
        balls[name] = [g[f"balls_{name}"] for g in gloo]
        for r, b in enumerate(balls[name]):
            if b["count"] != n_balls:
                failures.append(f"balls {name} rank {r}: {b['count']} particles, not {n_balls}")
    emit(dict(phase="dist_dense_check", card=card, runs=shown, balls_particles=n_balls,
              balls_ms_per_substep=balls, one_device_balls_ms_per_substep=one_ms,
              what="two processes time-sharing one H100, not a scaling number",
              seconds=time.perf_counter() - t0, failures=failures))
    raise_failures(failures)
    return {"dist_dense_check_nccl": nccl["launches"],
            "dist_dense_check_gloo": {k: sum(g["launches"][k] for g in gloo)
                                      for k in nccl["launches"]}}


# -- the remaining scene scripts and the standalone demos -------------------------

# the runner entries of the 3-D scene scripts this section drives, by kind
SCRIPT_KINDS = {
    "async": ("combo", "sand", "slope", "stork"),
    "cpic": ("banana", "bunny_split", "buoyancy", "goo_blocks", "robot", "robot_reversed",
             "sand_stir", "sand_sweep"),
    "plain": ("sand_layers", "colliding_balls_3d_test"),
}
SCRIPT_KIND = {name: kind for kind, names in SCRIPT_KINDS.items() for name in names}
SANDY_SCRIPTS = ("combo", "sand", "robot", "robot_reversed", "sand_stir", "sand_sweep",
                 "sand_layers")  # held at the sand column's bounds, knife edges aside
# scripts_check: the port tests' res and a frame of a few substeps (the async
# scripts' frame at adaptive dt: 47 substeps of the stork, 3-4 of the others)
SCRIPT_CHECK_RES = {"async": 32, "cpic": 48, "plain": 32}
SCRIPT_CHECK_FRAME_DT = {"async": 3e-3, "cpic": 1.5e-4, "plain": 6e-4}
SCRIPT_UNFUSED = ("robot", "sand_layers")  # also on TMT_FUSED=0: p2g_blocked launched
# The knife-edge lanes of resting sand outnumber its plastic events, so the
# gap between the card's and the CPU's events is also held to this share of
# the CPU's (PR 15's card runs: at most 0.045, combo's 27 of 595)
PLAST_GAP_SHARE = 0.1
# scripts_path: each script at its own res, a warm-up frame and a timed frame;
# the 5e-5 s CPIC scripts' frames cut to 20 substeps, the others their 0.01 s
SCRIPT_PATH_CPIC_FRAME_DT = 5e-4  # 10 substeps of the CPIC scripts' 5e-5 s
SCRIPT_PATH_TIMED_FRAMES = 1  # after one warm-up frame
SCRIPT_STAGE_SUBSTEPS = 4  # the CPIC scripts' stage breakdown
DEMO_BOUNDS = (("x", 5e-6), ("v", 5e-5), ("F", 5e-6))  # tests/port/test_torch_demos.py


def script_scene(name, res, device, frame_dt=None, fused=True):
    """The runner entry `name` of ``runner.SCENES`` at `res` on `device`
    (on the route of `fused`), its frame_update, with frame_dt cut to
    `frame_dt` where given."""
    from taichi_mpm_torch import runner

    argv = [name, "--res", str(res)] + (["--cpu"] if device == "cpu" else [])
    args = runner.parse_args(argv, scene=True)
    sim, update = on_route(fused, lambda: runner.SCENES[name](args))
    if frame_dt:
        sim.frame_dt = frame_dt
    return sim, update


def script_frame(name, device, fused=True):
    """scripts_check's frame of the script `name`: its first frame (after
    its frame_update) at the tests' res. Returns the scene."""
    kind = SCRIPT_KIND[name]
    sim, update = script_scene(name, SCRIPT_CHECK_RES[kind], device,
                               SCRIPT_CHECK_FRAME_DT[kind], fused)
    if update is not None:
        update(sim, 0)
    sim.step()
    return sim


def phase_scripts_check():
    """Each of the 14 script entries (``SCRIPT_KINDS``) at the port tests'
    res, one frame of a few substeps, on the card against the CPU (the
    kernels' plain twins): the CPIC scripts at the CPIC bounds (states
    and near_b equal, bodies 1e-5 / 1e-6), the others at the frame
    bounds, the sand scripts at the sand column's (F 2.5e-5, aux 1.5e-5),
    plastic events equal but for sand's knife edges (counted on the CPU
    frame) and apart by at most PLAST_GAP_SHARE of the CPU's, equal sorts and adaptive substeps, a second card run equal
    in bits (bodies too). ``robot`` and ``sand_layers`` also on
    TMT_FUSED=0 (the pytree CPIC frame, the unfused route) against the
    CPU on that route. All four kernels must launch. Returns the
    launches."""
    import torch

    from taichi_mpm_torch import diagnostics

    failures, out = [], {}
    zero_counts()
    runs = [(name, True) for names in SCRIPT_KINDS.values() for name in names]
    runs += [(name, False) for name in SCRIPT_UNFUSED]
    for name, fused in runs:
        label = name if fused else f"{name}_unfused"
        t0 = time.perf_counter()
        card = script_frame(name, "cuda", fused)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counted = read_counts()
        rerun = script_frame(name, "cuda", fused)
        zero_counts()
        for kernel, n in counted.items():  # the rerun's launches are a check's, not the path's
            counters()[kernel].launches = n
        t0 = time.perf_counter()
        with diagnostics.packed_sand_edges_per_substep() as edges, \
                diagnostics.dense_sand_edges_per_substep() as dense_edges:
            cpu = script_frame(name, "cpu", fused)
        cpu_s = time.perf_counter() - t0
        slack = sum(edges) + sum(dense_edges)
        if SCRIPT_KIND[name] == "cpic":
            errs = cpic_errors(card, cpu, f"{label} card vs CPU", failures, plast_slack=slack)
            for field in ("pos", "vel", "rot", "omega"):
                if not np.array_equal(getattr(card.bodies, field).cpu().numpy(),
                                      getattr(rerun.bodies, field).cpu().numpy()):
                    failures.append(f"{label} rerun: body {field} differs")
        else:
            bounds = SAND_COLUMN_BOUNDS if name in SANDY_SCRIPTS else FRAME_BOUNDS
            errs = frame_errors(card, cpu, f"{label} card vs CPU", failures, bounds, slack)
        gap = abs(card.plasticity_counter - cpu.plasticity_counter)
        if not gap <= PLAST_GAP_SHARE * cpu.plasticity_counter:
            failures.append(f"{label} card vs CPU: plastic events {card.plasticity_counter} vs "
                            f"{cpu.plasticity_counter}, more than {PLAST_GAP_SHARE} of the CPU's apart")
        same_bits(card, rerun, f"{label} rerun", failures)
        substeps = [getattr(s, "last_substeps", None) for s in (card, rerun, cpu)]
        if len(set(substeps)) != 1:
            failures.append(f"{label}: substeps {substeps} (card, rerun, CPU)")
        check_domain(card, card.particles.count(), failures)
        out[label] = dict(particles=card.particles.count(), res=card.cfg.res[0],
                          frame_dt=card.frame_dt, adaptive_substeps=substeps[0],
                          errors=errs, plast=card.plasticity_counter,
                          plast_cpu=cpu.plasticity_counter, sand_knife_edges=slack,
                          near_b=int(card.particles.near_b.sum()), card_s=card_s, cpu_s=cpu_s)
    launches = read_counts()
    failures += [f"{kernel} never launched" for kernel in TRANSFER_KERNELS if not launches[kernel]]
    emit(dict(phase="scripts_check", **out, launches=launches, failures=failures))
    raise_failures(failures)
    return launches


def phase_scripts_path(card):
    """Each of the 14 script entries through ``runner.main`` on the card,
    at the script's own res and particle count, every launch count set
    to 0 first: a warm-up frame and SCRIPT_PATH_TIMED_FRAMES timed frames
    (the 5e-5 s CPIC scripts' cut to 5e-4 s, 10 substeps, by --frame-dt).
    Per script: particles, ms per substep over the timed frames (host
    clock around each frame, fenced; the warm-up frame, which pays the
    scene's finalize, first sort and allocations, apart), particle-steps/s,
    host syncs per substep and sorts, substeps, the printed frame lines; for robot, robot_reversed and buoyancy the
    bodies' omega and pos. Every particle finite and in the domain, the
    robots' wheels turning with their steppers' sign, buoyancy's count
    growing; each kernel of a script's route once per substep (p2g_fused
    on every script, g2p_blocked on the CPIC scripts, g2p_fused on the
    others, p2g_blocked never). Then each CPIC script's ``cpic_stage_ms``
    over SCRIPT_STAGE_SUBSTEPS from its state (not counted among the
    path's launches). Returns the launches."""
    import io
    from contextlib import redirect_stdout

    from taichi_mpm_torch import runner
    from taichi_mpm_torch.utils import HostSyncs

    failures, out, cpic_sims = [], {}, {}
    zero_counts()
    for kind, names in SCRIPT_KINDS.items():
        for name in names:
            make, box = runner.SCENES[name], {}

            def entry(args, make=make, box=box):
                sim, update = make(args)
                box["timed"] = Timed(sim)
                box["seeded"] = sum(b["x"].shape[0] for b in sim._pending)
                counts = box["counts"] = []  # each frame's particles, after its update

                def counted(s, f):
                    if update is not None:
                        update(s, f)
                    counts.append(s.particles.count() if s.particles is not None
                                  else sum(b["x"].shape[0] for b in s._pending))

                return box["timed"], counted

            argv = [name, "--frames", str(1 + SCRIPT_PATH_TIMED_FRAMES)]
            if kind == "cpic":
                argv += ["--frame-dt", str(SCRIPT_PATH_CPIC_FRAME_DT)]
            runner.SCENES[name] = entry
            log = io.StringIO()
            syncs0 = HostSyncs.count
            try:
                with redirect_stdout(log):
                    t0 = time.perf_counter()
                    runner.main(argv)
                    wall = time.perf_counter() - t0
            finally:
                runner.SCENES[name] = make
            timed = box["timed"]
            sim = timed.sim
            per_frame = [st["substeps"] or round(sim.frame_dt / sim.cfg.base_dt)
                         for st in timed.steps]
            n = sim.particle_count()
            n_timed = sum(per_frame[1:])
            step_s = sum(timed.ms["step"][1:]) / 1e3
            psteps = sum(c * k for c, k in zip(box["counts"][1:], per_frame[1:]))
            check_domain(sim, n, failures)
            row = dict(particles=n, res=sim.cfg.res[0], frames=len(per_frame),
                       substeps_per_frame=per_frame, timed_substeps=n_timed,
                       ms_per_substep=step_s * 1e3 / n_timed,
                       warmup_frame_ms=timed.ms["step"][0], frame_ms=timed.ms["step"],
                       particle_steps_per_s=psteps / step_s,
                       host_syncs_per_substep=sum(st["host_syncs"] for st in timed.steps[1:])
                       / n_timed, sorts=sim.n_sorts, wall_s=wall,
                       all_host_syncs=HostSyncs.count - syncs0,
                       runner_lines=log.getvalue().splitlines())
            if sim.bodies is not None:
                row.update(omega=sim.bodies.omega.cpu().numpy().tolist(),
                           pos=sim.bodies.pos.cpu().numpy().tolist(),
                           near_b=int(sim.particles.near_b.sum()))
            if name.startswith("robot"):
                spin = [float(sim.bodies.omega[w, 2] - sim.bodies.omega[b, 2])
                        for w, b in (a.obj for a in sim.rigid_scene.articulations)]
                row["wheel_spin"] = spin
                sign = -1 if name == "robot_reversed" else 1
                if not all(np.sign(w) == sign for w in spin):
                    failures.append(f"{name}: the wheels spin {spin}, not with sign {sign}")
            if name == "buoyancy" and not n > box["seeded"]:
                failures.append(f"buoyancy: {n} particles after the jets, {box['seeded']} seeded")
            if not all(f"frame {f:05d}" in row["runner_lines"][f] for f in range(len(per_frame))):
                failures.append(f"{name}: the runner printed {row['runner_lines']}")
            out[name] = row
            if kind == "cpic":
                cpic_sims[name] = sim
    launches = read_counts()
    cpic_substeps = sum(sum(out[name]["substeps_per_frame"]) for name in SCRIPT_KINDS["cpic"])
    substeps = sum(sum(row["substeps_per_frame"]) for row in out.values())
    expected = dict(p2g_fused=substeps, g2p_fused=substeps - cpic_substeps,
                    g2p_blocked=cpic_substeps, p2g_blocked=0, body_totals=0)
    failures += [f"{kernel} launched {n} times on the scripts' path, not {expected[kernel]} "
                 "(once per substep of its route)" for kernel, n in launches.items()
                 if n != expected[kernel]]
    for name, sim in cpic_sims.items():  # after the path's launches are read
        stages, wall = cpic_stage_ms(sim, SCRIPT_STAGE_SUBSTEPS)
        out[name].update(stage_ms=stages, stages_sum_ms=sum(stages.values()),
                         breakdown_wall_ms_per_substep=wall)
    emit(dict(phase="scripts_path", card=card, **out, launches=launches,
              clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"), failures=failures))
    raise_failures(failures)
    return launches


def phase_demo_mpm88():
    """Both standalone demos (``taichi_mpm_torch/demos``), one frame of
    40 substeps from their 8,192 particles on the card and on the CPU:
    x 5e-6, v 5e-5, F 5e-6; a second card frame equal in bits; each
    card frame's ms."""
    import torch

    from taichi_mpm_torch.demos import mls_mpm88, mls_mpm88_explained

    failures, out = [], {}
    for demo in (mls_mpm88, mls_mpm88_explained):
        label = demo.__name__.rsplit(".", 1)[-1]
        frames = {}
        for run, device in (("card", "cuda"), ("rerun", "cuda"), ("cpu", "cpu")):
            state = demo.initial_state(device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(int(demo.frame_dt / demo.dt)):
                state = demo.substep(*state)
            torch.cuda.synchronize()
            frames[run] = ((time.perf_counter() - t0) * 1e3,
                           [a.cpu().numpy() for a in state])
        errs = {}
        for (field, bound), a, b in zip(DEMO_BOUNDS, frames["card"][1], frames["cpu"][1]):
            errs[field] = float(np.abs(a.astype(np.float64) - b).max())
            if not errs[field] <= bound:
                failures.append(f"{label} card vs CPU: {field} differs by {errs[field]} > {bound}")
        if any(a.tobytes() != b.tobytes() for a, b in zip(frames["card"][1], frames["rerun"][1])):
            failures.append(f"{label}: a second card frame differs in bits")
        x = frames["card"][1][0]
        if not np.isfinite(x).all():
            failures.append(f"{label}: positions not finite")
        out[label] = dict(errors=errs, card_ms=frames["card"][0], rerun_ms=frames["rerun"][0],
                          cpu_ms=frames["cpu"][0], y_range=[float(x[:, 1].min()),
                                                            float(x[:, 1].max())])
    emit(dict(phase="demo_mpm88", **out, failures=failures))
    raise_failures(failures)


# The check block's phases (none times anything) in the check lanes, the
# longest first (their seconds in a whole run on a slow host: PERF.md),
# each with its arguments ("card": the card's name) and where its value
# goes: the kernels line's launches of a path, "paths" (a dict of paths),
# "reference" (a CPU reference a timed phase takes) or nothing.
CHECK_PHASES = (
    ("phase_mesh_check", ("card",), "paths"),
    ("phase_dist_check", ("card", "cpic"), "paths"),
    ("phase_materials25", (0, 3), None),
    ("phase_materials25", (1, 3), None),
    ("phase_materials25", (2, 3), None),
    ("phase_emission_check", (), None),
    ("phase_dist_async_check", ("card",), "paths"),
    ("phase_dist_check", ("card", "plain"), "paths"),
    ("phase_bucketed_check", (), None),
    ("phase_dist_dense_check", ("card",), "paths"),
    ("phase_dense_check", (), "dense_check"),
    ("phase_scripts_check", (), "scripts_check"),
    ("dense_path_reference", (), "reference"),
)
# the check block's shorter phases, run here after the warm-ups, each with
# where its value goes (as in CHECK_PHASES)
PARENT_CHECK_PHASES = (
    ("phase_dense_cpic_check", (), "dense_cpic_check"),
    ("phase_wheel_2d_coupled", ("card",), "wheel_2d_coupled"),
    ("phase_cube25", (), None), ("phase_water25", (), None), ("phase_dam_check", (), None),
    ("phase_cpic_check", ("water",), None), ("phase_cpic_check", ("sand",), None),
    ("phase_cpic_unfused_check", (), None), ("phase_sand_column_check", (), None),
    ("phase_dense_vs_blocked", (), None), ("phase_dense_adaptive", (), None),
    ("phase_p2g_edges", (), None), ("phase_g2p_edges", (), None),
    ("phase_body_totals_check", (), None), ("phase_dense_cpic_vs_fused", (), None),
    ("phase_demo_mpm88", (), None),
)


def parent_checks(card, wheel_snapshot, balls):
    """This process's share of the check block: the CPIC wheel's and the
    balls' warm-ups for the timed paths, then PARENT_CHECK_PHASES, with
    the lanes' CPU threads. Returns the warm-ups' records and the phases'
    values in the order of PARENT_CHECK_PHASES."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(LANE_THREADS)
    try:
        warm = cpic_warm_snapshot(wheel_snapshot)
        balls_run = balls_snapshot(balls)
        values = [globals()[name](*(card if a == "card" else a for a in args))
                  for name, args, _ in PARENT_CHECK_PHASES]
    finally:
        torch.set_num_threads(threads)
    return warm, balls_run, values


def main():
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--kernel-tree"]:
        kernel_tree(*sys.argv[2:3])
        return 0
    if sys.argv[1:2] == ["--dense-cpic-tree"]:
        dense_cpic_tree(*sys.argv[2:4])
        return 0
    if sys.argv[1:2] == ["--wheel-snapshot"] and len(sys.argv) == 3:
        emit(dict(phase="wheel_snapshot", **cpic_path_snapshot(sys.argv[2])))
        return 0
    t_start = time.perf_counter()
    # the port itself: fails here when the script stands outside a checkout
    from taichi_mpm_torch.ops import cuda_build

    card = nvidia_smi()
    print(card, flush=True)
    emit(dict(phase="card", card=card, torch=torch.__version__, cuda=torch.version.cuda))
    t0 = time.perf_counter()
    libraries = [(src, mats) for src in ("p2g", "g2p") for mats in LIBRARY_SETS]
    libraries.append(("body_totals", 0))
    per_library = cuda_build.build(*libraries)
    emit(dict(phase="build", seconds=time.perf_counter() - t0, seconds_per_library=per_library,
              ptxas={f"{src}_{mats}": cuda_build.ptxas_report(src, mats)
                     for src, mats in libraries}))
    clock_cpu_frames()
    emit(dict(phase="p2g_checksums", sha256=p2g_checksums()))
    emit(dict(phase="g2p_checksums", sha256=g2p_checksums()))

    # The check block: the phases that time nothing, in check lanes at
    # once, while this process warms the CPIC wheel and the balls for the
    # timed paths; the rank groups of those paths start up meanwhile.
    snapshots = tempfile.TemporaryDirectory(prefix="chip_smoke_snapshots_")
    wheel_snapshot = os.path.join(snapshots.name, "wheel.npz")
    balls = os.path.join(snapshots.name, "balls.npz")
    RANK_GROUPS.update({world: RankGroup(world) for world in (2, 4)})
    t_checks = time.perf_counter()
    tasks = [(name, tuple(card if a == "card" else a for a in args))
             for name, args, _ in CHECK_PHASES]
    values, (warm, balls_run, mine) = check_block(
        tasks, lambda: parent_checks(card, wheel_snapshot, balls))
    checks_s = time.perf_counter() - t_checks
    emit(dict(phase="check_block", seconds=checks_s, lanes=CHECK_LANES,
              lane_threads=LANE_THREADS, cpic_warmup_s=warm["warmup_s"],
              balls_snapshot_s=balls_run[1]))
    launches, refs = {}, {}
    for (name, _, key), value in zip(CHECK_PHASES + PARENT_CHECK_PHASES, values + mine):
        if key == "paths":
            launches.update(value)
        elif key == "reference":
            refs[name] = value
        elif key is not None:
            launches[key] = value

    # The timed block: one phase at a time, alone on the card.
    t_timed = time.perf_counter()
    sim, launches["jelly_8m"], fused_ms = phase_main_path(card)
    phase_profile(sim, card)  # steps one more frame: before the phases that share its state
    phase_breakdown(sim, card)
    measured = phase_kernels(sim, card)
    by_material = phase_material_kernels(sim, card)
    del sim
    sim, launches["jelly_8m_unfused"], _ = phase_main_path(card, fused=False)
    phase_stage_report(sim, card)
    del sim
    launches["sand_8m"] = phase_sand_path(card)
    launches["dam_fused"], dam_ms, lattice = phase_dam(card, fused=True)
    launches["dam_unfused"], _, _ = phase_dam(card, fused=False)
    launches["script_dam"], kept = phase_script_dam(card, lattice)
    phase_script_resume(kept)
    for name, counts in phase_bucketed_path(card, kept["substeps"]).items():
        launches[f"bucketed_{name}"] = counts
    sim, launches["cpic_wheel"], fixed_syncs, cpic_ms = phase_cpic_path(card, warm,
                                                                        wheel_snapshot)
    phase_cpic_breakdown(sim, card)
    phase_profile(sim, card, phase="cpic_profile", substeps=CPIC_PROFILE_SUBSTEPS)
    # the wheel's state with the water on it, for the phases that resume it
    sim.save(wheel_snapshot)
    del sim
    launches["cpic_wheel_unfused"] = phase_cpic_unfused_path(card, wheel_snapshot, cpic_ms)
    launches["cpic_wheel_adaptive"] = phase_cpic_adaptive(card, fixed_syncs)
    launches["dense_balls"] = phase_dense_path(card, refs["dense_path_reference"])
    launches["dense_jelly_8m"] = phase_dense_scale(card, fused_ms)
    launches["wheel_2d"] = phase_wheel_2d_path(card)
    launches["dense_cpic_wheel_100k"], measured["body_totals"] = phase_dense_cpic_scale(
        card, cpic_ms, wheel_snapshot)
    dist_launches, one_8m_ms = phase_dist_path(card)
    launches.update(dist_launches)
    launches.update(phase_slab_cpic_paths(card, wheel_snapshot))
    launches.update(phase_mesh_path(card, one_8m_ms))
    launches.update(phase_mesh_cpic_path(card, wheel_snapshot))
    launches.update(phase_dist_async_path(card, balls, *balls_run))
    snapshots.cleanup()
    launches["scripts_path"] = phase_scripts_path(card)
    for group in RANK_GROUPS.values():
        group.close()
    emit(dict(phase="timing", check_block_s=checks_s, check_lanes=CHECK_LANES,
              timed_block_s=time.perf_counter() - t_timed,
              script_s=time.perf_counter() - t_start))
    emit({"kernels": kernels_line(measured, launches, dam_ms, by_material)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
