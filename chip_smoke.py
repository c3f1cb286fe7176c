#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``taichi_mpm_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. ``card``: the card's name and power limit (nvidia-smi), then ``build``:
   both CUDA kernels compiled from ``taichi_mpm_torch/csrc`` (one nvcc per
   source, started together).
2. ``cube25``: ``benchmark_cube(cells=25)`` (125k jelly particles), one
   frame of 6 substeps on the card and the same frame on the CPU (the
   kernels' plain twins), held to x 5e-6, v 5e-5, F 5e-6, C 5e-4, aux 5e-6
   with equal sort and plasticity counts; a second card frame must give
   the same bits (the path is deterministic). Then each kernel against
   its plain PyTorch version on the same CUDA inputs: that state stirred
   (see ``stirred``) so that C and F - I are far from 0. P2G records to
   1e-5 x max|record| and bit-identical over two launches (the kernel is
   deterministic); G2P rows to x 5e-6, v 5e-5, F 5e-6, C 5e-4 and
   1e-3 x max|C|, the other rows exactly, vmax to 1e-5 relative, the
   plasticity count exactly; max|v|, max|F - I| and max|C| are printed
   beside the errors.
3. ``main_path``: ``benchmark_cube(cells=100, res=125)``, the 8M-particle
   jelly cube, with frame_dt = 20 base_dt: every launch count set to 0, one
   warm-up frame and 15 timed frames (host clock, fenced by
   torch.cuda.synchronize), the counts read right after. Each kernel must
   have launched once per substep; all 8,000,000 particles must stay
   active, with finite positions inside [0, res dx].
4. ``breakdown``: CUDA-event times of each stage of a substep at 8M;
   ``profile``: one more frame under torch.profiler, the device's busy
   time against the frame's wall time (the idle share) and the kernels
   that take the most of it.
5. ``kernel_checks``: the checks of phase 2 on the 8M state, stirred;
   then the ``kernels`` line: per kernel its launches on the main path,
   its CUDA-event time at the 8M shapes, its plain version's time, its
   max abs error against the plain version there (from
   ``kernel_checks``), and its bound (bytes over 3.35 TB/s or float32
   operations over 67 TFLOP/s, the larger; the halo tiles and windows
   counted for the live slots only, as no other slot is read).

Then the card's name and power limit once more, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero; without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
N_TIMED_FRAMES = 15
SUBSTEPS_PER_FRAME = 20

# float32 operations per particle, counted from the kernels' formulas (an
# FMA is 2): see the notes in taichi_mpm_torch/csrc/p2g.cu and g2p.cu.
P2G_OPS_PREP = 6 * 115 + 146 + 135  # polar Newton (6 iterations), force + A, weights
P2G_OPS_SCATTER = 27 * 31  # 27 support nodes: weight, offset, 3 + 1 channel FMAs
G2P_OPS_GATHER = 6 + 54 + 27 * 29  # position, weights, 27 nodes: v and B FMAs
G2P_OPS_FINISH = 150  # damping, cdg, F <- cdg F, advection, checks
P2G_ROWS_READ = 32  # act, x, v, F, C, mass, vol, mu, lambda, origin
G2P_ROWS_READ, G2P_ROWS_WRITTEN = 15, 24  # x, origin, F (+ key) / x, v, F, C


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


ROW_BOUNDS = (("x", 0, 3, 5e-6), ("v", 3, 3, 5e-5), ("F", 6, 9, 5e-6), ("C", 15, 9, 5e-4))
C_REL = 1e-3  # G2P's C is also held to this share of max|C|
SPIN = 50.0  # rad/s, the stirred state's spin


def stirred(st, seed=0):
    """A copy of the sorted state `st` on which both kernels meet values
    far from rest: every particle spins at SPIN rad/s about a tilted axis
    through the particles' centre (on top of its own v), F gets N(0, 0.05)
    and C N(0, 0.01) noise. A falling cube keeps C near 0 and F near I,
    where a wrong C or F could pass an absolute bound. Positions and
    everything else stay, so the page map still holds."""
    import torch

    from taichi_mpm_torch.ops.rows import RACT, RC, RF, RV, RX

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
    return out


def compare_kernels(sim, st, failures):
    """Each kernel against its plain version on the same CUDA inputs: the
    sorted state `st` on the page map of `sim`. Returns the errors and the
    scales of what G2P wrote; a broken bound is appended to `failures`."""
    import torch

    from taichi_mpm_torch.ops import blocked, g2p, p2g
    from taichi_mpm_torch.ops.rows import RACT, RC, RF, RV
    from taichi_mpm_torch.ops.substep import grid_update_flat

    cfg, dt = sim.cfg, sim.cfg.base_dt
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

    vrec = grid_update_flat(rec, pm["ids"], cfg, tuple(sim.colliders), sim.t, dt)
    win = blocked.windows(vrec, pm["nbr"])
    st_k, st_p = st.clone(), st.clone()
    vmax, plast = g2p.g2p_fused(pm["slot_keys"], st_k, win, dt, cfg)
    vmax_p, plast_p = g2p.g2p_fused_plain(pm["slot_keys"], st_p, win, dt, cfg)
    torch.cuda.synchronize()
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
    if not torch.equal(st_k[24:].view(torch.int32), st_p[24:].view(torch.int32)):
        failures.append("G2P changed rows it must leave alone")
    vk, vp = float(vmax), float(vmax_p)
    if not abs(vk - vp) <= 1e-5 * vp:
        failures.append(f"vmax {vk} vs plain {vp}")
    if int(plast) != int(plast_p):
        failures.append(f"plasticity count {int(plast)} vs plain {int(plast_p)}")
    return dict(p2g_max_abs_err=p2g_err, p2g_record_scale=scale,
                g2p_max_abs_err=max(errs.values()), g2p_row_err=errs, g2p_scale=g2p_scale,
                vmax=vk, vmax_plain=vp, plast=int(plast))


def cube(cells, device, substeps):
    from taichi_mpm_torch import scenes

    sim = scenes.benchmark_cube(cells=cells, res=125, material="jelly", E=2e4,
                                nu=0.35, device=device)
    sim.frame_dt = substeps * sim.cfg.base_dt
    return sim


def phase_cube25():
    """One 6-substep frame on the card and on the CPU, then the kernels
    against their plain versions at the card's state."""
    from taichi_mpm_torch import convert

    sims = {dev: cube(25, dev, 6) for dev in ("cuda", "cpu")}
    rerun = cube(25, "cuda", 6)
    for sim in (*sims.values(), rerun):
        sim.step()
    g, c = (sims[d].particles for d in ("cuda", "cpu"))
    failures = []
    first = convert.particles_to_numpy(g)
    for name, arr in convert.particles_to_numpy(rerun.particles).items():
        if arr.tobytes() != first[name].tobytes():
            failures.append(f"the card's frame is not deterministic: {name} differs on a rerun")
    act = c.active.numpy()
    if not np.array_equal(g.active.cpu().numpy(), act):
        failures.append("card and CPU frames keep other particles")
    act &= g.active.cpu().numpy()
    errs = {}
    for name, bound in (("x", 5e-6), ("v", 5e-5), ("F", 5e-6), ("C", 5e-4), ("aux", 5e-6)):
        a = getattr(g, name).cpu().numpy()[act].astype(np.float64)
        b = getattr(c, name).numpy()[act].astype(np.float64)
        errs[name] = float(np.abs(a - b).max())
        if not errs[name] <= bound:
            failures.append(f"card vs CPU frame: {name} differs by {errs[name]} > {bound}")
    gs, cs = sims["cuda"], sims["cpu"]
    if (gs.n_sorts, gs.plasticity_counter) != (cs.n_sorts, cs.plasticity_counter):
        failures.append("card and CPU frames count other sorts or plastic events")
    out = dict(phase="cube25", particles=int(act.sum()), K=gs.block_capacity,
               frame_vs_cpu=errs, n_sorts=gs.n_sorts)
    out.update(compare_kernels(gs, stirred(gs.packed_carry[0]), failures))
    emit(dict(out, failures=failures))
    raise_failures(failures)


def phase_main_path(card):
    """The 8M-particle jelly cube: warm-up frame, timed frames, checks."""
    import torch

    from taichi_mpm_torch.ops import g2p, p2g

    t0 = time.perf_counter()
    sim = cube(100, "cuda", SUBSTEPS_PER_FRAME)
    sim._ensure_finalized()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    p2g.stats.launches = g2p.stats.launches = 0
    t0 = time.perf_counter()
    sim.step()  # warm-up: pack, first sort, page map
    sim.sync()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(N_TIMED_FRAMES):
        sim.step()
    sim.sync()
    timed_s = time.perf_counter() - t0
    launches = {"p2g_fused": p2g.stats.launches, "g2p_fused": g2p.stats.launches}

    substeps = (1 + N_TIMED_FRAMES) * SUBSTEPS_PER_FRAME
    failures = [f"{name} launched {n} times in {substeps} substeps"
                for name, n in launches.items() if n != substeps]
    p = sim.particles
    n_active = int(p.active.sum())
    if n_active != 8_000_000:
        failures.append(f"{n_active} particles active, not 8,000,000")
    x = p.x[p.active]
    hi = sim.cfg.res[0] * sim.cfg.dx
    if not (bool(torch.isfinite(x).all()) and float(x.min()) >= 0.0 and float(x.max()) <= hi):
        failures.append("positions not finite or outside the domain")

    n_timed = N_TIMED_FRAMES * SUBSTEPS_PER_FRAME
    emit(dict(
        phase="main_path", card=card, particles=n_active, K=sim.block_capacity,
        substeps=substeps, timed_substeps=n_timed, ms_per_substep=timed_s * 1e3 / n_timed,
        particle_steps_per_s=n_active * n_timed / timed_s, n_sorts=sim.n_sorts,
        warmup_frame_s=warm_s, setup_s=setup_s,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        y_min=float(x[:, 1].min()), launches=launches,
        clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit"), failures=failures,
    ))
    raise_failures(failures)
    return sim, launches


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


def phase_profile(sim, card):
    """One frame (20 substeps) under torch.profiler: the device's busy
    time (the sum of its kernels' and copies' times) over the frame's
    wall time, and the kernels that take the most of it."""
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
        phase="profile", card=card, frame_wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=(1.0 - busy_ms / wall_ms) if busy_ms > 0 else None,
        top_ms_per_frame=top,
    ))


def phase_kernels(sim, launches, card):
    """Each kernel at the 8M shapes: its time, its plain version's time,
    its error against the plain version (on the state stirred), and its
    bound."""
    import torch

    from taichi_mpm_torch.ops import blocked, g2p, p2g
    from taichi_mpm_torch.ops.substep import grid_update_flat

    cfg, dt = sim.cfg, sim.cfg.base_dt
    st, _, pm, _ = sim.packed_carry
    K = pm["ids"].shape[0]
    n_live = min(int(pm["n_act"]), K)  # slots whose tiles and windows are read
    pw = st.shape[1]
    n_in = int((pm["e_arr"] - pm["s_arr"]).sum())  # particles in slot ranges
    n_act = int((st[36] > 0.5).sum())

    rec = blocked.merge_tiles(p2g.p2g_fused(pm["s_arr"], pm["e_arr"], st, dt, cfg), pm["nbr"])
    win = blocked.windows(
        grid_update_flat(rec, pm["ids"], cfg, tuple(sim.colliders), sim.t, dt), pm["nbr"])
    scratch = st.clone()
    p2g_ms = cuda_ms(lambda: p2g.p2g_fused(pm["s_arr"], pm["e_arr"], st, dt, cfg), 10)
    p2g_plain_ms = cuda_ms(lambda: p2g.p2g_fused_plain(pm["s_arr"], pm["e_arr"], st, dt, cfg), 3)
    g2p_ms = cuda_ms(lambda: g2p.g2p_fused(pm["slot_keys"], scratch, win, dt, cfg), 10)
    g2p_plain_ms = cuda_ms(lambda: g2p.g2p_fused_plain(pm["slot_keys"], scratch, win, dt, cfg), 3)
    del rec, win, scratch

    failures = []
    checks = compare_kernels(sim, stirred(st), failures)
    emit(dict(phase="kernel_checks", card=card, particles=n_act, **checks, failures=failures))
    raise_failures(failures)
    torch.cuda.synchronize()

    p2g_bytes = 4 * (P2G_ROWS_READ * n_in + 2 * K + n_live * 343 * 4)
    p2g_ops = (P2G_OPS_PREP + P2G_OPS_SCATTER) * n_in
    g2p_bytes = 4 * (pw + (G2P_ROWS_READ + 1 + G2P_ROWS_WRITTEN) * n_act + n_live * 3 * 343)
    g2p_ops = (G2P_OPS_GATHER + G2P_OPS_FINISH) * n_act

    def entry(name, source, replaces, ms, plain_ms, err, nbytes, ops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=None, bytes=nbytes, ops=ops, live_slots=n_live, slots=K)

    return [
        entry("p2g_fused", "taichi_mpm_torch/csrc/p2g.cu",
              "taichi_mpm_tpu/ops/fused_pallas.py:301", p2g_ms, p2g_plain_ms,
              checks["p2g_max_abs_err"], p2g_bytes, p2g_ops),
        entry("g2p_fused", "taichi_mpm_torch/csrc/g2p.cu",
              "taichi_mpm_tpu/ops/fused_pallas.py:377", g2p_ms, g2p_plain_ms,
              checks["g2p_max_abs_err"], g2p_bytes, g2p_ops),
    ]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    # the port itself: fails here when the script stands outside a checkout
    from taichi_mpm_torch.ops import cuda_build

    card = nvidia_smi()
    print(card, flush=True)
    emit(dict(phase="card", card=card, torch=torch.__version__, cuda=torch.version.cuda))
    t0 = time.perf_counter()
    cuda_build.build("p2g", "g2p")
    emit(dict(phase="build", seconds=time.perf_counter() - t0))

    phase_cube25()
    sim, launches = phase_main_path(card)
    phase_profile(sim, card)  # steps one more frame: before the phases that share its state
    phase_breakdown(sim, card)
    emit({"kernels": phase_kernels(sim, launches, card)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
