"""What the ranks of the slab tests run: functions that
``comm.run_ranks`` spawns on gloo ranks on the CPU. A spawned process
imports this module by name, so it imports the port only (no JAX: the
JAX side of each comparison runs in the test process), and each function
takes numpy inputs and returns numpy results."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from taichi_mpm_torch import convert
from taichi_mpm_torch.core import levelset
from taichi_mpm_torch.ops import blocked
from taichi_mpm_torch.ops.substep import build_page_map_full
from taichi_mpm_torch.parallel import comm
from taichi_mpm_torch.parallel import spatial_blocked as sb
from taichi_mpm_torch.parallel.spatial import migrate
from taichi_mpm_torch.scenes import (crossing_blob, dam_frame, plate_scene, sharding_cube,
                                     spatial_strip, tag_pending)
PM_INTS = ("ids", "n_act", "slot_map", "s_arr", "e_arr", "nbr", "slot_keys")


def _local(arrays, rank, cap):
    """This rank's lanes of a global layout of equal slabs of `cap` lanes."""
    return convert.particles_from_numpy({k: v[rank * cap:(rank + 1) * cap]
                                         for k, v in arrays.items()})


# -- the primitives (tests/port/test_torch_slabs.py) ----------------------------------


def primitives(cases):
    """Each case on this rank: ("migrate", arrays, cap, cfg, bounds or None)
    or ("exchange", arrays, cap, cfg, K, bounds or None, rec). Returns a
    list of numpy results, in order."""
    torch.set_num_threads(1)
    s = comm.rank()
    out = []
    for case in cases:
        if case[0] == "migrate":
            _, arrays, cap, cfg, bounds = case
            p = _local(arrays, s, cap)
            dest = None if bounds is None else sb.dest_from_bounds(p.x, bounds, cfg, 2)
            q, mig = migrate(p, cfg, 2, dest)
            out.append(dict(convert.particles_to_numpy(q), sent=(mig.sent_left, mig.sent_right),
                            arrived=mig.arrived, grown=mig.grown))
            continue
        _, arrays, cap, cfg, K, bounds, rec = case
        slabs = sb.Slabs(cfg, 2, s, None if bounds is None else 1)
        p = _local(arrays, s, cap)
        keys = sb.local_keys(p, slabs.off_cells(bounds), cfg, slabs.lcfg)
        p, keys, _ = blocked.sort_particles_by_keys(p, keys)
        pm = build_page_map_full(keys, slabs.lcfg, K)
        r = torch.as_tensor(rec[s * K:(s + 1) * K].copy())
        r = sb.exchange_boundary_records(r, pm, slabs.lcfg, slabs.width(bounds))
        r = sb.zero_domain_edge_ghosts(r, pm, slabs.lcfg, s)
        res = {k: pm[k].numpy() for k in PM_INTS}
        res.update(keys=keys.numpy(), rec=r.numpy())
        if bounds is not None:
            res["hist"] = sb.col_hist_from_pm(pm, bounds[s], slabs.lcfg, slabs.CB).numpy()
        out.append(res)
    return out


# -- scenes (tests/port/test_torch_distributed.py) ------------------------------------

CROSSING = dict(res=(32, 32, 32), base_delta_t=2e-4, frame_dt=2.4e-3, gravity=(0.0, -10.0, 0.0))


def crossing_scene(cls, n=300, speed=8.0, ls=levelset, **kw):
    """Two jelly blobs across the middle of a res-32 box, the upper one
    moving +x and the lower one -x at `speed`: particles cross a slab
    boundary both ways, and a 12-substep frame re-sorts in its middle
    (drift 0.45 cell after 9 substeps). Each particle's index is tagged
    in params[:, ID_SLOT]. `ls` is the levelset module of `cls`'s
    package."""
    rng = np.random.default_rng(0)

    def blob(y0):
        return np.stack([rng.uniform(0.35, 0.65, n), rng.uniform(y0, y0 + 0.2, n),
                         rng.uniform(0.3, 0.7, n)], -1).astype(np.float32)

    sim = cls(**CROSSING, **kw)
    sim.add_collider(ls.box_domain(lo=(0.1, 0.1, 0.1), hi=(0.9, 0.9, 0.9), friction=0.3))
    sim.add_particles("jelly", pos=blob(0.6), vel=(speed, 0.0, 0.0), density=1000.0, E=1e4,
                      nu=0.3)
    sim.add_particles("jelly", pos=blob(0.2), vel=(-speed, 0.0, 0.0), density=1000.0, E=1e4,
                      nu=0.3)
    tag_pending(sim)
    return sim



def _route(fused):
    os.environ["TMT_FUSED"] = "1" if fused else "0"


def _run(make, frames):
    from taichi_mpm_torch.parallel.driver import DistributedMPM

    sim = make(DistributedMPM)
    for _ in range(frames):
        sim.step()
    st = sim.slab_stats
    return dict(convert.particles_to_numpy(sim._gather()), resorts=st.resorts,
                resort_after=list(st.resort_after), sent=(st.sent_left, st.sent_right), arrived=st.arrived, bounds=list(st.bounds),
                fused=sim.fused, balanced=sim.balanced, count=sim.particle_count())


ROUTES = {"fused_balanced": (True, True), "fused_uniform": (True, False),
          "unfused_uniform": (False, False), "unfused_balanced": (False, True)}


def scenes(snapshot, out_dir):
    """The slice on this rank: the crossing scene one frame on each route;
    a source after the first frame; a one-device snapshot loaded and
    stepped; the runner with SHARDS=2. Returns a dict of numpy results."""
    from taichi_mpm_torch import runner
    from taichi_mpm_torch.parallel.driver import DistributedMPM

    torch.set_num_threads(1)
    res = {}
    for name, (fused, balanced) in ROUTES.items():
        _route(fused)
        res[name] = _run(lambda cls: crossing_scene(cls, balanced=balanced, device="cpu"), 1)
    _route(True)

    sim = crossing_scene(DistributedMPM, n=100, capacity=400, device="cpu")
    sim.step()
    rng = np.random.default_rng(1)
    sim.add_particles("jelly", pos=0.25 + rng.uniform(0, 0.1, (50, 3)).astype(np.float32),
                      density=1000.0, E=1e4, nu=0.3)
    counts = [sim.particle_count()]
    sim.step()
    counts.append(sim.particle_count())
    res["source"] = dict(counts=counts, positions=sim.positions(), velocities=sim.velocities(),
                         energy=sim.energy())

    sim = crossing_scene(DistributedMPM, device="cpu")
    sim.load(snapshot)
    sim.step()
    res["load"] = dict(convert.particles_to_numpy(sim._gather()), t=float(sim.t))
    sim.save(os.path.join(out_dir, "slabs.npz"))
    sim.visualize(os.path.join(out_dir, f"slabs_rank{comm.rank()}.bgeo"))

    os.environ["SHARDS"] = "2"
    try:
        rsim = runner.main(["colliding_balls_energy", "--res", "32", "--frames", "2", "--cpu",
                            "--frame-dt", "1.2e-3", "--out", os.path.join(out_dir, "runner")])
    finally:
        del os.environ["SHARDS"]
    res["runner"] = dict(type=type(rsim).__name__, count=rsim.particle_count(),
                         energy=rsim.energy(), positions=rsim.positions())
    return res


# -- CPIC scenes (tests/port/test_torch_slabs_cpic.py) --------------------------------

CPIC_ROUTES = {"fused_balanced": (True, True), "fused_uniform": (True, False),
               "unfused_uniform": (False, False)}
BODY_FIELDS = ("pos", "vel", "rot", "omega")


def cluster_scene(cls, plate_mesh, **kw):
    """A left cluster pushed through a plate (after
    tests/test_spatial_blocked.py:285-353, whose cluster moves at 2 m/s
    for 18 substeps, too slow to reach its plate or move a bound): 500
    jelly particles in [0.2, 0.4] x [0.35, 0.65]^2 at 20 m/s along x
    through a scripted plate (half size 0.12, normal y) at (0.4, 0.5,
    0.5), which cuts the cluster in two, res (64, 32, 32), gravity -4,
    frames of 6 substeps. The equal-count split moves right, so a
    balanced bound moves (r = 3: within [5, 11] of 16 columns); on
    uniform slabs rank 1 holds nothing at first."""
    rng = np.random.default_rng(5)
    sim = cls(res=(64, 32, 32), base_delta_t=2e-4, frame_dt=12e-4, gravity=(0, -4.0, 0),
              penalty=1e3, **kw)
    n = 500
    x0 = np.empty((n, 3), np.float32)
    x0[:, 0] = rng.uniform(0.2, 0.4, n)
    x0[:, 1] = rng.uniform(0.35, 0.65, n)
    x0[:, 2] = rng.uniform(0.35, 0.65, n)
    sim.add_particles("jelly", pos=x0, vel=(20.0, 0.0, 0.0), E=1e4, nu=0.3, density=1000)
    sim.add_particles("rigid", mesh=plate_mesh(half_u=0.12, half_v=0.12, axis=1),
                      scripted_position=lambda t: (0.4, 0.5, 0.5),
                      scripted_rotation=lambda t: (0.0, 0.0, 0.0), codimensional=True,
                      friction=0.2)
    tag_pending(sim)
    return sim


def island_scene(cls, plate_mesh, **kw):
    """A body inside rank 0's slab: 400 jelly particles in [0.1, 0.75] x
    [0.42, 0.62] x [0.35, 0.65] falling at 1 m/s onto a small plate (half
    size 0.08, normal y, free to turn) at (0.2, 0.4, 0.5), res 32; the
    grid window of rank 1 (x >= 0.375) holds no node of the plate's CDF,
    so its near set is empty while its slab holds particles."""
    rng = np.random.default_rng(7)
    sim = cls(res=(32, 32, 32), base_delta_t=2e-4, frame_dt=12e-4, gravity=(0, -10.0, 0),
              penalty=1e3, **kw)
    pos = (rng.uniform(0.0, 1.0, (400, 3)) * [0.65, 0.2, 0.3] + [0.1, 0.42, 0.35]).astype(
        np.float32)
    sim.add_particles("jelly", pos=pos, vel=(0.0, -1.0, 0.0), E=1e4, nu=0.3, density=1000)
    sim.add_particles("rigid", mesh=plate_mesh(half_u=0.08, half_v=0.08, axis=1),
                      scripted_position=lambda t: (0.2, 0.4, 0.5), codimensional=True,
                      friction=0.2)
    tag_pending(sim)
    return sim


CPIC_SCENES = {"plate_free": (functools.partial(plate_scene, free=True), 2),
               "cluster": (cluster_scene, 3), "island": (island_scene, 2)}


def island_with_source(cls, plate_mesh, frames=2, **kw):
    """island_scene, and after its first frame a source of 60 jelly
    particles above the plate, written into free lanes (on slabs: the
    global set gathered, written and split again); the plate keeps
    turning through it. Returns the scene after `frames` frames."""
    sim = island_scene(cls, plate_mesh, capacity=600, **kw)
    sim.step()
    rng = np.random.default_rng(8)
    pos = (rng.uniform(0.0, 1.0, (60, 3)) * [0.1, 0.05, 0.1] + [0.15, 0.45, 0.45]).astype(
        np.float32)
    sim.add_particles("jelly", pos=pos, vel=(0.0, -1.0, 0.0), E=1e4, nu=0.3, density=1000)
    for _ in range(frames - 1):
        sim.step()
    return sim


def _bodies(sim):
    return {k: getattr(sim.bodies, k).cpu().numpy().copy() for k in BODY_FIELDS}


def _cpic_run(make, frames):
    """make(DistributedMPM) stepped `frames` times on this rank: the
    gathered particles, this rank's bodies after each frame, the slab
    events."""
    from taichi_mpm_torch.parallel.driver import DistributedMPM

    sim = make(DistributedMPM)
    bodies = []
    for _ in range(frames):
        sim.step()
        bodies.append(_bodies(sim))
    st = sim.slab_stats
    return dict(convert.particles_to_numpy(sim._gather()), bodies=bodies, fused=sim.fused,
                balanced=sim.slabs.balanced, sent=(st.sent_left, st.sent_right),
                bounds=list(st.bounds), resorts=st.resorts, n_near=st.n_near,
                n_coarse=st.n_coarse, count=sim.particle_count(), t=float(sim.t))


def _mpm_run(make, fused, frames):
    """The one-device reference: make(MPM) on a route, `frames` frames."""
    from taichi_mpm_torch import MPM

    _route(fused)
    sim = make(MPM)
    for _ in range(frames):
        sim.step()
    return dict(convert.particles_to_numpy(sim.particles), bodies=_bodies(sim))


def _runner_water_wheel(out_dir, shards):
    """scenes.water_wheel through runner.main at res 32, 2 frames of 2e-3
    s (40 substeps; the source emits each frame), on `shards` ranks."""
    from taichi_mpm_torch import runner

    if shards > 1:
        os.environ["SHARDS"] = str(shards)
    try:
        sim = runner.main(["water_wheel", "--res", "32", "--frames", "2", "--cpu",
                           "--frame-dt", "2e-3", "--out", out_dir])
    finally:
        os.environ.pop("SHARDS", None)
    return dict(type=type(sim).__name__, count=sim.particle_count(), bodies=_bodies(sim),
                positions=sim.positions())


def cpic_scenes(out_dir):
    """The CPIC slice on this rank: the plate scene on the default route
    (held to JAX's); each scene of CPIC_SCENES on each slab frame; the
    unfused route's indivisible res[0]; a save after frame 1 resumed by a
    fresh scene; water_wheel through the runner with SHARDS=2; the island
    scene with a source after its first frame; then this
    rank's share of the one-device references (rank r the jobs r, r + 2,
    ...). Returns a dict of numpy results."""
    from taichi_mpm_torch import MPM
    from taichi_mpm_torch.parallel.driver import DistributedMPM
    from taichi_mpm_torch.rigid.mesh import plate_mesh

    torch.set_num_threads(1)
    s = comm.rank()
    res = {}
    _route(True)
    res["jax_plate"] = _cpic_run(lambda cls: plate_scene(cls, plate_mesh, device="cpu"), 1)
    for name, (scene, frames) in CPIC_SCENES.items():
        for route, (fused, balanced) in CPIC_ROUTES.items():
            _route(fused)
            res[f"{name}_{route}"] = _cpic_run(
                lambda cls: scene(cls, plate_mesh, balanced=balanced, device="cpu"), frames)

    _route(False)
    try:
        sim = cluster_scene(lambda **kw: DistributedMPM(**dict(kw, res=(36, 32, 32))),
                            plate_mesh, device="cpu")
        sim.step()
        res["indivisible"] = None
    except ValueError as e:
        res["indivisible"] = str(e)
    _route(True)

    snap = os.path.join(out_dir, "cpic_slabs.npz")
    sim = island_scene(DistributedMPM, plate_mesh, balanced=False, device="cpu")
    sim.step()
    sim.save(snap)
    sim.step()
    resumed = island_scene(DistributedMPM, plate_mesh, balanced=False, capacity=4096,
                           device="cpu")  # the lanes of the ranks' slabs, all of them
    resumed.load(snap)
    resumed.step()
    res["resume"] = dict(
        uninterrupted=dict(convert.particles_to_numpy(sim._gather()), bodies=_bodies(sim)),
        resumed=dict(convert.particles_to_numpy(resumed._gather()), bodies=_bodies(resumed)),
        migrants=(resumed.slab_stats.sent_left, resumed.slab_stats.sent_right,
                  sim.slab_stats.resort_after))
    res["water_wheel"] = _runner_water_wheel(os.path.join(out_dir, "ww_slabs"), 2)
    sim = island_with_source(DistributedMPM, plate_mesh, device="cpu")
    res["island_source"] = dict(count=sim.particle_count(), bodies=_bodies(sim))

    jobs = [(f"{name}_{int(fused)}", scene, fused, frames)
            for name, (scene, frames) in CPIC_SCENES.items() for fused in (True, False)]
    jobs[:0] = [("water_wheel", None, True, 0), ("island_source", island_with_source, True, 0)]
    mpm = {}
    for key, scene, fused, frames in jobs[s::2]:
        if scene is None:
            _route(True)
            mpm[key] = _runner_water_wheel(os.path.join(out_dir, "ww_mpm"), 1)
        elif scene is island_with_source:
            _route(True)
            sim = island_with_source(MPM, plate_mesh, device="cpu")
            mpm[key] = dict(count=sim.particle_count(), bodies=_bodies(sim))
        else:
            mpm[key] = _mpm_run(lambda cls: scene(cls, plate_mesh, device="cpu"), fused, frames)
    _route(True)
    res["mpm"] = mpm
    return res


# -- per-block async on slabs (tests/port/test_torch_async_mpm.py) --------------------

BLOBS = dict(res=(32, 32, 32), base_delta_t=1e-3, frame_dt=6.4e-3, unit_delta_t=1e-4,
             gravity=(0, 0, 0))  # tests/test_adaptive.py::TestPerBlockDriver's scene


def add_blobs(sim):
    """900 soft (E 4e3) and 300 stiff (E 4e5) elastic particles, one blob
    each side of x = 0.5 (either package's scene)."""
    rng = np.random.default_rng(0)
    pos = np.concatenate([
        rng.uniform([0.15, 0.3, 0.3], [0.4, 0.6, 0.6], (900, 3)),
        rng.uniform([0.6, 0.4, 0.4], [0.8, 0.6, 0.6], (300, 3)),
    ]).astype(np.float32)
    sim.add_particles("elastic", pos=pos[:900], E=4e3, nu=0.3)
    sim.add_particles("elastic", pos=pos[900:], E=4e5, nu=0.3)
    return sim




def _set_global(sim, arrays, t=None):
    """Replace a slab scene's particles by the global set `arrays` (the
    same on every rank), split again."""
    sim._ensure_finalized()
    sim._set_particles(convert.particles_from_numpy(arrays))
    sim._shard()
    if t is not None:
        sim.t = np.float32(t)


def owned_levels(sim):
    """The sharded levels of this rank's slab sorted afresh, on the blocks
    it owns: global (bx, by, bz), level, occupied."""
    from taichi_mpm_torch.ops import packed
    from taichi_mpm_torch.parallel import async_spatial

    slabs, s = sim.slabs, comm.rank()
    Wb = slabs.width(None)
    st = packed.pack_particles(sim.particles)
    st, _, pm, _, _ = sb.resort(sb.SlabCarry(st, None, None, 256), slabs, True, sb.SlabStats())
    lev = async_spatial.slot_levels_sharded(st, pm, sim.cfg, slabs.lcfg, sim.bucket_unit(), Wb)
    bx, by, bz, valid = blocked._decode_ids(pm["ids"], slabs.lcfg)
    own = valid & (bx >= 1) & (bx <= Wb)
    block = torch.stack([bx + s * Wb - 1, by, bz], -1)
    return dict(block=block[own].numpy(), lev=lev[own].numpy(),
                occ=(pm["e_arr"] > pm["s_arr"])[own].numpy())


def _async_run(sim, frames=1):
    sim._ensure_finalized()
    n0 = sim.particles.active.sum().item()
    before = sim.update_counter
    for _ in range(frames):
        sim.step()
    fs, ss = sim.last_frame_stats, sim.slab_stats
    return dict(convert.particles_to_numpy(sim._gather()), nup=sim.update_counter - before,
                t=float(sim.t), local_start=n0, count=sim.particle_count(),
                level_hist=fs.level_hist, schedule=fs.schedule, sorts=fs.sorts,
                empty=fs.empty_advances, sent=(ss.sent_left, ss.sent_right), arrived=ss.arrived)


def async_slabs(a0, fast, t_fast):
    """The slice on this rank: ``DistributedAsyncMPM`` over the blobs for two
    frames from the global set `a0`, then one frame from `fast` at
    `t_fast`; the sharded levels of `a0` and of `fast`; the crossing blob
    and the dam one frame each. Returns a dict of numpy results."""
    from taichi_mpm_torch.parallel.driver import DistributedAsyncMPM

    torch.set_num_threads(1)
    sim = add_blobs(DistributedAsyncMPM(**BLOBS, device="cpu"))
    _set_global(sim, a0)
    res = dict(levels=[owned_levels(sim)])
    res["frames"] = [_async_run(sim) for _ in range(2)]
    _set_global(sim, fast, t_fast)
    res["levels"].append(owned_levels(sim))
    _set_global(sim, fast, t_fast)
    res["third"] = _async_run(sim)
    res["crossing"] = _async_run(crossing_blob(DistributedAsyncMPM, "cpu"))
    res["dam"] = _async_run(dam_frame(16, DistributedAsyncMPM, "cpu"))
    return res


# -- the dense slab frames (tests/port/test_torch_slabs_dense.py) ---------------------




def _strip_frames(arrays, frames, slack):
    from taichi_mpm_torch.core.solver import MPM
    from taichi_mpm_torch.parallel import spatial

    sim = spatial_strip(MPM, device="cpu")
    sim._finalize()
    local, _ = spatial.shard_spatially(convert.particles_from_numpy(arrays), sim.cfg, 2,
                                       comm.rank(), slack)
    frame = spatial.build_spatial_frame(sim.cfg, (), 10)
    t, dropped = np.float32(0.0), 0
    for _ in range(frames):
        local, t, d = frame(local, t)
        dropped += d
    return dict(convert.particles_to_numpy(local), t=float(t), dropped=dropped)


def dense_slabs(strip, fast, cube):
    """The dense slab frame on the strip (4 frames of 10 substeps, slack 2)
    and the fast strip (10 frames, slack 3), both from global sets, and
    the data-parallel frame on the cube's lanes `cube` (5 substeps).
    Returns this rank's particles of each, numpy."""
    from taichi_mpm_torch.parallel import sharding

    torch.set_num_threads(1)
    res = dict(strip=_strip_frames(strip, 4, 2.0), fast=_strip_frames(fast, 10, 3.0))
    sim = sharding_cube("cpu")
    sim._finalize(capacity=cube["x"].shape[0])
    p = sharding.shard_particles(convert.particles_from_numpy(cube), 2, comm.rank())
    frame = sharding.build_sharded_frame(sim.cfg, tuple(sim.colliders), 5)
    p, t = frame(p, np.float32(0.0))
    res["cube"] = dict(convert.particles_to_numpy(p), t=float(t))
    return res
