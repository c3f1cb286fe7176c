"""What the ranks of the pencil tests run (tests/port/test_torch_pencils.py):
one function, ``pencils``, that ``comm.run_ranks`` spawns on four gloo
ranks on the CPU, a (2, 2) mesh. A spawned process imports this module
by name, so it imports the port only (no JAX: the JAX side of each
comparison runs in the test process); it takes numpy inputs and returns
numpy results."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from slab_ranks import BODY_FIELDS, CPIC_ROUTES, ROUTES, _route
from taichi_mpm_torch import convert
from taichi_mpm_torch.ops import blocked
from taichi_mpm_torch.ops.substep import build_page_map_full
from taichi_mpm_torch.parallel import comm
from taichi_mpm_torch.parallel import spatial_blocked as sb
from taichi_mpm_torch.parallel import spatial_mesh2d as sm
from taichi_mpm_torch.scenes import (corner_cluster, corner_crossing, diagonal_pair, driver_jelly,
                                     pencil_drift, plate_scene)

MESH = (2, 2)
JAX_FRAMES = 2  # tests/test_distributed_driver.py:126's
DRIFT_FRAMES = 3
CLUSTER_FRAMES = 3  # tests/test_spatial_mesh2d.py:172's
CPIC_FRAMES = 2
CROSSING_FRAMES = 2
CLUSTER_ROUTES = {"fused_balanced": (True, True), "unfused_balanced": (False, True)}
# the plate across the corner of the four uniform pencils, off the node
# plane y = 0.5, where the pencils' shifted frame would round a node to
# either side of it
CORNER = (0.5, 0.49, 0.5)


def stats_of(sim):
    """A pencil run's events on this rank."""
    st = sim.slab_stats
    return dict(sent_x=(st.sent_left, st.sent_right), sent_y=(st.sent_low_y, st.sent_high_y),
                diagonal=int(st.diagonal), arrived=st.arrived, grown=st.grown,
                resorts=st.resorts, resort_after=list(st.resort_after), bounds=list(st.bounds),
                n_near=st.n_near)


def run(make, frames):
    """make(DistributedMPM) on the (2, 2) mesh, `frames` frames: the
    gathered particles, this rank's particles at the start and bodies
    after each frame (with bodies), its events, and what the driver
    chose."""
    from taichi_mpm_torch.parallel.driver import DistributedMPM

    sim = make(functools.partial(DistributedMPM, mesh_shape=MESH, device="cpu"))
    sim._ensure_finalized()
    local_start = int(sim.particles.active.sum())
    bodies = []
    for _ in range(frames):
        sim.step()
        if sim.bodies is not None:
            bodies.append({k: getattr(sim.bodies, k).numpy().copy() for k in BODY_FIELDS})
    return dict(convert.particles_to_numpy(sim._gather()), **stats_of(sim), bodies=bodies,
                fused=sim.fused, balanced=sim.balanced, rx=sim.rx, ry=sim.ry,
                count=sim.particle_count(), t=float(sim.t), local_start=local_start)


def mpm_run(make, fused, frames):
    """The one-device reference: make(MPM) on a route, `frames` frames."""
    from taichi_mpm_torch import MPM

    _route(fused)
    sim = make(functools.partial(MPM, device="cpu"))
    for _ in range(frames):
        sim.step()
    out = convert.particles_to_numpy(sim.particles)
    if sim.bodies is not None:
        out["bodies"] = {k: getattr(sim.bodies, k).numpy().copy() for k in BODY_FIELDS}
    return out


# -- the primitives -------------------------------------------------------------------


def exchange(arrays, cfg, seed):
    """The record exchange on this rank's uniform pencil of the global
    set `arrays`: each live block's records set to values drawn for
    (this rank, its global block), then exchanged. Returns the live
    blocks' global ids (gbx, gby, bz), their records before and after."""
    s = comm.rank()
    pen = sm.Pencils(cfg, MESH, s)
    p, _ = sm.shard_pencils(convert.particles_from_numpy(arrays), cfg, MESH, s, 2.0)
    keys = sb.local_keys(p, pen.off_cells(None), cfg, pen.lcfg)
    p, keys, _ = blocked.sort_particles_by_keys(p, keys)
    pm = build_page_map_full(keys, pen.lcfg, 512)
    n = int(pm["n_act"])
    bx, by, bz, _ = blocked._decode_ids(pm["ids"][:n], pen.lcfg)
    Wbx, Wby = pen.width(None)
    gblock = torch.stack([bx - 1 + pen.sx * Wbx, by - 1 + pen.sy * Wby, bz], -1).numpy()
    nbz = blocked.num_blocks_padded(cfg)[2]
    table = np.random.default_rng(seed + s).uniform(
        0.5, 1.5, (cfg.res[0] // 4 + 3, cfg.res[1] // 4 + 3, nbz, 256))
    rec = torch.zeros((pm["ids"].shape[0], 256), dtype=torch.float32)
    rec[:n] = torch.as_tensor(table[gblock[:, 0] + 1, gblock[:, 1] + 1, gblock[:, 2]],
                              dtype=torch.float32)
    before = rec[:n].numpy().copy()
    after = pen.exchange(rec, pm, None)[:n].numpy()
    return dict(block=gblock, before=before, after=after)


def migration(arrays, caps, cfg):
    """One re-sort's migration on this rank: its lanes of `arrays` (the
    ranks' parts of `caps` lanes, one after another) moved to their
    uniform pencils. Returns the particles after, and the counts."""
    s = comm.rank()
    first = sum(caps[:s])
    p = convert.particles_from_numpy({k: v[first:first + caps[s]] for k, v in arrays.items()})
    st = sb.SlabStats()
    p = sm.Pencils(cfg, MESH, s).migrate(p, None, st)
    return dict(convert.particles_to_numpy(p), sent_x=(st.sent_left, st.sent_right),
                sent_y=(st.sent_low_y, st.sent_high_y), diagonal=int(st.diagonal),
                arrived=st.arrived, grown=st.grown)


# -- the slice -------------------------------------------------------------------------


def _jobs():
    """The one-device references, (key, scene, route, frames): each rank
    runs its share."""
    from taichi_mpm_torch.rigid.mesh import plate_mesh

    plate = functools.partial(plate_scene, plate_mesh=plate_mesh, free=True)
    jobs = [(f"drift_{int(f)}", pencil_drift, f, DRIFT_FRAMES) for f in (True, False)]
    jobs += [(f"cluster_{int(f)}", corner_cluster, f, CLUSTER_FRAMES) for f in (True, False)]
    jobs += [("crossing_1", corner_crossing, True, CROSSING_FRAMES),
             ("pair_1", diagonal_pair, True, 1)]
    jobs += [(f"plate_{int(f)}", plate, f, CPIC_FRAMES) for f in (True, False)]
    return jobs + [("corner_plate_1", functools.partial(plate, center=CORNER), True, CPIC_FRAMES)]


def pencils(primitives, snapshot, out_dir):
    """The pencil slice on this rank of a (2, 2) gloo group: the
    primitives (`primitives`: the exchange's and the migration's
    inputs); driver_jelly on the default route (held to JAX's); each
    plain route on pencil_drift; corner_crossing and diagonal_pair on
    uniform fused pencils; the balanced routes on corner_cluster;
    each CPIC pencil frame on the free plate, and the refused one; the
    plate across the four uniform pencils' corner on the fused route; a
    one-device snapshot (`snapshot`, driver_jelly after a frame) loaded
    and stepped, and this run's own snapshot saved in `out_dir`; the
    mesh choices; then this rank's share of the one-device references.
    Returns a dict of numpy results."""
    from taichi_mpm_torch.parallel.driver import DistributedMPM
    from taichi_mpm_torch.rigid.mesh import plate_mesh

    torch.set_num_threads(1)
    s = comm.rank()
    res = dict(exchange=exchange(*primitives["exchange"]),
               migration=migration(*primitives["migration"]))
    _route(True)
    res["jax"] = run(driver_jelly, JAX_FRAMES)
    for name, (fused, balanced) in ROUTES.items():
        _route(fused)
        res[f"drift_{name}"] = run(functools.partial(pencil_drift, balanced=balanced),
                                   DRIFT_FRAMES)
    res["crossing"] = run(functools.partial(corner_crossing, balanced=False), CROSSING_FRAMES)
    res["pair"] = run(functools.partial(diagonal_pair, balanced=False), 1)
    for name, (fused, balanced) in CLUSTER_ROUTES.items():
        _route(fused)
        res[f"cluster_{name}"] = run(corner_cluster, CLUSTER_FRAMES)
    plate = functools.partial(plate_scene, plate_mesh=plate_mesh, free=True)
    for name, (fused, balanced) in CPIC_ROUTES.items():
        _route(fused)
        res[f"plate_{name}"] = run(functools.partial(plate, balanced=balanced), CPIC_FRAMES)
    res["corner_plate"] = run(functools.partial(plate, center=CORNER, balanced=False),
                              CPIC_FRAMES)
    _route(False)
    try:
        run(plate, 1)
        res["refused"] = None
    except ValueError as e:
        res["refused"] = str(e)

    _route(True)
    sim = driver_jelly(DistributedMPM, mesh_shape=MESH, device="cpu")
    sim.load(snapshot)
    sim.step()
    res["load"] = dict(convert.particles_to_numpy(sim._gather()), t=float(sim.t))
    sim.save(os.path.join(out_dir, "pencils.npz"))

    choices = {}
    for key, kw in {"r5": dict(r=5), "res24": dict(res=(24, 24, 32)),
                    "uniform": dict(balanced=False), "res36": dict(res=(36, 32, 32)),
                    "res36_uniform": dict(res=(36, 32, 32), balanced=False)}.items():
        try:
            sim = DistributedMPM(**dict(dict(res=(32, 32, 32), device="cpu", mesh_shape=MESH),
                                        **kw))
            choices[key] = (sim.mesh2d, sim.balanced, sim.rx, sim.ry)
        except ValueError as e:
            choices[key] = str(e)
    res["choices"] = choices

    res["mpm"] = {key: mpm_run(scene, fused, frames)
                  for key, scene, fused, frames in _jobs()[s::4]}
    _route(True)
    return res
