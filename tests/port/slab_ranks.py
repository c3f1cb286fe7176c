"""What the ranks of the slab tests run: functions that
``comm.run_ranks`` spawns on gloo ranks on the CPU. A spawned process
imports this module by name, so it imports the port only (no JAX: the
JAX side of each comparison runs in the test process), and each function
takes numpy inputs and returns numpy results."""

from __future__ import annotations

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

ID_SLOT = 7  # port_helpers.ID_SLOT: each particle's index rides in this params slot
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


def tag_pending(sim):
    """Tag each pending particle's index in params[:, ID_SLOT]."""
    first = 0
    for batch in sim._pending:
        n = batch["x"].shape[0]
        batch["params"][:, ID_SLOT] = np.arange(first, first + n, dtype=np.float32)
        first += n


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
