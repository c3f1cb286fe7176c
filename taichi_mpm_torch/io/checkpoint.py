"""Checkpoint / resume: snapshots of the whole simulation state (torch
counterpart of ``taichi_mpm_tpu.io.checkpoint``).

One compressed npz in the JAX package's format: ``p.<field>`` for each
particle field, ``b.<field>`` for each rigid-body field when the scene
has bodies, ``t`` (float32) and ``meta_json`` (the configuration's plain
fields, ``frame_dt``, ``has_bodies``). The field names, dtypes and lane
order are the JAX package's, so each package resumes the other's
snapshots (``convert.snapshot_fields``, ``convert.grow_rows``). Scripted
callables stay in the scene that the user rebuilds; the arrays are
restored into it.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from taichi_mpm_torch import convert
from taichi_mpm_torch.core.state import FIELDS
from taichi_mpm_torch.rigid.body import BODY_FIELDS


def _host(obj, names) -> dict:
    return {n: getattr(obj, n).detach().cpu().numpy() for n in names}


def save_checkpoint(path: str, sim) -> None:
    """Snapshot the particles, the rigid bodies, the time and the
    configuration of `sim` (the reference's action 'save')."""
    arrays = {f"p.{n}": a for n, a in _host(sim.particles, FIELDS).items()}
    if sim.bodies is not None:
        arrays.update({f"b.{n}": a for n, a in _host(sim.bodies, BODY_FIELDS).items()})
    arrays["t"] = np.asarray(sim.t, np.float32)
    meta = dict(
        cfg={k: v for k, v in dataclasses.asdict(sim.cfg).items()
             if isinstance(v, (int, float, bool, str, tuple, list))},
        frame_dt=sim.frame_dt,
        has_bodies=sim.bodies is not None,
    )
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, sim) -> None:
    """Restore a snapshot's arrays into a rebuilt scene `sim` (the
    reference's action 'load'): its colliders, scripted motion and
    articulations come from the scene, the state from the snapshot. A
    snapshot of a larger capacity than the scene's raises; into a larger
    scene it fills the first rows and the rest stay free. The packed
    carry is dropped: the next frame sorts afresh."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta_json"]).decode())
        snap = convert.snapshot_fields(data, "p", FIELDS)
        bodies = convert.snapshot_fields(data, "b", BODY_FIELDS)
        t = np.float32(data["t"])
    snap_cap = snap["x"].shape[0]
    sim._finalize_for_load(snap_cap)
    cap = sim.particles.capacity
    if cap < snap_cap:
        raise ValueError(
            f"scene capacity {cap} is smaller than the checkpoint's {snap_cap}; rebuild "
            "the scene with at least the snapshot capacity")
    current = convert.particles_to_numpy(sim.particles)
    arrays = dict(current, **convert.grow_rows(snap, current, snap_cap))
    p = convert.particles_from_numpy(arrays, device=sim.device)
    if meta["has_bodies"]:
        if sim.bodies is None:
            raise ValueError("the checkpoint has rigid bodies; the scene does not")
        sim.bodies = convert.bodies_from_numpy(
            dict(_host(sim.bodies, BODY_FIELDS), **bodies), device=sim.device)
    mats = np.unique(arrays["mat"][arrays["active"]]).tolist()
    sim.cfg = sim.cfg.with_materials(set(sim.cfg.active_materials) | set(mats))
    sim._set_particles(p)
    sim.t = t
    sim.frame_dt = float(meta["frame_dt"])
