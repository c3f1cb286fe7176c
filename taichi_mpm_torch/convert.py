"""Carry state across from the JAX package, through numpy only.

An MPM scene has no weights: its parameters are the particle state, the
configuration and the collider specs. Tests build the inputs of both
packages from the same numpy arrays through these functions, so this
module needs no JAX import.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core.state import FIELDS, Particles
from taichi_mpm_torch.ops.rows import NCH

_INT_FIELDS = ("mat", "states")
_BOOL_FIELDS = ("active", "near_b")


def config_from_dict(d: dict) -> SimConfig:
    """SimConfig from a field dict (e.g. dataclasses.asdict of the JAX
    package's SimConfig); sequences become tuples."""
    names = {f.name for f in dataclasses.fields(SimConfig)}
    kw = {k: tuple(v) if isinstance(v, (list, tuple, np.ndarray)) else v
          for k, v in d.items() if k in names}
    return SimConfig(**kw)


def particles_from_numpy(arrays: dict, device="cpu") -> Particles:
    """Particles from a dict of numpy arrays keyed by field name."""
    out = {}
    for name in FIELDS:
        a = np.asarray(arrays[name])
        if name in _INT_FIELDS:
            a = a.astype(np.int32)
        elif name in _BOOL_FIELDS:
            a = a.astype(bool)
        else:
            a = a.astype(np.float32)
        out[name] = torch.as_tensor(np.array(a, order="C"), device=device)
    return Particles(**out)


def particles_to_numpy(p) -> dict:
    """Dict of numpy arrays keyed by field name, from the port's Particles
    or any object with the same field names (the JAX package's)."""
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    return {name: host(getattr(p, name)) for name in FIELDS}


def packed_from_numpy(st, device="cpu") -> torch.Tensor:
    """(NCH, Pw) float32 packed state from a numpy array in either form
    the JAX package carries: (NCH, Pw) or flat (NCH * Pw,)."""
    a = np.asarray(st, np.float32)
    if a.ndim == 1:
        a = a.reshape(NCH, -1)
    if a.ndim != 2 or a.shape[0] != NCH:
        raise ValueError(f"expected ({NCH}, Pw) or flat, got {a.shape}")
    return torch.as_tensor(np.array(a, np.float32, order="C"), device=device)


def bodies_from_numpy(arrays: dict, device="cpu"):
    """The port's RigidBodies from a dict of numpy arrays keyed by field
    name (float32), of either dimension: a 2-D body's rot, omega and
    inertia_inv are (R, 1)."""
    from taichi_mpm_torch.rigid.body import BODY_FIELDS, RigidBodies

    return RigidBodies(**{
        name: torch.as_tensor(np.array(np.asarray(arrays[name]), np.float32), device=device)
        for name in BODY_FIELDS})


def bodies_from_jax(bodies, device="cpu"):
    """The port's RigidBodies from the JAX package's (or any object with
    the same field names holding arrays), through numpy."""
    from taichi_mpm_torch.rigid.body import BODY_FIELDS

    return bodies_from_numpy({name: getattr(bodies, name) for name in BODY_FIELDS}, device)


def snapshot_fields(data, prefix: str, names) -> dict:
    """The arrays `prefix`.<name> of a snapshot (an npz in the format both
    packages write, ``io.checkpoint``) that it holds, by field name. The
    two packages' snapshots share field names, dtypes (float32; int32 mat
    and states; bool active and near_b) and lane order (a snapshot holds
    the particles as the scene reads them, unpacked from the sorted
    carry), so only the capacity can differ: ``grow_rows`` fits it."""
    return {n: np.asarray(data[f"{prefix}.{n}"]) for n in names if f"{prefix}.{n}" in data}


def grow_rows(snap: dict, current: dict, snap_cap: int) -> dict:
    """Snapshot particle arrays fitted to a scene's capacity: an array
    whose leading dimension is the snapshot's capacity `snap_cap` fills
    rows [0, snap_cap) and the scene's own arrays (`current`) keep the
    rows above; any other array is taken as it is (the JAX package's
    ``io.checkpoint._restore``)."""
    out = {}
    for name, a in snap.items():
        cur = current[name]
        if a.shape[0] == snap_cap and snap_cap < cur.shape[0]:
            a = np.concatenate([a.astype(cur.dtype), cur[snap_cap:]], 0)
        out[name] = a
    return out


def scene_from_jax(scene, colliders=(), device="cpu"):
    """The port's CPICScene from the JAX package's: the boundary-particle
    and hull arrays through numpy, the scripted-motion callables as they
    are (they take and return plain numbers), the articulations and the
    collision setup rebuilt from their fields. `colliders` are the port's
    colliders of the scene (the JAX ones hold JAX code)."""
    from taichi_mpm_torch.rigid.articulation import Articulation
    from taichi_mpm_torch.rigid.collision import CollisionConfig
    from taichi_mpm_torch.rigid.scene import SCENE_ARRAYS, CPICScene

    arrays = {}
    for name in SCENE_ARRAYS:
        a = np.asarray(getattr(scene, name))
        a = a.astype(np.int32 if name == "bp_rid" else np.float32)
        arrays[name] = torch.as_tensor(np.array(a, order="C"), device=device)
    arts = tuple(Articulation(**dataclasses.asdict(a)) for a in scene.articulations)
    coll = (None if scene.collision is None
            else CollisionConfig(**dataclasses.asdict(scene.collision)))
    return CPICScene(**arrays, pos_funcs=tuple(scene.pos_funcs),
                     rot_funcs=tuple(scene.rot_funcs), articulations=arts,
                     colliders=tuple(colliders), collision=coll)
