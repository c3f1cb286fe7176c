"""CPIC scene construction: rigid bodies + boundary particles + statics
(torch counterpart of ``taichi_mpm_tpu.rigid.scene``, 2-D and 3-D).

Mesh -> mass/inertia -> recentre -> boundary-particle sampling, all on
the host in numpy (``rigid.mesh``), producing one ``RigidBodies`` and one
``CPICScene`` of tensors on the scene's device. A 2-D body's rotation is
an angle (the scripted and initial rotations in degrees) and its inertia
a scalar; a 2-D scene has no rigid-rigid collision (the reference's 2-D
rigid solver does not detect contacts).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from taichi_mpm_torch.math.quat import quat_from_euler_xyz
from taichi_mpm_torch.rigid import mesh as meshlib
from taichi_mpm_torch.rigid.body import RigidBodies

MAX_RIGIDS = 12  # int32 tag bits, 2 per rigid


@dataclasses.dataclass
class CPICScene:
    """Static CPIC data: boundary particles (body frame) + scene meta."""

    bp_offset: torch.Tensor  # (B, d) offsets from the body centroid
    bp_normal: torch.Tensor  # (B, d) body-frame normals
    bp_elem: torch.Tensor  # (B, d, d) body-frame element vertices
    bp_rid: torch.Tensor  # (B,) int32
    hull_verts: torch.Tensor  # (R, V, d) body-frame hull vertices per rigid
    pos_funcs: Tuple[Optional[Callable], ...] = ()
    rot_funcs: Tuple[Optional[Callable], ...] = ()
    articulations: Tuple = ()
    colliders: Tuple = ()
    collision: object = None  # CollisionConfig | None
    _hull_np: object = dataclasses.field(default=None, repr=False)

    def hull_verts_host(self) -> np.ndarray:
        """hull_verts as a numpy array, for the host-side rigid-rigid
        solve (cached: the hulls are static)."""
        if self._hull_np is None:
            self._hull_np = self.hull_verts.cpu().numpy()
        return self._hull_np


SCENE_ARRAYS = ("bp_offset", "bp_normal", "bp_elem", "bp_rid", "hull_verts")


def _euler_quat(euler_deg) -> np.ndarray:
    """Host-side wxyz quaternion of XYZ Euler angles in degrees, in
    float32 as the JAX package's scene build computes it."""
    e = torch.deg2rad(torch.as_tensor(np.asarray(euler_deg, np.float32)))
    return quat_from_euler_xyz(e).numpy()


class RigidSceneBuilder:
    """Accumulates rigid bodies; emits (RigidBodies, CPICScene).

    Index 0 is the background body (infinite mass) so articulations can
    link to the world."""

    def __init__(self, dim: int, dx: float, rigid_collision: bool = True,
                 rigid_penalty: float = 1e3):
        self.dim = dim
        self.dx = dx
        self.rigid_collision = rigid_collision
        self.rigid_penalty = rigid_penalty
        self.bodies = []
        self.bp = []
        self.pos_funcs = [None]
        self.rot_funcs = [None]
        self.meshes = [None]  # body-frame element soup per rigid (frame output)
        self.articulations = []
        self.bodies.append(dict(
            pos=np.zeros(dim, np.float32), vel=np.zeros(dim, np.float32),
            rot=self._rot_identity(), omega=self._omega_zero(), mass_inv=0.0,
            inertia_inv=self._inertia_zero(), friction=(0.0, 0.0),
            restitution=0.0, rotation_axis=np.zeros(3, np.float32),
            linear_damping=0.0, angular_damping=0.0,
        ))

    def _rot_identity(self):
        if self.dim == 2:
            return np.zeros(1, np.float32)
        q = np.zeros(4, np.float32)
        q[0] = 1.0
        return q

    def _omega_zero(self):
        return np.zeros(1 if self.dim == 2 else 3, np.float32)

    def _inertia_zero(self):
        return np.zeros(1 if self.dim == 2 else (3, 3), np.float32)

    def add_rigid(
        self,
        mesh: np.ndarray,
        density: float = None,
        codimensional: bool = True,
        scale=None,
        initial_position=None,
        initial_velocity=None,
        initial_rotation=None,
        initial_angular_velocity=None,
        scripted_position: Optional[Callable] = None,
        scripted_rotation: Optional[Callable] = None,
        friction: Optional[float] = None,
        friction0: float = 0.0,
        friction1: float = 0.0,
        restitution: float = 0.0,
        rotation_axis=None,
        linear_damping: float = 0.0,
        angular_damping: float = 0.0,
        recenter: bool = True,
        t0: float = 0.0,
    ) -> int:
        """Returns the rigid id (>= 1). Codimensional default density 40,
        solid 400; scripted bodies get infinite mass/inertia; the mesh is
        recentred to its centre of mass. Rotations are Euler angles in
        degrees (one angle in 2-D)."""
        d = self.dim
        rid = len(self.bodies)
        if rid >= MAX_RIGIDS:
            raise ValueError(f"at most {MAX_RIGIDS - 1} rigid bodies")
        elem = np.asarray(mesh, np.float32).copy()
        if scale is not None:
            elem = elem * np.asarray(scale, np.float32)
        if density is None:
            density = 40.0 if codimensional else 400.0

        mass, com, inertia = meshlib.mass_properties(elem, density, codimensional)
        if not recenter:
            if scripted_position is None:
                raise ValueError("recenter=False needs a scripted position")
            com = np.zeros_like(com)
        elem = elem - com

        if scripted_position is not None:
            pos = np.asarray(scripted_position(t0), np.float32)
        else:
            pos = np.asarray(
                initial_position if initial_position is not None else np.zeros(d), np.float32)
        if d == 2:
            ang = (float(scripted_rotation(t0)) if scripted_rotation is not None
                   else float(initial_rotation or 0.0))
            rot = np.asarray([np.deg2rad(ang)], np.float32)
        else:
            euler = (np.asarray(scripted_rotation(t0), np.float32)
                     if scripted_rotation is not None
                     else np.asarray(initial_rotation if initial_rotation is not None
                                     else np.zeros(3), np.float32))
            rot = _euler_quat(euler)

        mass_inv = 0.0 if scripted_position is not None else 1.0 / max(mass, 1e-30)
        if scripted_rotation is not None:
            inertia_inv = self._inertia_zero()
        elif d == 2:
            inertia_inv = np.asarray([1.0 / max(inertia, 1e-30)], np.float32)
        else:
            inertia_inv = np.linalg.inv(inertia + 1e-12 * np.eye(3)).astype(np.float32)
        if friction is not None:
            friction0 = friction1 = friction
        vel = np.asarray(initial_velocity if initial_velocity is not None else np.zeros(d),
                         np.float32)
        omega = (np.atleast_1d(np.asarray(initial_angular_velocity, np.float32))
                 if initial_angular_velocity is not None else self._omega_zero())

        self.bodies.append(dict(
            pos=pos, vel=vel, rot=rot, omega=omega, mass_inv=mass_inv,
            inertia_inv=inertia_inv, friction=(friction0, friction1),
            restitution=restitution,
            rotation_axis=np.asarray(rotation_axis if rotation_axis is not None
                                     else np.zeros(3), np.float32),
            linear_damping=linear_damping, angular_damping=angular_damping,
        ))
        self.pos_funcs.append(scripted_position)
        self.rot_funcs.append(scripted_rotation)

        self.meshes.append(elem)
        bpos, bnrm, eidx = meshlib.sample_boundary_particles(elem, self.dx)
        self.bp.append(dict(offset=bpos, normal=bnrm, elem=elem[eidx],
                            rid=np.full(len(bpos), rid, np.int32)))
        return rid

    def add_articulation(self, kind: str, obj0: int, obj1: int = 0, **kw):
        from taichi_mpm_torch.rigid.articulation import build_articulation

        bodies_np = {"pos": np.stack([b["pos"] for b in self.bodies]),
                     "rot": np.stack([b["rot"] for b in self.bodies])}
        self.articulations.append(
            build_articulation(kind, obj0, obj1, bodies_np, self.dim, **kw))

    @property
    def num(self) -> int:
        return len(self.bodies)

    def build(self, colliders=(), device="cpu") -> Tuple[RigidBodies, CPICScene]:
        from taichi_mpm_torch.rigid.collision import CollisionConfig, hull_vertices

        def t(a, dtype=np.float32):
            return torch.as_tensor(np.asarray(a, dtype), device=device)

        def stack(key):
            return t(np.stack([np.asarray(b[key], np.float32) for b in self.bodies]))

        bodies = RigidBodies(
            pos=stack("pos"), vel=stack("vel"), rot=stack("rot"), omega=stack("omega"),
            mass_inv=t([b["mass_inv"] for b in self.bodies]),
            inertia_inv=stack("inertia_inv"),
            friction=t([b["friction"] for b in self.bodies]),
            restitution=t([b["restitution"] for b in self.bodies]),
            rotation_axis=stack("rotation_axis"),
            linear_damping=t([b["linear_damping"] for b in self.bodies]),
            angular_damping=t([b["angular_damping"] for b in self.bodies]),
        )
        if not self.bp:
            raise ValueError("no rigid bodies with boundary particles")

        # rigid-rigid collision pairs (3-D only): every pair of
        # non-background bodies unless both are fully scripted (position
        # and rotation)
        scripted = tuple(self.pos_funcs[i] is not None and self.rot_funcs[i] is not None
                         for i in range(self.num))
        pairs = []
        if self.dim == 3 and self.rigid_collision:
            pairs = [(i, j) for i in range(1, self.num) for j in range(i + 1, self.num)
                     if not (scripted[i] and scripted[j])]
        collision = (CollisionConfig(pairs=tuple(pairs), penalty=self.rigid_penalty)
                     if pairs else None)
        elems = [np.zeros((1, self.dim, self.dim), np.float32)] + [b["elem"] for b in self.bp]
        scene = CPICScene(
            bp_offset=t(np.concatenate([b["offset"] for b in self.bp])),
            bp_normal=t(np.concatenate([b["normal"] for b in self.bp])),
            bp_elem=t(np.concatenate([b["elem"] for b in self.bp])),
            bp_rid=t(np.concatenate([b["rid"] for b in self.bp]), np.int32),
            hull_verts=t(hull_vertices(elems, self.dim)),
            pos_funcs=tuple(self.pos_funcs),
            rot_funcs=tuple(self.rot_funcs),
            articulations=tuple(self.articulations),
            colliders=tuple(colliders),
            collision=collision,
        )
        return bodies, scene
