"""MPM scene driver: the user-facing API on the blocked fixed-dt path
(torch counterpart of ``taichi_mpm_tpu.core.solver.MPM``).

``MPM(res=...)``, then ``add_particles`` (materials, or ``"rigid"`` with a
mesh for a CPIC rigid body), ``add_articulation``, ``add_collider`` and
``step()``. Without rigid bodies every frame runs
``ops.packed.packed_frame_carry``: the fused P2G and G2P kernels on the
card, with a lazy re-sort; with ``TMT_FUSED=0`` in the environment (read
at construction, as in the JAX package) the unfused route instead: the
operand prep in torch, the P2G kernel on it, the gather-only G2P kernel
and the finish in torch. A kernel that fails to build or launch raises;
nothing falls back to the other route. With rigid bodies it runs
``rigid.cpic_packed.cpic_packed_frame_carry``: two-way coupled CPIC
substeps (the fused P2G kernel and the gather-only G2P kernel, with the
sparse corrections between); the unfused CPIC route raises. The packed
carry (sorted state, page map, drift) persists across frames;
``particles`` is unpacked from it only when read.

Only the blocked path exists in the port so far: 2-D scenes and kernel
orders other than 2 need the dense oracle path (ROADMAP.md queue 1,
"the dense oracle path"), and raise here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core.state import Particles, empty_particles
from taichi_mpm_torch.materials import models as materials
from taichi_mpm_torch.ops import blocked, packed
from taichi_mpm_torch.rigid import cpic_packed


def resolve_device(device) -> torch.device:
    """The device a scene runs on: the card unless the caller names
    another. There is no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "MPM runs on a CUDA device and none is available; pass "
                "device='cpu' to run the plain-torch path on the CPU")
        device = "cuda"
    return torch.device(device)


class MPM:
    """Scene-level driver, mirroring the reference Python API
    (``MPM(res=...)``, ``add_particles``, ``step``)."""

    def __init__(
        self,
        res: Sequence[int],
        dx: float = 0.0,
        base_delta_t: float = 1e-4,
        frame_dt: float = 1e-2,
        gravity: Optional[Sequence[float]] = None,
        capacity: Optional[int] = None,
        optimized: Optional[bool] = None,
        device=None,
        **cfg_kw,
    ):
        """optimized: the reference's choice of the blocked path (None or
        True); the port has only that path, so False, the dense oracle
        path, raises."""
        if optimized is False:
            raise NotImplementedError(
                "optimized=False selects the dense oracle path, not ported yet "
                "(ROADMAP.md queue 1, 'the dense oracle path'); pass None or True")
        res = tuple(int(r) for r in res)
        if len(res) != 3:
            raise NotImplementedError(
                f"{len(res)}-D scenes need the dense oracle path, not ported "
                "yet (ROADMAP.md queue 1, 'the dense oracle path')")
        if gravity is None:
            gravity = (0.0, -10.0, 0.0)
        self.cfg = SimConfig(
            res=res, dx=dx, base_dt=base_delta_t, gravity=tuple(gravity), **cfg_kw
        )
        if self.cfg.kernel_order != 2:
            raise NotImplementedError(
                f"kernel_order={self.cfg.kernel_order} needs the dense oracle "
                "path, not ported yet (ROADMAP.md queue 1, 'the dense oracle path')")
        self.device = resolve_device(device)
        self.frame_dt = frame_dt
        self.capacity = capacity
        self.optimized = optimized
        # the fused kernels (prep inside P2G, finish inside G2P);
        # TMT_FUSED=0 selects the unfused route
        self.fused = os.environ.get("TMT_FUSED", "1") != "0"
        self.colliders: List = []
        self._pending: List[dict] = []
        self._particles: Optional[Particles] = None
        self._pcarry = None  # persistent packed carry (st, keys, pm, drift)
        self.t = np.float32(0.0)
        # work counters (reference plasticity counter; sorts per run)
        self.plasticity_counter = 0
        self.n_sorts = 0
        # CPIC rigid-body state (built at finalize from the first 'rigid')
        self._rigid_builder = None
        self.bodies = None
        self.rigid_scene = None
        self.cpic_caps = None  # cpic_packed.Capacities, set at the first CPIC frame
        self.cpic_stats = None  # high-water marks of the newest CPIC frame

    # -- particle state (lazily materialized) --------------------------------

    @property
    def particles(self) -> Optional[Particles]:
        """The Particles SoA. After a frame it is unpacked from the
        persistent packed carry on first read (in sorted lane order)."""
        if self._particles is None and self._pcarry is not None:
            self._particles = packed.unpack_particles(self._pcarry[0], self._cap_p)
        return self._particles

    @property
    def block_capacity(self) -> Optional[int]:
        """Page-map capacity K in use (None before the first frame)."""
        return None if self._pcarry is None else self._pcarry[2]["ids"].shape[0]

    @property
    def packed_carry(self):
        """The persistent packed carry (sorted state, keys, page map,
        drift) of the newest frame; None before the first frame."""
        return self._pcarry

    def sync(self):
        """Wait for the device work of the newest frame (a timing fence;
        does not unpack the particles)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # -- scene construction -------------------------------------------------

    def add_particles(
        self,
        type: str,
        pos: Optional[np.ndarray] = None,
        vel: Optional[np.ndarray] = None,
        density: Optional[float] = None,
        ppc: float = 8.0,
        mass: Optional[float] = None,
        vol: Optional[float] = None,
        **mat_kw,
    ):
        """Seed particles of a material at explicit positions.

        vol = dx^d / ppc and mass = vol * density by default. A callable
        ``<param>_tex`` kwarg sets a per-particle parameter from the seed
        positions (the parameter must sit verbatim in one slot); a
        non-callable one is dropped, as in the reference.

        ``type="rigid"`` adds a rigid body from ``mesh=`` (a (T, 3, 3)
        triangle array) or ``mesh_fn=`` (an OBJ path) with the keywords of
        ``rigid.scene.RigidSceneBuilder.add_rigid``; ``vel`` is its initial
        velocity. Returns the body id (>= 1; 0 is the background)."""
        if type == "rigid":
            return self._add_rigid(density=density, initial_velocity=vel, **mat_kw)
        if pos is None:
            raise NotImplementedError(
                "texture seeding (pos=None) is not ported yet (ROADMAP.md "
                "queue 1, 'texture seeding'); pass explicit positions")
        if density is None:
            density = 400.0
        pos = np.asarray(pos, np.float32)
        n, d = pos.shape
        if d != self.cfg.dim:
            raise ValueError(f"positions are {d}-D, the scene is {self.cfg.dim}-D")
        tex_kw = {
            k[:-4]: mat_kw.pop(k)
            for k in list(mat_kw)
            if k.endswith("_tex") and callable(mat_kw[k])
        }
        mat_id, params, aux0 = materials.pack_params(type, **mat_kw)
        v = np.zeros((n, d), np.float32)
        if vel is not None:
            v[:] = np.asarray(vel, np.float32)
        vol_ = float(vol) if vol is not None else self.cfg.dx**d / ppc
        mass_ = float(mass) if mass is not None else vol_ * density
        params_arr = np.broadcast_to(np.asarray(params, np.float32), (n, 8)).copy()
        for name, tex in tex_kw.items():
            slot = materials.param_slot(type, name, mat_kw)
            params_arr[:, slot] = np.asarray(tex(pos), np.float32).reshape(n)
        batch = dict(
            x=pos,
            v=v,
            mat=np.full((n,), mat_id, np.int32),
            params=params_arr,
            aux=np.full((n,), aux0, np.float32),
            mass=np.full((n,), mass_, np.float32),
            vol=np.full((n,), vol_, np.float32),
        )
        if self.particles is not None:
            self._inject(batch)  # post-finalize emission into free slots
        else:
            self._pending.append(batch)
        return n

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _inject(self, batch: dict):
        """Write a batch into inactive capacity slots."""
        p = self.particles
        free = torch.nonzero(~p.active).flatten()
        n = batch["x"].shape[0]
        if n > free.numel():
            raise RuntimeError(
                f"particle capacity exhausted: need {n}, have {free.numel()} free "
                f"slots; construct MPM(..., capacity=...) with headroom")
        idx = free[:n]
        d = self.cfg.dim
        p.x[idx] = self._tensor(batch["x"])
        p.v[idx] = self._tensor(batch["v"])
        p.F[idx] = torch.eye(d, device=self.device)
        p.C[idx] = 0.0
        for name in ("mat", "params", "aux", "mass", "vol"):
            getattr(p, name)[idx] = self._tensor(batch[name])
        p.states[idx] = 0
        p.bdist[idx] = 0.0
        p.bnormal[idx] = 0.0
        p.near_b[idx] = False
        p.active[idx] = True
        self._pcarry = None  # particle set mutated outside the frame
        mats = set(self.cfg.active_materials) | set(np.unique(batch["mat"]).tolist())
        self.cfg = self.cfg.with_materials(mats)

    def add_collider(self, collider):
        self.colliders.append(collider)

    # -- rigid bodies (CPIC) ---------------------------------------------------

    def _add_rigid(self, mesh=None, mesh_fn: Optional[str] = None, **kw) -> int:
        from taichi_mpm_torch.rigid.mesh import load_obj
        from taichi_mpm_torch.rigid.scene import RigidSceneBuilder

        if self.bodies is not None:
            raise ValueError("rigid bodies are added before the first step")
        if self._rigid_builder is None:
            self._rigid_builder = RigidSceneBuilder(self.cfg.dim, self.cfg.dx)
        if mesh is None:
            if not mesh_fn:
                raise ValueError("a rigid body needs mesh= (array) or mesh_fn= (OBJ path)")
            mesh = load_obj(mesh_fn)
        return self._rigid_builder.add_rigid(mesh, t0=float(self.t), **kw)

    def add_articulation(self, type: str, obj0: int, obj1: int = 0, **kw):
        """Constrain two rigid bodies (the reference's 'add_articulation'):
        rotation, frozen, distance, axial_rotation, motor or stepper."""
        if self._rigid_builder is None:
            raise ValueError("add rigid bodies first")
        if self.bodies is not None:
            raise ValueError("articulations are added before the first step")
        self._rigid_builder.add_articulation(type, obj0, obj1, **kw)

    # -- state finalization --------------------------------------------------

    def _finalize(self, capacity: Optional[int] = None):
        if not self._pending:
            raise RuntimeError("no particles added")
        cat = {k: np.concatenate([b[k] for b in self._pending], 0)
               for k in self._pending[0]}
        n = cat["x"].shape[0]
        cap = capacity or self.capacity or n
        p = empty_particles(cap, self.cfg.dim, self.device)
        for name in ("x", "v", "mat", "params", "aux", "mass", "vol"):
            getattr(p, name)[:n] = self._tensor(cat[name])
        p.active[:n] = True
        self.cfg = self.cfg.with_materials(int(m) for m in np.unique(cat["mat"]))
        self._particles = p
        self._pcarry = None
        self._pending = []
        if self._rigid_builder is not None:
            self.bodies, self.rigid_scene = self._rigid_builder.build(
                tuple(self.colliders), device=self.device)
            self.cfg = dataclasses.replace(self.cfg, num_rigids=self._rigid_builder.num)

    def _active_block_cap(self) -> int:
        """Initial page-map capacity K: 1.5x the dilated occupancy
        (occupied blocks + 27-neighbourhood), a multiple of 64, at most
        the padded block space. Computed on the device."""
        cfg = self.cfg
        nbp = blocked.num_blocks_padded(cfg)
        nbt = blocked.total_blocks_padded(cfg)
        p = self.particles
        res = torch.as_tensor(cfg.res, dtype=torch.int32, device=self.device)
        cell = torch.minimum(torch.clamp((p.x * cfg.inv_dx).to(torch.int32), min=0), res - 1)
        b = cell // blocked.BLOCK
        bid = (b[:, 0] * nbp[1] + b[:, 1]) * nbp[2] + b[:, 2]
        bid = torch.where(p.active, bid, nbt)
        occ = torch.zeros((nbt + 1,), dtype=torch.bool, device=self.device)
        occ[bid.long()] = True
        occ = blocked._dilate27(occ[:-1].reshape(nbp))
        n_occ = int(occ.sum())
        return int(min(nbt, -(-max(64, int(1.5 * n_occ)) // 64) * 64))

    def _rigid_map_cap(self) -> int:
        """Initial capacity Kr of the CPIC frame's rigid page map, estimated
        on the host from the bodies at rest (the JAX package's estimate):
        the boundary particles' blocks dilated four deep, with a 1.5x
        margin, a multiple of 64."""
        from taichi_mpm_torch.rigid.body import boundary_particle_world

        scene = self.rigid_scene
        xb, _, _ = boundary_particle_world(self.bodies, scene.bp_rid, scene.bp_offset,
                                           scene.bp_normal, scene.bp_elem)
        nb = np.maximum(1, -(-np.asarray(self.cfg.res) // blocked.BLOCK))
        tag = np.zeros(tuple(nb), bool)
        blk = (xb.cpu().numpy() / self.cfg.dx).astype(np.int64) // blocked.BLOCK
        tag[tuple(np.clip(blk, 0, nb - 1).T)] = True
        for ax in range(3):  # a box dilation, four blocks along each axis
            t = tag.copy()
            for s in range(1, 5):
                lo = [slice(None)] * 3
                hi = [slice(None)] * 3
                lo[ax] = slice(s, None)
                hi[ax] = slice(0, -s)
                tag[tuple(lo)] |= t[tuple(hi)]
                tag[tuple(hi)] |= t[tuple(lo)]
        return int(min(blocked.total_blocks_padded(self.cfg),
                       -(-max(64, int(1.5 * tag.sum())) // 64) * 64))

    # -- time stepping --------------------------------------------------------

    def _check_route(self):
        if self.bodies is not None and not self.fused:
            raise NotImplementedError(
                "CPIC with TMT_FUSED=0 runs the pytree CPIC frame "
                "(rigid/cpic_blocked.cpic_frame_carry), not ported yet "
                "(ROADMAP.md queue 1, 'the rest of CPIC'); unset TMT_FUSED")

    def _prepare_frame(self):
        """Finalize the scene, check its route and pack the carry when
        there is none."""
        if (self._particles is None and self._pcarry is None) or self._pending:
            self._finalize()
        self._check_route()
        if self._pcarry is None:
            p = self.particles
            self._cap_p = p.capacity
            if self.bodies is not None and self.cpic_caps is None:
                self.cpic_caps = cpic_packed.Capacities(self._rigid_map_cap())
            self._pcarry = packed.pack_carry(p, self.cfg, self._active_block_cap())
            self.n_sorts += 1

    def _end_frame(self, carry, t, nsorts, plast):
        self._pcarry = carry
        self._particles = None  # unpacked again from the carry on read
        self.t = t
        self.n_sorts += nsorts
        self.plasticity_counter += int(plast)

    def step(self, frame_dt: Optional[float] = None):
        """Advance one frame on the blocked path (the CPIC frame when the
        scene has rigid bodies). The page map grows at the sort when its
        capacity overflows (ops.packed.sort_and_map); the CPIC capacities
        grow where they are used (rigid.cpic_packed)."""
        self._prepare_frame()
        fdt = frame_dt or self.frame_dt
        n_sub = max(1, int(round(fdt / self.cfg.base_dt)))
        if self.bodies is not None:
            carry, self.bodies, t, nmax, nnear, ncoarse, nr, nsorts, plast = (
                cpic_packed.cpic_packed_frame_carry(
                    self._pcarry, self.bodies, self.t, self.cfg, self.rigid_scene,
                    self.cfg.base_dt, n_sub, self.cpic_caps))
            self.cpic_stats = dict(n_act=nmax, n_near=nnear, n_coarse=ncoarse, n_r=nr)
        else:
            carry, t, _, nsorts, plast = packed.packed_frame_carry(
                self._pcarry, self.t, self.cfg, tuple(self.colliders),
                self.cfg.base_dt, n_sub, fused=self.fused)
        self._end_frame(carry, t, nsorts, plast)

    # -- read-out -------------------------------------------------------------

    def _ensure_finalized(self):
        if self.particles is None or self._pending:
            self._finalize()

    def positions(self) -> np.ndarray:
        self._ensure_finalized()
        p = self.particles
        return p.x[p.active].cpu().numpy()

    def velocities(self) -> np.ndarray:
        self._ensure_finalized()
        p = self.particles
        return p.v[p.active].cpu().numpy()
