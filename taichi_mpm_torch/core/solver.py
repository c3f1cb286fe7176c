"""MPM scene driver: the user-facing API on the blocked path (torch
counterpart of ``taichi_mpm_tpu.core.solver.MPM``).

``MPM(res=...)``, then ``add_particles`` (a material at explicit
positions or seeded from a density texture, or ``"rigid"`` with a mesh
for a CPIC rigid body), ``add_articulation``, ``add_collider`` and
``step()`` or ``simulate``. Without rigid bodies every frame runs
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

Read-out and I/O: ``positions``, ``velocities``, ``energy``
(``mechanical_energy``), ``visualize`` (a BGEO file per frame, with the
rigid bodies' meshes as OBJ), ``visualize_cdf``,
``visualize_particle_cdf``, ``save`` and ``load`` (snapshots in the JAX
package's format) and ``general_action``.

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
from taichi_mpm_torch.utils import const


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


def mechanical_energy(p: Particles, cfg: SimConfig):
    """Kinetic + elastic potential + gravitational potential energy of
    the active particles, a 0-d tensor on their device (the conservation
    diagnostic of the JAX package's ``mechanical_energy``)."""
    act = p.active
    m = torch.where(act, p.mass, 0.0)
    kinetic = 0.5 * torch.sum(m * torch.sum(p.v * p.v, -1))
    pot = materials.dispatch_potential_energy(cfg.active_materials, p.mat, p.F, p.aux,
                                              p.params, p.vol)
    elastic = torch.sum(torch.where(act, pot, 0.0))
    g = const(cfg.gravity, torch.float32, p.device)
    grav = -torch.sum(m * torch.sum(p.x * g, -1))
    return kinetic + elastic + grav


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
        """Seed particles of a material at explicit positions `pos`, or,
        with pos=None, from a density texture ``density_tex`` (a callable
        of points (n, d) giving the particles per cell there): Poisson-disk
        seeding by the periodic tile (``pd=True``, ``pd_periodic=True``,
        the default), by Bridson dart throwing (``pd_periodic=False``) or
        rejection sampling (``pd=False``); with ``pd_source=True`` an
        emitter that adds the layer leaving the texture within
        ``delta_t`` (default frame_dt) at velocity `vel`, for
        ``frame_update`` callbacks. A texture's ppc is its maximum.

        vol = dx^d / ppc and mass = vol * density by default. A callable
        ``<param>_tex`` kwarg sets a per-particle parameter from the seed
        positions (the parameter must sit verbatim in one slot); a
        non-callable one is dropped, as in the reference. After the first
        frame a batch fills free capacity slots (``_inject``).

        ``type="rigid"`` adds a rigid body from ``mesh=`` (a (T, 3, 3)
        triangle array) or ``mesh_fn=`` (an OBJ path) with the keywords of
        ``rigid.scene.RigidSceneBuilder.add_rigid``; ``vel`` is its initial
        velocity. Returns the body id (>= 1; 0 is the background), else
        the number of particles added."""
        if type == "rigid":
            return self._add_rigid(density=density, initial_velocity=vel, **mat_kw)
        if pos is None:
            if "density_tex" not in mat_kw:
                raise ValueError("add_particles needs pos= or density_tex=")
            pos, ppc = self._sample_from_texture(
                density_tex=mat_kw.pop("density_tex"),
                pd=mat_kw.pop("pd", True),
                pd_source=mat_kw.pop("pd_source", False),
                pd_periodic=mat_kw.pop("pd_periodic", True),
                delta_t=mat_kw.pop("delta_t", self.frame_dt),
                velocity=vel,
            )
            if len(pos) == 0:
                return 0
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

    def _sample_from_texture(self, density_tex, pd, pd_source, pd_periodic, delta_t,
                             velocity):
        """Seed positions (float32, host) and ppc of a density texture, by
        the JAX package's rules and random streams."""
        from taichi_mpm_torch.sampling import poisson

        d = self.cfg.dim
        lo = np.zeros(d)
        hi = np.asarray(self.cfg.res) * self.cfg.dx
        dx = self.cfg.dx
        if pd and pd_periodic:
            if pd_source:
                v = np.asarray(velocity if velocity is not None else np.zeros(d))
                offset = v * float(self.t)
                g = np.asarray(self.cfg.gravity)
                adv = v * delta_t + 0.5 * g * (delta_t + self.cfg.base_dt) * delta_t
                pos = poisson.sample_from_source(density_tex, lo, hi, dx, d, offset, adv)
            else:
                pos = poisson.sample_from_periodic_data(density_tex, lo, hi, dx, d)
        elif pd:
            mn, mx, ppc = poisson._density_bbox(density_tex, lo, hi, dx, d)
            if mn is None:
                return np.zeros((0, d), np.float32), 1.0
            cand = poisson.bridson(mn, mx, poisson.min_distance_for_ppc(dx, ppc, d))
            pos = cand[density_tex(cand) > 0]
        else:
            # rejection sampling at ppc per cell
            mn, mx, ppc = poisson._density_bbox(density_tex, lo, hi, dx, d)
            if mn is None:
                return np.zeros((0, d), np.float32), 1.0
            rng = np.random.default_rng(0)
            axes = [np.arange(0, self.cfg.res[k]) for k in range(d)]
            cells = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, d)
            m = int(np.ceil(ppc))
            cand = (np.repeat(cells, m, 0) + rng.random((len(cells) * m, d))) * dx
            keep = rng.random(len(cand)) <= density_tex(cand) / max(ppc, 1e-30)
            pos = cand[keep].astype(np.float32)
        _, _, ppc = poisson._density_bbox(density_tex, lo, hi, dx, d)
        return pos, max(ppc, 1e-30)

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

    def _finalize(self, capacity: Optional[int] = None, allow_empty: bool = False):
        if not self._pending and not allow_empty:
            raise RuntimeError("no particles added")
        n = sum(b["x"].shape[0] for b in self._pending)
        cap = capacity or self.capacity or n
        p = empty_particles(cap, self.cfg.dim, self.device)
        if self._pending:
            cat = {k: np.concatenate([b[k] for b in self._pending], 0)
                   for k in self._pending[0]}
            for name in ("x", "v", "mat", "params", "aux", "mass", "vol"):
                getattr(p, name)[:n] = self._tensor(cat[name])
            p.active[:n] = True
            self.cfg = self.cfg.with_materials(int(m) for m in np.unique(cat["mat"]))
        self._set_particles(p)
        self._pending = []
        if self._rigid_builder is not None:
            self.bodies, self.rigid_scene = self._rigid_builder.build(
                tuple(self.colliders), device=self.device)
            self.cfg = dataclasses.replace(self.cfg, num_rigids=self._rigid_builder.num)

    def _finalize_for_load(self, snap_cap: int):
        """Finalize a scene a snapshot is loaded into; a scene whose
        particles all come later (an emitter's) gets empty capacity for
        at least the snapshot's."""
        if self.particles is None or self._pending:
            self._finalize(self.capacity or (None if self._pending else snap_cap),
                           allow_empty=True)

    def _set_particles(self, p: Particles):
        """Replace the particle state; the packed carry goes with it and
        the next frame sorts afresh."""
        self._particles = p
        self._pcarry = None

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

    def simulate(self, num_frames: int, frame_update=None):
        """`num_frames` frames, each after frame_update(self, f) where
        given (an emitter's add_particles, scripted changes). Returns the
        particles."""
        for f in range(num_frames):
            if frame_update is not None:
                frame_update(self, f)
            self.step()
        return self.particles

    # -- diagnostics and I/O --------------------------------------------------

    def energy(self) -> float:
        """Mechanical energy of the particles (``mechanical_energy``),
        computed on the scene's device."""
        self._ensure_finalized()
        return float(mechanical_energy(self.particles, self.cfg))

    def general_action(self, action: str, **kw):
        """The reference's string-dispatched actions: 'save', 'load' (with
        file_name= or path=), 'add_articulation' (type=, obj0=, obj1=, and
        the articulation's keywords) and 'calculate_energy'."""
        if action in ("save", "load"):
            path = kw["file_name"] if "file_name" in kw else kw["path"]
            return getattr(self, action)(path)
        if action == "add_articulation":
            kw2 = dict(kw)
            return self.add_articulation(kw2.pop("type"), kw2.pop("obj0"), kw2.pop("obj1", 0),
                                         **kw2)
        if action == "calculate_energy":
            return self.energy()
        raise ValueError(f"unknown general_action {action!r}")

    def visualize(self, path: str, verbose: bool = False, write_rigid: bool = True,
                  writer: str = "native"):
        """Write the active particles to a BGEO file (``io.bgeo``); verbose
        adds their v, mass, boundary (near_b) and distance (bdist). With
        rigid bodies their current meshes go beside it as
        ``<stem>_rigid_<id>.obj``. writer "numpy" takes the native
        writer's numpy twin."""
        from taichi_mpm_torch.io.bgeo import write_bgeo

        self._ensure_finalized()
        p = self.particles
        act = p.active
        attrs = {}
        if verbose:
            attrs["v"] = p.v[act].cpu().numpy()
            attrs["mass"] = p.mass[act].cpu().numpy()
            attrs["boundary"] = p.near_b[act].to(torch.float32).cpu().numpy()
            attrs["distance"] = p.bdist[act].cpu().numpy()
        write_bgeo(path, p.x[act].cpu().numpy(), attrs, writer=writer)
        if write_rigid and self.bodies is not None:
            self.write_rigid_meshes(os.path.splitext(path)[0] + "_rigid")

    def write_rigid_meshes(self, prefix: str):
        """Each rigid body's current world-space mesh as
        ``<prefix>_<id>.obj`` (a triangle soup)."""
        from taichi_mpm_torch.rigid.body import rotate

        if self.bodies is None:
            raise ValueError("no rigid bodies in the scene")
        pos = self.bodies.pos.cpu().numpy()
        rot = self.bodies.rot.cpu()
        for rid in range(1, self._rigid_builder.num):
            elem = self._rigid_builder.meshes[rid]  # (E, 3, 3) body frame
            world = rotate(rot[rid][None], torch.as_tensor(elem.reshape(-1, 3))).numpy() + pos[rid]
            with open(f"{prefix}_{rid}.obj", "w") as f:
                f.write(f"# taichi_mpm_torch rigid body {rid}\n")
                for v in world:
                    f.write(f"v {v[0]} {v[1]} {v[2]}\n")
                for e in range(elem.shape[0]):
                    i0 = 3 * e + 1
                    f.write(f"f {i0} {i0 + 1} {i0 + 2}\n")

    def visualize_cdf(self, path: str):
        """The current grid CDF as a point cloud of the tagged nodes, with
        their distance, states and rigid_id (the reference's CDF debug
        dump)."""
        from taichi_mpm_torch.io.bgeo import write_bgeo
        from taichi_mpm_torch.rigid import cdf
        from taichi_mpm_torch.rigid.body import boundary_particle_world

        if self.bodies is None:
            raise ValueError("no rigid bodies in the scene")
        scene = self.rigid_scene
        xb, _, elem_w = boundary_particle_world(self.bodies, scene.bp_rid, scene.bp_offset,
                                                scene.bp_normal, scene.bp_elem)
        dist, rid, states = cdf.rasterize_rigid_boundary(xb, elem_w, scene.bp_rid,
                                                         self.bodies.num, self.cfg)
        states = states.cpu().numpy()
        sel = states != 0
        coords = np.stack(np.meshgrid(*[np.arange(n) for n in self.cfg.grid_nodes],
                                      indexing="ij"), -1).reshape(-1, self.cfg.dim)[sel]
        write_bgeo(path, (coords * self.cfg.dx).astype(np.float32),
                   {"distance": dist.cpu().numpy()[sel],
                    "states": states[sel].astype(np.float32),
                    "rigid_id": rid.cpu().numpy()[sel].astype(np.float32)})

    def visualize_particle_cdf(self, path: str):
        """The active particles that carry CPIC affinity bits, with their
        distance, states and boundary flag."""
        from taichi_mpm_torch.io.bgeo import write_bgeo

        self._ensure_finalized()
        p = self.particles
        sel = p.active & (p.states != 0)
        write_bgeo(path, p.x[sel].cpu().numpy(),
                   {"distance": p.bdist[sel].cpu().numpy(),
                    "states": p.states[sel].to(torch.float32).cpu().numpy(),
                    "boundary": p.near_b[sel].to(torch.float32).cpu().numpy()})

    def save(self, path: str):
        """A snapshot of the state (``io.checkpoint``, the JAX package's
        format)."""
        from taichi_mpm_torch.io.checkpoint import save_checkpoint

        self._ensure_finalized()
        save_checkpoint(path, self)

    def load(self, path: str):
        """Restore a snapshot (this package's or the JAX package's) into
        this rebuilt scene; the next frame sorts afresh."""
        from taichi_mpm_torch.io.checkpoint import load_checkpoint

        load_checkpoint(path, self)
