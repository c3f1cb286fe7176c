"""MPM scene driver: the user-facing API (torch counterpart of
``taichi_mpm_tpu.core.solver``, ``MPM`` and the dense substep and frame).

``MPM(res=...)``, then ``add_particles`` (a material at explicit
positions or seeded from a density texture, or ``"rigid"`` with a mesh
for a CPIC rigid body), ``add_articulation``, ``add_collider`` and
``step()`` or ``simulate``.

Two paths, chosen at the first frame as the JAX package chooses
(``MPM._use_blocked``): the blocked path for 3-D scenes of quadratic
B-splines unless ``optimized=False``, and the dense path otherwise (2-D
scenes, kernel orders 1 and 3, ``optimized=False``). The dense path
keeps ``Particles`` as they are and runs ``frame_fn``: a Python loop of
``substep`` (``core.transfer``'s whole-grid P2G, grid update and G2P,
then the per-particle collision and the boundary clean-up where the
configuration asks for them), with no host read in a fixed-dt frame.
With rigid bodies it runs ``rigid.cpic.cpic_frame_fn``: the coupled
substeps of the coloured transfers over the dense grid CDF, with the
articulations (and, in 3-D, the rigid-rigid collisions) on the host.
That frame runs on the lanes up to the last one ever made active
(``_live_lanes``): the lanes above have never held a particle, and a
substep leaves such a lane as it is, so the scripts' capacities (100,000
lanes for a few thousand grains) cost nothing per substep.

On the blocked path, without rigid bodies every frame runs
``ops.packed.packed_frame_carry``: the fused P2G and G2P kernels on the
card, with a lazy re-sort; with ``TMT_FUSED=0`` in the environment (read
at construction, as in the JAX package) the unfused route instead: the
operand prep in torch, the P2G kernel on it, the gather-only G2P kernel
and the finish in torch. A kernel that fails to build or launch raises;
nothing falls back to the other route. With rigid bodies it runs
``rigid.cpic_packed.cpic_packed_frame_carry``: two-way coupled CPIC
substeps (the fused P2G kernel and the gather-only G2P kernel, with the
sparse corrections between); with ``TMT_FUSED=0`` the pytree CPIC frame
``rigid.cpic_blocked.cpic_frame_carry`` (``p2g_blocked`` on the operand
of ``ops.substep.prep_p2g``, the same gather kernel and corrections, the
dense finish), as in the JAX package. The carry (sorted state, page map,
drift) persists across frames: the packed state, whose ``particles`` is
unpacked only when read, or, on the pytree CPIC frame, the sorted
Particles set itself.

Read-out and I/O: ``positions``, ``velocities``, ``energy``
(``mechanical_energy``), ``visualize`` (a BGEO file per frame, with the
rigid bodies' meshes as OBJ), ``visualize_cdf``,
``visualize_particle_cdf``, ``save`` and ``load`` (snapshots in the JAX
package's format) and ``general_action``.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core import transfer
from taichi_mpm_torch.core.state import FIELDS, Particles, empty_particles
from taichi_mpm_torch.materials import models as materials
from taichi_mpm_torch.ops import blocked, packed
from taichi_mpm_torch.rigid import cpic, cpic_blocked, cpic_packed
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


def substep(p: Particles, t, cfg: SimConfig, colliders, dt, xg=None):
    """One dense substep: P2G, grid update, G2P, then the per-particle
    collision and the boundary clean-up where cfg asks for them. `xg` are
    the grid's node positions (``transfer.node_positions``). Returns (p,
    t + dt in float32, the plasticity count as a 0-d tensor); the JAX
    package's substep returns no count."""
    grid = transfer.p2g(p, cfg, dt)
    grid_v, _ = transfer.grid_update(grid, cfg, colliders, t, dt, xg)
    p, count = transfer.g2p(p, grid_v, cfg, dt, return_count=True)
    if cfg.particle_collision:
        p = transfer.particle_collision_resolution(p, cfg, colliders, t)
    if cfg.clean_boundary:
        p = clear_boundary_particles(p, cfg)
    return p, np.float32(t) + np.float32(dt), count


def clear_boundary_particles(p: Particles, cfg: SimConfig) -> Particles:
    """Deactivate the particles within 7 cells of the domain's edge (the
    reference deletes them)."""
    pos = p.x * cfg.inv_dx
    res = const(cfg.res, torch.float32, p.device)
    near = (torch.amin(pos, -1) < 7.0) | (torch.amax(pos - res, -1) > -7.0)
    return dataclasses.replace(p, active=p.active & ~near)


def frame_fn(p: Particles, t, cfg: SimConfig, colliders, dt, n_substeps: int, xg=None):
    """A dense frame of n_substeps substeps of dt. Returns (p, t, the
    plasticity count as a 0-d tensor); reads nothing back to the host."""
    count = torch.zeros((), dtype=torch.int64, device=p.device)
    for _ in range(n_substeps):
        p, t, c = substep(p, t, cfg, colliders, dt, xg)
        count = count + c
    return p, t, count


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
        """optimized: the reference's choice of the blocked path. None
        takes it for 3-D scenes of quadratic B-splines (the card stands
        where the JAX package's TPU stands) and the dense path otherwise;
        True asks for it (a 3-D scene of another order then raises); False
        takes the dense path (``_use_blocked``)."""
        res = tuple(int(r) for r in res)
        if gravity is None:
            gravity = (0.0, -10.0, 0.0) if len(res) == 3 else (0.0, -10.0)
        self.cfg = SimConfig(
            res=res, dx=dx, base_dt=base_delta_t, gravity=tuple(gravity), **cfg_kw
        )
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
        self._blocked = None  # the path, chosen at the first frame (_use_blocked)
        self._xg = None  # the dense path's node positions
        self._live = None  # lanes up to the last one ever active (_live_lanes)
        self.t = np.float32(0.0)
        # work counters (reference plasticity counter; sorts per run); the
        # dense path's count stays on the device until it is read
        self._plast = 0
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
        persistent packed carry on first read (in sorted lane order); the
        pytree CPIC frame's carry holds it as it is."""
        if self._particles is None and self._pcarry is not None:
            head = self._pcarry[0]
            self._particles = (head if isinstance(head, Particles)
                               else packed.unpack_particles(head, self._cap_p))
        return self._particles

    @property
    def plasticity_counter(self) -> int:
        """Plastic events summed over the frames (the reference's work
        counter)."""
        return int(self._plast)

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
        if self._live is not None and n:
            self._live = max(self._live, int(idx[-1]) + 1)
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
        self._live = n
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
        self._live = None

    def _live_lanes(self) -> int:
        """1 + the index of the last lane ever made active (at least 1):
        known from the finalize and the emissions, or read once from the
        active mask after the particles were replaced."""
        if self._live is None:
            idx = torch.nonzero(self._particles.active).flatten()
            self._live = int(idx[-1]) + 1 if idx.numel() else 0
        return max(1, self._live)

    def _live_frame(self, frame):
        """frame(p) -> (p, *rest) run on the live lanes' particles
        (``_live_lanes``); the other lanes keep their values. Returns the
        whole particle set and rest."""
        p = self._particles
        n = self._live_lanes()
        if n >= p.capacity:
            return frame(p)
        q, *rest = frame(Particles(**{f: getattr(p, f)[:n] for f in FIELDS}))
        return (Particles(**{f: torch.cat([getattr(q, f), getattr(p, f)[n:]])
                             for f in FIELDS}), *rest)

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

    def _use_blocked(self) -> bool:
        """Whether the scene runs on the blocked path (the JAX package's
        gate): the blocked kernels hold quadratic weights, so a 3-D scene
        of another order takes the dense path with a warning, or raises
        where optimized=True asks for the blocked one."""
        cfg = self.cfg
        use_blocked = self.optimized
        if use_blocked is None:
            use_blocked = cfg.dim == 3
        if use_blocked and cfg.dim == 3 and cfg.kernel_order != 2:
            if self.optimized:
                raise ValueError(
                    "optimized=True requires kernel_order=2 (the blocked/"
                    "fused kernels hardcode quadratic weights); got "
                    f"kernel_order={cfg.kernel_order}. Use optimized=False.")
            warnings.warn(
                f"kernel_order={cfg.kernel_order}: falling back to the "
                "oracle (unblocked) path; the optimized path only supports "
                "quadratic B-splines.", stacklevel=3)
            return False
        return bool(use_blocked and cfg.dim == 3)

    def _pytree_cpic(self) -> bool:
        """Whether the frames run the pytree CPIC frame (rigid bodies on the
        blocked path with TMT_FUSED=0), whose carry holds a Particles set."""
        return self.bodies is not None and bool(self._blocked) and not self.fused

    def _prepare_frame(self):
        """Finalize the scene, choose its path at the first frame and, on
        the blocked path, pack the carry when there is none."""
        if (self._particles is None and self._pcarry is None) or self._pending:
            self._finalize()
        if self._blocked is None:
            self._blocked = self._use_blocked()
        if not self._blocked:
            if self._xg is None and self.colliders:
                self._xg = transfer.node_positions(self.cfg, self.device)
            return
        if self._pcarry is None:
            p = self.particles
            self._cap_p = p.capacity
            if self.bodies is not None and self.cpic_caps is None:
                self.cpic_caps = cpic_packed.Capacities(self._rigid_map_cap())
            pack = cpic_blocked.cpic_pack_carry if self._pytree_cpic() else packed.pack_carry
            self._pcarry = pack(p, self.cfg, self._active_block_cap())
            self.n_sorts += 1

    def _end_frame(self, carry, t, nsorts, plast):
        self._pcarry = carry
        self._particles = None  # unpacked again from the carry on read
        self.t = t
        self.n_sorts += nsorts
        self._plast += int(plast)

    def _end_dense_frame(self, p, t, plast):
        self._particles = p
        self.t = t
        self._plast = self._plast + plast  # a device tensor: read when asked

    def step(self, frame_dt: Optional[float] = None):
        """Advance one frame: ``frame_fn`` on the dense path, or
        ``rigid.cpic.cpic_frame_fn`` when the scene has rigid bodies; on
        the blocked path the packed frame, or the packed CPIC frame when
        the scene has rigid bodies. The page map grows at the sort when its
        capacity overflows (ops.packed.sort_and_map); the CPIC capacities
        grow where they are used (rigid.cpic_packed)."""
        self._prepare_frame()
        fdt = frame_dt or self.frame_dt
        n_sub = max(1, int(round(fdt / self.cfg.base_dt)))
        if not self._blocked and self.bodies is not None:
            p, self.bodies, t, plast = self._live_frame(lambda q: cpic.cpic_frame_fn(
                q, self.bodies, self.t, self.cfg, self.rigid_scene, self.cfg.base_dt, n_sub,
                self._xg))
            self._end_dense_frame(p, t, plast)
            return
        if not self._blocked:
            self._end_dense_frame(*frame_fn(self._particles, self.t, self.cfg,
                                            tuple(self.colliders), self.cfg.base_dt, n_sub,
                                            self._xg))
            return
        if self.bodies is not None:
            frame = (cpic_blocked.cpic_frame_carry if self._pytree_cpic()
                     else cpic_packed.cpic_packed_frame_carry)
            carry, self.bodies, t, nmax, nnear, ncoarse, nr, nsorts, plast = frame(
                self._pcarry, self.bodies, self.t, self.cfg, self.rigid_scene, self.cfg.base_dt,
                n_sub, self.cpic_caps)
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

    def particle_count(self) -> int:
        """The number of active particles."""
        self._ensure_finalized()
        return self.particles.count()

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
        self._ensure_finalized()
        self._write_bgeo(self.particles, path, verbose, writer)
        if write_rigid and self.bodies is not None:
            self.write_rigid_meshes(os.path.splitext(path)[0] + "_rigid")

    @staticmethod
    def _write_bgeo(p: Particles, path: str, verbose: bool, writer: str):
        """The active particles of `p` to a BGEO file (``visualize``)."""
        from taichi_mpm_torch.io.bgeo import write_bgeo

        act = p.active
        attrs = {}
        if verbose:
            attrs["v"] = p.v[act].cpu().numpy()
            attrs["mass"] = p.mass[act].cpu().numpy()
            attrs["boundary"] = p.near_b[act].to(torch.float32).cpu().numpy()
            attrs["distance"] = p.bdist[act].cpu().numpy()
        write_bgeo(path, p.x[act].cpu().numpy(), attrs, writer=writer)

    def write_rigid_meshes(self, prefix: str):
        """Each rigid body's current world-space mesh as
        ``<prefix>_<id>.obj`` (a triangle soup in 3-D, a polyline at z = 0
        in 2-D)."""
        from taichi_mpm_torch.rigid.body import rotate

        if self.bodies is None:
            raise ValueError("no rigid bodies in the scene")
        d = self.cfg.dim
        pos = self.bodies.pos.cpu().numpy()
        rot = self.bodies.rot.cpu()
        for rid in range(1, self._rigid_builder.num):
            elem = self._rigid_builder.meshes[rid]  # (E, d, d) body frame
            world = rotate(rot[rid][None], torch.as_tensor(elem.reshape(-1, d))).numpy() + pos[rid]
            with open(f"{prefix}_{rid}.obj", "w") as f:
                f.write(f"# taichi_mpm_torch rigid body {rid}\n")
                for v in world:
                    f.write(f"v {v[0]} {v[1]} {v[2] if d == 3 else 0}\n")
                for e in range(elem.shape[0]):
                    i0 = d * e + 1
                    f.write(f"f {i0} {i0 + 1} {i0 + 2}\n" if d == 3 else f"l {i0} {i0 + 1}\n")

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
