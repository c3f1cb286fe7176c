"""CPIC two-way coupled transfers and the coupled substep of the dense path
(torch counterpart of ``taichi_mpm_tpu.rigid.cpic``).

The coloured transfers: a grid node whose colour tags are incompatible
with a particle's affinity does not receive the particle's P2G scatter;
its friction-projected velocity change becomes an impulse on the rigid
body that owns the node (``p2g_cpic``). In G2P such a node is replaced
by a ghost velocity, the particle's own velocity friction-projected
against the rigid surface plus a push along the boundary normal, and
penetrating particles get a penalty impulse exchanged with the rigid
(``g2p_cpic``). ``cpic_substep`` is one coupled substep of the dense
path over whole-grid arrays, in 2-D or 3-D and at any B-spline order.

Every stencil offset is computed at once as in ``core.transfer``, and the
sums keep the JAX package's order: the P2G scatter is one ordered
scatter, offset-major (``utils.index_add_ordered``); the impulses onto
the bodies are summed per offset and body in particle order, on every
device (``_body_totals``: ``ops.body_sums.body_totals``, on the card the
hand-written kernel ``csrc/body_totals.cu``, on the CPU its twin, one
ordered scatter into per-offset rows), and the offsets' totals then
added in offset order; in G2P the last incompatible node of the stencil
names the body the penalty impulse goes to. So the card sums the bodies'
totals in the CPU's and the JAX package's order, and the frame has the
same bits on every run on the card. ``cpic_substep(stages=...)`` keeps
each stage's outputs (``diagnostics.coupled_stage_partings``). The
helpers ``_compatible`` and ``_friction_of`` serve the packed CPIC path
too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core import transfer
from taichi_mpm_torch.core.levelset import friction_project
from taichi_mpm_torch.core.state import Particles
from taichi_mpm_torch.materials import models as materials
from taichi_mpm_torch.math.kernels import inv_D
from taichi_mpm_torch.ops import body_sums
from taichi_mpm_torch.rigid import cdf
from taichi_mpm_torch.rigid.body import (
    RigidBodies,
    _torque_of,
    advance,
    apply_impulses,
    boundary_particle_world,
    velocity_at,
)
from taichi_mpm_torch.utils import const, index_add_ordered, mv, outer


def _compatible(grid_state, p_state, smask):
    """Colour compatibility of a node's tags with a particle's affinity."""
    mask = (grid_state & p_state & smask) >> 1
    return (grid_state & mask) == (p_state & mask)


def _friction_of(bodies: RigidBodies, rid, p_state):
    """Side-dependent rigid friction: friction[rid, negative bit]."""
    safe = torch.clamp(rid, 0, bodies.num - 1).long()
    neg = ((p_state >> (2 * safe)) & 1).long()
    return torch.where(rid >= 0, bodies.friction[safe, neg], 0.0)


def _friction_of_masked(bodies: RigidBodies, rid, p_state):
    """_friction_of as a static unroll over the bodies with rid == r
    masks (rid < 0 -> 0)."""
    out = torch.zeros(rid.shape, dtype=torch.float32, device=rid.device)
    for r in range(bodies.num):
        neg = (p_state >> (2 * r)) & 1
        fr = torch.where(neg == 1, bodies.friction[r, 1], bodies.friction[r, 0])
        out = torch.where(rid == r, fr, out)
    return out


def _stencil(p: Particles, cfg: SimConfig, grid_rid, grid_states, nd=None):
    """Every stencil offset of every particle at once, offsets first (K
    offsets in the JAX package's order): ``cdf.stencil_node_data`` at
    cfg's B-spline order over the node colour tags and owner bodies (0
    and -1 out of the grid; the distance plane is not read), with the
    nodes' linear index (0 out of the grid) added. `nd`, the CDF gather's
    stencil data at the same positions, holds the same values at
    quadratic order and is reused."""
    if nd is None:
        ncdf = cdf.DenseNodeCDF(torch.zeros(grid_rid.shape, device=grid_rid.device), grid_rid,
                                grid_states, cfg)
        nd = cdf.stencil_node_data(p.x, ncdf, cfg, cfg.kernel_order)
    return dict(nd, lin=torch.where(nd["inb"], transfer._ravel(nd["nidx"], cfg.grid_nodes), 0))


def _body_totals(bodies: RigidBodies, rid, J, at, valid, stages=None, key="p2g"):
    """``accumulate_impulses`` over the particle axis (the last but one of
    J) of each leading row (a stencil offset, if any): the impulses J at
    points `at` where valid, per body rid. Returns (J (..., R, d), torque
    (..., R, 3 or 1)). Each row is summed in particle order on every
    device, the CPU's and the JAX package's order
    (``ops.body_sums.body_totals``: on the card the hand-written kernel
    ``csrc/body_totals.cu``, on the CPU an ordered scatter into per-offset
    rows). Torch's per-body masked sums on the card reduced as a tree,
    which moved the 2-D async wheel's omega past the body bound; an
    ordered scatter into a few rows sums each row in one thread over
    every lane there (82 of 91 ms of a dense CPIC substep of the 100k
    wheel on an H100). `stages` (a dict) receives the addends under
    `key` + "_rows": each lane's body (-1 where not valid), J and
    torque."""
    J = torch.where(valid[..., None], J, 0.0)
    rows = (torch.where(valid, rid, -1), J, _torque_of(at - bodies.pos[rid], J))
    if stages is not None:
        stages[key + "_rows"] = rows
    return body_sums.body_totals(*rows, bodies.num)


def _offset_sums(bodies: RigidBodies, rid, J, at, valid, stages=None):
    """The impulse totals of each stencil offset (leading axis K,
    ``_body_totals``) added in offset order. `stages` (a dict) receives
    the addends, the per-offset totals and their sums."""
    Jk, tk = _body_totals(bodies, rid, J, at, valid, stages)
    J_tot, tau_tot = Jk[0], tk[0]
    for k in range(1, Jk.shape[0]):
        J_tot = J_tot + Jk[k]
        tau_tot = tau_tot + tk[k]
    if stages is not None:
        stages.update(p2g_offset_totals=(Jk, tk), p2g_totals=(J_tot, tau_tot))
    return J_tot, tau_tot


def p2g_cpic(p: Particles, bodies: RigidBodies, grid_rid, grid_states, cfg: SimConfig, dt,
             nd=None, stages=None):
    """CPIC P2G: the dense P2G of ``core.transfer`` into the compatible
    nodes, and the impulses of the incompatible ones on their bodies
    (`nd`: see ``_stencil``; `stages`: see ``cpic_substep``). Returns
    (grid nodes + (d + 1,), J_tot (R, d), tau_tot (R, 3) or (R, 1) in
    2-D)."""
    d = cfg.dim
    R = bodies.num
    smask = cdf.state_mask(R)
    invD = inv_D(cfg.kernel_order)

    vel = p.v
    if cfg.particle_gravity:
        vel = vel + const(cfg.gravity, torch.float32, p.device) * dt
    force = materials.dispatch_force(cfg.active_materials, p.mat, p.F, p.aux, p.params, p.vol)
    force = torch.where(p.active[:, None, None], force, 0.0)
    affine = (invD * p.mass[:, None, None] * p.C
              - transfer._folded(invD * cfg.inv_dx, dt) * force)
    affine = torch.where(p.active[:, None, None], affine, 0.0)
    mass = torch.where(p.active, p.mass, 0.0)
    mvel = mass[:, None] * vel

    st = _stencil(p, cfg, grid_rid, grid_states, nd)
    inb, wo, nrid = st["inb"], st["wo"], st["nrid"]
    compat = _compatible(st["s"], p.states, smask)

    # compatible nodes: the plain MLS-MPM scatter
    mom = mvel + mv(affine, st["dpos"])  # (K, N, d)
    val = torch.cat([mom, mass[:, None].expand(mom.shape[:-1] + (1,))], -1) \
        * (wo * p.active)[..., None]
    val = torch.where((inb & compat)[..., None], val, 0.0)
    flat = torch.zeros((int(np.prod(cfg.grid_nodes)), d + 1), dtype=torch.float32,
                       device=p.device)
    index_add_ordered(flat, st["lin"].reshape(-1), val.reshape(-1, d + 1))

    # incompatible nodes: an impulse onto the owning rigid
    hit = inb & (~compat) & (nrid >= 0) & p.active
    xg = st["nidx"].to(torch.float32) * cfg.dx
    rid_safe = torch.clamp(nrid, 0, R - 1).long()
    rigid_v = velocity_at(bodies, rid_safe, xg)
    fric = _friction_of(bodies, nrid, p.states)
    dv = vel - friction_project(vel, rigid_v, p.bnormal, fric)
    impulse = (mass * wo)[..., None] * dv + float(np.float32(dt)) * mv(force, st["gradw"])
    J_tot, tau_tot = _offset_sums(bodies, rid_safe, impulse, xg, hit, stages)
    grid = flat.reshape(tuple(cfg.grid_nodes) + (d + 1,))
    if stages is not None:
        stages.update(p2g_force=force, p2g_scatter_addends=val, p2g_grid=grid)
    return grid, J_tot, tau_tot


def g2p_cpic(p: Particles, bodies: RigidBodies, grid_v, grid_rid, grid_states, cfg: SimConfig,
             dt, return_count: bool = False, nd=None, stages=None):
    """CPIC G2P: the dense gather with each incompatible node's velocity
    replaced by the ghost velocity, ``core.transfer.g2p_finish`` (near-
    boundary particles zero their C), then the boundary penalty (`nd`: see
    ``_stencil``; `stages`: see ``cpic_substep``). Returns
    (particles, J_tot, tau_tot) of the penalty impulses [, the plasticity
    count as a 0-d tensor]."""
    d = cfg.dim
    R = bodies.num
    smask = cdf.state_mask(R)
    st = _stencil(p, cfg, grid_rid, grid_states, nd)
    inb, lin, nrid = st["inb"], st["lin"], st["nrid"]
    gv = grid_v.reshape(-1, d).index_select(0, lin.reshape(-1)).reshape(lin.shape + (d,))
    gv = torch.where(inb[..., None], gv, 0.0)
    incompat = inb & ~_compatible(st["s"], p.states, smask)

    # the ghost velocity of incompatible nodes
    xg = st["nidx"].to(torch.float32) * cfg.dx
    rid_safe = torch.clamp(nrid, 0, R - 1).long()
    v_g = torch.where((nrid >= 0)[..., None], velocity_at(bodies, rid_safe, xg), 0.0)
    fric = _friction_of(bodies, nrid, p.states)
    push = p.bnormal * transfer._folded(dt, cfg.dx, cfg.pushing_force)
    fake_v = torch.where(p.near_b[:, None], friction_project(p.v, v_g, p.bnormal, fric) + push,
                         p.v)
    gv_eff = torch.where(incompat[..., None], fake_v, gv)
    # the owner of the last incompatible node in stencil order
    owned = incompat & (nrid >= 0)
    K = owned.shape[0]
    k_last = torch.amax(owned * torch.arange(1, K + 1, device=p.device)[:, None], 0)
    rid_last = torch.where(k_last > 0,
                           nrid.gather(0, torch.clamp(k_last - 1, min=0)[None])[0], -1)

    wgv = st["wo"][..., None] * gv_eff
    b_off = outer(wgv, st["dpos"])
    v_new, b_new = wgv[0], b_off[0]
    for k in range(1, K):  # summed offset by offset, as the JAX package's loop sums them
        v_new = v_new + wgv[k]
        b_new = b_new + b_off[k]
    v_new = torch.where(p.active[:, None], v_new, 0.0)
    b_new = torch.where(p.active[:, None, None], b_new, 0.0)
    p, count = transfer.g2p_finish(p, v_new, b_new, cfg, dt, zero_C=p.near_b,
                                   return_count=True)

    # the boundary penetration penalty
    pen = p.active & p.near_b & (p.bdist < -0.05 * cfg.dx) & (p.bdist > -0.3 * cfg.dx)
    dv = p.bdist[:, None] * p.bnormal * cfg.penalty
    v_fixed = torch.where(pen[:, None], p.v - dv, p.v)
    J_tot, tau_tot = _body_totals(bodies, torch.clamp(rid_last, 0, R - 1).long(),
                                  dv * p.mass[:, None], p.x, pen & (rid_last >= 0), stages, "g2p")
    p = dataclasses.replace(p, v=v_fixed)
    if stages is not None:
        stages.update(g2p_gather_addends=wgv, g2p_particles=p, g2p_totals=(J_tot, tau_tot))
    if return_count:
        return p, J_tot, tau_tot, count
    return p, J_tot, tau_tot


def cpic_substep(p: Particles, bodies: RigidBodies, t, cfg: SimConfig, scene, dt, xg=None,
                 stages=None):
    """One coupled substep of the dense path, in the reference's order:
    coupling_iterations x {rigid-rigid collision and articulations (on
    the host, ``rigid.host``), rasterize the CDF}, gather the particles'
    CDF, CPIC P2G (+ impulses), the rigid bodies against the domain's
    level set, the grid update, CPIC G2P (+ penalty impulses), the
    per-particle collision and the boundary clean-up where cfg asks for
    them, then advance the bodies. `xg` are the grid's node positions
    (``core.transfer.node_positions``). A dict `stages` receives each
    stage's outputs: the CDF planes, the gathered particles and the
    bodies after the rigid prologue, the materials' force, the P2G
    scatter's addends and grid, each impulse sum's addends (``rows``),
    per-offset and total sums, the updated grid velocities, the G2P
    gather's addends and particles, the bodies after P2G's impulses and
    at the end. Returns (p, bodies, t + dt in float32, the plasticity
    count as a 0-d tensor)."""
    from taichi_mpm_torch.core.solver import clear_boundary_particles
    from taichi_mpm_torch.rigid import collision as coll
    from taichi_mpm_torch.rigid.cpic_blocked import _solve_bodies

    R = bodies.num
    for _ in range(max(1, cfg.coupling_iterations)):
        bodies = _solve_bodies(bodies, scene, dt)
        xb, _, elem_w = boundary_particle_world(bodies, scene.bp_rid, scene.bp_offset,
                                                scene.bp_normal, scene.bp_elem)
        grid_dist, grid_rid, grid_states = cdf.rasterize_rigid_boundary(
            xb, elem_w, scene.bp_rid, R, cfg)
    nd = cdf.stencil_node_data(p.x, cdf.DenseNodeCDF(grid_dist, grid_rid, grid_states, cfg), cfg)
    states, bdist, bnormal, near_b = cdf.gather_cdf_lookup(p.x, p.states, R, cfg, nd)
    p = dataclasses.replace(p, states=states, bdist=bdist, bnormal=bnormal, near_b=near_b)
    if cfg.kernel_order != 2:
        nd = None  # the transfers' stencil differs from the gather's

    if stages is not None:
        stages.update(cdf_planes=(grid_dist, grid_rid, grid_states), cdf_particles=p,
                      cdf_bodies=bodies)
    grid, J1, tau1 = p2g_cpic(p, bodies, grid_rid, grid_states, cfg, dt, nd, stages)
    bodies = apply_impulses(bodies, J1, tau1)
    if scene.colliders:
        bodies = coll.rigid_levelset_collision(bodies, xb, scene.bp_rid, scene.colliders, t, dt)
    grid_v, _ = transfer.grid_update(grid, cfg, scene.colliders, t, dt, xg)
    if stages is not None:
        stages.update(p2g_bodies=bodies, grid_v=grid_v)
    p, J2, tau2, count = g2p_cpic(p, bodies, grid_v, grid_rid, grid_states, cfg, dt,
                                  return_count=True, nd=nd, stages=stages)
    bodies = apply_impulses(bodies, J2, tau2)
    if cfg.particle_collision:
        p = transfer.particle_collision_resolution(p, cfg, scene.colliders, t)
    if cfg.clean_boundary:
        p = clear_boundary_particles(p, cfg)
    bodies = advance(bodies, t, dt, scene.pos_funcs, scene.rot_funcs, cfg.gravity)
    if stages is not None:
        stages.update(particles=p, bodies=bodies)
    return p, bodies, np.float32(t) + np.float32(dt), count


def cpic_frame_fn(p: Particles, bodies: RigidBodies, t, cfg: SimConfig, scene, dt,
                  n_substeps: int, xg=None):
    """A dense CPIC frame: n_substeps ``cpic_substep`` of dt. Returns (p,
    bodies, t, the plasticity count as a 0-d tensor); reads nothing back
    to the host but where the scene has articulations or rigid-rigid
    collisions (``rigid.host``, one read per coupling iteration)."""
    count = torch.zeros((), dtype=torch.int64, device=p.device)
    for _ in range(n_substeps):
        p, bodies, t, c = cpic_substep(p, bodies, t, cfg, scene, dt, xg)
        count = count + c
    return p, bodies, t, count
