"""CPIC on the blocked path, compute-then-correct (torch counterpart of
``taichi_mpm_tpu.rigid.cpic_blocked``).

All particles run the plain blocked P2G/G2P; the particles near rigid
surfaces, compacted into a small set, then get a sparse correction:

* ``p2g_correction`` subtracts their contributions at colour-incompatible
  nodes from the node records and turns them into rigid impulses;
* ``g2p_correction`` replaces what they gathered from incompatible nodes
  by the CPIC ghost velocity;

with the same weights and force values as the plain path, so the
combination is the reference's coloured transfers. ``rigid_prologue`` is
the per-substep rigid prologue {rigidify, articulate, rasterize CDF}.
The near set is given to the corrections as ``mini``: the (48, B) packed
rows of its lanes (row map in ``ops/rows.py``) and ``nd``, its shared
stencil data (``cdf.stencil_node_data``, 27 offsets stacked on a leading
axis). The packed CPIC frame (``rigid.cpic_packed``, the fused route)
and the pytree frame here share them.

The pytree frame (``cpic_frame_carry``) is the JAX package's CPIC route
with ``TMT_FUSED=0``. Its carry is (Particles, keys, page map, drift), a
Particles set, as in the JAX package (whose MPM unpacks nothing there).
A substep: the rigid prologue with the rigid page map rebuilt (dilate 1),
the near set (``compact_near_rigid_ranges``, the exact stencil test),
the CDF gather on it, the operand prep (``ops.substep.prep_p2g``, the
matrix-form force) and the P2G kernel ``p2g_blocked``, the merge, the P2G
correction and its impulses, the level-set collision of the bodies, the
grid update and the windows, the gather kernel ``g2p_blocked``, the G2P
correction, ``core.transfer.g2p_finish`` (C zeroed near the boundary),
the boundary penalty and its impulses, the particle collision, the
boundary clean-up and the body advance. The near set is sized to its
counts (the JAX package sizes it by budgets b1 and near and re-runs a
frame that overflows them): n_near and n_coarse are read on the host, as
is the rigid page map's occupancy n_r, and Kr grows where the map is
built. Host reads per substep: those three, the bodies for the host's
rigid solves where the scene has collisions or articulations, and max|v|
for the drift.

On slabs (``parallel.spatial_blocked``) both CPIC substeps take the JAX
package's multichip hooks: the grid-frame config and the slab's offset
``world_off`` (the CDF, the near set, the page map and the grid update in
the slab's local frame, positions global), the origins with the offset,
the shifted colliders, the boundary exchange after the P2G correction,
and ``sum_fn``, the sum over the ranks of each rank's impulses, in place
of JAX's ``axis``. Without them each is one device's substep, in the
same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core import transfer
from taichi_mpm_torch.core.levelset import friction_project
from taichi_mpm_torch.core.state import Particles
from taichi_mpm_torch.materials import cforms
from taichi_mpm_torch.math.kernels import bspline_weights, inv_D
from taichi_mpm_torch.ops import blocked, g2p, p2g, packed
from taichi_mpm_torch.ops.blocked import REC_LANES, VREC_LANES
from taichi_mpm_torch.ops.rows import (
    NCH, RACT, RAUX, RBN, RC, RF, RMASS, RMAT, RNEARB, RORG, RPAR, RSTATES, RV, RVOL, RX,
)
from taichi_mpm_torch.ops.substep import build_page_map_full, grid_update_flat, prep_p2g
from taichi_mpm_torch.rigid import cdf
from taichi_mpm_torch.rigid.body import (
    R_UNROLL_MAX,
    accumulate_impulses,
    accumulate_impulses_masked,
    advance,
    apply_impulses,
    boundary_particle_world,
    velocity_at,
)
from taichi_mpm_torch.rigid.cpic import _compatible, _friction_of
from taichi_mpm_torch.rigid.host import HostBodies
from taichi_mpm_torch.utils import HostSyncs, const, host_read, index_add_ordered, mv


def _rec_slot_lane(idx, slot_map, cfg: SimConfig):
    """Global node index (..., 3) -> (record slot, 64-lane index)."""
    nbp = blocked.num_blocks_padded(cfg)
    total = nbp[0] * nbp[1] * nbp[2]
    b = torch.div(idx, 4, rounding_mode="floor")
    l = idx - 4 * b
    bid = (b[..., 0] * nbp[1] + b[..., 1]) * nbp[2] + b[..., 2]
    slot = slot_map[torch.clamp(bid, 0, total).long()]
    lane = l[..., 0] * 16 + l[..., 1] * 4 + l[..., 2]
    return slot.long(), lane


def _rows(mini, r0, n):
    return tuple(mini[r0 + k] for k in range(n))


def _near_values(mini, cfg: SimConfig, dt):
    """The plain path's P2G values for the near set: velocity (B, 3),
    mass (B,), the fused affine (B, 3, 3) and the force (B, 3, 3), with
    the formulas of prep_p2g (zero for inactive lanes)."""
    act = mini[RACT] > 0.5
    mass = torch.where(act, mini[RMASS], 0.0)
    vel = mini[RV:RV + 3].t()
    if cfg.particle_gravity:
        vel = vel + const(cfg.gravity, device=mini.device) * float(np.float32(dt))
    force = cforms.dispatch_force(cfg.active_materials, mini[RMAT].view(torch.int32),
                                  _rows(mini, RF, 9), mini[RAUX], _rows(mini, RPAR, 8),
                                  mini[RVOL])
    force = torch.stack([torch.where(act, f, 0.0) for f in force], -1).reshape(-1, 3, 3)
    invD = inv_D(cfg.kernel_order)
    C = mini[RC:RC + 9].t().reshape(-1, 3, 3)
    aff = invD * mass[:, None, None] * C - (invD * cfg.inv_dx * dt) * force
    aff = torch.where(act[:, None, None], aff, 0.0)
    return vel, mass, aff, force


def _body_terms(bodies, nrid, xg, pstates):
    """(rigid velocity at xg, friction) of each node's owner body (zero
    where there is none). The JAX package takes the masked forms for up
    to R_UNROLL_MAX bodies; they select the same values as these indexed
    ones (the same arithmetic per lane), in fewer launches."""
    R = bodies.num
    v = torch.where((nrid >= 0)[..., None],
                    velocity_at(bodies, torch.clamp(nrid, 0, R - 1).long(), xg), 0.0)
    return v, _friction_of(bodies, nrid, pstates)


def _world_nodes(nidx, cfg: SimConfig, world_off):
    """World positions of grid nodes: on a slab the local node plus the
    slab's offset, as the JAX package adds it."""
    xg = nidx.to(torch.float32) * cfg.dx
    return xg if world_off is None else xg + world_off


def summed(sum_fn, J, tau):
    """(J, tau) summed over the ranks by one call of `sum_fn` on the two
    stacked (the sum is elementwise: stacking changes no value); as they
    are where there is no `sum_fn` (one device)."""
    if sum_fn is None:
        return J, tau
    both = sum_fn(torch.stack([J, tau]))
    return both[0], both[1]


def p2g_correction(mini, nd, pm, bodies, rec, cfg: SimConfig, dt, world_off=None):
    """Undo the plain scatter of the near set at colour-incompatible
    nodes and turn it into rigid impulses. rec: (K, 256) node records.
    `cfg` is the grid's config; on a slab its local one, with `world_off`
    (3,) the slab's offset, which takes the node positions back to the
    world for the rigid terms. Returns (rec, J_tot (R, 3), tau_tot
    (R, 3))."""
    K = pm["ids"].shape[0]
    R = bodies.num
    smask = cdf.state_mask(R)
    pstates = mini[RSTATES].view(torch.int32)
    bnormal = mini[RBN:RBN + 3].t()
    vel, mass, aff, force = _near_values(mini, cfg, dt)
    mv_p = mass[:, None] * vel

    nidx, inb, s, nrid = nd["nidx"], nd["inb"], nd["s"], nd["nrid"]
    wo, gradw, dpos = nd["wo"], nd["gradw"], nd["dpos"]
    hit = inb & ~_compatible(s, pstates, smask) & (nrid >= 0)  # (27, B)

    # subtract the plain scatter w (mv + A dpos, m): one ordered scatter of
    # the hit (offset, channel, particle) triples in offset-major order,
    # the order of the JAX package's per-offset, per-channel scatters
    mom = mv_p + mv(aff, dpos)  # (27, B, 3)
    slot, lane = _rec_slot_lane(nidx, pm["slot_map"], cfg)
    lin_base = torch.where(slot < K, slot * REC_LANES, K * REC_LANES) + lane
    chan = torch.arange(4, device=rec.device) * 64
    index = lin_base[:, None, :] + chan[None, :, None]  # (27, 4, B)
    vals = torch.cat([-wo[..., None] * mom, (-wo * mass)[..., None]], -1).transpose(1, 2)
    sel = hit[:, None, :].expand_as(index).reshape(-1)
    # the misses add zero to scratch entries past the records, one each
    # (selecting the hits instead would read their count on the host; a
    # shared scratch entry would make one long chain of equal indices)
    n = sel.numel()
    scratch = (K + 1) * REC_LANES + torch.arange(n, device=rec.device)
    index = torch.where(sel, index.reshape(-1), scratch)
    flat = torch.cat([rec.reshape(-1), rec.new_zeros(REC_LANES + n)])
    index_add_ordered(flat, index, torch.where(sel, vals.reshape(-1), 0.0))

    # rigid impulses (transfer.cpp:241-252)
    xg = _world_nodes(nidx, cfg, world_off)
    rigid_v, fric = _body_terms(bodies, nrid, xg, pstates)
    velb = vel.expand_as(xg)
    dv = velb - friction_project(velb, rigid_v, bnormal.expand_as(xg), fric)
    impulse = (mass * wo)[..., None] * dv + float(np.float32(dt)) * mv(force, gradw)
    if R <= R_UNROLL_MAX:
        J_tot, tau_tot = accumulate_impulses_masked(bodies, nrid, impulse, xg, hit)
    else:
        J_tot, tau_tot = accumulate_impulses(bodies, torch.clamp(nrid, 0, R - 1), impulse, xg,
                                             hit)
    return flat[:K * REC_LANES].reshape(rec.shape), J_tot, tau_tot


def g2p_correction(mini, nd, pm, bodies, vrec, cfg: SimConfig, dt, world_off=None):
    """Per-offset corrections of the near set: the gathered grid velocity
    at incompatible nodes is replaced by the CPIC ghost value. `cfg` and
    `world_off` as in ``p2g_correction``. Returns (dv (B, 3), dB (B, 3, 3),
    rid_last (B,))."""
    K = pm["ids"].shape[0]
    R = bodies.num
    smask = cdf.state_mask(R)
    pv = mini[RV:RV + 3].t()
    pstates = mini[RSTATES].view(torch.int32)
    bnormal = mini[RBN:RBN + 3].t()
    near_b = mini[RNEARB] > 0.5
    B = pv.shape[0]

    nidx, inb, s, nrid = nd["nidx"], nd["inb"], nd["s"], nd["nrid"]
    wo, dpos = nd["wo"], nd["dpos"]
    incompat = inb & ~_compatible(s, pstates, smask)
    slot, lane = _rec_slot_lane(nidx, pm["slot_map"], cfg)
    lin_base = torch.where(slot < K, slot * VREC_LANES, K * VREC_LANES) + lane
    vflat = torch.cat([vrec.reshape(-1), vrec.new_zeros(VREC_LANES)])
    gv = torch.stack([vflat[lin_base + c * 64] for c in range(3)], -1)  # (27, B, 3)

    xg = _world_nodes(nidx, cfg, world_off)
    v_g, fric = _body_terms(bodies, nrid, xg, pstates)
    push = float(np.float32(dt * cfg.dx * cfg.pushing_force))
    pvb = pv.expand_as(xg)
    fake_v = torch.where(near_b[:, None],
                         friction_project(pvb, v_g, bnormal.expand_as(xg), fric) + bnormal * push,
                         pvb)
    delta = torch.where(incompat[..., None], fake_v - gv, 0.0)
    wd = wo[..., None] * delta  # (27, B, 3)
    terms = torch.cat([wd, (wd[..., :, None] * dpos[..., None, :]).flatten(-2)], -1)
    acc = terms[0]
    for o in range(1, terms.shape[0]):  # summed offset by offset, as in the JAX package
        acc = acc + terms[o]
    dv, dB = acc[:, :3], acc[:, 3:].reshape(B, 3, 3)
    # the owner of the last incompatible node in stencil order
    owned = incompat & (nrid >= 0)
    last = owned.shape[0] - 1 - torch.argmax(owned.flip(0).to(torch.int32), 0)
    rid_last = torch.where(owned.any(0), nrid.gather(0, last[None])[0], -1)
    return dv, dB, rid_last


def grown(n: int, cap: int, limit: int, quantum: int) -> int:
    """A capacity after an overflow: 2n rounded up to `quantum`, at most
    `limit` (the sizes the JAX package's MPM re-jits with)."""
    return int(min(limit, -(-2 * n // quantum) * quantum)) if n > cap else cap


def rigid_map(xb, cfg: SimConfig, caps, dilate: int, chk_dilate=None):
    """The rigid page map (cdf.rigid_page_map_checked) at capacity
    caps.Kr, grown at once where its occupancy exceeds it: Kr only sizes
    the record arrays, so a larger map holds the same blocks in the same
    slots and gives the same CDF."""
    HostSyncs.count += 1  # the occupancy n_r is read on the host
    rm = cdf.rigid_page_map_checked(xb, cfg, caps.Kr, dilate, chk_dilate)
    if rm[2] > caps.Kr:
        caps.Kr = grown(rm[2], caps.Kr, blocked.total_blocks_padded(cfg), 64)
        rm = cdf.rigid_page_map_checked(xb, cfg, caps.Kr, dilate, chk_dilate)
    return rm


def _solve_bodies(bodies, scene, dt):
    """The rigid-rigid collision solve and the articulations, on one host
    copy of the bodies (rigid.host; one read of the card, counted)."""
    from taichi_mpm_torch.rigid import articulation as artic
    from taichi_mpm_torch.rigid import collision as coll

    if scene.collision is None and not scene.articulations:
        return bodies
    HostSyncs.count += 1
    hb = HostBodies(bodies)
    if scene.collision is not None:
        coll.rigidify_host(hb, scene.hull_verts_host(), scene.collision,
                           coll.icosphere_directions(), dt)
    artic.articulate_host(hb, scene.articulations, dt)
    return hb.apply_to(bodies)


def rigid_prologue(bodies, scene, cfg: SimConfig, dt, caps, rmap=None, gcfg: SimConfig = None,
                   world_off=None):
    """coupling_iterations x {rigidify, articulate, rasterize CDF}.
    Returns (bodies, ncdf, n_r, xb_world).

    caps.Kr > 0 selects the record-sparse CDF over a rigid page map;
    rmap = (rids, rslot_map, n_r, chk) reuses a lazily kept map, checked
    here against the post-rigidify boundary positions that the rasterize
    uses and rebuilt (dilate=4) when one of them has left the check plane
    (one host sync). Kr = 0 keeps the dense grid arrays.

    On a slab, `gcfg` is the slab's local grid config and `world_off`
    (3,) its offset: the replicated boundary particles and elements,
    shifted by -world_off, are rasterized into the slab's grid window
    (the JAX package's ``xb_g``, ``elem_g``); every rank runs this on the
    same bodies, with no collective."""
    gcfg = cfg if gcfg is None else gcfg
    R = bodies.num
    ncdf, n_r, xb = None, 0, None
    for _ in range(max(1, cfg.coupling_iterations)):
        bodies = _solve_bodies(bodies, scene, dt)
        xb, _, elem_w = boundary_particle_world(bodies, scene.bp_rid, scene.bp_offset,
                                                scene.bp_normal, scene.bp_elem)
        xb_g, elem_g = (xb, elem_w) if world_off is None else (xb - world_off, elem_w - world_off)
        if caps.Kr > 0:
            if rmap is not None and host_read(torch.all(rmap[3][cdf.block_id_of(xb_g, gcfg)])):
                rids, rslot_map, n_r = rmap[:3]
            else:
                rids, rslot_map, n_r, _ = rigid_map(xb_g, gcfg, caps,
                                                    dilate=4 if rmap is not None else 1)
            Kr = rids.shape[0]
            dist_r, rid_r, states_r, key_r = cdf.rasterize_rigid_boundary_records(
                xb_g, elem_g, scene.bp_rid, R, gcfg, rslot_map, Kr, return_key=True)
            ncdf = cdf.RecordNodeCDF(dist_r, rid_r, states_r, rids, rslot_map, Kr, gcfg,
                                     num_rigids=R, key=key_r)
        else:
            dist, rid, states, key = cdf.rasterize_rigid_boundary(
                xb_g, elem_g, scene.bp_rid, R, gcfg, return_key=True)
            ncdf = cdf.DenseNodeCDF(dist, rid, states, gcfg, num_rigids=R, key=key)
            n_r = 0
    return bodies, ncdf, n_r, xb


# -- the near-rigid set -----------------------------------------------------------


def near_rigid_lanes(pm, node_states, cfg: SimConfig, positions, states,
                     fast_stage2: bool = False):
    """The near-rigid set read off the block sort. Stage 1: the sorted
    lane ranges of the blocks holding tagged nodes, dilated by one block
    (the stencil's reach and the lazy sort's half-cell drift); stage 2:
    the lanes whose quadratic stencil touches a tagged node or that carry
    affinity bits, in lane order. `positions(idx)` (n, 3) and
    `states(idx)` (n,) read the lanes' positions and affinity. Returns
    (idx (n_near,) int64, n_near, n_coarse), both counts read on the
    host."""
    nbp = blocked.num_blocks_padded(cfg)
    total = blocked.total_blocks_padded(cfg)
    core = blocked._dilate27(node_states.tagged_blocks().reshape(nbp)).reshape(-1)
    core = torch.cat([core, core.new_zeros(1)])
    ids = pm["ids"].long()
    tagged = core[torch.clamp(ids, max=total)] & (ids < total)
    s_arr = pm["s_arr"]
    e_arr = torch.where(tagged, pm["e_arr"], s_arr)
    n_coarse = host_read((e_arr - s_arr).sum())
    idx1 = blocked.range_lanes(s_arr, e_arr, n_coarse)[1]
    pos = positions(idx1) * cfg.inv_dx
    base, _, _ = bspline_weights(cfg.kernel_order, pos)
    if fast_stage2:
        # one dilated-plane lookup at the stencil centre, exact under the
        # lazy dilate=4 / chk_dilate=1 rigid map
        exact = node_states.stencil_tagged(base.long() + 1)
    else:
        nodes = const(cfg.grid_nodes, torch.int64, pos.device)
        exact = torch.zeros((n_coarse,), dtype=torch.bool, device=pos.device)
        for off in transfer.stencil_offsets(3, cfg.kernel_order):
            nidx = base.long() + const(off, torch.int64, pos.device)
            inb = torch.all((nidx >= 0) & (nidx < nodes), -1)
            s, _, _ = node_states.lookup(nidx, inb)
            exact = exact | (s != 0)
    exact = exact | (states(idx1) != 0)
    idx = idx1[exact]  # stable: the near lanes in coarse order
    HostSyncs.count += 1  # the boolean index reads its size on the host
    return idx, idx.numel(), n_coarse


def local_x(x, world_off):
    """Positions in a slab's local grid frame (x - world_off); `x` itself
    on one device."""
    return x if world_off is None else x - world_off


def compact_near_rigid_ranges(p: Particles, pm, node_states, cfg: SimConfig, world_off=None):
    """The near-rigid set of a sorted Particles set over its page map
    (``near_rigid_lanes``, the exact stage-2 test); on a slab `cfg` is the
    local grid config and the positions are shifted by -world_off.
    Returns (idx, n_near, n_coarse)."""
    return near_rigid_lanes(pm, node_states, cfg, lambda i: local_x(p.x[i], world_off),
                            lambda i: p.states[i])


def compact_near_rigid(p: Particles, grid_states, cfg: SimConfig):
    """The near-rigid set of any Particles set over the dense grid's
    node states: the particles in blocks holding tagged nodes (dilated by
    one block) or carrying affinity bits, in lane order, then the exact
    stencil test. Returns (idx, n_near, n_coarse), read on the host."""
    nodes = cfg.grid_nodes
    nbp = blocked.num_blocks_padded(cfg)
    tag = torch.zeros(tuple(4 * n for n in nbp), dtype=torch.bool, device=p.device)
    tag[: nodes[0], : nodes[1], : nodes[2]] = (grid_states != 0).reshape(nodes)
    core = tag.reshape(nbp[0], 4, nbp[1], 4, nbp[2], 4).any(5).any(3).any(1)
    core = blocked._dilate27(core).reshape(-1)
    touch = core[blocked.block_id_of(p.x, cfg).long()]
    idx1 = torch.nonzero(p.active & (touch | (p.states != 0))).flatten()
    n_coarse = idx1.numel()
    base, _, _ = bspline_weights(cfg.kernel_order, p.x[idx1] * cfg.inv_dx)
    nodes_t = const(nodes, torch.int64, p.device)
    exact = p.states[idx1] != 0
    for off in transfer.stencil_offsets(3, cfg.kernel_order):
        nidx = base.long() + const(off, torch.int64, p.device)
        inb = torch.all((nidx >= 0) & (nidx < nodes_t), -1)
        lin = (nidx[..., 0] * nodes[1] + nidx[..., 1]) * nodes[2] + nidx[..., 2]
        exact = exact | (torch.where(inb, grid_states[torch.where(inb, lin, 0)], 0) != 0)
    idx = idx1[exact]
    HostSyncs.count += 2
    return idx, idx.numel(), n_coarse


# -- the pytree frame ---------------------------------------------------------------


def _gather_rows(p: Particles, origin):
    """The packed rows the gather kernel reads (positions and block
    origins; the other rows zero)."""
    rows = torch.zeros((NCH, p.capacity), dtype=torch.float32, device=p.device)
    rows[RX:RX + 3] = p.x.t()
    rows[RORG:RORG + 3] = origin.t()
    return rows


def cpic_blocked_substep_presorted(p: Particles, pm, bodies, t, cfg: SimConfig, scene, dt,
                                   caps, lcfg: SimConfig = None, world_off=None, origin=None,
                                   grid_colliders=None, exchange_fn=None, sum_fn=None):
    """One coupled substep of a sorted Particles set against its frozen
    page map (``build_page_map_full``); caps.Kr sizes the rigid page map
    (grown where it overflows). Returns ((p, bodies, t + dt), n_near,
    n_coarse, n_r, vmax, plast) with vmax (max |v| component after the
    finish, before the penalty) and plast as 0-d device tensors.

    The slab frames' hooks (``parallel.spatial_blocked``; the JAX
    package's): `lcfg` the slab's local grid config, in which the CDF,
    the page map and the grid update work, and `world_off` (3,) its
    offset (positions stay global); `origin` the particles' block origins
    with the slab's offset already added, so the kernels see one
    device's coordinates; `grid_colliders` the colliders shifted into
    the local frame; `exchange_fn(rec)` the boundary exchange, after the
    P2G correction (each rank un-scatters its own particles from its own
    records first); `sum_fn(x)` the sum over the ranks of each rank's
    impulses, J and tau stacked into one call, twice a substep, before
    they are applied. Every rank calls it, with zeros where its slab has
    no particle near a body. Absent hooks give one device's substep."""
    from taichi_mpm_torch.core.solver import clear_boundary_particles
    from taichi_mpm_torch.rigid.collision import rigid_levelset_collision

    gcfg = cfg if lcfg is None else lcfg
    origin = pm["origin"] if origin is None else origin
    R = bodies.num
    n = p.capacity
    bodies, ncdf, n_r, xb = rigid_prologue(bodies, scene, cfg, dt, caps, gcfg=gcfg,
                                           world_off=world_off)

    # the CDF gather on the near set; affinity rebuilt from zero
    idx, n_near, n_coarse = compact_near_rigid_ranges(p, pm, ncdf, gcfg, world_off)
    near = p.take(idx)
    x_loc = local_x(near.x, world_off)
    nd = cdf.stencil_node_data(x_loc, ncdf, gcfg)
    st_c, bd_c, bn_c, nb_c = cdf.gather_cdf_lookup(x_loc, near.states, R, gcfg, nd)

    def scattered(vals, shape, dtype):
        out = torch.zeros(shape, dtype=dtype, device=p.device)
        out[idx] = vals
        return out

    p = dataclasses.replace(
        p, states=scattered(st_c, (n,), torch.int32), bdist=scattered(bd_c, (n,), torch.float32),
        bnormal=scattered(bn_c, (n, 3), torch.float32), near_b=scattered(nb_c, (n,), torch.bool))
    mini = packed.pack_particles(p.take(idx))

    # plain P2G over all particles, then the correction of the near set
    pdata = prep_p2g(p, None, cfg, dt, origin=origin)
    tiles = p2g.p2g_blocked(pm["s_arr"], pm["e_arr"], pdata)
    del pdata
    rec = blocked.merge_tiles(tiles, pm["nbr"])
    del tiles
    rec, J1, tau1 = p2g_correction(mini, nd, pm, bodies, rec, gcfg, dt, world_off)
    if exchange_fn is not None:
        rec = exchange_fn(rec)
    bodies = apply_impulses(bodies, *summed(sum_fn, J1, tau1))
    if scene.colliders:
        bodies = rigid_levelset_collision(bodies, xb, scene.bp_rid, scene.colliders, t, dt)
    vrec = grid_update_flat(rec, pm["ids"], gcfg,
                            scene.colliders if grid_colliders is None else grid_colliders, t, dt)
    win = blocked.windows(vrec, pm["nbr"])

    # plain G2P over all particles, the correction of the near set, the finish
    pout = g2p.g2p_blocked(pm["slot_keys"], _gather_rows(p, origin), win, cfg)
    del win
    act = p.active
    v_new = torch.where(act[:, None], pout[0:3].t(), 0.0)
    b_new = torch.where(act[:, None, None], pout[3:12].t().reshape(n, 3, 3), 0.0)
    dv, dB, rid_last = g2p_correction(mini, nd, pm, bodies, vrec, gcfg, dt, world_off)
    v_new[idx] += dv  # the near lanes are distinct
    b_new[idx] += dB
    p, plast = transfer.g2p_finish(p, v_new, b_new, cfg, dt, zero_C=p.near_b,
                                   return_count=True)
    vmax = torch.amax(torch.where(p.active[:, None], torch.abs(p.v), 0.0))

    # boundary penetration penalty (transfer.cpp:671-682) on the near set,
    # the only lanes whose affinity fields are set; torque arms at the
    # advected positions
    act_c = p.active[idx]
    pen = act_c & nb_c & (bd_c < -0.05 * cfg.dx) & (bd_c > -0.3 * cfg.dx)
    dvp = bd_c[:, None] * bn_c * cfg.penalty
    v = p.v.clone()
    v[idx] = torch.where(pen[:, None], v[idx] - dvp, v[idx])
    J2, tau2 = accumulate_impulses(bodies, torch.clamp(rid_last, 0, R - 1),
                                   dvp * p.mass[idx][:, None], p.x[idx], pen & (rid_last >= 0))
    p = dataclasses.replace(p, v=v)
    bodies = apply_impulses(bodies, *summed(sum_fn, J2, tau2))
    if cfg.particle_collision:
        p = transfer.particle_collision_resolution(p, cfg, scene.colliders, t)
    if cfg.clean_boundary:
        p = clear_boundary_particles(p, cfg)
    bodies = advance(bodies, t, dt, scene.pos_funcs, scene.rot_funcs, cfg.gravity)
    return (p, bodies, np.float32(t) + np.float32(dt)), n_near, n_coarse, n_r, vmax, plast


def _sort_and_map_full(p: Particles, cfg: SimConfig, K: int):
    """Sort + page map with origins, grown at once where the occupancy
    exceeds K (``ops.packed.sort_and_map``'s rule)."""
    p, keys, _ = blocked.sort_particles(p, cfg)
    pm = build_page_map_full(keys, cfg, K)
    n_act = int(pm["n_act"])
    if n_act > K:
        pm = build_page_map_full(keys, cfg, packed.grown_capacity(n_act, cfg))
    return p, keys, pm


def cpic_blocked_substep(p: Particles, bodies, t, cfg: SimConfig, scene, dt, K: int, caps):
    """One coupled substep with its own sort and page map. Returns ((p,
    bodies, t + dt), n_act, n_near)."""
    p, _, pm = _sort_and_map_full(p, cfg, K)
    (p, bodies, t), n_near, _, _, _, _ = cpic_blocked_substep_presorted(
        p, pm, bodies, t, cfg, scene, dt, caps)
    return (p, bodies, t), int(pm["n_act"]), n_near


def cpic_pack_carry(p: Particles, cfg: SimConfig, K: int):
    """The persistent pytree CPIC carry: (sorted Particles, keys, page map
    with origins, zero drift)."""
    p, keys, pm = _sort_and_map_full(p, cfg, K)
    return (p, keys, pm, np.float32(0.0))


def cpic_frame_carry(carry, bodies, t, cfg: SimConfig, scene, dt, n_substeps: int, caps):
    """A fixed-dt CPIC frame over a persistent pytree carry: the lazy
    re-sort continues across frames (a re-sort after the substep whose
    drift sum(dt * inv_dx * max|v|) reaches 0.45 cell, the last one
    included). One host read per substep for the drift, besides the
    substep's own. Returns (carry, bodies, t, max n_act, max n_near,
    max n_coarse, max n_r, n_sorts, plast)."""
    p, keys, pm, drift = carry
    drift = np.float32(drift)
    step_drift = np.float32(dt * cfg.inv_dx)
    nmax = int(pm["n_act"])
    nnear = ncoarse = nr = nsorts = 0
    plast = torch.zeros((), dtype=torch.int64, device=p.device)
    for _ in range(n_substeps):
        (p, bodies, t), n_near, n_coarse, n_r, vmax, dplast = cpic_blocked_substep_presorted(
            p, pm, bodies, t, cfg, scene, dt, caps)
        drift = drift + step_drift * np.float32(host_read(vmax))
        plast = plast + dplast
        nnear, ncoarse, nr = max(nnear, n_near), max(ncoarse, n_coarse), max(nr, n_r)
        if drift >= packed.DRIFT_BOUND:
            p, keys, pm = _sort_and_map_full(p, cfg, pm["ids"].shape[0])
            drift = np.float32(0.0)
            nsorts += 1
            nmax = max(nmax, int(pm["n_act"]))
    return (p, keys, pm, drift), bodies, t, nmax, nnear, ncoarse, nr, nsorts, plast


def cpic_blocked_frame(p: Particles, bodies, t, cfg: SimConfig, scene, dt, n_substeps: int,
                       K: int, caps):
    """A CPIC frame from a Particles set (sorted first; returned in sorted
    lane order). Returns (p, bodies, t, max n_act, max n_near,
    max n_coarse, max n_r, n_sorts, plast); the sort count includes the
    first sort."""
    carry = cpic_pack_carry(p, cfg, K)
    carry, bodies, t, nmax, nnear, ncoarse, nr, nsorts, plast = cpic_frame_carry(
        carry, bodies, t, cfg, scene, dt, n_substeps, caps)
    return carry[0], bodies, t, nmax, nnear, ncoarse, nr, nsorts + 1, plast
