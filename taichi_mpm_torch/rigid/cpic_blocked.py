"""CPIC compute-then-correct helpers (torch counterpart of the helpers of
``taichi_mpm_tpu.rigid.cpic_blocked`` that the packed CPIC frame uses).

All particles run the plain blocked P2G/G2P; the particles near rigid
surfaces, compacted into a small set, then get a sparse correction:

* ``p2g_correction`` subtracts their contributions at colour-incompatible
  nodes from the node records and turns them into rigid impulses;
* ``g2p_correction`` replaces what they gathered from incompatible nodes
  by the CPIC ghost velocity;

with the same weights and fused-force values as the plain path, so the
combination is the reference's coloured transfers. ``rigid_prologue`` is
the per-substep rigid prologue {rigidify, articulate, rasterize CDF}.

The near set is given as ``mini``: the (48, B) packed rows of its lanes
(row map in ``ops/rows.py``) and ``nd``, its shared stencil data
(``cdf.stencil_node_data``, 27 offsets stacked on a leading axis). The
pytree frame of the JAX module (its ``TMT_FUSED=0`` route) is not ported
(ROADMAP.md queue 1, "the rest of CPIC").
"""

from __future__ import annotations

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core.levelset import friction_project
from taichi_mpm_torch.materials import cforms
from taichi_mpm_torch.math.kernels import inv_D
from taichi_mpm_torch.ops import blocked
from taichi_mpm_torch.ops.blocked import REC_LANES, VREC_LANES
from taichi_mpm_torch.ops.rows import (
    RACT, RAUX, RBN, RC, RF, RMASS, RMAT, RNEARB, RPAR, RSTATES, RV, RVOL,
)
from taichi_mpm_torch.rigid import cdf
from taichi_mpm_torch.rigid.body import (
    R_UNROLL_MAX,
    accumulate_impulses,
    accumulate_impulses_masked,
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


def p2g_correction(mini, nd, pm, bodies, rec, cfg: SimConfig, dt):
    """Undo the plain scatter of the near set at colour-incompatible
    nodes and turn it into rigid impulses. rec: (K, 256) node records.
    Returns (rec, J_tot (R, 3), tau_tot (R, 3))."""
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
    xg = nidx.to(torch.float32) * cfg.dx
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


def g2p_correction(mini, nd, pm, bodies, vrec, cfg: SimConfig, dt):
    """Per-offset corrections of the near set: the gathered grid velocity
    at incompatible nodes is replaced by the CPIC ghost value. Returns
    (dv (B, 3), dB (B, 3, 3), rid_last (B,))."""
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

    xg = nidx.to(torch.float32) * cfg.dx
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


def rigid_prologue(bodies, scene, cfg: SimConfig, dt, caps, rmap=None):
    """coupling_iterations x {rigidify, articulate, rasterize CDF}.
    Returns (bodies, ncdf, n_r, xb_world).

    caps.Kr > 0 selects the record-sparse CDF over a rigid page map;
    rmap = (rids, rslot_map, n_r, chk) reuses a lazily kept map, checked
    here against the post-rigidify boundary positions that the rasterize
    uses and rebuilt (dilate=4) when one of them has left the check plane
    (one host sync). Kr = 0 keeps the dense grid arrays."""
    R = bodies.num
    ncdf, n_r, xb = None, 0, None
    for _ in range(max(1, cfg.coupling_iterations)):
        bodies = _solve_bodies(bodies, scene, dt)
        xb, _, elem_w = boundary_particle_world(bodies, scene.bp_rid, scene.bp_offset,
                                                scene.bp_normal, scene.bp_elem)
        if caps.Kr > 0:
            if rmap is not None and host_read(torch.all(rmap[3][cdf.block_id_of(xb, cfg)])):
                rids, rslot_map, n_r = rmap[:3]
            else:
                rids, rslot_map, n_r, _ = rigid_map(xb, cfg, caps,
                                                    dilate=4 if rmap is not None else 1)
            Kr = rids.shape[0]
            dist_r, rid_r, states_r, key_r = cdf.rasterize_rigid_boundary_records(
                xb, elem_w, scene.bp_rid, R, cfg, rslot_map, Kr, return_key=True)
            ncdf = cdf.RecordNodeCDF(dist_r, rid_r, states_r, rids, rslot_map, Kr, cfg,
                                     num_rigids=R, key=key_r)
        else:
            dist, rid, states, key = cdf.rasterize_rigid_boundary(
                xb, elem_w, scene.bp_rid, R, cfg, return_key=True)
            ncdf = cdf.DenseNodeCDF(dist, rid, states, cfg, num_rigids=R, key=key)
            n_r = 0
    return bodies, ncdf, n_r, xb
