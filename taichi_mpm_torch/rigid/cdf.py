"""Compatible-Particle-In-Cell (CPIC) grid CDF: rasterize + gather (torch
counterpart of ``taichi_mpm_tpu.rigid.cdf``).

* ``rasterize_rigid_boundary`` / ``rasterize_rigid_boundary_records``:
  rigid surface particles scatter signed distance + colour tags to grid
  nodes, densely over the whole grid (2-D or 3-D) or over the records of
  a rigid page map (3-D). The (min distance, rigid id) pair is a
  scatter-min of one packed int32 key (quantized distance << 8 | rid +
  1), and the 2-bit colour tags are per-rigid scatter-max planes. Both
  reductions are integer, so their result does not depend on the order
  of the writes (on the card they are atomics). In 2-D the ``cdf_expand``
  knob then dilates the tags (``_expand_states_2d``).
* ``gather_cdf`` (dense grid arrays, 2-D or 3-D) and
  ``gather_cdf_lookup`` (any node view): particles acquire affinity bits
  and reconstruct signed distance + normal by weighted least squares over
  colour-compatible nodes.

Bit layout: rigid r owns bits [2r, 2r+1]: bit 2r+1 = "touched", bit 2r =
"negative side" (int32 caps a scene at 12 rigid bodies).
"""

from __future__ import annotations

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.core.transfer import stencil_offsets
from taichi_mpm_torch.math.kernels import bspline_weights
from taichi_mpm_torch.ops import blocked
from taichi_mpm_torch.utils import const, cross

# Distance quantization of the scatter-min key: 20 fractional bits over
# [0, 4) grid units; the low 8 bits hold rigid_id + 1.
_DIST_SCALE = float(1 << 20)
_KEY_INF = int(np.iinfo(np.int32).max)

# MLS reconstruction determinant guards, by dimension.
_GUARD = {2: 3e-3, 3: 1e-4}


def state_mask(num_rigids: int) -> int:
    """All 'touched' bits: 0b10 repeated per rigid."""
    m = 0
    for r in range(num_rigids):
        m |= 2 << (2 * r)
    return m


def explicit_inv(M):
    """Batched adjugate inverse of (..., d, d), d = 2 or 3, with the
    unsigned determinant clamp |det| < 1e-30 -> 1e-30 of the JAX package
    (a tiny negative determinant becomes +1e-30)."""
    if M.shape[-1] == 2:
        a, b, c, dd = M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1]
        det = a * dd - b * c
        inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det)
        return torch.stack([torch.stack([dd * inv_det, -b * inv_det], -1),
                            torch.stack([-c * inv_det, a * inv_det], -1)], -2)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    dm, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - dm * i
    A11 = a * i - c * g
    A12 = c * dm - a * f
    A20 = dm * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * dm
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    return torch.stack([
        torch.stack([A00 * inv_det, A01 * inv_det, A02 * inv_det], -1),
        torch.stack([A10 * inv_det, A11 * inv_det, A12 * inv_det], -1),
        torch.stack([A20 * inv_det, A21 * inv_det, A22 * inv_det], -1),
    ], -2)


def _element_frame_inverse(elem):
    """Per-element frame inverse (v0, Minv) with coords(xg) =
    Minv (xg - v0): columns e1, e2 and the unit normal (in 2-D e1 and
    its unit normal)."""
    v0 = elem[..., 0, :]
    e1 = elem[..., 1, :] - v0
    if elem.shape[-1] == 2:
        n = torch.stack([e1[..., 1], -e1[..., 0]], -1)
        norm = torch.sqrt(n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1])
        n = n / torch.clamp(norm, min=1e-30)[..., None]
        return v0, explicit_inv(torch.stack([e1, n], -1))
    e2 = elem[..., 2, :] - v0
    n = cross(e1, e2)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-30)
    M = torch.stack([e1, e2, n], -1)
    return v0, explicit_inv(M)


def _frame_coords(v0, Minv, xg):
    y = xg - v0
    out = Minv[..., 0] * y[..., 0:1]
    for k in range(1, y.shape[-1]):
        out = out + Minv[..., k] * y[..., k:k + 1]
    return out


def _ravel(idx, nodes):
    lin = idx[..., 0]
    for k in range(1, len(nodes)):
        lin = lin * nodes[k] + idx[..., k]
    return lin


def _stencil_nodes(xb, cfg: SimConfig):
    """(3^d, B, d) int64 node indices of each boundary particle's
    quadratic stencil and their in-grid mask (3^d, B)."""
    base, _, _ = bspline_weights(2, xb * cfg.inv_dx)
    offs = const(stencil_offsets(cfg.dim, 2), torch.int64, xb.device)
    idx = base.long()[None] + offs[:, None, :]
    nodes = const(cfg.grid_nodes, torch.int64, xb.device)
    return idx, torch.all((idx >= 0) & (idx < nodes), -1)


def _raster_values(xb, elem_world, bp_rid, cfg: SimConfig):
    """Per (stencil offset, boundary particle): node index, in-range
    mask, packed key and colour tag, stacked over the 3^d offsets."""
    idx, inb = _stencil_nodes(xb, cfg)
    v0, Minv = _element_frame_inverse(elem_world)
    xg = idx.to(torch.float32) * cfg.dx
    coord = _frame_coords(v0[None], Minv[None], xg)
    h = coord[..., cfg.dim - 1]
    if cfg.dim == 2:
        in_range = (coord[..., 0] >= -0.02) & (coord[..., 0] <= 1.02)
    else:
        in_range = ((coord[..., 0] >= 0) & (coord[..., 1] >= 0)
                    & (coord[..., 0] + coord[..., 1] <= 1.0))
    dist_gu = torch.abs(h) * cfg.inv_dx
    q = torch.clamp(dist_gu * _DIST_SCALE, max=_DIST_SCALE * 4 - 1).to(torch.int32)
    key = (q << 8) | (bp_rid[None] + 1)
    tag = 2 + (h < 0.0).to(torch.int32)
    return idx, inb & in_range, key, tag


def _reduce_planes(N, lin, valid, key, tag, bp_rid, num_rigids, device):
    """Scatter-min of the keys and scatter-max of the tags at rows `lin`
    (invalid writes go to row N, dropped). Returns (key (N,), states
    (N,))."""
    rid = bp_rid[None].expand_as(lin).long()
    lin = torch.where(valid, lin, N).reshape(-1)
    keys = torch.full((N + 1,), _KEY_INF, dtype=torch.int32, device=device)
    keys.scatter_reduce_(0, lin, torch.where(valid, key, _KEY_INF).reshape(-1), "amin")
    tags = torch.zeros(((N + 1) * num_rigids,), dtype=torch.int32, device=device)
    tags.scatter_reduce_(0, lin * num_rigids + rid.reshape(-1),
                         torch.where(valid, tag, 0).reshape(-1), "amax")
    shifts = torch.arange(num_rigids, dtype=torch.int32, device=device) * 2
    states = torch.sum(tags.reshape(N + 1, num_rigids) << shifts, 1, dtype=torch.int32)
    return keys[:N], states[:N]


def _decode_key(key, cfg: SimConfig):
    has = key != _KEY_INF
    rid = torch.where(has, (key & 0xFF) - 1, -1)
    dist = torch.where(has, (key >> 8).to(torch.float32) / _DIST_SCALE * cfg.dx, 0.0)
    return dist, rid


def rasterize_rigid_boundary(xb, elem_world, bp_rid, num_rigids: int, cfg: SimConfig,
                             return_key: bool = False):
    """Rigid boundary particles (B, d) with their world elements (B, d, d)
    -> dense grid CDF: (grid_dist (N,) world-unit unsigned distance,
    grid_rid (N,) nearest rigid (-1 none), grid_states (N,) colour tags
    [, the scatter-min key plane]). In 2-D, cfg.cdf_expand passes of
    ``_expand_states_2d`` dilate the tags."""
    nodes = cfg.grid_nodes
    N = int(np.prod(nodes))
    idx, valid, key, tag = _raster_values(xb, elem_world, bp_rid, cfg)
    lin = torch.where(valid, _ravel(idx, nodes), 0)
    key_plane, states = _reduce_planes(N, lin, valid, key, tag, bp_rid, num_rigids, xb.device)
    dist, rid = _decode_key(key_plane, cfg)
    if cfg.dim == 2 and cfg.cdf_expand:
        states = _expand_states_2d(states, num_rigids, cfg, int(cfg.cdf_expand))
    if return_key:
        return dist, rid, states, key_plane
    return dist, rid, states


def _expand_states_2d(grid_states, num_rigids: int, cfg: SimConfig, passes: int):
    """The 2-D tag dilation of the ``cdf_expand`` knob: per pass and axis,
    interior nodes adopt the tag and sign bits of their two neighbours
    for the rigids that do not touch them yet. Neighbours are read from
    the grid before the axis's update (a roll with the wrapped border row
    zeroed), the two neighbour updates composed in sequence, the two axes
    one after the other; the first and the last two rows of the axis keep
    their states. Integer work: the JAX package's bits."""
    nodes = cfg.grid_nodes
    touched = state_mask(num_rigids)
    s = grid_states.reshape(nodes)

    def upd(state, nei):
        add = (nei & ~state) & touched
        return state | (nei & (add | (add >> 1)))

    for _ in range(passes):
        for k in range(2):
            nei_p = torch.roll(s, -1, dims=k)
            nei_m = torch.roll(s, 1, dims=k)
            nei_p.narrow(k, nodes[k] - 1, 1).zero_()
            nei_m.narrow(k, 0, 1).zero_()
            s2 = upd(upd(s, nei_p), nei_m)
            interior = torch.ones(nodes, dtype=torch.bool, device=s.device)
            interior.narrow(k, 0, 1).fill_(False)
            interior.narrow(k, nodes[k] - 2, 2).fill_(False)
            s = torch.where(interior, s2, s)
    return s.reshape(-1)


# -- record-sparse CDF over a rigid page map ------------------------------------


def rigid_page_map(xb, cfg: SimConfig, Kr: int, dilate: int = 1):
    """Compacted block set near rigid boundary particles: their blocks
    `dilate` times 27-dilated. Returns (rids (Kr,) ascending padded block
    ids, rslot_map (total+1,), n_r true occupancy)."""
    rids, rslot_map, n_r, _ = rigid_page_map_checked(xb, cfg, Kr, dilate)
    return rids, rslot_map, n_r


def block_id_of(x, cfg: SimConfig):
    """Padded block id of world positions x (..., 3), int64."""
    return blocked.block_id_of(x, cfg).long()


def rigid_page_map_checked(xb, cfg: SimConfig, Kr: int, dilate: int = 2,
                           chk_dilate: int = None):
    """rigid_page_map + a staleness-check plane for lazy reuse: chk
    (total+1,) bool = the boundary-particle blocks dilated `chk_dilate`
    times (default dilate-1); the map stays valid while every boundary
    particle's block is in chk. The margins (in blocks): rasterize writes
    need chk_dilate + 1 <= dilate; the compaction's fast stage-2 test
    needs chk_dilate + 3 <= dilate (dilate=4, chk_dilate=1).

    Returns (rids, rslot_map, n_r, chk) with n_r a Python int (read on
    the host: the map's size depends on it). Slots past Kr are dropped,
    as in the JAX package; the caller grows Kr when n_r > Kr."""
    if chk_dilate is None:
        chk_dilate = dilate - 1
    if chk_dilate + 1 > dilate:
        raise ValueError("chk_dilate + 1 must not exceed dilate")
    nbp = blocked.num_blocks_padded(cfg)
    total = blocked.total_blocks_padded(cfg)
    dev = xb.device
    occ = torch.zeros((total,), dtype=torch.bool, device=dev)
    occ[block_id_of(xb, cfg)] = True
    occ = occ.reshape(nbp)
    chk = occ
    for i in range(dilate):
        if i == chk_dilate:
            chk = occ
        occ = blocked._dilate27(occ)
    occ_ids = torch.nonzero(occ.reshape(-1)).flatten().to(torch.int32)
    n_r = occ_ids.numel()
    rids = torch.full((Kr,), total, dtype=torch.int32, device=dev)
    m = min(Kr, n_r)
    rids[:m] = occ_ids[:m]
    rslot_map = torch.full((total + 1,), Kr, dtype=torch.int32, device=dev)
    rslot_map[rids[:m].long()] = torch.arange(m, dtype=torch.int32, device=dev)
    chk_flat = torch.cat([chk.reshape(-1), torch.zeros((1,), dtype=torch.bool, device=dev)])
    return rids, rslot_map, n_r, chk_flat


def _node_to_record(idx, rslot_map, Kr: int, cfg: SimConfig):
    """Node index (..., 3) -> (record row in [0, Kr*64], ok): row Kr*64
    is the zero sentinel."""
    nbp = blocked.num_blocks_padded(cfg)
    total = nbp[0] * nbp[1] * nbp[2]
    b = torch.div(idx, 4, rounding_mode="floor")
    l = idx - b * 4
    bid = (b[..., 0] * nbp[1] + b[..., 1]) * nbp[2] + b[..., 2]
    rs = rslot_map[torch.clamp(bid, 0, total).long()]
    ok = rs < Kr
    lane = l[..., 0] * 16 + l[..., 1] * 4 + l[..., 2]
    row = torch.where(ok, rs.long() * 64 + lane, Kr * 64)
    return row, ok


def rasterize_rigid_boundary_records(xb, elem_world, bp_rid, num_rigids: int, cfg: SimConfig,
                                     rslot_map, Kr: int, return_key: bool = False):
    """Rigid boundary particles -> CDF node records (Kr*64 + 1,), the last
    row the zero sentinel: the dense rasterize's math on the rigid page
    map's records."""
    N = Kr * 64 + 1
    idx, valid, key, tag = _raster_values(xb, elem_world, bp_rid, cfg)
    row, ok = _node_to_record(idx, rslot_map, Kr, cfg)
    valid = valid & ok
    lin = torch.where(valid, row, N - 1)
    key_rec, states = _reduce_planes(N, lin, valid, key, tag, bp_rid, num_rigids, xb.device)
    key_rec[N - 1] = _KEY_INF
    states[N - 1] = 0
    dist, rid = _decode_key(key_rec, cfg)
    if return_key:
        return dist, rid, states, key_rec
    return dist, rid, states


def _pack_cdf_plane(key, states, num_rigids):
    """One int32 plane holding (states, rid, dist) per node, so a lookup
    is one gather instead of three (R <= 3 only): bits 0..2R-1 states,
    bits 6-7 rid+1, bits 8-29 the quantized distance, taken verbatim from
    the scatter-min key so the decode is bitwise the stored planes'.
    None when R > 3."""
    if num_rigids is None or num_rigids > 3 or key is None:
        return None
    has = key != _KEY_INF
    pk = torch.where(has, (key & ~0xFF) | ((key & 0xFF) << 6), 0)
    return pk | states


def _unpack_cdf(pk, num_rigids: int, cfg: SimConfig):
    s = pk & ((1 << (2 * num_rigids)) - 1)
    rid = ((pk >> 6) & 3) - 1
    dist = (pk >> 8).to(torch.float32) / _DIST_SCALE * cfg.dx
    return s, rid, dist


def _dilated_center_offsets(device):
    return const([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)],
                 torch.int64, device)


class DenseNodeCDF:
    """Uniform view over the dense (N_nodes,) CDF arrays; num_rigids <= 3
    with the key plane enables the packed single-plane lookup."""

    def __init__(self, grid_dist, grid_rid, grid_states, cfg: SimConfig,
                 num_rigids: int = None, key=None):
        self.dist, self.rid, self.states, self.cfg = grid_dist, grid_rid, grid_states, cfg
        self.R = num_rigids
        self.pk = _pack_cdf_plane(key, grid_states, num_rigids)

    def lookup(self, idx, inb):
        """-> (states, rid, dist_world) at node indices idx (..., 3)."""
        lin = torch.where(inb, _ravel(idx, self.cfg.grid_nodes), 0).long()
        if self.pk is not None:
            # pk = 0 decodes to (states 0, rid -1, dist 0): the masked values
            return _unpack_cdf(torch.where(inb, self.pk[lin], 0), self.R, self.cfg)
        s = torch.where(inb, self.states[lin], 0)
        rid = torch.where(inb, self.rid[lin], -1)
        dist = torch.where(inb, self.dist[lin], 0.0)
        return s, rid, dist

    def tagged_blocks(self):
        """(total_blocks_padded,) bool: blocks containing tagged nodes."""
        cfg = self.cfg
        nodes = cfg.grid_nodes
        nbp = blocked.num_blocks_padded(cfg)
        tag = torch.zeros(tuple(4 * n for n in nbp), dtype=torch.bool, device=self.states.device)
        tag[: nodes[0], : nodes[1], : nodes[2]] = (self.states != 0).reshape(nodes)
        return tag.reshape(nbp[0], 4, nbp[1], 4, nbp[2], 4).any(5).any(3).any(1).reshape(-1)

    def tag_dilated_center(self):
        """(N_nodes,) bool: D[c] = OR over e in {-1,0,1}^3 of
        (states[c+e] != 0)."""
        tag = (self.states != 0).reshape(self.cfg.grid_nodes)
        return blocked._dilate27(tag).reshape(-1)

    def stencil_tagged(self, center):
        """OR of (states != 0) over the quadratic stencil whose centre
        node is `center` (..., 3): one gather into the dilated plane."""
        nodes = const(self.cfg.grid_nodes, torch.int64, center.device)
        c = torch.minimum(torch.clamp(center, min=0), nodes - 1)
        return self.tag_dilated_center()[_ravel(c, self.cfg.grid_nodes).long()]


class RecordNodeCDF:
    """Uniform view over the record-sparse (Kr*64 + 1,) CDF arrays."""

    def __init__(self, dist_rec, rid_rec, states_rec, rids, rslot_map, Kr: int,
                 cfg: SimConfig, num_rigids: int = None, key=None):
        self.dist, self.rid, self.states = dist_rec, rid_rec, states_rec
        self.rids, self.rslot_map, self.Kr, self.cfg = rids, rslot_map, Kr, cfg
        self.R = num_rigids
        self.pk = _pack_cdf_plane(key, states_rec, num_rigids)

    def lookup(self, idx, inb):
        row, ok = _node_to_record(idx, self.rslot_map, self.Kr, self.cfg)
        row = torch.where(inb & ok, row, self.Kr * 64)
        if self.pk is not None:
            # the sentinel row holds pk = 0 -> (0, -1, 0.0)
            return _unpack_cdf(self.pk[row], self.R, self.cfg)
        rid = torch.where(inb & ok, self.rid[row], -1)
        return self.states[row], rid, self.dist[row]

    def tagged_blocks(self):
        total = blocked.total_blocks_padded(self.cfg)
        has = torch.any(self.states[: self.Kr * 64].reshape(self.Kr, 64) != 0, 1)
        out = torch.zeros((total + 1,), dtype=torch.bool, device=has.device)
        # unused slots (rids = total) write False into the dropped last entry
        out[torch.clamp(self.rids, max=total).long()] = has & (self.rids < total)
        return out[:total]

    def tag_dilated_center(self):
        """(Kr*64 + 1,) bool D with D[row(c)] = OR over e in {-1,0,1}^3 of
        (states[c+e] != 0), a neighbour off the map or off the padded
        block space counting as untagged (exact when the map holds every
        tagged block, as the lazy dilate=4 / chk_dilate=1 map guarantees
        for the candidates). Each record's 6^3 neighbourhood is assembled
        from its 27 neighbour blocks' tag planes and OR-dilated by a 3^3
        max pool."""
        cfg, Kr = self.cfg, self.Kr
        nbp = blocked.num_blocks_padded(cfg)
        total = nbp[0] * nbp[1] * nbp[2]
        dev = self.states.device
        bid = torch.clamp(self.rids, max=total).long()
        live = bid < total
        safe = torch.clamp(bid, max=total - 1)
        bco = torch.stack([safe // (nbp[1] * nbp[2]), (safe // nbp[2]) % nbp[1], safe % nbp[2]], -1)
        e = _dilated_center_offsets(dev)  # (27, 3), x-major
        nb = bco[:, None, :] + e[None]  # (Kr, 27, 3) neighbour block coords
        ok = torch.all((nb >= 0) & (nb < const(nbp, torch.int64, dev)), -1) & live[:, None]
        nbid = (nb[..., 0] * nbp[1] + nb[..., 1]) * nbp[2] + nb[..., 2]
        ns = self.rslot_map[torch.where(ok, nbid, total)].long()  # Kr where absent
        T = torch.cat([(self.states[: Kr * 64] != 0).reshape(Kr, 4, 4, 4),
                       torch.zeros((1, 4, 4, 4), dtype=torch.bool, device=dev)])
        E = T[ns].reshape(Kr, 3, 3, 3, 4, 4, 4).permute(0, 1, 4, 2, 5, 3, 6)
        E = E.reshape(Kr, 12, 12, 12)[:, 3:9, 3:9, 3:9]  # nodes -1..4 of the block
        D = torch.nn.functional.max_pool3d(E.to(torch.float32)[:, None], 3, stride=1) > 0.5
        return torch.cat([D.reshape(-1), torch.zeros((1,), dtype=torch.bool, device=dev)])

    def stencil_tagged(self, center):
        """OR of (states != 0) over the quadratic stencil centred at
        `center`: one record gather into the dilated plane."""
        row, ok = _node_to_record(center, self.rslot_map, self.Kr, self.cfg)
        return self.tag_dilated_center()[torch.where(ok, row, self.Kr * 64)]


# -- gather ------------------------------------------------------------------------


def stencil_node_data(p_x, ncdf, cfg: SimConfig, order: int = 2):
    """Per-offset node lookups + weights of each particle's B-spline
    stencil (quadratic, the CDF gather's, unless `order` names another),
    computed once and shared by the CDF gather and both transfers or
    correction passes, stacked over the K offsets (leading axis):
    dict(nidx (K,B,d) int64, inb, s, nrid, dist_world, wo (K,B),
    gradw (K,B,d), dpos (K,B,d))."""
    d = cfg.dim
    pos = p_x * cfg.inv_dx
    base, w, dw = bspline_weights(order, pos)
    o = const(stencil_offsets(d, order), torch.int64, p_x.device)
    nidx = base.long()[None] + o[:, None, :]
    nodes = const(cfg.grid_nodes, torch.int64, p_x.device)
    inb = torch.all((nidx >= 0) & (nidx < nodes), -1)
    s, nrid, dist = ncdf.lookup(nidx, inb)
    # per-axis weights and gradients at each offset: (K, B) each
    wa = [w[:, k, o[:, k]].t() for k in range(d)]
    da = [dw[:, k, o[:, k]].t() for k in range(d)]
    wo = wa[0]
    for k in range(1, d):
        wo = wo * wa[k]
    grads = []
    for k in range(d):  # d_k w_k times the other axes' weights, in axis order
        g = da[k]
        for j in range(d):
            if j != k:
                g = g * wa[j]
        grads.append(g * cfg.inv_dx)
    dpos = pos[None] - nidx.to(pos.dtype)
    return dict(nidx=nidx, inb=inb, s=s, nrid=nrid, dist=dist, wo=wo,
                gradw=torch.stack(grads, -1), dpos=dpos)


def _det(M):
    """Determinants of the m x m matrices M (a nested list of tensors) by
    cofactor expansion along the first row, as the JAX package's det_ll
    writes it: each minor expanded the same way, the odd terms negated and
    added (the same bits as subtracting them)."""
    if len(M) == 1:
        return M[0][0]
    acc = None
    for j in range(len(M)):
        term = M[0][j] * _det([[row[c] for c in range(len(M)) if c != j] for row in M[1:]])
        acc = term if acc is None else (acc - term if j % 2 else acc + term)
    return acc


def gather_cdf(p_x, p_states, grid_dist, grid_rid, grid_states, num_rigids: int,
               cfg: SimConfig):
    """The CDF gather over dense (N_nodes,) grid arrays (2-D or 3-D): the
    dense path's ``gather_cdf_lookup``. Returns (states, bdist, bnormal,
    near_b)."""
    ncdf = DenseNodeCDF(grid_dist, grid_rid, grid_states, cfg)
    return gather_cdf_lookup(p_x, p_states, num_rigids, cfg,
                             stencil_node_data(p_x, ncdf, cfg))


def gather_cdf_lookup(p_x, p_states, num_rigids: int, cfg: SimConfig, node_data):
    """Grid CDF -> particle affinity + boundary distance/normal over the
    shared stencil data of ``stencil_node_data``. Returns (states, bdist,
    bnormal, near_b): updated affinity, signed boundary distance (world
    units), unit normal, near-boundary flag. The per-offset terms are
    computed for all 3^d offsets at once and summed offset by offset, in
    the JAX package's order."""
    P = p_x.shape[0]
    R = num_rigids
    d = cfg.dim
    m = d + 1
    smask = state_mask(R)
    dev = p_x.device
    S = node_data["s"]  # (3^d, P)
    n_off = S.shape[0]
    dist_g = node_data["dist"] * cfg.inv_dx  # grid units
    wo = node_data["wo"]

    # pass 1: affinity update
    rr = torch.arange(R, dtype=torch.int32, device=dev)
    touch = ((S[..., None] >> (2 * rr + 1)) & 1).to(torch.float32)  # (3^d, P, R)
    neg = ((S[..., None] >> (2 * rr)) & 1).to(torch.float32)
    all_b = torch.sum(touch.amax(0).to(torch.int32) << (2 * rr + 1), -1, dtype=torch.int32)
    wd = (wo * dist_g)[..., None] * touch
    terms = torch.stack([wd * (1.0 - neg), wd * neg], 1)  # (3^d, 2, P, R)
    wd_pn = terms[0]
    for o in range(1, n_off):
        wd_pn = wd_pn + terms[o]
    wd_pos, wd_neg = wd_pn[0], wd_pn[1]

    # drop affinity with rigids no longer near
    states = p_states & (all_b | (all_b >> 1))
    rr = rr[None, :]
    avail = ((all_b[:, None] >> (2 * rr + 1)) & 1) == 1
    have = ((states[:, None] >> (2 * rr + 1)) & 1) == 1
    add = avail & (~have) & ((wd_pos + wd_neg) > 1e-7)
    neg_bit = (wd_pos < wd_neg).to(torch.int32)
    new_tags = torch.where(add, 2 + neg_bit, 0)
    states = states | torch.sum(new_tags << (2 * rr), 1, dtype=torch.int32)

    # pass 2: weighted MLS reconstruction with the final states; the
    # (d+1)^2 normal equations accumulated and solved componentwise
    # (Cramer)
    mask = (S & states & smask) >> 1
    same = (S & mask) == (states & mask)
    diff = (S ^ states) & mask
    single_neg = (diff != 0) & ((diff & (diff - 1)) == 0)
    use = (S != 0) & (same | single_neg)
    sign = torch.where(same, 1.0, -1.0)
    wgt = torch.where(use, wo, 0.0)
    dpos = node_data["dpos"]  # (3^d, P, d)
    xp = torch.stack([-dpos[..., k] for k in range(d)] + [torch.ones_like(dpos[..., 0])],
                     1)  # (3^d, m, P)
    wx = wgt[:, None] * xp
    upper = [(i, j) for i in range(m) for j in range(i, m)]
    iu = const([i for i, _ in upper], torch.int64, dev)
    ju = const([j for _, j in upper], torch.int64, dev)
    terms = torch.cat([wx[:, iu] * xp[:, ju], (wgt * sign * dist_g)[:, None] * xp], 1)
    acc = terms[0]  # XtX upper triangle, then XtY
    for o in range(1, n_off):
        acc = acc + terms[o]
    nu = len(upper)
    XtX = [[None] * m for _ in range(m)]
    for k, (i, j) in enumerate(upper):
        XtX[i][j] = XtX[j][i] = acc[k]
    XtY = [acc[nu + i] for i in range(m)]
    # the matrix and its m Cramer replacements (column j <- XtY), stacked
    mats = [[torch.stack([XtX[r][c]] + [XtY[r] if c == j else XtX[r][c] for j in range(m)])
             for c in range(m)] for r in range(m)]
    dets = _det(mats)
    det = dets[0]
    ok = (torch.abs(det) > _GUARD[d]) & (states != 0)
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    r = [dets[j + 1] * inv_det for j in range(m)]

    near_b = ok
    bdist = torch.where(ok, r[d] * cfg.dx, 0.0)
    glen2 = r[0] * r[0]
    for k in range(1, d):
        glen2 = glen2 + r[k] * r[k]
    gok = ok & (glen2 > 1e-4)
    gscale = 1.0 / torch.clamp(torch.sqrt(glen2), min=1e-30)
    bnormal = torch.stack([torch.where(gok, r[k] * gscale, 0.0) for k in range(d)], -1)
    return states, bdist, bnormal, near_b
