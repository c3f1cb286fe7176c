"""Rigid-rigid collision + rigid-vs-levelset collision (torch counterpart
of ``taichi_mpm_tpu.rigid.collision``, 3-D only).

Penetration between all non-(both-)scripted pairs is a sampled-support
separating-axis test over the convex hulls of the mesh vertices: depth
along K fixed icosphere directions d is s(d) = max_a d.a - min_b d.b; the
minimum translation direction is the argmin over the samples (first
index on ties), and the contact point is the midpoint of the mean
witness vertices of the two support planes. Resolution is ``iterations``
rounds of positional penalty + velocity impulses with sqrt-combined
friction/restitution, then ``iterations`` more velocity rounds. Detection
and resolution run on a host copy of the bodies (``rigid/host.py``); the
level-set collision of the boundary particles runs as tensor ops on
their device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from taichi_mpm_torch.rigid.body import (
    RigidBodies,
    accumulate_impulses,
    apply_impulses,
    impulse_contribution,
    velocity_at,
)
from taichi_mpm_torch.rigid.host import HostBodies, dot, dot_fma, rotate


@functools.lru_cache(maxsize=None)
def icosphere_directions(subdiv: int = 2) -> np.ndarray:
    """Unit direction samples (K, 3) from an icosphere (K=162 at subdiv 2)."""
    from taichi_mpm_torch.rigid.mesh import sphere_mesh

    tris = sphere_mesh(1.0, subdiv=subdiv)
    verts = np.unique(tris.reshape(-1, 3).round(6), axis=0)
    return (verts / np.linalg.norm(verts, axis=1, keepdims=True)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class CollisionConfig:
    """Static collision setup: candidate pairs (i < j, background
    excluded)."""

    pairs: Tuple[Tuple[int, int], ...]
    iterations: int = 5
    penalty: float = 1e3


def hull_vertices(bp_list, dim: int, max_verts: int = 512) -> np.ndarray:
    """Per-rigid deduplicated mesh vertices (R, V, d), padded by repeating
    the first vertex (harmless for support functions)."""
    out = []
    for elems in bp_list:
        v = np.unique(np.asarray(elems, np.float32).reshape(-1, dim).round(7), axis=0)
        if len(v) > max_verts:
            v = v[np.linspace(0, len(v) - 1, max_verts).astype(int)]
        out.append(v)
    V = max(len(v) for v in out) if out else 1
    padded = np.zeros((len(out), V, dim), np.float32)
    for r, v in enumerate(out):
        padded[r, : len(v)] = v
        padded[r, len(v):] = v[0]
    return padded


def detect(bodies: RigidBodies, verts_body, pairs, dirs, host=None):
    """Sampled-SAT penetration for all candidate pairs (numpy, float32).
    verts_body (R, V, 3) and dirs (K, 3) are numpy arrays. Returns (hit
    (P,), depth (P,), normal (P, 3), point (P, 3)); the normal points from
    body i toward body j; ties of the sampled depth take the first
    direction."""
    hb = host or HostBodies(bodies)
    ii = np.asarray([p[0] for p in pairs])
    jj = np.asarray([p[1] for p in pairs])
    va = hb.pos[ii][:, None, :] + rotate(hb.rot[ii][:, None, :], verts_body[ii])
    vb = hb.pos[jj][:, None, :] + rotate(hb.rot[jj][:, None, :], verts_body[jj])
    da = dot_fma(va[:, None, :, :], dirs[None, :, None, :])  # (P, K, V)
    db = dot_fma(vb[:, None, :, :], dirs[None, :, None, :])
    s = da.max(-1) - db.min(-1)  # penetration along each direction
    depth = s.min(1)
    kstar = np.argmin(s, 1)
    normal = dirs[kstar]
    pk = np.arange(len(pairs))
    pa, pb = da[pk, kstar], db[pk, kstar]  # (P, V) projections on the normal
    band = 1e-5 + 0.1 * np.maximum(depth, np.float32(0.0))[:, None]
    wa = (pa >= pa.max(-1, keepdims=True) - band).astype(np.float32)
    wb = (pb <= pb.min(-1, keepdims=True) + band).astype(np.float32)
    # the witness means summed in XLA's order (xla_sum): a symmetric
    # contact lies on the body's axis only if it rounds as in the
    # reference, and an impulse there has an arm of exactly zero
    a_star = xla_sum(wa[..., None] * va, 1) / np.sum(wa, 1)[:, None]
    b_star = xla_sum(wb[..., None] * vb, 1) / np.sum(wb, 1)[:, None]
    return depth > 0.0, depth, normal, 0.5 * (a_star + b_star)


_XLA_WINDOW = 32


def xla_sum(a, axis):
    """A float32 sum over `axis` in the order XLA's CPU backend adds it
    (its tree-reduction rewrite): up to 32 terms one after the other from
    0; more are zero-padded evenly at both ends to a multiple of 32, each
    window of 32 summed in order, and the window sums summed the same
    way."""
    a = np.moveaxis(np.asarray(a, np.float32), axis, 0)
    n = a.shape[0]
    if n > _XLA_WINDOW:
        pad = -(-n // _XLA_WINDOW) * _XLA_WINDOW - n
        widths = [(pad // 2, pad - pad // 2)] + [(0, 0)] * (a.ndim - 1)
        a = np.pad(a, widths).reshape((-1, _XLA_WINDOW) + a.shape[1:])
        return xla_sum(xla_sum(a, 1), 0)
    acc = np.zeros(a.shape[1:], np.float32)
    for term in a:
        acc = acc + term
    return acc


_ZERO = np.float32(0.0)
_TINY = np.float32(1e-30)


def _project_velocity(hb, i, j, p, n, hit):
    """Collision::project_velocity: restitution impulse, then a clamped
    Coulomb friction impulse."""
    fric = np.sqrt(hb.friction[i, 0] * hb.friction[j, 0])
    rest = np.sqrt(hb.restitution[i] * hb.restitution[j])
    v10 = hb.velocity_at(j, p) - hb.velocity_at(i, p)
    r0 = p - hb.pos[i]
    r1 = p - hb.pos[j]
    v0 = -dot(n, v10)
    K = hb.impulse_contribution(i, r0, n) + hb.impulse_contribution(j, r1, n)
    J = (1.0 + rest) * v0 / max(K, _TINY)
    J = J if (hit and J > 0) else _ZERO
    hb.pair_impulse(i, j, p, n, J)
    v10 = hb.velocity_at(j, p) - hb.velocity_at(i, p)
    tao = v10 - n * dot(n, v10)
    tlen = np.sqrt(dot(tao, tao))
    tao = tao / max(tlen, _TINY)
    Kt = hb.impulse_contribution(i, r0, tao) + hb.impulse_contribution(j, r1, tao)
    jt = -dot(v10, tao) / max(Kt, _TINY)
    jt = min(max(jt, -fric * J), fric * J)
    jt = jt if (hit and tlen > 1e-7 and J > 0) else _ZERO
    hb.pair_impulse(i, j, p, tao, jt)


def _project_position(hb, i, j, p, n, depth, hit, dt, penalty):
    """Collision::project_position: a penalty impulse along the normal."""
    r0 = p - hb.pos[i]
    r1 = p - hb.pos[j]
    K = hb.impulse_contribution(i, r0, n) + hb.impulse_contribution(j, r1, n)
    J = np.float32(penalty * dt) * depth / max(K, _TINY)
    hb.pair_impulse(i, j, p, n, J if (hit and J > 0) else _ZERO)


def rigidify_host(hb: HostBodies, verts_body, cconf: CollisionConfig, dirs, dt):
    """Detect + resolve rigid-rigid collisions on the host copy hb:
    iterations x (position + velocity), then iterations x velocity
    (verts_body and dirs as numpy arrays)."""
    hit, depth, normal, point = detect(None, verts_body, cconf.pairs, dirs, host=hb)
    for _ in range(cconf.iterations):
        for k, (i, j) in enumerate(cconf.pairs):
            _project_position(hb, i, j, point[k], normal[k], depth[k], bool(hit[k]), dt,
                              cconf.penalty)
            _project_velocity(hb, i, j, point[k], normal[k], bool(hit[k]))
    for _ in range(cconf.iterations):
        for k, (i, j) in enumerate(cconf.pairs):
            _project_velocity(hb, i, j, point[k], normal[k], bool(hit[k]))


def rigidify(bodies: RigidBodies, verts_body, cconf: CollisionConfig, dirs, dt):
    """rigidify_host on a host copy of `bodies`; returns the bodies with
    the new velocities on their device."""
    if not cconf.pairs:
        return bodies
    hb = HostBodies(bodies)
    rigidify_host(hb, verts_body, cconf, dirs, dt)
    return hb.apply_to(bodies)


def rigid_levelset_collision(bodies: RigidBodies, xb, bp_rid, colliders, t, dt):
    """Rigid boundary particles vs the domain level set: restitution
    impulse along the SDF gradient, then a clamped friction impulse from
    the post-impulse velocity, each accumulated per rigid."""
    if not colliders:
        return bodies
    rid = bp_rid.long()
    fric = bodies.friction[rid, 0]
    rest = bodies.restitution[rid]
    for c in colliders:
        phi = c.sdf(xb, t)
        grad = c.normal(xb, t, eps=1e-4)
        inside = phi < 0.0
        v10 = velocity_at(bodies, rid, xb)
        r0 = xb - bodies.pos[rid]
        v0 = torch.sum(grad * v10, -1)
        K = impulse_contribution(bodies, rid, r0, grad)
        J = -(1.0 + rest) * v0 / torch.clamp(K, min=1e-30)
        ok = inside & (J > 0)
        J_tot, tau_tot = accumulate_impulses(bodies, rid, J[:, None] * grad, xb, ok)
        bodies = apply_impulses(bodies, J_tot, tau_tot)
        v10 = velocity_at(bodies, rid, xb)
        tao = v10 - grad * torch.sum(grad * v10, -1, keepdim=True)
        tlen = torch.linalg.vector_norm(tao, dim=-1)
        tao = tao / torch.clamp(tlen, min=1e-30)[:, None]
        Kt = impulse_contribution(bodies, rid, r0, tao)
        jt = -torch.sum(v10 * tao, -1) / torch.clamp(Kt, min=1e-30)
        jt = torch.clamp(jt, -fric * J, fric * J)
        J_tot, tau_tot = accumulate_impulses(bodies, rid, jt[:, None] * tao, xb,
                                             ok & (tlen > 1e-7))
        bodies = apply_impulses(bodies, J_tot, tau_tot)
    return bodies
