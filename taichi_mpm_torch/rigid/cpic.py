"""CPIC colour-compatibility and friction helpers (torch counterpart of
the helpers of ``taichi_mpm_tpu.rigid.cpic`` that the packed CPIC path
uses). The dense oracle transfers of that module wait for the dense
oracle path (ROADMAP.md queue 1)."""

from __future__ import annotations

import torch

from taichi_mpm_torch.rigid.body import RigidBodies


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
