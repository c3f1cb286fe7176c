"""G2P: velocity windows -> particles, with or without the finish.

Two kernels of ``csrc/g2p.cu``, each with a plain-torch twin; a wrapper
launches its kernel on a CUDA tensor and uses the twin only on a CPU
tensor.

* ``g2p_fused`` (twin ``g2p_fused_plain``) replaces the TPU kernel
  ``taichi_mpm_tpu/ops/fused_pallas.py g2p_fused``: it gathers v and the
  APIC B of every active lane from its slot's window, runs the resample
  tail (``finish_packed``) and writes the state in place, returning max
  |v| over lanes still active and the plasticity count.
* ``g2p_blocked`` (twin ``g2p_blocked_plain``) replaces the TPU kernel
  ``taichi_mpm_tpu/ops/g2p_pallas.py g2p_blocked``: the gather alone,
  (12, Pw) rows v (3) and B row-major (9), for callers that correct the
  gathered values before the finish (the CPIC frame).

``finish_packed`` is the specification of the tail (the JAX package's
``ops/packed.finish_packed``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.materials import cforms
from taichi_mpm_torch.math.kernels import inv_D, quadratic_weight
from taichi_mpm_torch.ops import cuda_build
from taichi_mpm_torch.ops.blocked import TILE, TILE_NODES
from taichi_mpm_torch.ops.p2g import check_device_materials, material_set
from taichi_mpm_torch.ops.rows import (
    NCH, RACT, RAUX, RC, RF, RMAT, RORG, RPAR, RV, RX,
)

stats = cuda_build.LaunchCount("g2p_fused")
blocked_stats = cuda_build.LaunchCount("g2p_blocked")

_EYE = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def _k_cdg(cfg: SimConfig, dt) -> float:
    """invD * dt * inv_dx in f32, as the fused TPU kernel evaluates it."""
    return float(np.float32(inv_D(cfg.kernel_order)) * np.float32(dt)
                 * np.float32(cfg.inv_dx))


def _clip_hi(cfg: SimConfig):
    return [float(np.float32((cfg.res[k] - cfg.clamp_eps) * cfg.dx)) for k in range(3)]


def finish_packed(st, acc, cfg: SimConfig, dt, zero_C=None):
    """Tail of G2P on rows: APIC/RPIC damping, MLS F-update, plasticity,
    advection, clamp and the NaN scrub. acc rows: v (3), B row-major (9).
    zero_C (Pw,) bool, where given, zeroes the new C of those lanes (the
    CPIC frame's near-boundary lanes). A lane whose new x, v or F is not
    finite is deactivated and reset (x = v = C = 0, F = I). Returns
    (st_new, vmax, plast_count)."""
    act = st[RACT] > 0.5
    v_new = [torch.where(act, acc[k], 0.0) for k in range(3)]
    B = [torch.where(act, acc[3 + k], 0.0) for k in range(9)]

    if cfg.apic:
        sym_w = 1.0 - cfg.rpic_damping
        skew_w = 1.0 - cfg.apic_damping
        C_new = []
        for i in range(3):
            for j in range(3):
                bij, bji = B[3 * i + j], B[3 * j + i]
                s = 0.5 * (bij + bji)
                C_new.append(sym_w * s + skew_w * (bij - s))
    else:
        C_new = [torch.zeros_like(B[0]) for _ in range(9)]
    if zero_C is not None:
        C_new = [torch.where(zero_C, 0.0, c) for c in C_new]

    k = _k_cdg(cfg, dt)
    cdg = tuple(e - k * b for e, b in zip(_EYE, B))
    F = tuple(st[RF + i] for i in range(9))
    aux = st[RAUX]
    params = tuple(st[RPAR + i] for i in range(8))
    mat = st[RMAT].view(torch.int32)
    F_new, aux_new, cnt = cforms.dispatch_plasticity(
        cfg.active_materials, mat, F, cdg, aux, params, float(np.float32(dt)))

    hi = _clip_hi(cfg)
    x_new = [torch.clamp(st[RX + kk] + float(np.float32(dt)) * v_new[kk], 0.0, hi[kk])
             for kk in range(3)]

    finite = torch.ones_like(act)
    for r in (*x_new, *v_new, *F_new):
        finite = finite & torch.isfinite(r)
    keep = act & finite
    dead = act & ~finite

    def sel(new, old, cleanup=0.0):
        return torch.where(keep, new, torch.where(dead, cleanup, old))

    st_new = st.clone()
    for kk in range(3):
        st_new[RX + kk] = sel(x_new[kk], st[RX + kk])
        st_new[RV + kk] = sel(v_new[kk], st[RV + kk])
    for i in range(9):
        st_new[RF + i] = sel(F_new[i], st[RF + i], cleanup=_EYE[i])
        st_new[RC + i] = sel(C_new[i], st[RC + i])
    st_new[RAUX] = torch.where(keep, aux_new, aux)
    st_new[RACT] = keep.to(torch.float32)
    vmax = torch.amax(torch.stack([torch.where(keep, torch.abs(v), 0.0) for v in v_new]))
    plast = torch.where(keep, cnt, 0).sum(dtype=torch.int32)
    return st_new, vmax, plast


def _gather_plain(keys, st, win, cfg: SimConfig):
    """The window gather of both twins: rows v (3) and B row-major (9) of
    every lane from its slot's window over the 3x3x3 quadratic support
    (zero for slot key K), summed in the kernel's order. Only the lanes
    of a live slot are computed (a slot-K lane gathers zero), so a state
    of mostly free lanes costs what its live ones do."""
    K = win.shape[0]
    live = torch.nonzero(keys.long() < K).flatten()
    acc = _gather_lanes(keys[live].long(), st[:, live], win, cfg)
    out = [torch.zeros((st.shape[1],), dtype=st.dtype, device=st.device) for _ in range(12)]
    for o, a in zip(out, acc):
        o[live] = a
    return out


def _gather_lanes(slot, st, win, cfg: SimConfig):
    """``_gather_plain`` of lanes whose slots are `slot` (< K), rows of
    `st`."""
    K = win.shape[0]
    flat = win.reshape(K, -1)
    pos = torch.stack([st[RX + a] * cfg.inv_dx - st[RORG + a] for a in range(3)])
    base = torch.clamp(torch.floor(pos - 0.5), -2.0, 7.0)
    w = [[quadratic_weight(pos[a] - (base[a] + d)) for d in range(3)] for a in range(3)]
    tidx = (base + 1).long()
    acc = [torch.zeros_like(pos[0]) for _ in range(12)]
    for di in range(3):
        for dj in range(3):
            for dk in range(3):
                ix, iy, iz = tidx[0] + di, tidx[1] + dj, tidx[2] + dk
                inside = ((ix >= 0) & (ix < TILE) & (iy >= 0) & (iy < TILE)
                          & (iz >= 0) & (iz < TILE))
                wn = w[0][di] * w[1][dj] * w[2][dk]
                node = (ix.clamp(0, TILE - 1) * TILE + iy.clamp(0, TILE - 1)) * TILE \
                    + iz.clamp(0, TILE - 1)
                d = (pos[0] - (ix - 1), pos[1] - (iy - 1), pos[2] - (iz - 1))
                for c in range(3):
                    g = flat[slot, c * TILE_NODES + node]
                    wg = torch.where(inside, wn * g, 0.0)
                    acc[c] = acc[c] + wg
                    for a in range(3):
                        acc[3 + 3 * c + a] = acc[3 + 3 * c + a] + wg * d[a]
    return acc


def g2p_fused_plain(keys, st, win, dt, cfg: SimConfig):
    """Plain-torch twin of the fused G2P kernel: same inputs, same
    in-place update of `st`, same (vmax, plast)."""
    st_new, vmax, plast = finish_packed(st, _gather_plain(keys, st, win, cfg), cfg, dt)
    st.copy_(st_new)
    return vmax, plast


def g2p_blocked_plain(keys, st, win, cfg: SimConfig):
    """Plain-torch twin of the gather-only G2P kernel: (12, Pw) rows v (3)
    and B row-major (9)."""
    return torch.stack(_gather_plain(keys, st, win, cfg))


def _check_inputs(keys, st, win):
    if st.dtype != torch.float32 or st.dim() != 2 or st.shape[0] != NCH:
        raise ValueError(f"state must be float32 ({NCH}, Pw), got {st.dtype} {tuple(st.shape)}")
    if keys.dtype != torch.int32 or keys.shape != (st.shape[1],):
        raise ValueError(f"keys must be int32 (Pw,), got {keys.dtype} {tuple(keys.shape)}")
    if win.dtype != torch.float32 or win.shape[1:] != (3, TILE, TILE, TILE):
        raise ValueError(f"windows must be float32 (K, 3, 7, 7, 7), got {tuple(win.shape)}")
    for name, a in (("keys", keys), ("windows", win)):
        if a.device != st.device:
            raise ValueError(f"{name} is on {a.device}, state on {st.device}")
    if not (st.is_contiguous() and keys.is_contiguous() and win.is_contiguous()):
        raise ValueError("G2P needs contiguous tensors")
    if st.device.type not in ("cpu", "cuda"):
        raise ValueError(f"G2P runs on cuda or cpu tensors, not {st.device}")


def g2p_fused(keys, st, win, dt, cfg: SimConfig):
    """Gather + finish on the sorted packed state `st` (48, Pw), updated
    in place; keys (Pw,) are the lanes' slot ids (K = none), win the
    (K, 3, 7, 7, 7) velocity windows. Returns (vmax, plast) as 0-d
    tensors. On a CUDA tensor this launches the kernel (or raises); on a
    CPU tensor it runs the twin."""
    _check_inputs(keys, st, win)
    if st.device.type == "cpu":
        return g2p_fused_plain(keys, st, win, dt, cfg)
    check_device_materials(cfg)
    mats = material_set(cfg)
    lib = cuda_build.load("g2p", mats)
    lib.g2p_blocks.restype = ctypes.c_int
    lib.g2p_blocks.argtypes = [ctypes.c_longlong]
    pw = st.shape[1]
    nblk = lib.g2p_blocks(pw)
    vmax_part = torch.empty((nblk,), dtype=torch.float32, device=st.device)
    plast_part = torch.empty((nblk,), dtype=torch.int32, device=st.device)
    fn = lib.g2p_fused_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_float] * 8 + [
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sym_w, skew_w = 1.0 - cfg.rpic_damping, 1.0 - cfg.apic_damping
    stream = torch.cuda.current_stream(st.device).cuda_stream
    rc = fn(st.data_ptr(), pw, keys.data_ptr(), win.data_ptr(), win.shape[0],
            vmax_part.data_ptr(), plast_part.data_ptr(),
            float(np.float32(dt)), float(cfg.inv_dx), _k_cdg(cfg, dt), sym_w, skew_w,
            *_clip_hi(cfg), int(cfg.apic), mats, stream)
    cuda_build.check_launch(rc, "g2p_fused", mats)
    stats.launches += 1
    return torch.amax(vmax_part), plast_part.sum(dtype=torch.int32)


def g2p_blocked(keys, st, win, cfg: SimConfig):
    """The window gather alone: (12, Pw) rows v (3) and B row-major (9) of
    every lane of the sorted packed state `st` (48, Pw), read only; keys
    (Pw,) are the lanes' slot ids (K = none), win the (K, 3, 7, 7, 7)
    velocity windows. On a CUDA tensor this launches the kernel (or
    raises); on a CPU tensor it runs the twin."""
    _check_inputs(keys, st, win)
    if st.device.type == "cpu":
        return g2p_blocked_plain(keys, st, win, cfg)
    lib = cuda_build.load("g2p")
    fn = lib.g2p_blocked_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    pw = st.shape[1]
    out = torch.empty((12, pw), dtype=torch.float32, device=st.device)
    stream = torch.cuda.current_stream(st.device).cuda_stream
    rc = fn(st.data_ptr(), pw, keys.data_ptr(), win.data_ptr(), win.shape[0],
            float(cfg.inv_dx), out.data_ptr(), stream)
    cuda_build.check_launch(rc, "g2p_blocked")
    blocked_stats.launches += 1
    return out
