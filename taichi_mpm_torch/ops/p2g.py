"""P2G: particles -> per-slot halo tiles.

Two entry points of the CUDA kernel ``csrc/p2g.cu``, each with a
plain-torch twin; a wrapper launches the kernel on a CUDA tensor and
uses the twin only on a CPU tensor. Both give halo tiles
``(K, 7, 7, 7, 4)`` [i, j, k, c] where tile node (i, j, k) is block-local
node (i-1, j-1, k-1) and the channels are momentum (3) and mass.

* ``p2g_fused`` (twin ``p2g_fused_plain``) replaces the TPU kernel
  ``taichi_mpm_tpu/ops/fused_pallas.py p2g_fused``: prep and P2G from the
  packed state.
* ``p2g_blocked`` (twin ``p2g_blocked_plain``) replaces the TPU kernels
  ``taichi_mpm_tpu/ops/p2g_pallas.py p2g_blocked`` and
  ``p2g_blocked_batched`` (one function; the batched form is a TPU
  grid layout): P2G from the prebuilt operand of ``prep_packed``, for
  the unfused substep.

``prep_packed`` is the specification both follow for the per-particle
operand (the JAX package's ``ops/packed.prep_packed``).

Both kernels share one accumulation stage: one warp per slot stages 32
particles at a time (operand values, support weights), then walks them
in sorted order, each of 27 lanes adding the particle's term into one
node of its 3x3x3 support in a shared-memory tile. Every node sums the
same terms in the same order as the twins' specification (the slot's
particles in sorted order, zero weights and nodes outside the tile
skipped), so the kernels are deterministic and keep the bits of the
earlier node-owner loop; the twins, which sum per support offset with
``index_add_``, agree to rounding. See the note in ``csrc/p2g.cu``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from taichi_mpm_torch.config import SimConfig
from taichi_mpm_torch.materials import cforms
from taichi_mpm_torch.materials.models import MATERIAL_IDS
from taichi_mpm_torch.math.kernels import inv_D, quadratic_weight
from taichi_mpm_torch.ops import blocked, cuda_build
from taichi_mpm_torch.ops.blocked import TILE, TILE_NODES
from taichi_mpm_torch.ops.rows import (
    NCH, RACT, RAUX, RC, RF, RMASS, RMAT, RORG, RPAR, RV, RVOL, RX,
)

stats = cuda_build.LaunchCount("p2g_fused")
blocked_stats = cuda_build.LaunchCount("p2g_blocked")

# materials the CUDA kernels implement: all eight (csrc/materials.cuh)
DEVICE_MATERIALS = tuple(sorted(MATERIAL_IDS))


def check_device_materials(cfg: SimConfig):
    """Raise for a configuration the CUDA kernels do not implement."""
    if cfg.kernel_order != 2:
        raise NotImplementedError(
            f"kernel_order={cfg.kernel_order}: the blocked kernels are "
            "quadratic only")


def material_set(cfg: SimConfig) -> int:
    """The scene's materials as the bit set (1 << id) the CUDA kernels are
    compiled for: one library per set (``cuda_build``)."""
    return sum(1 << m for m in cfg.active_materials)


def prep_packed(st, cfg: SimConfig, dt):
    """The P2G operand (16, Pw) from packed state rows: m*v (3), m, the
    fused affine A (9, row-major) and the block-local position (3), with
    block origins read from rows 43-45. Inactive lanes get m = A = 0."""
    invD = inv_D(cfg.kernel_order)
    act = st[RACT] > 0.5
    F = tuple(st[RF + k] for k in range(9))
    C = tuple(st[RC + k] for k in range(9))
    params = tuple(st[RPAR + k] for k in range(8))
    mat = st[RMAT].view(torch.int32)
    force = cforms.dispatch_force(
        cfg.active_materials, mat, F, st[RAUX], params, st[RVOL])
    mass = torch.where(act, st[RMASS], 0.0)
    cf_scale = np.float32(invD * cfg.inv_dx) * np.float32(dt)
    A = [torch.where(act, invD * mass * c - float(cf_scale) * f, 0.0)
         for c, f in zip(C, force)]
    v = [st[RV + k] for k in range(3)]
    if cfg.particle_gravity:
        v = [v[k] + cfg.gravity[k] * float(np.float32(dt)) for k in range(3)]
    pos = [st[RX + k] * cfg.inv_dx - st[RORG + k] for k in range(3)]
    return torch.stack([mass * v[0], mass * v[1], mass * v[2], mass, *A, *pos])


def _slot_lanes(s_arr, e_arr):
    """(slot, lane) of every particle inside a slot's range [s, e)."""
    return blocked.range_lanes(s_arr, e_arr)


def _scatter_plain(slot, pd, K: int):
    """Halo tiles (K, 7, 7, 7, 4) from the operand columns pd (16, n) of
    particles in slots `slot` (n,), in sorted order. Each particle adds
    to its 3x3x3 support nodes inside the tile; the sum runs in particle
    order per support offset (index_add_)."""
    mv, m, A, pos = pd[0:3], pd[3], pd[4:13], pd[13:16]
    base = torch.floor(pos - 0.5)
    w = [[quadratic_weight(pos[a] - (base[a] + d)) for d in range(3)] for a in range(3)]
    tidx = (base + 1).long()  # tile index of the first support node
    out = torch.zeros((K * TILE_NODES, 4), dtype=torch.float32, device=pd.device)
    for di in range(3):
        for dj in range(3):
            for dk in range(3):
                ix, iy, iz = tidx[0] + di, tidx[1] + dj, tidx[2] + dk
                inside = ((ix >= 0) & (ix < TILE) & (iy >= 0) & (iy < TILE)
                          & (iz >= 0) & (iz < TILE))
                wn = w[0][di] * w[1][dj] * w[2][dk]
                d = (pos[0] - (ix - 1), pos[1] - (iy - 1), pos[2] - (iz - 1))
                mom = [mv[c] + A[3 * c] * d[0] + A[3 * c + 1] * d[1] + A[3 * c + 2] * d[2]
                       for c in range(3)]
                vals = torch.stack([wn * mom[0], wn * mom[1], wn * mom[2], wn * m], -1)
                vals = torch.where(inside[:, None], vals, 0.0)
                node = (ix.clamp(0, TILE - 1) * TILE + iy.clamp(0, TILE - 1)) * TILE \
                    + iz.clamp(0, TILE - 1)
                out.index_add_(0, slot * TILE_NODES + node, vals)
    return out.reshape(K, TILE, TILE, TILE, 4)


def p2g_fused_plain(s_arr, e_arr, st, dt, cfg: SimConfig):
    """Plain-torch twin of the fused P2G kernel: same inputs, same tiles
    (the operand of the lanes in slot ranges, then their scatter)."""
    slot, lane = _slot_lanes(s_arr, e_arr)
    return _scatter_plain(slot, prep_packed(st[:, lane], cfg, dt), s_arr.shape[0])


def p2g_blocked_plain(s_arr, e_arr, pdata):
    """Plain-torch twin of the P2G kernel on a prebuilt operand: the
    scatter of ``p2g_fused_plain`` on the columns of `pdata` (16, Pw)."""
    slot, lane = _slot_lanes(s_arr, e_arr)
    return _scatter_plain(slot, pdata[:, lane], s_arr.shape[0])


def _launch_args(cfg: SimConfig, dt):
    invD = inv_D(cfg.kernel_order)
    gdt = [np.float32(g) * np.float32(dt) for g in cfg.gravity]
    return (
        ctypes.c_float(cfg.inv_dx), ctypes.c_float(invD),
        ctypes.c_float(np.float32(invD * cfg.inv_dx) * np.float32(dt)),
        *(ctypes.c_float(g) for g in gdt), ctypes.c_int(int(cfg.particle_gravity)),
    )


def _check_inputs(s_arr, e_arr, st, rows=NCH, what="state"):
    if st.dtype != torch.float32 or st.dim() != 2 or st.shape[0] != rows:
        raise ValueError(f"{what} must be float32 ({rows}, Pw), got {st.dtype} {tuple(st.shape)}")
    for name, a in (("s_arr", s_arr), ("e_arr", e_arr)):
        if a.dtype != torch.int32 or a.dim() != 1 or a.shape != s_arr.shape:
            raise ValueError(f"{name} must be int32 (K,), got {a.dtype} {tuple(a.shape)}")
        if a.device != st.device:
            raise ValueError(f"{name} is on {a.device}, {what} on {st.device}")
    if not (st.is_contiguous() and s_arr.is_contiguous() and e_arr.is_contiguous()):
        raise ValueError("P2G needs contiguous tensors")
    if st.device.type not in ("cpu", "cuda"):
        raise ValueError(f"P2G runs on cuda or cpu tensors, not {st.device}")


def p2g_fused(s_arr, e_arr, st, dt, cfg: SimConfig):
    """Halo tiles (K, 7, 7, 7, 4) of the sorted packed state `st`
    (48, Pw) over the slot ranges [s_arr, e_arr). On a CUDA tensor this
    launches the kernel (or raises); on a CPU tensor it runs the twin."""
    _check_inputs(s_arr, e_arr, st)
    if st.device.type == "cpu":
        return p2g_fused_plain(s_arr, e_arr, st, dt, cfg)
    check_device_materials(cfg)
    K = s_arr.shape[0]
    out = torch.empty((K, TILE, TILE, TILE, 4), dtype=torch.float32, device=st.device)
    mats = material_set(cfg)
    lib = cuda_build.load("p2g", mats)
    fn = lib.p2g_fused_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p] + [ctypes.c_float] * 6 + [
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(st.device).cuda_stream
    rc = fn(st.data_ptr(), st.shape[1], s_arr.data_ptr(), e_arr.data_ptr(), K,
            out.data_ptr(), *_launch_args(cfg, dt), mats, stream)
    cuda_build.check_launch(rc, "p2g_fused", mats)
    stats.launches += 1
    return out


def p2g_blocked(s_arr, e_arr, pdata):
    """Halo tiles (K, 7, 7, 7, 4) of the prebuilt P2G operand `pdata`
    (16, Pw) [m v, m, A row-major, block-local pos] of a sorted state
    over the slot ranges [s_arr, e_arr). On a CUDA tensor this launches
    the kernel (or raises); on a CPU tensor it runs the twin."""
    _check_inputs(s_arr, e_arr, pdata, rows=16, what="operand")
    if pdata.device.type == "cpu":
        return p2g_blocked_plain(s_arr, e_arr, pdata)
    K = s_arr.shape[0]
    out = torch.empty((K, TILE, TILE, TILE, 4), dtype=torch.float32, device=pdata.device)
    lib = cuda_build.load("p2g")
    fn = lib.p2g_blocked_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    stream = torch.cuda.current_stream(pdata.device).cuda_stream
    rc = fn(pdata.data_ptr(), pdata.shape[1], s_arr.data_ptr(), e_arr.data_ptr(), K,
            out.data_ptr(), stream)
    cuda_build.check_launch(rc, "p2g_blocked")
    blocked_stats.launches += 1
    return out
