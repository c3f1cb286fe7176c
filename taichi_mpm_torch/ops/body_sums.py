"""The rigid bodies' impulse and torque totals of the dense CPIC path.

``body_totals`` launches the CUDA kernel ``csrc/body_totals.cu`` on CUDA
tensors and runs its plain-torch twin ``body_totals_plain`` on CPU
tensors. It replaces no TPU kernel: the JAX package sums these totals with
a scatter-add in particle order (``rigid/body.py accumulate_impulses``),
and so does the twin (``utils.index_add_ordered`` into one row per leading
row and body, lanes of no body into a row that is dropped). The kernel
sums each row in the same order, so the card gives the CPU's bits for the
same addends; a body's total is a small sum of large contact impulses,
whose order decides the last bits of the bodies (see the note in
``csrc/body_totals.cu``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from taichi_mpm_torch.ops import cuda_build
from taichi_mpm_torch.utils import index_add_ordered

stats = cuda_build.LaunchCount("body_totals")


def _check(rid, J, tau, R: int):
    lead, n = rid.shape[:-1], rid.shape[-1]
    for name, v in (("J", J), ("tau", tau)):
        if v.dtype != torch.float32 or v.shape[:-1] != rid.shape:
            raise ValueError(f"{name} must be float32 {tuple(lead)} + ({n}, c), got {v.dtype} "
                             f"{tuple(v.shape)}")
        if v.device != rid.device:
            raise ValueError(f"{name} is on {v.device}, rid on {rid.device}")
    if J.shape[-1] + tau.shape[-1] > 6 or J.shape[-1] < 1:
        raise ValueError(f"at most 6 components in all, got {J.shape[-1]} + {tau.shape[-1]}")
    if R < 1:
        raise ValueError(f"R must be at least 1, got {R}")
    if rid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"body totals run on cuda or cpu tensors, not {rid.device}")


def body_totals_plain(rid, J, tau, R: int):
    """Plain-torch twin: per leading row and body r, the sums over the
    particle axis (the last but one of J and tau) of the lanes with
    rid == r, in lane order from +0 (``index_add_ordered``); a lane with
    rid -1 adds nothing. Returns (J (..., R, d), tau (..., R, c))."""
    _check(rid, J, tau, R)
    lead = rid.shape[:-1]
    n_lead = int(np.prod(lead))
    r2 = rid.reshape(n_lead, -1).long()
    rows = torch.where(r2 >= 0, torch.arange(n_lead, device=rid.device)[:, None] * R + r2,
                       n_lead * R).reshape(-1)
    return tuple(
        index_add_ordered(torch.zeros((n_lead * R + 1, v.shape[-1]), device=v.device), rows,
                          v.reshape(-1, v.shape[-1]))[:-1].reshape(lead + (R, v.shape[-1]))
        for v in (J, tau))


def body_totals(rid, J, tau, R: int):
    """The totals of ``body_totals_plain``: rid (..., N) int (a body in
    [0, R) or -1), J (..., N, d) and tau (..., N, c) float32. On a CUDA
    tensor this launches the kernel (or raises); on a CPU tensor it runs
    the twin."""
    _check(rid, J, tau, R)
    if rid.device.type == "cpu":
        return body_totals_plain(rid, J, tau, R)
    lead, n = rid.shape[:-1], rid.shape[-1]
    n_lead = int(np.prod(lead))
    ca, cb = J.shape[-1], tau.shape[-1]
    rid32 = rid.to(torch.int32).contiguous()
    a, b = J.contiguous(), tau.contiguous()
    out_a = torch.empty(lead + (R, ca), dtype=torch.float32, device=rid.device)
    out_b = torch.empty(lead + (R, cb), dtype=torch.float32, device=rid.device)
    lib = cuda_build.load("body_totals")
    fn = lib.body_totals_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    stream = torch.cuda.current_stream(rid.device).cuda_stream
    rc = fn(a.data_ptr(), ca, b.data_ptr(), cb, rid32.data_ptr(), n_lead, n, R,
            out_a.data_ptr(), out_b.data_ptr(), stream)
    cuda_build.check_launch(rc, "body_totals")
    if n_lead:
        stats.launches += 1
    return out_a, out_b
