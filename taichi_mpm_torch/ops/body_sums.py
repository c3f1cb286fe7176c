"""The rigid bodies' impulse and torque totals of the dense CPIC path.

``body_totals`` launches the CUDA kernels of ``csrc/body_totals.cu`` (a
scan of rid across the card that marks each body's lanes, then one block
per row and body that adds the values of its hits in lane order) on CUDA
tensors and runs their plain-torch twin ``body_totals_plain`` on CPU
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
import functools
import math

import torch

from taichi_mpm_torch.ops import cuda_build
from taichi_mpm_torch.utils import index_add_ordered

stats = cuda_build.LaunchCount("body_totals")


def _check(rid, J, tau, R: int):
    shape = rid.shape
    for name, v in (("J", J), ("tau", tau)):
        if v.dtype != torch.float32 or v.shape[:-1] != shape or v.device != rid.device:
            raise ValueError(f"{name} must be float32 {tuple(shape)} + (c,) on {rid.device}, "
                             f"got {v.dtype} {tuple(v.shape)} on {v.device}")
    ca, cb = J.shape[-1], tau.shape[-1]
    if ca + cb > 6 or ca < 1:
        raise ValueError(f"at most 6 components in all, got {ca} + {cb}")
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
    n_lead = math.prod(lead)
    r2 = rid.reshape(n_lead, -1).long()
    rows = torch.where(r2 >= 0, torch.arange(n_lead, device=rid.device)[:, None] * R + r2,
                       n_lead * R).reshape(-1)
    return tuple(
        index_add_ordered(torch.zeros((n_lead * R + 1, v.shape[-1]), device=v.device), rows,
                          v.reshape(-1, v.shape[-1]))[:-1].reshape(lead + (R, v.shape[-1]))
        for v in (J, tau))


@functools.cache
def _library():
    """The kernels' launcher, built at first use, its argument types set
    once."""
    launch = cuda_build.load("body_totals").body_totals_launch
    launch.restype = ctypes.c_int
    launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return launch


@functools.lru_cache(maxsize=64)
def _scratch_words(n_lead: int, n: int, R: int) -> int:
    fn = cuda_build.load("body_totals").body_totals_scratch_words
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
    return fn(n_lead, n, R)


def body_totals(rid, J, tau, R: int):
    """The totals of ``body_totals_plain``: rid (..., N) int (a body in
    [0, R) or -1), J (..., N, d) and tau (..., N, c) float32. On a CUDA
    tensor this launches the kernels (or raises); on a CPU tensor it runs
    the twin. The kernels read rid as int64, the dtype the dense CPIC path
    hands over; another integer dtype is widened first."""
    _check(rid, J, tau, R)
    if rid.device.type == "cpu":
        return body_totals_plain(rid, J, tau, R)
    lead, n = rid.shape[:-1], rid.shape[-1]
    n_lead = math.prod(lead)
    ca, cb = J.shape[-1], tau.shape[-1]
    rid = (rid if rid.dtype == torch.int64 else rid.long()).contiguous()
    a, b = J.contiguous(), tau.contiguous()
    dev = rid.device
    scratch = torch.empty(_scratch_words(n_lead, n, R), dtype=torch.int32, device=dev)
    out_a = torch.empty(lead + (R, ca), dtype=torch.float32, device=dev)
    out_b = torch.empty(lead + (R, cb), dtype=torch.float32, device=dev)
    rc = _library()(a.data_ptr(), ca, b.data_ptr(), cb, rid.data_ptr(), n_lead, n, R,
                    scratch.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(rc, "body_totals")
    if n_lead:
        stats.launches += 1
    return out_a, out_b
