"""Small shared helpers (torch counterpart of ``taichi_mpm_tpu.utils``):
the unrolled batched 3-vector products the rigid code uses, written with
the JAX package's operation order, the two ways host values reach
the card without stalling it (``const``, ``upload``), and the counted
way device values reach the host (``host_read``)."""

from __future__ import annotations

import functools

import numpy as np
import torch


def outer(a, b):
    """Batched outer product: (..., d) x (..., d) -> (..., d, d)."""
    return a[..., :, None] * b[..., None, :]


def mv(a, v):
    """Batched small matrix-vector product, unrolled:
    out_i = ((a_i0 v_0 + a_i1 v_1) + a_i2 v_2)."""
    d = v.shape[-1]
    rows = []
    for i in range(a.shape[-2]):
        acc = a[..., i, 0] * v[..., 0]
        for k in range(1, d):
            acc = acc + a[..., i, k] * v[..., k]
        rows.append(acc)
    return torch.stack(rows, -1)


def cross(a, b):
    """a x b over the last axis (jnp.cross's formula)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def index_add_ordered(dst, index, src):
    """dst[index[i]] += src[i] for i in order, in place along dim 0; the
    repeated indices are summed in a fixed order, so the result has the
    same bits on every run. On the CPU, index_add_ is that sequential
    loop (the JAX package's scatter-add on the CPU sums in the same
    order). On a CUDA tensor index_add_ uses float atomics, whose order
    changes from run to run, so it goes through index_put_(accumulate)
    under torch's deterministic mode: indices sorted stably, each run of
    equal indices summed in order."""
    if dst.device.type != "cuda":
        return dst.index_add_(0, index, src)
    prev = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return dst.index_put_((index,), src, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn_only)


def _frozen(values):
    a = np.asarray(values)
    return a.tolist() if a.ndim == 0 else tuple(_frozen(v) for v in a)


@functools.lru_cache(maxsize=None)
def _const(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=torch.device(device))


def const(values, dtype=torch.float32, device="cpu"):
    """A constant tensor made once per (values, dtype, device) and then
    reused: a copy from pageable host memory to the card waits for the
    card's queue to drain, so a constant rebuilt in every call of a loop
    stalls the host on every call. Callers must not modify it."""
    try:  # a tuple of numbers (the common call) is its own key
        return _const(values, dtype, device)
    except TypeError:  # lists, arrays, or a tuple holding them
        return _const(_frozen(values), dtype, device)


def upload(values, device, dtype=np.float32):
    """Host values that change from call to call as a tensor on `device`:
    through pinned memory, without waiting for the card's queue."""
    t = torch.from_numpy(np.ascontiguousarray(values, dtype))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class HostSyncs:
    """Device-to-host reads the frame loops make once or more per
    substep (each waits for the card), and the copies to the host of the
    slab communicator's staged transport (``parallel.comm``): a plain
    counter, read and reset by callers that measure. The page map's
    occupancy read at a re-sort is not counted."""

    count = 0


def host_read(t):
    """t.tolist(), counted as one host sync."""
    HostSyncs.count += 1
    return t.tolist()
