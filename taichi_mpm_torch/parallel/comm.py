"""The slab code's communicator over ``torch.distributed``. It has no
counterpart in the JAX package, whose slab frames run as one program
under ``shard_map``; the only place the port's slab code talks to
``torch.distributed`` is here.

The port is multi-controller (SPMD), as ``torchrun`` launches it: one
process per rank, every rank running the same scene script. The ranks
form a chain along x (rank s owns the s-th slab), or an (Sx, Sy) mesh of
pencils, pencil (sx, sy) on rank sx * Sy + sy (the JAX package's
``devices.reshape(Sx, Sy)``), each of whose axes is an ``Axis``. The
collectives of JAX's frames become:

* ``ppermute`` to a neighbour along an axis: ``neighbour_exchange``, one
  ``dist.batch_isend_irecv`` with the rank before and the rank after;
* ``pmax``: ``all_max``; ``psum``: ``all_sum`` (``dist.all_reduce``);
* the read-out's gather of the global state: ``all_gather_rows``.

The backend is named by the caller and never switched on failure:

* ``nccl`` for CUDA tensors, one GPU per rank;
* ``gloo`` on the CPU;
* ``gloo`` for ranks that share one card (NCCL refuses two ranks on one
  device). This transport moves a CUDA tensor through pinned host
  memory: it is copied to the host, exchanged there by gloo and copied
  back. That is how a gloo group moves every CUDA tensor, always. Each
  copy to the host waits for the card and counts as a host sync
  (``utils.HostSyncs``); the copies back do not wait.

``rank_device`` gives a rank its device, ``process_group`` starts and
ends a group, and ``run_ranks`` spawns a group of ranks on this machine
(the tests on the CPU; ranks sharing one card in ``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from taichi_mpm_torch.utils import HostSyncs


def rank() -> int:
    return dist.get_rank()


def world() -> int:
    return dist.get_world_size()


def rank_device(device=None) -> torch.device:
    """The device of this rank: `device` where the caller names one, else
    ``cuda:{LOCAL_RANK}`` (the global rank where LOCAL_RANK is unset).
    A rank without that device raises; nothing runs on the CPU unless
    asked."""
    if device is not None:
        return torch.device(device)
    index = int(os.environ.get("LOCAL_RANK", rank() if dist.is_initialized() else 0))
    if not torch.cuda.is_available() or index >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank device cuda:{index} does not exist on this machine "
            f"({torch.cuda.device_count() if torch.cuda.is_available() else 0} CUDA devices); "
            "launch one rank per GPU, or pass device= (device='cpu' for the CPU)")
    return torch.device("cuda", index)


def _staged(t: torch.Tensor) -> bool:
    """Whether this group moves `t` through host memory (gloo and a CUDA
    tensor)."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The buffer the backend moves for `t`: a pinned host copy on the
    staged transport (a host sync), else `t` itself (contiguous)."""
    if _staged(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        HostSyncs.count += 1
        return host
    return t.contiguous()


def _reduce(t: torch.Tensor, op) -> torch.Tensor:
    w = _wire(t) if _staged(t) else t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(w, op=op)
    return w.to(t.device, non_blocking=True)


def all_max(t: torch.Tensor) -> torch.Tensor:
    """Elementwise max of `t` over the ranks (JAX's ``pmax``), a new
    tensor on `t`'s device."""
    return _reduce(t, dist.ReduceOp.MAX)


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum of `t` over the ranks (JAX's ``psum``)."""
    return _reduce(t, dist.ReduceOp.SUM)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the rank mesh: the ranks along it are `stride` apart,
    and this rank is at `index` of `size`."""

    stride: int
    index: int
    size: int


def chain() -> Axis:
    """The slabs' one axis: every rank of the group, in rank order."""
    return Axis(1, rank(), world())


def neighbour_exchange(send_left, send_right, left_shape=None, right_shape=None, axis=None):
    """Send `send_left` to the rank before this one along `axis` (default
    ``chain()``) and `send_right` to the rank after it (JAX's ``ppermute``
    one step each way along a mesh axis). Returns (from_left,
    from_right): what the rank before sent right and what the rank after
    sent left, zeros at an end of the axis (where ``ppermute`` gives
    zeros). A message travels with the shape its receiver expects:
    `left_shape` and `right_shape` are the shapes coming from the left
    and the right, by default those of `send_right` and `send_left` (an
    exchange whose two sides are the same shape). Empty messages are not
    sent."""
    ax = chain() if axis is None else axis
    s = rank()
    dev = send_left.device
    from_left = torch.zeros(send_right.shape if left_shape is None else left_shape,
                            dtype=send_right.dtype, device=dev)
    from_right = torch.zeros(send_left.shape if right_shape is None else right_shape,
                             dtype=send_left.dtype, device=dev)
    ops, received = [], []
    for step, out, into in ((-1, send_left, from_left), (1, send_right, from_right)):
        if not 0 <= ax.index + step < ax.size:
            continue
        peer = s + step * ax.stride
        if out.numel():
            ops.append(dist.P2POp(dist.isend, _wire(out), peer))
        if into.numel():
            buf = torch.empty(into.shape, dtype=into.dtype, pin_memory=True) if _staged(into) \
                else into
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            received.append((buf, into))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for buf, into in received:
        if buf is not into:
            into.copy_(buf, non_blocking=True)
    return from_left, from_right


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The rows (dim 0) of `t` on every rank, concatenated in rank order,
    on every rank. Ranks may hold different numbers of rows."""
    n = _all_gather_counts(t.shape[0])
    pad = max(n)
    w = torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    w[: t.shape[0]] = t
    w = _wire(w)
    parts = [torch.empty_like(w) for _ in n]
    dist.all_gather(parts, w)
    return torch.cat([p[:k] for p, k in zip(parts, n)]).to(t.device)


def _all_gather_counts(count: int) -> list:
    """`count` of every rank, in rank order, as Python ints."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(count)], dtype=torch.int64, device=dev)
    parts = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(parts, t)
    return [int(p) for p in parts]


# -- process groups ------------------------------------------------------------


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(backend: str, rank: int, world: int, port: int, timeout_s: float = 300.0):
    """A process group of `world` ranks that meet at tcp://localhost:port,
    destroyed on exit. A collective that waits longer than `timeout_s`
    raises."""
    if backend == "nccl":
        torch.cuda.set_device(rank_device())
    # the ranks meet on this machine: gloo's pairs connect over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(fn, rank, world, backend, port, timeout_s, args, results):
    """A spawned rank: join the group, run fn(*args), report the result or
    the traceback."""
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        with process_group(backend, rank, world, port, timeout_s):
            out = fn(*args)
        results.put((rank, out, None))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, None, traceback.format_exc()))


def run_ranks(fn, world: int, backend: str, args=(), timeout_s: float = 300.0) -> list:
    """Run fn(*args) on `world` spawned ranks of one process group on this
    machine; returns each rank's result, in rank order. `fn` must be
    importable by name (spawned processes import it). A rank that raises,
    dies or outlives `timeout_s` ends the run: every rank is stopped and
    this raises (RuntimeError with the rank's traceback, or TimeoutError)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, port, timeout_s, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} did not "
                                   f"finish within {timeout_s} s")
            try:
                r, value, err = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code {dead[0][1]} "
                                       "without a result")
                continue
            if err is not None:
                raise RuntimeError(f"rank {r} failed:\n{err}")
            out[r] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                raise TimeoutError("a rank did not exit after reporting its result")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [out[r] for r in range(world)]
