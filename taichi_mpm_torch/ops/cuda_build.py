"""Build and load the port's CUDA kernels.

Each source in ``taichi_mpm_torch/csrc/`` is compiled by ``nvcc`` into
shared libraries with a plain C interface, loaded with ctypes: one per
material set (``-DTMT_MATS=<set>``, the scene's materials as a bit set
``1 << id``), holding that set's fused kernel alone, so that a scene
compiles only its own materials, as the JAX package's static
``active_materials`` does. Set 0 holds the material-free kernels
(``p2g_blocked``, ``g2p_blocked``). Builds happen at first use, never at
import, into ``taichi_mpm_torch/_build/`` (listed in ``.gitignore``),
keyed by a hash of the sources, the flags and the set, so an edited
source is rebuilt and an unchanged one is reused. ``build(*libs)``
starts one ``nvcc`` per missing (source, material set) at once and
waits for all of them. Each library keeps ``nvcc``'s ``-Xptxas -v`` report beside it
(``ptxas_report``): registers, spills and shared memory per kernel.

No ``--use_fast_math``: the polar Newton iteration, the SVD and the NaN
scrub keep IEEE ``sqrtf`` and division, and ``logf``/``expf``/``powf``
their full precision.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# what a launcher returns for an entry point its library was not built for
WRONG_LIBRARY = -1

_loaded: dict = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _flags(mats: int):
    return (*NVCC_FLAGS, f"-DTMT_MATS={int(mats)}")


def library_path(name: str, mats: int = 0) -> Path:
    """The library of source `name` for material set `mats` (0: the
    material-free kernels)."""
    h = hashlib.sha256(" ".join(_flags(mats)).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-m{int(mats)}-{digest}.so"


def build(*libs) -> dict:
    """Compile the libraries that are not built yet, all at once; each is
    a (source name, material set) pair. Returns the seconds each one took,
    from the common start to its nvcc's exit, by library file name.
    Processes that build together (the ranks of a ``torchrun`` launch)
    take turns on a lock file in the build directory: the first compiles,
    the others then find its libraries (the lock goes with its holder's
    process)."""
    todo = {(name, int(mats)): library_path(name, mats) for name, mats in libs}
    if all(out.exists() for out in todo.values()):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_missing([(spec, out) for spec, out in todo.items() if not out.exists()])


def _build_missing(todo) -> dict:
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for (name, mats), out in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *_flags(mats), "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors, seconds = [], {}
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        seconds[out.name] = time.perf_counter() - t0
        if proc.returncode == 0:
            out.with_suffix(".log").write_bytes(log)
            os.replace(tmp, out)  # atomic: a reader never sees half a file
        else:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {out.name}:\n{log.decode(errors='replace')}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str, mats: int = 0) -> ctypes.CDLL:
    """The loaded library of source `name` for material set `mats`,
    building it if needed."""
    key = (name, int(mats))
    lib = _loaded.get(key)
    if lib is None:
        build(key)
        lib = ctypes.CDLL(str(library_path(*key)))
        _loaded[key] = lib
    return lib


# the kernels' labels, by a part of their mangled names
_KERNEL_LABELS = {"StageState": "p2g_fused", "StageOperand": "p2g_blocked",
                  "g2p_kernel": "g2p_fused", "g2p_blocked_kernel": "g2p_blocked",
                  "body_totals_mark": "body_totals_mark",
                  "body_totals_sum": "body_totals_sum"}


def ptxas_report(name: str, mats: int = 0) -> dict:
    """Per kernel of a built library, from its ``-Xptxas -v`` log:
    registers, spill stores and loads (bytes) and static shared memory
    (bytes)."""
    log = library_path(name, mats).with_suffix(".log").read_text(errors="replace")
    out, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = _KERNEL_LABELS.get(
                next((k for k in _KERNEL_LABELS if k in m.group(1)), None), m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernel:
            out.setdefault(kernel, {}).update(spill_stores=int(m.group(1)),
                                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and kernel:
            out.setdefault(kernel, {}).update(registers=int(m.group(1)),
                                              smem=int(m.group(2) or 0))
    return out


def check_launch(rc: int, what: str, mats: int = 0) -> None:
    """Raise for a launcher's non-zero return code."""
    if rc == WRONG_LIBRARY:
        raise RuntimeError(f"{what}: the library loaded for material set {mats} was not "
                           "built for it")
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


class LaunchCount:
    """Plain launch counter of one kernel wrapper: incremented where the
    wrapper launches its kernel and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
