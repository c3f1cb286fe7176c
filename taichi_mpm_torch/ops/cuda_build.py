"""Build and load the port's CUDA kernels.

Each source in ``taichi_mpm_torch/csrc/`` is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with ctypes. Builds
happen at first use, never at import, into ``taichi_mpm_torch/_build/``
(listed in ``.gitignore``), one library per source keyed by a hash of the
source text and the flags, so an edited source is rebuilt and an
unchanged one is reused. ``build(*names)`` starts one ``nvcc`` per
missing library at once and waits for all of them.

No ``--use_fast_math``: the polar Newton iteration and the NaN scrub keep
IEEE ``sqrtf`` and division.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

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


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(*names: str) -> None:
    """Compile the named kernels that are not built yet, all at once."""
    todo = [(n, library_path(n)) for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
        else:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


class LaunchCount:
    """Plain launch counter of one kernel wrapper: incremented where the
    wrapper launches its kernel and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
