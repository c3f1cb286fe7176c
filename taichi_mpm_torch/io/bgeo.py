"""BGEO particle output (Houdini classic geo v5); torch port's
counterpart of ``taichi_mpm_tpu.io.bgeo``.

Two writers of the same bytes:
  * the native C++ writer (``io/native/bgeo.cpp``, the port's copy of the
    JAX package's), built with ``g++ -O2 -shared -fPIC`` at first use into
    ``taichi_mpm_torch/_build/`` and driven through ctypes: the writer of
    every frame dump;
  * the plain numpy writer, its twin, chosen explicitly with
    ``writer="numpy"``.

There is no silent fallback: when the native writer cannot be built,
``write_bgeo`` raises and names the numpy writer. ``read_bgeo`` reads a
file back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

HOUDINI_FLOAT = 0
HOUDINI_INT = 1
HOUDINI_VECTOR = 5

SOURCE = Path(__file__).resolve().parent / "native" / "bgeo.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")
WRITERS = ("native", "numpy")

_native = None


def library_path() -> Path:
    """The native writer's library, keyed by its source and flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtmtio-{h.hexdigest()[:16]}.so"


def native_lib():
    """Build (once) and load the native writer; raises when g++ cannot
    build it."""
    global _native
    if _native is not None:
        return _native
    lib_path = library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, lib_path)  # atomic: concurrent builds race safely
        except (OSError, subprocess.CalledProcessError) as e:
            if os.path.exists(tmp):
                os.unlink(tmp)
            detail = getattr(e, "stderr", None) or str(e)
            raise RuntimeError(
                f"the native bgeo writer could not be built from {SOURCE} with g++ "
                f"({detail.strip()[:400]}); pass writer='numpy' to write_bgeo (or to "
                "MPM.visualize) to write the same bytes from numpy") from e
    lib = ctypes.CDLL(str(lib_path))
    lib.tmt_write_bgeo.restype = ctypes.c_int
    lib.tmt_write_bgeo.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
    ]
    _native = lib
    return lib


def _normalize(positions, attributes):
    pos = np.ascontiguousarray(positions, np.float32)
    n, d = pos.shape
    if d == 2:  # 2-D embedded in z = 0, as the reference's 2-D output
        pos = np.concatenate([pos, np.zeros((n, 1), np.float32)], 1)
    attrs = []
    for name, arr in (attributes or {}).items():
        a = np.ascontiguousarray(arr, np.float32)
        if a.ndim == 1:
            a = a[:, None]
        if a.shape[0] != n:
            raise ValueError(f"attribute {name} has {a.shape[0]} rows for {n} points")
        htype = HOUDINI_VECTOR if a.shape[1] == 3 else HOUDINI_FLOAT
        attrs.append((name, a, htype))
    return pos, n, attrs


def write_bgeo(path: str, positions: np.ndarray,
               attributes: Optional[Dict[str, np.ndarray]] = None, writer: str = "native"):
    """Write a classic BGEO file. attributes: name -> (n,) or (n, c)
    float. writer: "native" (the C++ writer) or "numpy" (its twin)."""
    if writer not in WRITERS:
        raise ValueError(f"writer must be one of {WRITERS}, not {writer!r}")
    pos, n, attrs = _normalize(positions, attributes)
    if writer == "numpy":
        write_bgeo_numpy(path, pos, n, attrs)
        return
    lib = native_lib()
    names = (ctypes.c_char_p * len(attrs))(*[a[0].encode() for a in attrs])
    counts = (ctypes.c_int * len(attrs))(*[a[1].shape[1] for a in attrs])
    types = (ctypes.c_int * len(attrs))(*[a[2] for a in attrs])
    ptrs = (ctypes.POINTER(ctypes.c_float) * len(attrs))(
        *[a[1].ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for a in attrs])
    rc = lib.tmt_write_bgeo(str(path).encode(), n,
                            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            len(attrs), names, counts, types, ptrs)
    if rc != 0:
        raise IOError(f"native bgeo writer failed with code {rc} for {path}")


def write_bgeo_numpy(path: str, pos: np.ndarray, n: int, attrs):
    """The numpy writer, byte-identical to the native one (its inputs as
    ``_normalize`` gives them)."""
    out = bytearray()
    magic = ((((ord("B") << 8) | ord("g")) << 8) | ord("e")) << 8 | ord("o")
    out += struct.pack(">i", magic)
    out += b"V"
    out += struct.pack(">iiiiiiiii", 5, n, 1, 0, 0, len(attrs), 0, 1, 0)
    particle_size = 4
    for name, a, htype in attrs:
        out += struct.pack(">H", len(name)) + name.encode()
        out += struct.pack(">Hi", a.shape[1], htype)
        out += struct.pack(">i", 0) * a.shape[1]
        particle_size += a.shape[1]
    # particle block: [x y z 1 attrs...] big-endian float32
    block = np.empty((n, particle_size), ">f4")
    block[:, :3] = pos
    block[:, 3] = 1.0
    col = 4
    for _, a, _ in attrs:
        block[:, col : col + a.shape[1]] = a
        col += a.shape[1]
    out += block.tobytes()
    out += struct.pack(">H", 9) + b"generator"
    out += struct.pack(">Hii", 1, 4, 1)
    out += struct.pack(">H", 4) + b"papi"
    out += struct.pack(">ii", 0x8000, n)
    if n > (1 << 16):
        out += np.arange(n, dtype=">i4").tobytes()
    else:
        out += np.arange(n, dtype=">u2").tobytes()
    out += struct.pack(">i", 0)
    out += b"\x00\xff"
    with open(path, "wb") as f:
        f.write(out)


def read_bgeo(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Read back a classic BGEO written by this module (or partio):
    (positions (n, 3), {name: (n,) or (n, c)})."""
    with open(path, "rb") as f:
        buf = f.read()
    off = 0

    def take(fmt):
        nonlocal off
        vals = struct.unpack_from(">" + fmt, buf, off)
        off += struct.calcsize(">" + fmt)
        return vals if len(vals) > 1 else vals[0]

    magic = take("i")
    if magic != ((((ord("B") << 8) | ord("g")) << 8) | ord("e")) << 8 | ord("o") \
            or take("c") != b"V":
        raise ValueError(f"{path} is not a classic BGEO file")
    version, n, nprims, npg, nprg, nattr, nva, npa, na = take("iiiiiiiii")
    attrs = []
    particle_size = 4
    for _ in range(nattr):
        ln = take("H")
        name = buf[off : off + ln].decode()
        off += ln
        count, htype = take("Hi")
        off += 4 * count  # defaults
        attrs.append((name, count))
        particle_size += count
    data = np.frombuffer(buf, ">f4", n * particle_size, off).reshape(n, particle_size)
    pos = data[:, :3].astype(np.float32)
    out = {}
    col = 4
    for name, count in attrs:
        a = data[:, col : col + count].astype(np.float32)
        out[name] = a[:, 0] if count == 1 else a
        col += count
    return pos, out
