#!/usr/bin/env python3
"""Time variants of the P2G kernel source at the 8M jelly state.

Run from the root of a checkout on a machine with an H100 and nvcc:

    python3 tools/p2g_variants.py

Each variant is ``taichi_mpm_torch/csrc/p2g.cu`` with a few lines
replaced (one slot per block as written, or 2 or 4; no row prefetch; the
dense 49 i + 7 j + k tile layout with lanes in offset order), built with
the port's nvcc flags into ``taichi_mpm_torch/_build/variants/`` for the
material sets the states need (jelly's and water's ``p2g_fused``, the
material-free ``p2g_blocked``) and loaded in place of the built
libraries. On each state of
``chip_smoke.kernel_states`` (the 8M jelly cube and the 1.4M adaptive dam,
after one frame) both entry points are timed with CUDA events (10
launches, after one) in the order A, B, ..., B, A, and their tiles must
keep the bits of the source as written. One JSON line per variant and
state, one per state with the share of particles whose support corner
equals that of the particle before them in their slot (the updates a
kernel could keep in registers), then the card's name, clock and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

CSRC = ROOT / "taichi_mpm_torch" / "csrc"
OUT = ROOT / "taichi_mpm_torch" / "_build" / "variants"
IDENTITY_LANES = "kLaneOffset[32] = {" + ", ".join(
    [str(i) for i in range(27)] + ["0"] * 5) + "}"
NO_PREFETCH = (
    ("  if (lane < e - s) stage.load(pw, (long long)s + lane, raw);\n", ""),
    ("      stage.build(raw, sv);",
     "      stage.load(pw, (long long)base + lane, raw);\n      stage.build(raw, sv);"),
    ("    if (lane < e - base - 32) stage.load(pw, (long long)base + 32 + lane, raw);\n", ""),
)
VARIANTS = {
    "as_written": (),
    "warps2": (("constexpr int WARPS = 1;", "constexpr int WARPS = 2;"),),
    "warps4": (("constexpr int WARPS = 1;", "constexpr int WARPS = 4;"),),
    "no_prefetch": NO_PREFETCH,
    "dense_layout": (("constexpr int SI = 51, SJ = 7;", "constexpr int SI = 49, SJ = 7;"),
                     (re.compile(r"kLaneOffset\[32\] = \{[^}]*\}"), IDENTITY_LANES)),
}


def variant_source(edits) -> str:
    src = (CSRC / "p2g.cu").read_text()
    for old, new in edits:
        if isinstance(old, re.Pattern):
            src, n = old.subn(new, src)
        else:
            n = src.count(old)
            src = src.replace(old, new)
        if n != 1:
            raise RuntimeError(f"variant edit matched {n} times: {old!r}")
    return src


# the material sets of the libraries a variant is built for: the
# material-free one (p2g_blocked), jelly's and water's (p2g_fused)
SETS = (0, 1 << 1, 1 << 3)


def build_all():
    """One nvcc per variant and material set, all at once; returns
    name -> ({set: library}, ptxas lines)."""
    from taichi_mpm_torch.ops import cuda_build

    OUT.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, OUT / header.name)
    procs = {}
    for name, edits in VARIANTS.items():
        (OUT / f"p2g_{name}.cu").write_text(variant_source(edits))
        for mats in SETS:
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-DTMT_MATS={mats}",
                   "-o", str(OUT / f"p2g_{name}_m{mats}.so"), str(OUT / f"p2g_{name}.cu")]
            procs[name, mats] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT)
    built = {}
    for (name, mats), proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (set {mats}):\n{log}")
        libs, regs = built.setdefault(name, ({}, []))
        libs[mats] = ctypes.CDLL(str(OUT / f"p2g_{name}_m{mats}.so"))
        regs += [f"set {mats}: " + line.split(":", 1)[1].strip()
                 for line in log.splitlines() if "registers" in line]
    return built


def main():
    import torch

    from taichi_mpm_torch.ops import cuda_build, p2g

    if not torch.cuda.is_available():
        print("p2g_variants: no CUDA device", file=sys.stderr)
        return 2
    built = build_all()
    load = cuda_build.load
    for label, sim in chip_smoke.kernel_states():
        runs = chip_smoke.p2g_launches(sim)
        ref, ms = {}, {name: {k: [] for k in runs} for name in built}
        try:
            for name in [*built, *reversed(list(built))]:
                cuda_build.load = lambda _, mats=0, libs=built[name][0]: libs[mats]
                for kernel, fn in runs.items():
                    tiles = fn()
                    torch.cuda.synchronize()
                    ref.setdefault(kernel, tiles)
                    if not torch.equal(tiles.view(torch.int32), ref[kernel].view(torch.int32)):
                        raise RuntimeError(f"variant {name} changed the bits of {kernel}")
                    ms[name][kernel].append(chip_smoke.cuda_ms(fn, 10))
        finally:
            cuda_build.load = load
        for name, (_, regs) in built.items():
            print(json.dumps(dict(state=label, variant=name, ms=ms[name], registers=regs)),
                  flush=True)
        st, _, pm, _ = sim.packed_carry
        slot, lane = p2g._slot_lanes(pm["s_arr"], pm["e_arr"])
        corner = torch.floor(st[0:3, lane] * sim.cfg.inv_dx - st[43:46, lane] - 0.5)
        same = (corner[:, 1:] == corner[:, :-1]).all(0) & (slot[1:] == slot[:-1])
        print(json.dumps(dict(state=label, particles=int(lane.numel()),
                              same_corner_as_previous=float(same.float().mean()))), flush=True)
        del sim, runs
    print(chip_smoke.nvidia_smi("name,clocks.sm,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
