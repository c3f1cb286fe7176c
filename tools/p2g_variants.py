#!/usr/bin/env python3
"""Time variants of the P2G kernel source at the 8M jelly state.

Run from the root of a checkout on a machine with an H100 and nvcc:

    python3 tools/p2g_variants.py [hencky]

(with ``hencky``, only the Hencky build's variants below).

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
kernel could keep in registers).

Then the Hencky build (sand's library; the warp-specialised block of one
consumer warp and producer warps, see the note in ``p2g.cu``) on the 8M
jelly state made of sand (``chip_smoke.as_material``), timed the same
way: 2 or 4 producer warps for 3, a ring of 3 or 8 stages for 4, the
launch bounds asking for 1 block per SM (80 registers: the ptxas
default) instead of 8 (64), blocks of 2
producers and 2 stages (alone, and asking for 10 blocks per SM), of one
producer and 2 stages, the parent's schedule (``p2g_kernel``, one warp
staging and scattering in turn), and, changing the bits, the staging
alone (the consumer waits and releases, and adds one value a round so
that the records stay live) and the scatter alone (the producers write
records of constant values without loading or building). The last two
size the ring and the ratio of producers to the consumer. Then the jelly build on the jelly
state with its own schedule and with the warp-specialised one. Then the
card's name, clock and power limit.
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

# the Hencky build's variants, built for sand's set, timed on the 8M state
# made of sand; the last two change the bits
HENCKY_VARIANTS = {
    "ws_as_written": (),
    "ws_producers2": (("constexpr int WS_PRODUCERS = 3;", "constexpr int WS_PRODUCERS = 2;"),),
    "ws_producers4": (("constexpr int WS_PRODUCERS = 3;", "constexpr int WS_PRODUCERS = 4;"),),
    "ws_stages3": (("constexpr int WS_STAGES = 4;", "constexpr int WS_STAGES = 3;"),),
    "ws_stages8": (("constexpr int WS_STAGES = 4;", "constexpr int WS_STAGES = 8;"),),
    "ws_min_blocks1": (("constexpr int WS_MIN_BLOCKS = 8;", "constexpr int WS_MIN_BLOCKS = 1;"),),
    "ws_p2s2": (("constexpr int WS_PRODUCERS = 3;", "constexpr int WS_PRODUCERS = 2;"),
                ("constexpr int WS_STAGES = 4;", "constexpr int WS_STAGES = 2;")),
    "ws_p2s2_min10": (("constexpr int WS_PRODUCERS = 3;", "constexpr int WS_PRODUCERS = 2;"),
                      ("constexpr int WS_STAGES = 4;", "constexpr int WS_STAGES = 2;"),
                      ("constexpr int WS_MIN_BLOCKS = 8;", "constexpr int WS_MIN_BLOCKS = 10;")),
    "ws_p1s2": (("constexpr int WS_PRODUCERS = 3;", "constexpr int WS_PRODUCERS = 1;"),
                ("constexpr int WS_STAGES = 4;", "constexpr int WS_STAGES = 2;")),
    "parent_schedule": (("  if constexpr (hencky_build<MATS>()) {\n    return launch_ws(",
                         "  if constexpr (false) {\n    return launch_ws("),),
    # the consumer reads one value a round, so that the records stay live
    "staging_only": (("      scatter_round(ring[q], min(32, e - s - 32 * r), tile, lane);\n",
                      "      if (lane == 0) tile[0].x += ring[q][0][0].x;\n      __syncwarp();\n"),),
    "scatter_only": (("        stage.load(pw, (long long)base + lane, rows);\n"
                      "        stage.build(rows, sv);\n",
                      "        for (int k = 0; k < NV; ++k) sv[k] = 0.5f;\n"),),
    "ws_everywhere": (("  return has<MATS>(ELASTIC) || has<MATS>(SAND) || has<MATS>(VON_MISES);",
                       "  return true;"),),
}
HENCKY_CHANGES_BITS = ("staging_only", "scatter_only")
# the states each variant is timed on: sand's, and jelly's for the new
# schedule against the one its build keeps
HENCKY_STATES = {"sand": tuple(v for v in HENCKY_VARIANTS if v != "ws_everywhere"),
                 "jelly": ("ws_as_written", "ws_everywhere")}


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


def build_all(names):
    """One nvcc per variant and material set, all at once (the Hencky
    variants for sand's set alone); returns name -> ({set: library},
    ptxas lines)."""
    from taichi_mpm_torch.ops import cuda_build

    OUT.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, OUT / header.name)
    procs = {}
    for name, edits in {**VARIANTS, **HENCKY_VARIANTS}.items():
        if name not in names:
            continue
        (OUT / f"p2g_{name}.cu").write_text(variant_source(edits))
        hencky = [1 << chip_smoke.MATERIALS.index(m) for m, vs in HENCKY_STATES.items()
                  if name in vs]
        for mats in (SETS if name in VARIANTS else hencky):
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


def time_hencky(sim, built):
    """The Hencky variants on the 8M state of `sim` made of each material
    of HENCKY_STATES, in the order A, B, ..., B, A; each
    arithmetic-keeping variant must give the tiles of the source as
    written."""
    import torch

    from taichi_mpm_torch.ops import cuda_build, p2g

    st0, _, pm, _ = sim.packed_carry
    s_arr, e_arr, dt = pm["s_arr"], pm["e_arr"], sim.cfg.base_dt
    load = cuda_build.load
    for material, names in HENCKY_STATES.items():
        st = chip_smoke.as_material(st0, material)
        cfg = sim.cfg.with_materials((chip_smoke.MATERIALS.index(material),))
        ref, ms = None, {name: [] for name in names}
        try:
            for name in [*names, *reversed(names)]:
                cuda_build.load = lambda _, mats=0, libs=built[name][0]: libs[mats]
                tiles = p2g.p2g_fused(s_arr, e_arr, st, dt, cfg)
                torch.cuda.synchronize()
                ref = tiles if ref is None else ref
                if name not in HENCKY_CHANGES_BITS and not torch.equal(
                        tiles.view(torch.int32), ref.view(torch.int32)):
                    raise RuntimeError(f"variant {name} changed the bits of {material}")
                del tiles
                ms[name].append(chip_smoke.cuda_ms(
                    lambda: p2g.p2g_fused(s_arr, e_arr, st, dt, cfg), 10))
        finally:
            cuda_build.load = load
        for name in names:
            print(json.dumps(dict(state=f"{material}_8m", variant=name, ms=ms[name],
                                  registers=built[name][1])), flush=True)
        del st, ref


def main():
    import torch

    from taichi_mpm_torch.ops import cuda_build, p2g

    if not torch.cuda.is_available():
        print("p2g_variants: no CUDA device", file=sys.stderr)
        return 2
    only = sys.argv[1:] == ["hencky"]
    built = build_all([*([] if only else VARIANTS), *HENCKY_VARIANTS])
    hencky = {name: built.pop(name) for name in HENCKY_VARIANTS}
    load = cuda_build.load
    for label, sim in chip_smoke.kernel_states():
        if label == "jelly_8m":
            time_hencky(sim, hencky)
        if only:
            break
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
