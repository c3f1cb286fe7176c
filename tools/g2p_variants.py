#!/usr/bin/env python3
"""Time variants of the G2P kernel source at the 8M jelly and 1.4M dam states.

Run from the root of a checkout on a machine with an H100 and nvcc:

    python3 tools/g2p_variants.py [svd]

(with ``svd``, only the SVD build's variants below).

Each variant is ``taichi_mpm_torch/csrc/g2p.cu`` with a few lines
replaced, built with the port's nvcc flags (``-Xptxas -v`` among them,
whose register counts it prints) into ``taichi_mpm_torch/_build/variants/``
for the material sets the states need (jelly's and water's
``g2p_fused``, the material-free ``g2p_blocked``) and loaded in place of
the built libraries:

* ``as_written``: 4 windows staged per block of 128 lanes, rows loaded
  before the gather, the largest shared-memory carveout, F not stored on
  water lanes;
* ``staged2``, ``staged8``: 2 or 8 windows staged;
* ``device_gather``: none staged, every lane gathers from device memory
  through L1 (the gather of the kernel before the staging);
* ``no_prefetch``: F, aux and row 47 loaded once the block has staged its
  windows, not with the other rows before it waits;
* ``threads64``, ``threads256``: 64 or 256 lanes per block;
* ``default_carveout``: the CUDA runtime's default shared-memory carveout;
* ``streaming``: rows loaded and stored with the evict-first hint
  (``__ldcs``, ``__stcs``);
* ``water_f_store``: F stored on every water lane, as before;
* ``gather_only``: the gather alone (key, active row, x, origin and the
  windows read), no state row written, |sum of v and B| taken as vmax;
* ``rows_only``: no gather (v = B = 0), the rows read and written.

On each state of ``chip_smoke.kernel_states`` (after one frame) both G2P
entry points are timed with CUDA events (10 launches, after one) in the
order A, B, ..., B, A. Every variant but the last two must give the bits
of the source as written: ``g2p_fused``'s state, vmax and count on a fresh
copy of the state, and ``g2p_blocked``'s rows. One JSON line per variant
and state (times, registers, the share of lanes whose window the variant
stages).

Then the builds with an SVD return map (sand's and visco's libraries) on
the 8M jelly state made of sand and of visco (``chip_smoke.as_material``),
timed the same way: ``g2p_kernel`` as written and with launch bounds
asking for 6-10 blocks per SM (a register budget per build: 80, 72, 64,
56, 48); the
split design of ``tools/g2p_split.cu`` (a gather and a return-map
warpgroup with their own register budgets), with one or two return-map
warpgroups, and, changing the bits, its gather warpgroup alone (the map
warpgroup waits and releases, no return map); then the jelly build on
the jelly state as written and split. Then the card's name, clock and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

CSRC = ROOT / "taichi_mpm_torch" / "csrc"
OUT = ROOT / "taichi_mpm_torch" / "_build" / "variants"


def staged(n):
    return (("constexpr int STAGED = 4;", f"constexpr int STAGED = {n};"),)


def threads(n):
    return (("constexpr int THREADS = 128;", f"constexpr int THREADS = {n};"),)


GATHER_ONLY = (
    ("    // 4. the finish (fused_pallas._finish_tile, same formulas and order)\n",
     "    vmax = fabsf(v[0] + v[1] + v[2] + B[0] + B[1] + B[2] + B[3] + B[4] + B[5] + B[6]"
     " + B[7] + B[8]);\n  }\n#if 0\n  {\n"),
    ("  // block partials: max |v| (lanes still active) and the plasticity count\n",
     "#endif\n  // block partials\n"),
)
ROWS_ONLY = staged(0) + (("      gather_window(pos, slot, win, K, v, B);\n", ""),)
VARIANTS = {
    "as_written": (),
    "staged2": staged(2),
    "staged8": staged(8),
    "device_gather": staged(0),
    "no_prefetch": (("    rows.load(ld);  // in flight while the block stages its windows\n", ""),
                    ("  if (active) {\n    float pos[3];",
                     "  if (active) {\n    rows.load(ld);\n    float pos[3];")),
    "threads64": threads(64),
    "threads256": threads(256),
    "default_carveout": (("constexpr int CARVEOUT = cudaSharedmemCarveoutMaxShared;",
                          "constexpr int CARVEOUT = cudaSharedmemCarveoutDefault;"),),
    "streaming": (("  auto ld = [&](int r) { return S[(long long)r * pw]; };",
                   "  auto ld = [&](int r) { return __ldcs(S + (long long)r * pw); };"),
                  ("  auto put = [&](int r, float value) { S[(long long)r * pw] = value; };",
                   "  auto put = [&](int r, float value) { __stcs(S + (long long)r * pw, value); };")),
    "water_f_store": (("      if (write_F) {\n", "      {\n"),),
    "gather_only": GATHER_ONLY,
    "rows_only": ROWS_ONLY,
}
CHANGES_BITS = ("gather_only", "rows_only")


def blocks(n):
    """g2p_kernel's launch bounds asking for n blocks per SM: a register
    budget of 65536 / (128 n) a thread."""
    return (("__global__ void __launch_bounds__(THREADS)\ng2p_kernel(",
             f"__global__ void __launch_bounds__(THREADS, {n})\ng2p_kernel("),)


def split_budget(n, gather, maps):
    return (("  static constexpr int kMinBlocks = kVisco ? 3 : 4;\n"
             "  static constexpr int kGather = kVisco ? 56 : 48;\n"
             "  static constexpr int kMap = kVisco ? 104 : 80;\n",
             f"  static constexpr int kMinBlocks = {n};\n"
             f"  static constexpr int kGather = {gather};\n"
             f"  static constexpr int kMap = {maps};\n"),)


# the return-map builds' variants, each (source, edits): "g2p" the port's
# csrc/g2p.cu, "split" tools/g2p_split.cu (its own note); timed on the 8M
# state made of the materials of SVD_STATES; the last split one changes
# the bits
SVD_VARIANTS = {
    "kernel": ("g2p", ()),
    **{f"blocks{n}": ("g2p", blocks(n)) for n in (6, 7, 8, 9, 10)},
    "split": ("split", ()),
    "split_maps2": ("split", (("constexpr int WS_MAPS = 1;", "constexpr int WS_MAPS = 2;"),)
                    + split_budget(2, 48, 96)),
    "split_gather_only": ("split", (
        ("          material_plasticity<M>(rows.F, cdg, rows.aux, rows.par, prm.dt, pl);\n",
         "          pl.count = 0;\n          pl.aux = rows.aux;\n"
         "          for (int k = 0; k < 9; ++k) pl.F[k] = rows.F[k];\n"),)),
}
SVD_CHANGES_BITS = ("split_gather_only",)
SVD_STATES = {"sand": ("kernel", "blocks9", "blocks10", "split", "split_maps2",
                       "split_gather_only"),
              "visco": ("kernel", "blocks6", "blocks7", "blocks8", "split", "split_maps2"),
              "jelly": ("kernel", "split")}


def variant_source(edits, source="g2p") -> str:
    src = (CSRC / "g2p.cu" if source == "g2p" else ROOT / "tools" / "g2p_split.cu").read_text()
    for old, new in edits:
        n = src.count(old)
        if n != 1:
            raise RuntimeError(f"variant edit matched {n} times: {old!r}")
        src = src.replace(old, new)
    return src


KERNEL_NAMES = {"g2p_kernelILi2E": "g2p_fused jelly", "g2p_kernelILi8E": "g2p_fused water",
                "g2p_kernelILi10E": "g2p_fused both", "g2p_blocked_kernel": "g2p_blocked",
                "g2p_ws_kernelILi16E": "g2p_fused sand", "g2p_ws_kernelILi128E": "g2p_fused visco",
                "g2p_kernelILi16E": "g2p_fused sand", "g2p_kernelILi128E": "g2p_fused visco"}


def ptxas_registers(log: str) -> dict:
    """ptxas -v's spill and register lines of each kernel."""
    regs, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = next((v for k, v in KERNEL_NAMES.items() if k in line), line.split("'")[1])
        elif fn and ("spill" in line or "registers" in line):
            regs[fn] = (regs.get(fn, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return regs


# the material sets of the libraries a variant is built for: the
# material-free one (g2p_blocked), jelly's and water's (g2p_fused)
SETS = (0, 1 << 1, 1 << 3)


def build_all(names):
    """One nvcc per variant and material set, all at once (the SVD
    variants for sand's and visco's sets alone); returns name -> ({set:
    library}, registers)."""
    from taichi_mpm_torch.ops import cuda_build

    OUT.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, OUT / header.name)
    procs = {}
    variants = {**{n: ("g2p", e) for n, e in VARIANTS.items()}, **SVD_VARIANTS}
    for name, (source, edits) in variants.items():
        if name not in names:
            continue
        (OUT / f"g2p_{name}.cu").write_text(variant_source(edits, source))
        svd = [1 << chip_smoke.MATERIALS.index(m) for m, vs in SVD_STATES.items() if name in vs]
        for mats in (SETS if name in VARIANTS else svd):
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-DTMT_MATS={mats}",
                   f"-I{CSRC}", "-o", str(OUT / f"g2p_{name}_m{mats}.so"),
                   str(OUT / f"g2p_{name}.cu")]
            procs[name, mats] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT)
    built = {}
    for (name, mats), proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (set {mats}):\n{log}")
        libs, regs = built.setdefault(name, ({}, {}))
        libs[mats] = ctypes.CDLL(str(OUT / f"g2p_{name}_m{mats}.so"))
        regs.update(ptxas_registers(log))
    return built


def time_svd(sim, built):
    """The SVD variants on the 8M state of `sim` made of sand and of visco,
    in the order A, B, ..., B, A; each arithmetic-keeping variant must
    give the state, vmax and count of the source as written."""
    import torch

    from taichi_mpm_torch.ops import cuda_build, g2p

    st0, _, pm, _ = sim.packed_carry
    keys, dt = pm["slot_keys"], sim.cfg.base_dt
    load = cuda_build.load
    for material, names in SVD_STATES.items():
        st = chip_smoke.as_material(st0, material)
        cfg = sim.cfg.with_materials((chip_smoke.MATERIALS.index(material),))
        win = chip_smoke.g2p_windows(sim, st, pm)
        scratch = st.clone()
        ref, ms = None, {name: [] for name in names}
        try:
            for name in [*names, *reversed(names)]:
                cuda_build.load = lambda _, mats=0, libs=built[name][0]: libs[mats]
                new = st.clone()
                outs = [new, *g2p.g2p_fused(keys, new, win, dt, cfg)]
                torch.cuda.synchronize()
                bits = [o.view(torch.int32) if o.is_floating_point() else o for o in outs]
                ref = ref or bits
                if name not in SVD_CHANGES_BITS and not all(map(torch.equal, bits, ref)):
                    raise RuntimeError(f"variant {name} changed the bits of {material}")
                del new, outs, bits
                ms[name].append(chip_smoke.cuda_ms(
                    lambda: g2p.g2p_fused(keys, scratch, win, dt, cfg), 10))
        finally:
            cuda_build.load = load
        for name in names:
            print(json.dumps(dict(state=f"{material}_8m", variant=name, ms=ms[name],
                                  registers=built[name][1])), flush=True)
        del st, win, scratch, ref


def main():
    import torch

    from taichi_mpm_torch import diagnostics
    from taichi_mpm_torch.ops import cuda_build, g2p

    if not torch.cuda.is_available():
        print("g2p_variants: no CUDA device", file=sys.stderr)
        return 2
    only = sys.argv[1:] == ["svd"]
    built = build_all([*([] if only else VARIANTS), *SVD_VARIANTS])
    svd = {name: built.pop(name) for name in SVD_VARIANTS}
    load = cuda_build.load
    for label, sim in chip_smoke.kernel_states():
        if label == "jelly_8m":
            time_svd(sim, svd)
        if only:
            break
        cfg, dt = sim.cfg, sim.cfg.base_dt
        st, _, pm, _ = sim.packed_carry
        keys, win = pm["slot_keys"], chip_smoke.g2p_windows(sim, st, pm)
        scratch = st.clone()
        runs = {"g2p_fused": lambda: g2p.g2p_fused(keys, scratch, win, dt, cfg),
                "g2p_blocked": lambda: g2p.g2p_blocked(keys, st, win, cfg)}
        ref, ms = None, {name: {k: [] for k in runs} for name in built}
        try:
            for name in [*built, *reversed(list(built))]:
                libs = built[name][0]
                cuda_build.load = lambda _, mats=0, libs=libs: libs[mats]
                new = st.clone()
                outs = [new, *g2p.g2p_fused(keys, new, win, dt, cfg),
                        g2p.g2p_blocked(keys, st, win, cfg)]
                torch.cuda.synchronize()
                bits = [o.view(torch.int32) if o.is_floating_point() else o for o in outs]
                ref = ref or bits
                if name not in CHANGES_BITS and not all(map(torch.equal, bits, ref)):
                    raise RuntimeError(f"variant {name} changed the bits at {label}")
                del new, outs, bits
                for kernel, fn in runs.items():
                    ms[name][kernel].append(chip_smoke.cuda_ms(fn, 10))
        finally:
            cuda_build.load = load
        K = win.shape[0]
        for name, (libs, regs) in built.items():
            share = diagnostics.g2p_staged_share(keys, st, libs[0].g2p_block_lanes(),
                                                 libs[0].g2p_staged_windows(), K)
            print(json.dumps(dict(state=label, variant=name, ms=ms[name], staged_share=share,
                                  registers=regs)), flush=True)
        del sim, runs, scratch, win, ref
    print(chip_smoke.nvidia_smi("name,clocks.sm,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
