#!/usr/bin/env python3
"""Time variants of the G2P kernel source at the 8M jelly and 1.4M dam states.

Run from the root of a checkout on a machine with an H100 and nvcc:

    python3 tools/g2p_variants.py

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
stages), then the card's name, clock and power limit.
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


def variant_source(edits) -> str:
    src = (CSRC / "g2p.cu").read_text()
    for old, new in edits:
        n = src.count(old)
        if n != 1:
            raise RuntimeError(f"variant edit matched {n} times: {old!r}")
        src = src.replace(old, new)
    return src


KERNEL_NAMES = {"g2p_kernelILi2E": "g2p_fused jelly", "g2p_kernelILi8E": "g2p_fused water",
                "g2p_kernelILi10E": "g2p_fused both", "g2p_blocked_kernel": "g2p_blocked"}


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


def build_all():
    """One nvcc per variant and material set, all at once; returns
    name -> ({set: library}, registers)."""
    from taichi_mpm_torch.ops import cuda_build

    OUT.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, OUT / header.name)
    procs = {}
    for name, edits in VARIANTS.items():
        (OUT / f"g2p_{name}.cu").write_text(variant_source(edits))
        for mats in SETS:
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-DTMT_MATS={mats}",
                   "-o", str(OUT / f"g2p_{name}_m{mats}.so"), str(OUT / f"g2p_{name}.cu")]
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


def main():
    import torch

    from taichi_mpm_torch import diagnostics
    from taichi_mpm_torch.ops import cuda_build, g2p

    if not torch.cuda.is_available():
        print("g2p_variants: no CUDA device", file=sys.stderr)
        return 2
    built = build_all()
    load = cuda_build.load
    for label, sim in chip_smoke.kernel_states():
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
