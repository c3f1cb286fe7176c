#!/usr/bin/env python3
"""Count the SASS instructions that one particle executes in a fused build.

Run on a machine with the CUDA toolkit, after the libraries are built
(``python3 chip_smoke.py`` or ``--kernel-tree`` builds them into
``taichi_mpm_torch/_build/``):

    python3 tools/sass_count.py [LIB.so | DUMP.sass[.gz] ...]

With no argument it counts the single-material libraries of ``p2g`` and
``g2p`` that ``ops.cuda_build`` would load for this checkout. It prints one
JSON line per library: the fused kernel's count per particle and every
loop it met (address range, instructions, trips taken and the rule that
set them), so that the count can be checked against the dump.

How a count is made. ``cuobjdump -sass`` gives the kernel's instructions.
A walk follows them from the entry the way a particle's work goes:

* a guard (a forward conditional branch) falls through to the guarded
  work, except where the code it skips is a few instructions that call a
  subroutine (the slow paths of IEEE division and square root): then
  the fast path is taken; of an if/else the arm laid out first is
  counted;
* a predicated EXIT does not exit; a call is one instruction (the
  subroutine is not entered);
* a loop (a backward branch) runs its body once where it holds another
  loop; an innermost one `trips` times: 6 where the body holds a square
  root (MUFU.RSQ: the SVD's Jacobi sweeps and the polar
  Newton iteration, 6 each), 32 over the particles a trip for the P2G
  scatter's particle loop (an innermost body with a shared-memory load
  and store and no barrier: one full round of 32 particles, one 16-byte
  tile store each), 1 for any other (the rounds and tiles themselves, the
  waits of a hand-over taken as ready, setmaxnreg's retry, the
  per-slot zeroing and write loops, visco's exp approximation, which
  stops at its first k on the states measured);
* in a warp-specialised kernel (one with mbarrier instructions) the
  branch after the block's first barrier splits the roles; both are
  walked and added. A hand-over's wait is walked as one pass of its retry
  loop.

The count is in instruction issue slots of one lane per particle: a P2G
round serves 32 particles with each staging instruction (one lane each)
and with each of the scatter's 32 iterations (all lanes for one
particle), so per particle it is the staging path plus the scatter body
times 32 over 32; a G2P lane is one particle. Per-slot and per-block work
(zeroing a tile, writing it, staging windows beyond the first pass) is
counted once per round or tile, not amortised. The floor that
``chip_smoke.py`` derives, count x particles / (SMs x 4 schedulers x 32
lanes x SM clock), is the time the SMs need to issue these instructions
at one per scheduler and cycle.
"""

from __future__ import annotations

import gzip
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LABEL = re.compile(r"^\s*(\.L_x_\d+|[\w$.]+):\s*$")
FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
TARGET = re.compile(r"`\(([^)]+)\)|\b(0x[0-9a-f]+)\b")

# the fused kernels' mangled names hold these (ops/cuda_build._KERNEL_LABELS)
FUSED = {"p2g": ("StageState",), "g2p": ("g2p_kernel", "g2p_ws_kernel")}
MAX_STEPS = 50_000_000
# a guard skips a slow path when the code it skips is at most this many
# instructions and calls a subroutine (argument moves, the call, a branch)
SLOW_PATH = 12


def sass_text(path: Path) -> str:
    if path.suffix == ".gz":
        return gzip.decompress(path.read_bytes()).decode(errors="replace")
    if path.suffix == ".sass":
        return path.read_text(errors="replace")
    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout


def functions(text: str) -> dict:
    """name -> list of (address, text) and label -> address."""
    out, name, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = FUNC.match(line)
        if m:
            name = m.group(1)
            out[name] = ([], {})
            continue
        if name is None:
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTR.match(line)
        if m:
            addr = int(m.group(1), 16)
            ins, labels = out[name]
            for lab in pending:
                labels[lab] = addr
            pending = []
            ins.append((addr, m.group(2)))
    return out


class Kernel:
    def __init__(self, ins, labels):
        self.addr = [a for a, _ in ins]
        self.text = [t for _, t in ins]
        self.index = {a: i for i, a in enumerate(self.addr)}
        self.labels = labels

    def op(self, i):
        t = self.text[i]
        pred = None
        if t.startswith("@"):
            pred, t = t.split(None, 1)
        return pred, t.split()[0], t

    def target(self, i):
        _, _, t = self.op(i)
        for lab, num in TARGET.findall(t):
            if lab and lab in self.labels:
                return self.index.get(self.labels[lab])
            if num:
                return self.index.get(int(num, 16))
        return None

    def calls_between(self, a, b):
        return any(self.op(k)[1].startswith("CALL") for k in range(a, b))

    def body(self, start, end):
        return [self.op(k)[1] for k in range(start, end + 1)]


def loop_trips(k: Kernel, start: int, end: int) -> tuple:
    """(trips, rule) of the loop with body [start, end]."""
    ops = k.body(start, end)
    inner = not any(k.op(j)[1] == "BRA" and (k.target(j) or j) < j for j in range(start, end))
    if not inner:
        return 1, "once: holds a loop (per round, tile or slot)"
    if any(o.startswith("MUFU.RSQ") for o in ops):
        return 6, "square root: Jacobi sweeps or polar Newton"
    barrier = any(o.startswith(("BAR", "SYNCS", "USETMAXREG")) for o in ops)
    if (not barrier and any(o.startswith("LDS") for o in ops)
            and any(o.startswith("STS") for o in ops)):
        per_trip = max(1, sum(o == "STS.128" for o in ops))  # one tile update a particle
        return 32 // per_trip, f"P2G scatter: 32 particles, {per_trip} a trip"
    return 1, "once: per round, tile or wait"


def walk(k: Kernel, start=0, force=None, split=False):
    """Instructions executed from index `start` (see the module note);
    `force` maps a branch index to taken (True) or not. With `split`,
    stops at the role branch and returns its index too."""
    force = force or {}
    count, i, taken, loops, seen_bar = 0, start, {}, {}, False
    for _ in range(MAX_STEPS):
        if i is None or i >= len(k.text):
            return count, loops, None
        pred, op, _ = k.op(i)
        count += 1
        if op.startswith("BAR.SYNC") or op.startswith("BAR.ARV") or op == "BAR":
            seen_bar = True
        if op == "EXIT":
            if pred is None:
                return count, loops, None
            i += 1
            continue
        if op.startswith("RET"):
            return count, loops, None
        if op == "BRA" or op.startswith("BRA."):
            t = k.target(i)
            if op.startswith("BRA.DIV"):  # taken only in a divergent warp
                i += 1
                continue
            if t is None:
                i += 1
                continue
            if t <= i:  # a loop's back edge
                trips, rule = loop_trips(k, t, i)
                loops[(k.addr[t], k.addr[i])] = dict(
                    start=hex(k.addr[t]), end=hex(k.addr[i]), body=i - t + 1, trips=trips,
                    rule=rule)
                n = taken.get(i, 0)
                if n < trips - 1:
                    taken[i] = n + 1
                    i = t
                else:  # after its trips the loop falls out, back edge or not
                    taken[i] = 0
                    i += 1
                continue
            if pred is None or pred == "@PT":
                i = t
                continue
            if split and seen_bar and i not in force:
                return count, loops, i
            go = force.get(i, t - i <= SLOW_PATH and k.calls_between(i + 1, t))
            i = t if go else i + 1
            continue
        i += 1
    raise RuntimeError("walk did not end")


def per_particle(k: Kernel) -> dict:
    """The count per particle of a fused kernel and its loops: one walk,
    or, in a warp-specialised kernel (one that uses mbarriers), the walk
    up to the role split after its first barrier and each role's walk."""
    ws = any(k.op(i)[1].startswith("SYNCS") for i in range(len(k.text)))
    n, loops, split = walk(k, split=ws)
    if split is None:
        return dict(count=n, loops=list(loops.values()), roles=None)
    roles = {}
    for side in (False, True):
        m, role_loops, _ = walk(k, force={split: side})
        roles["taken" if side else "fall_through"] = dict(
            count=m - n, loops=list(role_loops.values()))
    return dict(count=sum(r["count"] for r in roles.values()), prefix=n,
                split=hex(k.addr[split]), roles=roles)


def count_library(path: Path, src: str) -> dict:
    funcs = functions(sass_text(path))
    for name, (ins, labels) in funcs.items():
        if any(key in name for key in FUSED[src]) and "blocked" not in name:
            return dict(library=path.name, kernel=name, **per_particle(Kernel(ins, labels)))
    return dict(library=path.name, kernel=None)


def default_libraries():
    sys.path.insert(0, str(ROOT))
    from taichi_mpm_torch.ops import cuda_build

    for src in ("p2g", "g2p"):
        for m in range(8):
            yield cuda_build.library_path(src, 1 << m), src


def main(argv):
    targets = ([(Path(a), "p2g" if "p2g" in Path(a).name else "g2p") for a in argv]
               if argv else list(default_libraries()))
    for path, src in targets:
        print(json.dumps(count_library(path, src)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
