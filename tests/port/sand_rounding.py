"""Is the port's sand drift over a frame rounding? A script, not a test.

    python tests/port/sand_rounding.py [--seed N] [--collision] [--column]

Prints, for the sand return map (``cforms.plast_sand``):

1. one call on the random inputs of ``test_torch_cforms.py``: the JAX
   float32 result and the port's float32 result, each against the port's
   formula evaluated in float64;
2. the 6-substep multi-material frame of ``test_torch_frame.py`` (jelly,
   sand, water, seed 41; ``--collision`` adds particle collision and the
   boundary clean): per material, the port against the JAX frame, and the
   JAX frame against itself with every sand F moved by one ulp (up or
   down, drawn from ``--seed``).

With ``--column``, instead: one frame (0.01 s, 20 adaptive substeps) of
``scenes.sand_column`` (``scripts/async/sand.py`` at res 64) on the CPU,
against the same frame with every F of the input moved by one ulp, for
three draws of the directions (seeds 0-2): the noise by which
``chip_smoke.py``'s ``sand_column_check`` sets its F and aux bounds.

If the port's difference is of the size a one-ulp change of the input
makes, it is rounding, not a fault.
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_helpers import configs, jax_particles, max_err, scene_arrays  # noqa: E402
from taichi_mpm_torch import convert  # noqa: E402
from taichi_mpm_torch.core import levelset as tls  # noqa: E402
from taichi_mpm_torch.materials import cforms as tcf  # noqa: E402
from taichi_mpm_torch.materials import models as tmodels  # noqa: E402
from taichi_mpm_torch.ops import packed as tpacked  # noqa: E402
from taichi_mpm_tpu.core import levelset as jls  # noqa: E402
from taichi_mpm_tpu.materials import cforms as jcf  # noqa: E402
from taichi_mpm_tpu.ops import packed as jpacked  # noqa: E402


def one_call():
    rng = np.random.default_rng(1 + tmodels.MATERIAL_NAMES["sand"])
    n = 512
    mid, params, aux0 = tmodels.pack_params("sand")
    F = np.eye(3, dtype=np.float32)[None] + 0.2 * rng.standard_normal((n, 3, 3)).astype(np.float32)
    cdg = np.eye(3, dtype=np.float32)[None] + 0.02 * rng.standard_normal((n, 3, 3)).astype(np.float32)
    aux = (aux0 + 0.05 * rng.standard_normal(n)).astype(np.float32)
    par = np.broadcast_to(np.asarray(params, np.float32), (n, 8)).copy()
    par *= (1.0 + 0.1 * rng.random((n, 8))).astype(np.float32)

    def run(fns, conv):
        rows = lambda a: tuple(conv(a[:, i, k].copy()) for i in range(3) for k in range(3))
        F_new, aux_new, _ = fns[mid](rows(F), rows(cdg), conv(aux),
                                     tuple(conv(par[:, k].copy()) for k in range(8)), 2e-4)
        return ([np.asarray(f, np.float64) for f in F_new], np.asarray(aux_new, np.float64))

    Fj, auxj = run(jcf.PLASTICITY_FNS, jnp.asarray)
    Ft, auxt = run(tcf.PLASTICITY_FNS, torch.as_tensor)
    Fd, auxd = run(tcf.PLASTICITY_FNS, lambda a: torch.as_tensor(a).double())
    F_off = lambda Fs: max(np.abs(a - b).max() for a, b in zip(Fs, Fd))
    print(f"one call: aux  JAX f32 - f64 {np.abs(auxj - auxd).max():.3e}, "
          f"port f32 - f64 {np.abs(auxt - auxd).max():.3e}, JAX - port {np.abs(auxj - auxt).max():.3e}")
    print(f"one call: F    JAX f32 - f64 {F_off(Fj):.3e}, port f32 - f64 {F_off(Ft):.3e}")


def frame(seed, collision):
    a, mids = scene_arrays(1200, seed=41, mats=("jelly", "sand", "water"))
    extra = dict(particle_collision=True, clean_boundary=True) if collision else {}
    jcfg, tcfg = configs(mids, **extra)
    lo, hi = (0.12,) * 3, (0.88,) * 3
    jcol = (jls.box_domain(lo, hi, friction=-1.0),
            jls.plane((0.0, 0.39, 0.0), (0.0, 1.0, 0.0), friction=0.3))
    tcol = (tls.box_domain(lo, hi, friction=-1.0),
            tls.plane((0.0, 0.39, 0.0), (0.0, 1.0, 0.0), friction=0.3))

    def jframe(arrays):
        return jpacked.packed_frame(jax_particles(arrays), jnp.float32(0.0), jcfg, jcol,
                                    jcfg.base_dt, 6, 192, interpret=True, fused=True)[0]

    jp = jframe(a)
    tp = tpacked.packed_frame(convert.particles_from_numpy(a), np.float32(0.0), tcfg, tcol,
                              tcfg.base_dt, 6, 192)[0]
    b = {k: v.copy() for k, v in a.items()}
    sand = b["mat"] == tmodels.SAND
    toward = np.where(np.random.default_rng(seed).random(b["F"].shape) < 0.5, -np.inf, np.inf)
    b["F"][sand] = np.nextafter(b["F"][sand], toward[sand].astype(np.float32))
    jq = jframe(b)

    names = {v: k for k, v in tmodels.MATERIAL_NAMES.items()}
    act = tp.active.numpy()
    mat = tp.mat.numpy()
    for m in np.unique(mat[act]):
        s = act & (mat == m)
        for f in ("F", "aux"):
            J = np.asarray(getattr(jp, f))[s]
            print(f"frame: {names[int(m)]:6s} {f:4s} JAX - port {max_err(J, getattr(tp, f).numpy()[s]):.3e}, "
                  f"JAX - JAX(sand F +-1 ulp) {max_err(J, np.asarray(getattr(jq, f))[s]):.3e}")


def column():
    from taichi_mpm_torch import scenes

    def run(seed=None):
        sim = scenes.sand_column(device="cpu")
        sim._ensure_finalized()
        if seed is not None:
            p = sim.particles
            F, act = p.F.numpy(), p.active.numpy()
            toward = np.where(np.random.default_rng(seed).random(F.shape) < 0.5, -np.inf, np.inf)
            F[act] = np.nextafter(F[act], toward[act].astype(np.float32))
        sim.step()
        return sim

    base = run()
    act = base.particles.active.numpy()
    for seed in range(3):
        moved = run(seed)
        errs = {f: max_err(getattr(base.particles, f).numpy()[act],
                           getattr(moved.particles, f).numpy()[act])
                for f in ("x", "v", "F", "C", "aux")}
        print(f"column: substeps {base.last_substeps} and {moved.last_substeps}, "
              f"frame - frame(F +-1 ulp, seed {seed}): "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=5, help="draws the direction of each ulp step")
    ap.add_argument("--collision", action="store_true",
                    help="particle collision and boundary clean on, as in test_torch_frame.py")
    ap.add_argument("--column", action="store_true",
                    help="the one-ulp noise of a sand column frame instead")
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.column:
        column()
        return
    one_call()
    frame(args.seed, args.collision)


if __name__ == "__main__":
    main()
