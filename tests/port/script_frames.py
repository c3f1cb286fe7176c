"""The JAX package's frames of three scene scripts, each in a process of
its own, for ``test_torch_scripts.py`` (their compiles take 20-45 s
each on the CPU, so the test starts them together and does its other
work meanwhile).

    python tests/port/script_frames.py <robot|sand_layers|stork> <out.npz>

writes the JAX frame's result: the active particles ordered by their id
tag (``scenes.tag_pending``), the bodies, the frame's counts, and for
``stork`` every substep's dt.

- robot: ``scripts/mls-cpic/robot.py`` at res 48, one frame of 6
  substeps through its ``MPM.step``: what the JAX script computes on
  the CPU, where the JAX package runs a 3-D scene's CPIC frame on its
  dense path (its packed CPIC frame in interpret mode compiles several
  times slower). Its snapshot after the frame (``MPM.save``) is written
  beside the result (``snapshot_path``).
- sand_layers: ``scripts/sand_layers.py`` at res 32; the port's scene
  runs 24 substeps alone (the column settles until its layers yield),
  and JAX's fused ``packed_frame`` (Pallas in interpret mode) runs the
  next 6 from that state, which is written too.
- stork: ``scripts/async/stork.py`` at res 32, one 0.01 s frame of
  JAX's fused ``packed_adaptive_frame`` (interpret mode), each
  substep's dt recorded at its call.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CPIC_RES, PLAIN_RES = 48, 32
FRAME_SUBSTEPS = 6
SAND_SETTLE_SUBSTEPS = 24


def snapshot_path(out):
    """Where the robot's JAX snapshot is written beside the result `out`."""
    return str(out)[:-len(".npz")] + "_snapshot.npz"


def settled_sand(res=PLAIN_RES):
    """The port's sand_layers scene after SAND_SETTLE_SUBSTEPS substeps on
    the CPU, ids tagged."""
    from taichi_mpm_torch import scenes

    sim = scenes.tag_pending(scenes.sand_layers(res=res, device="cpu"))
    sim.step(frame_dt=SAND_SETTLE_SUBSTEPS * sim.cfg.base_dt)
    return sim


def main(name, out):
    import jax
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(1)
    jax.config.update("jax_platforms", "cpu")
    for var in ("SHARDS", "ASYNC", "ROBOT_REVERSED"):
        os.environ.pop(var, None)
    sys.path[:0] = [ROOT, HERE]
    from taichi_mpm_tpu.sampling import poisson as jpoisson
    from taichi_mpm_torch import convert, scenes
    from taichi_mpm_torch.rigid.body import BODY_FIELDS
    from taichi_mpm_torch.sampling import poisson as tpoisson

    from port_helpers import by_id, jax_particles
    from test_torch_scripts import jax_script

    jpoisson._periodic_cache = {d: tpoisson.periodic_tile(d) for d in (2, 3)}
    res = CPIC_RES if name == "robot" else PLAIN_RES
    jsim = jax_script(name, res)["sim"]
    scenes.tag_pending(jsim)
    jsim._finalize()
    cfg, colliders = jsim.cfg, tuple(jsim.colliders)
    saved = {}
    if name == "robot":
        jsim.frame_dt = FRAME_SUBSTEPS * cfg.base_dt
        jsim.step()
        p, t = jsim.particles, jsim.t
        saved.update({f"body_{k}": np.asarray(getattr(jsim.bodies, k)) for k in BODY_FIELDS})
        jsim.save(snapshot_path(out))
    elif name == "sand_layers":
        from taichi_mpm_tpu.ops import packed as jpacked

        port = settled_sand(res)
        start = convert.particles_to_numpy(port.particles)
        saved.update({f"start_{k}": v for k, v in start.items()})
        p, t, nmax, _, plast = jpacked.packed_frame(
            jax_particles(start), jnp.float32(port.t), cfg, colliders, cfg.base_dt,
            FRAME_SUBSTEPS, jsim._active_block_cap(), interpret=True, fused=True)
        saved.update(plast=int(plast), nmax=int(nmax), cap=jsim._active_block_cap())
    else:
        from taichi_mpm_tpu.ops import packed as jpacked

        dts = []
        substep = jpacked.packed_substep_presorted

        def recorded(st, keys, pm, tt, cfg_, cols, dt, **kw):
            jax.debug.callback(lambda d: dts.append(np.float32(d)), dt, ordered=True)
            return substep(st, keys, pm, tt, cfg_, cols, dt, **kw)

        jpacked.packed_substep_presorted = recorded
        cap = jsim._active_block_cap()
        p, t, n, nmax = jpacked.packed_adaptive_frame(
            jsim.particles, jnp.float32(0.0), cfg, colliders, jsim.frame_dt, jsim.unit_delta_t,
            cfg.base_dt, cap, jsim.strength_dt_mul, jsim.cfl_dt_mul, interpret=True, fused=True)
        jax.block_until_ready(p.x)
        jax.effects_barrier()
        saved.update(dts=np.asarray(dts, np.float32), n=int(n), nmax=int(nmax), cap=cap)
    saved.update({f"p_{k}": v for k, v in by_id(p).items()})
    saved["t"] = np.float32(t)
    np.savez(out, **saved)


if __name__ == "__main__":
    main(*sys.argv[1:3])
