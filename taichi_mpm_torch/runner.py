"""Frame runner for scene scripts (torch counterpart of the repo's
``scripts/common.py``): the frame loop with per-frame BGEO output,
snapshots, ``--continue`` restarts and energy printing.

A scene script on the port reads

    from taichi_mpm_torch import runner, scenes
    args = runner.parse_args(frames=100, res=64)
    sim = scenes.water_script(res=args.res, device=args.device)
    runner.simulate(sim, args)

and the module runs the scripts' counterparts in ``scenes`` itself:

    python -m taichi_mpm_torch.runner water --res 32 --frames 3 --cpu --out out/
    python -m taichi_mpm_torch.runner balls --res 32 --frames 2 --cpu
    python -m taichi_mpm_torch.runner sand_paddles --frame-dt 1e-3 --out out/
    python -m taichi_mpm_torch.runner water_wheel --res 32 --frames 2 --cpu --frame-dt 2e-3
    python -m taichi_mpm_torch.runner colliding_balls_energy --res 32 --frames 2 --cpu
    python -m taichi_mpm_torch.runner tetris --frames 5 --cpu --out out/
    python -m taichi_mpm_torch.runner sand_wheel_2d --res 128 --frames 3 --cpu
    python -m taichi_mpm_torch.runner robot --res 32 --frames 1 --cpu --frame-dt 1.5e-4
    python -m taichi_mpm_torch.runner stork --res 32 --frames 1 --cpu

With SHARDS=N under ``torchrun`` a scene that takes the runner's solver
class runs on N ranks (``parallel.driver.DistributedMPM``, one GPU per
rank over nccl; with ``--cpu``, gloo on the CPU):

    SHARDS=2 torchrun --nproc-per-node 2 -m taichi_mpm_torch.runner colliding_balls_energy
    SHARDS=2 torchrun --nproc-per-node 2 -m taichi_mpm_torch.runner water_wheel --frames 120

Frames go to ``<out>/<frame>.bgeo`` (five digits), snapshots to
``<out>/snapshot_<frame>.npz`` every ``--snapshot-interval`` frames, and
``--continue F`` resumes from ``<out>/snapshot_F.npz`` (this package's or
the JAX package's) at frame F + 1. Without ``--cpu`` the scene runs on
the card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import time


def parse_args(argv=None, **defaults):
    """The scene scripts' options: --frames, --res, --out, --cpu (run on
    the CPU: ``args.device`` is "cpu", else None, the card),
    --snapshot-interval, --continue, --verbose-bgeo, --frame-dt. With
    ``scene=True`` among `defaults` a leading scene name (``SCENES``) is
    read too."""
    ap = argparse.ArgumentParser()
    if defaults.pop("scene", False):
        ap.add_argument("scene", choices=sorted(SCENES))
    ap.add_argument("--frames", type=int, default=defaults.get("frames", 60))
    ap.add_argument("--res", type=int, default=defaults.get("res", 0))
    ap.add_argument("--out", type=str, default=defaults.get("out", ""))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain-torch twins)")
    ap.add_argument("--snapshot-interval", type=int, default=0)
    ap.add_argument("--continue", dest="cont", type=int, default=-1,
                    help="resume from the snapshot of this frame")
    ap.add_argument("--verbose-bgeo", action="store_true")
    ap.add_argument("--frame-dt", type=float, default=0.0,
                    help="override the scene's frame_dt (caps substeps per frame)")
    args = ap.parse_args(argv)
    args.device = "cpu" if args.cpu else None
    return args


def mpm_class(device=None):
    """The scene's solver class, bound to `device`: ``MPM``; or, with
    SHARDS=N > 1, ``DistributedMPM`` over the torch.distributed group of N
    ranks that ``torchrun`` launched (``main`` joins it; without such a
    group this raises and says how to launch); or, with ASYNC=1,
    ``AsyncMPM`` at global adaptive dt (UNIT_DT the power-of-two unit,
    default 1e-6; ASYNC_MAX_DT, where set, the largest dt in place of the
    scene's base_delta_t). SHARDS takes precedence over ASYNC, as in the
    JAX package's runner."""
    import torch.distributed as dist

    from taichi_mpm_torch.core.adaptive import AsyncMPM
    from taichi_mpm_torch.core.solver import MPM

    n = int(os.environ.get("SHARDS", "1"))
    if n > 1:
        from taichi_mpm_torch.parallel.driver import DistributedMPM

        world = dist.get_world_size() if dist.is_initialized() else 0
        if world != n:
            raise RuntimeError(
                f"SHARDS={n} runs DistributedMPM on a torch.distributed group of {n} ranks, "
                f"and {'none is initialized' if not world else f'this one has {world}'}: "
                f"launch `SHARDS={n} torchrun --nproc-per-node {n} -m taichi_mpm_torch.runner "
                "<scene> ...` (one GPU per rank over nccl; gloo on the CPU with --cpu)")
        return functools.partial(DistributedMPM, n_shards=n, device=device)
    if os.environ.get("ASYNC", "0") == "1":
        unit = float(os.environ.get("UNIT_DT", "1e-6"))
        max_dt = os.environ.get("ASYNC_MAX_DT")

        def cls(*a, **k):
            if max_dt is not None:
                k["base_delta_t"] = float(max_dt)
            k.setdefault("unit_delta_t", unit)
            k.setdefault("device", device)
            return AsyncMPM(*a, **k)

        return cls
    return functools.partial(MPM, device=device)


@contextlib.contextmanager
def launched_group(args):
    """The process group of a ``torchrun`` launch with SHARDS > 1, joined
    for the run and left after it: gloo with --cpu, else nccl (one GPU
    per rank). Nothing where SHARDS is unset or a group already exists."""
    import torch.distributed as dist

    if int(os.environ.get("SHARDS", "1")) <= 1 or dist.is_initialized() \
            or "WORLD_SIZE" not in os.environ:
        yield
        return
    from taichi_mpm_torch.parallel import comm

    if not args.cpu:
        import torch

        torch.cuda.set_device(comm.rank_device())
    dist.init_process_group("gloo" if args.cpu else "nccl", init_method="env://")
    try:
        yield
    finally:
        dist.destroy_process_group()


def snapshot_path(out: str, frame: int) -> str:
    return os.path.join(out, f"snapshot_{frame:05d}.npz")


def frame_path(out: str, frame: int) -> str:
    return os.path.join(out, f"{frame:05d}.bgeo")


def simulate(sim, args, frame_update=None, print_energy=False):
    """The frame loop: frames from 0 (or from ``--continue`` + 1, after
    loading that snapshot) to ``--frames``; each after frame_update(sim,
    f), printed with its time, particle count and wall time (and the
    energy), written to ``--out`` as BGEO and, every
    ``--snapshot-interval`` frames, as a snapshot. On slabs every rank
    runs it; rank 0 prints and writes."""
    if getattr(args, "frame_dt", 0.0):
        sim.frame_dt = args.frame_dt
    out = args.out or None
    if out:
        os.makedirs(out, exist_ok=True)
    start = 0
    if args.cont >= 0 and out:
        sim.load(snapshot_path(out, args.cont))
        start = args.cont + 1
    for f in range(start, args.frames):
        if frame_update is not None:
            frame_update(sim, f)
        t0 = time.perf_counter()
        sim.step()
        wall = time.perf_counter() - t0
        n = sim.particle_count()
        msg = f"frame {f:05d}  t={float(sim.t):.4f}  particles={n}  wall={wall*1e3:.0f}ms"
        if print_energy:
            msg += f"  E={sim.energy():.5f}"
        if getattr(sim, "rank", 0) == 0:
            print(msg, flush=True)
        if out:
            sim.visualize(frame_path(out, f), verbose=args.verbose_bgeo)
            if args.snapshot_interval and f % args.snapshot_interval == 0:
                sim.save(snapshot_path(out, f))
    return sim


def _script(name, res=None, source=None, solver=True, **kw):
    """A runner entry of the scene `name` of ``scenes``: at --res, or its
    script's default `res` (None: a scene without one), on the runner's
    solver class (``mpm_class``) where its script takes it, with the
    frame_update `source` of ``scenes``."""
    def make(args):
        from taichi_mpm_torch import scenes

        skw = dict(kw, solver=mpm_class(args.device)) if solver else dict(kw)
        if res is not None:
            skw["res"] = args.res or res
        sim = getattr(scenes, name)(device=args.device, **skw)
        return sim, None if source is None else getattr(scenes, source)

    return make


# the scene scripts' counterparts: name -> (args -> (sim, frame_update)).
# The timing harnesses of scripts/benchmark (benchmark_3d.py,
# multichip_scaling.py) come with the port's benchmark
# (ROADMAP.md queue 1, 'benchmark')
SCENES = {"water": _script("water_script", 64, solver=False),
          "balls": _script("async_balls", 64, solver=False),
          "sand_paddles": _script("sand_paddles", 64, source="sand_paddles_source"),
          "water_wheel": _script("water_wheel", 64, source="water_wheel_source"),
          "colliding_balls_energy": _script("colliding_balls_energy", 100),
          "oscillating_jello": _script("oscillating_jello", 50),
          "tetris": _script("tetris", 128), "mpm88": _script("mpm88"),
          "sand_wheel_2d": _script("sand_wheel_2d", 128, source="sand_wheel_2d_source"),
          "async_wheel": _script("async_wheel", 128, solver=False),
          "combo": _script("async_combo", 64, solver=False),
          "sand": _script("async_sand", 64, solver=False),
          "slope": _script("async_slope", 64, solver=False),
          "stork": _script("async_stork", 64, solver=False),
          "banana": _script("banana", 96), "bunny_split": _script("bunny_split", 96),
          "buoyancy": _script("buoyancy", 64, source="buoyancy_source"),
          "goo_blocks": _script("goo_blocks", 64), "robot": _script("robot", 64),
          "robot_reversed": _script("robot", 64, reversed=True),
          "sand_stir": _script("sand_stir", 64), "sand_sweep": _script("sand_sweep", 64),
          "sand_layers": _script("sand_layers", 64, solver=False),
          "colliding_balls_3d_test": _script("colliding_balls_3d", 64, solver=False)}
# the scenes that print their energy every frame, as their scripts do
ENERGY_SCENES = ("colliding_balls_energy", "oscillating_jello")


def main(argv=None):
    args = parse_args(argv, scene=True)
    with launched_group(args):
        sim, frame_update = SCENES[args.scene](args)
        simulate(sim, args, frame_update=frame_update,
                 print_energy=args.scene in ENERGY_SCENES)
    if hasattr(sim, "update_counter"):
        print("total particle updates:", sim.update_counter)
    return sim


if __name__ == "__main__":
    main()
