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
    python -m taichi_mpm_torch.runner sand_paddles --frame-dt 1e-3 --out out/

Frames go to ``<out>/<frame>.bgeo`` (five digits), snapshots to
``<out>/snapshot_<frame>.npz`` every ``--snapshot-interval`` frames, and
``--continue F`` resumes from ``<out>/snapshot_F.npz`` (this package's or
the JAX package's) at frame F + 1. Without ``--cpu`` the scene runs on
the card.
"""

from __future__ import annotations

import argparse
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
    ASYNC=1, ``AsyncMPM`` at global adaptive dt (UNIT_DT the power-of-two
    unit, default 1e-6; ASYNC_MAX_DT, where set, the largest dt in place
    of the scene's base_delta_t). SHARDS > 1 asks for the multi-device
    driver, which the port does not have yet."""
    from taichi_mpm_torch.core.adaptive import AsyncMPM
    from taichi_mpm_torch.core.solver import MPM

    n = int(os.environ.get("SHARDS", "1"))
    if n > 1:
        raise NotImplementedError(
            f"SHARDS={n} selects the multi-device driver (DistributedMPM), not "
            "ported yet (ROADMAP.md queue 1, 'multi-gpu'); unset SHARDS")
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


def snapshot_path(out: str, frame: int) -> str:
    return os.path.join(out, f"snapshot_{frame:05d}.npz")


def frame_path(out: str, frame: int) -> str:
    return os.path.join(out, f"{frame:05d}.bgeo")


def simulate(sim, args, frame_update=None, print_energy=False):
    """The frame loop: frames from 0 (or from ``--continue`` + 1, after
    loading that snapshot) to ``--frames``; each after frame_update(sim,
    f), printed with its time, particle count and wall time (and the
    energy), written to ``--out`` as BGEO and, every
    ``--snapshot-interval`` frames, as a snapshot."""
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
        n = sim.particles.count()
        msg = f"frame {f:05d}  t={float(sim.t):.4f}  particles={n}  wall={wall*1e3:.0f}ms"
        if print_energy:
            msg += f"  E={sim.energy():.5f}"
        print(msg, flush=True)
        if out:
            sim.visualize(frame_path(out, f), verbose=args.verbose_bgeo)
            if args.snapshot_interval and f % args.snapshot_interval == 0:
                sim.save(snapshot_path(out, f))
    return sim


def _water(args):
    from taichi_mpm_torch import scenes

    return scenes.water_script(res=args.res or 64, device=args.device), None


def _sand_paddles(args):
    from taichi_mpm_torch import scenes

    sim = scenes.sand_paddles(res=args.res or 64, device=args.device,
                              solver=mpm_class(args.device))
    return sim, scenes.sand_paddles_source


# the scene scripts' counterparts: name -> (args -> (sim, frame_update))
SCENES = {"water": _water, "sand_paddles": _sand_paddles}


def main(argv=None):
    args = parse_args(argv, scene=True)
    sim, frame_update = SCENES[args.scene](args)
    simulate(sim, args, frame_update=frame_update)
    if hasattr(sim, "update_counter"):
        print("total particle updates:", sim.update_counter)
    return sim


if __name__ == "__main__":
    main()
