"""The port's frame runner (``taichi_mpm_torch.runner``, the counterpart
of ``scripts/common.py``) on the CPU.

``scripts/async/water.py``'s scene at res 16 through ``runner.simulate``:
per-frame BGEO (verbose) that reads back as the scene's particles, bit
for bit; snapshots every frame; ``--continue`` from a snapshot, whose
frames are the uninterrupted run's, bit for bit (an AsyncMPM frame sorts
afresh at its start either way); the energy printed. ``mpm_class``
honours ASYNC=1 and refuses SHARDS > 1. ``main`` runs the sand-paddles
script's counterpart, whose source emits every frame."""

import numpy as np
import pytest
import torch

from taichi_mpm_torch import runner, scenes
from taichi_mpm_torch.core.adaptive import AsyncMPM
from taichi_mpm_torch.core.solver import MPM
from taichi_mpm_torch.io.bgeo import read_bgeo

torch.set_num_threads(1)

ARGS = ["--cpu", "--frame-dt", "5e-4", "--snapshot-interval", "1", "--verbose-bgeo"]


def test_simulate_writes_frames_snapshots_and_resumes(tmp_path, capsys):
    out = str(tmp_path / "out")
    args = runner.parse_args(["--frames", "3", "--out", out, *ARGS], res=16)
    assert args.device == "cpu" and args.res == 16
    sim = runner.simulate(scenes.water_script(res=args.res, device=args.device), args,
                          print_energy=True)
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 3 and all("E=" in line for line in printed)
    n = sim.particles.count()
    assert n > 1000 and f"particles={n}" in printed[-1]
    pos, attrs = read_bgeo(runner.frame_path(out, 2))
    assert np.array_equal(pos, sim.positions())
    assert np.array_equal(attrs["v"], sim.velocities())
    assert set(attrs) == {"v", "mass", "boundary", "distance"}
    for f in range(3):
        assert (tmp_path / "out" / f"snapshot_{f:05d}.npz").exists()

    frames = {f: open(runner.frame_path(out, f), "rb").read() for f in (1, 2)}
    args = runner.parse_args(["--frames", "3", "--out", out, "--continue", "0", *ARGS], res=16)
    resumed = runner.simulate(scenes.water_script(res=16, device="cpu"), args)
    assert resumed.t == sim.t and resumed.particles.count() == n
    for f, data in frames.items():
        assert open(runner.frame_path(out, f), "rb").read() == data, f


def test_mpm_class(monkeypatch):
    monkeypatch.delenv("SHARDS", raising=False)
    monkeypatch.delenv("ASYNC", raising=False)
    sim = runner.mpm_class("cpu")(res=(16, 16, 16))
    assert type(sim) is MPM and sim.device.type == "cpu"
    monkeypatch.setenv("ASYNC", "1")
    monkeypatch.setenv("ASYNC_MAX_DT", "2e-3")
    sim = runner.mpm_class("cpu")(res=(16, 16, 16), base_delta_t=1e-4)
    assert isinstance(sim, AsyncMPM) and sim.cfg.base_dt == 2e-3 and sim.unit_delta_t == 1e-6
    monkeypatch.setenv("SHARDS", "2")
    with pytest.raises(NotImplementedError, match="queue 1, 'multi-gpu'"):
        runner.mpm_class("cpu")


def test_main_runs_the_sand_paddles_script(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("ASYNC", raising=False)
    monkeypatch.delenv("SHARDS", raising=False)
    out = tmp_path / "paddles"
    sim = runner.main(["sand_paddles", "--res", "64", "--frames", "2", "--cpu",
                       "--frame-dt", "5e-4", "--out", str(out)])
    counts = [int(line.split("particles=")[1].split()[0])
              for line in capsys.readouterr().out.splitlines()]
    assert len(counts) == 2 and 0 < counts[0] < counts[1] == sim.particles.count()
    assert sim.particles.capacity == 50_000 and sim.bodies.num == 3
    assert sorted(p.name for p in out.glob("00001*")) == [
        "00001.bgeo", "00001_rigid_1.obj", "00001_rigid_2.obj"]
