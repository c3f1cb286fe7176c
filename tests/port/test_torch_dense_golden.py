"""The port's dense path against the repo's independent references, at
their sizes and tolerances.

- The numpy MLS-MPM oracle of ``tests/test_mpm88_oracle.py`` (192 snow
  particles, 30 substeps): x 5e-5, v 5e-3, Jp 1e-4, F 1e-3.
- The compiled mls-mpm88 golden (``tests/fixtures/mpm88_ref/golden.txt``,
  3,000 particles, res 80, frames of 10 substeps): centre of mass within
  1e-3, 4e-3 and 8e-3 at frames 10, 20 and 40, deciles within 2e-2 at
  frame 10.
- The compiled tetris golden (``tests/fixtures/tetris_ref/golden.txt``,
  3,360 particles of three materials, res 160, frames of 26 substeps):
  each material's centre of mass within 1e-3, 2e-3 and 8e-3 at frames
  10, 20 and 40; at frame 10 the elastic and liquid deciles within 5e-3
  and 1e-3.

Each golden scene is built once per module and stepped forward by the
tests in turn, each to its own frame; a test that asks for a frame the
scene has passed gets a scene rebuilt from the golden's frame 0, so a
test checks its frame whatever ran before it.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from taichi_mpm_torch import MPM, scenes

from port_helpers import load_golden, numpy_mpm88_substep

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parents[1] / "fixtures"


def test_mpm88_trajectory_matches_numpy_oracle():
    sim = scenes.mpm88(device="cpu")
    x0 = sim._pending[0]["x"].copy()
    n = len(x0)
    x, v = x0.copy(), np.zeros((n, 2), np.float32)
    F = np.broadcast_to(np.eye(2, dtype=np.float32), (n, 2, 2)).copy()
    B = np.zeros((n, 2, 2), np.float32)
    Jp = np.ones(n, np.float32)
    for _ in range(3):  # 3 frames x 10 substeps
        sim.step()
    for _ in range(30):
        x, v, F, B, Jp = numpy_mpm88_substep(x, v, F, B, Jp, sim.cfg.grid_nodes)
    p = sim.particles
    np.testing.assert_allclose(p.x.numpy(), x, atol=5e-5)
    np.testing.assert_allclose(p.v.numpy(), v, atol=5e-3)
    np.testing.assert_allclose(p.aux.numpy(), Jp, atol=1e-4)
    np.testing.assert_allclose(p.F.numpy(), F, atol=1e-3)


class Golden:
    """A golden's frames and its scene, built by `make` and stepped
    forward on demand."""

    def __init__(self, make, frames):
        self.make, self.frames = make, frames
        self.sim, self.frame = make(), 0

    def at(self, k):
        if k < self.frame:
            self.sim, self.frame = self.make(), 0
        while self.frame < k:
            self.sim.step()
            self.frame += 1
        return self.sim.particles.x.numpy()


@pytest.fixture(scope="module")
def mpm88_golden():
    frames = load_golden(FIXTURES / "mpm88_ref" / "golden.txt")
    return Golden(lambda: scenes.mpm88(pos=frames[0], device="cpu"), frames)


@pytest.mark.parametrize("frame,com_bound", [(10, 1e-3), (20, 4e-3), (40, 8e-3)])
def test_mpm88_matches_compiled_reference(mpm88_golden, frame, com_bound):
    got = mpm88_golden.at(frame)
    ref = mpm88_golden.frames[frame]
    assert np.abs(got.mean(0) - ref.mean(0)).max() < com_bound
    if frame == 10:
        qs = np.linspace(0.05, 0.95, 10)
        assert np.abs(np.quantile(got, qs, axis=0) - np.quantile(ref, qs, axis=0)).max() < 2e-2


TETRIS_N = 160
TETRIS_DT = 60e-4 / TETRIS_N


@pytest.fixture(scope="module")
def tetris_golden():
    frames = load_golden(FIXTURES / "tetris_ref" / "golden.txt")
    x0 = frames[0][:, :2]
    types = frames[0][:, 2].astype(int)
    masks = [types == t for t in range(3)]

    def make():
        sim = MPM(res=(TETRIS_N, TETRIS_N), base_delta_t=TETRIS_DT, frame_dt=26 * TETRIS_DT,
                  gravity=(0.0, -200.0), device="cpu")
        sim.add_particles("jelly", pos=x0[masks[0]], mass=1.0, vol=1.0, E=1e4, nu=0.2)
        sim.add_particles("snow", pos=x0[masks[1]], mass=1.0, vol=1.0, youngs_modulus=1e4,
                          poisson_ratio=0.2, hardening=10.0)
        sim.add_particles("water", pos=x0[masks[2]], mass=1.0, vol=1.0, k=0.2e4, gamma=1.0)
        for c in scenes.mpm88_colliders():
            sim.add_collider(c)
        return sim

    g = Golden(make, frames)
    g.order = np.concatenate([np.where(m)[0] for m in masks])
    g.sizes = [int(m.sum()) for m in masks]
    return g


@pytest.mark.parametrize("frame,com_bound", [(10, 1e-3), (20, 2e-3), (40, 8e-3)])
def test_tetris_matches_compiled_reference(tetris_golden, frame, com_bound):
    got = tetris_golden.at(frame)
    assert np.isfinite(got).all() and tetris_golden.sim.particles.count() == len(got)
    ref = tetris_golden.frames[frame][:, :2][tetris_golden.order]
    off = 0
    for t, nt in enumerate(tetris_golden.sizes):
        g, r = got[off:off + nt], ref[off:off + nt]
        assert np.abs(g.mean(0) - r.mean(0)).max() < com_bound, (t, frame)
        if frame == 10 and t in (0, 2):  # snow fractures chaotically
            qs = np.linspace(0.05, 0.95, 10)
            q_err = np.abs(np.quantile(g, qs, axis=0) - np.quantile(r, qs, axis=0)).max()
            assert q_err < (5e-3 if t == 0 else 1e-3), (t, q_err)
        off += nt


def test_golden_rewinds_to_an_earlier_frame(mpm88_golden):
    """Asked for a frame it has passed, a golden scene starts again from
    frame 0 and gives that frame's bits."""
    first = mpm88_golden.at(2).copy()
    mpm88_golden.at(3)
    assert np.array_equal(mpm88_golden.at(2), first) and mpm88_golden.frame == 2
