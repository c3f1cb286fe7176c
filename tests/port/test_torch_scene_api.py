"""The port's scene API against the reference's surface.

``MPM(..., optimized=...)`` takes the reference's keyword: None and True
choose the blocked path for a 3-D quadratic scene, and False the dense
path. ``AsyncMPM`` is exported from the package and its
``step`` returns the particles, as the reference's does. The package's
messages cite ROADMAP.md's items by name, and every name they cite is
one of the items still to port, so a renumbering of the queue cannot
make them stale and a finished item cannot stay cited."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import taichi_mpm_torch
from taichi_mpm_torch import MPM
from taichi_mpm_torch.core import adaptive, solver

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("optimized", [None, True])
def test_mpm_takes_optimized(optimized):
    sim = MPM(res=(16, 16, 16), optimized=optimized, device="cpu")
    assert sim.optimized is optimized


def test_mpm_unoptimized_names_the_dense_path():
    sim = MPM(res=(16, 16, 16), optimized=False, device="cpu")
    assert sim.optimized is False and sim._use_blocked() is False
    sim.add_particles("water", pos=np.full((8, 3), 0.5, np.float32), density=1000.0)
    sim.frame_dt = 2 * sim.cfg.base_dt
    sim.step()
    assert sim.packed_carry is None and sim.n_sorts == 0 and sim.particles.count() == 8


def test_async_mpm_is_exported_and_step_returns_particles():
    assert taichi_mpm_torch.AsyncMPM is adaptive.AsyncMPM
    assert "AsyncMPM" in taichi_mpm_torch.__all__
    assert taichi_mpm_torch.mechanical_energy is solver.mechanical_energy  # as JAX exports it
    sim = taichi_mpm_torch.AsyncMPM(res=(16, 16, 16), base_delta_t=2e-4, frame_dt=4e-4,
                                    unit_delta_t=1e-6, device="cpu")
    pos = np.random.default_rng(3).uniform(0.4, 0.6, (200, 3)).astype(np.float32)
    sim.add_particles("sand", pos=pos, density=2000.0, friction_angle=35.0)
    p = sim.step()
    assert p is sim.particles
    assert int(p.count()) == 200 and sim.last_substeps >= 2


def test_roadmap_citations_name_their_items():
    """Every item a message cites is one ROADMAP.md's queue 1 still has to
    port (after its "Still to port" line), not one marked done."""
    roadmap = (ROOT / "ROADMAP.md").read_text().lower()
    todo = roadmap[roadmap.index("still to port"):roadmap.index("### 2.")]
    cited = []
    for path in sorted((ROOT / "taichi_mpm_torch").rglob("*.py")):
        text = path.read_text()
        assert not re.search(r"queue \d+ item \d+", text), path
        cited += re.findall(r"ROADMAP\.md\s+queue\s+1,\s+['\"]([^'\"\n]+)['\"]", text)
    assert cited
    for name in cited:
        assert name.lower() in todo, name
