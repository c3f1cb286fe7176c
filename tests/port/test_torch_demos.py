"""The torch demos (``taichi_mpm_torch/demos``) against the JAX package's
``demos/mls_mpm88.py`` and ``mls_mpm88_explained.py``.

Each torch demo's ``substep`` against the JAX demo's (loaded by ``runpy``
with its ``__main__`` left out, jitted as the demo runs it) on the demo's
own 8,192 particles from default_rng(0), one frame of 40 substeps on
the CPU: x 5e-6, v 5e-5, F 5e-6 (the bounds of ``tests/test_fused.py``;
measured, both demos, printed with ``pytest -s``: x 0, v 4.2e-7, F
4.3e-8; C 3.9e-5, Jp 0). Then
each demo's ``main`` on the CPU prints one line a frame, as the JAX demo
does.
"""

import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from taichi_mpm_torch.demos import mls_mpm88, mls_mpm88_explained

from port_helpers import max_err

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
DEMOS = {"mls_mpm88": mls_mpm88, "mls_mpm88_explained": mls_mpm88_explained}
BOUNDS = dict(x=5e-6, v=5e-5, F=5e-6)
SUBSTEPS = 40  # one frame: frame_dt / dt


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_substep_matches_jax_demo(name):
    import jax.numpy as jnp

    jax_substep = runpy.run_path(str(ROOT / "demos" / f"{name}.py"), run_name="demo")["substep"]
    demo = DEMOS[name]
    state = demo.initial_state("cpu")
    # the JAX demo's __main__ seeding, from the same generator
    rng = np.random.default_rng(0)
    P = 8192
    x0 = np.concatenate([rng.random((P // 2, 2)) * 0.2 + [0.35, 0.6],
                         rng.random((P // 2, 2)) * 0.2 + [0.45, 0.25]])
    assert np.array_equal(state[0].numpy(), x0.astype(np.float32))
    js = (jnp.asarray(x0, jnp.float32), jnp.zeros((P, 2)), jnp.tile(jnp.eye(2), (P, 1, 1)),
          jnp.zeros((P, 2, 2)), jnp.ones(P))
    for _ in range(SUBSTEPS):
        js = jax_substep(*js)
        state = demo.substep(*state)
    errs = {field: max_err(np.asarray(j), t.numpy())
            for field, j, t in zip(("x", "v", "F", "C", "Jp"), js, state)}
    print(name, errs)  # the measured errors, with pytest -s
    assert all(t.dtype == torch.float32 for t in state)
    for field, bound in BOUNDS.items():
        assert errs[field] <= bound, (field, errs[field])
    assert errs["Jp"] <= 1e-6


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_main_prints_each_frame(name, capsys):
    x = DEMOS[name].main(["--cpu", "--frames", "1"])[0]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and lines[0].startswith("frame 000  y in [")
    assert torch.isfinite(x).all() and lines[0].endswith(
        f"[{float(x[:, 1].min()):.3f}, {float(x[:, 1].max()):.3f}]")
