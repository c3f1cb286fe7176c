"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller names another device.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
PORT_FILES = sorted((ROOT / "taichi_mpm_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
IMPORT_LINE = re.compile(r"^\s*(import|from)\s+(jax|taichi_mpm_tpu)\b", re.MULTILINE)


def test_port_import_does_not_load_jax():
    code = (
        "import sys, taichi_mpm_torch, taichi_mpm_torch.scenes, "
        "taichi_mpm_torch.convert, taichi_mpm_torch.ops.packed, "
        "taichi_mpm_torch.rigid.cpic_packed, taichi_mpm_torch.rigid.articulation, "
        "taichi_mpm_torch.rigid.collision, taichi_mpm_torch.rigid.scene, "
        "taichi_mpm_torch.rigid.mesh, taichi_mpm_torch.math.quat, "
        "taichi_mpm_torch.rigid.cpic, taichi_mpm_torch.rigid.cdf, taichi_mpm_torch.rigid.body, "
        "taichi_mpm_torch.rigid.host, taichi_mpm_torch.rigid.cpic_blocked, "
        "taichi_mpm_torch.ops.async_bucketed, taichi_mpm_torch.ops.substep, "
        "taichi_mpm_torch.core.adaptive, taichi_mpm_torch.diagnostics, "
        "taichi_mpm_torch.sampling, taichi_mpm_torch.sampling.poisson, "
        "taichi_mpm_torch.sampling.texture, taichi_mpm_torch.io, taichi_mpm_torch.io.bgeo, "
        "taichi_mpm_torch.io.checkpoint, taichi_mpm_torch.math.svd, "
        "taichi_mpm_torch.materials.models, taichi_mpm_torch.runner, "
        "taichi_mpm_torch.core.transfer, taichi_mpm_torch.core.solver, "
        "taichi_mpm_torch.math.kernels, taichi_mpm_torch.core.state, taichi_mpm_torch.config, "
        "taichi_mpm_torch.parallel.comm, taichi_mpm_torch.parallel.spatial, "
        "taichi_mpm_torch.parallel.spatial_blocked, taichi_mpm_torch.parallel.driver, "
        "taichi_mpm_torch.demos, taichi_mpm_torch.demos.mls_mpm88, "
        "taichi_mpm_torch.demos.mls_mpm88_explained\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
        "'taichi_mpm_tpu'))]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_lines(path):
    assert path.exists()
    assert not IMPORT_LINE.search(path.read_text()), path


def test_tf32_is_off():
    import taichi_mpm_torch  # noqa: F401

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_mpm_without_device_needs_cuda():
    from taichi_mpm_torch import MPM

    if torch.cuda.is_available():
        assert MPM(res=(16, 16, 16)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            MPM(res=(16, 16, 16))


def test_unported_paths_raise(monkeypatch):
    """2-D scenes, kernel order 3 and 2-D rigid bodies run on the dense
    path; the per-block scheduler refuses a 2-D scene, as the JAX package
    does; the multi-device drivers need a process group, and what stays
    unported of them raises: the pencil mesh (DistributedAsyncMPM refuses
    it with the JAX package's message)."""
    from taichi_mpm_torch import MPM, runner
    from taichi_mpm_torch.core.adaptive import AsyncMPM

    for sim in (MPM(res=(16, 16), device="cpu"),
                MPM(res=(16, 16, 16), kernel_order=3, optimized=False, device="cpu")):
        sim.add_particles("jelly", pos=np.full((4, sim.cfg.dim), 0.5, np.float32))
        sim.step()
        assert sim.packed_carry is None and sim.particles.count() == 4
    sim = MPM(res=(16, 16), device="cpu")
    sim.add_particles("jelly", pos=np.full((4, 2), 0.5, np.float32))
    sim.add_particles("rigid", mesh=np.asarray([[[-0.2, 0.0], [0.2, 0.0]]], np.float32),
                      scripted_position=lambda t: (0.5, 0.3))
    sim.step()
    assert sim.packed_carry is None and sim.bodies.rot.shape == (2, 1)
    sim = AsyncMPM(res=(16, 16), per_block=True, device="cpu")
    sim.add_particles("jelly", pos=np.full((4, 2), 0.5, np.float32))
    with pytest.raises(ValueError, match="3D-only"):
        sim.step()
    monkeypatch.setenv("SHARDS", "2")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        runner.mpm_class("cpu")  # no process group: says how to launch
    from taichi_mpm_torch import DistributedAsyncMPM, DistributedMPM

    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node N"):
        DistributedMPM(res=(16, 16, 16), mesh_shape=(2, 2), device="cpu")  # no process group
    with pytest.raises(ValueError, match="slab-mesh"):
        DistributedAsyncMPM(res=(16, 16, 16), mesh_shape=(2, 2), device="cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node N"):
        DistributedAsyncMPM(res=(16, 16, 16), device="cpu")  # no process group


def test_rigid_surface_rejects_misuse():
    from taichi_mpm_torch import MPM
    from taichi_mpm_torch.rigid.mesh import plate_mesh

    sim = MPM(res=(16, 16, 16), device="cpu")
    with pytest.raises(ValueError, match="add rigid bodies first"):
        sim.add_articulation("rotation", 1, 0)
    with pytest.raises(ValueError, match="mesh"):
        sim.add_particles("rigid")
    sim.add_particles("water", pos=[[0.5, 0.5, 0.5]])
    sim.add_particles("rigid", mesh=plate_mesh(0.1, 0.1), scripted_position=lambda t: (0.5, 0.3, 0.5))
    sim.step()
    with pytest.raises(ValueError, match="before the first step"):
        sim.add_particles("rigid", mesh=plate_mesh(0.1, 0.1))
    assert sim.cfg.num_rigids == 2 and sim.bodies.num == 2
