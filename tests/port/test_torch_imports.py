"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller names another device.
"""

import re
import subprocess
import sys
from pathlib import Path

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
        "taichi_mpm_torch.core.adaptive, taichi_mpm_torch.diagnostics, "
        "taichi_mpm_torch.sampling, taichi_mpm_torch.sampling.poisson, "
        "taichi_mpm_torch.sampling.texture, taichi_mpm_torch.io, taichi_mpm_torch.io.bgeo, "
        "taichi_mpm_torch.io.checkpoint, taichi_mpm_torch.math.svd, "
        "taichi_mpm_torch.materials.models, taichi_mpm_torch.runner\n"
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


def test_unported_paths_raise():
    from taichi_mpm_torch import MPM

    with pytest.raises(NotImplementedError, match="dense oracle path"):
        MPM(res=(16, 16), device="cpu")
    with pytest.raises(NotImplementedError, match="dense oracle path"):
        MPM(res=(16, 16, 16), kernel_order=3, device="cpu")


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
