"""taichi_mpm_torch — the PyTorch / CUDA port of taichi_mpm_tpu.

The blocked 3-D path (``MPM``, ``add_particles``, ``add_collider``,
``step``; ``AsyncMPM`` at global adaptive dt; CPIC rigid coupling), all
eight materials, with hand-written CUDA kernels for P2G and G2P
(``csrc/``); ``DistributedMPM`` over x-slabs of a ``torch.distributed``
group (``parallel/``); texture seeding, BGEO and checkpoint I/O, the energy and
a frame runner for scene scripts (``runner``). Entry points run on the
card unless the caller passes ``device="cpu"``, which runs the kernels'
plain-torch twins.
"""

import torch

# The port is held to the JAX reference at float32 precision (~1e-6
# relative). TF32 keeps 10 mantissa bits, so any float32 matmul or
# convolution the port reaches must not be routed through it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from taichi_mpm_torch.config import SimConfig  # noqa: E402
from taichi_mpm_torch.core import levelset  # noqa: E402
from taichi_mpm_torch.core.adaptive import AsyncMPM  # noqa: E402
from taichi_mpm_torch.core.solver import MPM, mechanical_energy  # noqa: E402
from taichi_mpm_torch.core.state import Particles, empty_particles  # noqa: E402


def __getattr__(name):
    # lazy, as in the JAX package: parallel.driver brings torch.distributed
    if name in ("DistributedMPM", "DistributedAsyncMPM"):
        from taichi_mpm_torch.parallel import driver

        return getattr(driver, name)
    raise AttributeError(name)


__all__ = ["MPM", "AsyncMPM", "DistributedMPM", "DistributedAsyncMPM", "SimConfig", "Particles",
           "empty_particles", "mechanical_energy", "levelset"]
