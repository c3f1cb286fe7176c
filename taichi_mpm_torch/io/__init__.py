"""Output and persistence (torch counterpart of ``taichi_mpm_tpu.io``):
BGEO particle dumps (native C++ writer, numpy twin) and checkpoints."""

from taichi_mpm_torch.io.bgeo import read_bgeo, write_bgeo  # noqa: F401
from taichi_mpm_torch.io.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
