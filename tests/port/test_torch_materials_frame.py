"""Port vs JAX: frames of the six materials other than jelly and water.

The port's ``packed_frame`` on the CPU (the fused kernels' plain twins,
whose material code the CUDA kernels repeat per particle) against the
JAX package's ``packed_frame(fused=True)`` with its Pallas kernels in
interpret mode, on the same numpy particles, as ``test_torch_frame.py``
does for jelly and water: 6 substeps of ``scene_arrays(1200, ...)`` in a
sticky box over a frictional floor that cuts through the block, held to
the bounds the reference sets between its own paths
(``tests/test_fused.py``): x 5e-6, v 5e-5, F 5e-6, C 5e-4, aux 5e-6, with
equal sort and plasticity counts.

Sand's return map decides at knife edges (tr or delta_gamma within
rounding of 0), where two roundings of the same state may disagree on
an event: its plasticity count may differ from JAX's by no more than the
lanes of the port's frame that lie within ``diagnostics.SAND_EDGE_TOL``
of them (``diagnostics.sand_edges_per_substep``). Its aux (log Jp) stays
within the common 5e-6 bound on this frame (4.3e-6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.core import levelset as jls
from taichi_mpm_tpu.ops import packed as jpacked
from taichi_mpm_torch import convert, diagnostics
from taichi_mpm_torch.core import levelset as tls
from taichi_mpm_torch.ops import packed as tpacked

from port_helpers import configs, jax_particles, max_err, scene_arrays

torch.set_num_threads(1)

BOUNDS = dict(x=5e-6, v=5e-5, F=5e-6, C=5e-4, aux=5e-6)


@pytest.mark.parametrize("mats", [
    ("elastic", "von_mises", "linear"),
    ("snow", "visco"),
    ("sand",),
])
def test_materials_frame_matches_jax(mats):
    a, mids = scene_arrays(1200, seed=41, mats=mats)
    jcfg, tcfg = configs(mids)
    lo, hi = (0.12,) * 3, (0.88,) * 3
    jcol = (jls.box_domain(lo, hi, friction=-1.0),
            jls.plane((0.0, 0.39, 0.0), (0.0, 1.0, 0.0), friction=0.3))
    tcol = (tls.box_domain(lo, hi, friction=-1.0),
            tls.plane((0.0, 0.39, 0.0), (0.0, 1.0, 0.0), friction=0.3))
    jp, _, jnmax, jns, jpl = jpacked.packed_frame(
        jax_particles(a), jnp.float32(0.0), jcfg, jcol, jcfg.base_dt, 6, 192,
        interpret=True, fused=True)
    with diagnostics.sand_edges_per_substep() as edges:
        tp, _, tnmax, tns, tpl = tpacked.packed_frame(
            convert.particles_from_numpy(a), np.float32(0.0), tcfg, tcol, tcfg.base_dt, 6, 192)
    assert (int(jnmax), int(jns)) == (tnmax, tns)
    # sand's events may differ at its knife edges only; no other material's
    assert abs(int(jpl) - int(tpl)) <= sum(edges), (int(jpl), int(tpl), edges)
    if "sand" in mats:
        assert int(tpl) > 0 and len(edges) == 6
    else:
        assert sum(edges) == 0
    ja = np.asarray(jp.active)
    assert np.array_equal(ja, tp.active.numpy())
    for name, bound in BOUNDS.items():
        err = max_err(np.asarray(getattr(jp, name))[ja], getattr(tp, name).numpy()[ja])
        assert err <= bound, (name, err)
