"""Shared inputs of the port's CPU tests: scenes built once in numpy and
handed to both packages (the JAX reference and the torch port)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from taichi_mpm_torch import convert
from taichi_mpm_torch.core.state import FIELDS
from taichi_mpm_torch.materials import models as tmodels


def scene_arrays(n=1200, seed=0, mats=("jelly",), lo=0.375, hi=0.5,
                 v_scale=0.5, cap_extra=17):
    """Numpy particle fields of a random box of particles (capacity
    n + cap_extra, the extra slots inactive) and its material ids."""
    rng = np.random.default_rng(seed)
    cap = n + cap_extra
    a = {
        "x": np.zeros((cap, 3), np.float32),
        "v": np.zeros((cap, 3), np.float32),
        "F": np.broadcast_to(np.eye(3, dtype=np.float32), (cap, 3, 3)).copy(),
        "C": np.zeros((cap, 3, 3), np.float32),
        "aux": np.zeros(cap, np.float32),
        "mass": np.zeros(cap, np.float32),
        "vol": np.zeros(cap, np.float32),
        "mat": np.zeros(cap, np.int32),
        "params": np.zeros((cap, 8), np.float32),
        "active": np.zeros(cap, bool),
        "states": np.zeros(cap, np.int32),
        "bdist": np.zeros(cap, np.float32),
        "bnormal": np.zeros((cap, 3), np.float32),
        "near_b": np.zeros(cap, bool),
    }
    a["x"][:n] = rng.uniform(lo, hi, (n, 3))
    a["v"][:n] = v_scale * rng.standard_normal((n, 3))
    mids = []
    for i, m in enumerate(mats):
        mid, params, aux0 = tmodels.pack_params(m)
        mids.append(mid)
        sel = np.arange(n) % len(mats) == i
        a["mat"][:n][sel] = mid
        a["params"][:n][sel] = params
        a["aux"][:n][sel] = aux0
    a["mass"][:n] = 1e-3
    a["vol"][:n] = 1e-6
    a["active"][:n] = True
    return a, tuple(sorted(set(mids)))


def jax_particles(arrays):
    import jax.numpy as jnp

    from taichi_mpm_tpu.core.state import Particles as JParticles

    return JParticles(**{k: jnp.asarray(arrays[k]) for k in FIELDS})


def configs(mats, res=(32, 32, 32), base_dt=2e-4, **kw):
    """(JAX SimConfig, port SimConfig) with the same fields."""
    from taichi_mpm_tpu.config import SimConfig as JConfig

    jcfg = JConfig(res=res, base_dt=base_dt, gravity=(0.0, -10.0, 0.0),
                   active_materials=tuple(mats), **kw)
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


def np_of(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def max_err(a, b):
    return float(np.max(np.abs(np_of(a).astype(np.float64) - np_of(b).astype(np.float64))))
