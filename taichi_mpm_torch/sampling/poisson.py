"""Poisson-disk particle seeding (Bridson + periodic tile + sources).

The port's counterpart of ``taichi_mpm_tpu.sampling.poisson`` (host
numpy). Every function gives the JAX package's points bit for bit: the
same random streams, the same float64 arithmetic and the same float32
casts. After the reference sampler (``poisson_disk_sampler.h``):
  * ``bridson``: dart-throwing with a background grid;
  * a *periodic* point set per dimension, tiled over the target region
    (the reference loads ``$mpm/periodic_pd_{dim}d.dat``). The port ships
    the 2-D and 3-D sets as ``periodic_pd_{2,3}d.npy`` beside this file:
    ``bridson`` over [0, bound)^dim at r = 1, periodic, from
    ``default_rng(12345)``, the JAX package's generation (bound 40 in
    2-D, 16 in 3-D), so that no run pays the ~50 s of generating the 3-D
    set. ``python -m taichi_mpm_torch.sampling.poisson`` writes them anew;
  * ``sample_from_periodic_data``: filter the tiled points by a density
    texture;
  * ``sample_from_source``: an emitter, the points whose advected
    position leaves the density mask this frame;
  * ``sample_packed``: spheres packed in a region.

min_distance from the target ppc is calibrated to the tile's measured
density (``min_distance_for_ppc``).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

PERIODIC_BOUND = 40.0  # the reference's periodic_bound (2-D tile)
PERIODIC_BOUND_3D = 16.0  # the JAX package's 3-D tile, kept cheap to generate
TILE_SEED = 12345
_TILE_DIR = os.path.dirname(os.path.abspath(__file__))
_periodic_cache: dict = {}


def min_distance_for_ppc(dx: float, ppc: float, dim: int) -> float:
    """The min distance whose tiling gives `ppc` particles per cell of
    size `dx`: the tile's points per unit volume at r = 1 fix it (the
    reference's fixed 2/3 and 13/18 factors fit its own generator)."""
    v = dx**dim / ppc
    pts, bound = periodic_tile(dim)
    factor = len(pts) / bound**dim  # points per unit volume at r = 1
    return (v * factor) ** (1.0 / dim)


def bridson(lo, hi, r: float, rng=None, periodic: bool = False, k: int = 30):
    """Bridson dart throwing in the box [lo, hi); min distance r.

    The JAX package's ``bridson`` with its rejection test over the 5^d
    grid cells around a candidate done as one array operation: the same
    candidates drawn in the same order from `rng`, the same squared
    distances, so the same points."""
    rng = rng or np.random.default_rng(0)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    d = len(lo)
    size = hi - lo
    cell = r / math.sqrt(d)
    res = np.maximum(np.ceil(size / cell).astype(int), 1)
    grid = -np.ones(res, np.int64)
    offsets = np.asarray(list(np.ndindex(*(5,) * d)), np.int64) - 2  # (5^d, d)
    samples = np.empty((64, d), np.float64)
    n = 0
    active = []
    r2 = r * r

    def cell_of(p):
        return np.minimum(((p - lo) / cell).astype(int), res - 1)

    def fits(p):
        ci = cell_of(p) + offsets
        if periodic:
            wrap = ci // res
            off = wrap * size
            ci = ci - wrap * res
        else:
            inside = np.all((ci >= 0) & (ci < res), axis=1)
            ci = ci[inside]
            off = np.zeros(ci.shape, np.float64)
        j = grid[tuple(ci.T)]
        near = j >= 0
        q = samples[j[near]] + off[near]
        return not np.any(np.sum((p - q) ** 2, axis=1) < r2)

    def add(p):
        nonlocal samples, n
        if n == len(samples):
            samples = np.concatenate([samples, np.empty_like(samples)])
        samples[n] = p
        grid[tuple(cell_of(p))] = n
        active.append(n)
        n += 1

    add(lo + rng.random(d) * size)
    while active:
        base = samples[active[-1]].copy()
        placed = False
        for _ in range(k):
            rad = r * (1.0 + rng.random())
            vec = rng.normal(size=d)
            vec *= rad / np.linalg.norm(vec)
            p = base + vec
            if periodic:
                p = lo + np.mod(p - lo, size)
            elif np.any(p < lo) or np.any(p >= hi):
                continue
            if fits(p):
                add(p)
                placed = True
                break
        if not placed:
            active.pop()
    return samples[:n].astype(np.float32)


def tile_bound(dim: int) -> float:
    return PERIODIC_BOUND if dim == 2 else PERIODIC_BOUND_3D


def tile_path(dim: int) -> str:
    return os.path.join(_TILE_DIR, f"periodic_pd_{dim}d.npy")


def generate_tile(dim: int) -> np.ndarray:
    """The periodic point set of dimension `dim`, generated as the JAX
    package generates it (unit min distance, periodic, rng 12345)."""
    bound = tile_bound(dim)
    return bridson(np.zeros(dim), np.full(dim, bound), 1.0,
                   rng=np.random.default_rng(TILE_SEED), periodic=True)


def periodic_tile(dim: int):
    """(points, bound): the unit-min-distance periodic point set in
    [0, bound)^dim. The shipped file where there is one (2-D, 3-D), else
    generated and kept in memory."""
    if dim not in _periodic_cache:
        path = tile_path(dim)
        pts = np.load(path) if os.path.exists(path) else generate_tile(dim)
        _periodic_cache[dim] = (pts, tile_bound(dim))
    return _periodic_cache[dim]


def _density_bbox(tex, lo, hi, dx, dim):
    """Bounding box + max ppc of the positive-density region sampled at
    cell centers (the reference's get_ready)."""
    axes = [np.arange(lo[k] + dx * 0.5, hi[k], dx) for k in range(dim)]
    mesh = np.meshgrid(*axes, indexing="ij")
    pts = np.stack(mesh, -1).reshape(-1, dim)
    vals = tex(pts)
    ppc = float(vals.max()) if len(vals) else 0.0
    pos = pts[vals > 0]
    if len(pos) == 0:
        return None, None, 0.0
    return pos.min(0) - dx, pos.max(0) + dx, ppc


def sample_from_periodic_data(
    tex, lo, hi, dx: float, dim: int, specific_min_distance: Optional[float] = None
):
    """Tile the periodic set over the density bbox; keep tex > 0."""
    mn, mx, ppc = _density_bbox(tex, lo, hi, dx, dim)
    if mn is None:
        return np.zeros((0, dim), np.float32)
    r = specific_min_distance or min_distance_for_ppc(dx, ppc, dim)
    pts, bound = periodic_tile(dim)
    region_size = bound * r
    reps = np.ceil((mx - mn) / region_size).astype(int)
    out = []
    base = pts * r + mn  # tile spans [0, region_size) per axis
    for idx in np.ndindex(*reps):
        coords = base + region_size * np.asarray(idx)
        keep = tex(coords) > 0
        out.append(coords[keep])
    return np.concatenate(out).astype(np.float32) if out else np.zeros((0, dim), np.float32)


def sample_from_source(tex, lo, hi, dx: float, dim: int, sample_offset, sample_advection):
    """Emitter: tiled points inside the mask whose advected position
    leaves it this frame. The tile pattern is shifted by sample_offset
    (= v * t) so successive frames emit fresh, non-overlapping layers."""
    mn, mx, ppc = _density_bbox(tex, lo, hi, dx, dim)
    if mn is None:
        return np.zeros((0, dim), np.float32)
    r = min_distance_for_ppc(dx, ppc, dim)
    pts, bound = periodic_tile(dim)
    region_size = bound * r
    off = np.asarray(sample_offset, np.float64)
    adv = np.asarray(sample_advection, np.float64)
    shifted = pts * r + off
    shifted -= np.floor(shifted / region_size + 0.5) * region_size
    reps = np.ceil((mx - mn) / region_size).astype(int)
    out = []
    for idx in np.ndindex(*reps):
        coords = mn + shifted + region_size * (np.asarray(idx) + 0.5)
        v0 = tex(coords)
        v1 = tex(coords + adv)
        keep = (v0 > 0) & (v1 == 0)
        out.append(coords[keep])
    return np.concatenate(out).astype(np.float32) if out else np.zeros((0, dim), np.float32)


def sample_packed(tex, local_tex, lo, hi, dx: float, dim: int, radius: float, gap: float):
    """Spheres-in-spheres packing: copies of the `local_tex` sample
    centred on the points of a sample of `tex` at min distance
    2 radius + gap."""
    centers = sample_from_periodic_data(tex, lo, hi, dx, dim, 2.0 * radius + gap)
    local = sample_from_periodic_data(local_tex, lo, hi, dx, dim)
    mn, mx, _ = _density_bbox(local_tex, lo, hi, dx, dim)
    if mn is None or len(centers) == 0:
        return np.zeros((0, dim), np.float32)
    mid = (mn + mx) * 0.5
    out = [local - mid + c for c in centers]
    return np.concatenate(out).astype(np.float32)


if __name__ == "__main__":
    for dim in (2, 3):
        np.save(tile_path(dim), generate_tile(dim))
        print(tile_path(dim), len(np.load(tile_path(dim))))
