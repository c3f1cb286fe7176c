"""Composable density-field "textures" for particle seeding.

A copy of ``taichi_mpm_tpu.sampling.texture`` (numpy only), kept here so
the port never imports the JAX package; the two must stay equal.

Host-side numpy re-design of taichi's Texture system as the reference
scenes use it (tc.Texture('ring'/'sphere'/'rect'/'mesh'/'bound'/...,
combined with rotate/translate/scale and scalar multiply; e.g.
water_wheel.py:67-72, banana.py:22-29). A texture is a function
``f(points (N, d)) -> density (N,)``; the value is the target
particles-per-cell at that point (reference: ppc = max texture value,
mpm.cpp:204-213).
"""

from __future__ import annotations

import numpy as np


class Texture:
    """Wraps f(points)->values with operator composition."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        return np.asarray(self.fn(np.asarray(pts, np.float32)), np.float32)

    def __mul__(self, s):
        if isinstance(s, Texture):
            return Texture(lambda p: self(p) * s(p))
        return Texture(lambda p: self(p) * float(s))

    __rmul__ = __mul__

    def __add__(self, o):
        return Texture(lambda p: self(p) + o(p))

    def translate(self, offset) -> "Texture":
        off = np.asarray(offset, np.float32)
        return Texture(lambda p: self(p - off))

    def scale(self, s) -> "Texture":
        s = np.asarray(s, np.float32)
        return Texture(lambda p: self(p / s))

    def rotate(self, axis: int, times: int = 1) -> "Texture":
        """Rotate by 90-degree steps about `axis` around the domain
        center 0.5 (taichi 'rotate' texture semantics)."""

        def fn(p):
            q = p - 0.5
            d = p.shape[-1]
            ax = [k for k in range(d) if k != axis] if d == 3 else [0, 1]
            for _ in range(times % 4):
                a, b = ax[-2], ax[-1]
                qa, qb = q[..., a].copy(), q[..., b].copy()
                q = q.copy()
                q[..., a] = qb
                q[..., b] = -qa
            return self(q + 0.5)

        return Texture(fn)

    def bound(self, axis: int, lo: float, hi: float, outside: float = 0.0) -> "Texture":
        """Zero (or `outside`) outside lo <= x[axis] < hi ('bound')."""

        def fn(p):
            v = self(p)
            inside = (p[..., axis] >= lo) & (p[..., axis] < hi)
            return np.where(inside, v, outside)

        return Texture(fn)


def constant(value: float = 1.0) -> Texture:
    return Texture(lambda p: np.full(p.shape[:-1], value, np.float32))


def sphere(center, radius) -> Texture:
    c = np.asarray(center, np.float32)
    return Texture(
        lambda p: (np.linalg.norm(p - c, axis=-1) < radius).astype(np.float32)
    )


def ring(center=None, inner: float = 0.0, outer: float = 0.05, axis: int = 2) -> Texture:
    """Annulus in the plane perpendicular to `axis` ('ring' texture:
    water_wheel.py:67 uses outer=0.05)."""

    def fn(p):
        d = p.shape[-1]
        q = np.delete(p, axis, axis=-1) if d == 3 else p
        c = np.asarray(
            center if center is not None else [0.5] * q.shape[-1], np.float32
        )
        if len(c) == 3 and d == 3:
            c = np.delete(c, axis)  # full-dim center: drop the axis comp.
        r = np.linalg.norm(q - c, axis=-1)
        return ((r >= inner) & (r < outer)).astype(np.float32)

    return Texture(fn)


def box(lo, hi) -> Texture:
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    return Texture(
        lambda p: np.all((p >= lo) & (p < hi), axis=-1).astype(np.float32)
    )


def slab(axis: int, lo: float, hi: float) -> Texture:
    return Texture(
        lambda p: ((p[..., axis] >= lo) & (p[..., axis] < hi)).astype(np.float32)
    )


def mesh(tris: np.ndarray, translate=None, scale=None, resolution: int = 64) -> Texture:
    """Point-in-mesh density via z-ray parity voxelization of a closed
    triangle mesh (the reference's 'mesh' texture rasterizes an obj to a
    volume the same way; banana.py:22-29).
    """
    t = np.asarray(tris, np.float64)
    if scale is not None:
        t = t * np.asarray(scale, np.float64)
    if translate is not None:
        t = t + np.asarray(translate, np.float64)

    lo = t.min((0, 1)) - 1e-4
    hi = t.max((0, 1)) + 1e-4

    def inside(p):
        # parity of ray +z crossings per query point (vectorized over tris).
        # The ray origin is offset by a tiny irrational amount in xy so it
        # cannot hit shared triangle edges (which would double-count).
        p = np.asarray(p, np.float64) + np.array([1.31e-7, 2.71e-7, 0.0])
        flat = p.reshape(-1, 3)
        count = np.zeros(len(flat), np.int64)
        a, b, c = t[:, 0], t[:, 1], t[:, 2]
        for i in range(0, len(flat), 4096):
            q = flat[i : i + 4096]
            # barycentric test in xy
            def cross2(u, v):
                return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]

            qa = q[:, None, :2] - a[None, :, :2]
            ab = (b - a)[None, :, :2]
            ac = (c - a)[None, :, :2]
            d00 = cross2(ab, ac)
            w1 = cross2(qa, ac) / np.where(np.abs(d00) < 1e-30, 1e-30, d00)
            w2 = cross2(ab, qa) / np.where(np.abs(d00) < 1e-30, 1e-30, d00)
            in_tri = (w1 >= 0) & (w2 >= 0) & (w1 + w2 <= 1)
            z_hit = (
                a[None, :, 2]
                + w1 * (b - a)[None, :, 2]
                + w2 * (c - a)[None, :, 2]
            )
            above = in_tri & (z_hit > q[:, None, 2])
            count[i : i + 4096] = above.sum(1)
        return (count % 2 == 1).reshape(p.shape[:-1])

    def fn(p):
        in_bb = np.all((p >= lo) & (p <= hi), axis=-1)
        out = np.zeros(p.shape[:-1], np.float32)
        if in_bb.any():
            out[in_bb] = inside(p[in_bb]).astype(np.float32)
        return out

    return Texture(fn)
