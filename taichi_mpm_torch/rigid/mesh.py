"""Host-side rigid mesh utilities (numpy, scene-construction time).

A copy of ``taichi_mpm_tpu.rigid.mesh`` (numpy only), kept here so the
port never imports the JAX package; the two must stay equal.

Covers what the reference gets from taichi's Mesh + RigidBody:
  * mesh sources: OBJ loading and procedural primitives (the reference
    ships $mpm/*.obj assets we re-create procedurally);
  * mass / inertia initialization for thin-shell (codimensional) and
    solid bodies (RigidBody::initialize_mass_and_inertia, used at
    the reference's src/mpm_rigid_body.cpp:191);
  * boundary-particle sampling at ~dx spacing over segments (2D) /
    triangles (3D) (mpm_rigid_body.cpp:216-255).

Everything here runs once at scene build; outputs are plain numpy arrays
that the scene build moves to the scene's device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Mesh sources. 3D mesh = (T, 3, 3) triangle vertex array; 2D = (S, 2, 2).
# ---------------------------------------------------------------------------


def load_obj(path: str) -> np.ndarray:
    """Minimal OBJ triangle loader (v / f lines, fans polygons)."""
    verts, tris = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    tris.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float32)
    return v[np.asarray(tris, np.int64)]


def box_mesh(half_extents=(0.5, 0.5, 0.5)) -> np.ndarray:
    """Axis-aligned box centered at the origin, 12 triangles (T,3,3)."""
    hx, hy, hz = half_extents
    c = np.array(
        [[sx * hx, sy * hy, sz * hz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float32,
    )
    # faces as corner indices (outward CCW)
    quads = [
        (0, 1, 3, 2),  # -x
        (4, 6, 7, 5),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    tris = []
    for a, b, cc, d in quads:
        tris.append([c[a], c[b], c[cc]])
        tris.append([c[a], c[cc], c[d]])
    return np.asarray(tris, np.float32)


def sphere_mesh(radius=0.5, subdiv=2) -> np.ndarray:
    """Icosphere (T,3,3)."""
    t = (1 + 5**0.5) / 2
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float32,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    tris = v[np.asarray(f, np.int64)]
    for _ in range(subdiv):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        ab /= np.linalg.norm(ab, axis=1, keepdims=True)
        bc /= np.linalg.norm(bc, axis=1, keepdims=True)
        ca /= np.linalg.norm(ca, axis=1, keepdims=True)
        tris = np.concatenate(
            [
                np.stack([a, ab, ca], 1),
                np.stack([ab, b, bc], 1),
                np.stack([ca, bc, c], 1),
                np.stack([ab, bc, ca], 1),
            ]
        )
    return (tris * radius).astype(np.float32)


def cylinder_mesh(radius=0.5, half_height=0.5, n=24, capped=True, axis=2):
    """Cylinder along `axis`, centered at origin (T,3,3)."""
    tris = []
    ang = np.linspace(0, 2 * math.pi, n + 1)
    for k in range(n):
        a0, a1 = ang[k], ang[k + 1]
        p00 = [radius * math.cos(a0), radius * math.sin(a0), -half_height]
        p01 = [radius * math.cos(a1), radius * math.sin(a1), -half_height]
        p10 = [radius * math.cos(a0), radius * math.sin(a0), half_height]
        p11 = [radius * math.cos(a1), radius * math.sin(a1), half_height]
        tris.append([p00, p01, p11])
        tris.append([p00, p11, p10])
        if capped:
            tris.append([[0, 0, -half_height], p01, p00])
            tris.append([[0, 0, half_height], p10, p11])
    tris = np.asarray(tris, np.float32)
    if axis != 2:
        order = {0: (2, 1, 0), 1: (0, 2, 1)}[axis]
        tris = tris[..., list(order)]
    return tris


def paddle_wheel_mesh(n_paddles=6, inner=0.05, outer=0.16, half_w=0.05) -> np.ndarray:
    """3D paddle wheel about the z axis: n thin radial plates, one mesh
    so the center of mass sits on the axle (the shape of the reference's
    ww_gears/ww_spoke water-wheel assets)."""
    tris = []
    for k in range(n_paddles):
        a = 2 * math.pi * k / n_paddles
        plate = plate_mesh(half_u=(outer - inner) / 2, half_v=half_w, axis=1)
        plate = plate + np.array([(inner + outer) / 2, 0, 0], np.float32)
        c, s = math.cos(a), math.sin(a)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        tris.append(plate @ R.T)
    return np.concatenate(tris)


def plate_mesh(half_u=0.5, half_v=0.5, axis=2) -> np.ndarray:
    """A flat rectangular thin shell (2 triangles) with normal on `axis`.

    The thin-cutter geometry of the cutting scenes (banana.py uses a
    $mpm/cutter.obj plane)."""
    quad = np.array(
        [[-half_u, -half_v, 0], [half_u, -half_v, 0], [half_u, half_v, 0], [-half_u, half_v, 0]],
        np.float32,
    )
    tris = np.asarray([[quad[0], quad[1], quad[2]], [quad[0], quad[2], quad[3]]])
    if axis != 2:
        order = {0: (2, 1, 0), 1: (0, 2, 1)}[axis]
        tris = tris[..., list(order)]
    return tris.astype(np.float32)


# -- 2D meshes: (S, 2, 2) segment arrays, outward normal = rot90(b - a) -----


def polygon_mesh_2d(verts: np.ndarray) -> np.ndarray:
    """Closed polygon (CCW vertex order => outward normals)."""
    v = np.asarray(verts, np.float32)
    nxt = np.roll(v, -1, axis=0)
    return np.stack([v, nxt], axis=1)


def segment_mesh_2d(a, b) -> np.ndarray:
    return np.asarray([[a, b]], np.float32)


def wheel_mesh_2d(radius=0.1, n_spokes=6, spoke_width=0.02) -> np.ndarray:
    """A 2D paddle wheel: n rectangular spokes radiating from the center
    (shape of the reference's sand_wheel_2D $mpm/wheel.obj scene)."""
    segs = []
    for k in range(n_spokes):
        a = 2 * math.pi * k / n_spokes
        d = np.array([math.cos(a), math.sin(a)], np.float32)
        t = np.array([-d[1], d[0]], np.float32) * (spoke_width / 2)
        p0, p1 = t, t + d * radius
        p2, p3 = -t + d * radius, -t
        segs += [[p0, p1], [p1, p2], [p2, p3]]
    return np.asarray(segs, np.float32)


# ---------------------------------------------------------------------------
# Normals / mass / inertia
# ---------------------------------------------------------------------------


def element_normals(elem: np.ndarray) -> np.ndarray:
    """Unit normals of segments (S,2,2) or triangles (T,3,3)."""
    if elem.shape[-1] == 2:
        d = elem[:, 1] - elem[:, 0]
        n = np.stack([d[:, 1], -d[:, 0]], -1)
    else:
        n = np.cross(elem[:, 1] - elem[:, 0], elem[:, 2] - elem[:, 0])
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)


def element_measure(elem: np.ndarray) -> np.ndarray:
    """Length (2D) or area (3D) per element."""
    if elem.shape[-1] == 2:
        return np.linalg.norm(elem[:, 1] - elem[:, 0], axis=-1)
    return 0.5 * np.linalg.norm(
        np.cross(elem[:, 1] - elem[:, 0], elem[:, 2] - elem[:, 0]), axis=-1
    )


def shell_mass_properties(elem: np.ndarray, density: float):
    """Thin-shell (codimensional) mass, center of mass, inertia about CoM.

    Surface integration with per-element lumping at centroids + the
    element's own second moment (adequate at ~dx resolution). Returns
    (mass, com (d,), inertia): inertia is a 3x3 tensor in 3D, a scalar
    in 2D.
    """
    d = elem.shape[-1]
    m_e = element_measure(elem) * density
    cent = elem.mean(axis=1)
    mass = float(m_e.sum())
    com = (m_e[:, None] * cent).sum(0) / max(mass, 1e-30)
    r = cent - com
    if d == 2:
        inertia = float((m_e * (r * r).sum(-1)).sum())
        # element own moment: segment of length L about its center: mL^2/12
        L = element_measure(elem)
        inertia += float((m_e * L * L / 12.0).sum())
        return mass, com.astype(np.float32), inertia
    # 3D: I = sum m (|r|^2 I3 - r r^T), sampled at 3 vertices + centroid
    # per triangle for a better second moment.
    I = np.zeros((3, 3), np.float64)
    for w, pts in ((0.25, elem[:, 0]), (0.25, elem[:, 1]), (0.25, elem[:, 2]), (0.25, cent)):
        rr = pts - com
        r2 = (rr * rr).sum(-1)
        I += (
            w
            * (
                m_e[:, None, None]
                * (r2[:, None, None] * np.eye(3) - rr[:, :, None] * rr[:, None, :])
            ).sum(0)
        )
    return mass, com.astype(np.float32), I.astype(np.float32)


def solid_mass_properties(tris: np.ndarray, density: float):
    """Solid-body mass properties via signed tetrahedra to the origin
    (standard divergence-theorem volume integrals; 3D only)."""
    a, b, c = tris[:, 0].astype(np.float64), tris[:, 1].astype(np.float64), tris[:, 2].astype(np.float64)
    vol6 = np.einsum("ij,ij->i", a, np.cross(b, c))  # 6 * signed volume
    volume = vol6.sum() / 6.0
    # canonical tet covariance
    C_canon = np.array([[1 / 60, 1 / 120, 1 / 120], [1 / 120, 1 / 60, 1 / 120], [1 / 120, 1 / 120, 1 / 60]])
    C = np.zeros((3, 3))
    for i in range(len(tris)):
        A = np.stack([a[i], b[i], c[i]], axis=1)  # columns
        C += vol6[i] * A @ C_canon @ A.T
    mass = density * volume
    com_ = ((a + b + c) * vol6[:, None]).sum(0) / (4.0 * vol6.sum())
    C = density * C
    # shift to CoM
    C -= mass * np.outer(com_, com_)
    I = np.trace(C) * np.eye(3) - C
    return float(mass), com_.astype(np.float32), I.astype(np.float32)


def mass_properties(elem: np.ndarray, density: float, codimensional: bool):
    if codimensional or elem.shape[-1] == 2:
        return shell_mass_properties(elem, density)
    return solid_mass_properties(elem, density)


# ---------------------------------------------------------------------------
# Boundary-particle sampling (mpm_rigid_body.cpp:216-255)
# ---------------------------------------------------------------------------


def sample_boundary_particles(elem: np.ndarray, dx: float):
    """Sample surface particles at ~dx spacing.

    Returns (positions (B,d), normals (B,d), elem_idx (B,)) in the mesh
    frame (pre-recentering). 2D: >=2 samples per segment at midpoints of
    equal subdivisions; 3D: a dx-lattice over each triangle's (u,v)
    parallelogram clipped to the triangle (same strategy as the
    reference's nested _x/_y loops)."""
    d = elem.shape[-1]
    pos, nrm, eid = [], [], []
    normals = element_normals(elem)
    if d == 2:
        for i, (a, b) in enumerate(elem):
            L = float(np.linalg.norm(b - a))
            n_samples = max(int(math.ceil(L / dx)), 2)
            ts = (0.5 + np.arange(n_samples)) / n_samples
            pos.append(a[None] + ts[:, None] * (b - a)[None])
            nrm.append(np.broadcast_to(normals[i], (n_samples, 2)))
            eid.append(np.full(n_samples, i, np.int32))
    else:
        eps = 1e-6
        for i, tri in enumerate(elem):
            e1, e2 = tri[1] - tri[0], tri[2] - tri[0]
            lx, ly = float(np.linalg.norm(e1)), float(np.linalg.norm(e2))
            if lx < 1e-12 or ly < 1e-12:
                continue
            xn, yn = e1 / lx, e2 / ly
            xs = np.arange(min(lx / 3.0, dx / 2.0), lx + dx, dx)
            ys = np.arange(min(ly / 3.0, dx / 2.0), ly + dx, dx)
            pts = []
            for _x in xs:
                x = _x if _x < lx else _x - dx / 2.0
                for _y in ys:
                    y = _y if _y < ly else _y - dx / 2.0
                    if x / lx + y / ly > 1.0 - eps:
                        continue
                    pts.append(tri[0] + xn * x + yn * y)
            if not pts:
                pts = [tri.mean(0)]
            pts = np.asarray(pts, np.float32)
            pos.append(pts)
            nrm.append(np.broadcast_to(normals[i], (len(pts), 3)))
            eid.append(np.full(len(pts), i, np.int32))
    return (
        np.concatenate(pos).astype(np.float32),
        np.concatenate(nrm).astype(np.float32),
        np.concatenate(eid),
    )
