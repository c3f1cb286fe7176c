"""mls-mpm88, PyTorch edition: THE EXPLAINED VERSION.

The walkthrough of the annotated 88-liner: the same 2-D Moving Least
Squares Material Point Method as ``mls_mpm88.py`` beside it, with every
step spelled out, plus notes on what changes when the loop body is a
sequence of whole-array PyTorch operations instead of a per-particle C++
loop. Torch and numpy only, no framework.

MPM in one paragraph
--------------------
MPM is a hybrid particle/grid method. Particles carry the persistent
state (position, velocity, deformation); the grid is a scratchpad
rebuilt every substep. Each substep:

  1. P2G   — particles scatter mass and momentum to nearby grid nodes,
  2. GRID  — nodes turn momentum into velocity, gain gravity, and
             enforce boundary conditions,
  3. G2P   — particles gather the new grid velocities and update their
             deformation gradient, then advect.

MLS-MPM (Hu et al. 2018) is the variant where the force and the APIC
affine-velocity transfer share one moving-least-squares reconstruction
— the stress contribution "rides along" in the same scatter as the
momentum, which is what makes an 88-line implementation possible.

The PyTorch twist
-----------------
The C++ original iterates `for (auto &p : particles)` and scatters with
`grid[base_coord.x + i][...] += ...`. Here every step below is a
whole-array operation over ALL particles at once, and the scatter is
one `index_add_`-style call over the nine stencil offsets of every
particle. Many particles add to the same node, and on the card a plain
`index_add_` adds them with float atomics, in an order that changes
from run to run; this demo's `index_add_ordered` sums each node's
contributions in a fixed order instead, so two runs on the card give the
same bits. The 3x3 stencil loops are Python loops: each of their nine
stages is a handful of kernels over every particle.

    python -m taichi_mpm_torch.demos.mls_mpm88_explained [--cpu] [--frames N]

prints the particles' height range per frame; without --cpu it runs on
the card.
"""
import argparse

import numpy as np
import torch

# -- simulation constants ---------------------------------------------------

n = 80                 # grid resolution: n x n cells over the unit square
dt = 1e-4              # substep — must resolve the elastic wave speed
frame_dt = 4e-3        # one printed frame = 40 substeps
dx, inv_dx = 1.0 / n, float(n)

gravity = 200.0        # the original's scaled gravity (unit square world)
E, nu = 1e4, 0.2       # Young's modulus, Poisson ratio
hardening = 10.0       # snow stiffens when compressed
# Lamé parameters: mu (shear) and lambda (volumetric) from E, nu
mu_0 = E / (2 * (1 + nu))
lam_0 = E * nu / ((1 + nu) * (1 - 2 * nu))

p_vol = (dx * 0.5) ** 2   # each particle represents a quarter-cell area
p_rho = 1.0
p_mass = p_vol * p_rho
N_PARTICLES = 8192


def index_add_ordered(dst, index, src):
    """dst[index[i]] += src[i] in the order of i. On the CPU index_add_
    is that sequential loop. On the card it goes through
    index_put_(accumulate) under torch's deterministic mode: the indices
    sorted stably, each run of equal indices summed in order."""
    if dst.device.type != "cuda":
        return dst.index_add_(0, index, src)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return dst.index_put_((index,), src, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(prev)


def polar_r(F):
    """Rotation factor R of the polar decomposition F = R S, closed
    form in 2-D: R is the rotation by the angle of (a+d, c-b). The
    corotated model measures stretch relative to this rotation so pure
    rigid rotation produces zero stress. (The original calls a library
    `polar_decomp`; in 2-D two hypot-normalized numbers do it, and rsqrt
    keeps the whole thing branch-free.)"""
    a, b, c, d = F[..., 0, 0], F[..., 0, 1], F[..., 1, 0], F[..., 1, 1]
    x, y = a + d, c - b
    s = torch.rsqrt(torch.clamp(x * x + y * y, min=1e-20))
    cs, sn = x * s, y * s
    return torch.stack([torch.stack([cs, -sn], -1), torch.stack([sn, cs], -1)], -2)


def substep(x, v, F, C, Jp):
    """One MLS-MPM substep over every particle simultaneously.

    State (all leading-dim P tensors, on one device):
      x  (P, 2)    position
      v  (P, 2)    velocity
      F  (P, 2, 2) elastic deformation gradient
      C  (P, 2, 2) APIC affine velocity field (velocity gradient)
      Jp (P,)      plastic volume ratio (snow hardening memory)
    """
    dev = x.device
    # ---- locate each particle on the grid --------------------------------
    # Quadratic B-spline support covers 3x3 nodes. `base` is the lowest
    # node of that stencil; `fx` in [0.5, 1.5) is the particle's offset
    # from it in cell units.
    base = torch.floor(x * inv_dx - 0.5).to(torch.int64)
    fx = x * inv_dx - base

    # Quadratic B-spline weights per axis — w[:, i, axis] is the weight
    # of stencil node i in {0,1,2}. They sum to 1 (partition of unity),
    # so scattering conserves mass and momentum exactly.
    w = torch.stack(
        [0.5 * (1.5 - fx) ** 2,
         0.75 - (fx - 1.0) ** 2,
         0.5 * (fx - 0.5) ** 2], 1)                       # (P, 3, 2)

    # ---- constitutive model: fixed corotated + snow hardening ------------
    # Compression (Jp < 1) exponentially stiffens the material — the
    # classic Disney snow hardening.
    e = torch.exp(hardening * (1.0 - Jp))
    mu, lam = mu_0 * e, lam_0 * e
    J = F[:, 0, 0] * F[:, 1, 1] - F[:, 0, 1] * F[:, 1, 0]  # current volume ratio
    R = polar_r(F)
    eye = torch.eye(2, device=dev)

    # PK1 stress (times F^T): 2 mu (F - R) F^T penalizes stretch away
    # from the nearest rotation; lam J (J - 1) I penalizes volume
    # change. This is the force half of the MLS reconstruction.
    PF = (2 * mu[:, None, None] * (F - R) @ F.transpose(1, 2)
          + (lam * J * (J - 1))[:, None, None] * eye)

    # MLS-MPM's key fusion: with quadratic B-splines the inverse inertia
    # tensor D = dx^2/4 I is constant, so the stress term folds into the
    # SAME affine matrix APIC already scatters. One scatter does both
    # momentum transfer and force application.
    D_inv = 4.0 * inv_dx * inv_dx
    stress = -(dt * p_vol) * (D_inv * PF)
    affine = stress + p_mass * C

    # ---- P2G: scatter mass and momentum ----------------------------------
    # grid[..., :2] accumulates momentum, grid[..., 2] mass. The (n+2)^2
    # grid leaves room for the stencil at the domain edge. The 3x3 loop
    # gathers nine (node, value) lists; one ordered scatter-add over all
    # of them sums each node in the order of the loop, stencil offset by
    # stencil offset, particle by particle.
    idx, vals = [], []
    for i in range(3):
        for j in range(3):
            off = torch.tensor([i, j], device=dev)
            dpos = (off - fx) * dx               # node position - particle
            wt = w[:, i, 0] * w[:, j, 1]         # tensor-product weight
            mv = p_mass * v + torch.einsum("pab,pb->pa", affine, dpos)
            vals.append(torch.cat([mv * wt[:, None], (p_mass * wt)[:, None]], 1))
            idx.append((base[:, 0] + i) * (n + 2) + base[:, 1] + j)
    grid = torch.zeros(((n + 2) * (n + 2), 3), device=dev)
    grid = index_add_ordered(grid, torch.cat(idx), torch.cat(vals)).view(n + 2, n + 2, 3)

    # ---- GRID: momentum -> velocity, gravity, boundaries ------------------
    m = grid[..., 2:3]
    gv = torch.where(m > 0, grid[..., :2] / torch.clamp(m, min=1e-30), 0.0)
    gv = torch.where(m > 0, gv + dt * torch.tensor([0.0, -gravity], device=dev), gv)

    # Box boundary, three cells thick: side walls zero the normal (x)
    # velocity; floor and ceiling act as separating walls — they only
    # cancel velocity INTO the wall (the `< 0` / `> 0` guards), so
    # material can leave but not penetrate.
    bx, by = torch.meshgrid(torch.arange(n + 2, device=dev), torch.arange(n + 2, device=dev),
                            indexing="ij")
    gv = torch.where(((bx < 3) | (bx > n - 3))[..., None],
                     gv * torch.tensor([0.0, 1.0], device=dev), gv)
    gv = torch.where(((by < 3) & (gv[..., 1] < 0))[..., None],
                     gv * torch.tensor([1.0, 0.0], device=dev), gv)
    gv = torch.where(((by > n - 3) & (gv[..., 1] > 0))[..., None],
                     gv * torch.tensor([1.0, 0.0], device=dev), gv)

    # ---- G2P: gather velocity and the affine field ------------------------
    # nv is the B-spline-weighted grid velocity; nC is the MLS velocity
    # gradient, reconstructed from the same 9 samples (4/dx^2 is D^-1
    # again). No extra stress pass — this is the other half of the MLS
    # fusion.
    nv = torch.zeros_like(v)
    nC = torch.zeros_like(C)
    for i in range(3):
        for j in range(3):
            dpos = torch.tensor([i, j], device=dev) - fx   # in cell units here
            wt = (w[:, i, 0] * w[:, j, 1])[:, None]
            g = gv[base[:, 0] + i, base[:, 1] + j]
            nv = nv + wt * g
            nC = nC + 4 * inv_dx * (wt * g)[:, :, None] * dpos[:, None, :]

    # ---- advect + elastic/plastic update ----------------------------------
    # Positions clamp just inside the wall band (the pool analog of the
    # original letting particles pile on the boundary).
    x = torch.clamp(x + dt * nv, 2.5 * dx, 1.0 - 2.5 * dx)

    # Elastic prediction: F <- (I + dt grad v) F.
    F = (eye + dt * nC) @ F

    # Snow plasticity: clamp the singular values of F into the elastic
    # region [1-2.5e-2, 1+7.5e-3]; whatever stretch is clipped moves
    # into the plastic ratio Jp (and thereby into the hardening). The
    # original clamps sig the same way inside its SVD.
    U, sig, Vt = torch.linalg.svd(F)
    sig_c = torch.clamp(sig, 1.0 - 2.5e-2, 1.0 + 7.5e-3)
    Jp = torch.clamp(Jp * torch.prod(sig, -1) / torch.prod(sig_c, -1), 0.6, 20.0)
    F = U @ (sig_c[..., None] * Vt)

    return x, nv, F, nC, Jp


def initial_state(device):
    """Two snow squares, one above the other — they fall, collide and
    splat (the original seeds three; the physics is identical): 4,096
    particles each from default_rng(0), at rest, undeformed."""
    rng = np.random.default_rng(0)
    P = N_PARTICLES
    x = np.concatenate([rng.random((P // 2, 2)) * 0.2 + [0.35, 0.6],
                        rng.random((P // 2, 2)) * 0.2 + [0.45, 0.25]])
    x = torch.tensor(x, dtype=torch.float32, device=device)
    v = torch.zeros((P, 2), device=device)
    F = torch.eye(2, device=device).repeat(P, 1, 1)
    C = torch.zeros((P, 2, 2), device=device)
    Jp = torch.ones(P, device=device)
    return x, v, F, C, Jp


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args(argv)
    x, v, F, C, Jp = initial_state("cpu" if args.cpu else "cuda")
    for f in range(args.frames):
        for _ in range(int(frame_dt / dt)):
            x, v, F, C, Jp = substep(x, v, F, C, Jp)
        print(f"frame {f:03d}  y in "
              f"[{float(x[:, 1].min()):.3f}, {float(x[:, 1].max()):.3f}]")
    return x, v, F, C, Jp


if __name__ == "__main__":
    main()
