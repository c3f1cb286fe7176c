"""mls-mpm88, PyTorch edition: a self-contained dense-grid 2-D MLS-MPM in
about 88 lines (80x80 grid, fixed corotated elasticity with snow
plasticity, a sticky box). Torch and numpy only, no framework: one
substep as a plain function on tensors.

The grid scatter sums each node's contributions in a fixed order (the
demo's own ``index_add_ordered``), so two runs on the card give the same
bits.

    python -m taichi_mpm_torch.demos.mls_mpm88 [--cpu] [--frames N]

prints the particles' height range per frame; without --cpu it runs on
the card.
"""
import argparse

import numpy as np
import torch

n, dt, frame_dt = 80, 1e-4, 4e-3
dx, inv_dx = 1.0 / n, float(n)
gravity, E, nu, hardening = 200.0, 1e4, 0.2, 10.0
mu_0, lam_0 = E / (2 * (1 + nu)), E * nu / ((1 + nu) * (1 - 2 * nu))
p_vol, p_rho = (dx * 0.5) ** 2, 1.0
p_mass = p_vol * p_rho
N_PARTICLES = 8192


def index_add_ordered(dst, index, src):
    """dst[index[i]] += src[i] in the order of i: index_add_ on the CPU (a
    sequential loop); on the card index_put_(accumulate) under torch's
    deterministic mode (a stable sort, each run of equal indices summed in
    order), where index_add_'s float atomics would change order from run
    to run."""
    if dst.device.type != "cuda":
        return dst.index_add_(0, index, src)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return dst.index_put_((index,), src, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(prev)


def polar_r(F):  # 2x2 rotation factor of F (closed form)
    a, b, c, d = F[..., 0, 0], F[..., 0, 1], F[..., 1, 0], F[..., 1, 1]
    x, y = a + d, c - b
    s = torch.rsqrt(torch.clamp(x * x + y * y, min=1e-20))
    cs, sn = x * s, y * s
    return torch.stack([torch.stack([cs, -sn], -1), torch.stack([sn, cs], -1)], -2)


def substep(x, v, F, C, Jp):
    dev = x.device
    base = torch.floor(x * inv_dx - 0.5).to(torch.int64)
    fx = x * inv_dx - base
    w = torch.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2, 0.5 * (fx - 0.5) ** 2], 1)
    e = torch.exp(hardening * (1.0 - Jp))
    mu, lam = mu_0 * e, lam_0 * e
    J = F[:, 0, 0] * F[:, 1, 1] - F[:, 0, 1] * F[:, 1, 0]
    R = polar_r(F)
    eye = torch.eye(2, device=dev)
    # fixed corotated PK1 F^T, fused into the APIC affine
    D_inv = 4.0 * inv_dx * inv_dx
    PF = 2 * mu[:, None, None] * (F - R) @ F.transpose(1, 2) + (lam * J * (J - 1))[:, None, None] * eye
    stress = -(dt * p_vol) * (D_inv * PF)
    affine = stress + p_mass * C

    idx, vals = [], []
    for i in range(3):
        for j in range(3):
            dpos = (torch.tensor([i, j], device=dev) - fx) * dx
            wt = w[:, i, 0] * w[:, j, 1]
            mv = p_mass * v + torch.einsum("pab,pb->pa", affine, dpos)
            vals.append(torch.cat([mv * wt[:, None], (p_mass * wt)[:, None]], 1))
            idx.append((base[:, 0] + i) * (n + 2) + base[:, 1] + j)
    grid = torch.zeros(((n + 2) * (n + 2), 3), device=dev)
    grid = index_add_ordered(grid, torch.cat(idx), torch.cat(vals)).view(n + 2, n + 2, 3)

    m = grid[..., 2:3]
    gv = torch.where(m > 0, grid[..., :2] / torch.clamp(m, min=1e-30), 0.0)
    gv = torch.where(m > 0, gv + dt * torch.tensor([0.0, -gravity], device=dev), gv)
    bx, by = torch.meshgrid(torch.arange(n + 2, device=dev), torch.arange(n + 2, device=dev),
                            indexing="ij")
    gv = torch.where(((bx < 3) | (bx > n - 3))[..., None], gv * torch.tensor([0.0, 1.0], device=dev), gv)
    gv = torch.where(((by < 3) & (gv[..., 1] < 0))[..., None], gv * torch.tensor([1.0, 0.0], device=dev), gv)
    gv = torch.where(((by > n - 3) & (gv[..., 1] > 0))[..., None], gv * torch.tensor([1.0, 0.0], device=dev), gv)

    nv = torch.zeros_like(v)
    nC = torch.zeros_like(C)
    for i in range(3):
        for j in range(3):
            dpos = torch.tensor([i, j], device=dev) - fx
            wt = (w[:, i, 0] * w[:, j, 1])[:, None]
            g = gv[base[:, 0] + i, base[:, 1] + j]
            nv = nv + wt * g
            nC = nC + 4 * inv_dx * (wt * g)[:, :, None] * dpos[:, None, :]
    x = torch.clamp(x + dt * nv, 2.5 * dx, 1.0 - 2.5 * dx)
    F = (eye + dt * nC) @ F
    # snow plasticity: clamp singular values
    U, sig, Vt = torch.linalg.svd(F)
    sig_c = torch.clamp(sig, 1.0 - 2.5e-2, 1.0 + 7.5e-3)
    Jp = torch.clamp(Jp * torch.prod(sig, -1) / torch.prod(sig_c, -1), 0.6, 20.0)
    F = U @ (sig_c[..., None] * Vt)
    return x, nv, F, nC, Jp


def initial_state(device):
    """Two snow squares of 4,096 particles each from default_rng(0): x, v,
    F, C, Jp on `device`."""
    rng = np.random.default_rng(0)
    P = N_PARTICLES
    x = np.concatenate([rng.random((P // 2, 2)) * 0.2 + [0.35, 0.6],
                        rng.random((P // 2, 2)) * 0.2 + [0.45, 0.25]])
    x = torch.tensor(x, dtype=torch.float32, device=device)
    v = torch.zeros((P, 2), device=device)
    F = torch.eye(2, device=device).repeat(P, 1, 1)
    return x, v, F, torch.zeros((P, 2, 2), device=device), torch.ones(P, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args(argv)
    x, v, F, C, Jp = initial_state("cpu" if args.cpu else "cuda")
    for f in range(args.frames):
        for _ in range(int(frame_dt / dt)):
            x, v, F, C, Jp = substep(x, v, F, C, Jp)
        print(f"frame {f:03d}  y in [{float(x[:,1].min()):.3f}, {float(x[:,1].max()):.3f}]")
    return x, v, F, C, Jp


if __name__ == "__main__":
    main()
