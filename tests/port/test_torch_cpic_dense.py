"""Port vs JAX: the coloured transfers and the dense CPIC frame.

Two scenes, each built by the JAX package's ``MPM`` and handed to the
port in numpy: the 2-D plate of tests/test_cpic.py::
test_particles_rest_on_thin_plate (32 jelly particles falling onto a
scripted segment, res 32) and the 3-D plate of tests/test_cpic.py::
test_matches_oracle_cpic (200 jelly particles about a scripted plate,
res 16). The JAX reference is its ``rigid.cpic.cpic_substep`` (the body
of its ``MPM`` dense CPIC frame and of its ``AsyncMPM`` oracle adaptive
frame) jitted once per scene with dt as an argument, beside the same
substep's P2G and G2P inputs and outputs (each JAX configuration of this
slice compiles in 5-20 s here, so each scene compiles one). The port's
``p2g_cpic``, ``g2p_cpic``, four ``cpic_substep`` and its ``MPM`` /
``AsyncMPM`` frames are held at the bounds tests/test_cpic.py holds
JAX's own paths to (x 5e-6, v 5e-4, F 5e-5, states and near_b equal,
body vel and omega 1e-5, pos 1e-6); grid records to 1e-6 of their
scale, impulses to 1e-5; substep counts equal.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taichi_mpm_tpu.core import adaptive as jadaptive
from taichi_mpm_tpu.core import transfer as jtransfer
from taichi_mpm_tpu.core.solver import MPM as JMPM
from taichi_mpm_tpu.rigid import body as jbody
from taichi_mpm_tpu.rigid import cdf as jcdf
from taichi_mpm_tpu.rigid import cpic as jcpic
from taichi_mpm_tpu.rigid.mesh import plate_mesh, segment_mesh_2d
from taichi_mpm_torch import MPM, convert
from taichi_mpm_torch.core.adaptive import AsyncMPM
from taichi_mpm_torch.rigid import body as tbody
from taichi_mpm_torch.rigid import cdf as tcdf
from taichi_mpm_torch.rigid import cpic as tcpic

from port_helpers import assert_cpic_close, assert_gather_close, max_err, np_of, port_inputs

torch.set_num_threads(1)

N_SUB = 4
GRID_REL, IMPULSE_REL = 1e-6, 1e-5


def plate_2d(cls=JMPM, **kw):
    """tests/test_cpic.py::test_particles_rest_on_thin_plate's scene."""
    sim = cls(res=(32, 32), base_delta_t=1e-4, gravity=(0, -10.0), **dict(dict(frame_dt=2e-3), **kw))
    xs, ys = np.linspace(0.4, 0.6, 8), np.linspace(0.53, 0.6, 4)
    pos = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    sim.add_particles("jelly", pos=pos, vel=(0.0, -0.5), E=1e4, nu=0.3)
    sim.add_particles("rigid", mesh=segment_mesh_2d((-0.3, 0.0), (0.3, 0.0)),
                      scripted_position=lambda t: (0.5, 0.5), codimensional=True, friction=0.0)
    return sim


def plate_3d(cls=JMPM, **kw):
    """tests/test_cpic.py::test_matches_oracle_cpic's scene."""
    rng = np.random.default_rng(3)
    sim = cls(res=(16, 16, 16), base_delta_t=2e-4, gravity=(0, -10.0, 0), penalty=1e3, **kw)
    pos = rng.uniform(0.3, 0.7, size=(200, 3)).astype(np.float32)
    sim.add_particles("jelly", pos=pos, vel=(0, -0.5, 0), E=1e4, nu=0.3, density=1000)
    sim.add_particles("rigid", mesh=plate_mesh(half_u=0.25, half_v=0.25, axis=1),
                      scripted_position=lambda t: (0.5, 0.45, 0.5),
                      scripted_rotation=lambda t: (0.0, 0.0, 0.0),
                      codimensional=True, friction=0.2)
    return sim


SCENES = {"2d": plate_2d, "3d": plate_3d}


def jax_parts(cfg, scene):
    """JAX's cpic_substep(p, bodies, t, dt), and beside it the same
    substep's CDF, P2G inputs and outputs and G2P inputs and outputs,
    from the JAX package's own functions in its order; one jit."""
    R = cfg.num_rigids

    def parts(p, bodies, t, dt):
        xb, _, elem = jbody.boundary_particle_world(bodies, scene.bp_rid, scene.bp_offset,
                                                    scene.bp_normal, scene.bp_elem)
        planes = jcdf.rasterize_rigid_boundary(xb, elem, scene.bp_rid, R, cfg)
        st, bd, bn, nb = jcdf.gather_cdf(p.x, p.states, *planes, R, cfg)
        pc = dataclasses.replace(p, states=st, bdist=bd, bnormal=bn, near_b=nb)
        grid, J1, tau1 = jcpic.p2g_cpic(pc, bodies, planes[1], planes[2], cfg, dt)
        b1 = jbody.apply_impulses(bodies, J1, tau1)
        grid_v, _ = jtransfer.grid_update(grid, cfg, scene.colliders, t, dt)
        pg, J2, tau2 = jcpic.g2p_cpic(pc, b1, grid_v, planes[1], planes[2], cfg, dt)
        return jcpic.cpic_substep(p, bodies, t, cfg, scene, dt), dict(
            planes=planes, pc=pc, grid=grid, J1=J1, tau1=tau1, b1=b1, grid_v=grid_v, pg=pg,
            J2=J2, tau2=tau2)

    return jax.jit(parts)


@pytest.fixture(scope="module", params=["2d", "3d"])
def run(request):
    """The scene's JAX run: N_SUB substeps of base_dt (as float32), each
    substep's outputs and parts kept; the compiled function."""
    sim = SCENES[request.param]()
    sim._finalize()
    cfg = sim.cfg
    fn = jax_parts(cfg, sim.rigid_scene)
    p, b, t, dt = sim.particles, sim.bodies, jnp.float32(0.0), jnp.float32(cfg.base_dt)
    steps = []
    for _ in range(N_SUB):
        (p, b, t), parts = fn(p, b, t, dt)
        steps.append((p, b, t, parts))
    return dict(label=request.param, sim=sim, fn=fn, steps=steps)


def _close_rel(a, b, rel):
    assert max_err(a, b) <= rel * max(1.0, float(np.abs(np.asarray(a)).max()))


def test_gather_cdf_matches_jax(run):
    """The dense CDF gather of each substep, from JAX's own CDF planes and
    particles: states and near_b equal, bdist and bnormal at the bounds
    of test_torch_cdf_2d.py."""
    sim = run["sim"]
    tcfg = port_inputs(sim)[3]
    p = sim.particles
    for p_next, _, _, parts in run["steps"]:
        tout = tcdf.gather_cdf(*(torch.as_tensor(np.array(a)) for a in (p.x, p.states)),
                               *(torch.as_tensor(np.array(a)) for a in parts["planes"]),
                               sim.cfg.num_rigids, tcfg)
        pc = parts["pc"]
        assert_gather_close((pc.states, pc.bdist, pc.bnormal, pc.near_b), tout, sim.cfg.dx)
        p = p_next


def test_p2g_cpic_matches_jax(run):
    """The first substep's P2G from JAX's own CDF and particles: grid
    records, impulse and torque totals."""
    sim, parts = run["sim"], run["steps"][0][3]
    _, tb, _, tcfg = port_inputs(sim)
    pc = convert.particles_from_numpy(convert.particles_to_numpy(parts["pc"]))
    planes = [torch.as_tensor(np.array(a)) for a in parts["planes"]]
    grid, J, tau = tcpic.p2g_cpic(pc, tb, planes[1], planes[2], tcfg, np.float32(tcfg.base_dt))
    _close_rel(parts["grid"], grid, GRID_REL)
    assert bool((np.asarray(parts["J1"]) != 0).any())  # the plate takes impulses
    _close_rel(parts["J1"], J, IMPULSE_REL)
    _close_rel(parts["tau1"], tau, IMPULSE_REL)


def test_g2p_cpic_matches_jax(run):
    """The first substep's G2P from JAX's own node velocities: particles
    at the CPIC bounds, the penalty impulses."""
    sim, parts = run["sim"], run["steps"][0][3]
    tcfg = port_inputs(sim)[3]
    pc = convert.particles_from_numpy(convert.particles_to_numpy(parts["pc"]))
    b1 = convert.bodies_from_jax(parts["b1"])
    planes = [torch.as_tensor(np.array(a)) for a in parts["planes"]]
    pg, J, tau = tcpic.g2p_cpic(pc, b1, torch.as_tensor(np.array(parts["grid_v"])), planes[1],
                                planes[2], tcfg, np.float32(tcfg.base_dt))
    assert_cpic_close(parts["pg"], parts["b1"], pg, b1)
    _close_rel(parts["J2"], J, IMPULSE_REL)
    _close_rel(parts["tau2"], tau, IMPULSE_REL)


def test_substeps_match_jax(run):
    """Four cpic_substep from the same state: particles and bodies after
    each, and t."""
    tp, tb, ts, tcfg = port_inputs(run["sim"])
    t = np.float32(0.0)
    for jp, jb, jt, _ in run["steps"]:
        tp, tb, t, _ = tcpic.cpic_substep(tp, tb, t, tcfg, ts, np.float32(tcfg.base_dt))
        assert_cpic_close(jp, jb, tp, tb)
        assert t == np.float32(jt)
    assert int(np_of(tp.near_b).sum()) > 0


def test_mpm_frame_matches_jax(run):
    """The port's MPM on the scene, built through its own API (the 3-D
    scene with optimized=False: the dense CPIC frame), one frame of four
    substeps against the JAX run; the frame at B-spline orders 1 and 3
    runs too (the 3-D order-3 scene warns and takes the dense path)."""
    jp, jb, jt, _ = run["steps"][-1]
    kw = dict(optimized=False) if run["label"] == "3d" else {}
    sim = SCENES[run["label"]](MPM, device="cpu", **kw)
    sim.frame_dt = N_SUB * sim.cfg.base_dt
    sim.step()
    assert sim.packed_carry is None
    assert_cpic_close(jp, jb, sim.particles, sim.bodies)
    assert sim.t == np.float32(jt)
    for order in (1, 3):
        other = SCENES[run["label"]](MPM, device="cpu", kernel_order=order)
        other.frame_dt = N_SUB * other.cfg.base_dt
        with pytest.warns(UserWarning) if run["label"] == "3d" else contextlib.nullcontext():
            other.step()
        assert other.packed_carry is None and other.particles.count() == sim.particles.count()
        assert bool(torch.isfinite(other.particles.x).all())


def test_async_unfused_matches_jax(run, monkeypatch):
    """AsyncMPM on the scene (in 3-D with TMT_FUSED=0: the dense CPIC
    frame) against JAX's oracle adaptive CPIC frame driven step by step:
    dt = min(snap_pot(dt_limit), t_end - t) until t_end - 1e-9, the
    substep jitted above. Equal substep counts, the CPIC bounds."""
    monkeypatch.setenv("TMT_FUSED", "0")
    frame_dt, unit = 1e-3, 1e-6
    sim = SCENES[run["label"]](AsyncMPM, frame_dt=frame_dt, unit_delta_t=unit, device="cpu")
    sim.step()
    assert sim.packed_carry is None
    jsim, fn = run["sim"], run["fn"]
    cfg = jsim.cfg
    limit = jax.jit(lambda p: jadaptive.snap_pot(jadaptive.dt_limit(p, cfg), unit, cfg.base_dt))
    p, b, t = jsim.particles, jsim.bodies, jnp.float32(0.0)
    t_end = t + frame_dt
    n = 0
    while bool(t < t_end - 1e-9):
        (p, b, t), _ = fn(p, b, t, jnp.minimum(limit(p), t_end - t))
        n += 1
    assert sim.last_substeps == n > 1
    assert_cpic_close(p, b, sim.particles, sim.bodies)
    assert sim.t == np.float32(t)


def test_impulse_sums_per_offset():
    """The per-offset impulse sums of p2g_cpic (one ordered scatter into
    offset x body rows, then the offsets added in order) equal JAX's
    accumulate_impulses per offset added in a loop, in bits."""
    rng = np.random.default_rng(4)
    K, n, R = 9, 500, 3
    vals = dict(pos=rng.uniform(0.3, 0.7, (R, 2)), vel=np.zeros((R, 2)), rot=np.zeros((R, 1)),
                omega=np.zeros((R, 1)), mass_inv=np.ones(R), inertia_inv=np.ones((R, 1)),
                friction=np.zeros((R, 2)), restitution=np.zeros(R),
                rotation_axis=np.zeros((R, 3)), linear_damping=np.zeros(R),
                angular_damping=np.zeros(R))
    vals = {k: np.asarray(v, np.float32) for k, v in vals.items()}
    jb = jbody.RigidBodies(**{k: jnp.asarray(v) for k, v in vals.items()})
    tb = tbody.RigidBodies(**{k: torch.as_tensor(v) for k, v in vals.items()})
    rid = rng.integers(0, R, (K, n))
    J = rng.normal(size=(K, n, 2)).astype(np.float32)
    at = rng.uniform(0.2, 0.8, (K, n, 2)).astype(np.float32)
    valid = rng.uniform(size=(K, n)) < 0.6
    jJ = jnp.zeros((R, 2))
    jt = jnp.zeros((R, 1))
    for k in range(K):
        a, b = jbody.accumulate_impulses(jb, jnp.asarray(rid[k]), jnp.asarray(J[k]),
                                         jnp.asarray(at[k]), jnp.asarray(valid[k]))
        jJ, jt = jJ + a, jt + b
    tJ, tt = tcpic._offset_sums(tb, torch.as_tensor(rid), torch.as_tensor(J), torch.as_tensor(at),
                                torch.as_tensor(valid))
    assert np.array_equal(np.asarray(jJ), np_of(tJ)) and np.array_equal(np.asarray(jt), np_of(tt))



def test_coupling_iterations_blocked_vs_dense():
    """tests/test_cpic.py:447 on the port: with coupling_iterations = 2 the
    blocked substep (the pytree frame's) still matches the dense oracle
    substep, both looping the prologue: x 5e-6, body vel 1e-5 (a free
    plate under 150 jelly particles, res 16). The prologue's two
    iterations are held against JAX's in tests/port/test_torch_cdf.py."""
    from taichi_mpm_torch.core import transfer as ttransfer
    from taichi_mpm_torch.ops.blocked import sort_particles
    from taichi_mpm_torch.rigid import cpic_blocked as tcb
    from taichi_mpm_torch.rigid import cpic_packed as tcp

    rng = np.random.default_rng(5)
    sim = MPM(res=(16, 16, 16), base_delta_t=2e-4, gravity=(0, -10.0, 0), penalty=1e3,
              coupling_iterations=2, device="cpu")
    pos = rng.uniform(0.3, 0.7, size=(150, 3)).astype(np.float32)
    sim.add_particles("jelly", pos=pos, vel=(0, -0.5, 0), E=1e4, nu=0.3, density=1000)
    sim.add_particles("rigid", mesh=plate_mesh(half_u=0.25, half_v=0.25, axis=1),
                      initial_position=(0.5, 0.45, 0.5), density=500.0, codimensional=True,
                      friction=0.2)
    sim._finalize()
    cfg, scene = sim.cfg, sim.rigid_scene
    assert cfg.coupling_iterations == 2
    p0, _, _ = sort_particles(sim.particles, cfg)
    t, dt = np.float32(0.0), np.float32(cfg.base_dt)
    p_o, b_o, _, _ = tcpic.cpic_substep(p0, sim.bodies, t, cfg, scene, dt,
                                        ttransfer.node_positions(cfg, p0.device))
    (p_b, b_b, _), _, n_near = tcb.cpic_blocked_substep(p0, sim.bodies, t, cfg, scene, dt, 96,
                                                        tcp.Capacities(128))
    assert n_near > 0
    assert max_err(p_o.x, p_b.x) <= 5e-6
    assert max_err(b_o.vel, b_b.vel) <= 1e-5
    assert max_err(b_o.vel, sim.bodies.vel) > 0  # the plate took impulses
