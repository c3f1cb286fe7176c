"""Port vs JAX: the CPIC substep's stages, one by one, on a small scene
with the CPIC benchmark's bodies (hub + 6-paddle wheel, a colliding pair
joined by a rotation articulation) and water on the paddles, res 16.

Both packages start from the same packed, sorted state (the JAX
package's ``cpic_packed_pack_carry``). Held:

* the rigid prologue (rigidify, articulate, rasterize) with the dense
  CDF, the record CDF and the lazy rigid page map: bodies 1e-6 of their
  scale; CDF states and rigid ids exactly, distances 1e-6 (world units,
  a quantized key's decode);
* the near-rigid compaction: its lanes and both counts exactly, and the
  JAX package's own output has no lane written twice, so its scatters
  with repeated indices equal the port's writes of the valid lanes only;
* the CDF gather: states and near_b exactly, bdist 1e-6, bnormal 1e-5;
* both corrections on seeded records: 1e-6 of the records' scale,
  impulses 1e-5 of theirs, rid_last exactly;
* the gather-only G2P's plain version against ``g2p_blocked`` in
  interpret mode, with the block-local positions built as the JAX CPIC
  frame builds them: 1e-5 of max|v| (the TPU kernel forms B as
  pos * v - sum w g node, the port as sum w g (pos - node));
* the prologue at coupling_iterations = 2 against JAX's; and, on the
  port alone, with a stale lazy map, which it must rebuild (a res-64
  plate scene): the CDF of a fresh build in bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.ops import blocked as jblocked
from taichi_mpm_tpu.ops.g2p_pallas import g2p_blocked as jax_g2p_blocked
from taichi_mpm_tpu.rigid import cdf as jcdf
from taichi_mpm_tpu.rigid import cpic_blocked as jcb
from taichi_mpm_tpu.rigid import cpic_packed as jcp
from taichi_mpm_tpu.rigid.body import boundary_particle_world as jbpw
from taichi_mpm_torch import convert
from taichi_mpm_torch.ops import blocked as tblocked
from taichi_mpm_torch.ops import g2p as tg2p
from taichi_mpm_torch.ops import packed as tpacked
from taichi_mpm_torch.ops.rows import RBN, RNEARB, RORG, RSTATES, RX
from taichi_mpm_torch.rigid import cdf as tcdf
from taichi_mpm_torch.rigid import cpic_blocked as tcb
from taichi_mpm_torch.rigid import cpic_packed as tcp
from taichi_mpm_torch.rigid.body import boundary_particle_world

from port_helpers import jax_hub_wheel_scene, max_err, np_of, port_inputs

torch.set_num_threads(1)

K, NEAR, B1 = 128, 256, 1024
MODES = ("dense", "record", "lazy")  # Kr = 0; Kr = 128 rebuilt; Kr = 128 lazy map


def _scale(a):
    return max(1.0, float(np.abs(np_of(a)).max()))


@pytest.fixture(scope="module")
def scene():
    sim = jax_hub_wheel_scene()
    jst, jkeys, jpm, _ = jcp.cpic_packed_pack_carry(sim.particles, sim.cfg, K, two_d=True)
    tp, tb, ts, tcfg = port_inputs(sim)
    tst = convert.packed_from_numpy(np.asarray(jst))
    tpm = tpacked.build_page_map_packed(torch.as_tensor(np.array(jkeys)), tcfg, K)
    return dict(sim=sim, jst=jst, jpm=jpm, tb=tb, ts=ts, tcfg=tcfg, tst=tst, tpm=tpm)


@pytest.fixture(scope="module")
def prologues(scene):
    """Both packages' prologues, in each CDF mode."""
    sim, cfg = scene["sim"], scene["sim"].cfg
    out = {}
    for mode in MODES:
        Kr = 0 if mode == "dense" else 128
        jrm = trm = None
        if mode == "lazy":
            xb, _, _ = jbpw(sim.bodies, *(getattr(sim.rigid_scene, n) for n in
                                          ("bp_rid", "bp_offset", "bp_normal", "bp_elem")))
            jrm = jcdf.rigid_page_map_checked(xb, cfg, Kr, dilate=4, chk_dilate=1)
            trm = tcp._lazy_rmap(scene["tb"], scene["ts"], scene["tcfg"],
                                 tcp.Capacities(Kr))
        jout = jcb.rigid_prologue(sim.bodies, sim.rigid_scene, cfg, cfg, cfg.base_dt, Kr,
                                  rmap=jrm)
        tout = tcb.rigid_prologue(scene["tb"], scene["ts"], scene["tcfg"], cfg.base_dt,
                                  tcp.Capacities(Kr), rmap=trm)
        out[mode] = (jout, tout, jrm is not None)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_prologue_matches_jax(prologues, mode):
    (jb, jn, jnr, jxb), (tb, tn, tnr, txb), _ = prologues[mode]
    for name in ("pos", "vel", "rot", "omega"):
        assert max_err(getattr(jb, name), getattr(tb, name)) <= 1e-6 * _scale(getattr(jb, name))
    assert max_err(jxb, txb) <= 1e-6
    assert int(jnr) == int(tnr)
    assert np.array_equal(np.asarray(jn.states), np_of(tn.states))
    assert np.array_equal(np.asarray(jn.rid), np_of(tn.rid))
    assert max_err(jn.dist, tn.dist) <= 1e-6
    # the packed lookup plane: equal tags and ids, the quantized distance
    # (2^-20 grid units) within one step
    jpk, tpk = np.asarray(jn.pk).astype(np.int64), np_of(tn.pk).astype(np.int64)
    assert np.array_equal(jpk & 0xFF, tpk & 0xFF)
    assert np.abs((jpk >> 8) - (tpk >> 8)).max() <= 1
    assert int((np_of(tn.states) != 0).sum()) > 0
    if mode != "dense":
        assert np.array_equal(np.asarray(jn.rids), np_of(tn.rids))
        assert np.array_equal(np.asarray(jn.rslot_map), np_of(tn.rslot_map))
    assert np.array_equal(np.asarray(jn.tagged_blocks()), np_of(tn.tagged_blocks()))
    # the fast stage-2 test: one lookup at each stencil centre of the
    # boundary particles' neighbourhood (one node out of the grid)
    centers = np.floor(np.asarray(jxb) * 16 + 0.5).astype(np.int32)  # dx = 1/16
    centers = np.concatenate([centers, centers + 1, centers - 2, [[-1, 3, 3]]])
    assert np.array_equal(np.asarray(jn.stencil_tagged(jnp.asarray(centers))),
                          np_of(tn.stencil_tagged(torch.as_tensor(centers).long())))


@pytest.fixture(scope="module")
def compacted(scene, prologues):
    cfg = scene["sim"].cfg
    out = {}
    for mode in MODES:
        (_, jn, _, _), (_, tn, _, _), fast = prologues[mode]
        jidx, jvalid, jn_exact, jn_coarse = jcp.compact_near_rigid_packed(
            scene["jst"], scene["jpm"], jn, cfg, NEAR, B1, fast_stage2=fast)
        tidx, tn_near, tn_coarse = tcp.compact_near_rigid_packed(
            scene["tst"], scene["tpm"], tn, scene["tcfg"], fast_stage2=fast)
        out[mode] = (np.asarray(jidx), np.asarray(jvalid), int(jn_exact), int(jn_coarse),
                     tidx, tn_near, tn_coarse)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_compaction_matches_jax(compacted, mode):
    jidx, jvalid, jn_exact, jn_coarse, tidx, tn_near, tn_coarse = compacted[mode]
    assert (jn_exact, jn_coarse) == (tn_near, tn_coarse)
    assert 0 < jn_exact < jn_coarse
    assert np.array_equal(jidx[jvalid], np_of(tidx))


@pytest.mark.parametrize("mode", MODES)
def test_jax_scatters_equal_masked_writes(compacted, mode):
    """JAX writes the near set's rows with .at[idx].set over all budget
    lanes, the invalid ones carrying zeros or old values; a repeated
    index would let an invalid lane overwrite a valid one. On these
    scenes no invalid lane repeats a valid lane, so writing the valid
    lanes alone, as the port does, gives the same rows."""
    jidx, jvalid = compacted[mode][:2]
    assert not set(jidx[~jvalid].tolist()) & set(jidx[jvalid].tolist())
    assert len(set(jidx[jvalid].tolist())) == int(jvalid.sum())


@pytest.fixture(scope="module")
def gathered(scene, prologues, compacted):
    """The CDF gather on the lazy map's near set, and the state with the
    affinity rows written (numpy), the input of both corrections."""
    cfg = scene["sim"].cfg
    (jb, jn, _, _), (tb, tn, _, _), _ = prologues["lazy"]
    jidx, jvalid = compacted["lazy"][:2]
    tidx = compacted["lazy"][4]
    jst = np.asarray(scene["jst"])
    R = jb.pos.shape[0]
    x_c = jnp.asarray(jst[RX:RX + 3, jidx].T)
    jnd = jcdf.stencil_node_data(x_c, jn, cfg)

    def sd(nidx, inb):
        s, _, dist = jn.lookup(nidx, inb)
        return s, dist

    jg = jcdf.gather_cdf_lookup(x_c, jnp.asarray(jst[RSTATES, jidx].view(np.int32)), sd, R, cfg,
                                node_data=jnd)
    mini = scene["tst"][:, tidx]
    tnd = tcdf.stencil_node_data(mini[RX:RX + 3].t(), tn, scene["tcfg"])
    tg = tcdf.gather_cdf_lookup(mini[RX:RX + 3].t(), mini[RSTATES].view(torch.int32), R,
                                scene["tcfg"], tnd)
    st_aff = jst.copy()
    st_aff[RSTATES:RNEARB + 1] = 0.0
    v = jvalid
    st_aff[RSTATES, jidx[v]] = np.asarray(jg[0])[v].view(np.float32)
    st_aff[RSTATES + 1, jidx[v]] = np.asarray(jg[1])[v]
    st_aff[RBN:RBN + 3, jidx[v]] = np.asarray(jg[2])[v].T
    st_aff[RNEARB, jidx[v]] = np.asarray(jg[3])[v]
    return dict(jb=jb, jn=jn, tb=tb, jidx=jidx, jvalid=jvalid, tidx=tidx, jnd=jnd, tnd=tnd,
                jg=jg, tg=tg, st_aff=st_aff)


def test_cdf_gather_matches_jax(gathered):
    g = gathered
    v = g["jvalid"]
    offs = sorted(g["jnd"])
    for k, name in enumerate(("nidx", "inb", "s", "nrid", "dist", "wo", "gradw", "dpos")):
        ja = np.stack([np.asarray(g["jnd"][o][k]) for o in offs])[:, v]
        if name in ("nidx", "inb", "s", "nrid"):
            assert np.array_equal(ja, np_of(g["tnd"][name])), name
        else:
            assert max_err(ja, g["tnd"][name]) <= 1e-6 * _scale(ja), name
    (js, jbd, jbn, jnb), (ts, tbd, tbn, tnb) = g["jg"], g["tg"]
    assert np.array_equal(np.asarray(js)[v], np_of(ts))
    assert np.array_equal(np.asarray(jnb)[v], np_of(tnb))
    assert int(np_of(tnb).sum()) > 0
    assert max_err(np.asarray(jbd)[v], tbd) <= 1e-6
    assert max_err(np.asarray(jbn)[v], tbn) <= 1e-5


def test_corrections_match_jax(scene, gathered):
    g = gathered
    sim, cfg = scene["sim"], scene["sim"].cfg
    dt = cfg.base_dt
    rng = np.random.default_rng(9)
    rec = (rng.normal(size=(K, 256)) * 1e-3).astype(np.float32)
    vrec = rng.normal(size=(K, 192)).astype(np.float32)
    pw = g["st_aff"].shape[1]
    B = len(g["jidx"])
    jmini = jcp.gather_mini(jnp.asarray(g["st_aff"]), jnp.asarray(g["jidx"]), pw)
    aidx = jnp.arange(B, dtype=jnp.int32)
    valid = jnp.asarray(g["jvalid"])
    tst = convert.packed_from_numpy(g["st_aff"])
    tmini = tst[:, g["tidx"]]

    jrec, jJ, jtau = jcb.p2g_correction(jmini, aidx, valid, scene["jpm"], g["jn"], g["jb"],
                                        jnp.asarray(rec), cfg, dt, node_data=g["jnd"])
    trec, tJ, ttau = tcb.p2g_correction(tmini, g["tnd"], scene["tpm"], g["tb"],
                                        torch.as_tensor(rec), scene["tcfg"], dt)
    assert max_err(jrec, trec) <= 1e-6 * _scale(jrec)
    assert max_err(rec, trec) > 0  # the correction acted
    for a, b in ((jJ, tJ), (jtau, ttau)):
        assert max_err(a, b) <= 1e-5 * max(1e-6, float(np.abs(np.asarray(a)).max()))

    jdv, jdB, jrid = jcb.g2p_correction(jmini, aidx, valid, scene["jpm"], g["jn"], g["jb"],
                                        jnp.asarray(vrec), cfg, dt, node_data=g["jnd"])
    tdv, tdB, trid = tcb.g2p_correction(tmini, g["tnd"], scene["tpm"], g["tb"],
                                        torch.as_tensor(vrec), scene["tcfg"], dt)
    v = g["jvalid"]
    assert max_err(np.asarray(jdv)[v], tdv) <= 1e-5 * _scale(jdv)
    assert max_err(np.asarray(jdB)[v], tdB) <= 1e-5 * _scale(jdB)
    assert np.array_equal(np.asarray(jrid)[v], np_of(trid))
    assert int((np_of(trid) >= 0).sum()) > 0


def test_g2p_blocked_plain_matches_jax(scene):
    """The gather-only G2P: the port's plain version reads x and the
    origin rows itself; JAX's kernel gets the block-local positions as the
    JAX CPIC frame builds them (x * inv_dx - origin)."""
    cfg = scene["sim"].cfg
    rng = np.random.default_rng(10)
    vrec = rng.normal(size=(K, 192)).astype(np.float32)
    jst = scene["jst"]
    pos = [jst[RX + a] * cfg.inv_dx - jst[RORG + a] for a in range(3)]
    posg = jnp.stack(pos + [jnp.zeros_like(pos[0])] * 5, 0)
    jpm = scene["jpm"]
    jout = np.asarray(jax_g2p_blocked(jpm["slot_keys"][None, :], posg,
                                      jblocked.windows_mm(jnp.asarray(vrec), jpm["nbr"]),
                                      jnp.asarray([K], jnp.int32), interpret=True))
    win = tblocked.windows(torch.as_tensor(vrec), scene["tpm"]["nbr"])
    tout = tg2p.g2p_blocked(scene["tpm"]["slot_keys"], scene["tst"], win, scene["tcfg"])
    assert tout.shape == (12, jst.shape[1])
    assert not np.any(jout[12:])
    scale = float(np.abs(jout[:3]).max())
    assert max_err(jout[:12], tout) <= 1e-5 * scale
    assert int((np_of(tout[0]) != 0).sum()) > 0


def test_prologue_coupling_iterations_matches_jax(scene):
    """coupling_iterations = 2 (tests/test_cpic.py:447 holds it between
    JAX's blocked and oracle substeps): the prologue runs {rigidify,
    articulate, rasterize} twice, with the record CDF, on the hub/wheel
    pair turning at -3 and 5 rad/s, so that the articulation has work to
    do, and matches JAX's at the bounds of test_prologue_matches_jax."""
    sim = scene["sim"]
    spin = np.zeros((3, 3), np.float32)
    spin[1, 2], spin[2, 2] = -3.0, 5.0
    jb0 = dataclasses.replace(sim.bodies, omega=sim.bodies.omega + jnp.asarray(spin))
    tb0 = scene["tb"].replace(omega=scene["tb"].omega + torch.as_tensor(spin))
    cfg2 = dataclasses.replace(sim.cfg, coupling_iterations=2)
    tcfg2 = dataclasses.replace(scene["tcfg"], coupling_iterations=2)
    jb, jn, jnr, jxb = jcb.rigid_prologue(jb0, sim.rigid_scene, cfg2, cfg2, cfg2.base_dt, 128)
    tb, tn, tnr, txb = tcb.rigid_prologue(tb0, scene["ts"], tcfg2, cfg2.base_dt,
                                          tcp.Capacities(128))
    for name in ("pos", "vel", "rot", "omega"):
        assert max_err(getattr(jb, name), getattr(tb, name)) <= 1e-6 * _scale(getattr(jb, name))
    assert max_err(jxb, txb) <= 1e-6 and int(jnr) == int(tnr)
    assert np.array_equal(np.asarray(jn.states), np_of(tn.states))
    assert np.array_equal(np.asarray(jn.rid), np_of(tn.rid))
    assert max_err(jn.dist, tn.dist) <= 1e-6
    assert max_err(tb0.omega, tb.omega) > 1.0  # the articulation acted


def test_prologue_rebuilds_stale_map():
    """The lazy rigid map checked at use (the port's counterpart of
    tests/test_cdf_fast.py:229): a map cached from the bodies moved 0.4 in
    x, whose dilate-4 blocks and check plane miss the boundary particles'
    blocks, is rebuilt inside the prologue, and the CDF equals the fresh
    build's in bits, where rasterizing into the stale map's records loses
    every write. A res-64 scene with a small plate, built by the port's
    MPM (at low res the dilation covers the whole grid and no map goes
    stale); the fresh build is held to JAX's by test_prologue_matches_jax."""
    from taichi_mpm_torch import MPM
    from taichi_mpm_torch.rigid.mesh import plate_mesh

    rng = np.random.default_rng(11)
    sim = MPM(res=(64, 64, 64), base_delta_t=2e-4, gravity=(0, -10.0, 0), device="cpu")
    sim.add_particles("jelly", pos=rng.uniform(0.4, 0.6, size=(32, 3)).astype(np.float32),
                      E=1e4, nu=0.3, density=1000)
    sim.add_particles("rigid", mesh=plate_mesh(half_u=0.05, half_v=0.05, axis=1),
                      scripted_position=lambda t: (0.5, 0.45, 0.5),
                      scripted_rotation=lambda t: (0.0, 0.0, 0.0), codimensional=True,
                      friction=0.2)
    sim._finalize()
    tb, ts, tcfg = sim.bodies, sim.rigid_scene, sim.cfg
    Kr = tblocked.total_blocks_padded(tcfg)
    _, fresh, _, txb = tcb.rigid_prologue(tb, ts, tcfg, tcfg.base_dt, tcp.Capacities(Kr))

    far = tb.replace(pos=tb.pos + torch.tensor([0.4, 0.0, 0.0]))
    stale = tcp._lazy_rmap(far, ts, tcfg, tcp.Capacities(Kr))
    assert not bool(torch.all(stale[3][tcdf.block_id_of(txb, tcfg)]))
    _, gated, _, _ = tcb.rigid_prologue(tb, ts, tcfg, tcfg.base_dt, tcp.Capacities(Kr),
                                        rmap=stale)

    # every node within 13 of the plate's (node 32, 29, 32 +- 3)
    ii = torch.as_tensor(np.stack(np.meshgrid(*[np.arange(c - 13, c + 14) for c in (32, 29, 32)],
                                              indexing="ij"), -1).reshape(-1, 3))
    inb = torch.ones((ii.shape[0],), dtype=torch.bool)
    ref, got = fresh.lookup(ii, inb), gated.lookup(ii, inb)
    assert int((ref[0] != 0).sum()) == int((fresh.states != 0).sum()) > 0
    for a, b in zip(got, ref):  # states, rid, dist
        assert torch.equal(a, b)
    xb, _, elem = boundary_particle_world(tb, ts.bp_rid, ts.bp_offset, ts.bp_normal, ts.bp_elem)
    lost = tcdf.rasterize_rigid_boundary_records(xb, elem, ts.bp_rid, tb.num, tcfg, stale[1], Kr)
    assert int((lost[2] != 0).sum()) == 0
