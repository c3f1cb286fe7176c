"""Port vs JAX: the pieces of per-block bucketed async
(``ops/async_bucketed``), and the bucketed frame's exactness.

On tests/test_async_bucketed.py's SOFT/STIFF blobs: the levels before
and after the monotonicity sweeps and every level's context lanes equal
JAX's exactly (JAX compiled as its frame compiles them: jitted, the unit
a constant). One bucket advance at a level whose context reaches slower
neighbours, from a backup that differs from the state, against JAX's
``bucket_substep``: the same lanes commit (the others and their backup
untouched), the committed lanes' backup is their pre-advance state,
their new state within the frame bounds of tests/test_fused.py.

Single-level frames (every slot at one level through ``lev_fn``, a high
unit so a frame is a few advances) equal the port's own packed frame at
dt = unit * 2^L in bits, with a mid-frame re-sort on the fast blob, on
both routes; the update count is active x steps.

Capacities: the JAX frame routes a bucket's unused lanes to lane pw - 1
and scatters with duplicate indices there, so when the capacity is a
multiple of 512 with every lane active, the commit of the last sorted
particle is dropped (``test_jax_drops_the_last_lanes_commit``, ROADMAP.md
queue 3). The parity tests therefore give JAX a capacity with a pad lane
(2,001 lanes), where its frame is the port's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taichi_mpm_tpu.ops import async_bucketed as jab
from taichi_mpm_tpu.ops import packed as jpacked
from taichi_mpm_torch import convert
from taichi_mpm_torch.ops import async_bucketed as tab
from taichi_mpm_torch.ops import packed as tpacked

from port_helpers import SOFT, STIFF, blob_arrays, jax_particles, max_err, np_of

torch.set_num_threads(1)

UNIT = 5e-4  # tests/test_async_bucketed.py's: a frame is 64 units
FRAME = UNIT * (1 << jab.MAXLEV)
K = 512


def _jax_ctx(lev, pm, L, jcfg):
    """The context of bucket_substep (ops/async_bucketed.py:186-200)."""
    Kj = pm["ids"].shape[0]
    in_bucket = lev == L
    ctx = in_bucket
    for ox in range(3):
        for oy in range(3):
            for oz in range(3):
                if (ox, oy, oz) == (1, 1, 1):
                    continue
                n = jab.nbr_at(pm["nbr"], ox, oy, oz)
                ctx = ctx | jnp.where(n < Kj, in_bucket[jnp.minimum(n, Kj - 1)], False)
    return ctx & (pm["ids"] < jab.blocked.total_blocks_padded(jcfg))


@pytest.fixture(scope="module")
def blobs():
    a, (jcfg, tcfg) = blob_arrays([SOFT, STIFF])
    return a, jcfg, tcfg


@pytest.fixture(scope="module")
def jax_levels(blobs):
    """JAX's sort, levels and each level's context ranges, one compile."""
    a, jcfg, _ = blobs

    @jax.jit
    def run(p):
        st, keys, pm = jpacked.sort_and_map(jpacked.pack_particles(p), jcfg, K)
        base = jab.slot_level_base(st, keys, pm, jcfg, UNIT)
        one = jab.monotonic_sweep(base, pm)
        lev = jab.slot_levels(st, keys, pm, jcfg, UNIT)
        ranges = [jab._bucket_ranges(pm, _jax_ctx(lev, pm, L, jcfg), 4096,
                                     jpacked.state_width(st))
                  for L in range(jab.MAXLEV + 1)]
        return base, one, lev, ranges, pm["slot_keys"]

    return jax.tree_util.tree_map(lambda x: np.array(x), run(jax_particles(a)))


@pytest.fixture(scope="module")
def port_sorted(blobs):
    a, _, tcfg = blobs
    return tpacked.sort_and_map(tpacked.pack_particles(convert.particles_from_numpy(a)),
                                tcfg, K)


def test_levels_match_jax(blobs, jax_levels, port_sorted):
    _, _, tcfg = blobs
    base, one, lev, _, _ = jax_levels
    st, _, pm = port_sorted
    tbase = tab.slot_level_base(st, pm, tcfg, UNIT)
    assert tbase.dtype == torch.int32
    assert np.array_equal(np_of(tbase), base)
    assert np.array_equal(np_of(tab.monotonic_sweep(tbase, pm)), one)
    tlev = np_of(tab.slot_levels(st, pm, tcfg, UNIT))
    assert np.array_equal(tlev, lev)
    occupied = np_of(pm["e_arr"] > pm["s_arr"])
    assert tlev[occupied].min() < tlev[occupied].max()  # heterogeneous
    assert not np.array_equal(base, lev)  # the sweeps changed levels


@pytest.mark.parametrize("L", range(7))
def test_bucket_ranges_match_jax(blobs, jax_levels, port_sorted, L):
    _, _, tcfg = blobs
    _, _, lev, ranges, _ = jax_levels
    idx_j, valid_j, n_j = ranges[L]
    st, _, pm = port_sorted
    _, ctx = tab.context_slots(torch.as_tensor(lev), pm, L, tcfg)
    idx, n_sel = tab.bucket_ranges(pm, ctx)
    assert n_sel == int(n_j)
    assert np.array_equal(valid_j, np.arange(valid_j.shape[0]) < n_sel)
    assert np.array_equal(np_of(idx), idx_j[:n_sel])


def test_bucket_substep_matches_jax(blobs, jax_levels, port_sorted):
    """Level 3: its context holds slower (level 4-6) neighbours. The
    backup is the state with v changed, so context lanes read from the
    backup are told apart; JAX op by op (its unfused substep)."""
    a, jcfg, tcfg = blobs
    _, _, lev, _, _ = jax_levels
    L = 3
    assert (lev == L).any() and (lev > L).any()
    dt = UNIT * (1 << L)
    st, keys, pm = port_sorted
    bk = st.clone()
    bk[3:6] += torch.from_numpy(np.random.default_rng(4).normal(0, 0.2, (3, st.shape[1])).astype(
        np.float32))
    st0, bk0 = st.clone(), bk.clone()

    jst, jkeys, jpm = jax.jit(lambda p: jpacked.sort_and_map(jpacked.pack_particles(p), jcfg,
                                                             K))(jax_particles(a))
    pw_j = jpacked.state_width(jst)
    cap = st.shape[1]
    jbk = jnp.concatenate([np_of(bk), np.zeros((bk.shape[0], pw_j - cap), np.float32)], 1)
    jst2, jbk2, n_sel, _, n_up, vmax = jab.bucket_substep(
        jst, jbk.reshape(-1) if jst.ndim == 1 else jbk, jkeys, jpm, jnp.asarray(lev), L,
        jnp.float32(0.0), jcfg, (), dt, 4096, 768, interpret=True, fused=False)
    jst2 = np.asarray(jst2).reshape(st.shape[0], -1)[:, :cap]
    jbk2 = np.asarray(jbk2).reshape(st.shape[0], -1)[:, :cap]

    tst, tbk, tn_sel, _, tn_up, tvmax = tab.bucket_substep(
        st.clone(), bk.clone(), keys, pm, torch.as_tensor(lev), L, np.float32(0.0), tcfg, (), dt,
        fused=False)
    assert tn_sel == int(n_sel) and int(tn_up) == int(n_up) > 0
    assert abs(float(tvmax) - float(vmax)) <= 5e-5
    changed = np_of((tst != st0).any(0))
    assert np.array_equal(changed, (jst2 != np_of(st0)).any(0))
    assert changed.sum() > 0
    assert np.array_equal(np_of(tbk), jbk2)  # committed lanes: the pre-advance state
    assert not np.array_equal(np_of(tbk), np_of(bk0))
    for name, rows, bound in (("x", slice(0, 3), 5e-6), ("v", slice(3, 6), 5e-5),
                              ("F", slice(6, 15), 5e-6), ("C", slice(15, 24), 5e-4)):
        assert max_err(np_of(tst)[rows], jst2[rows]) <= bound, name


def _level_fn(L):
    return lambda pm: torch.full_like(pm["ids"], L)


def _sorted_x(p):
    x = np_of(p.x)[np_of(p.active)]
    return x[np.lexsort(x.T)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("fast", [False, True], ids=["slow", "resorts"])
def test_single_level_frame_is_the_packed_frame(fused, fast):
    """Every slot at level 4: four advances of 8 units = the packed frame
    at dt = 8 units, bit for bit; the fast blob (1 m/s along x) drifts
    past 0.45 cell mid-frame, and both frames re-sort there."""
    a, (_, tcfg) = blob_arrays([SOFT], v=(1.0, 0.0, 0.0) if fast else None)
    L = 4
    p = convert.particles_from_numpy(a)
    p2, t, n_up, stats = tab.bucketed_frame(p, np.float32(0.0), tcfg, (), FRAME, UNIT, K,
                                            lev_fn=_level_fn(L), fused=fused)
    n_steps = (1 << tab.MAXLEV) >> L
    ref, t_ref, _, n_sorts, _ = tpacked.packed_frame(convert.particles_from_numpy(a),
                                                     np.float32(0.0), tcfg, (), UNIT * (1 << L),
                                                     n_steps, K, fused=fused)
    assert stats.advances == [0] * L + [n_steps] + [0] * (tab.MAXLEV - L)
    assert n_up == int(a["active"].sum()) * n_steps
    assert np.array_equal(_sorted_x(p2), _sorted_x(ref))
    assert t == t_ref
    if fast:
        assert stats.n_resorts >= 1
        # packed_frame counts its first sort and the one after its last substep
        assert n_sorts >= stats.n_resorts + 1
    else:
        assert stats.n_resorts == 0


def test_jax_drops_the_last_lanes_commit(blobs):
    """A capacity of 512 with every lane active: JAX's context ranges
    route their unused lanes to lane pw - 1 = 511, a real particle, and
    its commit scatter then writes lane 511 with duplicate indices whose
    no-op writes come after the commit: XLA keeps the last, so the lane
    keeps its old value. The port's commit writes the committed lanes
    only."""
    nch = 48
    pw = 512
    rng = np.random.default_rng(0)
    st = rng.standard_normal((nch, pw)).astype(np.float32)
    mini_new = rng.standard_normal((nch, 4)).astype(np.float32)
    idx = jnp.asarray([509, 510, 511, 511], jnp.int32)  # 3 valid lanes, 1 unused
    commit = jnp.asarray([True, True, True, False])
    out = np.asarray(jax.jit(jab._scatter_rows, static_argnums=1)(
        jnp.asarray(st).reshape(-1), nch, idx, jnp.asarray(mini_new).reshape(-1), commit))
    out = out.reshape(nch, pw)
    assert np.array_equal(out[:, 509:511], mini_new[:, :2])
    assert np.array_equal(out[:, 511], st[:, 511])  # the commit of lane 511 is lost
    # and _bucket_ranges does route the unused lanes there
    pm = dict(ids=jnp.asarray([0, 1], jnp.int32), s_arr=jnp.asarray([0, 3], jnp.int32),
              e_arr=jnp.asarray([3, 512], jnp.int32))
    ridx, valid, n_sel = jab._bucket_ranges(pm, jnp.asarray([False, True]), 512, pw)
    assert int(n_sel) == 509 and np.all(np.asarray(ridx)[509:] == pw - 1)
    assert np.asarray(ridx)[508] == 511 and np.asarray(valid)[508]
