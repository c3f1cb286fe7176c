"""The slab primitives of ``taichi_mpm_torch.parallel`` against the JAX
package's, on the same numpy inputs: the port's on two gloo ranks on
the CPU (one spawned group for the file, ``slab_ranks.primitives``),
JAX's under ``shard_map`` on 2 of the 8 virtual CPU devices (no Pallas).

Integers (keys, page maps, bounds, histograms, migrated lanes) must
match exactly; so must the migrated particles, which are copies; the
exchanged records match to 1e-6 x max|record|."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from port_helpers import configs, jax_particles, scene_arrays
from slab_ranks import PM_INTS, primitives
from taichi_mpm_torch import convert
from taichi_mpm_torch.parallel import comm
from taichi_mpm_torch.parallel import spatial as tsp
from taichi_mpm_torch.parallel import spatial_blocked as tsb
from taichi_mpm_tpu.ops.blocked import sort_particles_by_keys
from taichi_mpm_tpu.ops.substep import build_page_map_full
from taichi_mpm_tpu.parallel import spatial as jsp
from taichi_mpm_tpu.parallel import spatial_blocked as jsb

torch.set_num_threads(1)

CAP = 700  # lanes per slab in the global layouts, the last 100 free
GROW_MOVERS = 150  # slab 0's movers: more than slab 1's 100 free lanes
K = 768  # page-map capacity of the exchange cases (every block of res 32 fits)
BOUNDS = np.asarray([0, 3, 8], np.int32)  # balanced bounds at res 32 (uniform 4, r 1)
REC_TOL = 1e-6
JCFG, TCFG = configs(("jelly",))
MESH = Mesh(np.asarray(jax.devices()[:2]), ("x",))
PSPEC = jax.tree.map(lambda _: P("x"), jsp._particles_struct())


def _global(seed, movers, split=0.5):
    """A global layout of two slabs of CAP lanes at res 32: slab 0's
    particles left of x = `split`, slab 1's right of it, `movers` of each
    (or (slab 0's, slab 1's)) placed on the other side (they migrate), the
    last 100 lanes of each slab free."""
    movers = (movers, movers) if np.isscalar(movers) else movers
    a, _ = scene_arrays(2 * CAP, seed=seed, lo=0.1, hi=0.9, cap_extra=0)
    rng = np.random.default_rng(seed)
    sides = ((0.01, split - 0.01), (split + 0.01, 0.99))
    for s in range(2):
        lanes = np.arange(s * CAP, (s + 1) * CAP)
        a["x"][lanes, 0] = rng.uniform(*sides[s], CAP)
        a["x"][lanes[:movers[s]], 0] = rng.uniform(*sides[1 - s], movers[s])
        a["active"][lanes[-100:]] = False
    return a


def _jax_migrate(arrays, bounds):
    def local(p):
        s = jax.lax.axis_index("x")
        dest = None if bounds is None else jsb._dest_from_bounds(p, jnp.asarray(bounds), JCFG, 2)
        merged, _ = jsp.migrate(p, s, "x", JCFG, 2, CAP, count_only_overflow=False, dest=dest)
        return merged

    fn = jax.jit(shard_map(local, mesh=MESH, in_specs=(PSPEC,), out_specs=PSPEC,
                           check_vma=False))
    return convert.particles_to_numpy(fn(jax_particles(arrays)))


def _jax_exchange(arrays, rec, bounds):
    """Per slab: local keys, sort, page map, the record exchange and the
    ghost zeroing (and, balanced, the summed column histogram)."""
    if bounds is None:
        lcfg = jsb.local_config(JCFG, 2)
    else:
        CB, _, lcfg = jsb.balanced_params(JCFG, 2, 1)
    jb = jnp.asarray(bounds if bounds is not None else np.zeros(3, np.int32))

    def local(p, rec):
        s = jax.lax.axis_index("x")
        if bounds is None:
            keys = jsb._local_keys(p, s, JCFG, lcfg, 2)
            Wb = jsb.slab_cells(JCFG, 2) // 4
        else:
            off = ((jb[s] - 1) * 4).astype(jnp.float32) * JCFG.dx
            x_loc = p.x - jnp.stack([off, jnp.zeros_like(off), jnp.zeros_like(off)], -1)
            keys = jnp.where(p.active, jsb.blocked.block_id_of(x_loc, lcfg),
                             jsb.blocked.total_blocks_padded(lcfg))
            Wb = jb[s + 1] - jb[s]
        p, keys, _ = sort_particles_by_keys(p, keys)
        pm = build_page_map_full(keys, lcfg, K)
        rec = jsb.exchange_boundary_records(rec, pm, lcfg, "x", 2, Wb)
        rec = jsb.zero_domain_edge_ghosts(rec, pm, lcfg, s, 2)
        out = {k: pm[k][None] for k in PM_INTS}
        out.update(keys=keys[None], rec=rec[None])
        if bounds is not None:
            out["hist"] = jsb.col_hist_from_pm(pm, jb[s], lcfg, CB, "x")[None]
        return out

    fn = jax.jit(shard_map(local, mesh=MESH, in_specs=(PSPEC, P("x")), out_specs=P("x"),
                           check_vma=False))
    return {k: np.asarray(v) for k, v in fn(jax_particles(arrays), jnp.asarray(rec)).items()}


CASES = {
    "migrate_grow": ("migrate", 5, None),  # more arrivals than free lanes: no JAX run
    "migrate_uniform": ("migrate", 0, None),
    "migrate_bounds": ("migrate", 1, BOUNDS),
    "exchange_uniform": ("exchange", 2, None),
    "exchange_balanced": ("exchange", 3, BOUNDS),
}


@pytest.fixture(scope="module")
def both():
    """Each case's inputs, and the port's and JAX's results."""
    inputs, jax_out, port_cases = {}, {}, []
    for name, (kind, seed, bounds) in CASES.items():
        split = 0.5 if bounds is None else 0.375  # the slab boundary
        if name == "migrate_grow":
            arrays = _global(seed, movers=(GROW_MOVERS, 0))
            port_cases.append(("migrate", arrays, CAP, TCFG, bounds))
        elif kind == "migrate":
            arrays = _global(seed, movers=40, split=split)
            port_cases.append(("migrate", arrays, CAP, TCFG, bounds))
            jax_out[name] = _jax_migrate(arrays, bounds)
        else:
            arrays = _global(seed, movers=0, split=split)
            rec = np.random.default_rng(seed).standard_normal((2 * K, 256)).astype(np.float32)
            port_cases.append(("exchange", arrays, CAP, TCFG, K, bounds, rec))
            jax_out[name] = _jax_exchange(arrays, rec, bounds)
        inputs[name] = arrays
    port = comm.run_ranks(primitives, 2, "gloo", args=(port_cases,), timeout_s=120)
    return inputs, jax_out, {name: [port[r][i] for r in range(2)]
                             for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", ["migrate_uniform", "migrate_bounds"])
def test_migrate_matches_jax(both, name):
    _, jout, tout = both
    sent = np.asarray([r["sent"] for r in tout[name]])
    assert sent[0, 1] > 0 and sent[1, 0] > 0 and sent[0, 0] == sent[1, 1] == 0  # both ways
    assert all(r["grown"] == 0 for r in tout[name])
    for f, a in jout[name].items():
        b = np.concatenate([r[f] for r in tout[name]])
        assert np.array_equal(a, b), f


def test_migrate_grows_where_arrivals_exceed_free_lanes(both):
    """Where the JAX package drops arrivals beyond its budget, the port
    adds lanes (a multiple of 64): every particle lands on its owner and
    none is lost."""
    inputs, _, tout = both
    a = inputs["migrate_grow"]
    (r0, r1) = tout["migrate_grow"]
    assert r0["sent"] == (0, GROW_MOVERS) and r1["sent"] == (0, 0)
    assert r1["arrived"] == GROW_MOVERS and r1["grown"] == 64 and r0["grown"] == 0
    assert r0["x"].shape[0] == CAP and r1["x"].shape[0] == CAP + 64
    assert r0["active"].sum() == CAP - 100 - GROW_MOVERS
    assert r1["active"].sum() == CAP - 100 + GROW_MOVERS
    for r, out in enumerate((r0, r1)):
        assert np.all((out["x"][out["active"], 0] >= 0.5) == bool(r))  # each on its owner
    sent = np.concatenate([a["x"][a["active"]]])
    got = np.concatenate([out["x"][out["active"]] for out in tout["migrate_grow"]])
    assert np.array_equal(np.unique(sent, axis=0), np.unique(got, axis=0))


@pytest.mark.parametrize("name", ["exchange_uniform", "exchange_balanced"])
def test_local_page_map_and_exchange_match_jax(both, name):
    _, jout, tout = both
    for r in range(2):
        for k in PM_INTS + ("keys",):
            assert np.array_equal(np.asarray(jout[name][k][r]).reshape(-1),
                                  np.asarray(tout[name][r][k]).reshape(-1)), (k, r)
        a, b = jout[name]["rec"][r], tout[name][r]["rec"]
        assert np.abs(a - b).max() <= REC_TOL * np.abs(a).max()
    # the exchange met a live boundary column on both sides
    n_act = np.asarray(jout[name]["n_act"])
    assert 0 < n_act.min() and n_act.max() <= K


def test_col_hist_matches_jax(both):
    inputs, jout, tout = both
    hist = jout["exchange_balanced"]["hist"]
    assert np.array_equal(hist[0], hist[1])
    for r in range(2):
        assert np.array_equal(hist[r], tout["exchange_balanced"][r]["hist"])
    assert hist[0].sum() == inputs["exchange_balanced"]["active"].sum()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rebalance_bounds_matches_jax(seed):
    rng = np.random.default_rng(seed)
    S, CB = 4, 32
    uniform = np.round(np.linspace(0, CB, S + 1)).astype(np.int32)
    hist = (rng.integers(0, 50, CB) * (seed != 3)).astype(np.int32)  # seed 3: empty
    hist[: CB // 4] *= 20  # crowded on the left: the ideal bounds move left
    bounds = uniform + np.asarray([0] + list(rng.integers(-1, 2, S - 1)) + [0], np.int32)
    r = 3
    j = jsb.rebalance_bounds(jnp.asarray(hist), jnp.asarray(bounds), jnp.asarray(uniform), r, S)
    t = tsb.rebalance_bounds(hist, bounds, uniform, r, S)
    assert np.array_equal(np.asarray(j), t)


def test_configs_and_host_splits_match_jax():
    assert dataclasses.asdict(jsb.local_config(JCFG, 2)) == dataclasses.asdict(
        tsb.local_config(TCFG, 2))
    for S, res in ((2, 32), (4, 64), (3, 48)):
        jcfg, tcfg = configs(("jelly",), res=(res, 32, 32))
        jCB, ju, jl = jsb.balanced_params(jcfg, S, 1)
        tCB, tu, tl = tsb.balanced_params(tcfg, S, 1)
        assert jCB == tCB and np.array_equal(ju, tu)
        assert dataclasses.asdict(jl) == dataclasses.asdict(tl)
    with pytest.raises(ValueError):
        tsb.balanced_params(TCFG, 2, 2)  # r_max is 1 at res 32

    a = _global(4, movers=0)
    a["x"][:, 0] = np.random.default_rng(4).uniform(0.05, 0.3, a["x"].shape[0])  # crowded left
    tp = convert.particles_from_numpy(a)
    jb = jsb.balanced_bounds_host(jax.tree.map(np.asarray, jax_particles(a)), JCFG, 2, 1)
    tb = tsb.balanced_bounds_host(tp, TCFG, 2, 1)
    assert np.array_equal(jb, tb) and tb[1] == 3  # moved left by r
    for bounds in (None, tb):
        if bounds is None:
            jg = jsp.shard_spatially(jax_particles(a), JCFG, MESH, slack=1.5)
        else:
            jg = jsb.shard_spatially_bounds(jax_particles(a), JCFG, MESH, bounds, slack=1.5)
        jg = convert.particles_to_numpy(jg)
        cap = jg["x"].shape[0] // 2
        for r in range(2):
            if bounds is None:
                tl, tcap = tsp.shard_spatially(tp, TCFG, 2, r, slack=1.5)
            else:
                tl, tcap = tsb.shard_spatially_bounds(tp, TCFG, 2, r, bounds, slack=1.5)
            assert tcap == cap
            for f, v in convert.particles_to_numpy(tl).items():
                assert np.array_equal(v, jg[f][r * cap:(r + 1) * cap]), (f, r)


@pytest.mark.parametrize("s", [0, 1])
def test_edge_ghost_zeroing_keeps_non_finite_records_as_jax(s):
    """zero_domain_edge_ghosts adds the negation of rank 0's ghost
    records (no boolean index, no host sync): the same values as JAX's
    product with 0, NaN where a record is not finite; other ranks and
    columns are untouched."""
    from taichi_mpm_torch.ops.substep import build_page_map_full as t_build_page_map_full

    a = _global(2, movers=0)
    lcfg_t, lcfg_j = tsb.local_config(TCFG, 2), jsb.local_config(JCFG, 2)
    p = convert.particles_from_numpy({k: v[:CAP] for k, v in a.items()})
    p.x[:60, 0] = 0.005  # particles in rank 0's low ghost column
    keys = tsb.local_keys(p, tsb.shard_offset_cells(0, TCFG, 2), TCFG, lcfg_t)
    keys = torch.sort(keys).values
    pm_t = t_build_page_map_full(keys, lcfg_t, K)
    pm_j = build_page_map_full(jnp.asarray(keys.numpy()), lcfg_j, K)
    rec = np.random.default_rng(5).standard_normal((K, 256)).astype(np.float32)
    slots = tsb._column_slots(pm_t, lcfg_t, 0).flatten().numpy()
    live = slots[slots < K]
    assert live.size and (K - 1) not in live
    rec[live[0], :3] = (np.inf, -np.inf, np.nan)
    rec[K - 1, 0] = np.nan  # the slot inactive blocks add their zeros to
    want = np.asarray(jsb.zero_domain_edge_ghosts(jnp.asarray(rec), pm_j, lcfg_j,
                                                  jnp.int32(s), 2))
    got = tsb.zero_domain_edge_ghosts(torch.as_tensor(rec.copy()), pm_t, lcfg_t, s).numpy()
    np.testing.assert_array_equal(got, want)
    if s == 0:
        assert np.isnan(got[live[0], :3]).all() and not got[live[0], 3:].any()
