"""Port vs JAX: sort, page map, neighbour table, halo merge, window
assembly and the record grid update.

Integer outputs must be equal. The merge and the assembly are exact
selections in both packages (0/1 matmuls in JAX, gathers here); the JAX
side runs its selection matmuls at f32 precision on the CPU, and the
merge sums up to 8 terms in another order, so records and windows are
held to 1e-6 x max|value|. The grid update is the same elementwise
formula in both: 1e-6 x max|value|."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from taichi_mpm_tpu.core import levelset as jls
from taichi_mpm_tpu.ops import blocked as jblocked
from taichi_mpm_tpu.ops import packed as jpacked
from taichi_mpm_tpu.ops import substep as jsubstep
from taichi_mpm_torch import convert
from taichi_mpm_torch.core import levelset as tls
from taichi_mpm_torch.ops import blocked as tblocked
from taichi_mpm_torch.ops import packed as tpacked
from taichi_mpm_torch.ops import substep as tsubstep

from port_helpers import configs, jax_particles, max_err, np_of, scene_arrays

torch.set_num_threads(1)

K = 192


@pytest.fixture(scope="module")
def mapped():
    """Two clusters of particles (gaps in the page map), sorted and
    mapped by both packages from the same packed state."""
    a, mids = scene_arrays(900, seed=11, lo=0.2, hi=0.3)
    b, _ = scene_arrays(600, seed=12, lo=0.55, hi=0.7, cap_extra=0)
    arrays = {k: np.concatenate([a[k], b[k]]) for k in a}
    jcfg, tcfg = configs(mids)
    st0 = jpacked.pack_particles(jax_particles(arrays)).reshape(48, -1)
    jst, jkeys, jpm = jpacked.sort_and_map(st0, jcfg, K)
    tst, tkeys, tpm = tpacked.sort_and_map(
        convert.packed_from_numpy(np.asarray(st0)), tcfg, K)
    return dict(jcfg=jcfg, tcfg=tcfg, jst=jst, jkeys=jkeys, jpm=jpm,
                tst=tst, tkeys=tkeys, tpm=tpm)


def test_keys_and_sort_order_equal(mapped):
    m = mapped
    assert np.array_equal(np.asarray(m["jkeys"]), m["tkeys"].numpy())
    # same stable permutation: every row, including the origin rows
    assert np.array_equal(np.asarray(m["jst"]).view(np.uint32),
                          m["tst"].numpy().view(np.uint32))


@pytest.mark.parametrize("name", ["ids", "n_act", "slot_map", "s_arr", "e_arr",
                                  "nbr", "slot_keys"])
def test_page_map_equal(mapped, name):
    j, t = np.asarray(mapped["jpm"][name]), mapped["tpm"][name].numpy()
    assert j.shape == t.shape and np.array_equal(j, t)


def _occupied(mapped):
    """Slots that hold particles. The JAX merge and assembly are
    separable (per-axis) passes, exact where the fat page map holds:
    only occupied slots write tiles, only they read windows."""
    pm = mapped["jpm"]
    return np.asarray(pm["e_arr"]) > np.asarray(pm["s_arr"])


def test_merge_matches_merge_tiles_mm(mapped):
    rng = np.random.default_rng(3)
    tiles = rng.standard_normal((K, 7, 7, 7, 4)).astype(np.float32)
    tiles[~_occupied(mapped)] = 0.0
    jt = jnp.asarray(tiles.transpose(0, 1, 4, 2, 3).reshape(K, 28, 49))
    jrec = jblocked.merge_tiles_mm(jt, mapped["jpm"]["nbr"])
    trec = tblocked.merge_tiles(torch.as_tensor(tiles), mapped["tpm"]["nbr"])
    assert max_err(jrec, trec) <= 1e-6 * float(np.abs(np.asarray(jrec)).max())


def test_windows_match_windows_mm(mapped):
    rng = np.random.default_rng(4)
    n_act = int(mapped["jpm"]["n_act"])
    vrec = rng.standard_normal((K, 192)).astype(np.float32)
    vrec[n_act:] = 0.0
    jw = np.asarray(jblocked.windows_mm(jnp.asarray(vrec), mapped["jpm"]["nbr"]))
    occ = _occupied(mapped)
    jw = jw[:, :21, :49].reshape(K, 3, 7, 7, 7)[occ]
    tw = tblocked.windows(torch.as_tensor(vrec), mapped["tpm"]["nbr"])[occ]
    assert max_err(jw, tw) <= 1e-6 * float(np.abs(jw).max())


def _colliders(ls, which):
    if which == "box_plane":
        return (ls.box_domain((0.21, 0.22, 0.23), (0.65, 0.66, 0.67), friction=-1.0),
                ls.plane((0.0, 0.25, 0.0), (0.0, 1.0, 0.0), friction=0.4))
    # a slip-with-friction sphere, and an SDF without an analytic normal
    # (central differences)
    return (ls.sphere((0.3, 0.3, 0.3), 0.08, friction=-2.5),
            ls.Collider(sdf=lambda x, t: x[..., 1] - 0.62, friction=0.3))


@pytest.mark.parametrize("which", ["box_plane", "sphere_sdf"])
def test_grid_update_flat_matches(mapped, which):
    """Boundary projection on records with empty nodes: a sticky box and
    a frictional plane, or a slip sphere and a plain SDF collider."""
    rng = np.random.default_rng(5)
    rec = rng.standard_normal((K, 256)).astype(np.float32)
    mass = np.abs(rng.standard_normal((K, 64))).astype(np.float32) * 1e-3
    mass[rng.random((K, 64)) < 0.3] = 0.0
    rec[:, 192:] = mass
    jcol, tcol = _colliders(jls, which), _colliders(tls, which)
    dt = mapped["jcfg"].base_dt
    jv = jsubstep.grid_update_flat(jnp.asarray(rec), mapped["jpm"]["ids"],
                                   mapped["jcfg"], jcol, jnp.float32(0.0), dt)
    tv = tsubstep.grid_update_flat(torch.as_tensor(rec), mapped["tpm"]["ids"],
                                   mapped["tcfg"], tcol, np.float32(0.0), dt)
    jv = np.asarray(jv)
    assert np.array_equal(jv == 0.0, np_of(tv) == 0.0)
    assert max_err(jv, tv) <= 1e-6 * float(np.abs(jv).max())


def test_page_map_sentinel_capacity_beyond_blocks():
    """K larger than the padded block space pads with sentinels."""
    a, mids = scene_arrays(50, seed=2, lo=0.4, hi=0.45)
    jcfg, tcfg = configs(mids, res=(8, 8, 8))
    st0 = jpacked.pack_particles(jax_particles(a)).reshape(48, -1)
    total = jblocked.total_blocks_padded(jcfg)
    Kbig = total + 64
    _, _, jpm = jpacked.sort_and_map(st0, jcfg, Kbig)
    _, _, tpm = tpacked.sort_and_map(convert.packed_from_numpy(np.asarray(st0)), tcfg, Kbig)
    for name in ("ids", "slot_map", "s_arr", "e_arr", "nbr"):
        assert np.array_equal(np.asarray(jpm[name]), tpm[name].numpy()), name
