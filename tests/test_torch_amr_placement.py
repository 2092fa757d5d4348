"""Port parity: the refined meshes' placement over ranks
(``AmrHydro(rmesh=..., layout="flat"|"padded")``, ``amr/sharded.py``) and
``merge_blocks = auto`` under several ranks, on real gloo processes.

Twins of ``tests/test_amr_flat.py`` (exact balance of the flat layout and
``exact_state``'s round trip; two advance cycles on an uneven mesh; an
adaptive run through remeshes), ``tests/test_amr_balance.py`` (the padded
layout's per-level chunks; two advance cycles), ``tests/test_remesh.py:
test_sharded_adaptive_remesh_bitwise`` and ``tests/test_merge_blocks.py:
test_merge_auto_off_multidevice``.  The leaf counts per rank are the JAX
package's per-device counts; states and leaf tables equal the port's
one-rank run bit for bit, and the JAX package's sharded run to its
refined parity tests' 1e-12 (the JAX tests hold theirs bitwise against
their own one-device run; the port and the JAX package differ by
rounding).  ``slow`` marks what the JAX twin marks ``slow``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as DMesh, NamedSharding, PartitionSpec as P

from athenapk_tpu_torch.amr.remesh import AmrHydro
from athenapk_tpu_torch.parallel.dryrun import run_ranks
from test_merge_blocks import DECK as MERGE_DECK
from test_remesh import _blob_state
import torch_dist_workers as w


def _jax_amr(kind, sharding, layout="flat"):
    """The JAX twin's ``AmrHydro`` and its initial whole state."""
    from athenapk_tpu.amr import SmrMesh
    from athenapk_tpu.amr.remesh import AmrHydro as JAmr
    from athenapk_tpu.amr.smr import SmrState as JState
    from athenapk_tpu.core.mesh import Mesh as CMesh
    from athenapk_tpu.eos.adiabatic import EOS, prim_to_cons as jp2c
    from athenapk_tpu.refinement import RefinementConfig
    from athenapk_tpu.solver.hydro_pkg import HydroConfig

    eos = EOS(gamma=5.0 / 3.0)
    cfg = HydroConfig(fluid="euler", riemann="hllc", reconstruction="plm",
                      integrator="rk2")
    if kind == "uneven":
        base = CMesh(nx1=24, nx2=24, nx3=24, mbnx1=8, mbnx2=8, mbnx3=8,
                     x1min=0, x1max=1, x2min=0, x2max=1, x3min=0, x3max=1,
                     nghost=2)
        sm = SmrMesh(base, [(0.0, 0.32, 0.0, 0.32, 0.0, 0.32, 1)])
        amr = JAmr(sm, cfg, eos, RefinementConfig(
            method="maxdensity", maxdensity_refine_above=1e30),
            sharding=sharding, layout=layout)
        st = {}
        rng = np.random.default_rng(7)
        for lev, ids in sm.level_ids.items():
            shape = (len(ids), 5) + base.block_shape
            wp = np.ones(shape)
            wp[:, 1:4] = 0.1 * rng.standard_normal((shape[0], 3) + shape[2:])
            wp[:, 4] = 1.0 + 0.1 * rng.random(((shape[0],) + shape[2:]))
            st[lev] = jnp.asarray(np.asarray(jp2c(eos, jnp.asarray(wp),
                                                  "euler")))
        return amr, JState(sm, 5).fill_ghosts(st)
    nx = 16 if kind == "blob" else 32
    base = CMesh(nx1=nx, nx2=nx, nx3=nx, mbnx1=8, mbnx2=8, mbnx3=8,
                 x1min=0, x1max=1, x2min=0, x2max=1, x3min=0, x3max=1,
                 nghost=2)
    sm = SmrMesh(base, [], max_level=1)
    rcfg = RefinementConfig(method="maxdensity", maxdensity_refine_above=1.3,
                            maxdensity_deref_below=1.05)
    amr = JAmr(sm, cfg, eos, rcfg, derefine_count=1, sharding=sharding)
    if kind == "remesh":
        st = _blob_state(sm, eos)
    else:   # test_amr_flat.py:test_flat_adaptive_remesh_balance's blob
        st = {}
        for lev, ids in sm.level_ids.items():
            wp = np.ones((len(ids), 5) + base.block_shape)
            wp[:, 1:4] = 0.0
            st[lev] = jnp.asarray(np.asarray(jp2c(eos, jnp.asarray(wp),
                                                  "euler")))
        st[0] = st[0].at[0, 0].mul(1.5)
    return amr, JState(sm, 5).fill_ghosts(st)


def _shd():
    return NamedSharding(DMesh(np.asarray(jax.devices()[:8]), ("blocks",)),
                         P("blocks"))


def _port_amr(kind, layout="flat"):
    sm, cfg, eos, rcfg, kw = w.amr_mesh(kind)
    return AmrHydro(sm, cfg, eos, rcfg, device="cpu", layout=layout, **kw)


def _run(tmp_path, kind, layout, ncycles, jstate):
    """The 8-rank run from the JAX twin's initial state: -> (gathered
    npz, numbers)."""
    np.savez(tmp_path / "amr_in.npz",
             **{str(k): np.asarray(v) for k, v in jstate.items()})
    run_ranks(w.run_cases, 8, (str(tmp_path), [
        ("amr_case", ("amr", kind, layout, ncycles))]), device="cpu",
        timeout=600)
    with open(tmp_path / "amr.json") as f:
        nums = json.load(f)
    return np.load(tmp_path / "amr.npz"), nums


def _jax_counts(amr, placed):
    got = amr.device_leaf_counts(placed)
    return [got.get(d, 0) for d in jax.devices()[:8]]


def _check_states(out, port_amr, port_state, jax_state):
    for lev, v in port_state.items():
        np.testing.assert_array_equal(out[str(lev)], v.numpy(),
                                      err_msg=f"level {lev}")
        want = np.asarray(jax_state[lev])
        assert np.abs(out[str(lev)] - want).max() <= \
            1e-12 * np.abs(want).max(), f"level {lev}"
    for k in ("levels", "lx1", "lx2", "lx3"):
        np.testing.assert_array_equal(out[k], getattr(port_amr.smesh, k))


def _one_rank(kind, jstate, ncycles, layout="flat"):
    amr = _port_amr(kind, layout)
    st = {k: torch.from_numpy(np.asarray(v)) for k, v in jstate.items()}
    return amr, amr.advance(st, ncycles)


@pytest.mark.parametrize("layout", ["flat", "padded"])
def test_placement_balance(tmp_path, layout):
    """Twins of ``test_flat_placement_exact_balance`` and
    ``test_padded_placement_balance``: 34 leaves (26 + 8) over 8 ranks;
    the flat layout holds N//D or N//D + 1 leaves a rank, the padded one a
    chunk of each level; both are the JAX package's per-device counts;
    ``exact_state`` gives the whole state back bit for bit and ``_place``
    is idempotent."""
    jamr, jst = _jax_amr("uneven", _shd(), layout)
    jcounts = _jax_counts(jamr, jamr._place(jst))
    out, nums = _run(tmp_path, "uneven", layout, 0, jst)
    counts = [nums["placed_counts"][str(r)] for r in range(8)]
    assert counts == jcounts
    N = 34
    assert sum(counts) == N
    if layout == "flat":
        assert set(counts) <= {N // 8, N // 8 + 1}
    assert nums["round_trip"] and nums["idempotent"]


@pytest.mark.slow
@pytest.mark.parametrize("layout", ["flat", "padded"])
def test_advance_bitwise_vs_unsharded(tmp_path, layout):
    """Twins of ``test_flat_advance_bitwise_vs_unsharded`` and
    ``test_padded_advance_bitwise_vs_unsharded``: two advance cycles on
    the uneven mesh over 8 ranks."""
    jamr, jst = _jax_amr("uneven", _shd(), layout)
    jout = jamr.exact_state(jamr.advance(jamr._place(jst), 2))
    out, _ = _run(tmp_path, "uneven", layout, 2, jst)
    amr, ref = _one_rank("uneven", jst, 2, layout)
    _check_states(out, amr, ref, jout)


@pytest.mark.slow
@pytest.mark.parametrize("kind,ncycles", [("blob", 3), ("remesh", 4)])
def test_adaptive_remesh_bitwise(tmp_path, kind, ncycles):
    """Twins of ``test_flat_adaptive_remesh_balance`` (16^3, 3 cycles) and
    ``tests/test_remesh.py:test_sharded_adaptive_remesh_bitwise`` (32^3,
    4 cycles): adaptive runs through remeshes over 8 ranks, the new
    leaves re-dealt after every remesh with exact balance."""
    jamr, jst = _jax_amr(kind, _shd())
    jout = jamr.exact_state(jamr.advance(jst, ncycles))
    out, nums = _run(tmp_path, kind, "flat", ncycles, jst)
    amr, ref = _one_rank(kind, jst, ncycles)
    assert amr.smesh.max_level > 0 and nums["remeshes"] > 0
    _check_states(out, amr, ref, jout)
    counts = [nums["counts"][str(r)] for r in range(8)]
    assert sum(counts) == amr.smesh.levels.size
    assert max(counts) - min(counts) <= 1
    np.testing.assert_array_equal(out["levels"], jamr.smesh.levels)


@pytest.mark.parametrize("mesh_kind,layout,world", [
    ("uneven", "flat", 3), ("uneven", "padded", 8), ("smr", "flat", 2),
    ("smr", "padded", 4), ("2d", "flat", 3)])
def test_sharded_fill_bitwise(tmp_path, mesh_kind, layout, world):
    """One ghost fill over the ranks equals the one-rank fill bit for bit,
    ghosts included, on a state whose ghosts hold random values (stale
    ghosts, so a box received early and written since shows); each rank
    sends what its schedule says, no more than the face slabs the other
    ranks read and less than an all-gather of its rows.  Meshes: the
    uneven 24^3 one, ``test_sharded_smr_step``'s, and a 2-D one with
    outflow x (edge-rank boundaries)."""
    from athenapk_tpu_torch.amr.smr import SmrState

    sm = w.fill_mesh(mesh_kind)
    rng = np.random.default_rng(11)
    whole = {lev: torch.from_numpy(1.0 + rng.random(
        (ids.size, 5) + sm.base.block_shape))
        for lev, ids in sm.level_ids.items()}
    np.savez(tmp_path / "fill_in.npz",
             **{str(k): v.numpy() for k, v in whole.items()})
    run_ranks(w.run_cases, world, (str(tmp_path), [
        ("fill_case", ("fill", mesh_kind, layout))]), device="cpu",
        timeout=300)
    ref = SmrState(sm, 5, "cpu").fill_ghosts(
        {k: v.clone() for k, v in whole.items()})
    out = np.load(tmp_path / "fill.npz")
    for lev, v in ref.items():
        np.testing.assert_array_equal(out[str(lev)], v.numpy(),
                                      err_msg=f"level {lev}")
    for r in range(world):
        with open(tmp_path / f"fill.r{r}.json") as f:
            nums = json.load(f)
        slabs, gathered = nums["bounds"]
        assert nums["sent"] == nums["schedule"], (r, nums)
        assert 0 < nums["sent"] <= slabs, (r, nums)
        assert nums["sent"] < gathered, (r, nums)


def test_merge_auto_off_multidevice(tmp_path):
    """Twin of ``tests/test_merge_blocks.py:test_merge_auto_off_
    multidevice``: under a process group of two ranks ``merge_blocks =
    auto`` keeps the decomposition (the sharded path needs the block
    axis); on one rank it merges (``tests/test_torch_driver.py``)."""
    run_ranks(w.run_cases, 2, (str(tmp_path), [
        ("merge_case", ("merge", MERGE_DECK))]), device="cpu", timeout=300)
    with open(tmp_path / "merge.json") as f:
        got = json.load(f)
    assert got == {"nblocks": 8, "nghost": 3}
