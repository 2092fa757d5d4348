"""Port parity: the adaptive remesh (``amr/remesh.py``) and ``AmrHydro``,
against the JAX package's ``amr/remesh.py`` on the CPU in f64.

* The remesh conserves mass to 1e-13 relative across a refinement and a
  full derefinement (twin of ``tests/test_remesh.py::
  test_remesh_roundtrip_conserves``).
* On the same tags, the leaf table equals the JAX package's and the
  transferred, ghost-filled state agrees to 1e-14 relative (copies,
  minmod prolongation and pair averages: the same operations on the same
  numbers), in 3-D and 2-D, for refinement, derefinement and both at once.
* ``SmrMesh.from_leaf_table`` rebuilds the JAX package's mesh, and a mesh
  derefined to its roots refines again (the ceiling is the forest's).
* ``AmrHydro`` tracks an advected density blob and conserves its mass to
  1e-12 (twin of ``test_amr_blob_tracking``), with one stepper per
  topology and the derefinement counters.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu.amr.remesh import remesh as jremesh
from athenapk_tpu.amr.smr import SmrMesh as JSmrMesh
from athenapk_tpu.amr.smr import SmrState as JSmrState
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu_torch.amr.remesh import AmrHydro, remesh
from athenapk_tpu_torch.amr.smr import SmrMesh, SmrState
from athenapk_tpu_torch.amr.smr_hydro import SmrHydro
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.eos.adiabatic import EOS, prim_to_cons
from athenapk_tpu_torch.refinement import RefinementConfig
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig

torch.set_num_threads(2)

CONSERVE = 1e-13
PARITY = 1e-14


def _mesh_kw(n=32, mb=8, g=2, ndim=3):
    return dict(nx1=n, nx2=n, nx3=n if ndim == 3 else 1, mbnx1=mb, mbnx2=mb,
                mbnx3=mb if ndim == 3 else 1, x1min=0.0, x1max=1.0,
                x2min=0.0, x2max=1.0, x3min=0.0 if ndim == 3 else -0.5,
                x3max=1.0 if ndim == 3 else 0.5, nghost=g)


def _blob_state(sm, x0=0.25, noise_seed=None):
    """The blob of ``tests/test_remesh.py:_blob_state`` (a Gaussian density
    moving along x), optionally with seeded noise on the momenta; f64
    tensors, ghosts unfilled."""
    rng = np.random.default_rng(noise_seed)
    base = sm.base
    eos = EOS(gamma=5.0 / 3.0)
    state = {}
    for lev, ids in sm.level_ids.items():
        w = np.zeros((len(ids), 5) + base.block_shape)
        for li, gid in enumerate(ids):
            x, y, z = sm.cell_centers_leaf(gid)
            r2 = (x - x0) ** 2 + (y - 0.5) ** 2
            if base.nx3 > 1:
                r2 = r2 + (z - 0.5) ** 2
            w[li, 0] = 1.0 + np.broadcast_to(np.exp(-r2 / 0.005),
                                             base.block_shape)
            w[li, 1] = 1.0
            w[li, 4] = 1.0
        if noise_seed is not None:
            w[:, 1:3] += 1e-3 * rng.standard_normal(w[:, 1:3].shape)
        state[lev] = prim_to_cons(eos, torch.tensor(w), "euler")
    return state


def _total_mass(sm, state):
    isl = sm.base.interior_slices
    tot = 0.0
    for lev, u in state.items():
        d1, d2, d3 = sm.dx(lev)
        tot += float(torch.sum(u[isl][:, 0])) * d1 * d2 * d3
    return tot


def _near_blob(sm, x0=0.25, r2max=0.02):
    tags = np.zeros(sm.levels.size, np.int32)
    for gid in range(sm.levels.size):
        x, y, z = sm.cell_centers_leaf(gid)
        if ((x - x0) ** 2).min() < r2max and ((y - 0.5) ** 2).min() < r2max \
                and (sm.base.nx3 == 1 or ((z - 0.5) ** 2).min() < r2max):
            tags[gid] = 1
    return tags


def test_remesh_roundtrip_conserves():
    sm = SmrMesh(Mesh(**_mesh_kw()), [], max_level=1)
    state = SmrState(sm, 5, "cpu").fill_ghosts(_blob_state(sm))
    m0 = _total_mass(sm, state)

    sm2, state2 = remesh(sm, state, _near_blob(sm))
    assert sm2.max_level == 1 and 1 in sm2.level_ids
    assert abs(_total_mass(sm2, state2) - m0) / m0 < CONSERVE

    sm3, state3 = remesh(sm2, state2, -np.ones(sm2.levels.size, np.int32))
    assert sm3.max_level == 0
    assert sm3.levels.size == 64
    assert abs(_total_mass(sm3, state3) - m0) / m0 < CONSERVE
    assert all(bool(torch.isfinite(v).all()) for v in state3.values())


def _table(sm):
    return (sm.levels, sm.lx1, sm.lx2, sm.lx3)


def _assert_same_mesh(tsm, jsm):
    for a, b in zip(_table(tsm), _table(jsm)):
        np.testing.assert_array_equal(a, b)
    assert sorted(tsm.level_ids) == sorted(jsm.level_ids)
    assert tsm.max_level == jsm.max_level


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _kinds(old, new):
    """'refine' / 'derefine' for the leaves of ``new`` that ``old`` did not
    have: made from their parent, or from their children."""
    out = set()
    for (lev, a, b, c) in new._by_loc:
        if (lev, a, b, c) not in old._by_loc:
            out.add("refine" if (lev - 1, a // 2, b // 2, c // 2)
                    in old._by_loc else "derefine")
    return out


def _rounds(sm, r):
    """Tag round ``r``: refine the roots of the corner [0, 0.5)^d; derefine
    those while refining the corner [0.5, 1)^d; derefine all."""
    nb = sm.levels.size
    if r == 0:
        return np.array([all(o < 0.5 for o in sm.block_origin(g)
                             [:sm.base.ndim]) for g in range(nb)], np.int32)
    if r == 1:
        far = np.array([all(o >= 0.5 for o in sm.block_origin(g)
                            [:sm.base.ndim]) for g in range(nb)], np.int32)
        return np.where(sm.levels == 1, -1, far).astype(np.int32)
    return -np.ones(nb, np.int32)


WANT_KINDS = [{"refine"}, {"refine", "derefine"}, {"derefine"}]


@pytest.mark.parametrize("ndim", [3, 2])
def test_remesh_matches_jax(ndim):
    """Three rounds of tags (refinement, both at once, derefinement): leaf
    tables equal and states to 1e-14 relative after every remesh."""
    kw = _mesh_kw(n=16, mb=8, g=2, ndim=ndim)
    tsm = SmrMesh(Mesh(**kw), [], max_level=1)
    jsm = JSmrMesh(JMesh(**kw), [], max_level=1)
    start = _blob_state(tsm, x0=0.3, noise_seed=7)
    tstate = SmrState(tsm, 5, "cpu").fill_ghosts(start)
    jstate = JSmrState(jsm, 5).fill_ghosts(
        {lev: jnp.asarray(v.numpy()) for lev, v in start.items()})
    for r, want in enumerate(WANT_KINDS):
        tags = _rounds(tsm, r)
        np.testing.assert_array_equal(tags, _rounds(jsm, r))
        old = tsm
        tsm, tstate = remesh(tsm, tstate, tags)
        jsm, jstate = jremesh(jsm, jstate, tags)
        assert _kinds(old, tsm) == want, r
        _assert_same_mesh(tsm, jsm)
        for lev in jstate:
            assert tstate[lev].shape == jstate[lev].shape
            assert _rel(tstate[lev].numpy(), jstate[lev]) <= PARITY, (r, lev)
    assert tsm.max_level == 0


def test_from_leaf_table_and_refining_again():
    kw = _mesh_kw(n=16, mb=8, g=2)
    jsm = JSmrMesh(JMesh(**kw), [(0.0, 0.5, 0.0, 0.5, 0.0, 0.5, 1),
                                 (0.0, 0.25, 0.0, 0.25, 0.0, 0.25, 2)])
    tsm = SmrMesh.from_leaf_table(Mesh(**kw), jsm.levels, jsm.lx1, jsm.lx2,
                                  jsm.lx3, max_level=2)
    _assert_same_mesh(tsm, jsm)
    with pytest.raises(ValueError, match="leaf table"):
        SmrMesh.from_leaf_table(Mesh(**kw), [2], [0], [0], [0], max_level=2)

    # derefine to the roots: max_level drops to 0, yet the forest keeps
    # its ceiling of 2 and refines twice more
    sm = SmrMesh(Mesh(**kw), [], max_level=2)
    state = SmrState(sm, 5, "cpu").fill_ghosts(_blob_state(sm))
    sm, state = remesh(sm, state, np.ones(sm.levels.size, np.int32))
    # every root refined: level 0 holds no leaves and has no tensor, and
    # the stepper steps what is there
    assert sorted(sm.level_ids) == sorted(state) == [1]
    st = SmrHydro(sm, HydroConfig(fluid="euler", riemann="hlle",
                                  reconstruction="plm"),
                  EOS(gamma=5.0 / 3.0), device="cpu")
    m0 = st.total_mass(state)
    stepped = st.step(state, float(st.estimate_dt(state)), 0.0)
    assert abs(st.total_mass(stepped) - m0) / m0 < CONSERVE
    sm, state = remesh(sm, state, -np.ones(sm.levels.size, np.int32))
    assert sm.max_level == 0 and sm.levels.size == 8
    for want in (1, 2, 2):
        sm, state = remesh(sm, state, np.ones(sm.levels.size, np.int32))
        assert sm.max_level == want
    assert sm.levels.size == 8 ** 3


def test_amr_blob_tracking():
    """Twin of ``tests/test_remesh.py::test_amr_blob_tracking``."""
    sm = SmrMesh(Mesh(**_mesh_kw(n=16, mb=8, g=3)), [], max_level=1)
    cfg = HydroConfig(fluid="euler", riemann="hllc", reconstruction="plm",
                      integrator="rk2")
    rcfg = RefinementConfig(method="maxdensity", maxdensity_refine_above=1.3,
                            maxdensity_deref_below=1.1)
    drv = AmrHydro(sm, cfg, EOS(gamma=5.0 / 3.0), rcfg, check_interval=2,
                   device="cpu")
    state = drv._stepper.fill_ghosts(_blob_state(sm, x0=0.3))
    state, changed = drv.maybe_remesh(state)
    assert changed and drv.smesh.max_level == 1
    assert drv.remesh_log[-1]["new_topology"]
    m0 = drv.total_mass(state)
    state = drv.advance(state, 6)
    assert abs(drv.total_mass(state) - m0) / m0 < 1e-12
    # the refined region still holds the densest cell of the advected blob
    isl = drv.smesh.base.interior_slices
    best = {lev: float(u[isl][:, 0].max()) for lev, u in state.items()}
    assert best[drv.smesh.max_level] == max(best.values())
    assert all(bool(torch.isfinite(u).all()) for u in state.values())
    # one stepper per leaf table seen
    assert len(drv._steppers) == 1 + sum(e["new_topology"]
                                         for e in drv.remesh_log)


def test_derefine_count_needs_consecutive_checks():
    """A leaf merges only after ``derefine_count`` consecutive checks that
    ask for it; a check that does not resets its count."""
    sm = SmrMesh(Mesh(**_mesh_kw(n=16, mb=8, g=2)), [], max_level=1)
    cfg = HydroConfig(fluid="euler", riemann="hlle", reconstruction="plm")
    drv = AmrHydro(sm, cfg, EOS(gamma=5.0 / 3.0), RefinementConfig(),
                   derefine_count=3, device="cpu")
    state = drv._stepper.fill_ghosts(_blob_state(sm))
    state, changed = drv.maybe_remesh(state, np.ones(8, np.int32))
    assert changed and drv.smesh.levels.size == 64
    down = -np.ones(64, np.int32)
    for tags, want in ((down, False), (np.zeros(64, np.int32), False),
                       (down, False), (down, False), (down, True)):
        state, changed = drv.maybe_remesh(state, tags)
        assert changed == want
    assert drv.smesh.levels.size == 8
    assert abs(drv.total_mass(state) - _total_mass(sm, SmrState(
        sm, 5, "cpu").fill_ghosts(_blob_state(sm)))) < 1e-13
