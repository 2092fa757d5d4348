"""Port parity: the refined-mesh geometry and ghost fill (``amr/smr.py``),
the prolongation/restriction operators and the forest binding, against the
JAX package on the CPU.

The leaf tables must be equal, and the operators and the fill bitwise
equal: they are the same operations on the same numbers (copies, pair
averages, minmod slopes), so no tolerance is given.  The fill is held on
random states in 3-D (a three-level nest), 2-D and 1-D, with periodic,
outflow and reflecting boundaries.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu.amr.smr import SmrMesh as JSmrMesh
from athenapk_tpu.amr.smr import SmrState as JSmrState
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.refinement import prolong_restrict as jpr
from athenapk_tpu_torch.amr.smr import (SmrMesh, SmrState,
                                        smr_regions_from_deck)
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core import amr_forest
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.refinement import prolong_restrict as tpr

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]

NEST = [(0.25, 0.75, 0.25, 0.75, 0.25, 0.75, 1),
        (0.4, 0.6, 0.4, 0.6, 0.4, 0.6, 2)]
CASES = {
    # test_smr.py's two-level mesh and its three-level nest (:173)
    "3d_two_level": (dict(nx=(32, 32, 32), mb=(8, 8, 8), g=2),
                     [(0.4, 0.6, 0.4, 0.6, 0.4, 0.6, 1)]),
    "3d_nest": (dict(nx=(32, 32, 32), mb=(8, 8, 8), g=3), NEST),
    "3d_corner": (dict(nx=(16, 16, 16), mb=(8, 8, 8), g=3),
                  [(0.0, 0.5, 0.0, 0.5, 0.0, 0.5, 1)]),
    "2d": (dict(nx=(32, 32, 1), mb=(8, 8, 1), g=2),
           [(0.0, 0.5, 0.0, 0.5, -0.5, 0.5, 1)]),
    "2d_nest": (dict(nx=(32, 32, 1), mb=(8, 8, 1), g=2),
                [(0.25, 0.75, 0.25, 0.75, -0.5, 0.5, 1),
                 (0.4, 0.6, 0.4, 0.6, -0.5, 0.5, 2)]),
    "1d": (dict(nx=(64, 1, 1), mb=(16, 1, 1), g=2),
           [(0.3, 0.8, -0.5, 0.5, -0.5, 0.5, 1)]),
}


def _mesh_kw(nx, mb, g, bc="periodic"):
    return dict(nx1=nx[0], nx2=nx[1], nx3=nx[2], mbnx1=mb[0], mbnx2=mb[1],
                mbnx3=mb[2], x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.0,
                x3min=0.0 if nx[2] > 1 else -0.5,
                x3max=1.0 if nx[2] > 1 else 0.5, nghost=g,
                ix1_bc=bc, ox1_bc=bc,
                ix2_bc=bc if nx[1] > 1 else "periodic",
                ox2_bc=bc if nx[1] > 1 else "periodic",
                ix3_bc=bc if nx[2] > 1 else "periodic",
                ox3_bc=bc if nx[2] > 1 else "periodic")


def _meshes(case, bc="periodic"):
    kw, regions = CASES[case]
    kw = _mesh_kw(kw["nx"], kw["mb"], kw["g"], bc)
    return JSmrMesh(JMesh(**kw), regions), SmrMesh(Mesh(**kw), regions)


@pytest.mark.parametrize("case", sorted(CASES))
def test_leaf_tables_match_jax(case):
    js, ts = _meshes(case)
    for name in ("levels", "lx1", "lx2", "lx3"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    assert sorted(ts.level_ids) == sorted(js.level_ids)
    for lev in js.level_ids:
        np.testing.assert_array_equal(ts.level_ids[lev], js.level_ids[lev])
        assert ts.dx(lev) == js.dx(lev)
        assert ts.min_dx(lev) == js.min_dx(lev)
    if case == "3d_nest":
        assert ts.max_level == 2 and ts.levels.size > 64
    for gid in (0, ts.levels.size // 2, ts.levels.size - 1):
        assert ts.block_origin(gid) == js.block_origin(gid)
        for a, b in zip(ts.cell_centers_leaf(gid), js.cell_centers_leaf(gid)):
            np.testing.assert_array_equal(a, b)


def test_regions_from_deck():
    deck = """
<parthenon/static_refinement1>
x1min = 0.4
x1max = 0.6
x2min = 0.4
x2max = 0.6
x3min = 0.4
x3max = 0.6
level = 2
<parthenon/static_refinement0>
x1min = 0.25
x1max = 0.75
x2min = 0.25
x2max = 0.75
x3min = 0.25
x3max = 0.75
level = 1
"""
    got = smr_regions_from_deck(ParameterInput.from_string(deck))
    from athenapk_tpu.amr.smr import smr_regions_from_deck as jregions
    assert got == jregions(JPin.from_string(deck)) == NEST


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_prolong_restrict_bitwise(dims):
    rng = np.random.default_rng(dims)
    shape = (3, 2) + (1,) * (3 - dims) + (6,) * dims
    q = rng.standard_normal(shape)
    # flat and linear stretches put the minmod selects and the alpha
    # limiter on their equal and zero branches too
    q[0] = 1.5
    q[1, 0] = np.arange(q[1, 0].size).reshape(q[1, 0].shape)
    got = tpr.prolongate_minmod(torch.tensor(q), dims=dims).numpy()
    want = np.asarray(jpr.prolongate_minmod(jnp.asarray(q), dims=dims))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    got = tpr.restrict_average(torch.tensor(q), dims=dims).numpy()
    want = np.asarray(jpr.restrict_average(jnp.asarray(q), dims=dims))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case,bc", [
    ("3d_nest", "periodic"), ("3d_corner", "outflow"),
    ("3d_corner", "reflecting"), ("2d_nest", "periodic"),
    ("2d", "reflecting"), ("1d", "outflow")])
def test_fill_matches_jax_bitwise(case, bc):
    js, ts = _meshes(case, bc)
    nvar = 5
    rng = np.random.default_rng(len(case) + len(bc))
    state = {lev: rng.standard_normal((ids.size, nvar) + js.base.block_shape)
             for lev, ids in js.level_ids.items()}
    want = JSmrState(js, nvar).fill_ghosts(
        {lev: jnp.asarray(v) for lev, v in state.items()})
    got = SmrState(ts, nvar, device="cpu").fill_ghosts(
        {lev: torch.tensor(v) for lev, v in state.items()})
    for lev in state:
        np.testing.assert_array_equal(got[lev].numpy(), np.asarray(want[lev]))
        # the fill changes ghosts only
        isl = ts.base.interior_slices
        np.testing.assert_array_equal(got[lev][isl].numpy(), state[lev][isl])


def test_fill_is_in_place_and_keeps_a_uniform_state():
    _, ts = _meshes("3d_nest")
    st = SmrState(ts, 1, device="cpu")
    state = {lev: torch.full((ids.size, 1) + ts.base.block_shape, 3.5,
                             dtype=torch.float64)
             for lev, ids in ts.level_ids.items()}
    ids = {lev: id(v) for lev, v in state.items()}
    filled = st.fill_ghosts(state)
    for lev, v in filled.items():
        assert id(v) == ids[lev]
        assert bool((v == 3.5).all())


def _snapshot(path):
    return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                  for p in Path(path).iterdir())


def test_forest_binding_builds_under_build_and_not_native(tmp_path):
    native = ROOT / "native"
    before = _snapshot(native)
    lib = amr_forest.build_library()
    assert lib.parent == ROOT / "build" and lib.exists()
    # a fresh build goes where it is asked to, keyed by the source's hash
    fresh = amr_forest.build_library(tmp_path)
    assert fresh.parent == tmp_path and fresh.name == lib.name
    assert _snapshot(native) == before
    forest = amr_forest.AmrForest(2, 2, 2, ndim=3, max_level=1)
    assert forest.num_leaves == 8
    forest.update(np.eye(1, 8, 3, dtype=np.int32).ravel())
    levels, *_ = forest.leaves()
    assert sorted(levels.tolist()) == [0] * 7 + [1] * 8
    assert os.path.dirname(str(lib)) != str(native)


@pytest.mark.parametrize("what", ["SmrState", "SmrHydro",
                                  "init_state_from_pgen"])
def test_refined_building_blocks_default_to_the_card(what, monkeypatch):
    """Called without a device, each asks for the card: with none there,
    it raises ``core.device.resolve_device``'s error instead of running on
    the CPU."""
    from athenapk_tpu_torch.amr.driver import init_state_from_pgen
    from athenapk_tpu_torch.amr.smr_hydro import SmrHydro
    from athenapk_tpu_torch.eos.adiabatic import EOS
    from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ts = _meshes("3d_nest")
    cfg = HydroConfig(fluid="euler", riemann="hlle", reconstruction="plm")
    calls = {
        "SmrState": lambda: SmrState(ts, 5),
        "SmrHydro": lambda: SmrHydro(ts, cfg, EOS(gamma=5.0 / 3.0)),
        # the device is resolved before the generator is called
        "init_state_from_pgen": lambda: init_state_from_pgen(
            ts, None, None, cfg, EOS(gamma=5.0 / 3.0)),
    }
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        calls[what]()
