"""Port parity: the cloud-crushing problem (``pgen/cloud.py`` with tabular
cooling, the ``cloud_inflow_x2`` boundary and the scalar refinement
check) against the JAX package on the CPU in f64.

The deck is ``torch_decks.CLOUD`` (the reference's ``inputs/cloud.in`` is
not in the repository): GLM-MHD HLLD + PLM + VL2, one passive scalar, a
transverse field at plasma beta 100, Townsend cooling on a power-law
table written by the test.

* ``problem_generator`` gives the JAX package's state bit for bit;
* a uniform run of 5 cycles through both packages' ``run_from_file``:
  state, every dt (the ``.hst`` rows) and the ``.hst`` file to 1e-12;
* an adaptive run of 5 cycles at 16 x 32 x 16 with 8^3 blocks, numlevel 2,
  in lockstep: the leaf table equal after every cycle, the state and the
  step to 1e-12.  The JAX side runs its ``scatter`` ghost fill
  (``ATHENAPK_SMR_FILL=scatter``): its default fill hands a boundary hook
  the ghost region without the variable axis, which the cloud's hook
  cannot take (``amr/smr.py`` says more);
* the adaptive run's inflow ghosts hold the wind, the mesh refines around
  the cloud, the pressure stays positive (the twin of
  ``tests/test_cluster_smr.py:test_cloud_deck_adaptive_inflow``);
* ``Simulation._merge_blocks`` keeps the ghosts of an all-periodic deck
  whose problem registers boundary conditions, in both packages.
"""

import contextlib

import numpy as np
import pytest
import torch

from athenapk_tpu import driver as jdriver
from athenapk_tpu.amr.driver import SmrSimulation as JSmr
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.driver import Simulation as JSim
from athenapk_tpu.eos.adiabatic import EOS as JEOS
from athenapk_tpu.pgen import cloud as jcloud
from athenapk_tpu.solver.hydro_pkg import HydroConfig as JCfg
from athenapk_tpu_torch import driver as tdriver
from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation
from athenapk_tpu_torch.eos.adiabatic import EOS, cons_to_prim
from athenapk_tpu_torch.pgen import cloud
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig
from torch_decks import (HST_BLOCK, KH, cloud_deck, deck,
                         write_cooling_table)

torch.set_num_threads(2)

TOL = 1e-12


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _table(sm):
    return tuple(np.asarray(x) for x in (sm.levels, sm.lx1, sm.lx2, sm.lx3))


@pytest.fixture
def table(tmp_path):
    return write_cooling_table(tmp_path / "powerlaw.cool")


def test_problem_generator_is_bitwise_the_jax_one(table):
    text = cloud_deck(table)
    tpin, jpin = ParameterInput.from_string(text), JPin.from_string(text)
    cloud.init_user_mesh_data(tpin)
    jcloud.init_user_mesh_data(jpin)
    got = cloud.problem_generator(tpin, Mesh.from_parameter_input(tpin),
                                  HydroConfig.from_parameter_input(tpin),
                                  EOS.from_parameter_input(tpin))
    want = jcloud.problem_generator(jpin, JMesh.from_parameter_input(jpin),
                                    JCfg.from_parameter_input(jpin),
                                    JEOS.from_parameter_input(jpin))
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)
    assert got[:, 9].max() > 0.0 and got[:, 5].max() > 0.0   # scalar, Bx
    # the cloud-crushing time and the wind state agree too
    tp, jp = cloud._params(tpin), jcloud._params(jpin)
    assert (tp.t_cc, tp.rho_wind, tp.mom_wind, tp.rhoe_wind, tp.Bx) == \
        (jp.t_cc, jp.rho_wind, jp.mom_wind, jp.rhoe_wind, jp.Bx)


def test_uniform_cloud_matches_jax(table, tmp_path):
    path = tmp_path / "cloud.in"
    path.write_text(cloud_deck(table) + HST_BLOCK)
    runs = {}
    for name, mod, kw in (("jax", jdriver, {}),
                          ("torch", tdriver, {"device": "cpu"})):
        out = tmp_path / name
        out.mkdir()
        with contextlib.chdir(out):
            sim = mod.run_from_file(str(path), quiet=True, **kw)
        runs[name] = (sim, np.loadtxt(next(out.glob("*.hst"))))
    (js, jh), (ts, th) = runs["jax"], runs["torch"]
    assert ts.ncycle == js.ncycle == 5
    assert ts.mesh.nghost == js.mesh.nghost == 2 and ts.mesh.nblocks == 1
    assert "cloud_inflow_x2" in ts.pkg.custom_bcs
    assert _rel(ts.u.numpy(), js.u) <= TOL
    # every cycle's time and dt are rows of the history file
    assert th.shape == jh.shape and th.shape[0] >= 6
    scale = np.maximum(np.abs(jh).max(axis=0), np.abs(jh[:, 2]).max())
    assert (np.abs(th - jh) <= TOL * scale).all()
    assert abs(ts.tm_dt - js.tm_dt) <= TOL * js.tm_dt


def test_adaptive_cloud_matches_jax(table, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ATHENAPK_SMR_FILL", "scatter")
    text = cloud_deck(table, refinement="adaptive")
    js = JSmr(JPin.from_string(text), quiet=True)
    ts = SmrSimulation(ParameterInput.from_string(text), quiet=True,
                       device="cpu")
    assert ts._problem_check is not None
    assert "cloud_inflow_x2" in ts._custom_bcs
    for a, b in zip(_table(ts._smesh_now()), _table(js._smesh_now())):
        np.testing.assert_array_equal(a, b)
    for lev, u in js.state.items():
        np.testing.assert_array_equal(ts.state[lev].numpy(), np.asarray(u))
    for k in range(1, 6):
        js.nlim = ts.nlim = k
        js.run()
        ts.run()
        assert ts.ncycle == js.ncycle == k
        for a, b in zip(_table(ts._smesh_now()), _table(js._smesh_now())):
            np.testing.assert_array_equal(a, b, err_msg=f"cycle {k}")
        assert sorted(ts.state) == sorted(js.state)
        for lev, u in js.state.items():
            assert _rel(ts.state[lev].numpy(), u) <= TOL, (k, lev)
        assert abs(ts.tm_dt - js.tm_dt) <= TOL * js.tm_dt, k
        assert abs(ts.t - js.t) <= TOL * js.t, k

    # the twin of test_cloud_deck_adaptive_inflow: the initial refinement
    # followed the cloud's scalar, the pressure stays positive, and the
    # inner-x2 ghosts of every block on that face carry the wind
    sm = ts._smesh_now()
    assert sm.max_level >= 1 and 0 < sm.level_ids[1].size < 8 * 16
    g = sm.base.nghost
    cp = cloud._params(ts.pin)
    on_face = 0
    for lev, u in ts.state.items():
        assert bool(torch.isfinite(u).all())
        _, w = cons_to_prim(ts.eos, u, ts.cfg.fluid, ts.cfg.nscalars)
        assert float(w[:, 4, g:-g, g:-g, g:-g].min()) > 0.0
        edge = [i for i, gid in enumerate(sm.level_ids[lev])
                if sm.lx2[gid] == 0]
        on_face += len(edge)
        np.testing.assert_allclose(u.numpy()[edge, 0, g:-g, :g, g:-g],
                                   cp.rho_wind, rtol=1e-12)
    assert on_face > 0
    # the refined blocks hold the cloud, whose scalar the check reads
    tags = ts._problem_check(cons_to_prim(
        ts.eos, ts.state[1], ts.cfg.fluid, 1)[1], sm.base)
    assert int(tags.max()) == 1


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_merge_keeps_ghosts_for_a_boundary_hook(package, monkeypatch):
    """An all-periodic deck merges into one ghost-free block, unless its
    problem registers boundary conditions: then both packages keep the
    ghosts (``athenapk_tpu/driver.py:286-296``)."""
    from athenapk_tpu.pgen import get_pgen as jget
    from athenapk_tpu_torch.pgen import get_pgen as tget
    text = deck("kh", riemann="hllc", nx=(16, 16, 1), merge="true",
                extra=KH.format(2))
    pgen, sim, pin = ((jget("kh"), JSim, JPin) if package == "jax"
                      else (tget("kh"), Simulation, ParameterInput))
    kw = {} if package == "jax" else {"device": "cpu"}
    assert sim(pin.from_string(text), quiet=True, **kw).mesh.nghost == 0
    monkeypatch.setattr(pgen, "register_boundary_conditions",
                        lambda *a: {}, raising=False)
    merged = sim(pin.from_string(text), quiet=True, **kw).mesh
    assert merged.nghost == 2 and merged.nblocks == 1
