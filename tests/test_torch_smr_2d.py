"""Port parity: 2-D and 1-D refined meshes and GLM-MHD on a refined mesh,
against the JAX package on the CPU in f64.

* The 2-D blast of ``tests/test_smr_2d.py:286-302`` (32^2, meshblock 8,
  HLLC + PLM) and 1-D Sod of ``:210`` (64 cells, meshblock 16) through
  ``SmrSimulation`` for 5 cycles: per-level state, dt and ``.hst`` to 1e-12
  relative.  The port runs both through the -div(F)-with-faces function
  (two directions, one), the JAX package its XLA path.
* GLM-MHD (``tests/test_smr.py:194``): ``SmrHydro.step`` against the JAX
  package's on a magnetised blob, on both rungs of the port; a uniform
  magnetised flow stays uniform and mass is conserved to 1e-13.
* Twin of ``test_2d_smr_uniform_state_stays_uniform``: a constant state on
  a mixed-level 2-D mesh stays bit-constant, ghosts included.
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu.amr.driver import SmrSimulation as JSim
from athenapk_tpu.amr.smr import SmrMesh as JSmrMesh
from athenapk_tpu.amr.smr_hydro import SmrHydro as JSmrHydro
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.eos.adiabatic import EOS as JEOS
from athenapk_tpu.solver.hydro_pkg import HydroConfig as JCfg
from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.amr.smr import SmrMesh
from athenapk_tpu_torch.amr.smr_hydro import SmrHydro
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.eos.adiabatic import EOS, prim_to_cons
from torch_decks import HST_BLOCK, SMR_1D, SMR_2D, symmetry_noise

torch.set_num_threads(2)

TOL = 1e-12
DECKS = {
    "blast_2d": SMR_2D.format(n=32, mb=8, tlim=0.02, nlim=5,
                              precision="double") + HST_BLOCK,
    "sod_1d": SMR_1D.format(n=64, mb=16, nlim=5) + HST_BLOCK,
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("case", sorted(DECKS))
def test_five_cycles_match_jax(case, tmp_path, monkeypatch):
    deck = DECKS[case]
    monkeypatch.chdir(tmp_path)
    jsim = JSim(JPin.from_string(deck), quiet=True)
    start = symmetry_noise({lev: np.asarray(u)
                            for lev, u in jsim.state.items()}, seed=2)
    jsim.state = {lev: jnp.asarray(v) for lev, v in start.items()}
    os.makedirs("jax")
    os.chdir("jax")
    jsim.run()
    os.chdir("..")
    sim = SmrSimulation(ParameterInput.from_string(deck), quiet=True,
                        device="cpu")
    assert not sim.stepper._stage_rung
    assert set(sim.smesh.level_ids) == {0, 1}
    sim.load_state(start, 0.0, 0)
    sim.run()
    assert sim.ncycle == jsim.ncycle == 5
    for lev in jsim.state:
        assert _rel(sim.state[lev].numpy(), jsim.state[lev]) <= TOL
    hst, want = np.loadtxt("blast.out0.hst" if "blast" in case
                           else "sod.out0.hst"), \
        np.loadtxt(os.path.join("jax", "blast.out0.hst" if "blast" in case
                                else "sod.out0.hst"))
    assert hst.shape == want.shape == (6, 8)
    scale = np.abs(want[:, 2:]).max()
    for col in range(hst.shape[1]):
        diff = np.abs(hst[:, col] - want[:, col]).max()
        assert diff <= TOL * max(np.abs(want[:, col]).max(),
                                 scale if col >= 2 else 0.0), col


def _glm(mesh_cls, smr_cls, eos_cls):
    base = mesh_cls(nx1=16, nx2=16, nx3=16, mbnx1=8, mbnx2=8, mbnx3=8,
                    x1min=0, x1max=1, x2min=0, x2max=1, x3min=0, x3max=1,
                    nghost=3)
    return smr_cls(base, [(0.5, 1.0, 0.5, 1.0, 0.5, 1.0, 1)]), \
        eos_cls(gamma=5.0 / 3.0)


def _glm_prim(sm, perturb, seed=4):
    """Magnetised flow along x (the state of ``tests/test_smr.py:194``);
    ``perturb`` adds the density blob and seeded noise."""
    rng = np.random.default_rng(seed)
    state = {}
    for lev, ids in sm.level_ids.items():
        w = np.zeros((len(ids), 9) + sm.base.block_shape)
        w[:, 0] = 1.0
        w[:, 1] = 0.5
        w[:, 4] = 1.0
        w[:, 5] = 0.3
        w[:, 6] = 0.2
        if perturb:
            for li, gid in enumerate(ids):
                x, y, z = sm.cell_centers_leaf(gid)
                r2 = (x - 0.3) ** 2 + (y - 0.3) ** 2 + (z - 0.3) ** 2
                w[li, 0] += np.broadcast_to(0.3 * np.exp(-r2 / 0.01),
                                            sm.base.block_shape)
            w[:, 1:4] += 1e-3 * rng.standard_normal(w[:, 1:4].shape)
        state[lev] = w
    return state


@pytest.mark.parametrize("rung", ["stage", "negdiv"])
def test_glmmhd_steps_match_jax(rung, monkeypatch):
    if rung == "negdiv":
        monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "0")
    else:
        monkeypatch.delenv("ATHENAPK_PALLAS_STAGE", raising=False)
    cfg = dict(fluid="glmmhd", riemann="hlld", reconstruction="plm",
               integrator="vl2")
    sm, eos = _glm(Mesh, SmrMesh, EOS)
    jsm, jeos = _glm(JMesh, JSmrMesh, JEOS)
    from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig
    th = SmrHydro(sm, HydroConfig(**cfg), eos, device="cpu")
    assert th._stage_rung == (rung == "stage")
    jh = JSmrHydro(jsm, JCfg(**cfg), jeos)
    dt = 0.002
    c_h = 0.3 * min(sm.dx(sm.max_level)) / dt
    # uniform magnetised flow stays uniform (psi damping included)
    u = th.fill_ghosts({lev: prim_to_cons(eos, torch.tensor(w), "glmmhd")
                        for lev, w in _glm_prim(sm, False).items()})
    ref = {lev: v.clone() for lev, v in u.items()}
    for _ in range(3):
        u = th.step(u, dt, c_h)
    isl = sm.base.interior_slices
    for lev in u:
        np.testing.assert_allclose(u[lev][isl].numpy(), ref[lev][isl].numpy(),
                                   rtol=0, atol=1e-13)
    # the perturbed run: parity with the JAX package and mass
    u = th.fill_ghosts({lev: prim_to_cons(eos, torch.tensor(w), "glmmhd")
                        for lev, w in _glm_prim(sm, True).items()})
    ju = {lev: jnp.asarray(v.numpy()) for lev, v in u.items()}
    m0 = th.total_mass(u)
    for _ in range(4):
        u = th.step(u, dt, c_h)
        ju = jh.step(ju, dt, jnp.asarray(c_h))
    for lev in u:
        assert _rel(u[lev].numpy(), ju[lev]) <= TOL
    assert abs(th.total_mass(u) - m0) / m0 < 1e-13
    assert all(bool(torch.isfinite(v).all()) for v in u.values())


def test_2d_uniform_state_stays_uniform(tmp_path, monkeypatch):
    """Twin of ``tests/test_smr_2d.py::test_2d_smr_uniform_state_stays_
    uniform``: constant advected gas on a mixed-level 2-D mesh."""
    monkeypatch.chdir(tmp_path)
    deck = SMR_2D.format(n=16, mb=8, tlim=1.0, nlim=4, precision="double")
    deck = deck.replace("problem_id = blast", "problem_id = advection") \
        .replace("<problem/blast>\npressure_ratio = 100.0\n"
                 "radius_outer = 0.15\n",
                 "<problem/advection>\nvx = 1.0\nvy = 0.5\nrho_ratio = 0.0\n"
                 "rho_radius = 0.0\nrho0 = 1.0\np0 = 1.0\n")
    sim = SmrSimulation(ParameterInput.from_string(deck, [
        "parthenon/mesh/x1min=0.0", "parthenon/mesh/x1max=1.0",
        "parthenon/mesh/x2min=0.0", "parthenon/mesh/x2max=1.0",
        "parthenon/static_refinement0/x1min=0.0",
        "parthenon/static_refinement0/x1max=0.5",
        "parthenon/static_refinement0/x2min=0.0",
        "parthenon/static_refinement0/x2max=0.5"]), quiet=True, device="cpu")
    assert set(sim.smesh.level_ids) == {0, 1}
    start = {lev: u.clone() for lev, u in sim.state.items()}
    sim.run()
    assert sim.ncycle == 4
    for lev, u in sim.state.items():
        assert torch.equal(u, start[lev])      # ghosts included
        np.testing.assert_allclose(u[:, 0].numpy(), 1.0, rtol=1e-13)
        np.testing.assert_allclose(u[:, 1].numpy(), 1.0, rtol=1e-12)
