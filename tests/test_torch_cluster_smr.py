"""Port parity: the galaxy-cluster problem on static refined meshes
(``SmrSimulation`` with the cluster's ``problem_generator_smr`` and its
``_smr`` source hooks), on the CPU in f64.

* twins of ``tests/test_cluster_smr.py``: the HSE atmosphere stays static
  across a level boundary (``:47``), the COLD_GAS accretion is exactly
  volume-weighted across levels (``:75``), and the perturbations of a
  fully refined mesh equal the uniform mesh's at 2x, normalised by the
  volume-weighted rms over all levels on a mixed mesh (``:222``);
* the initial state of ``problem_generator_smr`` (one HSE profile at the
  finest dx, the perturbations over all levels) against the JAX
  package's, and 3 cycles of ``torch_decks.cluster_deck`` (every source
  on, Townsend cooling; base 16^3 over +-0.02 Mpc in 8^3 blocks, the
  octant x, y, z > 0 at level 1, 15 leaves) against the JAX package's
  ``SmrSimulation``, on the stage-faces and the negdiv-faces rung: every
  variable of every level to 1e-12 relative to its largest value, every
  dt;
* a stand-in for the slow reference-deck test (``:150``, which reads the
  reference's ``cluster.in``): the cluster deck with three levels (two
  nested regions, as the reference deck's), 2 cycles, finite, with the
  accretion region and the jet on the finest level.
"""

import contextlib

import numpy as np
import pytest
import torch

from athenapk_tpu.amr.driver import SmrSimulation as JSmr
from athenapk_tpu.amr.smr import SmrMesh as JSmrMesh
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.eos.adiabatic import EOS as JEOS
from athenapk_tpu.pgen.cluster import pgen as jcl
from athenapk_tpu.solver.hydro_pkg import HydroConfig as JCfg
from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.amr.smr import SmrMesh, smr_regions_from_deck
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.indices import (IB1, IB3, IDN, IEN, IM1, IM2,
                                             IM3, IPR, IV1, IV2, IV3)
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation
from athenapk_tpu_torch.eos.adiabatic import EOS, cons_to_prim
from athenapk_tpu_torch.pgen.cluster import pgen as tcl
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig
from test_agn_feedback import BASE
from test_cluster_smr import SMR_HSE_DECK
from torch_decks import cluster_deck, write_cluster_table

torch.set_num_threads(2)

TOL = 1e-12
OCTANT = (0.0, 0.02, 0.0, 0.02, 0.0, 0.02, 1)
PERTURB = """
<hydro>
fluid = glmmhd

<parthenon/time>
nlim = 0

<problem/cluster/init_perturb>
sigma_v = 7.5e-2
l_peak_v = 0.5
num_modes_v = 10
sol_weight_v = 1.0
rseed_v = 3
sigma_b = 2.5e-3
k_peak_b = 4.0
num_modes_b = 10
rseed_b = 4
"""


def _rel_per_var(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return max(float(np.abs(got[:, v] - want[:, v]).max()
                     / np.abs(want[:, v]).max())
               for v in range(want.shape[1]) if np.abs(want[:, v]).max() > 0)


def _interior(a, g):
    return a[:, :, g:-g, g:-g, g:-g]


# ------------------------------------------------------------ the twins
def test_hse_stays_static_on_smr(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sim = SmrSimulation(ParameterInput.from_string(SMR_HSE_DECK), quiet=True,
                        device="cpu")
    g = sim.smesh.base.nghost
    w0 = {lev: cons_to_prim(sim.eos, u, "euler", 0)[1].numpy()
          for lev, u in sim.state.items()}
    sim.run()
    w1 = {lev: cons_to_prim(sim.eos, u, "euler", 0)[1].numpy()
          for lev, u in sim.state.items()}
    assert set(w1) == {0, 1}, "expected a two-level mesh"
    for lev in w1:
        a, b = _interior(w0[lev], g), _interior(w1[lev], g)
        cs0 = np.sqrt(sim.eos.gamma * a[:, IPR] / a[:, IDN])
        mach = np.abs(b[:, [IV1, IV2, IV3]]).max() / cs0.min()
        assert mach < 2e-2, f"level {lev}: HSE developed Mach {mach:.2e}"
        drho = np.abs((b[:, IDN] - a[:, IDN]) / a[:, IDN])
        assert drho.mean() < 2e-3, f"level {lev}: drift {drho.mean():.2e}"


def test_cold_gas_accretion_volume_weighted():
    deck = SMR_HSE_DECK + """
<problem/cluster/uniform_gas>
init_uniform_gas = true
rho = 100.0
ux = 0.0
uy = 0.0
uz = 0.0
pres = 1.5

<problem/cluster/agn_triggering>
triggering_mode = COLD_GAS
accretion_radius = 0.08
cold_temp_thresh = 1.0e30
cold_t_acc = 0.1

<problem/cluster/agn_feedback>
efficiency = 0.0
fixed_power = 0.0
thermal_fraction = 0.0
kinetic_fraction = 0.0
magnetic_fraction = 0.0
"""
    pin = ParameterInput.from_string(deck)
    pin.set("problem/cluster/gravity", "gravity_srcterm", False)
    sim = SmrSimulation(pin, quiet=True, device="cpu")
    sm = sim.smesh
    g = sm.base.nghost
    r_acc, rho0 = 0.08, 100.0
    v_counted, n_by_level = 0.0, {}
    for gid in range(sm.levels.size):
        lev = int(sm.levels[gid])
        x, y, z = sm.cell_centers_leaf(gid)
        r = np.sqrt(np.broadcast_to(x ** 2 + y ** 2 + z ** 2,
                                    sm.base.block_shape))
        inside = r[g:-g, g:-g, g:-g] < r_acc
        d1, d2, d3 = sm.dx(lev)
        v_counted += inside.sum() * d1 * d2 * d3
        n_by_level[lev] = n_by_level.get(lev, 0) + inside.sum()
    assert len(n_by_level) == 2 and all(n > 0 for n in n_by_level.values())
    src = tcl.problem_source_unsplit_smr(pin, sm, sim.cfg, sim.eos)
    prims = {lev: cons_to_prim(sim.eos, u, "euler", 0)[1]
             for lev, u in sim.state.items()}
    beta_dt = 1.0e-4
    state2 = src(dict(sim.state), prims, beta_dt, 0.0)

    def total_mass(state):
        return sum(float(_interior(u.numpy(), g)[:, IDN].sum())
                   * np.prod(sm.dx(lev)) for lev, u in state.items())

    removed = total_mass(sim.state) - total_mass(state2)
    np.testing.assert_allclose(removed, rho0 * v_counted / 0.1 * beta_dt,
                               rtol=1e-10)


def _smr_perturb_deck(region):
    return BASE.replace("""<parthenon/mesh>
nghost = 2
nx1 = 32""", """<parthenon/mesh>
refinement = static
nghost = 2
nx1 = 16""").replace("nx2 = 32\nx2min", "nx2 = 16\nx2min").replace(
        "nx3 = 32\nx3min", "nx3 = 16\nx3min").replace(
        "<parthenon/meshblock>\nnx1 = 32\nnx2 = 32\nnx3 = 32",
        "<parthenon/meshblock>\nnx1 = 8\nnx2 = 8\nnx3 = 8") + (
        "\n<parthenon/static_refinement0>\n" + "".join(
            f"x{d}min = {region[0]}\nx{d}max = {region[1]}\n"
            for d in (1, 2, 3)) + "level = 1\n") + PERTURB


def test_init_perturb_smr_matches_uniform_at_2x():
    sigma_v, sigma_b = 7.5e-2, 2.5e-3
    sim_u = Simulation(ParameterInput.from_string(BASE + PERTURB),
                       quiet=True, device="cpu")
    glob_u = sim_u.cons()[sim_u.mesh.interior_slices][0]
    sim_s = SmrSimulation(ParameterInput.from_string(
        _smr_perturb_deck((-0.5, 0.5))), quiet=True, device="cpu")
    sm = sim_s.smesh
    assert set(sim_s.state) == {1}, "expected a fully refined mesh"
    st = sim_s.state[1].numpy()
    gb, mb = sm.base.nghost, sm.base.mbnx1
    glob_s = np.empty_like(glob_u)
    for li, gid in enumerate(sm.level_ids[1]):
        ox, oy, oz = (int(a[gid]) * mb for a in (sm.lx1, sm.lx2, sm.lx3))
        glob_s[:, oz:oz + mb, oy:oy + mb, ox:ox + mb] = \
            st[li, :, gb:-gb, gb:-gb, gb:-gb]
    for c in (IM1, IM2, IM3, IB1, IB1 + 1, IB3, IEN):
        scale = np.abs(glob_u[c]).max()
        np.testing.assert_allclose(glob_s[c], glob_u[c], rtol=0,
                                   atol=1e-9 * scale, err_msg=f"var {c}")
    # a mixed-level mesh: the rms is volume-weighted across levels
    sim_m = SmrSimulation(ParameterInput.from_string(
        _smr_perturb_deck((-0.45, -0.05))), quiet=True, device="cpu")
    assert set(sim_m.state) == {0, 1}
    v2_sum = b2_sum = 0.0
    for lev, u in sim_m.state.items():
        ui = _interior(u.numpy(), gb)
        vol = np.prod(sim_m.smesh.dx(lev))
        rho = ui[:, IDN]
        v2_sum += float(((ui[:, IM1:IM3 + 1] / rho[:, None]) ** 2).sum()) \
            * vol
        b2_sum += float((ui[:, IB1:IB3 + 1] ** 2).sum()) * vol
    assert abs(np.sqrt(v2_sum) - sigma_v) / sigma_v < 1e-12
    assert abs(np.sqrt(b2_sum) - sigma_b) / sigma_b < 1e-12


# ---------------------------------------------------- against the JAX package
def test_problem_generator_smr_matches_jax():
    text = cluster_deck(n=16, mb=8, half=0.02, refinement="static",
                        regions=[OCTANT])
    tpin, jpin = ParameterInput.from_string(text), JPin.from_string(text)
    tbase, jbase = (Mesh.from_parameter_input(tpin),
                    JMesh.from_parameter_input(jpin))
    regions = smr_regions_from_deck(tpin)
    tsm, jsm = SmrMesh(tbase, regions), JSmrMesh(jbase, regions)
    got = tcl.problem_generator_smr(tpin, tsm,
                                    HydroConfig.from_parameter_input(tpin),
                                    EOS.from_parameter_input(tpin))
    want = jcl.problem_generator_smr(jpin, jsm,
                                     JCfg.from_parameter_input(jpin),
                                     JEOS.from_parameter_input(jpin))
    assert sorted(got) == sorted(want) == [0, 1]
    for lev in want:
        assert got[lev].dtype == np.float64
        assert _rel_per_var(got[lev], np.asarray(want[lev])) <= TOL


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cluster_smr")
    text = cluster_deck(n=16, mb=8, half=0.02, nlim=3, refinement="static",
                        regions=[OCTANT], table=write_cluster_table(
                            root / "cluster.cool"))
    js = JSmr(JPin.from_string(text), quiet=True)
    dts = []
    for k in range(1, 4):
        js.nlim = k
        with contextlib.chdir(root):
            js.run()
        dts.append(js.tm_dt)
    return text, js, dts


@pytest.mark.parametrize("rung", ["stage", "negdiv"])
def test_refined_cluster_matches_jax(jax_run, rung, tmp_path, monkeypatch):
    text, js, jdts = jax_run
    monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "1" if rung == "stage"
                       else "0")
    monkeypatch.chdir(tmp_path)
    ts = SmrSimulation(ParameterInput.from_string(text), quiet=True,
                       device="cpu")
    assert ts._split_loop()
    st = ts._stepper_now()
    assert st.problem_source_unsplit is not None
    assert st.problem_source_first_order is not None
    dts = []
    for k in range(1, 4):
        ts.nlim = k
        ts.run()
        dts.append(ts.tm_dt)
    assert ts.ncycle == js.ncycle == 3
    np.testing.assert_allclose(dts, jdts, rtol=TOL)
    assert sorted(ts.state) == sorted(js.state) == [0, 1]
    for lev, u in js.state.items():
        assert _rel_per_var(ts.state[lev].numpy(), np.asarray(u)) <= TOL, lev
    # the AGN tracer reached the scalar on the finest level
    assert float(ts.state[1][:, 9].max()) > 0.0


def test_three_level_cluster_deck_runs(tmp_path, monkeypatch):
    """The small-size stand-in for ``test_cluster_smr.py:test_reference_
    cluster_deck_runs``: three levels (base 32^3 over +-0.04 Mpc in 8^3
    blocks, +-0.01 at level 1, +-0.005 at level 2), GLM-MHD, cooling and
    the whole AGN subsystem, 2 cycles, finite, mass positive."""
    monkeypatch.chdir(tmp_path)
    text = cluster_deck(n=32, mb=8, half=0.04, nlim=2, refinement="static",
                        regions=[(0.01, 1), (0.005, 2)],
                        table=write_cluster_table(tmp_path / "c.cool"))
    sim = SmrSimulation(ParameterInput.from_string(text), quiet=True,
                        device="cpu")
    assert {lev: ids.size for lev, ids in sim.smesh.level_ids.items()} == \
        {0: 56, 1: 56, 2: 64}
    sim.run()
    assert sim.ncycle == 2
    for lev, u in sim.state.items():
        assert bool(torch.isfinite(u).all()), f"level {lev} not finite"
        assert float(u[:, IDN].min()) > 0.0
    assert float(sim.state[2][:, 9].max()) > 0.0
