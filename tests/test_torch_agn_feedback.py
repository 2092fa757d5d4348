"""Port parity: the cluster's sources (``pgen/cluster/``: gravity, AGN
feedback and triggering, the magnetic tower, SN Ia, stellar feedback, the
clips) on a uniform mesh, on the CPU in f64.

* twins of the 11 tests of ``tests/test_agn_feedback.py`` (the thermal
  and kinetic accounting, the tower's initial field and its power, the
  boosted Bondi rate and mass removal, SN Ia, stellar feedback, the
  accretion dt, the AGN tracer and ``agn_extent``, the tower-mass toggle,
  Booth-Schaye), each with the port's ``Simulation`` (the decks are
  all-periodic: the port merges them into one ghost-free block, where the
  JAX tests run one ghosted block);
* one case per source against the JAX package's hook on the same state
  (a 16^3 block with ghosts over +-0.02 Mpc, every variable made from a
  numpy seed so that each threshold and ceiling splits the cells): the
  unsplit source with only that channel on (gravity, thermal, kinetic with
  the tracer and a precessing jet, the tower with its mass, each
  triggering mode with the thermal dump, SN Ia), the split source
  (stellar feedback, the clips) and the accretion dt of the Bondi modes:
  1e-12 relative to each variable's largest value.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.eos.adiabatic import EOS as JEOS
from athenapk_tpu.pgen.cluster import pgen as jcl
from athenapk_tpu.solver.hydro_pkg import HydroConfig as JCfg
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.indices import (IB1, IB2, IB3, IDN, IEN, IM1,
                                             IM3)
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation
from athenapk_tpu_torch.eos.adiabatic import EOS
from athenapk_tpu_torch.pgen.cluster import pgen as tcl
from athenapk_tpu_torch.pgen.cluster.agn_triggering import AGNTriggering
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig
from athenapk_tpu_torch.utils.units import Units
from test_agn_feedback import BASE, _interior_centers, _totals

torch.set_num_threads(2)

TOL = 1e-12


def _sim(extra):
    return Simulation(ParameterInput.from_string(BASE + extra), quiet=True,
                      device="cpu")


def _c2(pin_text):
    return Units(ParameterInput.from_string(pin_text)).speed_of_light() ** 2


# ---------------------------------------------------------------- twins
def test_thermal_feedback_accounting():
    P, eff, r_th = 1e-2, 1e-3, 0.2
    sim = _sim(f"""
<hydro>
fluid = euler

<parthenon/time>
nlim = 12

<problem/cluster/agn_feedback>
fixed_power = {P}
efficiency = {eff}
thermal_fraction = 1.0
kinetic_fraction = 0.0
magnetic_fraction = 0.0
thermal_radius = {r_th}
""")
    m0, e0, p0, _ = _totals(sim)
    sim.run()
    m1, e1, p1, _ = _totals(sim)
    x, y, z = _interior_centers(sim)
    n_in = int((x ** 2 + y ** 2 + z ** 2 <= r_th ** 2).sum())
    vfac = n_in * sim.mesh.cell_volume / (4.0 / 3.0 * math.pi * r_th ** 3)
    de_exp = P * sim.t * vfac
    dm_exp = P / (eff * _c2(BASE)) * sim.t * vfac
    assert abs((e1 - e0) - de_exp) / de_exp < 2e-3
    assert abs((m1 - m0) - dm_exp) / dm_exp < 1e-6
    assert np.abs(p1 - p0).max() < 1e-10


def test_kinetic_feedback_accounting():
    P, eff = 1e-3, 1e-3
    rj, thick, off = 0.2, 0.125, 0.0625
    sim = _sim(f"""
<hydro>
fluid = euler

<parthenon/time>
nlim = 12

<problem/cluster/agn_feedback>
fixed_power = {P}
efficiency = {eff}
thermal_fraction = 0.0
kinetic_fraction = 1.0
magnetic_fraction = 0.0
kinetic_jet_radius = {rj}
kinetic_jet_thickness = {thick}
kinetic_jet_offset = {off}
""")
    m0, e0, p0, _ = _totals(sim)
    sim.run()
    m1, e1, p1, _ = _totals(sim)
    x, y, z = _interior_centers(sim)
    in_jet = ((np.sqrt(x ** 2 + y ** 2) < rj) & (np.abs(z) >= off)
              & (np.abs(z) <= off + thick))
    vfac = (int(in_jet.sum()) * sim.mesh.cell_volume
            / (2.0 * thick * math.pi * rj ** 2))
    de_exp = P * sim.t * vfac
    dm_exp = P / (eff * _c2(BASE)) * sim.t * vfac
    assert abs((e1 - e0) - de_exp) / de_exp < 2e-3
    assert abs((m1 - m0) - dm_exp) / dm_exp < 1e-6
    assert np.abs(p1 - p0).max() < 1e-10


def test_magnetic_tower_initial_field_matches_analytic():
    B0, alpha, ls = 1e-3, 2.5, 0.15
    sim = _sim(f"""
<hydro>
fluid = glmmhd

<parthenon/time>
nlim = 0

<problem/cluster/magnetic_tower>
potential_type = li
li_alpha = {alpha}
l_scale = {ls}
initial_field = {B0}
""")
    u = sim.cons()[sim.mesh.interior_slices]
    x, y, z = _interior_centers(sim)
    r = np.sqrt(x ** 2 + y ** 2)
    rl, hl = r / ls, z / ls
    ex = np.exp(-rl ** 2 - hl ** 2)
    b_r, b_th, b_h = 2.0 * hl * rl * ex, alpha * rl * ex, \
        2.0 * (1.0 - rl ** 2) * ex
    with np.errstate(invalid="ignore", divide="ignore"):
        cth = np.where(r > 0, x / np.where(r > 0, r, 1.0), 0.0)
        sth = np.where(r > 0, y / np.where(r > 0, r, 1.0), 0.0)
    want = np.stack([B0 * (b_r * cth - b_th * sth),
                     B0 * (b_r * sth + b_th * cth), B0 * b_h])
    got = np.stack([u[:, IB1], u[:, IB2], u[:, IB3]])
    scale = np.abs(want).max()
    assert scale > 0.5 * B0
    assert np.abs(got - want).max() / scale < 1e-12
    eint = u[:, IEN] - 0.5 * (got ** 2).sum(axis=0)
    assert np.abs(eint - 1.0 / (5.0 / 3.0 - 1.0)).max() < 1e-12


def test_magnetic_tower_power_accounting():
    P = 1e-4
    sim = _sim(f"""
<hydro>
fluid = glmmhd

<parthenon/time>
nlim = 10

<problem/cluster/agn_feedback>
fixed_power = {P}
efficiency = 1e-3
thermal_fraction = 0.0
kinetic_fraction = 0.0
magnetic_fraction = 1.0

<problem/cluster/magnetic_tower>
potential_type = li
li_alpha = 2.5
l_scale = 0.15
initial_field = 0.0
""")
    m0, e0, _, me0 = _totals(sim)
    sim.run()
    m1, e1, _, me1 = _totals(sim)
    assert sim.t > 0
    dme_exp = P * sim.t
    assert abs((me1 - me0) - dme_exp) / dme_exp < 5e-2
    assert abs((e1 - e0) - dme_exp) / dme_exp < 5e-2


def test_boosted_bondi_rate_and_mass_removal():
    alpha, m_smbh, r_acc, eff, r_th = 100.0, 1e-2, 0.2, 1e-6, 0.2
    sim = _sim(f"""
<hydro>
fluid = euler

<parthenon/time>
nlim = 10

<problem/cluster/gravity>
m_smbh = {m_smbh}

<problem/cluster/agn_triggering>
triggering_mode = BOOSTED_BONDI
accretion_radius = {r_acc}
bondi_alpha = {alpha}

<problem/cluster/agn_feedback>
fixed_power = 0.0
efficiency = {eff}
thermal_fraction = 1.0
kinetic_fraction = 0.0
magnetic_fraction = 0.0
thermal_radius = {r_th}
""")
    m0 = _totals(sim)[0]
    sim.run()
    m1 = _totals(sim)[0]
    G = Units(sim.pin).gravitational_constant()
    mdot = alpha * 2.0 * math.pi * G ** 2 * m_smbh ** 2 / (5.0 / 3.0) ** 1.5
    x, y, z = _interior_centers(sim)
    n_in = int((x ** 2 + y ** 2 + z ** 2 <= r_th ** 2).sum())
    vfac = n_in * sim.mesh.cell_volume / (4.0 / 3.0 * math.pi * r_th ** 3)
    dm_exp = mdot * sim.t * ((1.0 - eff) * vfac - 1.0)
    assert abs((m1 - m0) - dm_exp) / (mdot * sim.t) < 2e-2


def test_snia_feedback_accounting():
    P_m, M_m = 1e-3, 1e-4
    m_bcg, r_bcg = 7.5e-4, 4e-3
    sim = _sim(f"""
<hydro>
fluid = euler

<parthenon/time>
nlim = 8

<problem/cluster/gravity>
which_bcg_g = HERNQUIST
gravity_srcterm = false
m_bcg_s = {m_bcg}
r_bcg_s = {r_bcg}

<problem/cluster/snia_feedback>
power_per_bcg_mass = {P_m}
mass_rate_per_bcg_mass = {M_m}
""")
    m0, e0, _, _ = _totals(sim)
    sim.run()
    m1, e1, _, _ = _totals(sim)
    x, y, z = _interior_centers(sim)
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    s = (m_bcg * r_bcg / (2.0 * math.pi * r * (r + r_bcg) ** 3)).sum() \
        * sim.mesh.cell_volume
    assert abs((m1 - m0) - M_m * sim.t * s) / (M_m * sim.t * s) < 1e-8
    assert abs((e1 - e0) - P_m * sim.t * s) / (P_m * sim.t * s) < 2e-3


def test_stellar_feedback_accounting():
    un = Units(ParameterInput.from_string(BASE))
    mu = 1.0 / (0.25 * 3.0 / 4.0 + 0.75 * 2.0)
    mbar = mu * un.mh()
    mbar_over_kb = mbar / un.k_boltzmann()
    n_th, t_th = 0.9 / mbar, 2.0 * mbar_over_kb
    eff, r_st, r_ex = 1e-4, 0.3, 0.1
    sim = _sim(f"""
<hydro>
fluid = euler

<parthenon/time>
nlim = 1

<problem/cluster/stellar_feedback>
stellar_radius = {r_st}
exclusion_radius = {r_ex}
efficiency = {eff}
number_density_threshold = {n_th}
temperature_threshold = {t_th}
""")
    m0, e0, _, _ = _totals(sim)
    sim.run()
    m1, e1, _, _ = _totals(sim)
    x, y, z = _interior_centers(sim)
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    sel = (r <= r_st) & (r > r_ex)
    dm_exp = (n_th * mbar - 1.0) * sel.sum() * sim.mesh.cell_volume
    de_exp = (1.0 / (2.0 / 3.0) - eff * un.speed_of_light() ** 2) * dm_exp
    assert dm_exp < 0 and de_exp > 0
    assert abs((m1 - m0) - dm_exp) / abs(dm_exp) < 1e-4
    assert abs((e1 - e0) - de_exp) / abs(de_exp) < 1e-3


def test_accretion_dt_constraint():
    cap = 1e-5
    sim = _sim(f"""
<hydro>
fluid = euler

<parthenon/time>
nlim = 2

<problem/cluster/agn_triggering>
triggering_mode = COLD_GAS
accretion_radius = 0.2
cold_temp_thresh = 1e12
cold_t_acc = {cap / 0.1}
accretion_cfl = 0.1

<problem/cluster/agn_feedback>
efficiency = 1e-3
thermal_fraction = 1.0
thermal_radius = 0.2
""")
    sim.run()
    assert sim.ncycle == 2
    assert abs(sim.t - 2 * cap) / (2 * cap) < 1e-12
    # the Bondi mode: the cap formula, a 0-d tensor on the state's device
    sim2 = _sim("""
<hydro>
fluid = euler

<parthenon/time>
nlim = 1

<problem/cluster/gravity>
m_smbh = 1e-2

<problem/cluster/agn_triggering>
triggering_mode = BOOSTED_BONDI
accretion_radius = 0.2
bondi_alpha = 100.0
accretion_cfl = 0.25
""")
    _, prim = sim2.pkg.cons_to_prim(sim2.u)
    got = tcl.estimate_timestep(sim2.pin, sim2.mesh, sim2.cfg, sim2.eos,
                                prim, 0.0)
    assert torch.is_tensor(got) and got.dim() == 0
    G = Units(sim2.pin).gravitational_constant()
    mdot = 100.0 * 2.0 * math.pi * G ** 2 * 1e-4 / math.sqrt(5.0 / 3.0) ** 3
    x, y, z = _interior_centers(sim2)
    m_reg = float(((x ** 2 + y ** 2 + z ** 2) < 0.04).sum()
                  * sim2.mesh.cell_volume)
    want = 0.25 * m_reg / mdot
    assert abs(float(got) - want) / want < 1e-10
    # and it caps the driver's dt, read with the CFL minimum
    assert sim2._estimate()[0] == pytest.approx(min(want, sim2._estimate()[1]),
                                                rel=1e-10)


def test_agn_tracer_injection_and_extent():
    rj, thick, off = 0.2, 0.125, 0.0625
    sim = _sim(f"""
<hydro>
fluid = euler
nscalars = 1

<parthenon/time>
nlim = 4

<problem/cluster/agn_feedback>
fixed_power = 1e-3
efficiency = 1e-3
thermal_fraction = 0.0
kinetic_fraction = 1.0
magnetic_fraction = 0.0
kinetic_jet_radius = {rj}
kinetic_jet_thickness = {thick}
kinetic_jet_offset = {off}
enable_tracer = true

<problem/cluster/reductions>
agn_tracer_thresh = 0.01
""")
    sim.run()
    ui = sim.cons()[sim.mesh.interior_slices]
    conc = ui[:, 5] / ui[:, 0]
    x, y, z = _interior_centers(sim)
    in_jet = ((np.sqrt(x ** 2 + y ** 2) < rj) & (np.abs(z) >= off)
              & (np.abs(z) <= off + thick))
    assert conc[in_jet].min() > 0.99
    assert conc[~in_jet].max() < 0.99
    cols = dict(tcl.history_columns(sim.pin, sim.mesh, sim.cfg, sim.eos))
    _, w = sim.pkg.cons_to_prim(sim.u)
    ext = cols["agn_extent"](sim.u, w, sim.mesh)
    r_jet_max = math.sqrt(rj ** 2 + (off + thick) ** 2)
    assert 0.5 * (off + thick) < ext < 1.5 * r_jet_max


def test_tower_mass_injection_toggle():
    pin = ParameterInput.from_string(BASE + """
<hydro>
fluid = glmmhd

<problem/cluster/agn_feedback>
fixed_power = 1e-3
thermal_fraction = 0.25
kinetic_fraction = 0.25
magnetic_fraction = 0.5
enable_magnetic_tower_mass_injection = false
""")
    fb = tcl._pkg(pin).agn_feedback
    assert abs(fb.thermal_fraction - 0.25) < 1e-14
    assert abs(fb.magnetic_fraction - 0.5) < 1e-14
    assert abs(fb.thermal_mass_fraction - 0.5) < 1e-14
    assert abs(fb.kinetic_mass_fraction - 0.5) < 1e-14
    assert fb.magnetic_mass_fraction == 0.0


def test_booth_schaye_boost():
    pin = ParameterInput.from_string(BASE + """
<hydro>
fluid = euler

<problem/cluster/gravity>
m_smbh = 1e-2

<problem/cluster/agn_triggering>
triggering_mode = BOOTH_SCHAYE
accretion_radius = 0.2
bondi_n0 = 0.5
bondi_beta = 2.0
""")
    un = Units(pin)
    mu = 1.0 / (0.25 * 3.0 / 4.0 + 0.75 * 2.0)
    mbar_over_kb = mu * un.mh() / un.k_boltzmann()
    trig = AGNTriggering(pin, un, mbar_over_kb, 5.0 / 3.0)
    cs = math.sqrt(5.0 / 3.0)
    n = 1.0 / (mbar_over_kb * un.k_boltzmann())
    one = torch.tensor(1.0, dtype=torch.float64)
    got = float(trig.rate_from_partials({"w": one, "w_rho": one,
                                         "w_v": 0.0 * one, "w_cs": cs * one}))
    boost = max(1.0, (n / 0.5) ** 2.0)
    want = (boost * 2.0 * math.pi * un.gravitational_constant() ** 2 * 1e-4
            / cs ** 3)
    assert abs(got - want) / want < 1e-12


# ---------------------------------------------- each source against JAX
HEAD = """
<job>
problem_id = cluster

<parthenon/mesh>
nghost = 2
nx1 = 16
x1min = -0.02
x1max = 0.02
nx2 = 16
x2min = -0.02
x2max = 0.02
nx3 = 16
x3min = -0.02
x3max = 0.02

<parthenon/meshblock>
nx1 = 16
nx2 = 16
nx3 = 16

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 1.0

<hydro>
fluid = glmmhd
eos = adiabatic
riemann = hlld
reconstruction = plm
gamma = 1.6666666666666667
He_mass_fraction = 0.25
nscalars = 1

<units>
code_length_cgs = 3.085677580962325e+24
code_mass_cgs = 1.98841586e+47
code_time_cgs = 3.15576e+16
"""
NO_GRAVITY = "\n<problem/cluster/gravity>\ngravity_srcterm = false\n"
THERMAL = """
<problem/cluster/agn_feedback>
fixed_power = {power}
efficiency = 1.0e-3
thermal_fraction = 1.0
thermal_radius = 0.006
"""
TRIGGER = """
<problem/cluster/gravity>
gravity_srcterm = false
m_smbh = 1e-2

<problem/cluster/agn_triggering>
triggering_mode = {mode}
accretion_radius = 0.008
cold_temp_thresh = 3.5e7
cold_t_acc = 0.1
bondi_alpha = 100.0
bondi_n0 = 6.5e72
bondi_beta = 2.0
accretion_cfl = 0.25
""" + THERMAL.format(power=0.0)
SOURCES = {
    "gravity": """
<problem/cluster/gravity>
include_nfw_g = true
which_bcg_g = HERNQUIST
include_smbh_g = true
g_smoothing_radius = 0.001
""",
    "thermal": NO_GRAVITY + THERMAL.format(power=1e-3),
    "kinetic_tracer": NO_GRAVITY + """
<problem/cluster/precessing_jet>
jet_theta = 0.3
jet_phi_dot = 100.0
jet_phi0 = 0.2

<problem/cluster/agn_feedback>
fixed_power = 1e-3
efficiency = 1.0e-3
kinetic_fraction = 1.0
kinetic_jet_radius = 0.006
kinetic_jet_thickness = 0.006
kinetic_jet_offset = 0.002
enable_tracer = true
""",
    "tower": NO_GRAVITY + """
<problem/cluster/precessing_jet>
jet_theta = 0.3
jet_phi0 = 0.2

<problem/cluster/agn_feedback>
fixed_power = 1e-3
efficiency = 1.0e-3
magnetic_fraction = 1.0

<problem/cluster/magnetic_tower>
potential_type = li
li_alpha = 20.0
l_scale = 0.005
l_mass_scale = 0.005
""",
    "cold_gas": TRIGGER.format(mode="COLD_GAS"),
    "boosted_bondi": TRIGGER.format(mode="BOOSTED_BONDI"),
    "booth_schaye": TRIGGER.format(mode="BOOTH_SCHAYE"),
    "snia": """
<problem/cluster/gravity>
which_bcg_g = HERNQUIST
gravity_srcterm = false

<problem/cluster/snia_feedback>
power_per_bcg_mass = 1.0e-3
mass_rate_per_bcg_mass = 1.0e-2
""",
    "stellar": """
<problem/cluster/stellar_feedback>
stellar_radius = 0.015
exclusion_radius = 0.003
efficiency = 1.0e-5
number_density_threshold = 6.5e72
temperature_threshold = 3.7e7
""",
    "clips": """
<problem/cluster/clips>
clip_r = 0.015
dfloor = 20.0
vceil = 1.0
vAceil = 0.5
Tceil = 4.0e7
""",
}
SPLIT = ("stellar", "clips")


def _random_state(mesh, seed=11):
    """(cons, prim) of a 16^3 block: rho 15-45, T 2e7-4.8e7 K (p / rho
    0.3-0.7 in these units), v ~ N(0, 1), B ~ N(0, 3), psi, a scalar."""
    rng = np.random.default_rng(seed)
    shape = (mesh.nblocks,) + mesh.block_shape
    w = np.empty((mesh.nblocks, 10) + mesh.block_shape)
    w[:, IDN] = rng.uniform(15.0, 45.0, shape)
    w[:, 1:4] = rng.standard_normal((mesh.nblocks, 3) + mesh.block_shape)
    w[:, 4] = w[:, IDN] * rng.uniform(0.3, 0.7, shape)
    w[:, IB1:IB3 + 1] = 3.0 * rng.standard_normal(
        (mesh.nblocks, 3) + mesh.block_shape)
    w[:, 8] = 0.1 * rng.standard_normal(shape)
    w[:, 9] = rng.uniform(0.0, 1.0, shape)
    u = w.copy()
    u[:, IM1:IM3 + 1] = w[:, IDN:IDN + 1] * w[:, 1:4]
    u[:, IEN] = (w[:, 4] / (2.0 / 3.0)
                 + 0.5 * w[:, IDN] * (w[:, 1:4] ** 2).sum(axis=1)
                 + 0.5 * (w[:, IB1:IB3 + 1] ** 2).sum(axis=1))
    u[:, 9] = w[:, IDN] * w[:, 9]
    return u, w


def _rel_per_var(got, want):
    return max(float(np.abs(got[:, v] - want[:, v]).max()
                     / np.abs(want[:, v]).max())
               for v in range(want.shape[1]) if np.abs(want[:, v]).max() > 0)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_source_matches_jax(source):
    text = HEAD + SOURCES[source]
    tpin, jpin = ParameterInput.from_string(text), JPin.from_string(text)
    tm, jm = Mesh.from_parameter_input(tpin), JMesh.from_parameter_input(jpin)
    tcfg, jcfg = (HydroConfig.from_parameter_input(tpin),
                  JCfg.from_parameter_input(jpin))
    teos, jeos = EOS.from_parameter_input(tpin), JEOS.from_parameter_input(jpin)
    u, w = _random_state(tm)
    dt, t = 3.0e-4, 0.013
    if source in SPLIT:
        got = tcl.problem_source_first_order(tpin, tm, tcfg, teos)(
            torch.from_numpy(u.copy()), dt, t).numpy()
        want = np.asarray(jcl.problem_source_first_order(
            jpin, jm, jcfg, jeos)(jnp.asarray(u), dt, t))
    else:
        tu = torch.from_numpy(u.copy())
        got = tcl.problem_source_unsplit(tpin, tm, tcfg, teos)(
            tu, torch.from_numpy(w), tm, dt, t).numpy()
        assert np.array_equal(tu.numpy(), u)     # the input is kept
        want = np.asarray(jcl.problem_source_unsplit(jpin, jm, jcfg, jeos)(
            jnp.asarray(u), jnp.asarray(w), jm, dt, t))
    changed = np.abs(want - u).max(axis=(0, 2, 3, 4)) > 0
    assert changed.any(), "the source did nothing on this state"
    assert _rel_per_var(got, want) <= TOL
    if source == "kinetic_tracer":
        assert changed[9]          # the tracer was reset in the slabs
    if source == "clips":
        assert changed[IDN] and changed[IM1] and changed[IEN]
    if source in ("boosted_bondi", "booth_schaye"):
        want_dt = float(jcl.estimate_timestep(jpin, jm, jcfg, jeos,
                                              jnp.asarray(w), t))
        got_dt = float(tcl.estimate_timestep(tpin, tm, tcfg, teos,
                                             torch.from_numpy(w), t))
        assert abs(got_dt - want_dt) <= TOL * want_dt
