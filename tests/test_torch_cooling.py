"""Port parity: tabular cooling (``srcterms/tabular_cooling.py``).

Twins of the three tests of ``tests/test_cooling.py`` (the integrators
against the exact cooling ODE, the cooling dt, the table's self-test),
run through the port's ``Simulation``.  That file's deck uses the
``diffusion`` problem with ``riemann = none``, which the port did not have
when these twins were written; here a ported problem (``sod``) runs HLLE + DC on a uniform state at
rest, loaded with ``load_state`` (its flux divergence is exactly 0), with
``calc_dt_hyp = false``.  Then ``TabularCooling.apply`` with each
integrator and ``estimate_timestep`` against the JAX package's on random
states, f64, to 1e-12.
"""

import math
import zlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from scipy.integrate import solve_ivp

from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.srcterms.tabular_cooling import TabularCooling as JCool
from athenapk_tpu.utils.units import Units as JUnits
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.indices import IDN, IPR
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation, make_cooling
from torch_decks import write_cooling_table

torch.set_num_threads(2)

DECK = """
<job>
problem_id = sod

<parthenon/mesh>
nghost = 2
nx1 = 8
x1min = -1.0
x1max = 1.0
nx2 = 1
x2min = -1.0
x2max = 1.0
nx3 = 1
x3min = -1.0
x3max = 1.0

<parthenon/time>
integrator = rk1
cfl = 0.3
tlim = {tlim}
nlim = {nlim}
ncycle_out = 0

<hydro>
fluid = euler
eos = adiabatic
riemann = hlle
reconstruction = dc
gamma = 1.666666666666667
He_mass_fraction = 0.25
max_dt = {max_dt}
calc_dt_hyp = false

<units>
code_length_cgs = 1.0
code_mass_cgs = 1.0
code_time_cgs = 1.0

<cooling>
enable_cooling = tabular
table_filename = {table}
lambda_units_cgs = 1.0
integrator = {integrator}
cfl = -1.0
"""

GAMMA = 5.0 / 3.0
HE_X = 0.25
MU = 1.0 / (HE_X * 3.0 / 4.0 + (1.0 - HE_X) * 2.0)
MH = 1.007947 * 1.660538921e-24
KB = 1.3806488e-16
MBAR_OVER_KB = MU * MH / KB
RHO = 1.0e-24
TOL = 1e-12


def _dedt_ref(e, alpha=0.5, lam0=1e-23, t_ref=1e6):
    T = MBAR_OVER_KB * (GAMMA - 1.0) * e
    lam = lam0 * (T / t_ref) ** alpha
    x_h_over_mh2 = ((1.0 - HE_X) / MH) ** 2
    return -lam * x_h_over_mh2 * RHO


def _setup(tmp_path, integrator, tlim, nlim=1, max_dt=None):
    table = write_cooling_table(tmp_path / "powerlaw.cool")
    deck = DECK.format(tlim=tlim, nlim=nlim, integrator=integrator,
                       table=table, max_dt=max_dt or tlim)
    sim = Simulation(ParameterInput.from_string(deck), quiet=True,
                     device="cpu")
    # a uniform gas at rest, rho = RHO and T = 1e6 K
    e0 = 1e6 / (MBAR_OVER_KB * (GAMMA - 1.0))   # specific internal energy
    u = np.zeros(tuple(sim.u.shape))
    u[:, IDN] = RHO
    u[:, 4] = RHO * e0
    sim.load_state(u, 0.0, 0)
    return sim, e0


@pytest.mark.parametrize("integrator,tol", [
    ("townsend", 1e-8),   # exact for piecewise power laws
    ("rk45", 1e-6),
    ("rk12", 1e-4),
])
def test_cooling_integrators_match_exact(tmp_path, integrator, tol):
    t_end = 3.0e13  # ~0.3 cooling times
    sim, e0 = _setup(tmp_path, integrator, tlim=t_end)
    sim.run()
    assert sim.ncycle == 1  # one application at the full dt
    _, w = sim.pkg.cons_to_prim(sim.u)
    w = w.numpy()
    sl = sim.mesh.interior_slices
    e_sim = (w[sl][:, IPR] / (RHO * (GAMMA - 1.0))).ravel()

    sol = solve_ivp(lambda t, y: _dedt_ref(y), (0.0, t_end), [e0],
                    rtol=1e-12, atol=1e-6)
    e_exact = sol.y[0, -1]
    rel = abs(e_sim.mean() - e_exact) / e_exact
    assert e_sim.std() < 1e-8 * e0  # the uniform box stays uniform
    assert rel < tol, f"{integrator}: rel err {rel:.2e}"
    if integrator != "townsend":
        # the subcycling loop's test reads the host once a pass
        assert sim.pkg.cooling.host_reads >= 2


def test_cooling_timestep_estimate(tmp_path):
    sim, e0 = _setup(tmp_path, "townsend", tlim=1e30, nlim=1, max_dt=1e30)
    sim.pkg.cooling.cooling_time_cfl = 0.1
    _, prim = sim.pkg.cons_to_prim(sim.u)
    dt = float(sim.pkg.cooling.estimate_timestep(prim, sim.mesh))
    tcool = e0 / abs(_dedt_ref(e0))
    np.testing.assert_allclose(dt, 0.1 * tcool, rtol=1e-6)
    # and the package's dt takes it (calc_dt_hyp = false: it is the dt)
    assert sim.pkg.estimate_timestep(prim)[0] == pytest.approx(dt, rel=1e-15)


def test_cooling_table_selftest(tmp_path):
    """``<cooling> test_filename`` makes the driver write de/dt over a
    log-spaced (rho, pres) grid at start-up; the values are the power law
    the table encodes, scaling as rho."""
    table = write_cooling_table(tmp_path / "powerlaw.cool")
    out = tmp_path / "cooling_table_test.dat"
    deck = DECK.format(tlim=1.0, nlim=0, integrator="townsend", table=table,
                       max_dt=1.0)
    pin = ParameterInput.from_string(deck)
    pin.set("cooling", "test_filename", str(out))
    pin.set("cooling", "test_rho0", "1.0e-26")
    pin.set("cooling", "test_rho1", "1.0e-22")
    pin.set("cooling", "test_n_rho", "5")
    pin.set("cooling", "test_pres0", "1.0e-14")
    pin.set("cooling", "test_pres1", "1.0e-10")
    pin.set("cooling", "test_n_pres", "9")
    Simulation(pin, quiet=True, device="cpu")

    data = np.genfromtxt(str(out))
    assert data.shape == (45, 4)
    rho, pres, internal_e, de_dt = data.T
    np.testing.assert_allclose(internal_e, pres / (rho * (GAMMA - 1.0)),
                               rtol=1e-10)
    T = MBAR_OVER_KB * (GAMMA - 1.0) * internal_e
    in_table = (T >= 1.0e4) & (T <= 1.0e8)
    assert in_table.sum() >= 20
    expect = _dedt_ref(internal_e) / RHO * rho
    np.testing.assert_allclose(de_dt[in_table], expect[in_table], rtol=1e-6)
    assert (de_dt[T < 1.0e4] == 0.0).all()


# ------------------------------------------------- against the JAX package
def _coolers(tmp_path, integrator, cfl=0.1):
    table = write_cooling_table(tmp_path / "powerlaw.cool")
    deck = DECK.format(tlim=1.0, nlim=1, integrator=integrator, table=table,
                       max_dt=1.0).replace("cfl = -1.0", f"cfl = {cfl}")
    tc = make_cooling(ParameterInput.from_string(deck))
    jpin = JPin.from_string(deck)
    units = JUnits(jpin)
    mbar_over_kb = MU * units.mh() / units.k_boltzmann()
    jc = JCool(jpin, units, GAMMA, MU, HE_X, mbar_over_kb)
    return tc, jc


def _random_cons(seed, mhd, nb=2, n=(6, 5, 4)):
    """Gas at rest or moving, 1e3-1e9 K (the table's 1e4-1e8 and beyond),
    some cells below the table and a few with negative internal energy
    (numpy, f64)."""
    rng = np.random.default_rng(seed)
    shape = (nb,) + n[::-1]
    nvar = 9 if mhd else 5
    rho = RHO * 10.0 ** rng.uniform(-1.0, 1.0, shape)
    temp = 10.0 ** rng.uniform(3.0, 9.0, shape)
    e = temp / (MBAR_OVER_KB * (GAMMA - 1.0))
    u = np.zeros((nb, nvar) + shape[1:])
    u[:, 0] = rho
    u[:, 1:4] = rho[:, None] * 1e6 * rng.standard_normal((nb, 3) + shape[1:])
    u[:, 4] = rho * e + 0.5 * (u[:, 1:4] ** 2).sum(axis=1) / rho
    if mhd:
        u[:, 5:8] = 1e-9 * rng.standard_normal((nb, 3) + shape[1:])
        u[:, 4] += 0.5 * (u[:, 5:8] ** 2).sum(axis=1)
    u[:, 4][rng.random(shape) < 0.02] *= -1.0
    return u


@pytest.mark.parametrize("fluid", ["euler", "glmmhd"])
@pytest.mark.parametrize("integrator", ["townsend", "rk12", "rk45"])
def test_apply_matches_jax(tmp_path, integrator, fluid):
    tc, jc = _coolers(tmp_path, integrator)
    u = _random_cons(zlib.crc32(f"{integrator}/{fluid}".encode()),
                     fluid == "glmmhd")
    for dt in (1e11, 3e13):
        got = tc.apply(torch.tensor(u), dt, fluid).numpy()
        want = np.asarray(jc.apply(jnp.asarray(u), dt, fluid))
        assert np.isfinite(got[:, 4]).sum() == np.isfinite(want[:, 4]).sum()
        ok = np.isfinite(want)
        assert np.array_equal(np.isfinite(got), ok)
        rel = np.abs(got[ok] - want[ok]).max() / np.abs(want[ok]).max()
        assert rel <= TOL, (dt, rel)
        # the energy changed where the gas is in the table
        assert (got[:, 4] != u[:, 4]).sum() > 10


def test_dedt_and_estimate_timestep_match_jax(tmp_path):
    tc, jc = _coolers(tmp_path, "townsend", cfl=0.1)
    u = _random_cons(7, False)
    e = u[:, 4] / u[:, 0]
    got = tc.dedt(torch.tensor(e), torch.tensor(u[:, 0])).numpy()
    want = np.asarray(jc.dedt(jnp.asarray(e), jnp.asarray(u[:, 0])))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    kw = dict(nx1=6, nx2=5, nx3=4, mbnx1=6, mbnx2=5, mbnx3=4, x1min=0.0,
              x1max=1.0, x2min=0.0, x2max=1.0, x3min=0.0, x3max=1.0,
              nghost=0)
    prim = u.copy()
    prim[:, 4] = np.abs(u[:, 4]) * (GAMMA - 1.0)
    prim[:, 1:4] = 0.0
    got = float(tc.estimate_timestep(torch.tensor(prim[:1]), Mesh(**kw)))
    want = float(jc.estimate_timestep(jnp.asarray(prim[:1]), JMesh(**kw)))
    assert got == pytest.approx(want, rel=TOL)
    assert math.isfinite(got)



@pytest.mark.parametrize("integrator", ["rk12", "rk45"])
def test_pass_log_counts_each_pass_and_changes_nothing(tmp_path, integrator):
    """``TabularCooling.pass_log`` on: the same result bit for bit, one
    row per pass, every active cell accepted or rejected, every active
    cell's error in one bin; accepted steps add up to the cells' steps."""
    from athenapk_tpu_torch.srcterms.tabular_cooling import PASS_COUNTS
    tc, _ = _coolers(tmp_path, integrator)
    u = torch.tensor(_random_cons(11, False))
    dt = 3e13
    want = tc.apply(u, dt, "euler")
    reads = tc.host_reads
    tc.pass_log = []
    got = tc.apply(u, dt, "euler")
    rows = torch.stack(tc.pass_log).numpy()
    tc.pass_log = None
    assert torch.equal(got, want)
    assert rows.shape == (tc.host_reads - reads - 1, len(PASS_COUNTS))
    active, ok, at_min, rejected = rows[:, :4].T
    assert (active == ok + at_min + rejected).all()
    assert (rows[:, 4:].sum(axis=1) == active).all()
    assert active[0] > 10 and rejected.sum() > 0
