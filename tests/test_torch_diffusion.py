"""Port parity: diffusion (``diffusion/diffusion.py``) and the ``diffusion``
problem on uniform meshes.

The diffusive fluxes of every process, coefficient and limiter (isotropic
and anisotropic conduction with fixed and Spitzer coefficients, the
saturation included; viscosity; Ohmic resistivity) against the JAX
package's ``calc_diff_fluxes`` in 1-D, 2-D and 3-D on seeded random prim,
``estimate_diff_dt``, and ``DiffusionConfig``'s parsing with its
``ValueError``s, all in f64 to 1e-12 relative (measured: 0 to ~1e-16).

Then the twins of ``tests/test_diffusion.py``: the viscous, resistive and
conductive Gaussians with ``riemann = none``, unsplit and RKL2, and
anisotropic conduction along B, through the port's ``Simulation``, each
held against the analytic profile with the JAX test's own bounds and
against the JAX package's final state (1e-12 relative to the state's
largest value; measured 0 for unsplit, ~1e-14 for RKL2).
"""

import dataclasses
import math
import zlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.diffusion import diffusion as jdiff
from athenapk_tpu.driver import Simulation as JSim
from athenapk_tpu.utils.units import Units as JUnits
from athenapk_tpu.utils.units import mean_molecular_weights as jmu
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.indices import IB2, IDN, IPR, IV2
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.diffusion import diffusion as tdiff
from athenapk_tpu_torch.driver import Simulation, make_diffusion

import test_diffusion as jtest

torch.set_num_threads(2)

TOL = 1e-12
# cluster-like code units (1 kpc, 1 Myr): p/rho ~ 1 is ~7e7 K, so the
# Spitzer coefficient and its saturation both matter
UNITS = """
<units>
code_length_cgs = 3.0856775809623245e+21
code_mass_cgs = 1.98841586e+41
code_time_cgs = 3.15576e+13
"""

MESHES = {
    "1d": dict(nx1=16, nx2=1, nx3=1, mbnx1=16, mbnx2=1, mbnx3=1),
    "2d": dict(nx1=12, nx2=10, nx3=1, mbnx1=12, mbnx2=10, mbnx3=1),
    "3d": dict(nx1=8, nx2=6, nx3=10, mbnx1=8, mbnx2=6, mbnx3=10),
}

CONFIGS = {
    "iso_fixed": dict(conduction="isotropic", conduction_coeff="fixed",
                      thermal_diff_coeff=0.3, conduction_sat_prefac=1.5),
    # a small saturation prefactor: the saturated and the classic flux
    # compete
    "aniso_fixed": dict(conduction="anisotropic", conduction_coeff="fixed",
                        thermal_diff_coeff=0.3,
                        conduction_sat_prefac=0.05),
    "iso_spitzer": "spitzer isotropic",
    "aniso_spitzer": "spitzer anisotropic",
    "viscosity": dict(viscosity="isotropic", viscosity_coeff="fixed",
                      mom_diff_coeff=0.2),
    "resistivity": dict(resistivity="ohmic", resistivity_coeff="fixed",
                        ohm_diff_coeff=0.15),
    "all": dict(conduction="anisotropic", conduction_coeff="fixed",
                thermal_diff_coeff=0.3, conduction_sat_prefac=0.05,
                viscosity="isotropic", viscosity_coeff="fixed",
                mom_diff_coeff=0.2, resistivity="ohmic",
                resistivity_coeff="fixed", ohm_diff_coeff=0.15),
}


def _spitzer_deck(cond):
    return (f"<diffusion>\nintegrator = unsplit\nconduction = {cond}\n"
            "conduction_coeff = spitzer\n<hydro>\nHe_mass_fraction = 0.25\n"
            + UNITS)


def _configs(name):
    """(JAX config, port config) of a ``CONFIGS`` entry."""
    spec = CONFIGS[name]
    if isinstance(spec, dict):
        return jdiff.DiffusionConfig(**spec), tdiff.DiffusionConfig(**spec)
    deck = _spitzer_deck(spec.split()[1])
    jp = JPin.from_string(deck)
    mu, _ = jmu(0.25)
    jc = jdiff.DiffusionConfig.from_parameter_input(jp, units=JUnits(jp),
                                                    mu=mu)
    return jc, make_diffusion(ParameterInput.from_string(deck))


def _prim(mesh, seed, spitzer=False):
    """Random positive rho and p, velocities and B, [1, 9, NZ, NY, NX]."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-1.0, 1.0, (1, 9) + mesh.block_shape)
    w[:, IDN] = rng.uniform(0.5, 1.5, mesh.block_shape)
    w[:, IPR] = rng.uniform(0.5, 1.5, mesh.block_shape)
    if spitzer:
        # T ~ 1e7-1e8 K in these units, the chi from it ~ the code's
        w[:, IPR] *= 1e-3
    return w


def _rel(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    return float(np.abs(np.asarray(got) - want).max() / scale) \
        if scale > 0 else float(np.abs(np.asarray(got)).max())


@pytest.mark.parametrize("dim", list(MESHES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_calc_diff_fluxes_matches_jax(name, dim):
    kw = dict(MESHES[dim], x1min=0.0, x1max=1.0, x2min=0.0, x2max=0.8,
              x3min=0.0, x3max=1.2, nghost=2)
    jc, tc = _configs(name)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    w = _prim(Mesh(**kw), seed=zlib.crc32(f"{name} {dim}".encode()),
              spitzer="spitzer" in name)
    want = jdiff.calc_diff_fluxes(jc, jnp.asarray(w), JMesh(**kw))
    got = tdiff.calc_diff_fluxes(tc, torch.tensor(w), Mesh(**kw))
    assert sorted(got) == sorted(want)
    for d in want:
        assert np.abs(np.asarray(want[d])).max() > 0.0
        assert _rel(got[d].numpy(), want[d]) <= TOL, (d, name, dim)
    jdt = float(jdiff.estimate_diff_dt(jc, jnp.asarray(w), JMesh(**kw), 0.4))
    tdt = float(tdiff.estimate_diff_dt(tc, torch.tensor(w), Mesh(**kw), 0.4))
    assert tdt == pytest.approx(jdt, rel=TOL)


def test_limiters_match_jax():
    rng = np.random.default_rng(7)
    a, b, c, d = (rng.standard_normal(400) for _ in range(4))
    # ties and zeros on the select boundaries
    a[:20] = 0.0
    b[20:40] = -a[20:40]
    c[40:60] = c[60:80] = d[40:60]
    args = [jnp.asarray(x) for x in (a, b, c, d)]
    targs = [torch.tensor(x) for x in (a, b, c, d)]
    for fn in ("minmod", "vanleer", "mc", "lim2"):
        np.testing.assert_array_equal(
            getattr(tdiff, fn)(*targs[:2]).numpy(),
            np.asarray(getattr(jdiff, fn)(*args[:2])))
    np.testing.assert_array_equal(tdiff.lim4(*targs).numpy(),
                                  np.asarray(jdiff.lim4(*args)))


PARSE_DECKS = [
    "<diffusion>\nconduction = isotropic\nconduction_coeff = fixed\n"
    "thermal_diff_coeff_code = 0.25\nconduction_sat_phi = 0.2\n",
    "<diffusion>\nintegrator = rkl2\nviscosity = isotropic\n"
    "viscosity_coeff = fixed\nmom_diff_coeff_code = 0.1\n"
    "rkl2_max_dt_ratio = 50\n",
    "<diffusion>\nresistivity = ohmic\nresistivity_coeff = fixed\n"
    "ohm_diff_coeff_code = 0.3\n",
    _spitzer_deck("anisotropic"),
    "<hydro>\ngamma = 1.4\n",
]


@pytest.mark.parametrize("deck", PARSE_DECKS)
def test_config_parsing_matches_jax(deck):
    jp = JPin.from_string(deck)
    units = JUnits(jp) if jp.has_block("units") else None
    mu = jmu(0.25)[0] if units is not None else None
    want = jdiff.DiffusionConfig.from_parameter_input(jp, units=units, mu=mu)
    got = make_diffusion(ParameterInput.from_string(deck))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("deck,match", [
    ("<diffusion>\nconduction = isotropic\nconduction_coeff = spitzer\n",
     "spitzer conduction requires"),
    ("<diffusion>\nconduction = isotropic\nconduction_coeff = magic\n",
     "conduction_coeff"),
    ("<diffusion>\nviscosity = isotropic\nviscosity_coeff = spitzer\n",
     "viscosity_coeff"),
    ("<diffusion>\nresistivity = ohmic\nresistivity_coeff = spitzer\n",
     "resistivity_coeff"),
])
def test_config_errors_match_jax(deck, match):
    with pytest.raises(ValueError, match=match):
        jdiff.DiffusionConfig.from_parameter_input(JPin.from_string(deck))
    with pytest.raises(ValueError, match=match):
        make_diffusion(ParameterInput.from_string(deck))


# --------------------------------------------- twins of test_diffusion.py
def _deck(iprob, fluid, conduction="none", viscosity="none",
          resistivity="none", diffint="unsplit", Bx=0.0):
    return jtest.DECK.format(iprob=iprob, fluid=fluid, conduction=conduction,
                             viscosity=viscosity, resistivity=resistivity,
                             diffint=diffint, Bx=Bx)


def _run_both(deck):
    """(port Simulation, JAX final cons) after the deck's run to tlim."""
    j = JSim(JPin.from_string(deck), quiet=True).run()
    t = Simulation(ParameterInput.from_string(deck), quiet=True,
                   device="cpu").run()
    assert t.ncycle == j.ncycle and t.t == pytest.approx(j.t, rel=1e-14)
    # the JAX package keeps the ghosts where it sees several devices; the
    # port merges into one ghost-free block: compare the interiors
    want = np.asarray(j.cons())[j.mesh.interior_slices]
    assert _rel(t.cons()[t.mesh.interior_slices], want) <= TOL
    return t


def _profile(sim, q):
    g = sim.mesh.nghost
    sl = slice(g, -g) if g else slice(None)
    x, _, _ = sim.mesh.cell_centers()
    xg = x[:, sl].reshape(-1)
    vals = q[:, 0, 0, sl].reshape(-1)
    order = np.argsort(xg)
    return xg[order], vals[order]


def _prim_np(sim):
    _, w = sim.pkg.cons_to_prim(sim.u)
    return w.numpy()


@pytest.mark.parametrize("diffint", ["unsplit", "rkl2"])
def test_viscous_gaussian(diffint):
    sim = _run_both(_deck(30, "euler", viscosity="isotropic",
                          diffint=diffint))
    x, v2 = _profile(sim, _prim_np(sim)[:, IV2])
    ref = jtest._heat_exact(jtest._gauss(x, 0.25, 0.5), 0.25, sim.t)
    err = np.abs(v2 - ref).mean() / np.abs(ref).max()
    assert err < 5e-3, f"viscous Gaussian rel-L1 {err:.2e}"


def test_resistive_gaussian():
    sim = _run_both(_deck(40, "glmmhd", resistivity="ohmic"))
    x, b2 = _profile(sim, _prim_np(sim)[:, IB2])
    ref = jtest._heat_exact(jtest._gauss(x, 0.25, 0.5), 0.25, sim.t)
    err = np.abs(b2 - ref).mean() / np.abs(ref).max()
    assert err < 5e-3, f"resistive Gaussian rel-L1 {err:.2e}"


@pytest.mark.parametrize("diffint", ["unsplit", "rkl2"])
def test_conduction_gaussian_iso(diffint):
    sim = _run_both(_deck(10, "glmmhd", conduction="isotropic",
                          diffint=diffint))
    w = _prim_np(sim)
    x, T = _profile(sim, w[:, IPR] / w[:, IDN])
    ref = 1.0 + jtest._heat_exact(jtest._gauss(x, 0.25, 0.5), 0.25, sim.t)
    err = np.abs(T - ref).mean() / np.abs(ref - 1.0).max()
    assert err < 5e-3, f"conduction Gaussian rel-L1 {err:.2e}"
    if diffint == "rkl2":
        # 2 cycles of 2 super-steps; the port's stage count is the JAX
        # formula's
        assert sim.pkg.rkl2_stages > 4 * sim.ncycle


def test_conduction_aniso_along_b():
    sim = _run_both(_deck(10, "glmmhd", conduction="anisotropic", Bx=1.0))
    w = _prim_np(sim)
    x, T = _profile(sim, w[:, IPR] / w[:, IDN])
    ref_pert = jtest._heat_exact(jtest._gauss(x, 0.25, 0.5), 0.25, sim.t)
    err = np.abs(T - 1.0 - ref_pert).mean() / ref_pert.max()
    assert err < 2e-2, f"aniso conduction rel-L1 {err:.2e}"


def test_null_solver_launches_nothing_and_keeps_a_state_at_rest():
    """``riemann = none`` without diffusion: the stage is the identity on
    a state whose diffusive fluxes vanish (no kernel, no flux)."""
    deck = _deck(30, "euler").replace("gamma = 2.0",
                                      "gamma = 2.0\nmax_dt = 0.01")
    deck = deck.replace("amp = 1e-6", "amp = 0.0")
    sim = Simulation(ParameterInput.from_string(deck), quiet=True,
                     device="cpu")
    u0 = sim.u.clone()
    sim.run()
    assert sim.ncycle == 20
    np.testing.assert_array_equal(sim.u.numpy(), u0.numpy())
    assert math.isinf(sim.dt_diff)
