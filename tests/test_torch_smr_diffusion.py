"""Port parity: diffusion on refined meshes, static and adaptive, and the
extended Dedner source on a refined mesh.

Each deck runs through the port's ``SmrSimulation`` and the JAX
package's on the CPU in f64 from the JAX package's initial state:

* static: the diffusive linear wave (``torch_decks.linwave3d_deck``:
  conduction, viscosity and resistivity) at 16x8x8 with 8^3 blocks and
  the x < 1.5 half at level 1 (1 + 8 leaves), unsplit and RKL2, 5 cycles;
* adaptive: ``inputs/blast_3d_adaptive.in`` at 16^3 with 8^3 blocks and
  isotropic conduction (chi = 0.01), unsplit and RKL2, 4 cycles from the
  state with seeded noise (the blast is exactly symmetric), refining on
  the pressure gradient;
* the extended Dedner source (``glmmhd_source = dedner_extended``) on the
  static wave without diffusion, on both rungs.

Held: the leaf table, every level's state to 1e-12 relative to the
state's largest value, and the total mass and energy across levels to
the JAX package's and to their own start (1e-13; the coarse-fine
correction covers the diffusive fluxes, so conduction conserves both;
the extended Dedner terms change the energy, so that deck holds the
mass only).
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu.amr.driver import SmrSimulation as JSmr
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.indices import IDN, IEN
from torch_decks import linwave3d_deck, symmetry_noise

torch.set_num_threads(2)

TOL = 1e-12
CONS_TOL = 1e-13
REGION = (0.0, 1.5, 0.0, 1.5, 0.0, 1.5)
BLAST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "inputs", "blast_3d_adaptive.in")
CONDUCTION = ["parthenon/mesh/nx1=16", "parthenon/mesh/nx2=16",
              "parthenon/mesh/nx3=16", "parthenon/time/nlim=4",
              "parthenon/output0/dt=-1", "diffusion/conduction=isotropic",
              "diffusion/conduction_coeff=fixed",
              "diffusion/thermal_diff_coeff_code=0.01",
              "diffusion/rkl2_max_dt_ratio=200"]


def _totals(state, smesh):
    g = smesh.base.nghost
    mass = etot = 0.0
    for lev, u in state.items():
        vol = float(np.prod(smesh.dx(lev)))
        ui = np.asarray(u)[:, :, g:-g, g:-g, g:-g]
        mass += ui[:, IDN].sum() * vol
        etot += ui[:, IEN].sum() * vol
    return np.array([mass, etot])


def _table(sm):
    return [np.asarray(x) for x in (sm.levels, sm.lx1, sm.lx2, sm.lx3)]


def _both(jpin, tpin, tmp_path, noise=False, conserves_energy=True):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        js = JSmr(jpin, quiet=True)
        ts = SmrSimulation(tpin, quiet=True, device="cpu")
        for a, b in zip(_table(ts._smesh_now()), _table(js._smesh_now())):
            np.testing.assert_array_equal(a, b)
        start = {lev: np.asarray(u) for lev, u in js.state.items()}
        if noise:
            start = symmetry_noise(start, seed=5)
        js.state = {lev: jnp.asarray(v) for lev, v in start.items()}
        ts.load_state(start, 0.0, 0)
        t0 = _totals(start, ts._smesh_now())
        js.run()
        ts.run()
    finally:
        os.chdir(cwd)
    assert ts.ncycle == js.ncycle and ts.t == pytest.approx(js.t, rel=TOL)
    for a, b in zip(_table(ts._smesh_now()), _table(js._smesh_now())):
        np.testing.assert_array_equal(a, b)
    scale = max(float(np.abs(np.asarray(v)).max())
                for v in js.state.values())
    for lev, u in js.state.items():
        err = float(np.abs(ts.state[lev].numpy() - np.asarray(u)).max())
        assert err <= TOL * scale, (lev, err / scale)
    tot = _totals({k: v.numpy() for k, v in ts.state.items()},
                  ts._smesh_now())
    np.testing.assert_allclose(tot, _totals(js.state, js._smesh_now()),
                               rtol=CONS_TOL)
    # (the extended Dedner terms change the energy by design)
    keep = slice(None) if conserves_energy else slice(0, 1)
    np.testing.assert_allclose(tot[keep], t0[keep], rtol=CONS_TOL)
    return js, ts


@pytest.mark.parametrize("integrator", ["unsplit", "rkl2"])
def test_static_diffusion_matches_jax(integrator, tmp_path):
    deck = linwave3d_deck(nx=(16, 8, 8), mb=(8, 8, 8), integrator=integrator,
                          refinement="static", region=REGION)
    js, ts = _both(JPin.from_string(deck), ParameterInput.from_string(deck),
                   tmp_path)
    assert {lev: v.shape[0] for lev, v in ts.state.items()} == {0: 1, 1: 8}
    assert ts.ncycle == 5
    st = ts.stepper
    assert st.sts == (integrator == "rkl2") == ts._split_loop()
    assert (st.rkl2_stages > 0) == (integrator == "rkl2")


@pytest.mark.parametrize("integrator", ["unsplit", "rkl2"])
def test_adaptive_conduction_matches_jax(integrator, tmp_path):
    ovr = CONDUCTION + [f"diffusion/integrator={integrator}",
                        "parthenon/mesh/derefine_count=1"]
    js, ts = _both(JPin.from_file(BLAST, ovr),
                   ParameterInput.from_file(BLAST, ovr), tmp_path,
                   noise=True)
    assert ts.ncycle == 4 and 1 in ts.state
    assert ts._stepper_now().diffusion.integrator == integrator


@pytest.mark.parametrize("rung", ["stage", "negdiv"])
def test_dedner_extended_on_smr_matches_jax(rung, tmp_path, monkeypatch):
    monkeypatch.setenv("ATHENAPK_PALLAS_STAGE",
                       "1" if rung == "stage" else "0")
    deck = linwave3d_deck(nx=(16, 8, 8), mb=(8, 8, 8), refinement="static",
                          region=REGION).replace(
        "integrator = unsplit\nconduction = isotropic",
        "integrator = unsplit\nconduction = none").replace(
        "viscosity = isotropic", "viscosity = none").replace(
        "resistivity = ohmic", "resistivity = none").replace(
        "gamma = 1.666666666666667",
        "gamma = 1.666666666666667\nglmmhd_source = dedner_extended")
    js, ts = _both(JPin.from_string(deck), ParameterInput.from_string(deck),
                   tmp_path, conserves_energy=False)
    st = ts.stepper
    assert st.diffusion is None and st._need_prim()
    assert st._stage_rung == (rung == "stage")
