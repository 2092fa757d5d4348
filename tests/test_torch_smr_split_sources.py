"""Port parity: split sources on refined meshes (the refined cases of
``tests/test_smr_split_sources.py`` as twins, then against the JAX
package on the CPU).

* rand_blast on a static refined mesh through the per-level adapter
  (``amr.driver.adapt_split_source``): the twin's checks (the blast's
  energy, the mass) and the JAX package's state level by level (1e-12
  relative to the state's largest value);
* turbulence's OU driving (GLM-MHD HLLD) through its ``_smr`` hook (the
  mean momentum and the rms reduced across levels): the twin's checks,
  and 5 cycles against the JAX package in f64 (1e-12) and in f32 (2e-5),
  both from the JAX package's initial state rounded to f32 (its refined
  loop turns an f32 state f64 under x64, so one f64 JAX run serves);
* the Strang hook through the adapter, monkeypatched (the twin);
* a monkeypatched pointwise ``problem_source_unsplit_smr`` on both rungs
  (1e-12).
"""

import os
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu.amr.driver import SmrSimulation as JSmr
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.pgen import linear_wave_mhd as jlw
from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.indices import IDN, IEN, IM1, IM2, IM3
from athenapk_tpu_torch.pgen import advection as tadv
from athenapk_tpu_torch.pgen import linear_wave_mhd as tlw
from torch_decks import linwave3d_deck, turbulence_deck

import test_smr_split_sources as jtest
from test_torch_split_sources import _dummy_strang_factory

torch.set_num_threads(2)

TOL = 1e-12
F32_TOL = 2e-5


def _rel_levels(got, want):
    scale = max(float(np.abs(np.asarray(v, np.float64)).max())
                for v in want.values())
    return max(float(np.abs(np.asarray(got[lev], np.float64)
                            - np.asarray(want[lev], np.float64)).max())
               for lev in want) / scale


def _totals(sim):
    """(mass, total energy, kinetic energy, momentum) over the levels."""
    sm = sim._smesh_now()
    g = sm.base.nghost
    mass = etot = ke = 0.0
    mom = np.zeros(3)
    for lev, u in sim.state.items():
        vol = float(np.prod(sm.dx(lev)))
        ui = np.asarray(u, np.float64)[:, :, g:-g, g:-g, g:-g]
        mass += ui[:, IDN].sum() * vol
        etot += ui[:, IEN].sum() * vol
        ke += (0.5 * (ui[:, IM1] ** 2 + ui[:, IM2] ** 2 + ui[:, IM3] ** 2)
               / ui[:, IDN]).sum() * vol
        mom += np.array([ui[:, m].sum() for m in (IM1, IM2, IM3)]) * vol
    return mass, etot, ke, mom


def _both(deck, tmp_path):
    """The JAX and the port's SmrSimulation of ``deck`` from the JAX
    package's initial state, run."""
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        js = JSmr(JPin.from_string(deck), quiet=True)
        start = {lev: np.asarray(u) for lev, u in js.state.items()}
        js.state = {lev: jnp.asarray(v) for lev, v in start.items()}
        ts = SmrSimulation(ParameterInput.from_string(deck), quiet=True,
                           device="cpu").load_state(start, 0.0, 0)
        js.run()
        ts.run()
    finally:
        os.chdir(cwd)
    return js, ts


def test_rand_blast_on_smr_matches_jax(tmp_path):
    """Twin of ``test_rand_blast_on_smr_injects_energy_conserves_mass``:
    rand_blast has no ``_smr`` hook, so the adapter carries its uniform
    source onto the levels; blast 1 fires in the cycle that crosses
    t = 0.00125."""
    js, ts = _both(jtest.RAND_BLAST_SMR, tmp_path)
    mass0, etot0 = jtest._totals(JSmr(JPin.from_string(
        jtest.RAND_BLAST_SMR), quiet=True))
    assert ts.t >= 0.00125 and ts.ncycle == js.ncycle
    mass1, etot1, _, _ = _totals(ts)
    np.testing.assert_allclose(mass1, mass0, rtol=1e-12)
    assert etot1 > etot0 * 1.5
    assert _rel_levels({k: v.numpy() for k, v in ts.state.items()},
                       js.state) <= TOL


@pytest.fixture(scope="module")
def jax_turbulence(tmp_path_factory):
    """The JAX package's 5 refined turbulence cycles from its initial state
    rounded to f32 (the JAX package's refined loop turns an f32 state f64
    under x64, so one f64 run serves both precisions): (deck of the f64
    run, start, JAX simulation)."""
    deck = turbulence_deck(n=16, mb=8, nlim=5, refinement="static",
                           num_modes=8)
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("jax"))
    try:
        js = JSmr(JPin.from_string(deck), quiet=True)
        start = {lev: np.asarray(u).astype(np.float32).astype(np.float64)
                 for lev, u in js.state.items()}
        js.state = {lev: jnp.asarray(v) for lev, v in start.items()}
        js.run()
    finally:
        os.chdir(cwd)
    return deck, start, js


@pytest.mark.parametrize("precision", ["double", "single"])
def test_turbulence_on_smr_matches_jax(precision, jax_turbulence, tmp_path,
                                       monkeypatch):
    """Twin of ``test_turbulence_ou_driving_on_smr`` (kinetic energy grows,
    no net momentum, mass conserved), and the JAX package's state."""
    deck, start, js = jax_turbulence
    single = precision == "single"
    monkeypatch.chdir(tmp_path)
    ts = SmrSimulation(ParameterInput.from_string(
        deck.replace("precision = double", f"precision = {precision}")),
        quiet=True, device="cpu").load_state(start, 0.0, 0).run()
    assert {lev: v.shape[0] for lev, v in ts.state.items()} == {0: 7, 1: 8}
    assert ts.ncycle == js.ncycle == 5
    assert all(v.dtype == (torch.float32 if single else torch.float64)
               for v in ts.state.values())
    tol = F32_TOL if single else TOL
    assert ts.t == pytest.approx(js.t, rel=tol)
    assert _rel_levels({k: v.numpy() for k, v in ts.state.items()},
                       js.state) <= tol
    mass, _, ke, mom = _totals(ts)
    assert ke > 0.0
    assert np.abs(mom).max() < (1e-5 if single else 1e-9)
    mass0 = _totals(types.SimpleNamespace(
        state=start, _smesh_now=ts._smesh_now))[0]
    np.testing.assert_allclose(mass, mass0, rtol=1e-6 if single else 1e-12)


def test_strang_split_source_smr(monkeypatch, tmp_path):
    """Twin: the same Strang hook on a refined mesh through the adapter."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tadv, "problem_source_strang",
                        _dummy_strang_factory, raising=False)
    deck = jtest.STRANG_DECK.replace(
        "<parthenon/mesh>",
        "<parthenon/mesh>\nrefinement = static\nnumlevel = 2\n") + """
<parthenon/static_refinement0>
x1min = 0.0
x1max = 0.5
x2min = 0.0
x2max = 0.5
x3min = 0.0
x3max = 0.5
level = 1
"""
    sim = SmrSimulation(ParameterInput.from_string(deck), quiet=True,
                        device="cpu")
    assert sim._split_loop()
    sim.run()
    g = sim._smesh_now().base.nghost
    e_expected = 1.0 / (5.0 / 3.0 - 1.0) + 0.5 + jtest.EDOT * sim.t
    for lev, u in sim.state.items():
        ui = u.numpy()[:, :, g:-g, g:-g, g:-g]
        np.testing.assert_allclose(ui[:, IEN].mean(), e_expected,
                                   rtol=1e-10)


EDOT = 0.3


def _jax_heating_smr(pin, smesh, cfg, eos):
    def src(state, prims, beta_dt, t):
        return {lev: u.at[:, IEN].add(beta_dt * EDOT * prims[lev][:, IDN]
                                      * (1.0 + t))
                for lev, u in state.items()}
    return src


def _torch_heating_smr(pin, smesh, cfg, eos):
    def src(state, prims, beta_dt, t):
        for lev, u in state.items():
            u[:, IEN] += beta_dt * EDOT * prims[lev][:, IDN] * (1.0 + t)
        return state
    return src


@pytest.mark.parametrize("rung", ["stage", "negdiv"])
def test_unsplit_problem_source_on_smr_matches_jax(rung, monkeypatch,
                                                   tmp_path):
    monkeypatch.setattr(jlw, "problem_source_unsplit_smr", _jax_heating_smr,
                        raising=False)
    monkeypatch.setattr(tlw, "problem_source_unsplit_smr",
                        _torch_heating_smr, raising=False)
    monkeypatch.setenv("ATHENAPK_PALLAS_STAGE",
                       "1" if rung == "stage" else "0")
    deck = linwave3d_deck(nx=(16, 8, 8), mb=(8, 8, 8), integrator="unsplit",
                          refinement="static",
                          region=(0.0, 1.5, 0.0, 1.5, 0.0, 1.5))
    js, ts = _both(deck, tmp_path)
    assert ts.stepper._stage_rung == (rung == "stage")
    assert ts.stepper._need_prim() and not ts._split_loop()
    assert ts.ncycle == js.ncycle == 5
    assert _rel_levels({k: v.numpy() for k, v in ts.state.items()},
                       js.state) <= TOL
