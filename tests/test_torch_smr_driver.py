"""Port parity: the static refined-mesh slice as a whole in 3-D,
``amr.driver.SmrSimulation`` against the JAX package's ``SmrSimulation`` on
the CPU in f64.

The deck is ``inputs/blast_3d_smr.in`` at nx = 32, meshblock 8 (56 + 64 =
120 leaves, PPM + HLLC, nghost 3).  Both packages start from the JAX
package's initial state times seeded noise (``torch_decks.symmetry_noise``:
the blast is exactly symmetric with zero velocity, where the JAX package's
compiled and eager steps already differ by a select flip) and run 5
cycles; per-level state, every dt and every ``.hst`` column agree to 1e-12
relative (measured ~1e-15), on both rungs of the port (the whole-stage
function per level, the default, and ``ATHENAPK_PALLAS_STAGE=0``, the
-div(F) function per level).  The port's own initial state (problem
generator per leaf + ghost fill) equals the JAX package's bitwise.
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu.amr.driver import SmrSimulation as JSim
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu_torch import driver as tdriver
from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.eos.adiabatic import EOS, cons_to_prim, prim_to_cons
from torch_decks import symmetry_noise

torch.set_num_threads(2)

TOL = 1e-12
DECK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "inputs", "blast_3d_smr.in")
OVERRIDES = ["parthenon/mesh/nx1=32", "parthenon/mesh/nx2=32",
             "parthenon/mesh/nx3=32", "parthenon/meshblock/nx1=8",
             "parthenon/meshblock/nx2=8", "parthenon/meshblock/nx3=8",
             "parthenon/time/nlim=5", "parthenon/output0/dt=-1"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's 5 cycles from its noised initial state: (initial
    state, its own initial state, final state, .hst rows, t)."""
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("jax"))
    try:
        sim = JSim(JPin.from_file(DECK, OVERRIDES), quiet=True)
        own = {lev: np.asarray(u) for lev, u in sim.state.items()}
        start = symmetry_noise(own, seed=0)
        sim.state = {lev: jnp.asarray(v) for lev, v in start.items()}
        sim.run()
        hst = np.loadtxt("blast.out0.hst")
    finally:
        os.chdir(cwd)
    return start, own, {lev: np.asarray(u) for lev, u in sim.state.items()}, \
        hst, sim.t


def test_initial_state_matches_jax_bitwise(jax_run, tmp_path, monkeypatch):
    _, own, _, _, _ = jax_run
    monkeypatch.chdir(tmp_path)
    sim = SmrSimulation(ParameterInput.from_file(DECK, OVERRIDES),
                        quiet=True, device="cpu")
    assert {lev: v.shape[0] for lev, v in sim.state.items()} == {0: 56, 1: 64}
    for lev in own:
        np.testing.assert_array_equal(sim.state[lev].numpy(), own[lev])


@pytest.mark.parametrize("rung", ["stage", "negdiv"])
def test_five_cycles_match_jax(jax_run, rung, tmp_path, monkeypatch):
    start, _, want, hst_want, t_want = jax_run
    monkeypatch.chdir(tmp_path)
    if rung == "negdiv":
        monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "0")
    else:
        monkeypatch.delenv("ATHENAPK_PALLAS_STAGE", raising=False)
    sim = SmrSimulation(ParameterInput.from_file(DECK, OVERRIDES),
                        quiet=True, device="cpu")
    assert sim.stepper._stage_rung == (rung == "stage")
    sim.load_state(start, 0.0, 0)
    sim.run()
    assert sim.ncycle == 5
    for lev in want:
        assert _rel(sim.state[lev].numpy(), want[lev]) <= TOL
    hst = np.loadtxt("blast.out0.hst")
    assert hst.shape == hst_want.shape == (6, 8)
    # time and dt columns, then mass, momenta, KE, total energy
    for col in range(hst.shape[1]):
        assert _rel(hst[:, col], hst_want[:, col]) <= TOL \
            or np.abs(hst[:, col] - hst_want[:, col]).max() <= TOL * np.abs(
                hst_want[:, 2:]).max(), col
    assert abs(sim.t - t_want) <= TOL * t_want


def _blob_state(sim, seed):
    """A density blob moving along x through the refined patch (the state of
    ``tests/test_smr.py:87``), plus seeded noise on the momenta."""
    rng = np.random.default_rng(seed)
    sm, eos = sim.smesh, EOS(gamma=5.0 / 3.0)
    state = {}
    for lev, ids in sm.level_ids.items():
        w = np.zeros((ids.size, 5) + sm.base.block_shape)
        for li, gid in enumerate(ids):
            x, y, z = sm.cell_centers_leaf(gid)
            r2 = (x - 0.2) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
            w[li, 0] = 1.0 + np.broadcast_to(np.exp(-r2 / 0.01),
                                             sm.base.block_shape)
        w[:, 1] = 1.0 + 1e-3 * rng.standard_normal(w[:, 1].shape)
        w[:, 4] = 1.0
        state[lev] = prim_to_cons(eos, torch.tensor(w), "euler")
    return sim.stepper.fill_ghosts(state)


@pytest.mark.parametrize("rung", ["stage", "negdiv"])
def test_smr_evolution_conserves_mass(rung, monkeypatch):
    """Twin of ``tests/test_smr.py::test_smr_evolution_conserves_mass``:
    a blob advected through the level boundary keeps the total mass to
    1e-13 relative (the flux correction), 8 cycles in f64."""
    if rung == "negdiv":
        monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "0")
    else:
        monkeypatch.delenv("ATHENAPK_PALLAS_STAGE", raising=False)
    sim = SmrSimulation(ParameterInput.from_file(DECK, [
        "parthenon/mesh/nx1=16", "parthenon/mesh/nx2=16",
        "parthenon/mesh/nx3=16", "parthenon/meshblock/nx1=8",
        "parthenon/meshblock/nx2=8", "parthenon/meshblock/nx3=8"] + [
        f"parthenon/mesh/x{k}{e}={v}" for k in (1, 2, 3)
        for e, v in (("min", 0.0), ("max", 1.0))] + [
        f"parthenon/static_refinement0/x{k}{e}={v}" for k in (1, 2, 3)
        for e, v in (("min", 0.0), ("max", 0.5))]), quiet=True, device="cpu")
    assert {lev: v.shape[0] for lev, v in sim.state.items()} == {0: 7, 1: 8}
    st = sim.stepper
    state = _blob_state(sim, seed=1)
    m0 = st.total_mass(state)
    dt = float(st.estimate_dt(state))
    for _ in range(8):
        state = st.step(state, dt, 0.0)
    assert abs(st.total_mass(state) - m0) / m0 < 1e-13
    assert all(bool(torch.isfinite(v).all()) for v in state.values())


def test_cli_runs_a_refined_deck_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert tdriver.main(["-i", DECK, "--device", "cpu",
                         "parthenon/mesh/nx1=16", "parthenon/mesh/nx2=16",
                         "parthenon/mesh/nx3=16", "parthenon/meshblock/nx1=8",
                         "parthenon/meshblock/nx2=8",
                         "parthenon/meshblock/nx3=8",
                         "parthenon/static_refinement0/x1min=0.0",
                         "parthenon/static_refinement0/x2min=0.0",
                         "parthenon/static_refinement0/x3min=0.0",
                         "parthenon/time/nlim=2"]) == 0
    out = capsys.readouterr().out
    assert "cycle=2 " in out and "blocks={0: 7, 1: 8}" in out
    assert "zone-cycles/wallsecond = " in out
    assert (tmp_path / "blast.out0.hst").exists()


@pytest.mark.parametrize("override,match", [
    ("parthenon/output1/file_type=hdf5", "hdf5"),
    ("parthenon/output1/file_type=rst", "rst"),
    ("tracers/enabled=true", "tracers"),
    ("diffusion/viscosity=isotropic", "diffusion"),
    ("diffusion/conduction=isotropic", "diffusion"),
    ("job/problem_id=rand_blast", "rand_blast"),
])
def test_unported_refined_features_raise(override, match, tmp_path,
                                         monkeypatch):
    """The features the port lacks raise; those ported since (diffusion,
    ``rand_blast``, hdf5 and rst outputs, tracers: ``RUN_NOW``) run the
    deck."""
    monkeypatch.chdir(tmp_path)
    if match in RUN_NOW:
        sim = SmrSimulation(ParameterInput.from_file(DECK, OVERRIDES + [override]
                            + RUN_NOW[match]), quiet=True, device="cpu")
        sim.run()
        assert sim.ncycle >= 1 and all(
            bool(torch.isfinite(u).all()) for u in sim.state.values())
        return
    pin = ParameterInput.from_file(DECK, OVERRIDES + [override])
    with pytest.raises(NotImplementedError, match=match):
        SmrSimulation(pin, device="cpu").run()


# the overrides that make a formerly refused case a runnable deck (the
# blast deck is Euler: rand_blast needs the GLM-MHD variables)
RUN_NOW = {"diffusion": ["diffusion/conduction_coeff=fixed",
                         "diffusion/thermal_diff_coeff_code=0.01",
                         "diffusion/viscosity_coeff=fixed",
                         "diffusion/mom_diff_coeff_code=0.01",
                         "parthenon/time/nlim=2"],
           "rand_blast": ["hydro/fluid=glmmhd", "hydro/riemann=hlle",
                          "parthenon/time/nlim=2"],
           "hdf5": ["parthenon/time/nlim=2"], "rst": ["parthenon/time/nlim=2"],
           "tracers": ["tracers/initial_seed_method=random_per_block",
                       "tracers/initial_num_tracers_per_cell=0.01",
                       "parthenon/time/nlim=2"]}


def test_cli_runs_a_refined_fofc_deck_on_the_cpu(tmp_path, monkeypatch):
    """First-order flux correction on a refined deck (it was refused
    before): the CLI's ``run_from_file`` runs it on the negdiv-faces rung,
    as the JAX package's ``_use_stage_fused`` puts such decks, and the
    state stays finite with positive density and pressure."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("ATHENAPK_PALLAS_STAGE", raising=False)
    sim = tdriver.run_from_file(DECK, OVERRIDES[:6] + [
        "hydro/first_order_flux_correct=true", "hydro/reconstruction=limo3",
        "parthenon/time/nlim=2"], quiet=True, device="cpu")
    assert sim.ncycle == 2
    st = sim._stepper_now()
    assert not st._stage_rung and st.cfg.first_order_flux_correct
    for u in sim.state.values():
        _, w = cons_to_prim(st.eos, u, "euler", 0)
        w = w[st._int_sl]
        assert bool(torch.isfinite(w).all())
        assert w[:, 0].min() > 0 and w[:, 4].min() > 0


def test_refined_deck_needs_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdriver.run_from_file(DECK, OVERRIDES)
    with pytest.raises(NotImplementedError, match="SmrSimulation"):
        tdriver.Simulation(ParameterInput.from_file(DECK, OVERRIDES),
                           device="cpu")
