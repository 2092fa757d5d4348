"""Port parity: the adaptive refined-mesh slice as a whole in 3-D,
``amr.driver.SmrSimulation`` on ``refinement = adaptive`` against the JAX
package's ``SmrSimulation`` on the CPU in f64.

The deck is ``inputs/blast_3d_adaptive.in`` as written (32^3, 8^3 blocks,
PLM + HLLC, RK2, pressure gradient at 0.5) with ``derefine_count = 1``.
Both packages run their initial-refinement loop (the leaf tables and the
port's initial state equal the JAX package's bitwise), then start from
the JAX state times seeded noise (``torch_decks.symmetry_noise``: the
blast is exactly symmetric, where compiled and eager steps differ by a
select flip) and run 8 cycles in lockstep.  After every cycle the leaf
tables are equal, the per-level states agree to 1e-12 relative, and the
time and the step (``tm_dt``) to 1e-12 relative; the run must refine and
derefine.  The 2-D and GLM-MHD decks are in ``test_torch_amr_driver_2d.py``.

Also: the CLI routes an adaptive deck, ``check_interval`` sets the remesh
cadence, and the features the port lacks are refused on adaptive decks.
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
from athenapk_tpu_torch.eos.adiabatic import cons_to_prim
from torch_decks import symmetry_noise

torch.set_num_threads(2)

TOL = 1e-12
DECK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "inputs", "blast_3d_adaptive.in")
OVERRIDES = ["parthenon/mesh/derefine_count=1", "parthenon/output0/dt=-1"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _table(sm):
    return tuple(np.asarray(x) for x in (sm.levels, sm.lx1, sm.lx2, sm.lx3))


def _kinds(old, new):
    """'refine' / 'derefine' for the leaves of table ``new`` that ``old``
    lacks: made from their parent, or from their children."""
    have = set(zip(*(x.tolist() for x in old)))
    out = set()
    for lev, a, b, c in zip(*(x.tolist() for x in new)):
        if (lev, a, b, c) not in have:
            out.add("refine" if (lev - 1, a // 2, b // 2, c // 2) in have
                    else "derefine")
    return out


def lockstep(jsim, tsim, ncycles, seed=0):
    """Noise the JAX simulation's initial state, load it into both, and
    run them one cycle at a time, holding the leaf table, the state, the
    time and the step after every cycle.  Returns the kinds of remesh
    seen."""
    for a, b in zip(_table(tsim._smesh_now()), _table(jsim._smesh_now())):
        np.testing.assert_array_equal(a, b)
    for lev, u in jsim.state.items():
        np.testing.assert_array_equal(tsim.state[lev].numpy(), np.asarray(u))
    start = symmetry_noise({lev: np.asarray(u)
                            for lev, u in jsim.state.items()}, seed=seed)
    jsim.state = {lev: jnp.asarray(v) for lev, v in start.items()}
    tsim.load_state(start, 0.0, 0)
    kinds = set()
    table = _table(jsim._smesh_now())
    for k in range(1, ncycles + 1):
        jsim.nlim = tsim.nlim = k
        jsim.run()
        tsim.run()
        assert tsim.ncycle == jsim.ncycle == k
        new = _table(jsim._smesh_now())
        for a, b in zip(_table(tsim._smesh_now()), new):
            np.testing.assert_array_equal(a, b, err_msg=f"cycle {k}")
        kinds |= _kinds(table, new)
        table = new
        assert sorted(tsim.state) == sorted(jsim.state)
        for lev, u in jsim.state.items():
            assert _rel(tsim.state[lev].numpy(), u) <= TOL, (k, lev)
        assert abs(tsim.t - jsim.t) <= TOL * jsim.t, k
        assert abs(tsim.tm_dt - jsim.tm_dt) <= TOL * jsim.tm_dt, k
    return kinds


def test_blast_3d_adaptive_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jsim = JSim(JPin.from_file(DECK, OVERRIDES), quiet=True)
    tsim = SmrSimulation(ParameterInput.from_file(DECK, OVERRIDES),
                         quiet=True, device="cpu")
    assert tsim.adaptive and tsim.driver.derefine_count == 1
    kinds = lockstep(jsim, tsim, 8)
    assert kinds == {"refine", "derefine"}
    assert tsim.perf_remeshes >= 1
    # a revisited topology reuses its stepper
    log = tsim.driver.remesh_log
    assert sum(e["changed"] for e in log) > sum(e["new_topology"]
                                                for e in log)
    assert len(tsim.driver._steppers) == 1 + sum(e["new_topology"]
                                                 for e in log)


def test_cli_runs_an_adaptive_deck_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert tdriver.main(["-i", DECK, "--device", "cpu",
                         "parthenon/mesh/derefine_count=1",
                         "parthenon/time/ncycle_out_mesh=-1",
                         "parthenon/time/nlim=3"]) == 0
    out = capsys.readouterr().out
    assert "cycle=3 " in out and "blocks={0: 56, 1: 64}" in out
    assert "blocks={0: 32, 1: 256}" in out
    assert "mesh structure (cycle " in out
    assert "zone-cycles/wallsecond = " in out
    assert (tmp_path / "blast.out0.hst").exists()


def test_fofc_adaptive_deck_runs_on_the_cpu(tmp_path, monkeypatch):
    """First-order flux correction on an adaptive deck (it was refused
    before): every stepper the run builds takes the negdiv-faces rung, and
    the leaves still change while the state stays finite and positive."""
    monkeypatch.chdir(tmp_path)
    sim = SmrSimulation(ParameterInput.from_file(DECK, OVERRIDES + [
        "hydro/first_order_flux_correct=true",
        "parthenon/time/nlim=3"]), quiet=True, device="cpu")
    sim.run()
    assert sim.ncycle == 3
    assert all(not st._stage_rung for st in sim.driver._steppers.values())
    assert len(sim.driver._steppers) >= 2     # the table changed
    st = sim._stepper_now()
    for u in sim.state.values():
        _, w = cons_to_prim(st.eos, u, "euler", 0)
        w = w[st._int_sl]
        assert bool(torch.isfinite(w).all())
        assert w[:, 0].min() > 0 and w[:, 4].min() > 0


def test_adaptive_deck_needs_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdriver.main(["-i", DECK, "parthenon/time/nlim=1"])
    with pytest.raises(NotImplementedError, match="SmrSimulation"):
        tdriver.Simulation(ParameterInput.from_file(DECK), device="cpu")


CADENCE_DECK = """
<job>
problem_id = advection

<problem/advection>
vx = 1.0
vy = 0.0
vz = 0.0
rho_ratio = 8.0
rho_radius = 0.12
rho0 = 1.0
p0 = 1.0

<parthenon/mesh>
refinement = adaptive
numlevel = 2
check_interval = 4
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 0.5
nx2 = 16
x2min = -0.25
x2max = 0.25
nx3 = 16
x3min = -0.25
x3max = 0.25

<parthenon/meshblock>
nx1 = 8
nx2 = 8
nx3 = 8

<refinement>
type = maxdensity
maxdensity_refine_above = 3.0
maxdensity_deref_below = 1.5

<parthenon/time>
integrator = rk2
cfl = 0.3
tlim = 1.0
nlim = 6
ncycle_out = 0

<hydro>
fluid = euler
eos = adiabatic
riemann = hllc
reconstruction = plm
gamma = 1.6666666666666667
"""


def test_check_interval_limits_remesh_cadence():
    """Twin of ``tests/test_remesh.py::
    test_check_interval_limits_remesh_cadence``: with check_interval = 4
    the refinement checks come at cycles 0 and 4 only (6 cycles)."""
    sim = SmrSimulation(ParameterInput.from_string(CADENCE_DECK), quiet=True,
                        device="cpu")
    assert sim.driver.check_interval == 4
    calls = []
    orig = sim.driver.maybe_remesh

    def spy(state, tags=None):
        calls.append((sim.ncycle, tags is not None))
        return orig(state, tags)

    sim.driver.maybe_remesh = spy
    sim.run()
    # the tags come with the dt read, never from a read of their own
    assert calls == [(0, True), (4, True)], calls


@pytest.mark.parametrize("override,match", [
    ("parthenon/output1/file_type=hdf5", "hdf5"),
    ("parthenon/output1/file_type=rst", "rst"),
    ("tracers/enabled=true", "tracers"),
    ("diffusion/viscosity=isotropic", "diffusion"),
    ("diffusion/conduction=isotropic", "diffusion"),
    ("job/problem_id=rand_blast", "rand_blast"),
])
def test_unported_features_raise_on_adaptive_decks(override, match, tmp_path,
                                                   monkeypatch):
    """The features the port lacks raise; those ported since (diffusion,
    ``rand_blast``, hdf5 and rst outputs, tracers: ``RUN_NOW``) run the
    deck."""
    monkeypatch.chdir(tmp_path)
    if match in RUN_NOW:
        sim = SmrSimulation(ParameterInput.from_file(DECK, [override]
                            + RUN_NOW[match]), quiet=True, device="cpu")
        sim.run()
        assert sim.ncycle >= 1 and all(
            bool(torch.isfinite(u).all()) for u in sim.state.values())
        return
    pin = ParameterInput.from_file(DECK, [override])
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
