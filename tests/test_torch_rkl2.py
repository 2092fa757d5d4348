"""Port parity: RKL2 super-time-stepping and the uniform driver's
non-pipelined branch.

``sts_half_step`` of the port's ``HydroPackage`` and ``SmrHydro`` against
the JAX package's on the same state (the diffusive linear wave of
``tests/test_diffusion_linwave3d.py``, ``torch_decks.linwave3d_deck``):
the state after the super-step to 1e-12 relative to its largest value
(measured ~1e-16) and the stage count s.  Then both drivers' entry
points (``run_from_file``, what the CLIs run) on that deck at 16x8x8 for
5 cycles with unsplit and with RKL2 diffusion: the ``.hst`` rows (every
cycle) and the final state (the JAX package keeps its ghosts where it
sees several devices, the port merges into one ghost-free block, so the
interiors are compared).
"""

import os

import numpy as np
import pytest
import torch

from athenapk_tpu import driver as jdriver
from athenapk_tpu.amr.driver import SmrSimulation as JSmr
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.driver import Simulation as JSim
from athenapk_tpu_torch import driver as tdriver
from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.driver import Simulation
from athenapk_tpu_torch.solver.hydro_pkg import rkl2_stage_count
from torch_decks import linwave3d_deck

torch.set_num_threads(2)

TOL = 1e-12
REGION = (0.0, 1.5, 0.0, 1.5, 0.0, 1.5)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _count_calls(obj, name):
    """Wrap ``obj.name`` to count its calls; -> the counter list."""
    calls = []
    fn = getattr(obj, name)

    def wrapped(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    setattr(obj, name, wrapped)
    return calls


@pytest.mark.parametrize("ratio", [200.0, 0.1])
def test_sts_half_step_matches_jax_uniform(ratio):
    deck = linwave3d_deck(integrator="rkl2", merge="false", ratio=ratio)
    js = JSim(JPin.from_string(deck), quiet=True)
    ts = Simulation(ParameterInput.from_string(deck), quiet=True,
                    device="cpu")
    ts.load_state(np.asarray(js.u), 0.0, 0)
    _, jdt_hyp = js._estimate()
    jdt_diff = js.dt_diff
    dt, _ = ts._estimate()
    assert ts.dt_diff == pytest.approx(jdt_diff, rel=1e-15)
    tau = 0.5 * dt
    jcalls = _count_calls(js.pkg, "_rkl2_other")
    want = np.asarray(js.pkg.sts_half_step(js.u, tau, jdt_diff))
    got = ts.pkg.sts_half_step(ts.u, tau, ts.dt_diff).numpy()
    s = rkl2_stage_count(tau, ts.dt_diff)
    assert s % 2 == 1 and s > 1
    assert ts.pkg.rkl2_stages == s == len(jcalls) + 1
    assert _rel(got, want) <= TOL
    assert _rel(got, np.asarray(js.u)) > 1e-10   # the super-step did work


def test_sts_half_step_matches_jax_refined():
    deck = linwave3d_deck(nx=(16, 8, 8), mb=(8, 8, 8), integrator="rkl2",
                          refinement="static", region=REGION)
    js = JSmr(JPin.from_string(deck), quiet=True)
    ts = SmrSimulation(ParameterInput.from_string(deck), quiet=True,
                       device="cpu")
    assert {lev: v.shape[0] for lev, v in ts.state.items()} == {0: 1, 1: 8}
    jdt, jdt_diff = (float(v) for v in
                     js.stepper.estimate_dt_with_diff(js.state))
    tdt, tdt_diff = (float(v) for v in
                     ts.stepper.estimate_dt_with_diff(ts.state))
    assert (tdt, tdt_diff) == pytest.approx((jdt, jdt_diff), rel=1e-14)
    tau = 0.5 * jdt
    jcalls = _count_calls(js.stepper, "_rkl2_other")
    want = js.stepper.sts_half_step(js.state, tau, jdt_diff)
    got = ts.stepper.sts_half_step(ts.state, tau, jdt_diff)
    assert ts.stepper.rkl2_stages == len(jcalls) + 1 \
        == rkl2_stage_count(tau, jdt_diff)
    for lev in want:
        assert _rel(got[lev].numpy(), want[lev]) <= TOL, lev


def _cli_run(pkg_driver, deck, path, **kw):
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        with open("deck.in", "w") as fh:
            fh.write(deck)
        sim = pkg_driver.run_from_file("deck.in", quiet=True, **kw)
        return sim, np.loadtxt("linear_wave_mhd.out2.hst")
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("integrator", ["unsplit", "rkl2"])
def test_both_drivers_match_on_the_diffusive_wave(integrator, tmp_path):
    deck = linwave3d_deck(integrator=integrator)
    js, hj = _cli_run(jdriver, deck, tmp_path / "jax")
    ts, ht = _cli_run(tdriver, deck, tmp_path / "torch", device="cpu")
    assert ts.ncycle == js.ncycle == 5
    assert ts.t == pytest.approx(js.t, rel=1e-13)
    want = np.asarray(js.cons())[js.mesh.interior_slices]
    assert _rel(ts.cons()[ts.mesh.interior_slices], want) <= TOL
    assert hj.shape == ht.shape == (7, 11)   # initial, 5 cycles, final
    # time, dt, mass, KE, total and magnetic energy (the tolerances of
    # test_torch_driver.py's .hst comparison)
    for col in (0, 1, 2, 6, 7, 8):
        np.testing.assert_allclose(ht[:, col], hj[:, col], rtol=1e-10)
    # MaxAbsV2 of the 1e-4 wave: the states' roundoff (~1e-16 absolute)
    np.testing.assert_allclose(ht[:, 10], hj[:, 10], rtol=0, atol=1e-15)
    # momentum sums cancel to roundoff over the periodic wave
    np.testing.assert_allclose(ht[:, 3:6], hj[:, 3:6], rtol=0, atol=1e-18)
    np.testing.assert_allclose(ht[:, 9], hj[:, 9], rtol=0, atol=1e-14)
    if integrator == "rkl2":
        # the Strang wrap: two half super-steps per cycle
        assert ts.pkg.rkl2_stages >= 2 * 3 * ts.ncycle
        assert ts._split_cycle()
    else:
        assert ts.pkg.rkl2_stages == 0 and not ts._split_cycle()


def test_rkl2_dt_cap_binds_at_the_ratio():
    """With a small ``rkl2_max_dt_ratio`` the step is ratio * dt_diff, as
    in the JAX package; the diffusive dt is read with the CFL minimum."""
    deck = linwave3d_deck(integrator="rkl2", ratio=0.1, merge="false")
    js = JSim(JPin.from_string(deck), quiet=True)
    ts = Simulation(ParameterInput.from_string(deck), quiet=True,
                    device="cpu")
    jdt, jdt_hyp = js._estimate()
    tdt, tdt_hyp = ts._estimate()
    assert tdt == pytest.approx(0.1 * ts.dt_diff, rel=1e-15)
    assert (tdt, tdt_hyp, ts.dt_diff) == pytest.approx(
        (float(jdt), float(jdt_hyp), js.dt_diff), rel=1e-14)
