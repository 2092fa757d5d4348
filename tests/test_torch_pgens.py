"""Port parity for the problem generators: every generator that the port
copies gives the JAX package's initial state bit for bit (both are numpy),
its hooks act alike, and ``Simulation.load_state`` carries a JAX state onto
the new decks, after which both packages step alike.
"""

import os

import numpy as np
import pytest
import torch

from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.driver import Simulation as JSim
from athenapk_tpu.eos.adiabatic import EOS as JEOS
from athenapk_tpu.pgen import get_pgen as jget_pgen
from athenapk_tpu.solver.hydro_pkg import HydroConfig as JCfg
from athenapk_tpu.utils import exact_riemann as jexact
from athenapk_tpu_torch.config.parameter_input import ParameterInput as TPin
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation as TSim
from athenapk_tpu_torch.eos.adiabatic import EOS
from athenapk_tpu_torch.pgen import get_pgen
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig
from athenapk_tpu_torch.utils import exact_riemann
from torch_decks import CASES, deck as _deck

torch.set_num_threads(2)


def _initial_state(pin, mesh_cls, cfg_cls, eos_cls, registry):
    pgen = registry(pin.get_string("job", "problem_id"))
    hook = getattr(pgen, "init_user_mesh_data", None)
    if hook is not None:
        hook(pin)
    mesh = mesh_cls.from_parameter_input(pin)
    cfg = cfg_cls.from_parameter_input(pin)
    eos = eos_cls.from_parameter_input(pin)
    return np.asarray(pgen.problem_generator(pin, mesh, cfg, eos)), pin


@pytest.mark.parametrize("case", sorted(CASES))
def test_initial_state_is_bitwise_the_jax_pgens(case):
    deck = _deck(**CASES[case])
    ju, jpin = _initial_state(JPin.from_string(deck), JMesh, JCfg, JEOS,
                              jget_pgen)
    tu, tpin = _initial_state(TPin.from_string(deck), Mesh, HydroConfig, EOS,
                              get_pgen)
    assert tu.dtype == ju.dtype == np.float64 and tu.shape == ju.shape
    assert np.array_equal(tu, ju)
    assert np.isfinite(tu).all() and np.abs(tu).max() > 0.0
    # the advection hook rescales tlim; the others leave it
    assert tpin.get_real("parthenon/time", "tlim") \
        == jpin.get_real("parthenon/time", "tlim")


def test_registry_lists_the_ported_problems():
    for pid in ("sod", "orszag_tang", "blast", "lw_implode", "field_loop",
                "cpaw", "kh", "advection", "linear_wave", "linear_wave_mhd"):
        assert callable(get_pgen(pid).problem_generator)
    assert callable(get_pgen("cloud").check_refinement_block)
    # the diffusion and split-source problems
    assert callable(get_pgen("diffusion").problem_generator)
    assert callable(get_pgen("rand_blast").problem_source_first_order)
    assert callable(get_pgen("turbulence").problem_source_first_order_smr)
    # the cluster, the last problem ported
    assert callable(get_pgen("cluster").problem_generator_smr)
    with pytest.raises(ValueError):
        get_pgen("no_such_problem")


@pytest.mark.parametrize("left,right", [
    ((1.0, 0.0, 1.0), (0.125, 0.0, 0.1)),      # Sod: rarefaction + shock
    ((1.0, 0.75, 1.0), (0.125, 0.0, 0.1)),     # Toro test 1
    ((1.0, -2.0, 0.4), (1.0, 2.0, 0.4)),       # two rarefactions
    ((1.0, 2.0, 0.4), (1.0, -2.0, 0.4)),       # two shocks
], ids=["sod", "toro1", "two_rarefactions", "two_shocks"])
def test_exact_riemann_copy_matches(left, right):
    """The port's copy of the exact Riemann solution (Sod's reference)
    against the JAX package's module, bit for bit."""
    xi = np.linspace(-4.0, 4.0, 513)
    assert exact_riemann.solve_star(*left, *right, 1.4) \
        == jexact.solve_star(*left, *right, 1.4)
    got = exact_riemann.sample(xi, *left, *right, 1.4)
    ref = jexact.sample(xi, *left, *right, 1.4)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b) and np.isfinite(a).all()


def _run_in(path, sim):
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return sim.run()
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("case", ["sod_1d", "blast_2d", "lw_implode",
                                  "field_loop_1", "kh_4", "cpaw_3d",
                                  "advection"])
def test_loaded_jax_state_steps_alike(case, tmp_path):
    """``load_state`` takes the JAX state (ghosted multi-block layouts
    included) and both packages then take the same 5 cycles: state to 1e-10
    of its largest magnitude, time to 1e-10."""
    deck = _deck(**CASES[case])
    js = JSim(JPin.from_string(deck), quiet=True)
    ts = TSim(TPin.from_string(deck), quiet=True, device="cpu")
    assert ts.mesh.nblocks == js.mesh.nblocks > 1
    assert ts.mesh.nghost == js.mesh.nghost > 0
    # the port's own initial state, ghosts filled, is the JAX one already
    assert np.array_equal(ts.u.numpy(), np.asarray(js.u))
    ts.load_state(np.asarray(js.u), js.t, js.ncycle)
    _run_in(tmp_path / "jax", js)
    _run_in(tmp_path / "torch", ts)
    a, b = np.asarray(js.u), ts.u.numpy()
    assert ts.ncycle == js.ncycle == 5
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    assert ts.t == pytest.approx(js.t, rel=1e-10)
    if case == "cpaw_3d":
        # user_work_after_loop wrote the same error line (6 printed digits)
        ej = np.loadtxt(tmp_path / "jax" / "cpaw-errors.dat")
        et = np.loadtxt(tmp_path / "torch" / "cpaw-errors.dat")
        np.testing.assert_allclose(et, ej, rtol=1e-5)
        assert ts.cpaw_errors["rms"] == pytest.approx(js.cpaw_errors["rms"],
                                                      rel=1e-8)
