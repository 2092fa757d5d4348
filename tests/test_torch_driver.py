"""Port parity for the whole slice: the ``bench.py:run_bench`` deck (3-D
GLM-MHD linear wave, HLLD + PPM + VL2, all periodic) through the JAX
``Simulation`` and the port's ``Simulation``, plus a port-only twin of
``tests/test_convergence.py::test_mhd_linear_wave_convergence``.

Both packages start from the same state (the JAX initial state handed to
the port with ``load_state``) and run 5 cycles in f64 on the CPU.  The
tests set ``merge_blocks`` explicitly: the test configuration gives JAX 8
virtual devices (``tests/conftest.py``), so ``auto`` would not merge there
while the port, one device per process, would.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.driver import Simulation as JSim
from athenapk_tpu_torch import driver as tdriver
from athenapk_tpu_torch.config.parameter_input import ParameterInput as TPin
from athenapk_tpu_torch.driver import Simulation as TSim

torch.set_num_threads(2)

DECK = """
<job>
problem_id = linear_wave_mhd

<problem/linear_wave>
compute_error = true
wave_flag = {wave_flag}
amp = 1.0e-6
vflow = {vflow}
test = true

<parthenon/mesh>
nghost = {nghost}
merge_blocks = {merge}
nx1 = {nx1}
x1min = 0.0
x1max = 3.0
nx2 = {nx2}
x2min = 0.0
x2max = 1.5
nx3 = {nx2}
x3min = 0.0
x3max = 1.5

<parthenon/meshblock>
nx1 = {mb}
nx2 = {mb}
nx3 = {mb}

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = {tlim}
nlim = {nlim}
ncycle_out = 0

<hydro>
fluid = glmmhd
eos = adiabatic
riemann = hlld
reconstruction = {recon}
gamma = 1.666666666666667

<parthenon/output1>
file_type = hst
"""

# the run_bench deck at 16^3, one history row per cycle
BENCH = dict(wave_flag=0, vflow=0.0, nghost=3, nx1=16, nx2=16, recon="ppm",
             tlim=100.0, nlim=5)


def _deck(**kw):
    return DECK.format(**{**BENCH, **kw})


def _run_in(path, sim):
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return sim.run()
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("merge,mb", [("true", 16), ("false", 8)],
                         ids=["merged_ghostfree", "ghosted_8_blocks"])
def test_slice_matches_jax(merge, mb, tmp_path):
    deck = _deck(merge=merge, mb=mb)
    js = JSim(JPin.from_string(deck), quiet=True)
    ts = TSim(TPin.from_string(deck), quiet=True, device="cpu")
    assert dataclasses.asdict(ts.mesh) == dataclasses.asdict(js.mesh)
    ts.load_state(np.asarray(js.u), js.t, js.ncycle)
    assert ts.u.dtype == torch.float64 and ts.u.device.type == "cpu"
    _run_in(tmp_path / "jax", js)
    _run_in(tmp_path / "torch", ts)

    # state after 5 cycles: 1e-10 relative (rounding-order differences
    # only; measured ~1e-15)
    a = np.asarray(js.u)
    b = ts.u.numpy()
    assert ts.ncycle == js.ncycle == 5
    assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    assert ts.t == pytest.approx(js.t, rel=1e-10)

    hj = np.loadtxt(tmp_path / "jax" / "linear_wave_mhd.out1.hst")
    ht = np.loadtxt(tmp_path / "torch" / "linear_wave_mhd.out1.hst")
    assert hj.shape == ht.shape == (7, 10)   # initial + 5 cycles + final
    # time and every cycle's dt, mass, KE, total and magnetic energy
    for col in (0, 1, 2, 6, 7, 8):
        np.testing.assert_allclose(ht[:, col], hj[:, col], rtol=1e-10)
    # momentum sums cancel to roundoff (~1e-22) over the periodic wave, and
    # the two packages sum in different orders
    np.testing.assert_allclose(ht[:, 3:6], hj[:, 3:6], rtol=0, atol=1e-18)
    # relDivB is a central difference of O(1) fields, so state roundoff
    # (~1e-16) enters it at ~1e-16/dx
    np.testing.assert_allclose(ht[:, 9], hj[:, 9], rtol=0, atol=1e-14)

    ej = np.loadtxt(tmp_path / "jax" / "linearwave-errors.dat")
    et = np.loadtxt(tmp_path / "torch" / "linearwave-errors.dat")
    # printed with 7 significant digits
    np.testing.assert_allclose(et, ej, rtol=1e-6)


@pytest.mark.parametrize("wave_flag,vflow", [(0, 0.0), (1, 0.0), (2, 0.0),
                                             (3, 1.0)])
def test_mhd_linear_wave_convergence_port(wave_flag, vflow, tmp_path):
    """Port twin of test_mhd_linear_wave_convergence: PLM + HLLD + VL2,
    one wave period at the 16 and 32 classes, same gates."""
    errs = []
    for nx1 in (16, 32):
        deck = _deck(wave_flag=wave_flag, vflow=vflow, nghost=2, nx1=nx1,
                     nx2=nx1 // 2, mb=nx1 // 2, merge="auto", recon="plm",
                     tlim=1.0, nlim=100000)
        sim = TSim(TPin.from_string(deck), quiet=True, device="cpu")
        assert sim.mesh.nblocks == 1 and sim.mesh.nghost == 0
        errs.append(_run_in(tmp_path / str(nx1), sim)
                    .linear_wave_errors["rms"])
    e16, e32 = errs
    assert e32 < 4.0e-7, f"32-class RMS-L1 {e32:.3e}"
    assert np.log2(e16 / e32) > 1.3


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSim(TPin.from_string(_deck(merge="true", mb=16)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdriver.main(["-i", os.devnull])


@pytest.mark.parametrize("override,match", [
    (["hydro/riemann=none", "hydro/reconstruction=dc"], "none"),
    ("parthenon/output2/file_type=hdf5", "hdf5"),
    ("parthenon/output2/file_type=rst", "rst"),
    ("tracers/enabled=true", "tracers"),
    ("parthenon/mesh/refinement=static", "refinement"),
    ("parthenon/mesh/refinement=adaptive", "refinement"),
    ("diffusion/conduction=isotropic", "diffusion"),
    ("cooling/enable_cooling=tabular", "cooling"),
    ("hydro/first_order_flux_correct=true", "first_order_flux_correct"),
    ("hydro/reconstruction=wenoz", "wenoz"),
    ("job/problem_id=sod", "sod"),
])
def test_unported_features_raise(override, match):
    overrides = override if isinstance(override, list) else [override]
    pin = TPin.from_string(_deck(merge="true", mb=16), overrides)
    with pytest.raises(NotImplementedError, match=match):
        TSim(pin, device="cpu").run()


@pytest.mark.parametrize("argv,match", [(["-r", "x.rhdf"], "restart"),
                                        (["-t", "trace", "-i", "x"], "-t")])
def test_cli_unported_options_raise(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        tdriver.main(argv)


def test_cli_runs_a_deck_on_the_cpu(tmp_path, monkeypatch, capsys):
    deck = tmp_path / "lw.in"
    deck.write_text(_deck(merge="true", mb=8, nx1=8, nx2=8, nlim=2))
    monkeypatch.chdir(tmp_path)
    assert tdriver.main(["-i", str(deck), "--device", "cpu",
                         "parthenon/time/ncycle_out=1",
                         "parthenon/time/perf_cycle_offset=1"]) == 0
    out = capsys.readouterr().out
    assert "cycle=2 " in out
    assert "zone-cycles/wallsecond = " in out
    assert (tmp_path / "linear_wave_mhd.out1.hst").exists()
    assert (tmp_path / "linearwave-errors.dat").exists()


def test_single_precision_sets_the_state_dtype(tmp_path):
    sim = TSim(TPin.from_string(_deck(merge="true", mb=16, nlim=2),
                                ["hydro/precision=single"]),
               quiet=True, device="cpu")
    assert sim.u.dtype == torch.float32
    _run_in(tmp_path, sim)
    assert sim.u.dtype == torch.float32
    assert torch.isfinite(sim.u).all()
    assert torch.get_default_dtype() == torch.float32   # nothing global
