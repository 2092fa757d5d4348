"""Port parity for the reference performance suite's method matrix
(``tst/regression/test_suites/performance/performance.py:32-54``, mirrored
by ``scripts/performance_grid.py:33-50``): the seven (fluid, integrator,
reconstruction, Riemann solver) combinations that the port took up with
WENO3, LimO3, WENO-Z and GLM-MHD HLLE, each a 3-D linear wave (the grid's
deck at 16^3 in one block, 3 cycles, f64) through the JAX package's CLI
and the port's (``run_from_file``, what each ``main`` runs on ``-i``; the
port's on the CPU): the final states, and the history rows that each run
writes.

Tolerances: the state 1e-12 relative to its largest magnitude (the same
operations; rounding-order differences only).  The history rows take
``tests/test_torch_driver.py``'s gates: time, dt, mass and the energies
1e-10 relative (the kinetic energy of a 1e-6 wave is a sum of 1e-12
squares, in which the state's roundoff is ~1e-11 relative); the momentum
sums cancel to roundoff over the periodic wave and are summed in
different orders, 1e-18 absolute; relDivB is a central difference of O(1)
fields, 1e-14 absolute.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from athenapk_tpu import driver as jdriver
from athenapk_tpu_torch import driver as tdriver

torch.set_num_threads(2)

DECK = """
<job>
problem_id = {pid}

<problem/linear_wave>
compute_error = false
wave_flag = 0
amp = 1.0e-6
test = true

<parthenon/mesh>
nghost = 3
merge_blocks = true
nx1 = 16
x1min = 0.0
x1max = 3.0
nx2 = 16
x2min = 0.0
x2max = 1.5
nx3 = 16
x3min = 0.0
x3max = 1.5

<parthenon/meshblock>
nx1 = 16
nx2 = 16
nx3 = 16

<parthenon/time>
integrator = {integ}
cfl = 0.3
tlim = 100.0
nlim = 3
ncycle_out = 0

<hydro>
fluid = {fluid}
eos = adiabatic
riemann = {riemann}
reconstruction = {recon}
gamma = 1.666666666666667

<parthenon/output1>
file_type = hst
dt = 0.0
"""

# the combinations of the grid that the port's kernels refused before
MISSING = [
    ("euler", "rk3", "wenoz", "hlle"),
    ("glmmhd", "vl2", "plm", "hlle"),
    ("glmmhd", "vl2", "weno3", "hlle"),
    ("glmmhd", "rk2", "weno3", "hlle"),
    ("glmmhd", "rk3", "weno3", "hlle"),
    ("glmmhd", "rk2", "limo3", "hlle"),
    ("glmmhd", "rk3", "wenoz", "hlle"),
]


@pytest.mark.parametrize("fluid,integ,recon,riemann", MISSING,
                         ids=["-".join(c) for c in MISSING])
def test_performance_matrix_matches_jax(fluid, integ, recon, riemann,
                                        tmp_path, monkeypatch):
    pid = "linear_wave_mhd" if fluid == "glmmhd" else "linear_wave"
    deck = tmp_path / "wave.in"
    deck.write_text(DECK.format(pid=pid, fluid=fluid, integ=integ,
                                recon=recon, riemann=riemann))
    rows, states = {}, {}
    # LimO3 selects on the ratio of neighbouring differences, which at the
    # wave's extrema and in its constant fields are roundoff: there the
    # compiled JAX step rounds some ratios across a select; its eager step
    # does the port's operations
    eager = jax.disable_jit() if recon == "limo3" else contextlib.nullcontext()
    for name, run in (("jax", lambda: jdriver.run_from_file(str(deck),
                                                            quiet=True)),
                      ("torch", lambda: tdriver.run_from_file(
                          str(deck), quiet=True, device="cpu"))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        with eager if name == "jax" else contextlib.nullcontext():
            sim = run()
        assert sim.ncycle == 3
        states[name] = np.asarray(sim.u) if name == "jax" else sim.u.numpy()
        rows[name] = np.loadtxt(tmp_path / name / f"{pid}.out1.hst")
    uj, ut = states["jax"], states["torch"]
    assert uj.shape == ut.shape
    assert np.abs(ut - uj).max() <= 1e-12 * np.abs(uj).max()
    hj, ht = rows["jax"], rows["torch"]
    assert hj.shape == ht.shape and hj.shape[0] == 5  # initial + 3 + final
    mhd = fluid == "glmmhd"
    # time, dt, mass, kinetic and total (and magnetic) energy
    cols = (0, 1, 2, 6, 7, 8) if mhd else (0, 1, 2, 6, 7)
    for col in cols:
        np.testing.assert_allclose(ht[:, col], hj[:, col], rtol=1e-10)
    np.testing.assert_allclose(ht[:, 3:6], hj[:, 3:6], rtol=0, atol=1e-18)
    if mhd:
        np.testing.assert_allclose(ht[:, 9], hj[:, 9], rtol=0, atol=1e-14)
    # the wave moved: dt > 0 every cycle and the state stayed finite
    assert np.isfinite(ht).all() and (ht[1:-1, 1] > 0).all()
