"""Port parity: the galaxy-cluster problem (``pgen/cluster/``) on a uniform
mesh against the JAX package on the CPU in f64.

* twins of ``tests/test_cluster.py`` (the HSE atmosphere stays static; the
  profile follows the entropy relation) and of
  ``tests/test_cluster_perturb.py`` (rms of the perturbations, divB): the
  latter's all-periodic deck merges into one block that keeps its ghosts
  (``needs_ghosts_at_init``), where the JAX package's merge would drop
  them and its perturbation refuse the deck;
* the initial states of ``problem_generator`` against the JAX package's
  on the same layout: uniform gas with a uniform and a dipole field bit
  for bit (the same numpy operations in both), the HSE atmosphere, the
  tower's initial field and both perturbations to 1e-12 (the JAX package
  evaluates K(r) and the tower with XLA, the port with numpy and PyTorch;
  the few-modes transform is an einsum in each);
* ``PRhoProfile`` against the JAX package's on the same radii (the RK4
  integration, ``np.interp`` against ``jnp.interp`` for floats, arrays and
  tensors) and its ``write`` file;
* 5 cycles of ``torch_decks.cluster_deck`` (GLM-MHD HLLD + PLM + VL2, one
  scalar, Townsend cooling, every cluster source on; 32^3 over +-0.02 Mpc
  in one ghosted block) through both packages' ``run_from_file``, on the
  sweep and the stage rung: every variable and the ``.hst`` file (with
  the cluster's columns) to 1e-12 relative to that variable's largest
  value;
* a JAX run of 2 cycles carried into the port, then 3 more on both sides.
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from athenapk_tpu import driver as jdriver
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.driver import Simulation as JSim
from athenapk_tpu.eos.adiabatic import EOS as JEOS
from athenapk_tpu.pgen.cluster import pgen as jcl
from athenapk_tpu.solver.hydro_pkg import HydroConfig as JCfg
from athenapk_tpu_torch import driver as tdriver
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.indices import (IB1, IB2, IB3, IDN, IEN, IM1,
                                             IM2, IM3, IPR, IV1, IV2, IV3)
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation, load_payload
from athenapk_tpu_torch.eos.adiabatic import EOS
from athenapk_tpu_torch.pgen.cluster import pgen as tcl
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig
from test_agn_feedback import BASE
from test_cluster import DECK as HSE_DECK
from torch_decks import HST_BLOCK, cluster_deck, write_cluster_table

torch.set_num_threads(2)

TOL = 1e-12
GLM = "\n<hydro>\nfluid = glmmhd\n\n<parthenon/time>\nnlim = 0\n"
PERTURB = GLM + """
<problem/cluster/init_perturb>
sigma_v = 7.5e-2
l_peak_v = 0.5
num_modes_v = 10
sol_weight_v = 1.0
rseed_v = 3
sigma_b = 2.5e-3
k_peak_b = 4.0
num_modes_b = 10
rseed_b = 4
"""


def _rel_per_var(got, want):
    """max over variables of max|got - want| / max|want| (axis 1 the
    variables)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return max(float(np.abs(got[:, v] - want[:, v]).max()
                     / np.abs(want[:, v]).max())
               for v in range(want.shape[1]) if np.abs(want[:, v]).max() > 0)


def _run_in(path, fn):
    os.makedirs(path, exist_ok=True)
    with contextlib.chdir(path):
        return fn()


# ------------------------------------------------------------ the twins
def test_hse_stays_static():
    """Twin of ``test_cluster.py:test_hse_stays_static``."""
    sim = Simulation(ParameterInput.from_string(HSE_DECK), quiet=True,
                     device="cpu")
    sl = sim.mesh.interior_slices
    w0 = sim.pkg.cons_to_prim(sim.u)[1].numpy()[sl]
    cs0 = np.sqrt(sim.eos.gamma * w0[:, IPR] / w0[:, IDN])
    sim.run()
    assert sim.ncycle >= 1 and sim.t == pytest.approx(1e-3)
    w = sim.pkg.cons_to_prim(sim.u)[1].numpy()[sl]
    mach = np.abs(w[:, [IV1, IV2, IV3]]).max() / cs0.min()
    assert mach < 2e-2, f"HSE atmosphere developed Mach {mach:.2e}"
    drho = np.abs((w[:, IDN] - w0[:, IDN]) / w0[:, IDN])
    assert drho.mean() < 2e-3, f"HSE mean drift {drho.mean():.2e}"


def test_hse_profile_matches_entropy_relation():
    """Twin of ``test_cluster.py:test_hse_profile_matches_entropy_
    relation``."""
    pin = ParameterInput.from_string(HSE_DECK)
    sim = Simulation(pin, quiet=True, device="cpu")
    pkg = tcl._pkg(pin)
    sl = sim.mesh.interior_slices
    w = sim.pkg.cons_to_prim(sim.u)[1].numpy()[sl]
    x, y, z = sim.mesh.cell_centers_mesh()
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)[(sl[0],) + sl[2:]]
    k_measured = w[:, IPR] * pkg.mu * pkg.mu_e ** (2.0 / 3.0) / (
        (w[:, IDN] / pkg.units.mh()) ** (5.0 / 3.0))
    k_expected = pkg.entropy.k_from_r(r)
    rel = np.abs(k_measured - k_expected) / k_expected
    assert rel.max() < 1e-2, f"entropy relation violated: {rel.max():.2e}"


def test_init_perturb_rms_and_divb():
    """Twin of ``test_cluster_perturb.py:test_init_perturb_rms_and_divb``
    (its all-periodic deck keeps its ghosts in the port's merged block)."""
    sigma_v, sigma_b = 7.5e-2, 2.5e-3
    sim = Simulation(ParameterInput.from_string(BASE + PERTURB), quiet=True,
                     device="cpu")
    assert sim.mesh.nblocks == 1 and sim.mesh.nghost == 2
    ui = sim.cons()[sim.mesh.interior_slices]
    vol = sim.mesh.cell_volume
    rho = ui[:, IDN]
    v2 = ((ui[:, IM1] / rho) ** 2 + (ui[:, IM2] / rho) ** 2
          + (ui[:, IM3] / rho) ** 2)
    rms_v = np.sqrt(float(v2.sum()) * vol)        # unit box
    assert abs(rms_v - sigma_v) / sigma_v < 1e-12
    b2 = ui[:, IB1] ** 2 + ui[:, IB2] ** 2 + ui[:, IB3] ** 2
    rms_b = np.sqrt(float(b2.sum()) * vol)
    assert abs(rms_b - sigma_b) / sigma_b < 1e-12
    # IEN == p / gm1 + KE + ME with p = 1
    eint = ui[:, IEN] - 0.5 * rho * v2 - 0.5 * b2
    assert np.abs(eint - 1.0 / (5.0 / 3.0 - 1.0)).max() < 1e-12
    # the curl construction: central-difference divB vanishes to roundoff
    # away from the block's boundary layer
    dx = sim.mesh.dx1

    def cd(q, ax):
        return (np.roll(q, -1, axis=ax) - np.roll(q, 1, axis=ax)) / (2 * dx)

    b1, b2c, b3 = ui[:, IB1], ui[:, IB2], ui[:, IB3]
    divb = cd(b1, 3) + cd(b2c, 2) + cd(b3, 1)
    scale = np.abs(np.stack([b1, b2c, b3])).max() / dx
    assert np.abs(divb[:, 2:-2, 2:-2, 2:-2]).max() / scale < 1e-12
    assert np.abs(ui[:, IM3]).max() > 0 and np.abs(ui[:, IB3]).max() > 0


# ----------------------------------------------------- the initial states
INIT_CASES = {
    "hse": HSE_DECK,
    "uniform_dipole": BASE + GLM + """
<problem/cluster/uniform_b_field>
init_uniform_b_field = true
bx = 1e-3
by = -2e-3
bz = 5e-4

<problem/cluster/dipole_b_field>
init_dipole_b_field = true
mx = 1e-4
my = 2e-4
mz = -3e-4
""",
    "tower": BASE + GLM + """
<problem/cluster/precessing_jet>
jet_theta = 0.3
jet_phi0 = 0.7

<problem/cluster/magnetic_tower>
potential_type = li
li_alpha = 2.5
l_scale = 0.15
initial_field = 1e-3
""",
    "perturb": BASE + PERTURB,
    "cluster_deck": cluster_deck(n=16, mb=8, half=0.02),
}


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_problem_generator_matches_jax(case):
    text = INIT_CASES[case]
    tpin, jpin = ParameterInput.from_string(text), JPin.from_string(text)
    tcl.init_user_mesh_data(tpin)
    jcl.init_user_mesh_data(jpin)
    got = tcl.problem_generator(tpin, Mesh.from_parameter_input(tpin),
                                HydroConfig.from_parameter_input(tpin),
                                EOS.from_parameter_input(tpin))
    want = np.asarray(jcl.problem_generator(
        jpin, JMesh.from_parameter_input(jpin),
        JCfg.from_parameter_input(jpin), JEOS.from_parameter_input(jpin)))
    assert got.dtype == want.dtype == np.float64
    if case == "uniform_dipole":
        assert np.array_equal(got, want)
        assert np.abs(got[:, IB3]).max() > 0
    else:
        assert _rel_per_var(got, want) <= TOL
    if case in ("perturb", "cluster_deck"):
        assert np.abs(got[:, IM3]).max() > 0 and np.abs(got[:, IB1]).max() > 0


def test_p_rho_profile_matches_jax(tmp_path):
    pin_t, pin_j = (ParameterInput.from_string(HSE_DECK),
                    JPin.from_string(HSE_DECK))
    mesh = Mesh.from_parameter_input(pin_t)
    tp = tcl._pkg(pin_t).hse.profile_for_mesh(mesh)
    jp = jcl._pkg(pin_j).hse.profile_for_mesh(JMesh.from_parameter_input(
        pin_j))
    np.testing.assert_array_equal(tp.r, jp.r)
    fin = np.isfinite(jp.p)
    np.testing.assert_array_equal(fin, np.isfinite(tp.p))
    assert fin[1:].all()      # only r = 0 is singular (no smoothing)
    np.testing.assert_allclose(tp.p[fin], jp.p[fin], rtol=TOL, atol=0)
    # the lookup: np.interp on floats, arrays and tensors, jnp.interp
    rng = np.random.default_rng(5)
    r = rng.uniform(tp.r[1], 0.2, 1000)
    want = np.asarray(jp.p_from_r(jnp.asarray(r)))
    np.testing.assert_allclose(tp.p_from_r(r), want, rtol=TOL, atol=0)
    got_t = tp.p_from_r(torch.as_tensor(r))
    assert torch.is_tensor(got_t) and got_t.dtype == torch.float64
    np.testing.assert_array_equal(got_t.numpy(), tp.p_from_r(r))
    assert tp.p_from_r(float(r[0])) == pytest.approx(float(want[0]),
                                                     rel=TOL)
    np.testing.assert_allclose(tp.rho_from_r(r),
                               np.asarray(jp.rho_from_r(jnp.asarray(r))),
                               rtol=TOL)
    # the HSE self-test file
    _run_in(tmp_path / "t", lambda: tp.write("he.dat"))
    _run_in(tmp_path / "j", lambda: jp.write("he.dat"))
    a, b = (np.loadtxt(tmp_path / d / "he.dat") for d in ("t", "j"))
    fin = np.isfinite(b).all(axis=1)
    np.testing.assert_allclose(a[fin], b[fin], rtol=TOL, atol=0)


# ------------------------------------------------------- whole runs
@pytest.fixture(scope="module")
def cluster_runs(tmp_path_factory):
    """The cluster deck (5 cycles, .hst every cycle) through the JAX
    package once, shared by the rung cases."""
    root = tmp_path_factory.mktemp("cluster")
    table = write_cluster_table(root / "cluster.cool")
    path = root / "cluster.in"
    path.write_text(cluster_deck(n=32, half=0.02, table=table) + HST_BLOCK)
    js = _run_in(root / "jax", lambda: jdriver.run_from_file(str(path),
                                                             quiet=True))
    return path, js, np.loadtxt(next((root / "jax").glob("*.hst")))


@pytest.mark.parametrize("rung", ["sweep", "stage"])
def test_cluster_deck_matches_jax(cluster_runs, rung, tmp_path, monkeypatch):
    path, js, jh = cluster_runs
    monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "1" if rung == "stage"
                       else "0")
    ts = _run_in(tmp_path, lambda: tdriver.run_from_file(
        str(path), quiet=True, device="cpu"))
    th = np.loadtxt(next(tmp_path.glob("*.hst")))
    assert ts.ncycle == js.ncycle == 5
    assert ts.mesh.nblocks == 1 and ts.mesh.nghost == 2
    assert ts._split_cycle() and ts.src_first_order is not None
    sl = ts.mesh.interior_slices
    assert _rel_per_var(ts.u.numpy()[sl], np.asarray(js.u)[sl]) <= TOL
    assert abs(ts.t - js.t) <= TOL * js.t
    # every cycle's time and dt, the hydro sums and the cluster's columns
    # (cold_mass, agn_extent, agn_feedback_power)
    assert th.shape == jh.shape and th.shape == (7, 2 + 8 + 3)
    for col in range(th.shape[1]):
        scale = max(np.abs(jh[:, col]).max(), 1e-300)
        assert np.abs(th[:, col] - jh[:, col]).max() <= TOL * scale, col
    # the sources acted: the core's cold gas accreted (power above the
    # fixed 1e-3) until the feedback heated it, the tracer was launched
    assert th[0, -3] > 0.0 and th[0, -1] > 1e-3
    assert th[-1, -3] == 0.0 and th[-1, -1] == 1e-3
    assert th[-1, -2] > 0.0


def test_jax_run_carries_into_the_port(tmp_path):
    """A JAX run of 2 cycles carried into the port (``load_payload``),
    then 3 more cycles on both sides: the cluster keeps no state across
    cycles beyond the conserved state, t and dt."""
    table = write_cluster_table(tmp_path / "cluster.cool")
    text = cluster_deck(n=16, half=0.02, nlim=2, table=table)
    js = JSim(JPin.from_string(text), quiet=True)
    _run_in(tmp_path / "jax", js.run)
    payload = {"cons": np.asarray(js.u), "t": js.t, "ncycle": js.ncycle,
               "dt": None}
    ts = Simulation(ParameterInput.from_string(text.replace(
        "nlim = 2", "nlim = 5")), quiet=True, device="cpu")
    load_payload(ts, payload)
    js.nlim = 5
    _run_in(tmp_path / "jax", js.run)
    _run_in(tmp_path / "torch", ts.run)
    assert ts.ncycle == js.ncycle == 5
    assert ts.t == pytest.approx(js.t, rel=TOL)
    assert _rel_per_var(ts.u.numpy(), np.asarray(js.u)) <= TOL


# ------------------------------------------------- the ghost-keeping merge
@pytest.mark.parametrize("sigma_b", [0.0, 0.5])
def test_merge_keeps_ghosts_for_init_perturb(sigma_b):
    """An all-periodic cluster deck merges into one block, ghost-free
    unless its initial state needs ghosts (``init_perturb/sigma_b``): the
    port keeps them and runs; the JAX package's merge drops them, and its
    perturbation refuses the deck (``athenapk_tpu/driver.py:296``)."""
    text = cluster_deck(n=16, mb=8, half=0.02, nlim=1, bc="periodic",
                        sigma_b=sigma_b).replace(
        "<parthenon/mesh>", "<parthenon/mesh>\nmerge_blocks = true")
    sim = Simulation(ParameterInput.from_string(text), quiet=True,
                     device="cpu")
    assert sim.mesh.nblocks == 1
    assert sim.mesh.nghost == (2 if sigma_b else 0)
    sim.run()
    assert sim.ncycle == 1 and np.isfinite(sim.cons()).all()
    if sigma_b:
        b = sim.cons()[sim.mesh.interior_slices][:, IB1:IB3 + 1]
        assert np.abs(b).max() > 0
        with pytest.raises(ValueError, match="nghost >= 1"):
            JSim(JPin.from_string(text), quiet=True)
    else:
        assert JSim(JPin.from_string(text), quiet=True).mesh.nghost == 0


def test_single_precision_refuses_stellar_feedback():
    """The stellar feedback's number density (rho / mbar, ~1e73 per Mpc^3
    in the cluster's units) is outside the f32 range: an f32 state raises
    rather than being compared with an overflowed threshold; the deck runs
    in f32 without it."""
    text = cluster_deck(n=16, half=0.02, nlim=1, precision="single")
    with pytest.raises(ValueError, match="outside the torch.float32 range"):
        Simulation(ParameterInput.from_string(text), quiet=True,
                   device="cpu").run()
    sim = Simulation(ParameterInput.from_string(cluster_deck(
        n=16, half=0.02, nlim=2, precision="single", stellar=False)),
        quiet=True, device="cpu").run()
    assert sim.u.dtype == torch.float32 and np.isfinite(sim.cons()).all()
