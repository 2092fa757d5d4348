"""Port parity: the problem source hooks and the split-source pgens on
uniform meshes (``rand_blast``, ``turbulence``), and the few-modes forcing
on a refined mesh against a uniform one.

Twins of ``tests/test_smr_split_sources.py``'s uniform cases (the Strang
hook, monkeypatched; the few-modes field of an all-level-1 mesh against
the uniform mesh at that resolution), then against the JAX package on the
CPU, each from the same initial state:

* turbulence (``torch_decks.turbulence_deck``, GLM-MHD HLLD + PLM + VL2,
  30 random modes) for 5 cycles in f64 (1e-12 relative to the state's
  largest value; measured ~3e-13) and in f32 (the JAX side runs the same
  f32 state with x64 on, as the JAX package does: the forcing is f64 in
  both and is cast where it is added; 2e-5, the f32 tolerance of
  ``tests/test_torch_smr_kernels.py``; measured 4e-7), with the
  acceleration shown to be f64 for an f32 state;
* rand_blast at 32^3, a window in which blast 1 fires (1e-12);
* a monkeypatched pointwise ``problem_source_unsplit`` on the diffusive
  linear wave, on the sweep and the stage rung (1e-12), and a
  monkeypatched ``estimate_timestep`` hook that binds (every dt the
  hook's).
"""

import os

import numpy as np
import pytest
import torch

from athenapk_tpu.amr.smr import SmrMesh as JSmrMesh
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.driver import Simulation as JSim
from athenapk_tpu.pgen import linear_wave_mhd as jlw
from athenapk_tpu.utils.few_modes_ft import FewModesFT as JFewModes
from athenapk_tpu_torch.amr.smr import SmrMesh
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.indices import IDN, IEN
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation
from athenapk_tpu_torch.pgen import advection as tadv
from athenapk_tpu_torch.pgen import linear_wave_mhd as tlw
from athenapk_tpu_torch.pgen import turbulence as tturb
from athenapk_tpu_torch.utils.few_modes_ft import FewModesFT, FewModesFTSmr
from torch_decks import linwave3d_deck, rand_blast_deck, turbulence_deck

import test_smr_split_sources as jtest

torch.set_num_threads(2)

TOL = 1e-12
F32_TOL = 2e-5


def _rel(got, want):
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(np.asarray(got, dtype=np.float64) - want).max()
                 / np.abs(want).max())


def _run_in(path, sim):
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return sim.run()
    finally:
        os.chdir(cwd)


def _interior(sim, u):
    return np.asarray(u)[sim.mesh.interior_slices]


# ------------------------------------------------------------- turbulence
@pytest.mark.parametrize("precision", ["double", "single"])
def test_turbulence_matches_jax(precision, tmp_path, monkeypatch):
    deck = turbulence_deck(n=16, nlim=5, precision=precision)
    js = JSim(JPin.from_string(deck.replace(f"precision = {precision}",
                                            "precision = double")),
              quiet=True)
    ts = Simulation(ParameterInput.from_string(deck), quiet=True,
                    device="cpu")
    dtype = np.float32 if precision == "single" else np.float64
    # the JAX package's state in the deck's precision, x64 on (its phases
    # and var_hat stay complex128)
    js.u = js.u.astype(dtype)
    np.testing.assert_array_equal(_interior(ts, ts.u.numpy()),
                                  _interior(js, js.u))
    seen = []
    gen = tturb.forcing_driver(ts.pin, ts.mesh).generate

    def spy(dt, device):
        acc = gen(dt, device)
        seen.append(acc.dtype)
        return acc

    monkeypatch.setattr(tturb.forcing_driver(ts.pin, ts.mesh), "generate",
                        spy)
    _run_in(tmp_path / "jax", js)
    _run_in(tmp_path / "torch", ts)
    assert ts.ncycle == js.ncycle == 5 and len(seen) == 5
    assert set(seen) == {torch.float64}
    assert ts.u.dtype == (torch.float32 if precision == "single"
                          else torch.float64)
    tol = F32_TOL if precision == "single" else TOL
    assert ts.t == pytest.approx(js.t, rel=tol)
    assert _rel(_interior(ts, ts.u.numpy()), _interior(js, js.u)) <= tol
    hj = np.loadtxt(tmp_path / "jax" / "turbulence.out0.hst")
    ht = np.loadtxt(tmp_path / "torch" / "turbulence.out0.hst")
    assert hj.shape == ht.shape == (7, 13)   # + Ms, Ma, plasma_beta
    # the sums over 4096 cells are taken in the state's dtype in both
    # packages, in different orders: f32 sums differ by up to ~4e-5
    hst_tol = 1e-4 if precision == "single" else 1e-10
    for col in (0, 1, 2, 6, 7, 8, 10, 11, 12):
        np.testing.assert_allclose(ht[:, col], hj[:, col], rtol=hst_tol)
    # the driving injected kinetic energy
    assert ht[-1, 6] > 10.0 * ht[1, 6] > 0.0


def test_turbulence_forcing_is_f64_for_an_f32_state():
    """The acceleration of an f32 state is f64 (complex128 tables), as the
    JAX package's under x64; an f32 transform would differ from it by
    far more than the f64 one does."""
    deck = turbulence_deck(n=8, precision="single")
    ts = Simulation(ParameterInput.from_string(deck), quiet=True,
                    device="cpu")
    fm = tturb.forcing_driver(ts.pin, ts.mesh)
    jfm = JFewModes(JMesh(**_mesh_kw(8)), fm.num_modes, fm.k_vec,
                    k_peak=2.0, sol_weight=1.0, t_corr=1.0,
                    rseed=20190729)
    acc = fm.generate(0.01, "cpu")
    want = np.asarray(jfm.generate(0.01))
    assert acc.dtype == torch.float64
    assert _rel(acc.numpy(), want) <= TOL
    assert _rel(acc.numpy().astype(np.float32), want) > 1e-9


def _mesh_kw(n, mb=None):
    return dict(nx1=n, nx2=n, nx3=n, mbnx1=mb or n, mbnx2=mb or n,
                mbnx3=mb or n, x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.0,
                x3min=0.0, x3max=1.0, nghost=2)


# -------------------------------------------------------------- rand_blast
def test_rand_blast_matches_jax_with_a_blast(tmp_path):
    deck = rand_blast_deck(n=32, nlim=5, tlim=0.01)
    js = JSim(JPin.from_string(deck), quiet=True)
    ts = Simulation(ParameterInput.from_string(deck), quiet=True,
                    device="cpu")
    e0 = float(ts.u[:, IEN].sum())
    _run_in(tmp_path / "jax", js)
    _run_in(tmp_path / "torch", ts)
    assert ts.ncycle == js.ncycle == 5
    assert js.t > 0.00125 and ts.t == pytest.approx(js.t, rel=TOL)
    assert _rel(_interior(ts, ts.u.numpy()), _interior(js, js.u)) <= TOL
    # blast 1 fired: the energy jumped, the mass stayed
    assert float(ts.u[:, IEN].sum()) > 1.5 * e0
    hj = np.loadtxt(tmp_path / "jax" / "rand_blast.out0.hst")
    ht = np.loadtxt(tmp_path / "torch" / "rand_blast.out0.hst")
    np.testing.assert_allclose(ht[:, 2], ht[0, 2], rtol=1e-13)
    np.testing.assert_allclose(ht[:, :3], hj[:, :3], rtol=1e-12)


# ------------------------------------------------------ few modes, refined
def test_fewmodes_smr_matches_uniform_at_same_resolution():
    """Twin of the JAX test: an all-level-1 mesh gives the uniform fine
    mesh's field (the same spectrum, the same left-edge phases)."""
    k_vec = np.array([[2.0, 0.0, 1.0], [0.0, 2.0, 1.0],
                      [0.0, 0.0, 0.0]])
    kw = dict(k_peak=2.0, sol_weight=1.0, t_corr=1.0, rseed=42)
    fm_uni = FewModesFT(Mesh(**_mesh_kw(16, 8)), 3, k_vec, **kw)
    acc_uni = fm_uni.generate(0.1, "cpu").numpy()
    sm = SmrMesh(Mesh(**_mesh_kw(8)), [(0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 1)])
    assert set(sm.level_ids) == {1} and len(sm.level_ids[1]) == 8
    acc_smr = FewModesFTSmr(sm, 3, k_vec, **kw).generate(0.1, "cpu")[1] \
        .numpy()
    for li in range(8):
        gid = sm.level_ids[1][li]
        bu = int(sm.lx1[gid]) + 2 * (int(sm.lx2[gid]) + 2 * int(sm.lx3[gid]))
        np.testing.assert_allclose(acc_smr[:, li], acc_uni[:, bu],
                                   rtol=1e-12, atol=1e-13)
    # and the JAX package's refined tables give the same field
    from athenapk_tpu.utils.few_modes_ft import FewModesFTSmr as JSmrFM
    jsm = JSmrMesh(JMesh(**_mesh_kw(8)), [(0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 1)])
    want = np.asarray(JSmrFM(jsm, 3, k_vec, **kw).generate(0.1)[1])
    assert _rel(acc_smr, want) <= TOL


# ---------------------------------------------------------- Strang source
def _dummy_strang_factory(pin, mesh, cfg, eos):
    """de/dt = EDOT, applied as dt/2 per call (the hook receives the full
    dt twice per cycle: the reference's AddSplitSourcesStrang)."""

    def src(u, dt, t):
        u = u.clone()
        u[:, IEN] += 0.5 * jtest.EDOT * dt
        return u

    return src


def test_strang_split_source_uniform(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tadv, "problem_source_strang",
                        _dummy_strang_factory, raising=False)
    sim = Simulation(ParameterInput.from_string(jtest.STRANG_DECK),
                     quiet=True, device="cpu")
    assert sim._split_cycle()
    sim.run()
    e_mean = sim.cons()[sim.mesh.interior_slices][:, IEN].mean()
    e_expected = 1.0 / (5.0 / 3.0 - 1.0) + 0.5 + jtest.EDOT * sim.t
    np.testing.assert_allclose(e_mean, e_expected, rtol=1e-10)


# --------------------------------------- unsplit source and the dt hook
EDOT = 0.3


def _jax_heating(pin, mesh, cfg, eos):
    def src(u, prim, mesh, beta_dt, t):
        return u.at[:, IEN].add(beta_dt * EDOT * prim[:, IDN] * (1.0 + t))
    return src


def _torch_heating(pin, mesh, cfg, eos):
    def src(u, prim, mesh, beta_dt, t):
        u[:, IEN] += beta_dt * EDOT * prim[:, IDN] * (1.0 + t)
        return u
    return src


@pytest.mark.parametrize("rung", ["sweep", "stage"])
def test_unsplit_problem_source_matches_jax(rung, monkeypatch, tmp_path):
    """A pointwise heating by the stage-start density (the prim the stage
    rung emits) on the diffusive wave, unsplit diffusion included."""
    monkeypatch.setattr(jlw, "problem_source_unsplit", _jax_heating,
                        raising=False)
    monkeypatch.setattr(tlw, "problem_source_unsplit", _torch_heating,
                        raising=False)
    if rung == "stage":
        monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "1")
    deck = linwave3d_deck(integrator="unsplit")
    js = JSim(JPin.from_string(deck), quiet=True)
    ts = Simulation(ParameterInput.from_string(deck), quiet=True,
                    device="cpu")
    assert ts.pkg._use_fused_stage() == (rung == "stage")
    assert ts.pkg._stage_needs_prim() and not ts._split_cycle()
    e0 = float(ts.u[:, IEN].sum())
    _run_in(tmp_path / "jax", js)
    _run_in(tmp_path / "torch", ts)
    assert ts.ncycle == js.ncycle == 5
    assert _rel(_interior(ts, ts.u.numpy()), _interior(js, js.u)) <= TOL
    assert float(ts.u[:, IEN].sum()) > e0 * (1.0 + EDOT * ts.t / 3.0)


def test_estimate_timestep_hook_binds(monkeypatch, tmp_path):
    def hook(pin, mesh, cfg, eos, prim, t):
        return 1e-3 * (1.0 + t)

    monkeypatch.setattr(jlw, "estimate_timestep", hook, raising=False)
    monkeypatch.setattr(tlw, "estimate_timestep", hook, raising=False)
    deck = linwave3d_deck(integrator="unsplit")
    js = JSim(JPin.from_string(deck), quiet=True)
    ts = Simulation(ParameterInput.from_string(deck), quiet=True,
                    device="cpu")
    assert ts._split_cycle()
    _run_in(tmp_path / "jax", js)
    _run_in(tmp_path / "torch", ts)
    ht = np.loadtxt(tmp_path / "torch" / "linear_wave_mhd.out2.hst")
    hj = np.loadtxt(tmp_path / "jax" / "linear_wave_mhd.out2.hst")
    # every step is the hook's at the cycle's start (the first from t=0)
    t_start = ht[1:-1, 0] - ht[1:-1, 1]
    np.testing.assert_allclose(ht[1:-1, 1], 1e-3 * (1.0 + t_start),
                               rtol=1e-14)
    np.testing.assert_allclose(ht[:, :2], hj[:, :2], rtol=1e-14)
    assert _rel(_interior(ts, ts.u.numpy()), _interior(js, js.u)) <= TOL
