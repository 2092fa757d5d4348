"""Port parity: the few-modes forcing (``utils/few_modes_ft.py``) and the
state a JAX run hands to the port (``driver.load_payload``).

* the phase tables of ``FewModesFT`` (several blocks) and
  ``FewModesFTSmr`` (per level) equal the JAX package's bitwise;
* ``update_var_hat``, numpy on the host in both packages, gives the same
  spectrum bitwise over several steps, and ``make_random_modes`` the same
  modes;
* ``get_state`` / ``set_state`` round trips continue the same random
  stream, and the JAX package's state sets the port's;
* the carry-over: a JAX run stopped after 3 cycles and continued for 2,
  against the port continuing from the JAX package's driver state (the
  state, t, the cycle, the last dt, and ``dt_diff`` for an RKL2 deck or
  the forcing's ``var_hat`` and bit-generator state for turbulence), on a
  uniform and a refined mesh: 1e-12 relative to the state's largest value.
"""

import copy
import os

import numpy as np
import pytest
import torch

from athenapk_tpu.amr.driver import SmrSimulation as JSmr
from athenapk_tpu.amr.smr import SmrMesh as JSmrMesh
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.driver import Simulation as JSim
from athenapk_tpu.pgen import turbulence as jturb
from athenapk_tpu.utils import few_modes_ft as jfm
from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.amr.smr import SmrMesh
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation, load_payload
from athenapk_tpu_torch.utils import few_modes_ft as tfm
from torch_decks import linwave3d_deck, turbulence_deck

torch.set_num_threads(2)

TOL = 1e-12
K_VEC = np.array([[2.0, 0.0, 1.0, 0.0, 1.0], [0.0, 2.0, 1.0, 1.0, -1.0],
                  [0.0, 0.0, 0.0, -1.0, 1.0]])
KW = dict(k_peak=2.0, sol_weight=0.7, t_corr=0.5, rseed=4242)


def _mesh_kw(n=(16, 8, 8), mb=(8, 4, 4)):
    return dict(nx1=n[0], nx2=n[1], nx3=n[2], mbnx1=mb[0], mbnx2=mb[1],
                mbnx3=mb[2], x1min=0.0, x1max=1.0, x2min=0.0, x2max=0.5,
                x3min=0.0, x3max=0.5, nghost=2)


@pytest.mark.parametrize("fill_ghosts", [False, True])
def test_phase_tables_match_jax(fill_ghosts):
    t = tfm.FewModesFT(Mesh(**_mesh_kw()), 5, K_VEC, fill_ghosts=fill_ghosts,
                       **KW)
    j = jfm.FewModesFT(JMesh(**_mesh_kw()), 5, K_VEC,
                       fill_ghosts=fill_ghosts, **KW)
    t.set_phases()
    j.set_phases()
    for a, b in zip(t._phases, j._phases):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(t.phases_on("cpu"), j._phases):
        assert a.dtype == torch.complex128
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_refined_phase_tables_match_jax():
    region = [(0.0, 0.5, 0.0, 0.25, 0.0, 0.25, 1)]
    kw = _mesh_kw(n=(8, 4, 4), mb=(4, 2, 2))
    t = tfm.FewModesFTSmr(SmrMesh(Mesh(**kw), region), 5, K_VEC, **KW)
    j = jfm.FewModesFTSmr(JSmrMesh(JMesh(**kw), region), 5, K_VEC, **KW)
    assert sorted(t._phases) == sorted(j._phases) == [0, 1]
    for lev in j._phases:
        for a, b in zip(t._phases[lev], j._phases[lev]):
            np.testing.assert_array_equal(a, np.asarray(b))
    got, want = t.generate(0.05, "cpu"), j.generate(0.05)
    for lev, acc in got.items():
        w = np.asarray(want[lev])
        assert float(np.abs(acc.numpy() - w).max() / np.abs(w).max()) <= TOL


def test_update_var_hat_is_bitwise_the_jax_one():
    t = tfm.FewModesFT(Mesh(**_mesh_kw()), 5, K_VEC, **KW)
    j = jfm.FewModesFT(JMesh(**_mesh_kw()), 5, K_VEC, **KW)
    for dt in (0.01, 0.3, 0.02, 1.5):
        t.update_var_hat(dt)
        j.update_var_hat(dt)
        np.testing.assert_array_equal(t.var_hat, j.var_hat)
    assert np.abs(t.var_hat).max() > 0.0
    # the hermitian pairs and the solenoidal projection took part
    assert t.var_hat.dtype == np.complex128
    np.testing.assert_array_equal(tfm.make_random_modes(30, 2.0, 7),
                                  jfm.make_random_modes(30, 2.0, 7))


def test_state_round_trips():
    a = tfm.FewModesFT(Mesh(**_mesh_kw()), 5, K_VEC, **KW)
    a.update_var_hat(0.1)
    saved = copy.deepcopy(a.get_state())
    first = [a.generate(0.1, "cpu").numpy() for _ in range(2)]
    b = tfm.FewModesFT(Mesh(**_mesh_kw()), 5, K_VEC, **KW)
    b.set_state(*saved)
    again = [b.generate(0.1, "cpu").numpy() for _ in range(2)]
    for x, y in zip(first, again):
        np.testing.assert_array_equal(x, y)
    # the JAX package's state continues in the port's driver
    j = jfm.FewModesFT(JMesh(**_mesh_kw()), 5, K_VEC, **KW)
    j.update_var_hat(0.2)
    c = tfm.FewModesFT(Mesh(**_mesh_kw()), 5, K_VEC, **KW)
    c.set_state(*copy.deepcopy(j.get_state()))
    j.update_var_hat(0.2)
    c.update_var_hat(0.2)
    np.testing.assert_array_equal(c.var_hat, j.var_hat)
    s = tfm.FewModesFTSmr(SmrMesh(Mesh(**_mesh_kw()), []), 5, K_VEC, **KW)
    s.set_state(*copy.deepcopy(j.get_state()))
    np.testing.assert_array_equal(s.get_state()[0], j.var_hat)


def _run_in(path, sim):
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return sim.run()
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("deck", ["turbulence", "rkl2"])
def test_uniform_carry_over_from_jax(deck, tmp_path):
    text = (turbulence_deck(n=16, nlim=3, merge="false") if deck ==
            "turbulence" else linwave3d_deck(integrator="rkl2", nlim=3,
                                             merge="false"))
    js = JSim(JPin.from_string(text), quiet=True)
    _run_in(tmp_path / "jax", js)
    payload = {"cons": np.asarray(js.u), "t": js.t, "ncycle": js.ncycle,
               "dt": None, "dt_diff": js.dt_diff}
    if deck == "turbulence":
        payload["few_modes_ft"] = copy.deepcopy(
            jturb._fmft(js.pin, js.mesh).get_state())
    ts = Simulation(ParameterInput.from_string(text.replace(
        "nlim = 3", "nlim = 5")), quiet=True, device="cpu")
    load_payload(ts, payload)
    js.nlim = 5
    _run_in(tmp_path / "jax", js)
    _run_in(tmp_path / "torch", ts)
    assert ts.ncycle == js.ncycle == 5
    assert ts.t == pytest.approx(js.t, rel=TOL)
    want = np.asarray(js.u)
    assert np.abs(ts.u.numpy() - want).max() <= TOL * np.abs(want).max()
    if deck == "rkl2":
        assert ts.pkg.rkl2_stages > 0
        assert ts.dt_diff == pytest.approx(js.dt_diff, rel=TOL)


def test_refined_carry_over_from_jax(tmp_path):
    text = turbulence_deck(n=16, mb=8, nlim=3, refinement="static",
                           num_modes=8)
    js = JSmr(JPin.from_string(text), quiet=True)
    _run_in(tmp_path / "jax", js)
    payload = {"state": {lev: np.asarray(u) for lev, u in js.state.items()},
               "t": js.t, "ncycle": js.ncycle, "dt": js.tm_dt,
               "few_modes_ft": copy.deepcopy(jturb._fmft_smr(
                   js.pin, js._smesh_now()).get_state())}
    ts = SmrSimulation(ParameterInput.from_string(text.replace(
        "nlim = 3", "nlim = 5")), quiet=True, device="cpu")
    load_payload(ts, payload)
    assert ts.tm_dt == js.tm_dt
    js.nlim = 5
    _run_in(tmp_path / "jax", js)
    _run_in(tmp_path / "torch", ts)
    assert ts.ncycle == js.ncycle == 5
    assert ts.t == pytest.approx(js.t, rel=TOL)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in js.state.values())
    for lev, u in js.state.items():
        assert float(np.abs(ts.state[lev].numpy() - np.asarray(u)).max()) \
            <= TOL * scale
