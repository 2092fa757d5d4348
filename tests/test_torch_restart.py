"""Port parity: checkpoint and restart (``outputs/restart.py``, ``-r``).

* twins of ``tests/test_restart.py``: a 6-cycle turbulence run equals 3
  cycles, a checkpoint and 3 more bit for bit (here also with tracers),
  and a resume honours the 2x growth cap from the checkpoint's dt;
* ``.rhdf`` files cross between the packages: a JAX checkpoint (uniform
  turbulence with its OU forcing and tracers, a static refined mesh with
  tracers, an adaptive mesh with tracers and derefinement counters)
  resumes in the port and agrees with the JAX run within 1e-12 of the
  largest value (tracer ids and activity identical), and a port
  checkpoint (uniform, static) resumes in the JAX package so;
* the twin of ``tests/test_merge_blocks.py::
  test_merge_skipped_for_foreign_restart_layout``;
* the triggers continue at count+1 after a resume, and the resumed run
  appends to the ``.hst`` file;
* the payload round trip without a file (what the card does, having no
  h5py): ``restart_payload`` -> ``Simulation(pin, restart=payload)``.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from athenapk_tpu.amr.driver import SmrSimulation as JSmr
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.driver import Simulation as JSim
from athenapk_tpu.driver import run_from_restart as jrun_from_restart
from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import (Simulation, run_from_restart,
                                       write_restart_file)
from athenapk_tpu_torch.outputs.restart import (restart_payload,
                                                restart_payload_smr)
from test_restart import DECK
from test_tracers import SMR_DECK, TURB_DECK
from torch_decks import symmetry_noise

torch.set_num_threads(2)

TOL = 1e-12
ADAPTIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "inputs", "blast_3d_adaptive.in")
TRACERS = """
<tracers>
enabled = true
initial_seed_method = random_per_block
initial_num_tracers_per_cell = 0.05
initial_rng_seed = 3
"""
EVERY_CYCLE = "\n<parthenon/output7>\nfile_type = rst\ndt = 0.0\nid = r\n"


def _np(v):
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _close(got, want, what):
    a, b = _np(want), _np(got)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.dtype.kind == "f":
        scale = max(float(np.abs(a).max()), 1.0)
        assert float(np.abs(b - a).max()) <= TOL * scale, what
    else:
        np.testing.assert_array_equal(b, a, err_msg=what)


def _hold_uniform(got, want):
    """Port (or JAX) ``got`` against ``want``: state, clock, tracers."""
    _close(got.u, want.u, "state")
    assert abs(got.t - want.t) <= TOL * want.t and got.ncycle == want.ncycle
    if want.tracer_state is not None:
        for k, v in want.tracer_state.items():
            _close(got.tracer_state[k], v, k)


def _hold_refined(got, want):
    assert sorted(got.state) == sorted(want.state)
    for lev, u in want.state.items():
        _close(got.state[lev], u, f"level {lev}")
    assert abs(got.t - want.t) <= TOL * want.t and got.ncycle == want.ncycle
    if want.tracer_state is not None:
        for lev, st in want.tracer_state["levels"].items():
            for k, v in st.items():
                _close(got.tracer_state["levels"][lev][k], v, f"{lev} {k}")
        assert int(got.tracer_state["n_lost"]) == \
            int(want.tracer_state["n_lost"])


# ------------------------------------------------- twins of test_restart.py
@pytest.mark.parametrize("tracers", [False, True])
def test_bitwise_restart(tmp_path, monkeypatch, tracers):
    monkeypatch.chdir(tmp_path)
    deck = DECK + (TRACERS if tracers else "")
    sim_a = Simulation(ParameterInput.from_string(
        deck.format(tlim=100.0, nlim=6)), quiet=True, device="cpu").run()
    sim_b = Simulation(ParameterInput.from_string(
        deck.format(tlim=100.0, nlim=3)), quiet=True, device="cpu").run()
    ckpt = str(tmp_path / "mid.rhdf")
    write_restart_file(sim_b, ckpt)
    sim_c = run_from_restart(ckpt, overrides=["parthenon/time/nlim=6"],
                             quiet=True, device="cpu")
    assert sim_c.ncycle == 6
    assert torch.equal(sim_a.u, sim_c.u)
    assert sim_a.t == sim_c.t
    if tracers:
        assert sim_a.tracer_state["n_lost"].item() == 0
        for k, v in sim_a.tracer_state.items():
            assert torch.equal(v, sim_c.tracer_state[k]), k


def test_restart_seeds_dt_growth_cap(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sim = Simulation(ParameterInput.from_string(
        DECK.format(tlim=100.0, nlim=3)), quiet=True, device="cpu").run()
    sim.tm_dt = 1.0e-6
    ckpt = str(tmp_path / "cap.rhdf")
    write_restart_file(sim, ckpt)
    sim2 = run_from_restart(
        ckpt, overrides=[f"parthenon/time/nlim={sim.ncycle + 1}"],
        quiet=True, device="cpu")
    assert sim2.ncycle == sim.ncycle + 1
    assert sim2.tm_dt <= 2.0e-6 * (1 + 1e-12)


def test_payload_round_trip_without_a_file(tmp_path, monkeypatch):
    """The card's restart: no h5py, the payload straight into a new
    ``Simulation``; bit for bit, with tracers and the forcing."""
    monkeypatch.chdir(tmp_path)
    deck = DECK + TRACERS
    full = Simulation(ParameterInput.from_string(
        deck.format(tlim=100.0, nlim=4)), quiet=True, device="cpu").run()
    half = Simulation(ParameterInput.from_string(
        deck.format(tlim=100.0, nlim=2)), quiet=True, device="cpu").run()
    payload = restart_payload(half)
    assert sorted(payload) == ["cons", "dt", "few_modes_ft", "ncycle", "t",
                               "tracers", "triggers"]
    rest = Simulation(ParameterInput.from_string(
        deck.format(tlim=100.0, nlim=4)), quiet=True, device="cpu",
        restart=payload).run()
    assert torch.equal(full.u, rest.u) and full.t == rest.t
    for k, v in full.tracer_state.items():
        assert torch.equal(v, rest.tracer_state[k]), k


# ------------------------------------------------- across the two packages
def _ckpt(path, cycle):
    (name,) = glob.glob(str(path / f"*.out_r.{cycle:05d}.rhdf"))
    return name


def _in(path, fn):
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def test_jax_turbulence_checkpoint_resumes_in_the_port(tmp_path):
    """JAX's uniform checkpoint with the OU forcing and tracers (lookback
    fields included): the port's resume agrees with JAX's own, and with
    its correlations.csv row."""
    deck = TURB_DECK + EVERY_CYCLE
    ov = ["parthenon/mesh/merge_blocks=false"]
    _in(tmp_path / "run", lambda: JSim(JPin.from_string(
        deck, ov + ["parthenon/time/nlim=2"]), quiet=True).run())
    ckpt = _ckpt(tmp_path / "run", 2)
    js = _in(tmp_path / "jax", lambda: jrun_from_restart(
        ckpt, ["parthenon/time/nlim=4"], quiet=True))
    ts = _in(tmp_path / "torch", lambda: run_from_restart(
        ckpt, ["parthenon/time/nlim=4"], quiet=True, device="cpu"))
    assert ts.mesh.nblocks == 8 and ts.is_restart
    _hold_uniform(ts, js)
    rows = [np.loadtxt(tmp_path / d / "correlations.csv", delimiter=",")
            for d in ("torch", "jax")]
    assert rows[0].shape == rows[1].shape == (2, 40)
    assert np.abs(rows[0] - rows[1]).max() <= TOL


def test_port_checkpoint_resumes_in_jax(tmp_path):
    deck = TURB_DECK + EVERY_CYCLE
    ov = ["parthenon/mesh/merge_blocks=false"]
    _in(tmp_path / "run", lambda: Simulation(ParameterInput.from_string(
        deck, ov + ["parthenon/time/nlim=2"]), quiet=True,
        device="cpu").run())
    ckpt = _ckpt(tmp_path / "run", 2)
    js = _in(tmp_path / "jax", lambda: jrun_from_restart(
        ckpt, ["parthenon/time/nlim=4"], quiet=True))
    ts = _in(tmp_path / "torch", lambda: run_from_restart(
        ckpt, ["parthenon/time/nlim=4"], quiet=True, device="cpu"))
    _hold_uniform(js, ts)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_static_refined_checkpoint_crosses(tmp_path, writer):
    deck = SMR_DECK.replace("nlim = 1000", "nlim = 2") + EVERY_CYCLE
    make = (lambda: JSmr(JPin.from_string(deck), quiet=True)) \
        if writer == "jax" else (lambda: SmrSimulation(
            ParameterInput.from_string(deck), quiet=True, device="cpu"))
    _in(tmp_path / "run", lambda: make().run())
    ckpt = _ckpt(tmp_path / "run", 2)
    js = _in(tmp_path / "jax", lambda: jrun_from_restart(
        ckpt, ["parthenon/time/nlim=4"], quiet=True))
    ts = _in(tmp_path / "torch", lambda: run_from_restart(
        ckpt, ["parthenon/time/nlim=4"], quiet=True, device="cpu"))
    assert isinstance(ts, SmrSimulation) and len(ts.state) == 2
    _hold_refined(ts, js)


def test_jax_adaptive_checkpoint_resumes_in_the_port(tmp_path):
    """An adaptive JAX run (from a noised blast, with tracers and
    ``derefine_count = 2``, so the checkpoint holds live counters)
    checkpoints after cycle 2; the port resumes it and agrees with the
    JAX run's cycle 4: the leaf table, the state and the tracers."""
    ov = ["parthenon/mesh/derefine_count=2", "parthenon/output0/dt=-1",
          "parthenon/output7/file_type=rst", "parthenon/output7/dt=0.0",
          "parthenon/output7/id=r", "tracers/enabled=true",
          "tracers/initial_seed_method=random_per_block",
          "tracers/initial_num_tracers_per_cell=0.05",
          "tracers/capacity_factor=8", "parthenon/time/nlim=4"]

    def jax_run():
        js = JSmr(JPin.from_file(ADAPTIVE, ov), quiet=True)
        start = symmetry_noise({lev: np.asarray(u)
                                for lev, u in js.state.items()}, seed=5)
        js.state = {lev: jnp.asarray(v) for lev, v in start.items()}
        return js.run()

    js = _in(tmp_path / "run", jax_run)
    assert js.perf_remeshes >= 1
    ckpt = _ckpt(tmp_path / "run", 2)
    import h5py
    with h5py.File(ckpt, "r") as fh:
        assert "DerefCounts" in fh and "Tracers" in fh
    ts = _in(tmp_path / "torch", lambda: run_from_restart(
        ckpt, ["parthenon/time/nlim=4"], quiet=True, device="cpu"))
    assert ts.adaptive and ts.ncycle == 4
    np.testing.assert_array_equal(ts._smesh_now().levels,
                                  js._smesh_now().levels)
    _hold_refined(ts, js)


def test_merge_skipped_for_foreign_restart_layout():
    """A checkpoint written in a blocked layout resumes in that layout."""
    from test_merge_blocks import DECK as MDECK
    pin = ParameterInput.from_string(MDECK)
    pin.apply_overrides(["parthenon/mesh/merge_blocks=true"])
    mesh = Mesh.from_parameter_input(pin)
    payload = {"cons": np.zeros((mesh.nblocks, 9) + mesh.block_shape)}
    assert Simulation._merge_blocks(pin, mesh, payload) is mesh
    merged = Simulation._merge_blocks(pin, mesh)
    assert merged.nblocks == 1 and merged.nghost == 0
    ok = {"cons": np.zeros((1, 9) + merged.block_shape)}
    assert Simulation._merge_blocks(pin, mesh, ok) == merged


def test_triggers_continue_after_a_resume(tmp_path, monkeypatch):
    """The rst trigger advances before its write, so the checkpoint of
    count k resumes at k+1; hdf5 dumps and the .hst file go on where the
    first run stopped (nothing rewritten, the .hst appended to)."""
    monkeypatch.chdir(tmp_path)
    deck = DECK.format(tlim=100.0, nlim=3) + """
<parthenon/output1>
file_type = hdf5
variables = prim
dt = 0.0
id = prim

<parthenon/output2>
file_type = rst
dt = 0.0
id = r

<parthenon/output3>
file_type = hst
"""
    Simulation(ParameterInput.from_string(deck), quiet=True,
               device="cpu").run()
    rhdf = sorted(glob.glob("turbulence.out_r.*.rhdf"))
    phdf = sorted(glob.glob("turbulence.out_prim.*.phdf"))
    # t=0, three cycles, and the forced final write
    assert len(rhdf) == len(phdf) == 5
    hst_rows = len(open("turbulence.out3.hst").readlines())
    stamp = os.path.getmtime(rhdf[2])
    sim = run_from_restart(rhdf[2], ["parthenon/time/nlim=5"], quiet=True,
                           device="cpu")
    assert sim.ncycle == 5
    out_r = next(o for o in sim.outputs if getattr(o, "oid", "") == "r")
    # resumed at count 3 (dt = 0 writes at every output call: the
    # resume's opening call 3, cycles 3..5 4..6, the final 7); the
    # checkpoint it came from is not rewritten
    assert out_r.count == 8
    assert os.path.getmtime(rhdf[2]) == stamp
    assert len(glob.glob("turbulence.out_r.*.rhdf")) == 8
    lines = open("turbulence.out3.hst").readlines()
    assert sum(ln.startswith("#") for ln in lines) == 2
    assert len(lines) > hst_rows


def test_refined_payload_round_trip_without_a_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    deck = SMR_DECK.replace("nlim = 1000", "nlim = {n}")
    full = SmrSimulation(ParameterInput.from_string(deck.format(n=4)),
                         quiet=True, device="cpu").run()
    half = SmrSimulation(ParameterInput.from_string(deck.format(n=2)),
                         quiet=True, device="cpu").run()
    payload = restart_payload_smr(half)
    assert payload["dt"] == half.tm_dt and "tracers" in payload
    rest = SmrSimulation(ParameterInput.from_string(deck.format(n=4)),
                         quiet=True, device="cpu", restart=payload).run()
    for lev, u in full.state.items():
        assert torch.equal(u, rest.state[lev])
    for lev, st in full.tracer_state["levels"].items():
        for k, v in st.items():
            assert torch.equal(v, rest.tracer_state["levels"][lev][k])
