"""Port parity: Lagrangian tracers (``tracers/tracers.py``,
``tracers/smr_tracers.py``) against the JAX package on the CPU in f64.

* ``scatter_pool`` on seeded random keys, with overflow: the same buffers
  and the same overflow count;
* whole runs of the JAX package's tracer decks (``tests/test_tracers.py``)
  through both packages: uniform blocked and merged ghost-free, static
  refined, adaptive (``inputs/blast_3d_adaptive.in`` with
  ``derefine_count = 1``, in lockstep) and turbulence with its lookback
  fields: ``id``/``active``/``n_lost`` identical in every slot, positions
  and samples within 1e-12 of the largest value or of 1, whichever is
  larger (s = log(rho) of a density near 1 is ~1e-5, where the density's
  last bit is already 2e-11 of it), ``correlations.csv`` row by row so;
* the port's twins of ``tests/test_tracers.py`` (ballistic advection,
  ownership after migration, outflow deactivation, the fused cycle against
  the split one, the swarm in a ``.phdf`` dump, the static refined mesh,
  its swarm dump and restart, the turbulence correlations),
  ``tests/test_adaptive_tracers.py::test_adopt_preserves_particles_across_
  topology_change`` and ``tests/test_merge_blocks.py::
  test_merged_tracers_match_blocked``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from athenapk_tpu.amr.driver import SmrSimulation as JSmr
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.driver import Simulation as JSim
from athenapk_tpu.tracers.tracers import scatter_pool as jscatter
from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.amr.smr import SmrMesh
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation, run_from_restart
from athenapk_tpu_torch.outputs.hdf5 import read_phdf
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig
from athenapk_tpu_torch.tracers.smr_tracers import (SmrTracers,
                                                    compact_swarm_smr)
from athenapk_tpu_torch.tracers.tracers import scatter_pool
from test_tracers import DECK, SMR_DECK, TURB_DECK
from torch_decks import symmetry_noise

torch.set_num_threads(2)

TOL = 1e-12
ADAPTIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "inputs", "blast_3d_adaptive.in")
TRACERS = ["tracers/enabled=true",
           "tracers/initial_seed_method=random_per_block",
           "tracers/initial_num_tracers_per_cell=0.05",
           "tracers/initial_rng_seed=11", "tracers/capacity_factor=8"]


def _short(deck, nlim):
    return deck.replace("nlim = 1000", f"nlim = {nlim}")


def _hold(got, want, what=""):
    """Port tracer dict ``got`` (tensors) against JAX's ``want``: integer
    and boolean entries identical, float entries within TOL of the
    largest value or of 1."""
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        a = np.asarray(v)
        b = got[k].cpu().numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, (what, k)
        if a.dtype.kind == "f":
            scale = max(float(np.abs(a).max()), 1.0)
            assert float(np.abs(b - a).max()) <= TOL * scale, (what, k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what} {k}")


def _hold_smr(got, want, what=""):
    assert sorted(got["levels"]) == sorted(want["levels"]), what
    for lev, st in want["levels"].items():
        _hold(got["levels"][lev], st, f"{what} level {lev}")
    assert int(got["n_lost"]) == int(want["n_lost"]), what


def _run_in(path, sim):
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return sim.run()
    finally:
        os.chdir(cwd)


def _active_sorted_by_id(state):
    act = state["active"].numpy().ravel()
    order = np.argsort(state["id"].numpy().ravel()[act])
    return {k: v.numpy().reshape(act.size, *v.shape[2:])[act][order]
            for k, v in state.items() if k not in ("active", "n_lost")}


# ------------------------------------------------------------ scatter_pool
@pytest.mark.parametrize("cap", [30, 4])
def test_scatter_pool_matches_jax(cap):
    rng = np.random.default_rng(7)
    nb, n = 6, 60
    key = rng.integers(0, nb + 1, n).astype(np.int32)
    fields = {"x": rng.random(n), "id": np.arange(n, dtype=np.int32),
              "active": key < nb, "s": rng.random((n, 3))}
    want, jover = jscatter({k: jnp.asarray(v) for k, v in fields.items()},
                           jnp.asarray(key), nb, cap)
    got, tover = scatter_pool({k: torch.as_tensor(v)
                               for k, v in fields.items()},
                              torch.as_tensor(key), nb, cap)
    _hold(got, want)
    assert int(tover) == int(jover)
    assert (int(tover) > 0) == (cap == 4)


# ---------------------------------------------------------- whole runs
@pytest.mark.parametrize("merge", ["false", "true"])
def test_uniform_run_matches_jax(merge):
    ov = [f"parthenon/mesh/merge_blocks={merge}"]
    js = JSim(JPin.from_string(_short(DECK, 5), ov), quiet=True).run()
    ts = Simulation(ParameterInput.from_string(_short(DECK, 5), ov),
                    quiet=True, device="cpu").run()
    assert ts.mesh.nblocks == (1 if merge == "true" else 8)
    _hold(ts.tracer_state, js.tracer_state, merge)
    assert ts.tracer_state["x"].dtype == torch.float64


def test_turbulence_tracers_and_correlations_match_jax(tmp_path):
    ov = ["parthenon/mesh/merge_blocks=false"]
    js = _run_in(tmp_path / "jax", JSim(JPin.from_string(TURB_DECK, ov),
                                        quiet=True))
    ts = _run_in(tmp_path / "torch", Simulation(
        ParameterInput.from_string(TURB_DECK, ov), quiet=True,
        device="cpu"))
    _hold(ts.tracer_state, js.tracer_state)
    rows = [np.loadtxt(tmp_path / d / "correlations.csv", delimiter=",")
            for d in ("torch", "jax")]
    assert rows[0].shape == rows[1].shape == (5, 40)
    for got, want in zip(*rows):
        assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(),
                                                    1.0)
    heads = [(tmp_path / d / "correlations.csv").read_text().split("\n")[0]
             for d in ("torch", "jax")]
    assert heads[0] == heads[1]


def test_static_refined_run_matches_jax():
    deck = _short(SMR_DECK, 4)
    js = JSmr(JPin.from_string(deck), quiet=True).run()
    ts = SmrSimulation(ParameterInput.from_string(deck), quiet=True,
                       device="cpu").run()
    _hold_smr(ts.tracer_state, js.tracer_state)


def test_adaptive_run_matches_jax(tmp_path, monkeypatch):
    """The adaptive blast with tracers, in lockstep from the same noised
    state: leaf tables equal after every cycle, the tracers held, the
    population conserved, refinements and derefinements both seen."""
    monkeypatch.chdir(tmp_path)
    ov = ["parthenon/mesh/derefine_count=1", "parthenon/output0/dt=-1"] \
        + TRACERS
    jsim = JSmr(JPin.from_file(ADAPTIVE, ov), quiet=True)
    tsim = SmrSimulation(ParameterInput.from_file(ADAPTIVE, ov), quiet=True,
                         device="cpu")
    _hold_smr(tsim.tracer_state, jsim.tracer_state, "seed")
    n0 = sum(int(st["active"].sum())
             for st in tsim.tracer_state["levels"].values())
    start = symmetry_noise({lev: np.asarray(u)
                            for lev, u in jsim.state.items()}, seed=3)
    jsim.state = {lev: jnp.asarray(v) for lev, v in start.items()}
    tsim.load_state(start, 0.0, 0)
    tables = set()
    for k in range(1, 4):
        jsim.nlim = tsim.nlim = k
        jsim.run()
        tsim.run()
        sm = tsim._smesh_now()
        np.testing.assert_array_equal(sm.levels, jsim._smesh_now().levels)
        tables.add(tuple(sm.levels.tolist()))
        _hold_smr(tsim.tracer_state, jsim.tracer_state, f"cycle {k}")
        n = sum(int(st["active"].sum())
                for st in tsim.tracer_state["levels"].values())
        assert n + int(tsim.tracer_state["n_lost"]) == n0
    assert len(tables) >= 2 and tsim.perf_remeshes >= 1


# ------------------------------------------------ twins of test_tracers.py
def test_tracer_uniform_advection():
    sim = Simulation(ParameterInput.from_string(DECK), quiet=True,
                     device="cpu")
    ts0 = _active_sorted_by_id(sim.tracer_state)
    n0 = int(sim.tracer_state["active"].sum())
    sim.run()
    ts = _active_sorted_by_id(sim.tracer_state)
    assert int(sim.tracer_state["active"].sum()) == n0
    assert int(sim.tracer_state["n_lost"]) == 0
    np.testing.assert_array_equal(ts0["id"], ts["id"])
    for comp, v in (("x", 1.0), ("y", 0.5), ("z", 0.25)):
        expect = (ts0[comp] + v * sim.t) % 1.0
        err = np.abs((ts[comp] - expect + 0.5) % 1.0 - 0.5)
        assert err.max() < 1e-10, f"{comp}: max err {err.max():.2e}"
    np.testing.assert_allclose(ts["rho"], 1.0, rtol=1e-10)
    np.testing.assert_allclose(ts["vel_x"], 1.0, rtol=1e-10)


def test_tracer_migration_ownership():
    sim = Simulation(ParameterInput.from_string(
        DECK, ["parthenon/mesh/merge_blocks=false"]), quiet=True,
        device="cpu").run()
    st = sim.tracer_state
    mesh = sim.mesh
    act = st["active"].numpy()
    x, y, z = (st[c].numpy() for c in "xyz")
    nb, cap = act.shape
    b1 = np.clip((x // (mesh.mbnx1 * mesh.dx1)).astype(int), 0, mesh.nb1 - 1)
    b2 = np.clip((y // (mesh.mbnx2 * mesh.dx2)).astype(int), 0, mesh.nb2 - 1)
    b3 = np.clip((z // (mesh.mbnx3 * mesh.dx3)).astype(int), 0, mesh.nb3 - 1)
    owner = b1 + mesh.nb1 * (b2 + mesh.nb2 * b3)
    slots = np.broadcast_to(np.arange(nb)[:, None], (nb, cap))
    np.testing.assert_array_equal(owner[act], slots[act])
    n_per_block = int(mesh.mbnx1 * mesh.mbnx2 * mesh.mbnx3 * 0.05)
    home = st["id"].numpy() // n_per_block
    assert (home[act] != slots[act]).any()


def test_tracer_outflow_deactivates():
    deck = DECK.replace(
        "<parthenon/meshblock>",
        "ix1_bc = outflow\nox1_bc = outflow\n\n<parthenon/meshblock>")
    sim = Simulation(ParameterInput.from_string(deck), quiet=True,
                     device="cpu")
    st0 = _active_sorted_by_id(sim.tracer_state)
    n0 = int(sim.tracer_state["active"].sum())
    sim.run()
    act = sim.tracer_state["active"].numpy()
    n_lost = int(sim.tracer_state["n_lost"])
    assert int(act.sum()) + n_lost == n0
    assert n_lost == int((st0["x"] + 1.0 * sim.t >= 1.0).sum())
    x = sim.tracer_state["x"].numpy()[act]
    assert (x >= 0.0).all() and (x < 1.0).all()


def test_tracer_fast_path_matches_slow_path():
    """The fused cycle against the split one (forced with a no-op Strang
    source, a no-op on a periodic domain): the same tracers bit for bit
    (the port's two cycles advect and fill in the same place)."""
    fast = Simulation(ParameterInput.from_string(DECK), quiet=True,
                      device="cpu")
    assert not fast._split_cycle()
    fast.run()
    slow = Simulation(ParameterInput.from_string(DECK), quiet=True,
                      device="cpu")
    slow.src_strang = lambda u, dt, t: u
    assert slow._split_cycle()
    slow.run()
    assert fast.ncycle == slow.ncycle and fast.t == slow.t
    for k, v in fast.tracer_state.items():
        assert torch.equal(v, slow.tracer_state[k]), k


def test_tracer_swarm_phdf_output(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    deck = DECK + """
<parthenon/output0>
file_type = hdf5
variables = prim
dt = 1.0
id = prim
swarms = tracers
tracers_variables = id, x, y, z, rho
"""
    sim = Simulation(ParameterInput.from_string(
        deck, ["parthenon/time/nlim=2"]), quiet=True, device="cpu").run()
    d = read_phdf("advection.out_prim.00000.phdf")
    sw = d.swarms["tracers"]
    n_active = int(sim.tracer_state["active"].sum())
    for var in ("id", "x", "y", "z", "rho"):
        assert len(sw[var]) == n_active
    assert (np.sort(sw["id"]) == np.arange(n_active)).all()


def _smr_active_by_id(state):
    out = {}
    for lev in sorted(state["levels"]):
        st = state["levels"][lev]
        act = st["active"].numpy().reshape(-1)
        for k, v in st.items():
            if k != "active":
                out.setdefault(k, []).append(v.numpy().reshape(-1)[act])
    merged = {k: np.concatenate(v) for k, v in out.items()}
    order = np.argsort(merged["id"])
    return {k: v[order] for k, v in merged.items()}


def test_tracer_smr_advection():
    sim = SmrSimulation(ParameterInput.from_string(SMR_DECK), quiet=True,
                        device="cpu")
    assert len(sim.smesh.level_ids) == 2
    ts0 = _smr_active_by_id(sim.tracer_state)
    assert len(ts0["id"]) > 0
    sim.run()
    ts = _smr_active_by_id(sim.tracer_state)
    assert int(sim.tracer_state["n_lost"]) == 0
    np.testing.assert_array_equal(ts0["id"], ts["id"])
    for comp, v in (("x", 1.0), ("y", 0.5), ("z", 0.25)):
        expect = (ts0[comp] + v * sim.t) % 1.0
        err = np.abs((ts[comp] - expect + 0.5) % 1.0 - 0.5)
        assert err.max() < 1e-10, f"{comp}: max err {err.max():.2e}"
    np.testing.assert_allclose(ts["rho"], 1.0, rtol=1e-10)
    sm = sim.smesh
    base = sm.base
    for lev, st in sim.tracer_state["levels"].items():
        act = st["active"].numpy()
        x, y, z = (st[c].numpy() for c in "xyz")
        ids_lev = sm.level_ids[lev]
        w = [base.mbnx1 * base.dx1 / (1 << lev),
             base.mbnx2 * base.dx2 / (1 << lev),
             base.mbnx3 * base.dx3 / (1 << lev)]
        for i in range(act.shape[0]):
            g, sel = ids_lev[i], act[i]
            for q, wq, lq in ((x, w[0], sm.lx1), (y, w[1], sm.lx2),
                              (z, w[2], sm.lx3)):
                assert (np.floor(q[i][sel] / wq).astype(int) == lq[g]).all()


def test_tracer_smr_swarm_dump_and_restart(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    deck = SMR_DECK + """
<parthenon/output0>
file_type = hdf5
variables = prim
dt = 1.0
id = prim
swarms = tracers
tracers_variables = id, x, y, z, rho

<parthenon/output1>
file_type = rst
dt = 1.0
id = restart
"""
    sim = SmrSimulation(ParameterInput.from_string(
        deck, ["parthenon/time/nlim=2"]), quiet=True, device="cpu").run()
    d = read_phdf("advection.outprim.00000.phdf")
    n_active = sum(int(st["active"].sum())
                   for st in sim.tracer_state["levels"].values())
    assert len(d.swarms["tracers"]["x"]) == n_active
    sim2 = run_from_restart("advection.out_restart.00000.rhdf",
                            ["parthenon/time/nlim=2"], quiet=True,
                            device="cpu")
    for lev, st in sim.tracer_state["levels"].items():
        for k, v in st.items():
            assert torch.equal(v, sim2.tracer_state["levels"][lev][k]), k


def test_turbulence_tracer_correlations(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sim = Simulation(ParameterInput.from_string(TURB_DECK), quiet=True,
                     device="cpu").run()
    st = sim.tracer_state
    act = st["active"].numpy()
    s = st["s"].numpy()
    rho = st["rho"].numpy()
    np.testing.assert_allclose(s[..., 0][act], np.log(rho[act]), rtol=1e-12)
    assert float(st["t_lookback"][0]) == sim.t
    lines = open("correlations.csv").readlines()
    assert lines[0].startswith("# cycle, time, s, sdot")
    assert len(lines) == 1 + 4 + 1
    last = np.array(lines[-1].split(","), dtype=float)
    n_act = act.sum()
    np.testing.assert_allclose(last[2], s[..., 0][act].sum() / n_act,
                               rtol=1e-12)
    np.testing.assert_allclose(last[4], (s[..., 0][act] ** 2).sum() / n_act,
                               rtol=1e-12)


# ------------------------------------- adopt and the merged ghost-free run
def test_adopt_preserves_particles_across_topology_change():
    """Twin of test_adaptive_tracers.py's adopt test: the population
    re-binned from a one-region mesh onto a two-region one keeps every
    (id, x, y, z, rho) and lands on the finest leaf covering it."""
    base = Mesh(nx1=16, nx2=16, nx3=16, mbnx1=8, mbnx2=8, mbnx3=8,
                x1min=0, x1max=1, x2min=0, x2max=1, x3min=0, x3max=1,
                nghost=2)
    pin = ParameterInput.from_string(
        "<tracers>\nenabled = true\ninitial_seed_method = random_per_block"
        "\ninitial_num_tracers_per_cell = 0.02\ninitial_rng_seed = 5\n")
    cfg = HydroConfig(fluid="euler", riemann="hllc", reconstruction="plm",
                      integrator="rk2")
    r1 = (0.0, 0.45, 0.0, 0.45, 0.0, 0.45, 1)
    r2 = (0.55, 1.0, 0.55, 1.0, 0.55, 1.0, 1)
    st = SmrTracers(pin, SmrMesh(base, [r1]), cfg, device="cpu").seed()
    for s in st["levels"].values():
        s["rho"] = torch.where(s["active"], 1.0 + 0.001 * s["id"], 0.0)
    names = ["id", "x", "y", "z", "rho"]
    before = compact_swarm_smr(st, names)
    st2 = SmrTracers(pin, SmrMesh(base, [r1, r2]), cfg,
                     device="cpu").adopt(st)
    after = compact_swarm_smr(st2, names)
    ob, oa = np.argsort(before["id"]), np.argsort(after["id"])
    for k in names:
        np.testing.assert_array_equal(after[k][oa], before[k][ob], err_msg=k)
    assert int(st2["n_lost"]) == int(st["n_lost"])
    lev1 = st2["levels"][1]
    act1 = lev1["active"].numpy()
    x1, y1, z1 = (lev1[c].numpy()[act1] for c in "xyz")
    assert ((x1 > 0.55) & (y1 > 0.55) & (z1 > 0.55)).any()
    lev0 = st2["levels"][0]
    act0 = lev0["active"].numpy()
    x0, y0, z0 = (lev0[c].numpy()[act0] for c in "xyz")
    assert not (((x0 < 0.45) & (y0 < 0.45) & (z0 < 0.45))
                | ((x0 > 0.55) & (y0 > 0.55) & (z0 > 0.55))).any()


def test_merged_tracers_match_blocked():
    """Twin of test_merge_blocks.py's tracer test: the merged ghost-free
    run (cyclic-wrap interpolation), handed the blocked run's seed, moves
    the tracers as the blocked run does."""
    deck = DECK.replace("nlim = 1000", "nlim = 12")

    def make(merge):
        return Simulation(ParameterInput.from_string(
            deck, [f"parthenon/mesh/merge_blocks={merge}",
                   "tracers/initial_rng_seed=5"]), quiet=True, device="cpu")

    a, b = make("false"), make("true")
    assert b.mesh.nblocks == 1 and b.mesh.nghost == 0
    act = a.tracer_state["active"].reshape(-1)
    n = int(act.sum())
    b.tracer_state = {
        k: (torch.zeros((), dtype=torch.int32) if k == "n_lost" else
            v.reshape((-1,) + tuple(v.shape[2:]))[act][None])
        for k, v in a.tracer_state.items()}
    a.run()
    b.run()
    sa = _active_sorted_by_id(a.tracer_state)
    sb = _active_sorted_by_id(b.tracer_state)
    assert sa["id"].size == sb["id"].size == n > 0
    for k in ("x", "y", "z", "rho", "vel_x"):
        np.testing.assert_allclose(sa[k], sb[k], rtol=0, atol=1e-13,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["Tracers", "SmrTracers"])
def test_tracers_default_to_the_card(kind, monkeypatch):
    """Without a device both tracer classes ask for the card, as every
    other entry point of the port does: where there is none that raises
    rather than quietly running on the CPU."""
    from athenapk_tpu_torch.tracers.tracers import Tracers

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = Mesh(nx1=16, nx2=16, nx3=16, mbnx1=8, mbnx2=8, mbnx3=8,
                x1min=0, x1max=1, x2min=0, x2max=1, x3min=0, x3max=1,
                nghost=2)
    pin = ParameterInput.from_string(
        "<tracers>\nenabled = true\ninitial_seed_method = random_per_block"
        "\ninitial_num_tracers_per_cell = 0.02\n")
    cfg = HydroConfig(fluid="euler", riemann="hllc", reconstruction="plm")
    make = {"Tracers": lambda **kw: Tracers(pin, base, cfg, **kw),
            "SmrTracers": lambda **kw: SmrTracers(
                pin, SmrMesh(base, [(0.0, 0.5, 0.0, 0.5, 0.0, 0.5, 1)]),
                cfg, **kw)}[kind]
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        make()
    assert make(device="cpu").device == torch.device("cpu")
