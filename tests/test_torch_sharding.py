"""Port parity: multi-rank runs over ``torch.distributed`` (gloo, real
processes on the CPU) against the port's one-rank run and the JAX
package's sharded run on conftest's 8 virtual devices.

Twins of ``tests/test_sharding.py`` (the z-slab step and dt, the GSPMD
step, outflow z on the sharded axis, the (4, 2) rank grid with and
without outflow, the refined-mesh step, the sharded tracers periodic and
with outflow z) and of ``tests/test_tracers.py:
test_tracer_advect_sharded_bitwise``.  Each holds the port's sharded
result bit for bit against the port's one-rank result, and against the
JAX package's sharded result to that test's own tolerance.  Two cases the
JAX package's routing drops movers in (``athenapk_tpu/tracers/
sharded.py:94-105``) are held against the one-rank port run only: two
ranks with more leavers than one block layer's capacity at once, and
movers that cross several ranks in one step.  Last, the dry run's command
on 8 ranks.

The ranks are spawned processes (``parallel.dryrun.run_ranks``) running
``tests/torch_dist_workers.py``; inputs and outputs pass through files.
One spawn of 8 ranks serves the uniform, tracer and refined cases.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.solver.hydro_pkg import HydroConfig as JHydroConfig
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.driver import Simulation
from athenapk_tpu_torch.parallel.dryrun import run_ranks, tracer_setup
from test_sharding import _setup
from test_tracers import DECK as TRACER_DECK
import torch_dist_workers as w

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTFLOW_Z = {"ix3_bc": "outflow", "ox3_bc": "outflow"}
OUTFLOW_YZ = {"ix2_bc": "outflow", "ox2_bc": "outflow", **OUTFLOW_Z}
UNIFORM = {"periodic": ({}, None), "outflow_z": (OUTFLOW_Z, None),
           "grid_periodic": ({}, (4, 2)), "grid_outflow": (OUTFLOW_YZ, (4, 2))}
TRACERS = {
    # test_sharded_tracers_match_single_device: dz/step 0.09 < block 0.125
    "tr_periodic": dict(setup=dict(vel=(0.30, 0.15, 0.45), seed=7), steps=10,
                        dt=0.2, fill=True),
    # test_sharded_tracers_nonperiodic_z_deactivation
    "tr_outflow": dict(setup=dict(vel=(0.0, 0.0, 0.5), seed=11,
                                  bcs=OUTFLOW_Z), steps=12, dt=0.1,
                       fill=False),
}
JAX_SMR = {}   # the refined case's JAX stepper, state and dt


def _jax_smr_state():
    """``test_sharded_smr_step``'s ghost-filled state and dt (JAX)."""
    from athenapk_tpu.amr import SmrMesh
    from athenapk_tpu.amr.smr_hydro import SmrHydro
    from athenapk_tpu.eos.adiabatic import EOS, prim_to_cons

    base = JMesh(nx1=32, nx2=32, nx3=32, mbnx1=8, mbnx2=8, mbnx3=8,
                 x1min=0, x1max=1, x2min=0, x2max=1, x3min=0, x3max=1,
                 nghost=3)
    sm = SmrMesh(base, [(0.4, 0.6, 0.4, 0.6, 0.4, 0.6, 1)])
    cfg = JHydroConfig(fluid="euler", riemann="hllc", reconstruction="plm",
                       integrator="rk2")
    eos = EOS(gamma=5.0 / 3.0)
    sh = SmrHydro(sm, cfg, eos)
    state = {}
    for lev, ids in sm.level_ids.items():
        wp = np.zeros((len(ids), 5) + base.block_shape)
        for li, gid in enumerate(ids):
            x, y, z = sm.cell_centers_leaf(gid)
            r2 = (x - 0.3) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
            wp[li, 0] = 1.0 + np.broadcast_to(np.exp(-r2 / 0.01),
                                              base.block_shape)
            wp[li, 1] = 1.0
            wp[li, 4] = 1.0
        state[lev] = jnp.asarray(np.asarray(
            prim_to_cons(eos, jnp.asarray(wp), "euler")))
    state = sh.state_mgr.fill_ghosts(state)
    return sh, state, float(sh.estimate_dt(state))


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    """One spawn of 8 ranks for the uniform, tracer and refined cases."""
    d = str(tmp_path_factory.mktemp("ranks8"))
    cases = []
    for name, (bcs, grid) in UNIFORM.items():
        _, _, _, _, u = _setup(**bcs)
        np.save(os.path.join(d, f"{name}_u.npy"), np.asarray(u))
        cases.append(("uniform_case", (name, bcs, grid)))
    for name, spec in TRACERS.items():
        cases.append(("tracer_case", (name, spec)))
    sh, state, dt = JAX_SMR["case"] = _jax_smr_state()
    np.savez(os.path.join(d, "smr_in.npz"),
             **{str(k): np.asarray(v) for k, v in state.items()})
    cases.append(("smr_case", ("smr", dt)))
    run_ranks(w.run_cases, 8, (d, cases), device="cpu", timeout=600)
    return d


def _load(d, name):
    return np.load(os.path.join(d, f"{name}.npz"))


def _port_step(d, name):
    """The one-rank port step and dt of a uniform case's input."""
    ut = torch.from_numpy(np.load(os.path.join(d, f"{name}_u.npy")))
    pkg = w.uniform_pkg(UNIFORM[name][0])
    ref = pkg.step(ut, 1e-3, 1.0).numpy()
    _, prim = pkg.cons_to_prim(ut)
    return ref, pkg.estimate_timestep(prim)


def _check_uniform(ranks8, name, jax_got, jax_dts=None):
    out = _load(ranks8, name)
    ref, dts_ref = _port_step(ranks8, name)
    # the sharded port run is the one-rank port run, bit for bit
    np.testing.assert_array_equal(out["u"], ref)
    assert tuple(out["dts"]) == tuple(dts_ref)
    # and matches the JAX package's sharded run to its test's tolerance
    np.testing.assert_allclose(out["u"], jax_got, rtol=1e-14, atol=1e-14)
    if jax_dts is not None:
        np.testing.assert_allclose(out["dts"][0], float(jax_dts[0]),
                                   rtol=1e-15)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_shard_map_step_matches_single_device(ranks8):
    from athenapk_tpu.parallel.halo import make_sharded_step
    from athenapk_tpu.parallel.mesh_sharding import (make_device_mesh,
                                                     shard_state)

    mesh, cfg, eos, pkg, u = _setup()
    dmesh = make_device_mesh(jax.devices()[:8])
    u_sh = shard_state(u, mesh, dmesh)
    step_fn, dt_fn = make_sharded_step(pkg, dmesh)
    got = np.asarray(step_fn(u_sh, jnp.asarray(1e-3), jnp.asarray(1.0)))
    _check_uniform(ranks8, "periodic", got, dt_fn(u_sh))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_gspmd_step_matches_single_device(ranks8):
    """The port has no GSPMD: its explicit sharded step is held against
    the JAX package's GSPMD step (that test's 1e-13) and the one-rank
    port step (bit for bit)."""
    from athenapk_tpu.parallel.mesh_sharding import (
        make_block_sharding, make_device_mesh, replicated, shard_state)

    mesh, cfg, eos, pkg, u = _setup()
    dmesh = make_device_mesh(jax.devices()[:8])
    bsh = make_block_sharding(dmesh)
    rep = replicated(dmesh)
    step = jax.jit(pkg._step, in_shardings=(bsh, rep, rep),
                   out_shardings=bsh)
    got = np.asarray(step(shard_state(u, mesh, dmesh), jnp.asarray(1e-3),
                          jnp.asarray(1.0)))
    out = _load(ranks8, "periodic")
    np.testing.assert_array_equal(out["u"], _port_step(ranks8, "periodic")[0])
    np.testing.assert_allclose(out["u"], got, rtol=1e-13, atol=1e-13)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_shard_map_step_nonperiodic_z(ranks8):
    """Outflow on the sharded axis: applied on the edge ranks only."""
    from athenapk_tpu.parallel.halo import make_sharded_step
    from athenapk_tpu.parallel.mesh_sharding import (make_device_mesh,
                                                     shard_state)

    mesh, cfg, eos, pkg, u = _setup(**OUTFLOW_Z)
    dmesh = make_device_mesh(jax.devices()[:8])
    step_fn, _ = make_sharded_step(pkg, dmesh)
    got = np.asarray(step_fn(shard_state(u, mesh, dmesh), jnp.asarray(1e-3),
                             jnp.asarray(1.0)))
    _check_uniform(ranks8, "outflow_z", got)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
@pytest.mark.parametrize("name", ["grid_periodic", "grid_outflow"])
def test_shard_map_step_2d_mesh(ranks8, name):
    """The (4, 2) rank grid over block-grid (z, y): halos along both
    sharded axes, outflow on the edge ranks of both."""
    from athenapk_tpu.parallel.halo import (from_grid, grid_sharding,
                                            make_device_mesh_2d,
                                            make_sharded_step_grid, to_grid)

    mesh, cfg, eos, pkg, u = _setup(**UNIFORM[name][0])
    dmesh = make_device_mesh_2d(jax.devices(), (4, 2))
    ug = jax.device_put(to_grid(u, mesh), grid_sharding(dmesh))
    step_fn, dt_fn = make_sharded_step_grid(pkg, dmesh)
    got = np.asarray(from_grid(step_fn(ug, jnp.asarray(1e-3),
                                       jnp.asarray(1.0)), mesh))
    _check_uniform(ranks8, name, got, dt_fn(ug))


def test_sharded_smr_step(ranks8):
    """The refined mesh's step over 8 ranks (flat ownership: 15 leaves a
    rank, the boxes each reads of the others' rows exchanged per fill step,
    the fine face slabs for the coarse owners): the one-rank port step
    bit for bit; the JAX package's GSPMD step (bit for bit with its own
    one-device step) to the refined parity tests' 1e-12."""
    from jax.sharding import Mesh as DMesh, NamedSharding, PartitionSpec as P
    from athenapk_tpu_torch.amr.smr_hydro import SmrHydro

    sh, state, dt = JAX_SMR["case"]
    jm = DMesh(np.array(jax.devices()), ("blocks",))
    shd = NamedSharding(jm, P("blocks"))
    jout = {k: jax.device_put(v, shd) for k, v in state.items()}
    step_sharded = jax.jit(sh._step)
    for _ in range(2):
        jout = step_sharded(jout, jnp.asarray(dt), jnp.asarray(0.0))

    sm, cfg, eos = w.smr_mesh()
    ref = {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}
    one = SmrHydro(sm, cfg, eos, device="cpu")
    for _ in range(2):
        ref = one.step(ref, dt, 0.0)
    out = _load(ranks8, "smr")
    for lev in ref:
        got = out[str(lev)]
        np.testing.assert_array_equal(got, ref[lev].numpy(),
                                      err_msg=f"level {lev}")
        want = np.asarray(jout[lev])
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def _by_id(st):
    act = np.asarray(st["active"]).ravel()
    ids = np.asarray(st["id"]).ravel()[act]
    order = np.argsort(ids)
    return {k: np.asarray(v).ravel()[act][order]
            for k, v in st.items() if k != "n_lost"}


def _match_jax_by_id(jax_state, port_state):
    """The active tracers by id: ids and flags identical, positions and
    samples within ``test_torch_tracers.py``'s 1e-12 of the largest value
    or of 1 (the trilinear sums round differently in the two packages)."""
    a, b = _by_id(jax_state), _by_id(port_state)
    assert a["id"].size == b["id"].size > 0
    for k in a:
        if a[k].dtype.kind in "biu":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            scale = max(float(np.abs(a[k]).max()), 1.0)
            assert float(np.abs(b[k] - a[k]).max()) <= 1e-12 * scale, k


def _port_tracers(spec, nranks=None):
    """The one-rank port run of a tracer case: -> the pool (numpy)."""
    tr, st, prim = tracer_setup("cpu", **spec["setup"])
    for _ in range(spec["steps"]):
        st = tr.advect(st, prim, spec["dt"])
        if spec["fill"]:
            st = tr.fill(st, prim)
    return {k: v.numpy() for k, v in st.items()}


def _jax_tracers(spec, sharded):
    """The JAX package's run of a tracer case (sharded: on the 8 virtual
    devices through ``make_sharded_tracer_ops``)."""
    from athenapk_tpu.parallel.mesh_sharding import make_device_mesh
    from athenapk_tpu.tracers import Tracers
    from athenapk_tpu.tracers.sharded import make_sharded_tracer_ops

    s = spec["setup"]
    mesh = JMesh(nx1=16, nx2=16, nx3=64, mbnx1=8, mbnx2=8, mbnx3=8,
                 x1min=0, x1max=1, x2min=0, x2max=1, x3min=0, x3max=1,
                 nghost=2, **s.get("bcs", {}))
    cfg = JHydroConfig(fluid="euler", riemann="hllc", reconstruction="plm",
                       integrator="rk2")
    tr = Tracers(JPin.from_string(f"""
<job>
problem_id = advection
<tracers>
enabled = true
initial_seed_method = random_per_block
initial_num_tracers_per_cell = 0.05
initial_rng_seed = {s["seed"]}
"""), mesh, cfg)
    prim = np.zeros((mesh.nblocks, 5) + mesh.block_shape)
    prim[:, 0] = 1.0
    prim[:, 1:4] = np.asarray(s["vel"])[:, None, None, None]
    prim[:, 4] = 1.0
    prim = jnp.asarray(prim)
    st = tr.fill(tr.seed(), prim)
    advect, fill = tr.advect, tr.fill
    if sharded:
        a, f = make_sharded_tracer_ops(tr, make_device_mesh(
            jax.devices()[:8]))
        advect = lambda q, p, dt: a(q, p, jnp.asarray(dt))  # noqa: E731
        fill = f
    for _ in range(spec["steps"]):
        st = advect(st, prim, spec["dt"])
        if spec["fill"]:
            st = fill(st, prim)
    return st


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
@pytest.mark.parametrize("name", list(TRACERS))
def test_sharded_tracers_match_single_device(ranks8, name):
    """Per-rank pools with lossless routing, across many slab crossings
    (``tr_periodic``) and with outflow z deactivating leavers on the rank
    where they live (``tr_outflow``, the twin of
    ``test_sharded_tracers_nonperiodic_z_deactivation``): every slot of
    the one-rank port run bit for bit, and the JAX sharded run's active
    tracers by id (``_match_jax_by_id``), with the same ``n_lost``."""
    spec = TRACERS[name]
    out = dict(_load(ranks8, name))
    ref = _port_tracers(spec)
    for k, v in ref.items():
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    jst = _jax_tracers(spec, sharded=True)
    assert int(out["n_lost"]) == int(np.asarray(jst["n_lost"]))
    _match_jax_by_id(jst, out)
    if name == "tr_outflow":
        assert int(out["n_lost"]) > 0
        assert int(out["active"].sum()) < int(
            _port_tracers({**spec, "steps": 0})["active"].sum())


def _spawn(world, tmp_path, cases):
    run_ranks(w.run_cases, world, (str(tmp_path), cases), device="cpu",
              timeout=300)


def test_sharded_tracers_two_rank_overflow(tmp_path):
    """Two ranks of 4 z-layers each, every particle carried half the
    domain in one step: each rank sends its whole pool (4 layers' worth)
    at once, more than the JAX package's one-layer transfer buffer
    (``layer * cap``, ``athenapk_tpu/tracers/sharded.py:64``) holds.
    Nothing is lost; every slot equals the one-rank run."""
    spec = dict(setup=dict(vel=(0.0, 0.0, 2.5), seed=5,
                           capacity_factor=1.0), steps=3, dt=0.2, fill=True)
    _spawn(2, tmp_path, [("tracer_case", ("ovf", spec))])
    out = dict(np.load(tmp_path / "ovf.npz"))
    ref = _port_tracers(spec)
    tr, st, _ = tracer_setup("cpu", **spec["setup"])
    layer_cap = tr.mesh.nb1 * tr.mesh.nb2 * tr.cap
    assert int(st["active"].sum()) // 2 > layer_cap
    for k, v in ref.items():
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    assert int(out["n_lost"]) == 0
    assert int(out["active"].sum()) == int(st["active"].sum())


def test_sharded_tracers_multi_hop(tmp_path):
    """Four ranks, movers carried 0.45 of the domain per step: each crosses
    one or two ranks at once (the JAX package drops them as strays).
    Nothing is lost; every slot equals the one-rank run."""
    spec = dict(setup=dict(vel=(0.30, 0.15, 2.25), seed=9), steps=4, dt=0.2,
                fill=True)
    _spawn(4, tmp_path, [("tracer_case", ("hop", spec))])
    out = dict(np.load(tmp_path / "hop.npz"))
    ref = _port_tracers(spec)
    for k, v in ref.items():
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    assert int(out["n_lost"]) == 0


def test_tracer_advect_sharded_bitwise(tmp_path):
    """Twin of ``tests/test_tracers.py:test_tracer_advect_sharded_bitwise``:
    the tracer deck's ``Simulation`` on 2 ranks (``merge_blocks = auto``
    keeps its 8 blocks there), one advect + fill sharded, against the
    one-rank port run in every slot and the JAX package's run by id."""
    from athenapk_tpu.driver import Simulation as JSim

    _spawn(2, tmp_path, [("sim_tracer_case", ("sim", TRACER_DECK, 0.01))])
    out = dict(np.load(tmp_path / "sim.npz"))
    pin = ParameterInput.from_string(TRACER_DECK)
    pin.apply_overrides(["parthenon/mesh/merge_blocks=false"])
    sim = Simulation(pin, quiet=True, device="cpu")
    _, wp = sim.pkg.cons_to_prim(sim.u)
    ref = sim.tracers.fill(sim.tracers.advect(sim.tracer_state, wp, 0.01),
                           wp)
    for k, v in ref.items():
        np.testing.assert_array_equal(out[k], v.numpy(), err_msg=k)
    jsim = JSim(JPin.from_string(TRACER_DECK), quiet=True)
    _, jw = jsim.pkg.cons_to_prim(jsim.u)
    jref = jsim.tracers.fill(jsim.tracers.advect(jsim.tracer_state, jw,
                                                 0.01), jw)
    _match_jax_by_id(jref, out)


def test_dryrun_command_on_8_ranks():
    """``python -m athenapk_tpu_torch.parallel.dryrun --ranks 8 --device
    cpu`` exits 0: every sharded path equal to the one-rank run, and each
    rank's bytes per fill equal to the halo or to the boxes of its
    schedule, within the face-slab and all-gather bounds."""
    res = subprocess.run(
        [sys.executable, "-m", "athenapk_tpu_torch.parallel.dryrun",
         "--ranks", "8", "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "bit for bit" in res.stdout
    for case in ("uniform_z_slabs", "grid_z_y", "adaptive_flat", "tracers"):
        assert f"{case}: " in res.stdout


@pytest.mark.parametrize("device,world,n_cuda,want", [
    ("cpu", 8, 0, "gloo"), ("cuda", 2, 1, "gloo"), ("cuda", 4, 4, "nccl"),
    ("cuda", 1, 1, "nccl"), ("cuda", 8, 4, "gloo")])
def test_backend_rule(device, world, n_cuda, want):
    """nccl only where every rank has a card of its own; gloo on the CPU
    and where ranks share a card (then its messages are host-staged)."""
    from athenapk_tpu_torch.parallel.mesh_sharding import (RankMesh,
                                                           choose_backend)

    assert choose_backend(device, world, n_cuda) == want
    rm = RankMesh(0, world, (world,), ("blocks",), torch.device(device),
                  want)
    assert rm.staged == (want == "gloo" and device == "cuda")


def test_shard_state_checks_and_emit_dt_refused():
    """``shard_state``'s two checks, with the JAX package's messages, and
    a sharded step that refuses the rank-local CFL bound of ``emit_dt``
    (no process group needed: both raise before any message)."""
    from athenapk_tpu_torch.parallel.halo import make_sharded_step
    from athenapk_tpu_torch.parallel.mesh_sharding import (RankMesh,
                                                           shard_state)

    pkg = w.uniform_pkg({})
    u = torch.zeros((pkg.mesh.nblocks, 9) + pkg.mesh.block_shape)
    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        shard_state(u, pkg.mesh, RankMesh(0, 3, (3,), ("blocks",),
                                          torch.device("cpu"), "gloo"))
    # 32 blocks over 16 ranks: 2 a rank, half a z-layer of 4
    with pytest.raises(ValueError, match="multiple of one z-layer"):
        shard_state(u, pkg.mesh, RankMesh(0, 16, (16,), ("blocks",),
                                          torch.device("cpu"), "gloo"))
    rm = RankMesh(0, 8, (8,), ("blocks",), torch.device("cpu"), "gloo")
    step = make_sharded_step(pkg, rm)
    with pytest.raises(ValueError, match="emit_dt"):
        step.step(shard_state(u, pkg.mesh, rm), 1e-3, 1.0, emit_dt=True)


def test_sendrecv_skips_empty_messages(tmp_path):
    """An empty message is not posted on either side (NCCL takes none):
    its receive is an empty tensor, the full message beside it to the
    same peer arrives, and only its bytes are counted."""
    run_ranks(w.run_cases, 2, (str(tmp_path), [
        ("empty_message_case", ("empty",))]), device="cpu", timeout=300)
    out = np.load(tmp_path / "empty.npz")
    assert out["empty"].shape == (0,)
    np.testing.assert_array_equal(out["full"], np.arange(6) + 10.0)
    assert int(out["sent"]) == 6 * 8
