"""Port parity: the galaxy cluster's unsplit source over ranks
(``AmrHydro(..., rmesh=..., problem_source_factory=...)``: gravity, AGN
feedback with COLD_GAS triggering and the tower, SN Ia, with Townsend
cooling) on a static refined mesh, on real gloo processes, and the hooks
that stay refused over ranks.

The deck is ``torch_decks.cluster_deck`` at base 16^3 over +-0.02 Mpc in
8^3 blocks with the octant x, y, z > 0 at level 1 (7 + 8 leaves), f64,
without the split sources (stellar feedback off, ``clip_r = -1``): over
ranks the port refuses them, where the JAX package's sharded
``AmrHydro`` drops them.  Three cycles from the same initial state:

* over 2 and 4 ranks, the flat and the padded layouts, the stage-faces
  and the negdiv-faces rungs: every level equals the port's one-rank run
  bit for bit (the hook's sums run per leaf in global leaf order on both,
  ``amr/leaf_sums.py``), every dt too, and each rank's hook makes one
  collective per stage;
* the port against the JAX package's sharded ``AmrHydro`` with the same
  unsplit factory on 8 host devices (flat and padded): every variable of
  every level to 1e-12 relative to its largest value, every dt to 1e-12,
  the leaf tables equal.

And: the first-order and Strang factories still raise over ranks, naming
the JAX package's behaviour; a uniform sharded step refuses a package with
an unsplit problem source, where the JAX package's ``shard_map`` step
fails on the shapes of the same closure when it traces.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as DMesh, NamedSharding, PartitionSpec as P

from athenapk_tpu_torch.amr.remesh import AmrHydro
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.driver import Simulation
from athenapk_tpu_torch.parallel.dryrun import run_ranks
from athenapk_tpu_torch.parallel.halo import (make_sharded_step,
                                              make_sharded_step_grid)
from athenapk_tpu_torch.parallel.mesh_sharding import RankMesh
from torch_decks import cluster_deck, write_cluster_table
import torch_dist_workers as w

torch.set_num_threads(2)

TOL = 1e-12
NCYCLES = 3
OCTANT = (0.0, 0.02, 0.0, 0.02, 0.0, 0.02, 1)
# (ranks, layout, rung): both layouts and both rungs at each world size
CASES = [(2, "flat", "stage"), (2, "padded", "negdiv"),
         (4, "flat", "negdiv"), (4, "padded", "stage")]


def unsplit_only(deck):
    """The cluster deck without its split sources (the clips off; build it
    with ``stellar=False``)."""
    assert "clip_r = 0.02" in deck
    return deck.replace("clip_r = 0.02", "clip_r = -1.0")


def _rel_per_var(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return max(float(np.abs(got[:, v] - want[:, v]).max()
                     / np.abs(want[:, v]).max())
               for v in range(want.shape[1]) if np.abs(want[:, v]).max() > 0)


def save_initial(d, name, sim):
    """The initial whole state and leaf table, for the ranks."""
    sm = sim.driver.smesh if sim.driver is not None else sim.smesh
    np.savez(os.path.join(d, f"{name}_in.npz"), levels=sm.levels,
             lx1=sm.lx1, lx2=sm.lx2, lx3=sm.lx3,
             **{f"L{k}": v.numpy() for k, v in sim.state.items()})


def load_run(d, name):
    out = np.load(os.path.join(d, f"{name}.npz"))
    with open(os.path.join(d, f"{name}.json")) as f:
        nums = json.load(f)
    state = {int(k[1:]): out[k] for k in out.files if k.startswith("L")}
    table = {k: out[k] for k in ("levels", "lx1", "lx2", "lx3")}
    return state, table, nums


def port_sim(deck, rung, amr=True):
    """``w.cluster_sim`` (and its one-rank ``w.cluster_amr``) with the
    rung's environment undone afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ATHENAPK_PALLAS_STAGE", "1" if rung == "stage" else "0")
        sim = w.cluster_sim(deck, rung)
        return sim, (w.cluster_amr(sim) if amr else None)


def one_rank(deck, rung, ncycles, remesh):
    """The port's one-rank run of ``cluster_cycles``: -> (AmrHydro, state,
    dts, tables)."""
    sim, amr = port_sim(deck, rung)
    st, dts, tables = w.cluster_cycles(amr, dict(sim.state), ncycles, remesh)
    return amr, st, dts, tables


def jax_sharded(deck, state, table, layout, ncycles, remesh, rcfg=None,
                derefine_count=1):
    """The JAX package's sharded ``AmrHydro`` (8 host devices) with the
    cluster's unsplit factory and cooling, from the port's initial state
    and leaf table, over ``w.cluster_cycles``' protocol: -> (exact state,
    dts, tables)."""
    from athenapk_tpu.amr.remesh import AmrHydro as JAmr
    from athenapk_tpu.amr.smr import SmrMesh as JSmrMesh
    from athenapk_tpu.config.parameter_input import ParameterInput as JPin
    from athenapk_tpu.core.mesh import Mesh as JMesh
    from athenapk_tpu.eos.adiabatic import EOS as JEOS
    from athenapk_tpu.pgen.cluster import pgen as jcl
    from athenapk_tpu.refinement import RefinementConfig as JRcfg
    from athenapk_tpu.solver.hydro_pkg import HydroConfig as JCfg
    from athenapk_tpu.srcterms.tabular_cooling import TabularCooling
    from athenapk_tpu.utils.units import Units, mean_molecular_weights

    pin = JPin.from_string(deck)
    cfg, eos = JCfg.from_parameter_input(pin), JEOS.from_parameter_input(pin)
    units = Units(pin)
    he = pin.get_real("hydro", "He_mass_fraction")
    mu, _ = mean_molecular_weights(he)
    cooling = TabularCooling(pin, units, pin.get_real("hydro", "gamma"), mu,
                             he, mu * units.mh() / units.k_boltzmann())
    base = JMesh.from_parameter_input(pin)
    sm = JSmrMesh.from_leaf_table(
        base, table["levels"], table["lx1"], table["lx2"], table["lx3"],
        max_level=int(pin.get_or_add_integer("parthenon/mesh", "numlevel",
                                             1)) - 1
        if remesh else int(np.max(table["levels"])))
    shd = NamedSharding(DMesh(np.asarray(jax.devices()[:8]), ("blocks",)),
                        P("blocks"))
    amr = JAmr(sm, cfg, eos, rcfg or JRcfg(), derefine_count=derefine_count,
               cooling=cooling, sharding=shd, layout=layout,
               problem_source_factory=lambda s: jcl.problem_source_unsplit_smr(
                   pin, s, cfg, eos))
    st = {k: jnp.asarray(v) for k, v in state.items()}
    t, dts, tables = 0.0, [], []
    for _ in range(ncycles):
        st = amr._place(st)
        if remesh:
            st, _ = amr.maybe_remesh(st)
            st = amr._place(st)
        s = amr.smesh
        tables.append({int(k): len(v) for k, v in s.level_ids.items()})
        dt = float(amr._stepper.estimate_dt(st))
        c_h = cfg.cfl * s.min_dx(s.max_level) / dt
        st = amr._stepper.step(st, dt, c_h, t)
        t += dt
        dts.append(dt)
    ex = amr.exact_state(st)
    return ({k: np.asarray(v) for k, v in ex.items()}, dts, tables,
            amr.smesh)


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    root = tmp_path_factory.mktemp("cluster_sharded")
    return unsplit_only(cluster_deck(
        n=16, mb=8, half=0.02, nlim=NCYCLES, refinement="static",
        regions=[OCTANT], stellar=False,
        table=write_cluster_table(root / "cluster.cool")))


@pytest.fixture(scope="module")
def ranks(deck, tmp_path_factory):
    """One spawn per world size, every (layout, rung) case of it."""
    d = str(tmp_path_factory.mktemp("cluster_ranks"))
    save_initial(d, "cluster", port_sim(deck, "stage", amr=False)[0])
    for world in (2, 4):
        cases = []
        for n, layout, rung in CASES:
            if n != world:
                continue
            name = f"c{n}_{layout}_{rung}"
            np.savez(os.path.join(d, f"{name}_in.npz"),
                     **np.load(os.path.join(d, "cluster_in.npz")))
            cases.append(("cluster_case", (name, deck, layout, rung, NCYCLES,
                                           False)))
        run_ranks(w.run_cases, world, (d, cases), device="cpu", timeout=600)
    return d


@pytest.fixture(scope="module")
def one_rank_runs(deck):
    return {rung: one_rank(deck, rung, NCYCLES, False)
            for rung in ("stage", "negdiv")}


# ------------------------------------------------------------------- tests
@pytest.mark.parametrize("world,layout,rung", CASES)
def test_sharded_cluster_bitwise_vs_one_rank(ranks, one_rank_runs, world,
                                             layout, rung):
    state, table, nums = load_run(ranks, f"c{world}_{layout}_{rung}")
    amr, ref, dts, _ = one_rank_runs[rung]
    for k in ("levels", "lx1", "lx2", "lx3"):
        np.testing.assert_array_equal(table[k], getattr(amr.smesh, k))
    assert sorted(state) == sorted(ref) == [0, 1]
    for lev, v in ref.items():
        np.testing.assert_array_equal(state[lev], v.numpy(),
                                      err_msg=f"level {lev}")
    assert nums["dts"] == dts
    # one collective per stage (VL2: two a cycle) on every rank
    assert nums["collectives"] == [2 * NCYCLES] * world
    # the AGN tracer reached the scalar on the finest level
    assert float(state[1][:, 9].max()) > 0.0


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
@pytest.mark.parametrize("layout", ["flat", "padded"])
def test_sharded_cluster_matches_jax_sharded(ranks, deck, one_rank_runs,
                                             layout):
    init = np.load(os.path.join(ranks, "cluster_in.npz"))
    table = {k: init[k] for k in ("levels", "lx1", "lx2", "lx3")}
    want, jdts, jtables, jsm = jax_sharded(
        deck, {int(k[1:]): init[k] for k in init.files if k.startswith("L")},
        table, layout, NCYCLES, False)
    for n, lay, rung in CASES:
        if lay != layout:
            continue
        state, got_table, nums = load_run(ranks, f"c{n}_{lay}_{rung}")
        for k in ("levels", "lx1", "lx2", "lx3"):
            np.testing.assert_array_equal(got_table[k], getattr(jsm, k))
        np.testing.assert_allclose(nums["dts"], jdts, rtol=TOL)
        assert sorted(state) == sorted(want)
        for lev, v in want.items():
            assert _rel_per_var(state[lev], v) <= TOL, (n, rung, lev)
    assert jtables == one_rank_runs["stage"][3]


def test_split_sources_refused_over_ranks(deck):
    """The first-order and the Strang factories raise over ranks (the JAX
    package drops them there); the unsplit factory is taken."""
    sim = port_sim(cluster_deck(n=16, mb=8, half=0.02, nlim=1,
                                refinement="static", regions=[OCTANT]),
                   "stage", amr=False)[0]
    src, fo, strang = sim._source_factories()
    assert fo(sim.smesh) is not None   # the clips and stellar feedback
    rm = RankMesh(0, 2, (2,), ("blocks",), torch.device("cpu"), "gloo")
    for kw in ({"problem_first_order_factory": fo},
               {"problem_strang_factory": fo}):
        with pytest.raises(ValueError, match="JAX package's sharded "
                           "AmrHydro drops them"):
            AmrHydro(sim.smesh, sim.cfg, sim.eos, None, device="cpu",
                     rmesh=rm, problem_source_factory=src, **kw)


def test_uniform_sharded_step_refuses_problem_source(tmp_path):
    """A uniform sharded step refuses a package with an unsplit problem
    source (its closure spans the whole mesh); the JAX package's
    ``shard_map`` step fails on the same closure's shapes."""
    text = cluster_deck(n=16, mb=8, half=0.02, stellar=False).replace(
        "nghost = 2", "nghost = 2\nmerge_blocks = false")
    sim = Simulation(ParameterInput.from_string(text), quiet=True,
                     device="cpu")
    assert sim.pkg.problem_source_unsplit is not None
    rm = RankMesh(0, 2, (2,), ("blocks",), torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="unsplit source"):
        make_sharded_step(sim.pkg, rm)
    gm = RankMesh(0, 2, (2, 1), ("z", "y"), torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="unsplit source"):
        make_sharded_step_grid(sim.pkg, gm)

    if len(jax.devices()) < 2:
        return
    from athenapk_tpu.config.parameter_input import ParameterInput as JPin
    from athenapk_tpu.driver import Simulation as JSim
    from athenapk_tpu.parallel.halo import make_sharded_step as jstep
    from athenapk_tpu.parallel.mesh_sharding import (make_device_mesh,
                                                     shard_state)

    js = JSim(JPin.from_string(text), quiet=True)
    dmesh = make_device_mesh(jax.devices()[:2])
    step_fn, _ = jstep(js.pkg, dmesh)
    with pytest.raises(TypeError, match="incompatible shapes"):
        step_fn(shard_state(js.u, js.mesh, dmesh), jnp.asarray(1e-6),
                jnp.asarray(0.0))


def test_leaf_sums_do_not_depend_on_the_rows_beside():
    """The per-leaf partial of a row is the same bits whether the row is
    summed alone or among others (pairwise halving, elementwise adds), and
    ``tree_sum`` adds in a fixed pairwise order."""
    from athenapk_tpu_torch.amr.leaf_sums import LeafSums, tree_sum

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((7, 3, 12, 12, 12)) * 1e3)
    whole = LeafSums.partial(x)
    for i in range(7):
        assert torch.equal(LeafSums.partial(x[i:i + 1])[0], whole[i])
        assert torch.equal(LeafSums.partial(x[i:i + 3])[0], whole[i])
    v = torch.from_numpy(rng.standard_normal(5))
    want = ((v[0] + v[4]) + v[2]) + (v[1] + v[3])
    assert torch.equal(tree_sum(v), want)
    assert tree_sum(torch.zeros((0, 2)), dim=0).shape == (2,)
