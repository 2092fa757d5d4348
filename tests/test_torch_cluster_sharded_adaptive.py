"""Port parity: the galaxy cluster's unsplit source over ranks on an
adaptive mesh, through a remesh that changes the leaves, on real gloo
processes.

The deck is ``torch_decks.cluster_adaptive_deck(split=False)`` (base 32^3
over +-0.04 Mpc in 8^3 blocks, ``numlevel = 2``, ``pressure_gradient`` at
0.08; gravity, AGN feedback with COLD_GAS triggering and the tower, SN Ia,
Townsend cooling; no split source, which the port refuses over ranks).
From the one-rank initial refinement ({0: 56, 1: 64} leaves), four cycles
of (remesh, dt, step); the remesh before the fourth changes the leaves to
{0: 54, 1: 80}.

* over 2 ranks (flat layout, stage-faces rung) and 4 ranks (padded
  layout, negdiv-faces rung): the leaf tables after every cycle, every
  dt and every level equal the port's one-rank run bit for bit, and each
  rank's hooks make one collective per stage;
* the port against the JAX package's sharded ``AmrHydro`` (flat, 8 host
  devices) with the same unsplit factory: leaf tables equal, every dt and
  every variable of every level to 1e-12 relative.
"""

import os

import jax
import numpy as np
import pytest
import torch

from athenapk_tpu.refinement import RefinementConfig as JRcfg
from athenapk_tpu_torch.parallel.dryrun import run_ranks
from test_torch_cluster_sharded import (TOL, _rel_per_var, jax_sharded,
                                        load_run, one_rank, port_sim,
                                        save_initial)
from torch_decks import cluster_adaptive_deck, write_cluster_table
import torch_dist_workers as w

torch.set_num_threads(2)

NCYCLES = 4
CASES = [(2, "flat", "stage"), (4, "padded", "negdiv")]


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    root = tmp_path_factory.mktemp("cluster_adaptive_sharded")
    return cluster_adaptive_deck(write_cluster_table(root / "cluster.cool"),
                                 nlim=NCYCLES, split=False)


@pytest.fixture(scope="module")
def ranks(deck, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cluster_adaptive_ranks"))
    save_initial(d, "cluster", port_sim(deck, "stage", amr=False)[0])
    init = dict(np.load(os.path.join(d, "cluster_in.npz")))
    for world, layout, rung in CASES:
        name = f"a{world}_{layout}_{rung}"
        np.savez(os.path.join(d, f"{name}_in.npz"), **init)
        run_ranks(w.run_cases, world, (d, [("cluster_case", (
            name, deck, layout, rung, NCYCLES, True))]), device="cpu",
            timeout=600)
    return d


@pytest.mark.parametrize("world,layout,rung", CASES)
def test_sharded_adaptive_cluster_bitwise_vs_one_rank(ranks, deck, world,
                                                      layout, rung):
    state, table, nums = load_run(ranks, f"a{world}_{layout}_{rung}")
    amr, ref, dts, tables = one_rank(deck, rung, NCYCLES, True)
    assert tables[0] == {0: 56, 1: 64} and tables[-1] == {0: 54, 1: 80}
    assert nums["tables"] == [{str(k): v for k, v in t.items()}
                              for t in tables]
    assert nums["changed"] >= 1
    for k in ("levels", "lx1", "lx2", "lx3"):
        np.testing.assert_array_equal(table[k], getattr(amr.smesh, k))
    ex = amr.exact_state(ref)
    assert sorted(state) == sorted(ex)
    for lev, v in ex.items():
        np.testing.assert_array_equal(state[lev], v.numpy(),
                                      err_msg=f"level {lev}")
    assert nums["dts"] == dts
    assert nums["collectives"] == [2 * NCYCLES] * world


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_adaptive_cluster_matches_jax_sharded(ranks, deck):
    init = np.load(os.path.join(ranks, "cluster_in.npz"))
    table = {k: init[k] for k in ("levels", "lx1", "lx2", "lx3")}
    from athenapk_tpu.config.parameter_input import ParameterInput as JPin
    want, jdts, jtables, jsm = jax_sharded(
        deck, {int(k[1:]): init[k] for k in init.files if k.startswith("L")},
        table, "flat", NCYCLES, True,
        rcfg=JRcfg.from_parameter_input(JPin.from_string(deck)))
    assert jtables[-1] == {0: 54, 1: 80}
    for world, layout, rung in CASES:
        state, got_table, nums = load_run(ranks, f"a{world}_{layout}_{rung}")
        assert nums["tables"] == [{str(k): v for k, v in t.items()}
                                  for t in jtables]
        for k in ("levels", "lx1", "lx2", "lx3"):
            np.testing.assert_array_equal(got_table[k], getattr(jsm, k))
        np.testing.assert_allclose(nums["dts"], jdts, rtol=TOL)
        for lev, v in want.items():
            assert _rel_per_var(state[lev], v) <= TOL, (world, lev)
