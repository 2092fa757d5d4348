"""Port parity: the galaxy cluster on an adaptive mesh on one rank
(``SmrSimulation`` with ``refinement = adaptive``: the cluster's
``problem_generator_smr`` regenerated on each initial topology, every
source on, Townsend cooling, the ``pressure_gradient`` criterion), against
the JAX package's ``SmrSimulation`` of the same deck, in f64 on the CPU.

The deck is ``torch_decks.cluster_adaptive_deck``: base 32^3 over
+-0.04 Mpc in 8^3 blocks, ``numlevel = 2``, ``derefine_count = 1``,
threshold 0.08.  Its initial refinement holds {0: 56, 1: 64} leaves and
the remesh before cycle 4 changes them to {0: 54, 1: 80}.  Four cycles on
the stage-faces and on the negdiv-faces rung: the leaf tables equal after
every cycle, every dt to 1e-12 relative, every variable of every level to
1e-12 relative to its largest value.  This is the one-rank baseline that
the sharded adaptive cluster (``test_torch_cluster_sharded_adaptive.py``,
``chip_smoke.py``'s path M5') is held to.
"""

import contextlib

import numpy as np
import pytest
import torch

from athenapk_tpu.amr.driver import SmrSimulation as JSmr
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from torch_decks import cluster_adaptive_deck, write_cluster_table

torch.set_num_threads(2)

TOL = 1e-12
NLIM = 4


def _rel_per_var(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return max(float(np.abs(got[:, v] - want[:, v]).max()
                     / np.abs(want[:, v]).max())
               for v in range(want.shape[1]) if np.abs(want[:, v]).max() > 0)


def _table(sm):
    return {int(k): int(len(v)) for k, v in sm.level_ids.items()}


def _cycles(sim, root):
    """``NLIM`` cycles one at a time: -> (dts, leaf counts after each)."""
    dts, tables = [], []
    for k in range(1, NLIM + 1):
        sim.nlim = k
        with contextlib.chdir(root):
            sim.run()
        dts.append(sim.tm_dt)
        tables.append(_table(sim.driver.smesh))
    return dts, tables


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cluster_adaptive")
    text = cluster_adaptive_deck(write_cluster_table(root / "cluster.cool"),
                                 nlim=NLIM)
    js = JSmr(JPin.from_string(text), quiet=True)
    start = _table(js.driver.smesh)
    dts, tables = _cycles(js, root)
    return text, js, start, dts, tables


@pytest.mark.parametrize("rung", ["stage", "negdiv"])
def test_adaptive_cluster_matches_jax(jax_run, rung, tmp_path, monkeypatch):
    text, js, jstart, jdts, jtables = jax_run
    monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "1" if rung == "stage"
                       else "0")
    ts = SmrSimulation(ParameterInput.from_string(text), quiet=True,
                       device="cpu")
    assert ts.adaptive and ts._split_loop()
    assert ts._stepper_now()._stage_rung == (rung == "stage")
    assert _table(ts.driver.smesh) == jstart == {0: 56, 1: 64}
    dts, tables = _cycles(ts, tmp_path)
    assert ts.ncycle == js.ncycle == NLIM
    assert tables == jtables
    assert tables[-1] != jstart, "no remesh changed the leaves"
    np.testing.assert_allclose(dts, jdts, rtol=TOL)
    for k in ("levels", "lx1", "lx2", "lx3"):
        np.testing.assert_array_equal(getattr(ts.driver.smesh, k),
                                      getattr(js.driver.smesh, k))
    assert sorted(ts.state) == sorted(js.state)
    for lev, u in js.state.items():
        assert _rel_per_var(ts.state[lev].numpy(), np.asarray(u)) <= TOL, lev
