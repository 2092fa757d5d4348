"""Port parity: the adaptive refined-mesh slice in 2-D, Euler and GLM-MHD,
``amr.driver.SmrSimulation`` against the JAX package's on the CPU in f64.

The deck is ``torch_decks.ADAPTIVE_2D`` (a 2-D blast on a 64^2 base with
16^2 blocks, PLM + HLLC, pressure gradient at 0.3, ``derefine_count = 1``),
and the same deck as GLM-MHD (HLLD, uniform Bx = 0.5, so the GLM speed
follows the finest level present).  As in ``test_torch_amr_driver.py``:
8 cycles in lockstep from the JAX package's noised initial state; after
every cycle the leaf tables are equal and the states, the time and the
step agree to 1e-12 relative; the run refines and derefines.
"""

import numpy as np
import pytest
import torch

from athenapk_tpu.amr.driver import SmrSimulation as JSim
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from test_torch_amr_driver import lockstep
from torch_decks import ADAPTIVE_2D, ADAPTIVE_2D_MHD

torch.set_num_threads(2)

DECK = ADAPTIVE_2D.format(n=64, mb=16, nlim=8, precision="double")
OVERRIDES = {"euler": ["parthenon/mesh/derefine_count=1"],
             "glmmhd": ["parthenon/mesh/derefine_count=1"] + ADAPTIVE_2D_MHD}


@pytest.mark.parametrize("fluid", sorted(OVERRIDES))
def test_blast_2d_adaptive_matches_jax(fluid, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jsim = JSim(JPin.from_string(DECK, OVERRIDES[fluid]), quiet=True)
    tsim = SmrSimulation(ParameterInput.from_string(DECK, OVERRIDES[fluid]),
                         quiet=True, device="cpu")
    assert tsim.cfg.fluid == fluid
    assert {lev: v.shape[0] for lev, v in tsim.state.items()} == {0: 4, 1: 48}
    assert lockstep(jsim, tsim, 8, seed=1) == {"refine", "derefine"}
    log = tsim.driver.remesh_log
    assert sum(e["new_topology"] for e in log) >= 2
    assert all(bool(torch.isfinite(v).all()) for v in tsim.state.values())
    assert np.isfinite(tsim.total_mass())
