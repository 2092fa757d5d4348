"""The port's refined ``SmrSimulation`` on one card, on a static mesh, as a
cell drives it (the names are ``uniform.py``'s).

The state is ``SmrSimulation.state``, ``{level: [nb, nvar, NZ, NY, NX]}``,
which every cycle replaces; ``state`` and the probe hand the harness its
tensors as a tuple in level order, the same tensors, so nothing is copied
or allocated for them inside the window.  The probe wraps the stepper's ``step``, which
both refined loops call once a cycle with the cycle's state: the split loop
(``SmrSimulation._run_split``, taken by a deck with a split source or a dt
hook, the cluster's) computes the dt first and applies the first-order
source after ``step``; a Strang source or RKL2 would change the state
before it, so such a deck is refused.  An adaptive deck is refused too: a
remesh changes the leaf table inside the window, which the probe's buffers
cannot hold.
"""

from __future__ import annotations

import torch

from benchmark.harness.trace import FIRST_ORDER

CHIPS = 1


def build(deck, device):
    from athenapk_tpu_torch.amr.driver import SmrSimulation
    from athenapk_tpu_torch.config.parameter_input import ParameterInput
    pin = ParameterInput.from_string(deck)
    mode = pin.get_string("parthenon/mesh", "refinement")
    if mode != "static":
        raise ValueError(f"the refined program takes a static mesh, not "
                         f"refinement = {mode}: a remesh inside the window "
                         "changes the leaf table")
    sim = SmrSimulation(pin, quiet=True, device=device)
    st = sim.stepper
    if st.sts or st.problem_source_strang is not None:
        raise ValueError("the refined program probes the state entering "
                         "the stepper's step: RKL2 or a Strang source "
                         "changes the cycle's state before it")
    return sim


def levels(state):
    """The level tensors of ``{level: tensor}``, in level order."""
    return tuple(state[lev] for lev in sorted(state))


def state(sim):
    return levels(sim.state)


def run_more(sim, ncycles):
    sim.nlim = sim.ncycle + ncycles
    sim.run()


def install_probe(sim, before):
    """Wrap ``SmrHydro.step`` (the instance's)."""
    inner = sim.stepper.step

    def step(state, dt, c_h, t=0.0):
        before(sim.ncycle, levels(state), dt, c_h, t)
        return inner(state, dt, c_h, t)
    sim.stepper.step = step


def install_ranges(sim):
    """A range around the first-order split source, as ``uniform.py``
    puts one around ``Simulation.src_first_order``."""
    st = sim.stepper
    inner = st.problem_source_first_order
    if inner is None:
        return

    def ranged(*a, **k):
        with torch.profiler.record_function(FIRST_ORDER):
            return inner(*a, **k)
    st.problem_source_first_order = ranged


def check_window(sim, last):
    if not sim.t < sim.tlim or sim.ncycle != last:
        raise RuntimeError(f"the window ended at cycle {sim.ncycle} (t = "
                           f"{sim.t}, tlim {sim.tlim}), not at cycle {last}")


def zones(sim):
    """The leaves' cells (ghosts left out)."""
    b = sim.smesh.base
    leaves = sum(ids.size for ids in sim.smesh.level_ids.values())
    return leaves * b.mbnx1 * b.mbnx2 * b.mbnx3


def layout(sim):
    u = state(sim)
    nbs = [x.shape[0] for x in u]
    st = sim.stepper
    return dict(shape=(sum(nbs),) + tuple(u[0].shape[1:]),
                itemsize=u[0].element_size(), fluid=sim.cfg.fluid,
                nscalars=sim.cfg.nscalars, levels=nbs,
                stage_prim=st._stage_rung and st._need_prim(),
                stage_faces=True)
