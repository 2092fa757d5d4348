"""The port's uniform ``Simulation`` on one card, as a cell drives it.

A configuration names the module that builds and drives its program
(``"program"`` in its file); this one serves every deck that the port's
``driver.Simulation`` runs on one uniform mesh; ``smr.py`` serves static
refined meshes, and a ranked program would be a module of its own beside
them.  Each has the same names:

* ``CHIPS``: the cards one run of the program uses;
* ``build(deck, device)``: the program, built through the CLI's own path
  (``ParameterInput`` -> ``Simulation``), with its initial state;
* ``state(sim)``: the state the cycles advance, one tensor or a tuple of
  tensors (a refined mesh's levels, in a fixed order), the program's own
  tensors: no concatenation, copy or allocation (the probe's copies are
  shaped from them);
* ``run_more(sim, ncycles)``: ``ncycles`` more cycles through the entry the
  window times, ending in a synchronise;
* ``install_probe(sim, before)``: call ``before(ncycle, u, dt, c_h, t)``
  before each cycle with the state entering it, in ``state``'s form and
  as cheaply (it runs inside the window);
* ``install_ranges(sim)``: the harness's own ranges for a traced run;
* ``check_window(sim, last)``: raise if the window did not end at cycle
  ``last``;
* ``zones(sim)``, ``layout(sim)``: the mesh's cells, and the state's layout
  for the roofline (``shape``, ``itemsize``, ``fluid``, ``nscalars``; on a
  refined mesh ``levels``, each level's block count, with ``shape`` over
  all of them; ``stage_prim`` and ``stage_faces`` where the stage kernel
  writes prim or the face slabs, ``harness/roofline.py``).
"""

from __future__ import annotations

import torch

from benchmark.harness.trace import FIRST_ORDER

CHIPS = 1


def build(deck, device):
    from athenapk_tpu_torch.config.parameter_input import ParameterInput
    from athenapk_tpu_torch.driver import Simulation
    return Simulation(ParameterInput.from_string(deck), quiet=True,
                      device=device)


def state(sim):
    return sim.u


def run_more(sim, ncycles):
    sim.nlim = sim.ncycle + ncycles
    sim.run()


def install_probe(sim, before):
    """Wrap the program's cycle call: ``HydroPackage.step_with_dt``, or
    ``Simulation._cycle`` on a deck with split sources."""
    if sim._split_cycle():
        inner = sim._cycle

        def cycle(dt_eff, c_h):
            before(sim.ncycle, sim.u, dt_eff, c_h, sim.t)
            return inner(dt_eff, c_h)
        sim._cycle = cycle
    else:
        inner = sim.pkg.step_with_dt

        def step_with_dt(u, dt, c_h, t=0.0):
            before(sim.ncycle, u, dt, c_h, t)
            return inner(u, dt, c_h, t)
        sim.pkg.step_with_dt = step_with_dt


def install_ranges(sim):
    """A range around the first-order split source, which the program
    leaves without one."""
    inner = sim.src_first_order
    if inner is None:
        return

    def ranged(*a, **k):
        with torch.profiler.record_function(FIRST_ORDER):
            return inner(*a, **k)
    sim.src_first_order = ranged


def check_window(sim, last):
    if not sim.t < sim.tlim or sim.ncycle != last:
        raise RuntimeError(f"the window ended at cycle {sim.ncycle} (t = "
                           f"{sim.t}, tlim {sim.tlim}), not at cycle {last}")


def zones(sim):
    return sim.mesh.nx1 * sim.mesh.nx2 * sim.mesh.nx3


def layout(sim):
    return dict(shape=tuple(sim.u.shape), itemsize=sim.u.element_size(),
                fluid=sim.cfg.fluid, nscalars=sim.cfg.nscalars)
