"""The plain driver: one deck's mesh, initial state, dt estimate and cycle.

A frozen copy of what the port's uniform ``Simulation`` does per cycle
(``driver.py``): c_h from the previous hyperbolic dt, the hydro step, the
first-order split source and its ghost fill, and the next dt (the problem's
cap, the CFL bound), with the port's block merge (an all-periodic
mesh without a boundary hook becomes one ghost-free block; any other
uniform mesh one ghosted block).  ``problem`` is a module with
``problem_generator`` and the optional hooks ``init_user_mesh_data``,
``needs_ghosts_at_init``, ``problem_source_unsplit``,
``problem_source_first_order`` and ``estimate_timestep_factory``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .config.parameter_input import ParameterInput
from .core.mesh import Mesh
from .eos.adiabatic import EOS
from .solver.hydro import HydroConfig, PlainHydro

DTYPES = {"double": torch.float64, "single": torch.float32}


def merged_mesh(pin, problem):
    """The one-block layout the port runs a uniform deck in."""
    mesh = Mesh.from_parameter_input(pin)
    merged = dataclasses.replace(mesh, mbnx1=mesh.nx1, mbnx2=mesh.nx2,
                                 mbnx3=mesh.nx3)
    bcs = {merged.ix1_bc, merged.ox1_bc, merged.ix2_bc, merged.ox2_bc,
           merged.ix3_bc, merged.ox3_bc}
    keep = getattr(problem, "needs_ghosts_at_init", None)
    if bcs == {"periodic"} and not (keep is not None and keep(pin)) \
            and merged.nghost > 0:
        merged = dataclasses.replace(merged, nghost=0)
    return merged


class PlainSim:
    """``deck`` (the text of an input deck) on ``device`` in ``dtype``."""

    def __init__(self, deck, problem, device, dtype=None):
        self.pin = pin = ParameterInput.from_string(deck)
        self.problem = problem
        self.device = torch.device(device)
        self.dtype = dtype or DTYPES[pin.get_or_add_string(
            "hydro", "precision", "double")]
        hook = getattr(problem, "init_user_mesh_data", None)
        if hook is not None:
            hook(pin)
        self.mesh = merged_mesh(pin, problem)
        self.cfg = HydroConfig.from_parameter_input(pin)
        self.eos = EOS.from_parameter_input(pin)

        def factory(name):
            f = getattr(problem, name, None)
            return f(pin, self.mesh, self.cfg, self.eos) if f else None

        self.src_first_order = factory("problem_source_first_order")
        self._pe_fn = factory("estimate_timestep_factory")
        self.hydro = PlainHydro(self.mesh, self.cfg, self.eos,
                                problem_source_unsplit=factory(
                                    "problem_source_unsplit"))

    @property
    def cells(self):
        return self.mesh.nx1 * self.mesh.nx2 * self.mesh.nx3

    def initial_state(self):
        """The ghost-filled initial state (on the device, in the dtype)."""
        u = torch.as_tensor(self.problem.problem_generator(
            self.pin, self.mesh, self.cfg, self.eos), dtype=self.dtype,
            device=self.device)
        return self.hydro.apply_boundaries(u)

    def estimate(self, u, t):
        """``(dt, dt_hyp)`` of the state ``u`` at time ``t``."""
        _, prim = self.hydro.cons_to_prim(u)
        cap = math.inf if self._pe_fn is None else self._pe_fn(prim, t)
        return self.hydro.estimate_timestep(prim, cap)

    def next_dt(self, u, t, dt_prev):
        """The dt and c_h of the cycle that starts from ``u``: the estimate
        capped at twice the previous cycle's dt (``None``: the first cycle
        of a run), and c_h from its hyperbolic dt."""
        dt, dt_hyp = self.estimate(u, t)
        if dt_prev is not None:
            dt = min(2.0 * dt_prev, dt)
        return dt, self.hydro.c_h_from_dt_hyp(dt_hyp)

    def cycle(self, u, dt, c_h, t):
        """One cycle from ``u``: the hydro step, then the first-order split
        source and its ghost fill."""
        u = self.hydro.step(u, dt, c_h, t)
        if self.src_first_order is not None:
            u = self.hydro.apply_boundaries(self.src_first_order(u, dt, t))
        return u

