"""The plain driver of the galaxy cluster: ``driver.PlainSim`` with what
the wave's plain stage (``solver/hydro.py``) leaves out, tabular cooling.

A frozen copy of what the port's uniform ``Simulation`` and
``HydroPackage`` do per cycle on a cooling deck: per stage, cons_to_prim ->
-div(F) -> the 2S update -> the Dedner source -> the cooling over beta dt
-> the unsplit problem source -> the ghost fill; then the first-order
split source and its fill; the next dt is the least of the hyperbolic CFL
bound, the cooling's dt, ``max_dt`` and the problem's cap.  The cooling is
built as the port's ``driver.make_cooling`` builds it, from ``<units>``
and ``hydro/He_mass_fraction``.

-div(F) is taken a direction at a time in slabs of ``SLAB`` planes across
an axis the direction does not sweep (``negdiv_in_slabs``): each cell's
operations are the plain ``negdiv``'s, in its order, but the flux
temporaries of one slab, not of the whole mesh, are alive at a time (a
count at 64^3 on the CPU found some 25 states alive at once without the
slabs: ~68 GB at 320^3).

``wide`` (a dtype, for the control): the cooling, its dt and the split
source run on the state cast to ``wide`` and cast back, for constants that
the state's dtype cannot hold (the cluster units' cooling coefficient,
~1e142, and stellar feedback's number-density threshold, ~1e72, are
outside float32).
"""

from __future__ import annotations

import math

import torch

from .config.parameter_input import ParameterInput
from .core.indices import AXIS_Y, AXIS_Z, GLMMHD
from .driver import DTYPES, PlainSim, merged_mesh
from .eos.adiabatic import EOS
from .solver.hydro import (AXIS_OF_DIR, HydroConfig, PlainHydro, active_dirs,
                           directional_flux, raw_cfl_dt)
from .srcterms.tabular_cooling import TabularCooling
from .utils.units import Units, mean_molecular_weights

# the planes of a slab of ``negdiv_in_slabs``
SLAB = 16


def negdiv_in_slabs(prim, c_h, mesh, cfg, eos, recon):
    """``solver.hydro.negdiv``, each direction's flux and its difference
    taken over slabs of ``SLAB`` planes across z (across y for the z
    direction) and joined: the same operations on each cell, in the same
    order (x, then y, then z)."""
    div = None
    for d in active_dirs(mesh):
        ax = AXIS_OF_DIR[d]
        cut = AXIS_Y if ax == AXIS_Z else AXIS_Z
        dx = mesh.dx[d - 1]
        parts = []
        for q in torch.split(prim, SLAB, dim=cut):
            F = directional_flux(q, c_h, d, dx, cfg, eos, recon)
            parts.append((torch.roll(F, -1, dims=ax) - F) / dx)
            del F
        dF = torch.cat(parts, dim=cut)
        del parts
        div = dF if div is None else div + dF
        del dF
    return -div


def hydro_config(pin):
    """The deck's ``HydroConfig``: ``HydroConfig.from_parameter_input``
    with a cooling deck let through (the options the plain stage does not
    cover are still refused)."""
    h = "hydro"
    if pin.get_or_add_string(h, "glmmhd_source", "dedner_plain") \
            != "dedner_plain" \
            or pin.get_or_add_bool(h, "first_order_flux_correct", False) \
            or pin.get_string(h, "riemann") == "none" \
            or pin.has_block("diffusion"):
        raise ValueError("the plain reference covers the Dedner plain "
                         "source without FOFC, diffusion or the null solver")
    return HydroConfig(
        fluid=pin.get_or_add_string(h, "fluid", "euler"),
        reconstruction=pin.get_string(h, "reconstruction"),
        riemann=pin.get_string(h, "riemann"),
        integrator=pin.get_string("parthenon/time", "integrator"),
        cfl=pin.get_real("parthenon/time", "cfl"),
        nscalars=pin.get_or_add_integer(h, "nscalars", 0),
        glmmhd_source="dedner_plain",
        glmmhd_alpha=pin.get_or_add_real(h, "glmmhd_alpha", 0.1),
        max_dt=pin.get_or_add_real(h, "max_dt", -1.0))


def make_cooling(pin):
    """The deck's ``TabularCooling`` (``<cooling> enable_cooling =
    tabular``), or None."""
    if pin.get_or_add_string("cooling", "enable_cooling", "none") \
            != "tabular":
        return None
    units = Units(pin)
    he_x = pin.get_real("hydro", "He_mass_fraction")
    mu, _ = mean_molecular_weights(he_x)
    mbar_over_kb = mu * units.mh() / units.k_boltzmann()
    return TabularCooling(pin, units, pin.get_real("hydro", "gamma"), mu,
                          he_x, mbar_over_kb)


class CoolingHydro(PlainHydro):
    """``PlainHydro`` with the cooling in each stage and in the dt."""

    def __init__(self, mesh, cfg, eos, cooling, problem_source_unsplit=None,
                 wide=None):
        super().__init__(mesh, cfg, eos,
                         problem_source_unsplit=problem_source_unsplit)
        self.cooling = cooling
        self.wide = wide

    def _widened(self, x):
        return x if self.wide is None else x.to(self.wide)

    def _stage_update(self, u0, u1, prim, gam0, gam1, beta_dt, c_h, recon,
                      t):
        nd = negdiv_in_slabs(prim, c_h, self.mesh, self.cfg, self.eos, recon)
        u_new = gam0 * u0 + gam1 * u1 + beta_dt * nd
        del nd
        if self.cfg.fluid == GLMMHD:
            u_new = self._dedner_source(u_new, beta_dt, c_h)
        if self.cooling is not None:
            u_new = self.cooling.apply(self._widened(u_new), beta_dt,
                                       self.cfg.fluid).to(u_new.dtype)
        if self.problem_source_unsplit is not None:
            u_new = self.problem_source_unsplit(u_new, prim, self.mesh,
                                                beta_dt, t)
        return self.apply_boundaries(u_new)

    def dt_limits(self, prim):
        """``{"hyp", "cool"}``: the hyperbolic CFL bound and the cooling's
        dt (inf without cooling), as floats."""
        w = prim[self.mesh.interior_slices]
        out = {"hyp": self.cfg.cfl * float(torch.min(raw_cfl_dt(
            w, self.mesh, self.cfg, self.eos, active_dirs(self.mesh)))),
            "cool": math.inf}
        if self.cooling is not None:
            out["cool"] = float(self.cooling.estimate_timestep(
                self._widened(prim), self.mesh))
        return out

    def estimate_timestep(self, prim, dt_cap=math.inf):
        """``(dt, dt_hyp)``: the hyperbolic CFL bound, the cooling's dt,
        the max_dt cap and ``dt_cap``, as floats."""
        lim = self.dt_limits(prim)
        dt = min(lim["hyp"], lim["cool"])
        if self.cfg.max_dt > 0.0:
            dt = min(dt, self.cfg.max_dt)
        return min(dt, float(dt_cap)), lim["hyp"]


class PlainClusterSim(PlainSim):
    """``deck`` on ``device`` in ``dtype`` (the deck's precision by
    default), with the cooling and the source and dt hooks of
    ``problem``; ``wide``: see the module's docstring."""

    def __init__(self, deck, problem, device, dtype=None, wide=None):
        self.pin = pin = ParameterInput.from_string(deck)
        self.problem = problem
        self.device = torch.device(device)
        self.dtype = dtype or DTYPES[pin.get_or_add_string(
            "hydro", "precision", "double")]
        problem.init_user_mesh_data(pin)
        self.mesh = merged_mesh(pin, problem)
        self.cfg = hydro_config(pin)
        self.eos = EOS.from_parameter_input(pin)
        hooks = {name: getattr(problem, name)(pin, self.mesh, self.cfg,
                                              self.eos)
                 for name in ("problem_source_first_order",
                              "estimate_timestep_factory",
                              "problem_source_unsplit")}
        first_order = hooks["problem_source_first_order"]
        if first_order is not None and wide is not None:
            def first_order(u, dt, t, inner=first_order):
                return inner(u.to(wide), dt, t).to(u.dtype)
        self.src_first_order = first_order
        self._pe_fn = hooks["estimate_timestep_factory"]
        self.hydro = CoolingHydro(self.mesh, self.cfg, self.eos,
                                  make_cooling(pin),
                                  hooks["problem_source_unsplit"], wide)

    def dt_limits(self, u, t):
        """The dt limits of the state ``u`` at time ``t``, as floats: the
        hyperbolic CFL bound, the cooling's dt and the problem's cap
        (``acc``, the accretion dt)."""
        _, prim = self.hydro.cons_to_prim(u)
        out = self.hydro.dt_limits(prim)
        out["acc"] = (math.inf if self._pe_fn is None
                      else float(self._pe_fn(prim, t)))
        return out
