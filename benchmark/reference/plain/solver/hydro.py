"""The plain stage, cycle and dt of the hydro package (a frozen copy of the
port's whole-tensor path: ``solver/hydro_pkg.py``, ``solver/sweep.py``'s
plain functions and ``solver/stage.py``'s CFL bound), without the CUDA
kernels, the whole-stage rungs, FOFC, diffusion and cooling, which no
benchmark configuration runs.

Per stage: cons_to_prim (floors) -> -div(F) (reconstruction, Riemann
solve, flux divergence, every direction as whole-tensor operations) ->
the 2S update -> the Dedner source -> the unsplit problem source -> the
ghost fill; the operation order is the port's, so the
result differs from the port's kernels by rounding alone.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..core.boundaries import make_boundary_fn
from ..core.indices import (AXIS_X, AXIS_Y, AXIS_Z, EULER, GLMMHD, IB1, IB2,
                            IB3, IDN, IPR, IPS, nvar_for_fluid)
from ..eos.adiabatic import (EOS, cons_to_prim, fast_magnetosonic_speed,
                             sound_speed)
from ..recon.schemes import positivity_mask, reconstruct
from ..riemann.solvers import solve_riemann
from .integrators import INTEGRATORS

AXIS_OF_DIR = {1: AXIS_X, 2: AXIS_Y, 3: AXIS_Z}


def active_dirs(mesh):
    dirs = [1]
    if mesh.nx2 > 1:
        dirs.append(2)
    if mesh.nx3 > 1:
        dirs.append(3)
    return dirs


def interior_mask(block_shape, interior_slices, device):
    """bool [1, 1, NZ, NY, NX]: the interior cells of a block."""
    m = torch.zeros(tuple(block_shape), dtype=torch.bool, device=device)
    m[tuple(interior_slices[2:])] = True
    return m[None, None]


def directional_flux(prim, c_h, d, dx, cfg, eos, recon):
    """Flux tensor of direction ``d``, co-indexed faces (index i = face
    i-1/2): ``wl = qp[i-1]``, ``wr = qm[i]``."""
    axis = AXIS_OF_DIR[d]
    qm, qp = reconstruct(recon, prim, axis, dx,
                         positivity_mask=positivity_mask(cfg.nvar))
    wl = torch.roll(qp, 1, dims=axis)
    return solve_riemann(cfg.riemann, cfg.fluid, eos, wl, qm, d,
                         c_h=c_h, nscalars=cfg.nscalars)


def negdiv(prim, c_h, mesh, cfg, eos, recon):
    """-div(F) summed over the active directions, one direction's fluxes
    alive at a time (the sum's order is the port's: x, then y, then z)."""
    div = None
    for d in active_dirs(mesh):
        F = directional_flux(prim, c_h, d, mesh.dx[d - 1], cfg, eos, recon)
        dF = (torch.roll(F, -1, dims=AXIS_OF_DIR[d]) - F) / mesh.dx[d - 1]
        del F
        div = dF if div is None else div + dF
    return -div


def raw_cfl_dt(prim, mesh, cfg, eos, dirs=(1, 2, 3)):
    """Per cell, ``min_d dx_d / (|v_d| + lam_d)``."""
    rho, p = prim[:, IDN], prim[:, IPR]
    if cfg.fluid == EULER:
        cs = sound_speed(eos, rho, p)
        lam = (cs, cs, cs)
    else:
        b1, b2, b3 = prim[:, IB1], prim[:, IB2], prim[:, IB3]
        lam = (fast_magnetosonic_speed(eos, rho, p, b1, b2, b3),
               fast_magnetosonic_speed(eos, rho, p, b2, b3, b1),
               fast_magnetosonic_speed(eos, rho, p, b3, b1, b2))
    m = None
    for d in dirs:
        t = mesh.dx[d - 1] / (torch.abs(prim[:, d]) + lam[d - 1])
        m = t if m is None else torch.minimum(m, t)
    return m


@dataclasses.dataclass(frozen=True)
class HydroConfig:
    """The deck's <hydro> and <parthenon/time> solver options."""

    fluid: str = EULER
    reconstruction: str = "plm"
    riemann: str = "hlle"
    integrator: str = "vl2"
    cfl: float = 0.3
    nscalars: int = 0
    glmmhd_source: str = "dedner_plain"
    glmmhd_alpha: float = 0.1
    max_dt: float = -1.0

    @property
    def nvar(self) -> int:
        return nvar_for_fluid(self.fluid, self.nscalars)

    @classmethod
    def from_parameter_input(cls, pin) -> "HydroConfig":
        h = "hydro"
        cfg = cls(
            fluid=pin.get_or_add_string(h, "fluid", EULER),
            reconstruction=pin.get_string(h, "reconstruction"),
            riemann=pin.get_string(h, "riemann"),
            integrator=pin.get_string("parthenon/time", "integrator"),
            cfl=pin.get_real("parthenon/time", "cfl"),
            nscalars=pin.get_or_add_integer(h, "nscalars", 0),
            glmmhd_source=pin.get_or_add_string(h, "glmmhd_source",
                                                "dedner_plain"),
            glmmhd_alpha=pin.get_or_add_real(h, "glmmhd_alpha", 0.1),
            max_dt=pin.get_or_add_real(h, "max_dt", -1.0),
        )
        if cfg.glmmhd_source != "dedner_plain" \
                or pin.get_or_add_bool(h, "first_order_flux_correct", False) \
                or cfg.riemann == "none" or pin.has_block("diffusion") \
                or pin.get_or_add_string("cooling", "enable_cooling",
                                         "none") != "none":
            raise ValueError("the plain reference covers the Dedner plain "
                             "source without FOFC, diffusion, cooling or "
                             "the null solver")
        return cfg


class PlainHydro:
    """The cycle and the dt estimate of one uniform mesh."""

    def __init__(self, mesh, cfg: HydroConfig, eos: EOS,
                 problem_source_unsplit: Optional[Callable] = None):
        self.mesh = mesh
        self.cfg = cfg
        self.eos = eos
        self.problem_source_unsplit = problem_source_unsplit
        self.apply_boundaries = make_boundary_fn(mesh)

    def cons_to_prim(self, u):
        return cons_to_prim(self.eos, u, self.cfg.fluid, self.cfg.nscalars)

    def _dedner_source(self, u, beta_dt, c_h):
        coeff = math.exp(-self.cfg.glmmhd_alpha * c_h * beta_dt
                         / self.mesh.min_dx)
        u[:, IPS] *= coeff
        return u

    def _stage_update(self, u0, u1, prim, gam0, gam1, beta_dt, c_h, recon,
                      t):
        nd = negdiv(prim, c_h, self.mesh, self.cfg, self.eos, recon)
        u_new = gam0 * u0 + gam1 * u1 + beta_dt * nd
        del nd
        if self.cfg.fluid == GLMMHD:
            u_new = self._dedner_source(u_new, beta_dt, c_h)
        if self.problem_source_unsplit is not None:
            u_new = self.problem_source_unsplit(u_new, prim, self.mesh,
                                                beta_dt, t)
        return self.apply_boundaries(u_new)

    def step(self, u, dt, c_h, t=0.0):
        """One cycle (every integrator stage); ``u`` enters and leaves
        ghost-filled."""
        cfg = self.cfg
        tab = INTEGRATORS[cfg.integrator]
        u0 = u
        u1 = u
        for s in range(tab["nstages"]):
            recon = cfg.reconstruction
            if cfg.integrator == "vl2" and s == 0:
                recon = "dc"
            u0f, prim = self.cons_to_prim(u0)
            u0 = self._stage_update(u0f, u1, prim, tab["gam0"][s],
                                    tab["gam1"][s], tab["beta"][s] * dt,
                                    c_h, recon, t)
            del u0f, prim
        return u0

    def estimate_timestep(self, prim, dt_cap=math.inf):
        """``(dt, dt_hyp)``: the hyperbolic CFL bound, the max_dt cap and
        ``dt_cap``, as floats."""
        cfg = self.cfg
        w = prim[self.mesh.interior_slices]
        dt_hyp = cfg.cfl * float(torch.min(raw_cfl_dt(
            w, self.mesh, cfg, self.eos, active_dirs(self.mesh))))
        dt = dt_hyp
        if cfg.max_dt > 0.0:
            dt = min(dt, cfg.max_dt)
        return min(dt, float(dt_cap)), dt_hyp

    def c_h_from_dt_hyp(self, dt_hyp):
        if self.cfg.fluid != GLMMHD:
            return 0.0
        return self.cfg.cfl * self.mesh.min_dx / dt_hyp
