"""The Hydro package: flux sweeps, stage updates, timestep, full cycle step.

Counterpart of ``athenapk_tpu/solver/hydro_pkg.py`` (reference
``src/hydro/hydro.cpp`` ``Hydro::Initialize``/``CalculateFluxes`` and
``src/hydro/hydro_driver.cpp`` ``HydroDriver::MakeTaskCollection``).  Runs
eagerly: a stage is straight-line tensor code, ``advance_cycles`` a Python
loop.  Each stage's -div(F) goes through ``sweep.fused_negdiv`` (the CUDA
kernel on the card, its plain twin on the CPU).

State layout: conserved ``u`` is ``[nblocks, nvar, NZ, NY, NX]`` (ghost-
inclusive); fluxes are co-indexed with cells (index i = face i-1/2).

Not ported yet (the constructor raises ``NotImplementedError``):
diffusion (and with it ``riemann = none``), cooling, problem source terms,
first-order flux correction, weno3/limo3/wenoz.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..core.boundaries import check_reflecting_mhd, make_boundary_fn
from ..core.indices import (IDN, IPR, IPS, IB1, IB2, IB3, IM1, IM2, IM3, IEN,
                            EULER, GLMMHD, nvar_for_fluid)
from ..core.mesh import Mesh
from ..eos.adiabatic import EOS, cons_to_prim, fast_magnetosonic_speed
from ..recon import RECONSTRUCTIONS, nghost_for
from . import sweep
from .integrators import INTEGRATORS
from .sweep import AXIS_OF_DIR, active_dirs


@dataclasses.dataclass(frozen=True)
class HydroConfig:
    """Static solver configuration (the reference's <hydro> + <parthenon/time>
    options, ``src/hydro/hydro.cpp:264-470``)."""

    fluid: str = EULER                # euler | glmmhd
    reconstruction: str = "plm"       # dc | plm | ppm (weno3/limo3/wenoz: not ported)
    riemann: str = "hlle"             # llf | hlle | hllc | hlld | none
    integrator: str = "vl2"           # rk1 | rk2 | rk3 | vl2
    cfl: float = 0.3
    nscalars: int = 0
    glmmhd_source: str = "dedner_plain"   # dedner_plain | dedner_extended
    glmmhd_alpha: float = 0.1
    calc_dt_hyp: bool = True
    max_dt: float = -1.0
    first_order_flux_correct: bool = False

    @property
    def nvar(self) -> int:
        return nvar_for_fluid(self.fluid, self.nscalars)

    @classmethod
    def from_parameter_input(cls, pin) -> "HydroConfig":
        h = "hydro"
        fluid = pin.get_or_add_string(h, "fluid", EULER)
        if fluid not in (EULER, GLMMHD):
            raise ValueError(f"unknown fluid '{fluid}'")
        eos_str = pin.get_or_add_string(h, "eos", "adiabatic")
        if eos_str != "adiabatic":
            raise ValueError(f"unsupported <hydro> eos '{eos_str}' "
                             "(only 'adiabatic', as the reference)")
        riemann = pin.get_string(h, "riemann")
        # 'none' disables hyperbolic fluxes (and their dt constraint);
        # explicit hydro/calc_dt_hyp takes precedence (hydro.cpp:355-374)
        calc_dt_hyp = riemann != "none"
        if pin.has(h, "calc_dt_hyp"):
            calc_dt_hyp = pin.get_bool(h, "calc_dt_hyp")
        if riemann == "none" and pin.get_string(h, "reconstruction") != "dc":
            raise ValueError("riemann 'none' requires dc reconstruction")
        return cls(
            calc_dt_hyp=calc_dt_hyp,
            fluid=fluid,
            reconstruction=pin.get_string(h, "reconstruction"),
            riemann=riemann,
            integrator=pin.get_string("parthenon/time", "integrator"),
            cfl=pin.get_real("parthenon/time", "cfl"),
            nscalars=pin.get_or_add_integer(h, "nscalars", 0),
            glmmhd_source=pin.get_or_add_string(h, "glmmhd_source",
                                                "dedner_plain"),
            glmmhd_alpha=pin.get_or_add_real(h, "glmmhd_alpha", 0.1),
            max_dt=pin.get_or_add_real(h, "max_dt", -1.0),
            first_order_flux_correct=pin.get_or_add_bool(
                h, "first_order_flux_correct", False),
        )


class HydroPackage:
    """Bundles mesh + config + EOS into the stage, step and dt functions.

    The JAX package pairs each function with its jitted wrapper (``_step``
    and ``step``, ``_step_with_dt`` and ``step_with_dt``, ...); eager
    PyTorch needs one method each: ``step``, ``step_with_dt``,
    ``estimate_timestep``, ``cons_to_prim`` and ``advance_cycles``."""

    def __init__(self, mesh: Mesh, cfg: HydroConfig, eos: EOS,
                 problem_source_unsplit: Optional[Callable] = None,
                 diffusion=None, cooling=None):
        missing = [name for name, value in (
            ("diffusion", diffusion), ("cooling", cooling),
            ("problem source terms", problem_source_unsplit)) if value]
        if cfg.first_order_flux_correct:
            missing.append("first_order_flux_correct")
        if cfg.reconstruction not in RECONSTRUCTIONS:
            missing.append(f"reconstruction '{cfg.reconstruction}'")
        if cfg.riemann == "none":
            missing.append("riemann 'none' (diffusion-only runs)")
        if missing:
            raise NotImplementedError(
                f"not ported to athenapk_tpu_torch yet: {', '.join(missing)}")
        self.mesh = mesh
        self.cfg = cfg
        self.eos = eos
        self.apply_boundaries = make_boundary_fn(mesh)

        check_reflecting_mhd(mesh, cfg.fluid)
        if cfg.fluid == GLMMHD and cfg.riemann == "hllc":
            raise ValueError("hllc is a hydro-only Riemann solver")
        if cfg.fluid == EULER and cfg.riemann == "hlld":
            raise ValueError("hlld is an MHD-only Riemann solver")
        need = nghost_for(cfg.reconstruction)
        # nghost=0 is the ghost-free periodic layout: cyclic rolls give
        # every cell a full-width stencil, so no ghost-depth requirement.
        if mesh.nghost != 0 and mesh.nghost < need:
            raise ValueError(
                f"reconstruction '{cfg.reconstruction}' needs nghost >= "
                f"{need}, got {mesh.nghost} (set parthenon/mesh/nghost)")
        self._active_dirs = active_dirs(mesh)

    # ------------------------------------------------------------------ prim
    def cons_to_prim(self, u):
        return cons_to_prim(self.eos, u, self.cfg.fluid, self.cfg.nscalars)

    # ----------------------------------------------------------------- fluxes
    def _compute_fluxes(self, prim, c_h, recon: str):
        """``sweep.compute_fluxes`` (the plain path's first half)."""
        return sweep.compute_fluxes(prim, c_h, self.mesh, self.cfg, self.eos,
                                    recon)

    def _flux_divergence(self, fluxes):
        """``sweep.flux_divergence`` (the plain path's second half)."""
        return sweep.flux_divergence(fluxes, self.mesh)

    # ---------------------------------------------------------------- sources
    def _dedner_source(self, u, prim, beta_dt, c_h):
        """Dedner psi damping (+ optional extended divB terms);
        ``src/hydro/glmmhd/dedner_source.cpp:17-79`` (Mignone & Tzeferacos
        2010 eq 27).  Updates ``u`` in place (the caller hands over the
        fresh stage result, saving a copy of the state) and returns it."""
        cfg = self.cfg
        mesh = self.mesh
        coeff = math.exp(-cfg.glmmhd_alpha * c_h * beta_dt / mesh.min_dx)
        if cfg.glmmhd_source == "dedner_extended":
            def cdiff(q, d):
                # q is a per-variable 4-D [nb, z, y, x] slice: shift the
                # 5-D axis map down by the dropped var axis
                ax = AXIS_OF_DIR[d] - 1
                return (torch.roll(q, -1, dims=ax)
                        - torch.roll(q, 1, dims=ax)) / (2.0 * mesh.dx[d - 1])

            b1 = prim[:, IB1]
            b2 = prim[:, IB2]
            b3 = prim[:, IB3]
            psi = prim[:, IPS]
            divB = cdiff(b1, 1)
            psi_gradB = b1 * cdiff(psi, 1)
            if mesh.nx2 > 1:
                divB = divB + cdiff(b2, 2)
                psi_gradB = psi_gradB + b2 * cdiff(psi, 2)
            if mesh.nx3 > 1:
                divB = divB + cdiff(b3, 3)
                psi_gradB = psi_gradB + b3 * cdiff(psi, 3)
            u[:, IM1] += -beta_dt * divB * b1
            u[:, IM2] += -beta_dt * divB * b2
            u[:, IM3] += -beta_dt * divB * b3
            u[:, IEN] += -beta_dt * psi_gradB
        u[:, IPS] *= coeff
        return u

    # ------------------------------------------------------------------ step
    def _stage_update(self, u0, u1, prim, gam0, gam1, beta_dt, c_h,
                      recon: str):
        """One 2S stage: -div(F) -> update -> Dedner source -> ghosts
        (the per-stage task chain of ``MakeTaskCollection``,
        ``src/hydro/hydro_driver.cpp:499-577``)."""
        negdiv = sweep.fused_negdiv(prim, c_h, self.mesh, self.cfg, self.eos,
                                    recon)
        u_new = gam0 * u0 + gam1 * u1 + beta_dt * negdiv
        if self.cfg.fluid == GLMMHD:
            u_new = self._dedner_source(u_new, prim, beta_dt, c_h)
        return self.apply_boundaries(u_new)

    def step(self, u, dt, c_h):
        """Advance one full cycle (all integrator stages); ``u`` enters
        ghost-filled and ``u(t+dt)`` leaves ghost-filled."""
        cfg = self.cfg
        tab = INTEGRATORS[cfg.integrator]
        u0 = u
        u1 = u
        for s in range(tab["nstages"]):
            recon = cfg.reconstruction
            if cfg.integrator == "vl2" and s == 0:
                recon = "dc"   # first-order predictor (hydro.cpp:459-464)
            u0f, prim = self.cons_to_prim(u0)
            u0 = self._stage_update(u0f, u1, prim, tab["gam0"][s],
                                    tab["gam1"][s], tab["beta"][s] * dt, c_h,
                                    recon)
        return u0

    def step_with_dt(self, u, dt, c_h):
        """One cycle + the next dt estimate: ``(u', (dt, dt_hyp, dt_diff))``."""
        u_new = self.step(u, dt, c_h)
        _, prim = self.cons_to_prim(u_new)
        return u_new, self.estimate_timestep(prim)

    def advance_cycles(self, u, t, dt, dt_hyp, tlim, n_cycles):
        """Run up to ``n_cycles`` cycles: per-cycle dt from the estimate
        (2x growth cap, tlim clamp), c_h from the previous hyperbolic dt.
        Returns ``(u', t', dt_next, dt_hyp', n_taken)``; cycles past tlim
        are not taken."""
        taken = 0
        for _ in range(n_cycles):
            if not t < tlim * (1.0 - 1e-14):
                break
            dt_eff = min(dt, tlim - t)
            u, (dt_next, dt_hyp_new, _) = self.step_with_dt(
                u, dt_eff, self.c_h_from_dt_hyp(dt_hyp))
            t = t + dt_eff
            dt = min(2.0 * dt_eff, float(dt_next))
            dt_hyp = float(dt_hyp_new)
            taken += 1
        return u, t, dt, dt_hyp, taken

    # ------------------------------------------------------------------- dt
    def estimate_timestep(self, prim):
        """Hyperbolic CFL timestep (``EstimateTimestep``,
        ``src/hydro/hydro.cpp:914-976``) with the max_dt cap.  Returns
        ``(dt_full, dt_hyp, dt_diff)`` as floats; dt_diff is inf (no
        diffusion in this port yet)."""
        cfg = self.cfg
        mesh = self.mesh
        eos = self.eos
        w = prim[mesh.interior_slices]
        rho = w[:, IDN]
        p = w[:, IPR]
        if cfg.fluid == EULER:
            c = torch.sqrt(eos.gamma * p / rho)
            lam = (c, c, c)
        else:
            b1, b2, b3 = w[:, IB1], w[:, IB2], w[:, IB3]
            lam = (fast_magnetosonic_speed(eos, rho, p, b1, b2, b3),
                   fast_magnetosonic_speed(eos, rho, p, b2, b3, b1),
                   fast_magnetosonic_speed(eos, rho, p, b3, b1, b2))
        mins = torch.stack([
            torch.min(mesh.dx[d - 1] / (torch.abs(w[:, d]) + lam[d - 1]))
            for d in self._active_dirs])
        dt_hyp = cfg.cfl * float(torch.min(mins))
        dt = dt_hyp if cfg.calc_dt_hyp else math.inf
        if cfg.max_dt > 0.0:
            dt = min(dt, cfg.max_dt)
        return dt, dt_hyp, math.inf

    # ------------------------------------------------------------------ misc
    def c_h_from_dt_hyp(self, dt_hyp):
        """Divergence-cleaning speed c_h = cfl * min_dx / dt_hyp
        (``PreStepMeshUserWorkInLoop``, ``src/hydro/hydro.cpp:102-143``)."""
        if self.cfg.fluid != GLMMHD:
            return 0.0
        return self.cfg.cfl * self.mesh.min_dx / dt_hyp
