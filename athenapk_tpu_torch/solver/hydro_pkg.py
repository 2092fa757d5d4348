"""The Hydro package: flux sweeps, stage updates, timestep, full cycle step.

Counterpart of ``athenapk_tpu/solver/hydro_pkg.py`` (reference
``src/hydro/hydro.cpp`` ``Hydro::Initialize``/``CalculateFluxes`` and
``src/hydro/hydro_driver.cpp`` ``HydroDriver::MakeTaskCollection``).  Runs
eagerly: a stage is straight-line tensor code.  Each stage's -div(F) goes
through ``sweep.fused_negdiv`` and each conversion to prim through
``eos.adiabatic_cuda.fused_cons_to_prim`` (the CUDA kernels on the card,
their plain twins on the CPU).

One opt-in rung, read from the environment once, when the package is
built (the name is the JAX package's, so a reader finds the
counterpart): with ``ATHENAPK_PALLAS_STAGE=1`` every stage of a 3-D deck
is one call of ``stage.fused_stage`` (cons_to_prim + -div(F) + the stage
update; on the ghost-free layout the last stage also emits the CFL bound,
so no separate cons_to_prim or dt pass runs in a cycle).

The default is the sweep path.  A deck with ``first_order_flux_correct =
true`` always runs the sweep path, as in the JAX package: its rescue reads
the unfused prim, u0 and u1, so the rung does not apply (the package says
so once when ``ATHENAPK_PALLAS_STAGE=1`` is set).  Each stage of such a
deck reads one flag from the card: whether the sweep's candidate state
has an interior cell with rho <= 0 or p <= 0 (or NaN).  If it has, the
stage is recomputed with the plain fluxes, the first-order (DC + LLF) flux
correction and their divergence, as PyTorch operations on the card;
``fofc_rescues`` counts those stages.

State layout: conserved ``u`` is ``[nblocks, nvar, NZ, NY, NX]`` (ghost-
inclusive); fluxes are co-indexed with cells (index i = face i-1/2).

Tabular cooling (``cooling``, ``srcterms.TabularCooling``) acts after the
Dedner source of every stage, on either path, and its dt joins
``estimate_timestep``; a cooling deck does not take the dt-emitting stage
(the bound would miss the cooling dt), as in the JAX package.
Problem-registered boundary conditions (``custom_bcs``) go to the ghost
fill (``core.boundaries.make_boundary_fn``).

Diffusion (``diffusion``, ``diffusion.DiffusionConfig``): with
``integrator = unsplit`` each stage adds the diffusive -div(F_diff) of the
stage-start prim (plain PyTorch) to the kernel's -div(F) before the FOFC
check, Dedner, cooling and the unsplit source, in the JAX package's order
(``athenapk_tpu/solver/hydro_pkg.py:535-592``); on the stage rung that prim
comes from the kernel's ``emit_prim``.  The sum differs from the JAX
package's -div(F + F_diff) only by rounding (the JAX package sums the
fluxes first).  A FOFC rescue recomputes the stage from the plain fluxes
plus F_diff, as the JAX package does.  ``riemann = none`` launches no
kernel: its hyperbolic fluxes are zero (the null solver), so a stage is
the diffusive update alone, and the hyperbolic dt does not bind
(``calc_dt_hyp``).  With ``integrator = rkl2`` the stages have no
diffusion; the driver wraps each cycle in two RKL2 half super-steps
(``sts_half_step``: plain PyTorch over the whole state, one boundary fill
per stage; ``rkl2_stages`` counts the stages).  The dt terms are the JAX
package's: the strict minimum with the diffusive dt for unsplit, and for
rkl2 the cap at ``rkl2_max_dt_ratio * dt_diff``; every minimum of an
estimate reaches the host in one read.

``problem_source_unsplit(u, prim, mesh, beta_dt, t)`` acts after cooling
in every stage, with the stage-start prim (``emit_prim`` on the stage
rung).

Profiler ranges (``torch.profiler.record_function``) carry the names of
the JAX package's ``jax.named_scope`` sites, so a trace (``driver -t``)
splits a stage alike: ``fused_stage`` (the whole-stage call),
``fused_lane_sweep`` (the sweep kernel's -div(F) and the update),
``calculate_fluxes`` and ``flux_divergence_update`` (the null solver's
stage), ``first_order_flux_correct``, ``dedner_source``,
``tabular_cooling``, ``problem_source`` and ``boundary_fill``.  Inside and
beside them: ``cons_to_prim`` (the EOS with floors), ``stage_update`` (the
2S combination ``gam0 u0 + gam1 u1 + beta_dt (-div F)``, nested in
``fused_lane_sweep``, ``flux_divergence_update`` or
``first_order_flux_correct``), ``estimate_timestep`` (the CFL reduction and
the minima's stack, with the cooling's dt limit in ``cooling_dt``; on the
stage rung the emitted bound's minimum) and
``host_read`` (each read of the device to the host, nested in the range of
the work it serves).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional

import torch
from torch.profiler import record_function

from ..core.boundaries import check_reflecting_mhd, make_boundary_fn
from ..core.indices import (AXIS_OF_DIR, IDN, IPS, IB1, IB2, IB3, IM1, IM2,
                            IM3, IEN, EULER, GLMMHD, nvar_for_fluid)
from ..core.mesh import Mesh
from ..diffusion import DiffusionConfig, calc_diff_fluxes, estimate_diff_dt
from ..eos import adiabatic_cuda
from ..eos.adiabatic import EOS
from ..recon import nghost_for
from ..riemann import solve_riemann
from . import stage, sweep
from .integrators import INTEGRATORS
from .sweep import active_dirs


def _p_like(cfg, u_new):
    """rho and e - ke (- the magnetic energy) of a candidate state: the
    good-cell test's operands (``hydro.cpp:1280``)."""
    rho = u_new[:, IDN:IDN + 1]
    ke_ = 0.5 * (u_new[:, IM1:IM1 + 1] ** 2 + u_new[:, IM2:IM2 + 1] ** 2
                 + u_new[:, IM3:IM3 + 1] ** 2) / rho
    p_like = u_new[:, IEN:IEN + 1] - ke_
    if cfg.fluid == GLMMHD:
        p_like = p_like - 0.5 * (u_new[:, IB1:IB1 + 1] ** 2
                                 + u_new[:, IB2:IB2 + 1] ** 2
                                 + u_new[:, IB3:IB3 + 1] ** 2)
    return rho, p_like


def fofc_bad_cells(cfg, u_new, interior):
    """Interior cells whose candidate state fails the reference's
    good-cell test ``rho > 0 && p > 0`` (``hydro.cpp:1280``), phrased as a
    negation so that NaN candidates are flagged and rescued too."""
    rho, p_like = _p_like(cfg, u_new)
    return ~((rho > 0.0) & (p_like > 0.0)) & interior


def first_order_flux_correct(cfg, eos, dirs, dx_of_dir, interior, u0, u1,
                             prim, fluxes, gam0, gam1, beta_dt, c_h):
    """Iterative first-order flux correction (``FirstOrderFluxCorrect``,
    ``src/hydro/hydro.cpp:1223-1342``): the face fluxes of cells whose
    candidate update would go rho <= 0 or p <= 0 are replaced by DC + LLF
    fluxes; the reference's early-exit loop is 4 unrolled masked passes (a
    pass with no bad cell changes nothing), the last checking rho only.
    ``interior`` is a bool [1, 1, NZ, NY, NX] mask; ``dx_of_dir`` the cell
    width per direction (level-scaled on refined meshes).  Returns new
    flux tensors."""
    llf = {d: solve_riemann("llf", cfg.fluid, eos,
                            torch.roll(prim, 1, dims=AXIS_OF_DIR[d]), prim, d,
                            c_h=c_h, nscalars=cfg.nscalars)
           for d in dirs}

    def flux_div(fl):
        div = None
        for d in dirs:
            dF = (torch.roll(fl[d], -1, dims=AXIS_OF_DIR[d]) - fl[d]) \
                / dx_of_dir[d]
            div = dF if div is None else div + dF
        return div

    for attempt in range(4):
        u_new = gam0 * u0 + gam1 * u1 - beta_dt * flux_div(fluxes)
        rho, p_like = _p_like(cfg, u_new)
        bad = ~((rho > 0.0) & (p_like > 0.0))
        if attempt > 2:
            # last pass: rho > 0 but p < 0 cells are left to the floors
            bad = ~(rho > 0.0)
        bad = bad & interior
        fluxes = {d: torch.where(bad | torch.roll(bad, 1, dims=AXIS_OF_DIR[d]),
                                 llf[d], fluxes[d]) for d in dirs}
    return fluxes


def stage_needs_prim(cfg, unsplit_diff, problem_source_unsplit):
    """Does an epilogue after the hyperbolic stage read the stage-start
    prim?  Unsplit diffusion, the problem's unsplit source and the extended
    Dedner divB terms do (on the stage rung ``emit_prim`` serves them);
    shared by ``HydroPackage`` and the refined ``SmrHydro``."""
    return (unsplit_diff or problem_source_unsplit is not None
            or (cfg.fluid == GLMMHD
                and cfg.glmmhd_source == "dedner_extended"))


def interior_mask(block_shape, interior_slices, device):
    """bool [1, 1, NZ, NY, NX]: the interior cells of a block."""
    m = torch.zeros(tuple(block_shape), dtype=torch.bool, device=device)
    m[tuple(interior_slices[2:])] = True
    return m[None, None]


@dataclasses.dataclass(frozen=True)
class HydroConfig:
    """Static solver configuration (the reference's <hydro> + <parthenon/time>
    options, ``src/hydro/hydro.cpp:264-470``)."""

    fluid: str = EULER                # euler | glmmhd
    reconstruction: str = "plm"       # dc | plm | ppm | weno3 | limo3 | wenoz
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
    ``estimate_timestep``, ``cons_to_prim`` and ``sts_half_step``."""

    def __init__(self, mesh: Mesh, cfg: HydroConfig, eos: EOS,
                 problem_source_unsplit: Optional[Callable] = None,
                 diffusion=None, cooling=None, custom_bcs=None):
        self.mesh = mesh
        self.cfg = cfg
        self.eos = eos
        self.diffusion = (diffusion if diffusion is not None
                          else DiffusionConfig())
        # unsplit diffusion joins every stage; rkl2 wraps the cycle
        self._unsplit_diff = (self.diffusion.any_enabled
                              and self.diffusion.integrator == "unsplit")
        self.sts = (self.diffusion.any_enabled
                    and self.diffusion.integrator == "rkl2")
        self.rkl2_stages = 0      # RKL2 stages run (each one host-side step)
        self.problem_source_unsplit = problem_source_unsplit
        self.cooling = cooling    # TabularCooling or None
        self.custom_bcs = custom_bcs
        self.apply_boundaries = make_boundary_fn(mesh, custom_bcs)

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
        self._stage_rung = os.environ.get("ATHENAPK_PALLAS_STAGE") == "1"
        if cfg.first_order_flux_correct and self._stage_rung:
            print("first_order_flux_correct: the stage rung does not apply "
                  "(the rescue reads the unfused prim, u0 and u1); this deck "
                  "runs the sweep kernel")
        self._interior = {}       # interior masks per device
        self.fofc_rescues = 0     # stages that took the first-order rescue

    # ------------------------------------------------------------------ prim
    def cons_to_prim(self, u):
        """``(u', prim)``: the EOS kernel on the card, its plain twin on the
        CPU (``eos.adiabatic_cuda.fused_cons_to_prim``).  With no floor or
        ceiling on, ``u'`` is ``u`` itself: no caller writes into either."""
        with record_function("cons_to_prim"):
            return adiabatic_cuda.fused_cons_to_prim(
                self.eos, u, self.cfg.fluid, self.cfg.nscalars)

    # ---------------------------------------------------- whole-stage rungs
    def _is_3d(self):
        return self.mesh.nx2 > 1 and self.mesh.nx3 > 1

    def _stage_needs_prim(self):
        return stage_needs_prim(self.cfg, self._unsplit_diff,
                                self.problem_source_unsplit)

    def _use_fused_stage(self):
        """Whole-stage rung: asked for, a 3-D layout (ghost-free or
        ghosted), a Riemann solver, and nothing else in the stage needs the
        raw face fluxes (no first-order flux correction)."""
        return (self._stage_rung and self._is_3d()
                and self.cfg.riemann != "none"
                and not self.cfg.first_order_flux_correct)

    def _use_fused_stage_dt(self):
        """May the last stage emit the next dt?  Needs the whole-stage rung
        and a dt estimate that is the pure hyperbolic CFL bound over every
        cell: ghost-free layout, hyperbolic dt enabled, no diffusion or
        cooling dt, and no epilogue that reads prim (it would change the
        state after the bound was taken)."""
        return (self._use_fused_stage() and self.mesh.nghost == 0
                and self.cfg.calc_dt_hyp and self.cooling is None
                and not self.diffusion.any_enabled
                and not self._stage_needs_prim())

    def _fused_stage_update(self, u0, u1, gam0, gam1, beta_dt, c_h,
                            recon: str, t=0.0, emit_dt: bool = False):
        """One 2S stage through ``stage.fused_stage``; unsplit diffusion,
        the Dedner source, cooling, the unsplit problem source and the
        boundary fill stay outside.  Returns ``u_new``, or ``(u_new,
        raw_dt)`` with ``emit_dt``."""
        emit_prim = self._stage_needs_prim()
        with record_function("fused_stage"):
            out = stage.fused_stage(u0, u1, gam0, gam1, beta_dt, c_h,
                                    self.mesh, self.cfg, self.eos, recon,
                                    emit_dt=emit_dt, emit_prim=emit_prim)
        rest = list(out) if emit_dt or emit_prim else [out]
        u_new = rest.pop(0)
        raw_dt = rest.pop(0) if emit_dt else None
        prim = rest.pop(0) if emit_prim else None
        if self._unsplit_diff:
            u_new += beta_dt * self._diff_negdiv(prim)
        u_new = self._stage_epilogue(u_new, prim, beta_dt, c_h, t)
        return (u_new, raw_dt) if emit_dt else u_new

    def _stage_epilogue(self, u_new, prim, beta_dt, c_h, t):
        """After the update: the Dedner source, cooling, the unsplit
        problem source and the boundary fill, in the JAX package's order
        (the plain Dedner source needs no prim)."""
        if self.cfg.fluid == GLMMHD:
            with record_function("dedner_source"):
                u_new = self._dedner_source(u_new, prim, beta_dt, c_h)
        if self.cooling is not None:
            with record_function("tabular_cooling"):
                u_new = self.cooling.apply_in_place(u_new, beta_dt,
                                                    self.cfg.fluid)
        if self.problem_source_unsplit is not None:
            with record_function("problem_source"):
                u_new = self.problem_source_unsplit(u_new, prim, self.mesh,
                                                    beta_dt, t)
        with record_function("boundary_fill"):
            return self.apply_boundaries(u_new)

    # ----------------------------------------------------------------- fluxes
    def _compute_fluxes(self, prim, c_h, recon: str):
        """The plain fluxes: ``sweep.compute_fluxes`` (zero for the null
        solver, ``rsolvers.hpp:35-63``) plus the unsplit diffusive fluxes,
        as the JAX package's ``_compute_fluxes``."""
        if self.cfg.riemann == "none":
            fluxes = {d: torch.zeros_like(prim) for d in self._active_dirs}
        else:
            fluxes = sweep.compute_fluxes(prim, c_h, self.mesh, self.cfg,
                                          self.eos, recon)
        if self._unsplit_diff:
            dflux = calc_diff_fluxes(self.diffusion, prim, self.mesh)
            fluxes = {d: fluxes[d] + dflux[d] for d in fluxes}
        return fluxes

    def _diff_negdiv(self, prim):
        """-div(F_diff) of ``prim`` (plain PyTorch)."""
        return -self._flux_divergence(calc_diff_fluxes(self.diffusion, prim,
                                                       self.mesh))

    def _flux_divergence(self, fluxes):
        """``sweep.flux_divergence`` (the plain path's second half)."""
        return sweep.flux_divergence(fluxes, self.mesh)

    # ------------------------------------------------------- flux correction
    def _interior_mask(self, device):
        if device not in self._interior:
            self._interior[device] = interior_mask(
                self.mesh.block_shape, self.mesh.interior_slices, device)
        return self._interior[device]

    def _fofc_bad_cells(self, u_new):
        return fofc_bad_cells(self.cfg, u_new, self._interior_mask(
            u_new.device))

    def _first_order_flux_correct(self, u0, u1, prim, fluxes, gam0, gam1,
                                  beta_dt, c_h):
        dx_of = {d: self.mesh.dx[d - 1] for d in self._active_dirs}
        return first_order_flux_correct(
            self.cfg, self.eos, self._active_dirs, dx_of,
            self._interior_mask(u0.device), u0, u1, prim, fluxes, gam0, gam1,
            beta_dt, c_h)

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
                      recon: str, t=0.0):
        """One 2S stage: -div(F) (+ unsplit diffusion) -> update ->
        (first-order rescue) -> Dedner source -> cooling -> unsplit
        problem source -> ghosts (the per-stage task chain of
        ``MakeTaskCollection``, ``src/hydro/hydro_driver.cpp:499-577``).
        The null solver launches no kernel."""
        if self.cfg.riemann == "none":
            with record_function("calculate_fluxes"):
                negdiv = self._diff_negdiv(prim) if self._unsplit_diff \
                    else torch.zeros_like(prim)
            with record_function("flux_divergence_update"), \
                    record_function("stage_update"):
                u_new = gam0 * u0 + gam1 * u1 + beta_dt * negdiv
        else:
            with record_function("fused_lane_sweep"):
                negdiv = sweep.fused_negdiv(prim, c_h, self.mesh, self.cfg,
                                            self.eos, recon)
                if self._unsplit_diff:
                    negdiv += self._diff_negdiv(prim)
                with record_function("stage_update"):
                    u_new = gam0 * u0 + gam1 * u1 + beta_dt * negdiv
        if self.cfg.first_order_flux_correct:
            with record_function("first_order_flux_correct"):
                any_bad = self._fofc_bad_cells(u_new).any()
                with record_function("host_read"):
                    rescue = bool(any_bad)
                if rescue:
                    # the JAX package's lax.cond: a stage with a bad
                    # candidate cell is recomputed through the plain fluxes
                    # and the 4-pass rescue
                    self.fofc_rescues += 1
                    fluxes = self._first_order_flux_correct(
                        u0, u1, prim, self._compute_fluxes(prim, c_h, recon),
                        gam0, gam1, beta_dt, c_h)
                    div = self._flux_divergence(fluxes)
                    with record_function("stage_update"):
                        u_new = gam0 * u0 + gam1 * u1 - beta_dt * div
        return self._stage_epilogue(u_new, prim, beta_dt, c_h, t)

    def step(self, u, dt, c_h, t=0.0, emit_dt: bool = False):
        """Advance one full cycle (all integrator stages); ``u`` enters
        ghost-filled and ``u(t+dt)`` leaves ghost-filled.  ``t`` is the
        cycle's start time (the unsplit problem source reads it).
        ``emit_dt`` (whole-stage rung on the ghost-free layout only): the
        last stage also emits the raw CFL bound; returns ``(u', raw_dt)``."""
        cfg = self.cfg
        tab = INTEGRATORS[cfg.integrator]
        u0 = u
        u1 = u
        raw_dt = None
        fused_stage = self._use_fused_stage()
        if emit_dt and not self._use_fused_stage_dt():
            raise ValueError("emit_dt needs the whole-stage rung on the "
                             "ghost-free layout with calc_dt_hyp")
        for s in range(tab["nstages"]):
            last = s == tab["nstages"] - 1
            recon = cfg.reconstruction
            if cfg.integrator == "vl2" and s == 0:
                recon = "dc"   # first-order predictor (hydro.cpp:459-464)
            if fused_stage:
                # cons_to_prim happens inside the stage function
                out = self._fused_stage_update(
                    u0, u1, tab["gam0"][s], tab["gam1"][s],
                    tab["beta"][s] * dt, c_h, recon, t,
                    emit_dt=emit_dt and last)
                u0, raw_dt = out if emit_dt and last else (out, raw_dt)
            else:
                u0f, prim = self.cons_to_prim(u0)
                u0 = self._stage_update(u0f, u1, prim, tab["gam0"][s],
                                        tab["gam1"][s], tab["beta"][s] * dt,
                                        c_h, recon, t)
        return (u0, raw_dt) if emit_dt else u0

    def step_with_dt(self, u, dt, c_h, t=0.0):
        """One cycle + the next dt estimate: ``(u', (dt, dt_hyp, dt_diff))``.
        Where the last stage can emit the CFL bound it does, and no
        cons_to_prim or reduction pass over the new state runs."""
        if self._use_fused_stage_dt():
            u_new, raw = self.step(u, dt, c_h, t, emit_dt=True)
            with record_function("estimate_timestep"):
                least = torch.min(raw)
                with record_function("host_read"):
                    dt_hyp = self.cfg.cfl * float(least)
            dt_full = dt_hyp
            if self.cfg.max_dt > 0.0:
                dt_full = min(dt_full, self.cfg.max_dt)
            return u_new, (dt_full, dt_hyp, math.inf)
        u_new = self.step(u, dt, c_h, t)
        _, prim = self.cons_to_prim(u_new)
        return u_new, self.estimate_timestep(prim)

    # ------------------------------------------------------------------- dt
    def estimate_timestep(self, prim, dt_cap=math.inf, reduce_min=None):
        """Hyperbolic CFL timestep (``EstimateTimestep``,
        ``src/hydro/hydro.cpp:914-976``), the diffusive dt (the strict
        minimum for unsplit, the ``rkl2_max_dt_ratio`` cap for rkl2), the
        cooling dt, the max_dt cap and ``dt_cap`` (the problem's dt
        constraint, a float or a 0-d tensor).  Returns ``(dt_full, dt_hyp,
        dt_diff)`` as floats, every minimum read from the device in one
        read.  ``reduce_min`` (a sharded run's minimum over ranks) maps the
        float64 vector of the raw minima to theirs before they combine, so
        every rank gets the one-rank dt."""
        cfg = self.cfg
        dc = self.diffusion
        with record_function("estimate_timestep"):
            w = prim[self.mesh.interior_slices]
            mins = {"hyp": torch.min(stage.raw_cfl_dt(
                w, self.mesh, cfg, self.eos, self._active_dirs)),
                "cap": dt_cap}
            if dc.any_enabled and dc.integrator != "none":
                mins["diff"] = estimate_diff_dt(dc, prim, self.mesh, cfg.cfl)
            if self.cooling is not None:
                with record_function("cooling_dt"):
                    mins["cool"] = self.cooling.estimate_timestep(prim,
                                                                  self.mesh)
            # the device minima (the diffusive and cooling dt may be
            # floats) in one read of the host
            lazy = {k: v for k, v in mins.items() if torch.is_tensor(v)}
            stacked = torch.stack(
                [v.to(mins["hyp"].dtype).reshape(()) for v in lazy.values()])
            with record_function("host_read"):
                mins.update(zip(lazy, stacked.tolist()))
            if reduce_min is not None:
                keys = sorted(mins)
                reduced = reduce_min(torch.tensor(
                    [float(mins[k]) for k in keys], dtype=torch.float64))
                with record_function("host_read"):
                    mins.update(zip(keys, reduced.tolist()))
        dt_diff = mins.get("diff", math.inf)
        dt_cool = mins.get("cool", math.inf)
        dt_hyp = cfg.cfl * mins["hyp"]
        dt = dt_hyp if cfg.calc_dt_hyp else math.inf
        if dc.any_enabled and dc.integrator == "unsplit":
            dt = min(dt, dt_diff)
        elif (dc.any_enabled and dc.integrator == "rkl2"
              and dc.rkl2_max_dt_ratio > 0.0):
            # cap dt so that dt_hyp / dt_diff <= the ratio; without the
            # hyperbolic dt the reference's dt_hyp stays huge, so the cap
            # always binds (hydro.cpp:948-957 + :344-362)
            dt_hyp_eff = dt_hyp if cfg.calc_dt_hyp else math.inf
            if dt_hyp_eff / dt_diff > dc.rkl2_max_dt_ratio:
                dt = min(dt, dc.rkl2_max_dt_ratio * dt_diff)
        dt = min(dt, dt_cool)
        if cfg.max_dt > 0.0:
            dt = min(dt, cfg.max_dt)
        return min(dt, mins["cap"]), dt_hyp, dt_diff

    # ------------------------------------------------------------------ RKL2
    def _diff_divergence(self, u):
        """-div(F_diff) from the ghost-filled cons ``u`` (the RKL2 operator
        M: ResetFluxes + CalcDiffFluxes + FluxDivergence,
        ``hydro_driver.cpp:225-260``)."""
        _, prim = self.cons_to_prim(u)
        return self._diff_negdiv(prim)

    def _rkl2_first(self, u, tau, s_rkl):
        """Y1 = Y0 + mu_tilde_1 tau M(Y0) (``RKL2StepFirst``,
        ``hydro_driver.cpp:93-126``).  Returns (Y1 ghost-filled, MY0)."""
        s = float(s_rkl)
        mu_tilde_1 = 4.0 / 3.0 / (s * s + s - 2.0)
        MY0 = self._diff_divergence(u)
        self.rkl2_stages += 1
        return self.apply_boundaries(u + mu_tilde_1 * tau * MY0), MY0

    def _rkl2_other(self, Yjm1, Yjm2, Y0, MY0, coeffs, tau):
        """One RKL2 recursion stage (``RKL2StepOther``,
        ``hydro_driver.cpp:128-167``)."""
        mu_j, nu_j, mu_tilde_j, gamma_tilde_j = coeffs
        MYjm1 = self._diff_divergence(Yjm1)
        self.rkl2_stages += 1
        return self.apply_boundaries(
            mu_j * Yjm1 + nu_j * Yjm2 + (1.0 - mu_j - nu_j) * Y0
            + mu_tilde_j * tau * MYjm1 + gamma_tilde_j * tau * MY0)

    def sts_half_step(self, u, tau, dt_diff: float):
        """RKL2 super-time-step over ``tau`` (one half of the Strang wrap;
        ``AddSTSTasks``, ``hydro_driver.cpp:170-344``): s stages, s from
        tau / dt_diff on the host, as the reference computes it when it
        builds the task list."""
        return rkl2_super_step(u, tau, dt_diff, self._rkl2_first,
                               self._rkl2_other)

    # ------------------------------------------------------------------ misc
    def c_h_from_dt_hyp(self, dt_hyp):
        """Divergence-cleaning speed c_h = cfl * min_dx / dt_hyp
        (``PreStepMeshUserWorkInLoop``, ``src/hydro/hydro.cpp:102-143``)."""
        if self.cfg.fluid != GLMMHD:
            return 0.0
        return self.cfg.cfl * self.mesh.min_dx / dt_hyp


def rkl2_stage_count(tau, dt_diff):
    """The RKL2 stage count s for a super-step of ``tau`` (odd;
    ``hydro_driver.cpp:186-190``)."""
    s_rkl = int(0.5 * (math.sqrt(9.0 + 16.0 * tau / dt_diff) - 1.0)) + 1
    return s_rkl + 1 if s_rkl % 2 == 0 else s_rkl


def rkl2_super_step(u, tau, dt_diff, first, other):
    """The RKL2 recursion over ``tau`` (Meyer, Balsara & Aslam 2014) with
    the stage functions ``first(u, tau, s) -> (Y1, MY0)`` and
    ``other(Yjm1, Yjm2, Y0, MY0, coeffs, tau) -> Yj``, on a uniform
    state or a ``{level: u}`` one alike."""
    s_rkl = rkl2_stage_count(tau, dt_diff)
    Y0 = u
    Yjm1, MY0 = first(u, tau, s_rkl)
    Yjm2 = Y0
    s = float(s_rkl)
    w1 = 4.0 / (s * s + s - 2.0)
    b_jm1 = b_jm2 = 1.0 / 3.0
    for jj in range(2, s_rkl + 1):
        j = float(jj)
        b_j = (j * j + j - 2.0) / (2.0 * j * (j + 1.0))
        mu_j = (2.0 * j - 1.0) / j * b_j / b_jm1
        nu_j = -(j - 1.0) / j * b_j / b_jm2
        mu_tilde_j = mu_j * w1
        gamma_tilde_j = -(1.0 - b_jm1) * mu_tilde_j
        Yj = other(Yjm1, Yjm2, Y0, MY0,
                   (mu_j, nu_j, mu_tilde_j, gamma_tilde_j), tau)
        Yjm2 = Yjm1
        Yjm1 = Yj
        b_jm2 = b_jm1
        b_jm1 = b_j
    return Yjm1
