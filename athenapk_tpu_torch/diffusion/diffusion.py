"""Diffusive processes: thermal conduction, viscosity, Ohmic resistivity
(torch).

Counterpart of ``athenapk_tpu/diffusion/diffusion.py`` (reference
``src/hydro/diffusion/``): each process adds face-flux increments to the
conserved-variable fluxes, written as whole-tensor shifted expressions.
The limiters (minmod, van Leer, MC, and lim4 for the off-axis gradients)
are ``diffusion.hpp:20-68``'s.

  conduction  — isotropic fixed (``conduction.cpp:189``) and general
                (anisotropic and/or Spitzer, with the saturated-flux
                smoothing, ``conduction.cpp:265``); the temperature is
                p / rho (Spitzer's kappa absorbs mbar / k_B).
  viscosity   — isotropic fixed-nu compressible stress
                (``viscosity.cpp:94``).
  resistivity — Ohmic fixed eta (``resistivity.cpp:91``).

Flux tensors are co-indexed with cells (index i = face i-1/2); every shift
wraps within a block (``torch.roll``, as the JAX package's ``jnp.roll``):
the ghost zones, or the periodic wrap of a ghost-free block, cover it.
Plain PyTorch on whatever device the state is on (the JAX package runs
no kernel for diffusion either); on a CPU tensor the square roots and the
Spitzer power are numpy's (``core/ieee.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..core.ieee import power, sqrt
from ..core.indices import (AXIS_OF_DIR, IB1, IB2, IB3, IDN, IEN, IPR, IV1,
                            IV2, IV3)

_TINY = 1.0e-20


# ------------------------------------------------------------------ limiters
def minmod(a, b):
    return torch.where(a * b > 0.0, torch.where(a > 0.0, torch.minimum(a, b),
                                                torch.maximum(a, b)), 0.0)


def vanleer(a, b):
    ab = a * b
    return torch.where(ab > 0.0, 2.0 * ab / torch.where(ab > 0.0, a + b, 1.0),
                       0.0)


def mc(a, b):
    return minmod(2.0 * minmod(a, b), 0.5 * (a + b))


def lim2(a, b):
    return mc(a, b)


def lim4(a, b, c, d):
    return lim2(lim2(a, b), lim2(c, d))


# -------------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    integrator: str = "none"          # none | unsplit | rkl2
    conduction: str = "none"          # none | isotropic | anisotropic
    conduction_coeff: str = "none"    # fixed | spitzer
    thermal_diff_coeff: float = 0.0   # chi (fixed, code units) or Spitzer's
    conduction_sat_prefac: float = 0.0
    mbar_over_kb: float = 1.0         # Spitzer: T_cgs = mbar/kb * p/rho
    viscosity: str = "none"           # none | isotropic
    viscosity_coeff: str = "none"     # fixed
    mom_diff_coeff: float = 0.0       # nu
    resistivity: str = "none"         # none | ohmic
    resistivity_coeff: str = "none"   # fixed
    ohm_diff_coeff: float = 0.0       # eta
    rkl2_max_dt_ratio: float = -1.0

    @property
    def any_enabled(self) -> bool:
        return (self.conduction != "none" or self.viscosity != "none"
                or self.resistivity != "none")

    @classmethod
    def from_parameter_input(cls, pin, units=None, mu: Optional[float] = None
                             ) -> "DiffusionConfig":
        d = "diffusion"
        if not pin.has_block(d):
            return cls()
        integ = pin.get_or_add_string(d, "integrator", "unsplit")
        cond = pin.get_or_add_string(d, "conduction", "none")
        cond_coeff = pin.get_or_add_string(d, "conduction_coeff", "none")
        chi = 0.0
        sat_prefac = 0.0
        mbar_over_kb = 1.0
        if cond != "none":
            phi = pin.get_or_add_real(d, "conduction_sat_phi", 0.3)
            if cond_coeff == "fixed":
                chi = pin.get_real(d, "thermal_diff_coeff_code")
                sat_prefac = 5.0 * phi
            elif cond_coeff == "spitzer":
                if units is None or mu is None:
                    raise ValueError(
                        "spitzer conduction requires <units> block and "
                        "hydro/He_mass_fraction")
                spitzer = pin.get_or_add_real(
                    d, "spitzer_cond_in_erg_by_s_K_cm", 4.6e-7)
                chi = spitzer * units.erg() / (units.s() * units.cm())
                sat_prefac = 6.86 * (mu ** 0.5) * phi
                mbar_over_kb = mu * units.mh() / units.k_boltzmann()
            else:
                raise ValueError("conduction requires conduction_coeff "
                                 "'fixed' or 'spitzer'")
        visc = pin.get_or_add_string(d, "viscosity", "none")
        visc_coeff = pin.get_or_add_string(d, "viscosity_coeff", "none")
        nu = 0.0
        if visc != "none":
            if visc_coeff != "fixed":
                raise ValueError("viscosity requires viscosity_coeff 'fixed'")
            nu = pin.get_real(d, "mom_diff_coeff_code")
        resist = pin.get_or_add_string(d, "resistivity", "none")
        resist_coeff = pin.get_or_add_string(d, "resistivity_coeff", "none")
        eta = 0.0
        if resist != "none":
            if resist_coeff != "fixed":
                raise ValueError(
                    "resistivity requires resistivity_coeff 'fixed'")
            eta = pin.get_real(d, "ohm_diff_coeff_code")
        return cls(
            integrator=integ, conduction=cond, conduction_coeff=cond_coeff,
            thermal_diff_coeff=chi, conduction_sat_prefac=sat_prefac,
            mbar_over_kb=mbar_over_kb,
            viscosity=visc, viscosity_coeff=visc_coeff, mom_diff_coeff=nu,
            resistivity=resist, resistivity_coeff=resist_coeff,
            ohm_diff_coeff=eta,
            rkl2_max_dt_ratio=pin.get_or_add_real(d, "rkl2_max_dt_ratio",
                                                  -1.0),
        )


# ------------------------------------------------------------------- helpers
def active_dims(mesh):
    return [1] + ([2] if mesh.nx2 > 1 else []) + ([3] if mesh.nx3 > 1 else [])


def _sh(q, n, axis):
    """``_sh(q, n)[i] == q[i+n]`` (a roll; the ghosts cover the wrap)."""
    return torch.roll(q, -n, dims=axis)


def _chi(dc: DiffusionConfig, p, rho):
    """Thermal diffusivity chi(p, rho) (``ThermalDiffusivity::Get``)."""
    if dc.conduction_coeff == "fixed":
        return dc.thermal_diff_coeff
    # Spitzer: kappa = c T_cgs^{5/2}; chi = kappa mbar/kb / rho
    T_cgs = dc.mbar_over_kb * p / rho
    return dc.thermal_diff_coeff * power(T_cgs, 2.5) * dc.mbar_over_kb / rho


def _face_derivs_T(prim, dirn, dims, dx):
    """(dT_x, dT_y, dT_z) at the faces of direction ``dirn``: the normal
    derivative and the lim4-limited off-axis ones
    (``conduction.cpp:265-...``), in global component order."""
    ax = AXIS_OF_DIR[dirn]
    T = prim[:, IPR] / prim[:, IDN]
    out = {}
    out[dirn] = (T - _sh(T, -1, ax - 1)) / dx[dirn - 1]
    for d2 in (1, 2, 3):
        if d2 == dirn:
            continue
        if d2 not in dims:
            out[d2] = torch.zeros_like(T)
            continue
        ax2 = AXIS_OF_DIR[d2] - 1   # component tensors have no var axis
        A = _sh(T, +1, ax2) - T
        B = T - _sh(T, -1, ax2)
        C = _sh(A, -1, ax - 1)
        D = _sh(B, -1, ax - 1)
        out[d2] = lim4(A, B, C, D) / dx[d2 - 1]
    return out[1], out[2], out[3]


def _favg(q, ax):
    """Average to the face: 0.5 (q[i-1] + q[i])."""
    return 0.5 * (q + _sh(q, -1, ax))


# ---------------------------------------------------------------- conduction
def conduction_fluxes(dc: DiffusionConfig, prim, mesh, dims):
    """Energy-flux increments per direction: isotropic fixed
    ``F_E = -chi rho_f dT/dn`` (``ThermalFluxIsoFixed``), otherwise the
    anisotropic and/or Spitzer flux with the saturation smoothing
    (``ThermalFluxGeneral``)."""
    out = {}
    simple = dc.conduction == "isotropic" and dc.conduction_coeff == "fixed"
    rho = prim[:, IDN]
    p = prim[:, IPR]
    T = p / rho
    for d in dims:
        ax = AXIS_OF_DIR[d] - 1
        denf = _favg(rho, ax)
        if simple:
            dTdn = (T - _sh(T, -1, ax)) / mesh.dx[d - 1]
            out[d] = -dc.thermal_diff_coeff * denf * dTdn
            continue
        dTdx, dTdy, dTdz = _face_derivs_T(prim, d, dims, mesh.dx)
        gradT = {1: dTdx, 2: dTdy, 3: dTdz}
        gradTmag = sqrt(dTdx ** 2 + dTdy ** 2 + dTdz ** 2)
        if dc.conduction_coeff == "fixed":
            chi_f = dc.thermal_diff_coeff
        else:
            chi = _chi(dc, p, rho)
            chi_f = 0.5 * (chi + _sh(chi, -1, ax))
        if dc.conduction == "anisotropic":
            Bx = _favg(prim[:, IB1], ax)
            By = _favg(prim[:, IB2], ax)
            # the reference zeroes Bz on faces for ndim < 3
            Bz = (_favg(prim[:, IB3], ax) if 3 in dims
                  else torch.zeros_like(Bx))
            Bmag = torch.clamp(sqrt(Bx ** 2 + By ** 2 + Bz ** 2), min=_TINY)
            bn = {1: Bx, 2: By, 3: Bz}[d] / Bmag
            bDotGradT = (Bx * dTdx + By * dTdy + Bz * dTdz) / Bmag
            flux_classic = -chi_f * denf * bDotGradT * bn
            flux_classic_mag = torch.abs(chi_f * denf * bDotGradT)
        else:
            flux_classic = -chi_f * denf * gradT[d]
            flux_classic_mag = chi_f * denf * gradTmag
        # saturation: the pressure upwind by the flux's sign (Cowie & McKee)
        p_m1 = _sh(p, -1, ax)
        presf = 0.5 * (p + p_m1)
        p_up = torch.where(flux_classic > 0.0, p_m1,
                           torch.where(flux_classic < 0.0, p, presf))
        flux_sat = dc.conduction_sat_prefac * sqrt(p_up / denf) * p_up
        out[d] = (flux_sat / (flux_sat + flux_classic_mag)) * flux_classic
    return out


# ----------------------------------------------------------------- viscosity
def viscosity_fluxes(dc: DiffusionConfig, prim, mesh, dims):
    """Compressible Navier-Stokes stress, isotropic fixed nu
    (``MomentumDiffFluxIsoFixed``): per direction ``{1, 2, 3 (momentum
    component), IEN: flux increment}``."""
    nu = dc.mom_diff_coeff
    rho = prim[:, IDN]
    v = {1: prim[:, IV1], 2: prim[:, IV2], 3: prim[:, IV3]}
    dx = mesh.dx
    out = {}
    for d in dims:
        ax = AXIS_OF_DIR[d] - 1
        # cyclic (normal, t1, t2) = (d, d+1, d+2)
        t1 = d % 3 + 1
        t2 = t1 % 3 + 1

        def favg(q):
            return _favg(q, ax)

        def cderiv(q, dd):
            """Centred derivative in dd, averaged onto the d-face."""
            ax2 = AXIS_OF_DIR[dd] - 1
            return (favg(_sh(q, +1, ax2)) - favg(_sh(q, -1, ax2))) / (
                2.0 * dx[dd - 1])

        def nderiv(q):
            return (q - _sh(q, -1, ax)) / dx[d - 1]

        fv = {}
        # normal: 4/3 d_n v_n - 2/3 (d_t1 v_t1 + d_t2 v_t2)
        fvn = 4.0 / 3.0 * nderiv(v[d])
        if t1 in dims:
            fvn = fvn - 2.0 / 3.0 * cderiv(v[t1], t1)
        if t2 in dims:
            fvn = fvn - 2.0 / 3.0 * cderiv(v[t2], t2)
        fv[d] = fvn
        # transverse: d_n v_t + d_t v_n
        fvt1 = nderiv(v[t1])
        if t1 in dims:
            fvt1 = fvt1 + cderiv(v[d], t1)
        fv[t1] = fvt1
        fvt2 = nderiv(v[t2])
        if t2 in dims:
            fvt2 = fvt2 + cderiv(v[d], t2)
        fv[t2] = fvt2

        nud = nu * _favg(rho, ax)
        fluxes = {m: -nud * fv[m] for m in (1, 2, 3)}
        fluxes[IEN] = -0.5 * nud * sum(
            (favg(v[m]) * 2.0) * fv[m] for m in (1, 2, 3))
        out[d] = fluxes
    return out


# --------------------------------------------------------------- resistivity
def resistivity_fluxes(dc: DiffusionConfig, prim, mesh, dims):
    """Ohmic diffusion, fixed eta (``OhmicDiffFluxIsoFixed``):
    ``F_d(B_m) = -eta eps_dmn J_n``, ``F_d(E) = eta (J x B)_d`` at faces."""
    eta = dc.ohm_diff_coeff
    B = {1: prim[:, IB1], 2: prim[:, IB2], 3: prim[:, IB3]}
    dx = mesh.dx
    out = {}
    for d in dims:
        ax = AXIS_OF_DIR[d] - 1
        t1 = d % 3 + 1
        t2 = t1 % 3 + 1

        def favg(q):
            return _favg(q, ax)

        def cderiv(q, dd):
            if dd not in dims:
                return torch.zeros_like(q)
            ax2 = AXIS_OF_DIR[dd] - 1
            return (favg(_sh(q, +1, ax2)) - favg(_sh(q, -1, ax2))) / (
                2.0 * dx[dd - 1])

        def nderiv(q):
            return (q - _sh(q, -1, ax)) / dx[d - 1]

        # the current at the d-face:
        # J_t2 = d_d B_t1 - d_t1 B_d ; J_t1 = d_t2 B_d - d_d B_t2
        J_t2 = nderiv(B[t1]) - cderiv(B[d], t1)
        J_t1 = cderiv(B[d], t2) - nderiv(B[t2])
        fluxes = {("B", t1): -eta * J_t2, ("B", t2): eta * J_t1}
        # F_d(E) = eta (J x B)_d with face-averaged B
        fluxes[IEN] = eta * (J_t1 * favg(B[t2]) - J_t2 * favg(B[t1]))
        out[d] = fluxes
    return out


# ------------------------------------------------------------------ assembly
def calc_diff_fluxes(dc: DiffusionConfig, prim, mesh) -> Dict[int, object]:
    """The diffusive flux tensors ``[nb, nvar, NZ, NY, NX]`` per active
    direction (``CalcDiffFluxes``, ``diffusion.cpp:18-53``)."""
    dims = active_dims(mesh)
    fluxes = {d: torch.zeros_like(prim) for d in dims}
    if dc.conduction != "none":
        for d, fe in conduction_fluxes(dc, prim, mesh, dims).items():
            fluxes[d][:, IEN] += fe
    if dc.viscosity != "none":
        mom_idx = {1: IV1, 2: IV2, 3: IV3}
        for d, fd in viscosity_fluxes(dc, prim, mesh, dims).items():
            for m in (1, 2, 3):
                fluxes[d][:, mom_idx[m]] += fd[m]
            fluxes[d][:, IEN] += fd[IEN]
    if dc.resistivity != "none":
        b_idx = {1: IB1, 2: IB2, 3: IB3}
        for d, fd in resistivity_fluxes(dc, prim, mesh, dims).items():
            for key, val in fd.items():
                row = IEN if key == IEN else b_idx[key[1]]
                fluxes[d][:, row] += val
    return fluxes


# ------------------------------------------------------------------------ dt
def estimate_diff_dt(dc: DiffusionConfig, prim, mesh, cfl: float):
    """The least parabolic dt over the processes (``Estimate*Timestep``):
    ``cfl * fac(ndim) * min(dx^2 / coeff)``.  A Python float for fixed
    coefficients, a 0-d tensor (not read) with Spitzer conduction."""
    dims = active_dims(mesh)
    fac = {1: 0.5, 2: 0.25, 3: 1.0 / 6.0}[len(dims)]
    coeffs = []
    if dc.conduction != "none":
        if dc.conduction_coeff == "fixed":
            coeffs.append(dc.thermal_diff_coeff)
        else:
            w = prim[mesh.interior_slices]
            coeffs.append(torch.max(_chi(dc, w[:, IPR], w[:, IDN])))
    if dc.viscosity != "none":
        coeffs.append(dc.mom_diff_coeff)
    if dc.resistivity != "none":
        coeffs.append(dc.ohm_diff_coeff)
    min_dt = math.inf
    for d in dims:
        dx2 = mesh.dx[d - 1] ** 2
        for c in coeffs:
            min_dt = _minimum(min_dt, dx2 / (c + _TINY))
    return cfl * fac * min_dt


def _minimum(a, b):
    """min of two floats or 0-d tensors (a tensor if either is one)."""
    if torch.is_tensor(a) and torch.is_tensor(b):
        return torch.minimum(a, b)
    if torch.is_tensor(a):
        return torch.clamp(a, max=b)
    if torch.is_tensor(b):
        return torch.clamp(b, max=a)
    return min(a, b)
