# A frozen copy of athenapk_tpu_torch/eos/adiabatic.py for the benchmark's plain
# reference (uniform meshes only); it imports nothing of the program.
"""Adiabatic equation of state for Euler and GLM-MHD fluids (torch).

Counterpart of ``athenapk_tpu/eos/adiabatic.py`` (reference
``src/eos/adiabatic_hydro.hpp:52-148`` and
``src/eos/adiabatic_glmmhd.hpp:62-167``): cons->prim with density/pressure/
internal-energy floors and velocity/internal-energy ceilings, applied to
whole block-batched tensors.  Returns updated ``(cons, prim)`` rather than
mutating ``cons``.

A floor <= 0 is disabled; negative states then propagate (NaNs downstream)
rather than being patched, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.ieee import sqrt
from ..core.indices import (IDN, IM1, IM2, IM3, IEN, IB1, IB2, IB3, IPS,
                            IV1, IV2, IV3, IPR, NHYDRO, NGLMMHD, GLMMHD)


@dataclasses.dataclass(frozen=True)
class EOS:
    """Static EOS parameters."""

    gamma: float
    density_floor: float = -1.0
    pressure_floor: float = -1.0
    internal_e_floor: float = -1.0
    velocity_ceiling: float = float("inf")
    internal_e_ceiling: float = float("inf")

    @property
    def gm1(self) -> float:
        return self.gamma - 1.0

    @classmethod
    def from_parameter_input(cls, pin) -> "EOS":
        """Parse <hydro> floor/ceiling options (reference
        ``src/hydro/hydro.cpp:469-540``)."""
        h = "hydro"
        return cls(
            gamma=pin.get_real(h, "gamma"),
            density_floor=pin.get_or_add_real(h, "dfloor", -1.0),
            pressure_floor=pin.get_or_add_real(h, "pfloor", -1.0),
            internal_e_floor=pin.get_or_add_real(h, "efloor", -1.0),
            velocity_ceiling=pin.get_or_add_real(h, "vceil", float("inf")),
            internal_e_ceiling=pin.get_or_add_real(h, "eceil", float("inf")),
        )


def sound_speed(eos: EOS, rho, p):
    return sqrt(eos.gamma * p / rho)


def fast_magnetosonic_speed(eos: EOS, rho, p, bx, by, bz):
    """Fast speed along the ``bx`` direction
    (``src/eos/adiabatic_glmmhd.hpp:47-54``)."""
    asq = eos.gamma * p
    ct2 = by * by + bz * bz
    qsq = bx * bx + ct2 + asq
    tmp = bx * bx + ct2 - asq
    return sqrt(0.5 * (qsq + sqrt(tmp * tmp + 4.0 * asq * ct2))
                      / rho)


def cons_to_prim(eos: EOS, cons, fluid: str, nscalars: int = 0):
    """Conserved -> primitive over a whole [..., nvar, nz, ny, nx] tensor;
    returns (cons', prim) with floors/ceilings applied to both."""
    is_mhd = fluid == GLMMHD

    u_d = cons[..., IDN, :, :, :]
    # density floor (keeps momentum/energy unchanged)
    if eos.density_floor > 0.0:
        u_d = torch.clamp(u_d, min=eos.density_floor)
    u_m1 = cons[..., IM1, :, :, :]
    u_m2 = cons[..., IM2, :, :, :]
    u_m3 = cons[..., IM3, :, :, :]
    u_e = cons[..., IEN, :, :, :]

    di = 1.0 / u_d
    w_vx = u_m1 * di
    w_vy = u_m2 * di
    w_vz = u_m3 * di

    e_k = 0.5 * di * (u_m1 * u_m1 + u_m2 * u_m2 + u_m3 * u_m3)
    if is_mhd:
        u_b1 = cons[..., IB1, :, :, :]
        u_b2 = cons[..., IB2, :, :, :]
        u_b3 = cons[..., IB3, :, :, :]
        e_b = 0.5 * (u_b1 * u_b1 + u_b2 * u_b2 + u_b3 * u_b3)
    else:
        e_b = 0.0

    # velocity ceiling rescales both v and momentum, removes KE from E
    if math.isfinite(eos.velocity_ceiling):
        w_v2 = w_vx * w_vx + w_vy * w_vy + w_vz * w_vz
        w_v = sqrt(w_v2)
        over = w_v2 > eos.velocity_ceiling ** 2
        scale = torch.where(over, eos.velocity_ceiling / w_v, 1.0)
        w_vx = w_vx * scale
        w_vy = w_vy * scale
        w_vz = w_vz * scale
        u_m1 = u_m1 * scale
        u_m2 = u_m2 * scale
        u_m3 = u_m3 * scale
        e_k_new = torch.where(over, 0.5 * u_d * eos.velocity_ceiling ** 2,
                              e_k)
        u_e = u_e - (e_k - e_k_new)
        e_k = e_k_new

    w_p = eos.gm1 * (u_e - e_k - e_b)

    # pressure floor takes precedence over the temperature-based floor
    if eos.pressure_floor > 0.0:
        under = w_p < eos.pressure_floor
        u_e = torch.where(under, eos.pressure_floor / eos.gm1 + e_k + e_b,
                          u_e)
        w_p = torch.where(under, eos.pressure_floor, w_p)
    if eos.internal_e_floor > 0.0:
        eff_floor = eos.gm1 * u_d * eos.internal_e_floor
        under = w_p < eff_floor
        u_e = torch.where(under, u_d * eos.internal_e_floor + e_k + e_b, u_e)
        w_p = torch.where(under, eff_floor, w_p)
    if math.isfinite(eos.internal_e_ceiling):
        eff_ceil = eos.gm1 * u_d * eos.internal_e_ceiling
        over = w_p > eff_ceil
        u_e = torch.where(over, u_d * eos.internal_e_ceiling + e_k + e_b, u_e)
        w_p = torch.where(over, eff_ceil, w_p)

    parts = [u_d, w_vx, w_vy, w_vz, w_p]
    cparts = [u_d, u_m1, u_m2, u_m3, u_e]
    if is_mhd:
        parts += [u_b1, u_b2, u_b3, cons[..., IPS, :, :, :]]
        cparts += [u_b1, u_b2, u_b3, cons[..., IPS, :, :, :]]
    nbase = NGLMMHD if is_mhd else NHYDRO
    for n in range(nbase, nbase + nscalars):
        parts.append(cons[..., n, :, :, :] * di)
        cparts.append(cons[..., n, :, :, :])
    prim = torch.stack(parts, dim=-4)
    cons_out = torch.stack(cparts, dim=-4)
    return cons_out, prim


def prim_to_cons(eos: EOS, prim, fluid: str, nscalars: int = 0):
    """Inverse conversion (used by problem generators and tests)."""
    is_mhd = fluid == GLMMHD
    rho = prim[..., IDN, :, :, :]
    vx = prim[..., IV1, :, :, :]
    vy = prim[..., IV2, :, :, :]
    vz = prim[..., IV3, :, :, :]
    p = prim[..., IPR, :, :, :]
    e_k = 0.5 * rho * (vx * vx + vy * vy + vz * vz)
    if is_mhd:
        bx = prim[..., IB1, :, :, :]
        by = prim[..., IB2, :, :, :]
        bz = prim[..., IB3, :, :, :]
        e_b = 0.5 * (bx * bx + by * by + bz * bz)
    else:
        e_b = 0.0
    u_e = p / eos.gm1 + e_k + e_b
    parts = [rho, rho * vx, rho * vy, rho * vz, u_e]
    if is_mhd:
        parts += [bx, by, bz, prim[..., IPS, :, :, :]]
    nbase = NGLMMHD if is_mhd else NHYDRO
    for n in range(nbase, nbase + nscalars):
        parts.append(prim[..., n, :, :, :] * rho)
    return torch.stack(parts, dim=-4)
