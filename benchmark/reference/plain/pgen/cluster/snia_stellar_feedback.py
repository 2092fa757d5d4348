# A frozen copy of athenapk_tpu_torch/pgen/cluster/snia_stellar_feedback.py for the benchmark's
# plain reference of the cluster; it imports nothing of the program.
"""SN Ia and stellar feedback for the cluster application (reference
``src/pgen/cluster/snia_feedback.cpp`` and ``stellar_feedback.cpp``;
counterpart of ``athenapk_tpu/pgen/cluster/snia_stellar_feedback.py``).

SN Ia: thermal energy and mass deposited in proportion to the BCG stellar
density profile (rates per unit BCG mass); an unsplit source, every stage.

Stellar: cold dense gas inside [exclusion_radius, stellar_radius] is
converted to thermal energy at rate efficiency*c^2: its density is reset
to the threshold and the removed mass is returned as heat (at fixed
velocity and temperature); a split source, once per cycle.

Both update ``u`` in place on its device.
"""

from __future__ import annotations

import copy

import torch

from ...core.indices import IDN, IEN, IM1, IM2, IM3, IPR


def check_range(dtype, what, value):
    """Refuse a constant outside the normal range of ``dtype`` (a number
    density per code volume overflows f32 where the mean particle mass,
    ~5e-72 in Mpc and 1e14 Msun units, underflows it): the result would be
    quietly wrong."""
    fi = torch.finfo(dtype)
    if not fi.tiny <= abs(value) <= fi.max:
        raise ValueError(f"{what} ({value:.3e} in code units) is outside "
                         f"the {dtype} range: run in double precision or "
                         "in other code units")


def add_mass_at_fixed_velocity(u, drho, de=None):
    """Add ``drho`` to the density with the velocity kept: the momenta
    scale by (rho + drho) / rho and the kinetic energy grows with them
    (plus ``de`` in the same addition to the energy)."""
    rho = u[:, IDN].clone()
    fac = (rho + drho) / rho
    ke_old = 0.5 * (u[:, IM1] ** 2 + u[:, IM2] ** 2 + u[:, IM3] ** 2) / rho
    u[:, IDN] += drho
    for c in (IM1, IM2, IM3):
        u[:, c] *= fac
    u[:, IEN] += ke_old * (fac - 1.0) if de is None \
        else ke_old * (fac - 1.0) + de


class SNIAFeedback:
    def __init__(self, pin, units, bcg_gravity,
                 block="problem/cluster/snia_feedback"):
        self.power_per_bcg_mass = pin.get_or_add_real(
            block, "power_per_bcg_mass", 0.0)
        self.mass_rate_per_bcg_mass = pin.get_or_add_real(
            block, "mass_rate_per_bcg_mass", 0.0)
        self.disabled = pin.get_or_add_bool(block, "disabled", False)
        # a BCG-only copy of the gravity profile (no NFW, no SMBH)
        self.bcg = copy.copy(bcg_gravity)
        self.bcg.include_nfw = False
        self.bcg.include_smbh = False
        if not self.disabled and (self.power_per_bcg_mass
                                  or self.mass_rate_per_bcg_mass):
            if self.bcg.which_bcg == "NONE":
                raise ValueError("SNIA feedback requires a BCG profile")

    @property
    def active(self):
        return not self.disabled and (self.power_per_bcg_mass != 0.0
                                      or self.mass_rate_per_bcg_mass != 0.0)

    def apply(self, u, prim, beta_dt, r):
        if not self.active:
            return u
        bcg_rho = self.bcg.rho_from_r(r)
        u[:, IEN] += self.power_per_bcg_mass * beta_dt * bcg_rho
        add_mass_at_fixed_velocity(
            u, self.mass_rate_per_bcg_mass * beta_dt * bcg_rho)
        return u


class StellarFeedback:
    def __init__(self, pin, units, mu, mbar_over_kb,
                 block="problem/cluster/stellar_feedback"):
        self.stellar_radius = pin.get_or_add_real(block, "stellar_radius",
                                                  0.0)
        self.exclusion_radius = pin.get_or_add_real(block,
                                                    "exclusion_radius", 0.0)
        self.efficiency = pin.get_or_add_real(block, "efficiency", 0.0)
        self.n_thresh = pin.get_or_add_real(block,
                                            "number_density_threshold", 0.0)
        self.t_thresh = pin.get_or_add_real(block, "temperature_threshold",
                                            0.0)
        self.disabled = (self.stellar_radius == 0.0
                         and self.exclusion_radius == 0.0
                         and self.efficiency == 0.0
                         and self.n_thresh == 0.0 and self.t_thresh == 0.0)
        if not self.disabled and self.exclusion_radius == 0.0:
            self.exclusion_radius = pin.get_or_add_real(
                "problem/cluster/agn_triggering", "accretion_radius", 0.0)
        if not self.disabled and not all(
                (self.stellar_radius, self.exclusion_radius,
                 self.efficiency, self.n_thresh, self.t_thresh)):
            raise ValueError("stellar feedback requires all parameters set")
        self.mbar = mu * units.mh()
        self.mbar_over_kb = mbar_over_kb
        self.mass_to_energy = self.efficiency * units.speed_of_light() ** 2

    def apply(self, u, prim, beta_dt, r):
        if self.disabled:
            return u
        check_range(u.dtype, "stellar feedback's mean particle mass",
                    self.mbar)
        rho = prim[:, IDN]
        number_density = rho / self.mbar
        temp = self.mbar_over_kb * prim[:, IPR] / rho
        sel = ((r <= self.stellar_radius) & (r > self.exclusion_radius)
               & (number_density >= self.n_thresh)
               & (temp <= self.t_thresh))
        # reset the density to the threshold; the removed mass becomes heat
        delta_rho = torch.where(sel, self.n_thresh * self.mbar - rho, 0.0)
        # momenta at fixed velocity, internal energy at fixed temperature
        eint_spec = prim[:, IPR] / ((5.0 / 3.0 - 1.0) * rho)  # per mass
        add_mass_at_fixed_velocity(u, delta_rho, delta_rho * eint_spec)
        u[:, IEN] += -self.mass_to_energy * delta_rho
        return u
