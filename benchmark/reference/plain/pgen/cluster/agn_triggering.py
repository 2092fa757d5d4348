# A frozen copy of athenapk_tpu_torch/pgen/cluster/agn_triggering.py for the benchmark's
# plain reference of the cluster; it imports nothing of the program.
"""AGN triggering: the accretion rate and the removal of the accreted gas
(reference ``src/pgen/cluster/agn_triggering.{hpp,cpp}``; counterpart of
``athenapk_tpu/pgen/cluster/agn_triggering.py``).

Modes:
  COLD_GAS      -- Mdot = M_cold(r < r_acc, T < T_thresh) / t_acc; the same
                   cells lose mass at rate rho/t_acc.
  BOOSTED_BONDI -- Mdot = alpha 2 pi G^2 M_smbh^2 <rho> / (<v>^2+<cs>^2)^1.5
                   with mass-weighted means inside r_acc.
  BOOTH_SCHAYE  -- as Bondi with alpha = (n/n0)^beta density boost.

The reference's per-cycle ``MPI_Allreduce`` of the accretion quantities
(``hydro_driver.cpp:360-394``) becomes sums over interior cells on the
state's device, added across level groups before ``rate_from_partials``:
the rate is a 0-d tensor there, never read to the host.
"""

from __future__ import annotations

import math

import torch

from ...core.ieee import sqrt
from ...core.indices import IDN, IEN, IM1, IM2, IM3, IPR, IV1, IV2, IV3
from .snia_stellar_feedback import check_range


class AGNTriggering:
    def __init__(self, pin, units, mbar_over_kb, gamma,
                 block="problem/cluster/agn_triggering"):
        self.mode = pin.get_or_add_string(block, "triggering_mode", "NONE")
        self.gamma = gamma
        self.accretion_radius = pin.get_or_add_real(block,
                                                    "accretion_radius", 0.0)
        self.cold_temp_thresh = pin.get_or_add_real(block,
                                                    "cold_temp_thresh", 0.0)
        self.cold_t_acc = pin.get_or_add_real(block, "cold_t_acc", 0.0)
        self.bondi_alpha = pin.get_or_add_real(block, "bondi_alpha", 0.0)
        self.bondi_m_smbh = pin.get_or_add_real("problem/cluster/gravity",
                                                "m_smbh", 0.0)
        self.bondi_n0 = pin.get_or_add_real(block, "bondi_n0", 0.0)
        self.bondi_beta = pin.get_or_add_real(block, "bondi_beta", 0.0)
        self.accretion_cfl = pin.get_or_add_real(block, "accretion_cfl", 0.1)
        self.remove_mass = pin.get_or_add_bool(block, "removed_accreted_mass",
                                               True)
        self.mbar_over_kb = mbar_over_kb
        self.units = units
        self.mean_molecular_mass = mbar_over_kb * units.k_boltzmann()

    # ------------------------------------------------------------------
    def accretion_partials(self, prim, r, cell_volume, valid=None,
                           partial=torch.sum):
        """One group's partial sums of the accretion reduction (0-d
        tensors, or one per leaf with ``partial=LeafSums.partial``).
        ``cell_volume`` is the group's (per-level) cell volume; ``valid``
        an optional interior mask excluding ghost zones (a leaf group
        contributes only its interiors: the volume-weighted cross-level
        reduction of the reference's MPI_Allreduce).  The partials of
        several groups are added before ``rate_from_partials``."""
        inside = r < self.accretion_radius
        if valid is not None:
            inside = inside & valid
        rho = prim[:, IDN]
        if self.mode == "COLD_GAS":
            temp = self.mbar_over_kb * prim[:, IPR] / rho
            cold = inside & (temp <= self.cold_temp_thresh)
            return {"cold_mass":
                    partial(torch.where(cold, rho, 0.0)) * cell_volume}
        # Bondi-like: mass-weighted sums inside the accretion region
        w = torch.where(inside, rho, 0.0) * cell_volume
        v2 = prim[:, IV1] ** 2 + prim[:, IV2] ** 2 + prim[:, IV3] ** 2
        cs = sqrt(self.gamma * prim[:, IPR] / rho)
        return {"w": partial(w),
                "w_rho": partial(w * rho),
                "w_v": partial(w * sqrt(v2)),
                "w_cs": partial(w * cs)}

    def rate_from_partials(self, p):
        """The accretion rate (0-d tensor) from summed partials."""
        if self.mode == "COLD_GAS":
            return p["cold_mass"] / self.cold_t_acc
        total = torch.clamp(p["w"], min=1e-300)
        mean_rho = p["w_rho"] / total
        mean_v = p["w_v"] / total
        mean_cs = p["w_cs"] / total
        if self.mode == "BOOSTED_BONDI":
            alpha = self.bondi_alpha
        elif self.mode == "BOOTH_SCHAYE":
            check_range(mean_rho.dtype, "Booth-Schaye's mean particle mass",
                        self.mean_molecular_mass)
            n = mean_rho / self.mean_molecular_mass
            alpha = torch.where(n < self.bondi_n0, 1.0,
                                (n / self.bondi_n0) ** self.bondi_beta)
        else:
            raise ValueError(f"unknown triggering mode {self.mode}")
        G = self.units.gravitational_constant()
        return (alpha * 2.0 * math.pi * G ** 2 * self.bondi_m_smbh ** 2
                * mean_rho / (mean_v ** 2 + mean_cs ** 2) ** 1.5)

    def accretion_rate(self, prim, r, cell_volume, valid=None):
        """The rate over one group (0.0 without triggering)."""
        if self.mode == "NONE":
            return 0.0
        return self.rate_from_partials(
            self.accretion_partials(prim, r, cell_volume, valid))

    def region_mass(self, prim, r, cell_volume, valid=None,
                    partial=torch.sum):
        inside = r < self.accretion_radius
        if valid is not None:
            inside = inside & valid
        return partial(torch.where(inside, prim[:, IDN], 0.0)) * cell_volume

    def remove_accreted(self, u, prim, r, mdot, beta_dt, region_mass=None):
        """Remove the accreted gas from the triggering region in
        proportion (``RemoveGas``), in place.  ``region_mass`` is the
        global (volume-weighted, all levels) mass of the region, which the
        Bondi modes need."""
        if self.mode == "NONE" or not self.remove_mass:
            return u
        inside = r < self.accretion_radius
        rho = prim[:, IDN]
        if self.mode == "COLD_GAS":
            temp = self.mbar_over_kb * prim[:, IPR] / rho
            sel = inside & (temp <= self.cold_temp_thresh)
            frac = beta_dt / self.cold_t_acc
        else:
            sel = inside
            region_mass = torch.clamp(region_mass, min=1e-300)
            frac = torch.clamp(mdot * beta_dt / region_mass, max=0.9)
        keep = torch.as_tensor(1.0 - frac, dtype=u.dtype, device=u.device)
        scale = torch.where(sel, keep, 1.0)
        for c in (IDN, IM1, IM2, IM3, IEN):
            u[:, c] *= scale
        return u
