# A frozen copy of athenapk_tpu_torch/pgen/cluster/gravity.py for the benchmark's
# plain reference of the cluster; it imports nothing of the program.
"""Cluster gravitational field: NFW halo + Hernquist BCG + SMBH point mass
(reference ``src/pgen/cluster/cluster_gravity.hpp``; counterpart of
``athenapk_tpu/pgen/cluster/gravity.py``).  Radial g(r) and rho(r) in code
units, with an inner smoothing radius.

``g_from_r`` and ``rho_from_r`` take a float or a numpy array (host f64:
the HSE integration) or a tensor (on its own device and dtype: the
source term), with the same operations in the same order either way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core.indices import IDN, IEN, IM1, IM2, IM3, IV1, IV2, IV3
from ...utils.units import Units


def _floor_and_log(r_in, floor):
    """``(max(r_in, floor), log)`` of the array kind of ``r_in``."""
    if torch.is_tensor(r_in):
        return torch.clamp(r_in, min=floor), torch.log
    return np.maximum(r_in, floor), np.log


class ClusterGravity:
    def __init__(self, pin, units: Units):
        g = "problem/cluster/gravity"
        self.include_nfw = pin.get_or_add_bool(g, "include_nfw_g", False)
        which_bcg = pin.get_or_add_string(g, "which_bcg_g", "NONE")
        if which_bcg not in ("NONE", "HERNQUIST"):
            raise ValueError(f"unknown BCG type {which_bcg}")
        self.which_bcg = which_bcg
        self.include_smbh = pin.get_or_add_bool(g, "include_smbh_g", False)

        hubble = pin.get_or_add_real(
            "problem/cluster", "hubble_parameter",
            70 * units.km_s() / units.mpc())
        rho_crit = 3 * hubble * hubble / (
            8 * math.pi * units.gravitational_constant())
        m_nfw_200 = pin.get_or_add_real(g, "m_nfw_200",
                                        8.5e14 * units.msun())
        c_nfw = pin.get_or_add_real(g, "c_nfw", 6.81)
        mass_fac = math.log(1 + c_nfw) - c_nfw / (1 + c_nfw)
        rho_nfw_0 = 200.0 / 3.0 * rho_crit * c_nfw ** 3 / mass_fac
        self.r_nfw_s = (m_nfw_200 / (4 * math.pi * rho_nfw_0 * mass_fac)
                        ) ** (1.0 / 3.0)
        G = units.gravitational_constant()
        self.g_const_nfw = G * m_nfw_200 / mass_fac
        self.rho_const_nfw = m_nfw_200 / (4 * math.pi * mass_fac)

        m_bcg_s = pin.get_or_add_real(g, "m_bcg_s", 7.5e10 * units.msun())
        self.r_bcg_s = pin.get_or_add_real(g, "r_bcg_s", 4 * units.kpc())
        self.alpha_bcg_s = pin.get_or_add_real(g, "alpha_bcg_s", 0.1)
        self.beta_bcg_s = pin.get_or_add_real(g, "beta_bcg_s", 1.43)
        self.g_const_bcg = (G * m_bcg_s / (self.r_bcg_s ** 2)
                            if which_bcg == "HERNQUIST" else 0.0)
        self.rho_const_bcg = (m_bcg_s * self.r_bcg_s / (2 * math.pi)
                              if which_bcg == "HERNQUIST" else 0.0)

        m_smbh = pin.get_or_add_real(g, "m_smbh", 3.4e8 * units.msun())
        self.g_const_smbh = G * m_smbh
        self.smoothing_r = pin.get_or_add_real(g, "g_smoothing_radius", 0.0)

    def g_from_r(self, r_in):
        r, log = _floor_and_log(r_in, self.smoothing_r)
        r2 = r * r
        g_r = 0.0 * r
        if self.include_nfw:
            g_r = g_r + self.g_const_nfw * (
                log(1 + r / self.r_nfw_s) - r / (r + self.r_nfw_s)) / r2
        if self.which_bcg == "HERNQUIST":
            g_r = g_r + self.g_const_bcg / (
                (1 + r / self.r_bcg_s) ** 2)
        if self.include_smbh:
            g_r = g_r + self.g_const_smbh / r2
        return g_r

    def rho_from_r(self, r_in):
        r, _ = _floor_and_log(r_in, self.smoothing_r)
        rho = 0.0 * r
        if self.include_nfw:
            rho = rho + self.rho_const_nfw / (r * (r + self.r_nfw_s) ** 2)
        if self.which_bcg == "HERNQUIST":
            rho = rho + self.rho_const_bcg / (r * (r + self.r_bcg_s) ** 3)
        return rho


def gravitational_field_source(gravity: ClusterGravity, u, prim, beta_dt,
                               xb, yb, zb, r):
    """Radial-g momentum and energy source on ``u`` in place
    (``GravitationalFieldSrcTerm``, srcterms/gravitational_field.hpp:25-66):
    -rho g r_hat on the momenta, -rho g r_hat . v on the energy.  ``r`` is
    the cells' radius, kept with the coordinates by the caller."""
    g_r = gravity.g_from_r(r)
    den = prim[:, IDN]
    src = torch.where(r == 0.0, 0.0, beta_dt * den * g_r / torch.where(
        r == 0.0, 1.0, r))
    u[:, IM1] += -src * xb
    u[:, IM2] += -src * yb
    u[:, IM3] += -src * zb
    u[:, IEN] += -src * (xb * prim[:, IV1] + yb * prim[:, IV2]
                         + zb * prim[:, IV3])
    return u
