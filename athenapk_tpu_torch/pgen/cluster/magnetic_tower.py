"""Magnetic tower injection (reference ``src/pgen/cluster/
magnetic_tower.hpp``; counterpart of ``athenapk_tpu/pgen/cluster/
magnetic_tower.py``): the Li et al. (2006) or donut potential in the jet
frame; fixed-field-rate or power-scaled injection.  The power-scaled form
solves the global quadratic for the field scale so that the injected
magnetic energy matches the requested power (the reference's linear and
quadratic contributions, ``hydro_driver.cpp:409-449``).

The partial sums and the field scale stay 0-d tensors on the state's
device: nothing here reads the host.  The injections update ``u`` in
place.
"""

from __future__ import annotations

import math

import torch

from ...core.ieee import sqrt
from ...core.indices import IB1, IB2, IB3, IDN, IEN


class MagneticTower:
    def __init__(self, pin, units, jet_coords,
                 block="problem/cluster/magnetic_tower"):
        self.jet_coords = jet_coords
        self.potential = pin.get_or_add_string(block, "potential_type", "li")
        self.alpha = pin.get_or_add_real(block, "li_alpha", 0.0) \
            if self.potential == "li" else 0.0
        self.l_scale = pin.get_or_add_real(block, "l_scale", 0.0)
        self.offset = pin.get_or_add_real(block, "offset", 0.0)
        self.thickness = pin.get_or_add_real(block, "thickness", 0.0)
        self.initial_field = pin.get_or_add_real(block, "initial_field", 0.0)
        self.fixed_field_rate = pin.get_or_add_real(block, "fixed_field_rate",
                                                    0.0)
        self.fixed_mass_rate = pin.get_or_add_real(block, "fixed_mass_rate",
                                                   0.0)
        self.l_mass_scale = pin.get_or_add_real(block, "l_mass_scale", 0.0)

    # -------------------------------------------------------------- field
    def unit_field(self, x, y, z, t):
        """Tower B for field_=1 in simulation Cartesian components
        (``MagneticTowerObj::FieldInSimCart``)."""
        if self.l_scale <= 0:
            z0 = torch.zeros_like(x + y + z)
            return z0, z0, z0
        jc = self.jet_coords
        r, cth, sth, h = jc.sim_to_jet(x, y, z, t)
        rl = r / self.l_scale
        hl = h / self.l_scale
        if self.potential == "donut":
            ex = torch.exp(-rl ** 2)
            in_slab = (torch.abs(h) >= self.offset) & (
                torch.abs(h) <= self.offset + self.thickness)
            b_r = torch.zeros_like(r)
            b_th = torch.where(in_slab, 2.0 * rl * ex, 0.0)
            b_h = torch.zeros_like(r)
        elif self.potential == "li":
            ex = torch.exp(-rl ** 2 - hl ** 2)
            b_r = 2.0 * hl * rl * ex
            b_th = self.alpha * rl * ex
            b_h = 2.0 * (1.0 - rl ** 2) * ex
        else:
            raise ValueError(f"unknown tower potential {self.potential}")
        return jc.jet_vec_to_sim(cth, sth, b_r, b_th, b_h, t)

    def radius(self, dtype):
        """The radius of the origin beyond which the field and the Gaussian
        mass are exactly 0 in ``dtype``: both carry exp(-(r^2 + h^2) / l^2),
        and the jet frame keeps r^2 + h^2 = x^2 + y^2 + z^2; exp(-q) is 0
        past q = -ln(the smallest subnormal), and 4 more leave it e^-4 of
        that.  The donut's field adds its slab's height."""
        fi = torch.finfo(dtype)
        q = -math.log(fi.tiny * fi.eps) + 4.0
        out = 0.0
        if self.l_scale > 0:
            out = self.l_scale * math.sqrt(q)
            if self.potential == "donut":
                out = math.hypot(out, self.offset + self.thickness)
        if self.l_mass_scale > 0.0:
            out = max(out, self.l_mass_scale * math.sqrt(q))
        return out

    def mass_profile(self, x, y, z, t):
        """The Gaussian of the mass injection, exp(-(r^2 + h^2) / l^2)."""
        r, _, _, h = self.jet_coords.sim_to_jet(x, y, z, t)
        return torch.exp(-(r ** 2 + h ** 2) / self.l_mass_scale ** 2)

    def _mass_source(self, u, x, y, z, t, mass_rate, beta_dt):
        """The Gaussian mass injection at ``mass_rate`` (the fixed rate
        where that is not positive; a float where nothing triggers, else a
        0-d tensor) into ``u[:, IDN]``."""
        if torch.is_tensor(mass_rate):
            rate = torch.where(mass_rate > 0.0, mass_rate,
                               self.fixed_mass_rate)
        else:
            rate = mass_rate if mass_rate > 0.0 else self.fixed_mass_rate
        norm = math.pi ** 1.5 * self.l_mass_scale ** 3
        dens = rate * self.mass_profile(x, y, z, t)
        u[:, IDN] += beta_dt * dens / norm

    # ------------------------------------------------------------- inject
    # The t=0 tower field lives in pgen._init_cons (``initial_field`` is
    # the field amplitude).

    def tower_partials(self, u, bt, cell_volume, valid=None,
                       partial=torch.sum):
        """(linear, quadratic) contributions of one leaf group to the
        global magnetic-energy quadratic dME = f*linear + f^2*quad (the
        reference's per-rank reduction, ``hydro_driver.cpp:409-449``).
        ``valid`` masks out ghost zones; ``cell_volume`` is per group;
        ``partial`` sums a field (one value per leaf with
        ``LeafSums.partial``)."""
        bx_t, by_t, bz_t = bt
        m = 1.0 if valid is None else valid
        linear = partial((u[:, IB1] * bx_t + u[:, IB2] * by_t
                          + u[:, IB3] * bz_t) * m) * cell_volume
        quad = 0.5 * partial((bx_t ** 2 + by_t ** 2 + bz_t ** 2) * m) \
            * cell_volume
        return linear, quad

    @staticmethod
    def scale_from_power(linear, quad, power, beta_dt):
        """Solve f*linear + f^2*quad = power*beta_dt for the field scale (a
        0-d tensor on the partials' device)."""
        target = power * beta_dt
        disc = sqrt(torch.clamp(linear ** 2 + 4 * quad * target,
                                min=0.0))
        return torch.where(quad > 0,
                           (-linear + disc) / (2 * torch.clamp(quad,
                                                               min=1e-300)),
                           0.0)

    def apply_scaled(self, u, f, bt, mass_rate, beta_dt, t, xb, yb, zb):
        """Inject dB = f * T(x) (and the Gaussian mass) into one leaf group,
        in place.  ``mass_rate`` may be a 0-d tensor (an AGN-triggered
        rate)."""
        bx_t, by_t, bz_t = bt
        db1, db2, db3 = f * bx_t, f * by_t, f * bz_t
        u[:, IEN] += (u[:, IB1] * db1 + u[:, IB2] * db2 + u[:, IB3] * db3
                      + 0.5 * (db1 ** 2 + db2 ** 2 + db3 ** 2))
        u[:, IB1] += db1
        u[:, IB2] += db2
        u[:, IB3] += db3
        if self.l_mass_scale > 0.0:
            self._mass_source(u, xb, yb, zb, t, mass_rate, beta_dt)
        return u
