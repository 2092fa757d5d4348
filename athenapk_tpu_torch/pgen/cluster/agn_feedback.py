"""AGN feedback: kinetic jet + thermal dump + magnetic tower fractions
(reference ``src/pgen/cluster/agn_feedback.cpp``; counterpart of
``athenapk_tpu/pgen/cluster/agn_feedback.py``).

Power = fixed_power + efficiency * Mdot * c^2 (Mdot from AGNTriggering);
mass rate = Mdot (1 - efficiency) + fixed_power / (efficiency c^2).
Thermal: a uniform energy and mass dump inside thermal_radius.  Kinetic:
paired jet slabs (radius, thickness, offset in the precessing jet frame)
receive density, momentum and energy.  Magnetic: the power-scaled tower.

``apply_groups`` serves both meshes: one group on a uniform mesh, one per
level on a refined one.  The rate, the power and the tower's scale are
0-d tensors on the state's device (Python floats where nothing
triggers); the injections update each group's ``u`` in place.  Inside
the caller's ``agn_feedback`` range, the triggering's partials, rate and
mass removal run in ``agn_triggering`` ranges and the tower's field,
partials, scale and injection in ``magnetic_tower`` ranges.
"""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from ...core.indices import IDN, IEN, IM1, IM2, IM3, NGLMMHD, NHYDRO
from . import regions


def where0(cond, val, like):
    """``val`` (a float or a 0-d tensor) where ``cond``, else 0, in the
    dtype of ``like``."""
    return torch.where(cond, torch.as_tensor(val, dtype=like.dtype,
                                             device=like.device), 0.0)


class _PlainSums:
    """A uniform mesh's sums: ``torch.sum`` over a group, the groups'
    partials added in order."""

    partial = staticmethod(torch.sum)

    @staticmethod
    def total(parts):
        return {k: sum(p[k] for _, p in parts) for k in parts[0][1]}


PLAIN_SUMS = _PlainSums()


class AGNFeedback:
    def __init__(self, pin, units, jet_coords, magnetic_tower,
                 mbar_over_kb, gamma, block="problem/cluster/agn_feedback"):
        self.fixed_power = pin.get_or_add_real(block, "fixed_power", 0.0)
        self.efficiency = pin.get_or_add_real(block, "efficiency", 1e-3)
        self.thermal_fraction = pin.get_or_add_real(block,
                                                    "thermal_fraction", 0.0)
        self.kinetic_fraction = pin.get_or_add_real(block,
                                                    "kinetic_fraction", 0.0)
        self.magnetic_fraction = pin.get_or_add_real(block,
                                                     "magnetic_fraction", 0.0)
        total = (self.thermal_fraction + self.kinetic_fraction
                 + self.magnetic_fraction)
        if total > 0:
            self.thermal_fraction /= total
            self.kinetic_fraction /= total
            self.magnetic_fraction /= total
        if (self.thermal_fraction < 0 or self.kinetic_fraction < 0
                or self.magnetic_fraction < 0):
            raise ValueError("AGN feedback energy fractions must be "
                             "non-negative")
        # mass deposition fractions: by default the energy fractions;
        # without tower mass injection, renormalised over thermal+kinetic
        # (agn_feedback.cpp:57-82)
        if pin.get_or_add_bool(block, "enable_magnetic_tower_mass_injection",
                               True):
            self.thermal_mass_fraction = self.thermal_fraction
            self.kinetic_mass_fraction = self.kinetic_fraction
            self.magnetic_mass_fraction = self.magnetic_fraction
        else:
            tk = self.thermal_fraction + self.kinetic_fraction
            tk = tk if tk > 0 else 1.0
            self.thermal_mass_fraction = self.thermal_fraction / tk
            self.kinetic_mass_fraction = self.kinetic_fraction / tk
            self.magnetic_mass_fraction = 0.0
        # passive-scalar AGN tracer: jet-launching cells get concentration
        # 1 (agn_feedback.cpp:374-376)
        self.enable_tracer = pin.get_or_add_bool(block, "enable_tracer",
                                                 False)
        if self.enable_tracer and pin.get_or_add_integer(
                "hydro", "nscalars", 0) != 1:
            raise ValueError("Enabling tracer for AGN feedback requires "
                             "hydro/nscalars=1 (agn_feedback.cpp:181)")
        self.thermal_radius = pin.get_or_add_real(block, "thermal_radius",
                                                  0.01)
        self.kinetic_jet_radius = pin.get_or_add_real(
            block, "kinetic_jet_radius", 0.01)
        self.kinetic_jet_thickness = pin.get_or_add_real(
            block, "kinetic_jet_thickness", 0.02)
        self.kinetic_jet_offset = pin.get_or_add_real(
            block, "kinetic_jet_offset", 0.02)
        # jet velocity/temperature pair (either may be derived)
        c = units.speed_of_light()
        kjt = pin.get_or_add_real(block, "kinetic_jet_temperature", -1.0)
        kjv = pin.get_or_add_real(block, "kinetic_jet_velocity", -1.0)
        gm1 = gamma - 1.0
        if kjv < 0 and kjt >= 0:
            e_jet = kjt / (mbar_over_kb * gm1)
            kjv = math.sqrt(max(2 * (self.efficiency * c * c
                                     - (1 - self.efficiency) * e_jet), 0.0))
        elif kjv >= 0:
            e_jet = max(self.efficiency * c * c
                        - 0.5 * kjv ** 2, 0.0) / max(1 - self.efficiency,
                                                     1e-300)
        else:
            kjv = math.sqrt(2 * self.efficiency) * c
            e_jet = 0.0
        self.kinetic_jet_velocity = kjv
        self.kinetic_jet_e = e_jet
        self.disabled = pin.get_or_add_bool(block, "disabled", False)
        self.jet_coords = jet_coords
        self.magnetic_tower = magnetic_tower
        self.units = units
        self.gamma = gamma
        self.triggering = None  # set by the pgen when a mode is configured

    def power_and_mass_rate(self, mdot):
        c2 = self.units.speed_of_light() ** 2
        power = self.fixed_power + mdot * self.efficiency * c2
        mass_rate = mdot * (1 - self.efficiency)
        if self.efficiency > 0:
            mass_rate = mass_rate + self.fixed_power / (self.efficiency * c2)
        return power, mass_rate

    def active(self):
        """Does any channel inject?  A tower with only fixed_field_rate
        injects without fixed_power or triggering (the reference declares
        this path, ``magnetic_tower.cpp:243-254`` FixedFieldSrcTerm, though
        its AGN task list never calls it; the JAX package makes it
        live)."""
        fixed_field = (self.magnetic_fraction > 0
                       and self.magnetic_tower is not None
                       and self.magnetic_tower.fixed_field_rate != 0.0)
        return not self.disabled and (self.fixed_power != 0.0
                                      or self.triggering is not None
                                      or fixed_field)

    def apply_groups(self, groups, beta_dt, t, mhd, sums=None):
        """AGN feedback over leaf groups (one per refinement level on a
        refined mesh, one on a uniform mesh), each a dict with ``u, prim,
        x, y, z, r, vol, valid`` (``vol`` that group's cell volume,
        ``valid`` its interior mask or None) and, with ``sums``, its
        ``level``.  The global reductions (the accretion rate, the tower's
        energy quadratic, the Bondi region's mass) are volume-weighted sums
        of per-group partials: the cross-level analog of the reference's
        MPI_Allreduce (``hydro_driver.cpp:360-449``).  ``sums`` takes them
        (``partial(field)``, ``total([(level, {name: partial})])``): by
        default ``torch.sum`` per group added across groups; on a refined
        mesh ``amr.leaf_sums.LeafSums``, per leaf in global leaf order and
        over ranks, all of a call's partials in one ``total``.  A group
        that offers ``box`` runs each channel (thermal, kinetic, the
        triggering's region, the tower) on the index box of its sphere
        (``regions.of``).  Updates each ``u`` in place; returns them in
        group order."""
        if not self.active():
            return [g["u"] for g in groups]
        sums = PLAIN_SUMS if sums is None else sums
        trig = self.triggering
        tw = self.magnetic_tower
        triggered = trig is not None and trig.mode != "NONE"
        tower = mhd and self.magnetic_fraction > 0
        scaled = tower and (self.fixed_power > 0 or trig is not None)
        # the Bondi modes' mass removal needs the global region mass
        bondi_mass = (trig is not None and trig.mode not in ("NONE",
                                                             "COLD_GAS")
                      and trig.remove_mass)
        # each channel on the index box of its sphere (``regions``)
        dtype = groups[0]["u"].dtype
        trig_g = [regions.of(g, "agn_triggering", trig.accretion_radius)
                  for g in groups] if trig is not None else None
        tower_g = tower_bt = None
        if tower:
            tower_g = [regions.of(g, "magnetic_tower", tw.radius(dtype))
                       for g in groups]
            with record_function("magnetic_tower"):
                tower_bt = [tw.unit_field(g["x"], g["y"], g["z"], t)
                            for g in tower_g]

        # every partial of the call, then their totals at once
        parts = []
        for gi, g in enumerate(groups):
            p = {}
            if triggered:
                ga = trig_g[gi]
                with record_function("agn_triggering"):
                    p.update(trig.accretion_partials(
                        ga["prim"], ga["r"], ga["vol"], ga["valid"],
                        sums.partial))
            if scaled:
                gt = tower_g[gi]
                with record_function("magnetic_tower"):
                    p["tower_linear"], p["tower_quad"] = tw.tower_partials(
                        gt["u"], tower_bt[gi], gt["vol"], gt["valid"],
                        sums.partial)
            if bondi_mass:
                ga = trig_g[gi]
                with record_function("agn_triggering"):
                    p["region_mass"] = trig.region_mass(
                        ga["prim"], ga["r"], ga["vol"], ga["valid"],
                        sums.partial)
            parts.append((g.get("level"), p))
        totals = sums.total(parts) if parts[0][1] else {}

        mdot = 0.0
        if triggered:
            with record_function("agn_triggering"):
                mdot = trig.rate_from_partials(totals)
        power, mass_rate = self.power_and_mass_rate(mdot)
        tower_f = None
        if scaled:
            with record_function("magnetic_tower"):
                tower_f = tw.scale_from_power(
                    totals["tower_linear"], totals["tower_quad"],
                    self.magnetic_fraction * power, beta_dt)
        elif tower:
            tower_f = tw.fixed_field_rate * beta_dt
        region_mass = totals.get("region_mass")

        for gi, g in enumerate(groups):
            if self.thermal_fraction > 0:
                gh = regions.of(g, "agn_thermal", self.thermal_radius)
                self._thermal(gh["u"], gh["r"], power, mass_rate, beta_dt)
            if self.kinetic_fraction > 0:
                gk = regions.of(g, "agn_kinetic", self.kinetic_radius())
                self._kinetic(gk["u"], gk["x"], gk["y"], gk["z"], t, power,
                              mass_rate, beta_dt, mhd)
            if tower_f is not None:
                gt = tower_g[gi]
                with record_function("magnetic_tower"):
                    self.magnetic_tower.apply_scaled(
                        gt["u"], tower_f, tower_bt[gi],
                        self.magnetic_mass_fraction * mass_rate, beta_dt, t,
                        gt["x"], gt["y"], gt["z"])
            if trig is not None:
                ga = trig_g[gi]
                with record_function("agn_triggering"):
                    trig.remove_accreted(ga["u"], ga["prim"], ga["r"], mdot,
                                         beta_dt, region_mass=region_mass)
        return [g["u"] for g in groups]

    def kinetic_radius(self):
        """The radius of the origin that holds the jet slabs."""
        return math.hypot(self.kinetic_jet_radius,
                          self.kinetic_jet_offset + self.kinetic_jet_thickness)

    def _thermal(self, u, r, power, mass_rate, beta_dt):
        """The thermal dump inside thermal_radius: energy, and mass added
        at fixed velocity (momenta scaled, kinetic energy added)."""
        vol = 4.0 / 3.0 * math.pi * self.thermal_radius ** 3
        de = self.thermal_fraction * power / vol * beta_dt
        drho = self.thermal_mass_fraction * mass_rate / vol * beta_dt
        inside = r ** 2 <= self.thermal_radius ** 2
        u[:, IEN] += where0(inside, de, u)
        rho = u[:, IDN].clone()
        fac = torch.where(inside, (rho + drho) / rho, 1.0)
        ke_old = 0.5 * (u[:, IM1] ** 2 + u[:, IM2] ** 2
                        + u[:, IM3] ** 2) / rho
        u[:, IDN] += where0(inside, drho, u)
        for c in (IM1, IM2, IM3):
            u[:, c] *= fac
        u[:, IEN] += torch.where(inside, ke_old * (fac - 1.0), 0.0)

    def _kinetic(self, u, xb, yb, zb, t, power, mass_rate, beta_dt, mhd):
        """The paired jet slabs: density, momentum along the jet axis
        (away from the launch plane) and energy; with ``enable_tracer`` the
        passive scalar of all material in the slabs reset to concentration
        1 (agn_feedback.cpp:371-376)."""
        jc = self.jet_coords
        rj, cth, sth, h = jc.sim_to_jet(xb, yb, zb, t)
        habs = torch.abs(h)
        in_jet = ((rj < self.kinetic_jet_radius)
                  & (habs >= self.kinetic_jet_offset)
                  & (habs <= self.kinetic_jet_offset
                     + self.kinetic_jet_thickness))
        scal = 1.0 / (2 * self.kinetic_jet_thickness * math.pi
                      * self.kinetic_jet_radius ** 2)
        jet_density = self.kinetic_mass_fraction * mass_rate * scal * beta_dt
        jet_momentum = jet_density * self.kinetic_jet_velocity
        jet_feedback = self.kinetic_fraction * power * scal * beta_dt
        ax, ay, az = jc.jet_vec_to_sim(cth, sth, 0.0, 0.0,
                                       torch.ones_like(h), t)
        sign = torch.where(h > 0, 1.0, -1.0).to(u.dtype)
        u[:, IDN] += where0(in_jet, jet_density, u)
        u[:, IM1] += torch.where(in_jet, jet_momentum * sign * ax, 0.0)
        u[:, IM2] += torch.where(in_jet, jet_momentum * sign * ay, 0.0)
        u[:, IM3] += torch.where(in_jet, jet_momentum * sign * az, 0.0)
        u[:, IEN] += where0(in_jet, jet_feedback, u)
        if self.enable_tracer:
            si = NGLMMHD if mhd else NHYDRO
            u[:, si] = torch.where(in_jet, u[:, IDN], u[:, si])

