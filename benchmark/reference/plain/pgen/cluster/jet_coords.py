# A frozen copy of athenapk_tpu_torch/pgen/cluster/jet_coords.py for the benchmark's
# plain reference of the cluster; it imports nothing of the program.
"""Precessing jet coordinate frame (reference
``src/pgen/cluster/jet_coords.hpp:25,90``; counterpart of
``athenapk_tpu/pgen/cluster/jet_coords.py``): rotate simulation Cartesian
coordinates into a cylindrical frame aligned with the (time-precessing)
jet axis, set by theta (tilt) and phi(t) = phi0 + t * phi_dot.  ``t`` is
a Python float: the frame's trigonometry is host arithmetic."""

from __future__ import annotations

import math

import torch

from ...core.ieee import sqrt


class JetCoords:
    def __init__(self, pin, block="problem/cluster/precessing_jet"):
        self.theta = pin.get_or_add_real(block, "jet_theta", 0.0)
        self.phi_dot = pin.get_or_add_real(block, "jet_phi_dot", 0.0)
        self.phi0 = pin.get_or_add_real(block, "jet_phi0", 0.0)

    def _trig(self, t):
        phi = self.phi0 + float(t) * self.phi_dot
        return (math.cos(self.theta), math.sin(self.theta),
                math.cos(phi), math.sin(phi))

    def sim_to_jet(self, x, y, z, t):
        """-> (r_jet, cos_theta_jet, sin_theta_jet, h_jet)."""
        ct, st, cp, sp = self._trig(t)
        x_j = x * cp * ct + y * sp * ct - z * st
        y_j = -x * sp + y * cp
        z_j = x * st * cp + y * sp * st + z * ct
        r = sqrt(x_j ** 2 + y_j ** 2)
        safe = torch.where(r != 0, r, 1.0)
        cth = torch.where(r != 0, x_j / safe, 0.0)
        sth = torch.where(r != 0, y_j / safe, 0.0)
        return r, cth, sth, z_j

    def jet_vec_to_sim(self, cth, sth, v_r, v_th, v_h, t):
        """Cylindrical jet-frame vector -> simulation Cartesian."""
        ct, st, cp, sp = self._trig(t)
        v_x_j = v_r * cth - v_th * sth
        v_y_j = v_r * sth + v_th * cth
        v_z_j = v_h
        v_x = v_x_j * cp * ct - v_y_j * sp + v_z_j * st * cp
        v_y = v_x_j * sp * ct + v_y_j * cp + v_z_j * sp * st
        v_z = -v_x_j * st + v_z_j * ct
        return v_x, v_y, v_z
