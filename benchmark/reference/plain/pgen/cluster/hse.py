# A frozen copy of athenapk_tpu_torch/pgen/cluster/hse.py for the benchmark's
# plain reference of the cluster; it imports nothing of the program.
"""Hydrostatic-equilibrium sphere: integrate dP/dr = -rho(P, K(r)) g(r)
from a fixed anchor (r_fix, rho_fix) into a P(r) lookup profile (reference
``src/pgen/cluster/hydrostatic_equilibrium_sphere.hpp:34,153``;
counterpart of ``athenapk_tpu/pgen/cluster/hse.py``).

The electron-entropy link: P = K (rho/mh)^{5/3} / (mu mu_e^{2/3}),
rho = (mu P / K)^{3/5} mh mu_e^{2/5}.  Everything here runs on the host in
numpy float64: the RK4 integration outward and inward from r_fix walks
~1e4-1e5 radii one after another (dr = min dx / r_sampling), and the
lookup ``p_from_r`` is ``np.interp`` (torch has no ``interp``); a tensor
argument is read to the host and the result put back on its device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class PRhoProfile:
    def __init__(self, r, p, sphere):
        self.r = np.asarray(r)
        self.p = np.asarray(p)
        self.sphere = sphere

    def p_from_r(self, r):
        """P at radius ``r`` (a float, numpy array or tensor), linear
        between the profile's radii (``np.interp``)."""
        if torch.is_tensor(r):
            return torch.as_tensor(
                np.interp(r.cpu().numpy(), self.r, self.p),
                dtype=r.dtype, device=r.device)
        return np.interp(r, self.r, self.p)

    def rho_from_r(self, r):
        k = self.sphere.entropy.k_from_r(r)
        return self.sphere.rho_from_p_k(self.p_from_r(r), k)

    def write(self, fname):
        s = self.sphere
        with open(fname, "w") as fh, np.errstate(divide="ignore",
                                                 invalid="ignore"):
            for r, p in zip(self.r, self.p):
                k = float(s.entropy.k_from_r(r))
                rho = float(s.rho_from_p_k(p, k))
                n = rho / (s.mu * s.mh)
                ne = s.mu / s.mu_e * n
                temp = p / (n * s.k_boltzmann)
                g = float(s.gravity.g_from_r(r))
                fh.write(f"{r} {p} {k} {rho} {n} {ne} {temp} {g} "
                         f"{-rho * g}\n")


class HydrostaticEquilibriumSphere:
    def __init__(self, pin, units, gravity, entropy, mu, mu_e):
        self.gravity = gravity
        self.entropy = entropy
        self.mh = units.mh()
        self.k_boltzmann = units.k_boltzmann()
        self.mu = mu
        self.mu_e = mu_e
        h = "problem/cluster/hydrostatic_equilibrium"
        self.r_fix = pin.get_or_add_real(
            h, "r_fix", 1953.9724519818478 * units.kpc())
        self.rho_fix = pin.get_or_add_real(
            h, "rho_fix", 8.607065015897638e-30 * units.g()
            / units.kpc() ** 3)
        self.r_sampling = pin.get_or_add_real(h, "r_sampling", 4.0)

    # entropy <-> pressure/density links
    def p_from_rho_k(self, rho, k):
        return k * (rho / self.mh) ** (5.0 / 3.0) / (
            self.mu * self.mu_e ** (2.0 / 3.0))

    def rho_from_p_k(self, p, k):
        return (self.mu * p / k) ** 0.6 * self.mh * self.mu_e ** 0.4

    def _dp_dr(self, r, p):
        g = float(self.gravity.g_from_r(r))
        k = float(self.entropy.k_from_r(r))
        rho = self.rho_from_p_k(p, k)
        return -rho * g

    def generate_p_rho_profile(self, r_start, r_end, n_r) -> PRhoProfile:
        """RK4 outward and inward from the anchor (the reference's
        ``generate_P_rho_profile``)."""
        r = np.linspace(r_start, r_end, n_r)
        i_fix = int(np.argmin(np.abs(r - self.r_fix)))
        p = np.zeros(n_r)
        k_fix = float(self.entropy.k_from_r(r[i_fix]))
        p[i_fix] = self.p_from_rho_k(self.rho_fix, k_fix)

        def rk4(r0, r1, p0):
            h = r1 - r0
            k1 = self._dp_dr(r0, p0)
            k2 = self._dp_dr(r0 + h / 2, p0 + h / 2 * k1)
            k3 = self._dp_dr(r0 + h / 2, p0 + h / 2 * k2)
            k4 = self._dp_dr(r0 + h, p0 + h * k3)
            return p0 + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

        # g is singular at r = 0 (p[0] is not finite without smoothing,
        # as in the reference; no cell centre lies within dr of it)
        with np.errstate(divide="ignore", invalid="ignore"):
            for i in range(i_fix + 1, n_r):
                p[i] = rk4(r[i - 1], r[i], p[i - 1])
            for i in range(i_fix - 1, -1, -1):
                p[i] = rk4(r[i + 1], r[i], p[i + 1])
        return PRhoProfile(r, p, self)

    def profile_for_mesh(self, mesh) -> PRhoProfile:
        """Radial grid adapted to the mesh (1/r_sampling of min dx)."""
        dr = min(mesh.min_dx / self.r_sampling,
                 self.entropy.r_k / self.r_sampling)
        corners = [abs(v) for v in (mesh.x1min, mesh.x1max, mesh.x2min,
                                    mesh.x2max, mesh.x3min, mesh.x3max)]
        r_max = math.sqrt(3) * max(corners)
        r_end = max(r_max, self.r_fix) + self.r_sampling * dr
        r_start = 0.0
        n_r = int(math.ceil((r_end - r_start) / dr)) + 1
        return self.generate_p_rho_profile(r_start, r_end, n_r)
