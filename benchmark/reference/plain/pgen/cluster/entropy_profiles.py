# A frozen copy of athenapk_tpu_torch/pgen/cluster/entropy_profiles.py for the benchmark's
# plain reference of the cluster; it imports nothing of the program.
"""ACCEPT-style entropy profile K(r) = K0 + K100 (r/r_k)^alpha (reference
``src/pgen/cluster/entropy_profiles.hpp``; Cavagnolo et al. 2009 ACCEPT
catalogue parameterisation).  Counterpart of
``athenapk_tpu/pgen/cluster/entropy_profiles.py``; ``k_from_r`` takes a
float, a numpy array or a tensor."""

from __future__ import annotations

from ...utils.units import Units


class ACCEPTEntropyProfile:
    def __init__(self, pin, units: Units):
        e = "problem/cluster/entropy_profile"
        kev_cm2 = units.kev() * units.cm() ** 2
        self.k_0 = pin.get_or_add_real(e, "k_0", 20 * kev_cm2)
        self.k_100 = pin.get_or_add_real(e, "k_100", 120 * kev_cm2)
        self.r_k = pin.get_or_add_real(e, "r_k", 100 * units.kpc())
        self.alpha_k = pin.get_or_add_real(e, "alpha_k", 1.75)

    def k_from_r(self, r):
        return self.k_0 + self.k_100 * (r / self.r_k) ** self.alpha_k
