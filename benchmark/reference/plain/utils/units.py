# A frozen copy of athenapk_tpu_torch/utils/units.py for the benchmark's plain
# reference of the cluster; it imports nothing of the program.
"""Code <-> physical (CGS) unit conversions (reference ``src/units.hpp``).

A copy of ``athenapk_tpu/utils/units.py`` (plain Python, ``math`` only):
the port imports nothing of the JAX package.

Three base scales (length/mass/time in cgs) define every derived
conversion; physical constants are stored in cgs and exposed in code units.
Values match the reference's constants (which follow yt's definitions).
"""

from __future__ import annotations

import math


class Units:
    # cgs constants
    KEV_CGS = 1.60218e-9                      # erg
    G_CGS = 1.0                               # g
    CM_CGS = 1.0
    CM_S_CGS = 1.0
    KM_S_CGS = 1.0e5
    KPC_CGS = 3.0856775809623245e+21
    MPC_CGS = 3.0856775809623245e+24
    S_CGS = 1.0
    YR_CGS = 3.15576e+7
    MYR_CGS = 3.15576e+13
    DYNE_CM2_CGS = 1.0
    MSUN_CGS = 1.98841586e+33
    ATOMIC_MASS_UNIT_CGS = 1.660538921e-24
    ELECTRON_MASS_CGS = 9.1093837015e-28
    G_CM3_CGS = 1.0
    ERG_CGS = 1.0
    GAUSS_CGS = 1.0
    MICROGAUSS_CGS = 1.0e-6
    MH_CGS = 1.007947 * ATOMIC_MASS_UNIT_CGS  # matches yt
    K_BOLTZMANN_CGS = 1.3806488e-16
    GRAVITATIONAL_CONSTANT_CGS = 6.67408e-08
    SPEED_OF_LIGHT_CGS = 2.99792458e10

    def __init__(self, pin=None, code_length_cgs=1.0, code_mass_cgs=1.0,
                 code_time_cgs=1.0):
        if pin is not None:
            code_length_cgs = pin.get_or_add_real("units", "code_length_cgs", 1.0)
            code_mass_cgs = pin.get_or_add_real("units", "code_mass_cgs", 1.0)
            code_time_cgs = pin.get_or_add_real("units", "code_time_cgs", 1.0)
        self.code_length_cgs = code_length_cgs
        self.code_mass_cgs = code_mass_cgs
        self.code_time_cgs = code_time_cgs

    # derived code-unit scales (cgs value of one code unit)
    @property
    def code_energy_cgs(self):
        return (self.code_mass_cgs * self.code_length_cgs ** 2
                / self.code_time_cgs ** 2)

    @property
    def code_density_cgs(self):
        return self.code_mass_cgs / self.code_length_cgs ** 3

    @property
    def code_pressure_cgs(self):
        return self.code_energy_cgs / self.code_length_cgs ** 3

    @property
    def code_entropy_kev_cm2(self):
        return self.code_energy_cgs / self.KEV_CGS * self.code_length_cgs ** 2

    @property
    def code_magnetic_cgs(self):
        return (math.sqrt(4.0 * math.pi) * math.sqrt(self.code_mass_cgs)
                / math.sqrt(self.code_length_cgs) / self.code_time_cgs)

    # physical quantities expressed in code units
    def k_boltzmann(self):
        return self.K_BOLTZMANN_CGS / self.code_energy_cgs

    def gravitational_constant(self):
        return self.GRAVITATIONAL_CONSTANT_CGS / (
            self.code_length_cgs ** 3
            / (self.code_mass_cgs * self.code_time_cgs ** 2))

    def speed_of_light(self):
        return self.SPEED_OF_LIGHT_CGS / (self.code_length_cgs
                                          / self.code_time_cgs)

    def kev(self):
        return self.KEV_CGS / self.code_energy_cgs

    def g(self):
        return self.G_CGS / self.code_mass_cgs

    def cm(self):
        return self.CM_CGS / self.code_length_cgs

    def cm_s(self):
        return self.CM_S_CGS / (self.code_length_cgs / self.code_time_cgs)

    def km_s(self):
        return self.KM_S_CGS / (self.code_length_cgs / self.code_time_cgs)

    def kpc(self):
        return self.KPC_CGS / self.code_length_cgs

    def mpc(self):
        return self.MPC_CGS / self.code_length_cgs

    def s(self):
        return self.S_CGS / self.code_time_cgs

    def yr(self):
        return self.YR_CGS / self.code_time_cgs

    def myr(self):
        return self.MYR_CGS / self.code_time_cgs

    def dyne_cm2(self):
        return self.DYNE_CM2_CGS / self.code_pressure_cgs

    def msun(self):
        return self.MSUN_CGS / self.code_mass_cgs

    def atomic_mass_unit(self):
        return self.ATOMIC_MASS_UNIT_CGS / self.code_mass_cgs

    def mh(self):
        return self.MH_CGS / self.code_mass_cgs

    def electron_mass(self):
        return self.ELECTRON_MASS_CGS / self.code_mass_cgs

    def g_cm3(self):
        return self.G_CM3_CGS / self.code_density_cgs

    def erg(self):
        return self.ERG_CGS / self.code_energy_cgs

    def gauss(self):
        return self.GAUSS_CGS / self.code_magnetic_cgs

    def microgauss(self):
        return self.MICROGAUSS_CGS / self.code_magnetic_cgs


def mean_molecular_weights(he_mass_fraction: float):
    """(mu, mu_e) for fully ionized H/He plasma
    (reference ``src/hydro/hydro.cpp:491-494``)."""
    x = he_mass_fraction
    mu = 1.0 / (x * 3.0 / 4.0 + (1.0 - x) * 2.0)
    mu_e = 1.0 / (x * 2.0 / 4.0 + (1.0 - x))
    return mu, mu_e
