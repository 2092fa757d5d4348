# A frozen copy of athenapk_tpu_torch/pgen/_linwave_common.py for the benchmark's plain
# reference (uniform meshes only); it imports nothing of the program.
"""Shared machinery for the linear-wave convergence problems.

Implements the standard adiabatic hydro / MHD Roe eigensystems (Roe 1981;
Roe & Balsara 1996; as catalogued in Stone et al. 2008, ApJS 178, 137,
appendix A/B) used to seed single-eigenmode perturbations, plus the oblique
wavevector geometry and the ``linearwave-errors.dat`` error protocol of the
reference (``src/pgen/linear_wave.cpp``, ``src/pgen/linear_wave_mhd.cpp`` —
the convergence suites' north star).
"""

from __future__ import annotations

import math

import numpy as np

TINY = 1.0e-20


class WaveGeometry:
    """Oblique wavevector setup (reference ``InitUserMeshData``): rotation
    angles chosen so an integer number of wavelengths fits the domain."""

    def __init__(self, pin, mhd: bool):
        p = "problem/linear_wave"
        self.wave_flag = pin.get_integer(p, "wave_flag")
        self.amp = pin.get_real(p, "amp")
        self.vflow = pin.get_or_add_real(p, "vflow", 0.0)
        ang_2 = pin.get_or_add_real(p, "ang_2", -999.9)
        ang_3 = pin.get_or_add_real(p, "ang_3", -999.9)
        ang_2_vert = pin.get_or_add_bool(p, "ang_2_vert", False)
        ang_3_vert = pin.get_or_add_bool(p, "ang_3_vert", False)
        gam = pin.get_real("hydro", "gamma")
        self.gamma = gam
        gm1 = gam - 1.0

        mb = "parthenon/mesh"
        x1size = pin.get_real(mb, "x1max") - pin.get_real(mb, "x1min")
        x2size = pin.get_real(mb, "x2max") - pin.get_real(mb, "x2min")
        x3size = pin.get_real(mb, "x3max") - pin.get_real(mb, "x3min")

        if ang_3 == -999.9:
            ang_3 = math.atan(x1size / x2size)
        sin_a3, cos_a3 = math.sin(ang_3), math.cos(ang_3)
        if ang_3_vert:
            sin_a3, cos_a3, ang_3 = 1.0, 0.0, 0.5 * math.pi
        if ang_2 == -999.9:
            ang_2 = math.atan(0.5 * (x1size * cos_a3 + x2size * sin_a3) / x3size)
        sin_a2, cos_a2 = math.sin(ang_2), math.cos(ang_2)
        if ang_2_vert:
            sin_a2, cos_a2, ang_2 = 1.0, 0.0, 0.5 * math.pi

        x1 = x1size * cos_a2 * cos_a3
        x2 = x2size * cos_a2 * sin_a3
        x3 = x3size * sin_a2
        f2 = pin.get_integer(mb, "nx2") > 1
        f3 = pin.get_integer(mb, "nx3") > 1
        lam = x1
        if f2 and ang_3 != 0.0:
            lam = min(lam, x2)
        if f3 and ang_2 != 0.0:
            lam = min(lam, x3)
        if ang_3_vert:
            lam = x2
        if ang_2_vert:
            lam = x3

        self.sin_a2, self.cos_a2 = sin_a2, cos_a2
        self.sin_a3, self.cos_a3 = sin_a3, cos_a3
        self.lam = lam
        self.k_par = 2.0 * math.pi / lam

        # background state (wave-frame): u0 || k, (v0,w0) perpendicular
        self.d0 = 1.0
        self.p0 = 1.0 / gam
        self.u0 = self.vflow
        h0 = ((self.p0 / gm1 + 0.5 * self.d0 * self.u0 ** 2) + self.p0) / self.d0
        if mhd:
            self.bx0 = 1.0
            self.by0 = math.sqrt(2.0)
            self.bz0 = 0.5
            h0 += (self.bx0 ** 2 + self.by0 ** 2 + self.bz0 ** 2) / self.d0
            self.ev, self.rem = mhd_eigensystem(
                gam, self.d0, self.u0, 0.0, 0.0, h0,
                self.bx0, self.by0, self.bz0, 0.0, 1.0)
        else:
            self.ev, self.rem = hydro_eigensystem(gam, self.d0, self.u0,
                                                  0.0, 0.0, h0)

        # test=true: reinterpret tlim as number of wave periods
        if pin.get_or_add_bool(p, "test", False):
            tlim = pin.get_real("parthenon/time", "tlim")
            pin.set("parthenon/time", "tlim",
                    lam / abs(self.ev[self.wave_flag]) * tlim)

    def wave_phase(self, x1, x2, x3):
        """Distance along k (broadcasts block coordinate arrays)."""
        return (self.cos_a2 * (x1 * self.cos_a3 + x2 * self.sin_a3)
                + x3 * self.sin_a2)

    def rotate_to_grid(self, mx, my, mz):
        """Wave-frame vector -> grid frame (inverse rotation)."""
        m1 = (mx * self.cos_a2 * self.cos_a3 - my * self.sin_a3
              - mz * self.sin_a2 * self.cos_a3)
        m2 = (mx * self.cos_a2 * self.sin_a3 + my * self.cos_a3
              - mz * self.sin_a2 * self.sin_a3)
        m3 = mx * self.sin_a2 + mz * self.cos_a2
        return m1, m2, m3


def hydro_eigensystem(gam, d, v1, v2, v3, h):
    """Adiabatic hydro eigenvalues + right eigenvectors (Roe 1981;
    Stone et al. 2008 eq. B2-B3).  Columns of rem are waves, rows are
    conserved components [d, mx, my, mz, E]."""
    gm1 = gam - 1.0
    vsq = v1 * v1 + v2 * v2 + v3 * v3
    asq = gm1 * max(h - 0.5 * vsq, TINY)
    a = math.sqrt(asq)
    ev = np.array([v1 - a, v1, v1, v1, v1 + a])
    rem = np.zeros((5, 5))
    rem[:, 0] = [1.0, v1 - a, v2, v3, h - v1 * a]
    rem[:, 1] = [0.0, 0.0, 1.0, 0.0, v2]
    rem[:, 2] = [0.0, 0.0, 0.0, 1.0, v3]
    rem[:, 3] = [1.0, v1, v2, v3, 0.5 * vsq]
    rem[:, 4] = [1.0, v1 + a, v2, v3, h + v1 * a]
    return ev, rem


def mhd_eigensystem(gam, d, v1, v2, v3, h, b1, b2, b3, x, y):
    """Adiabatic MHD eigenvalues + right eigenvectors (Roe & Balsara 1996;
    Stone et al. 2008 appendix B eqs. B17-B21).  7 waves; rows are
    [d, mx, my, mz, E, By, Bz]."""
    gm1 = gam - 1.0
    vsq = v1 * v1 + v2 * v2 + v3 * v3
    btsq = b2 * b2 + b3 * b3
    bt_starsq = (gm1 - (gm1 - 1.0) * y) * btsq
    vaxsq = b1 * b1 / d
    hp = h - (vaxsq + btsq / d)
    twid_asq = max(gm1 * (hp - 0.5 * vsq) - (gm1 - 1.0) * x, TINY)

    # fast/slow speeds (B18)
    ct2 = bt_starsq / d
    tsum = vaxsq + ct2 + twid_asq
    tdif = vaxsq + ct2 - twid_asq
    cf2_cs2 = math.sqrt(tdif * tdif + 4.0 * twid_asq * ct2)
    cfsq = 0.5 * (tsum + cf2_cs2)
    cf = math.sqrt(cfsq)
    cssq = twid_asq * vaxsq / cfsq
    cs = math.sqrt(cssq)

    # beta's (A17, B20, B28)
    bt = math.sqrt(btsq)
    bt_star = math.sqrt(bt_starsq)
    if bt == 0.0:
        bet2, bet3 = 1.0, 0.0
    else:
        bet2, bet3 = b2 / bt, b3 / bt
    gfac = math.sqrt(gm1 - (gm1 - 1.0) * y)
    bet2_star = bet2 / gfac
    bet3_star = bet3 / gfac
    bet_starsq = bet2_star ** 2 + bet3_star ** 2
    vbet = v2 * bet2_star + v3 * bet3_star

    # alpha's (A16)
    if (cfsq - cssq) == 0.0:
        alpha_f, alpha_s = 1.0, 0.0
    elif (twid_asq - cssq) <= 0.0:
        alpha_f, alpha_s = 0.0, 1.0
    elif (cfsq - twid_asq) <= 0.0:
        alpha_f, alpha_s = 1.0, 0.0
    else:
        alpha_f = math.sqrt((twid_asq - cssq) / (cfsq - cssq))
        alpha_s = math.sqrt((cfsq - twid_asq) / (cfsq - cssq))

    # Q's, A's (A14-A15)
    sqrtd = math.sqrt(d)
    isqrtd = 1.0 / sqrtd
    s = 1.0 if b1 >= 0.0 else -1.0
    twid_a = math.sqrt(twid_asq)
    qf = cf * alpha_f * s
    qs = cs * alpha_s * s
    af_prime = twid_a * alpha_f * isqrtd
    as_prime = twid_a * alpha_s * isqrtd
    afpbb = af_prime * bt_star * bet_starsq
    aspbb = as_prime * bt_star * bet_starsq

    vax = math.sqrt(vaxsq)
    ev = np.array([v1 - cf, v1 - vax, v1 - cs, v1,
                   v1 + cs, v1 + vax, v1 + cf])

    rem = np.zeros((7, 7))
    # density row
    rem[0] = [alpha_f, 0.0, alpha_s, 1.0, alpha_s, 0.0, alpha_f]
    # normal momentum
    rem[1] = [alpha_f * ev[0], 0.0, alpha_s * ev[2], v1,
              alpha_s * ev[4], 0.0, alpha_f * ev[6]]
    # transverse momentum y
    qa = alpha_f * v2
    qb = alpha_s * v2
    qc = qs * bet2_star
    qd = qf * bet2_star
    rem[2] = [qa + qc, -bet3, qb - qd, v2, qb + qd, bet3, qa - qc]
    # transverse momentum z
    qa = alpha_f * v3
    qb = alpha_s * v3
    qc = qs * bet3_star
    qd = qf * bet3_star
    rem[3] = [qa + qc, bet2, qb - qd, v3, qb + qd, -bet2, qa - qc]
    # energy
    rem[4] = [alpha_f * (hp - v1 * cf) + qs * vbet + aspbb,
              -(v2 * bet3 - v3 * bet2),
              alpha_s * (hp - v1 * cs) - qf * vbet - afpbb,
              0.5 * vsq + (gm1 - 1.0) * x / gm1,
              alpha_s * (hp + v1 * cs) + qf * vbet - afpbb,
              (v2 * bet3 - v3 * bet2),
              alpha_f * (hp + v1 * cf) - qs * vbet + aspbb]
    # By
    rem[5] = [as_prime * bet2_star, -bet3 * s * isqrtd,
              -af_prime * bet2_star, 0.0,
              -af_prime * bet2_star, -bet3 * s * isqrtd,
              as_prime * bet2_star]
    # Bz
    rem[6] = [as_prime * bet3_star, bet2 * s * isqrtd,
              -af_prime * bet3_star, 0.0,
              -af_prime * bet3_star, bet2 * s * isqrtd,
              as_prime * bet3_star]
    return ev, rem


