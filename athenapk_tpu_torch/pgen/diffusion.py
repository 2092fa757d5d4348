"""Diffusion test problems (reference ``src/pgen/diffusion.cpp``; the JAX
package's ``pgen/diffusion.py``): step functions (iprob 0-2), Gaussian
profiles for conduction / viscosity / resistivity (10 / 30 / 40), and the
Sharma & Hammett ring (20-22).  numpy only, as every problem generator of
the port."""

from __future__ import annotations

import math

import numpy as np

from ..core.indices import (IDN, IM1, IM2, IM3, IEN, IB1, IB2, IB3, GLMMHD)


def problem_generator(pin, mesh, cfg, eos):
    p = "problem/diffusion"
    gamma = pin.get_real("hydro", "gamma")
    mhd = cfg.fluid == GLMMHD
    Bx = pin.get_or_add_real(p, "Bx", 0.0)
    By = pin.get_or_add_real(p, "By", 0.0)
    iprob = pin.get_integer(p, "iprob")
    if not mhd and iprob in (0, 1, 2, 10, 20, 40):
        raise ValueError(f"diffusion iprob={iprob} requires MHD")

    t0 = 0.5
    amp = 1e-6
    diff_coeff = 0.0
    if iprob in (10, 30, 40):
        t0 = pin.get_or_add_real(p, "t0", t0)
        amp = pin.get_or_add_real(p, "amp", amp)
    if iprob == 10:
        diff_coeff = pin.get_real("diffusion", "thermal_diff_coeff_code")
    elif iprob == 30:
        diff_coeff = pin.get_real("diffusion", "mom_diff_coeff_code")
    elif iprob == 40:
        diff_coeff = pin.get_real("diffusion", "ohm_diff_coeff_code")

    x, y, z = mesh.cell_centers_mesh()
    shape = (mesh.nblocks,) + mesh.block_shape
    xb = np.broadcast_to(x, shape)
    yb = np.broadcast_to(y, shape)
    zb = np.broadcast_to(z, shape)

    u = np.zeros((mesh.nblocks, cfg.nvar) + mesh.block_shape)
    u[:, IDN] = 1.0
    one = np.ones(shape)

    def gauss(coord, coeff):
        return amp / math.sqrt(4.0 * math.pi * coeff * t0) * np.exp(
            -(coord ** 2) / (4.0 * coeff * t0))

    if iprob == 0:
        u[:, IB1], u[:, IB2] = Bx, By
        eint = np.where(xb <= 0.0, 10.0, 12.0)
    elif iprob == 1:
        u[:, IB2], u[:, IB3] = Bx, By
        eint = np.where(yb <= 0.0, 10.0, 12.0)
    elif iprob == 2:
        u[:, IB3], u[:, IB1] = Bx, By
        eint = np.where(zb <= 0.0, 10.0, 12.0)
    elif iprob == 10:
        u[:, IB1], u[:, IB2] = Bx, By
        eff = diff_coeff if Bx == 0.0 else diff_coeff * Bx * Bx
        eint = 1.0 + gauss(xb, eff)
    elif iprob in (20, 21, 22):
        a, b = {20: (xb, yb), 21: (yb, zb), 22: (zb, xb)}[iprob]
        ib_a, ib_b = {20: (IB1, IB2), 21: (IB2, IB3), 22: (IB3, IB1)}[iprob]
        r = np.sqrt(a ** 2 + b ** 2)
        phi = np.arctan2(b, a)
        u[:, ib_a] = b / r
        u[:, ib_b] = -a / r
        eint = np.where((np.abs(r - 0.6) < 0.1)
                        & (np.abs(phi) < math.pi / 12.0), 12.0, 10.0)
    elif iprob == 30:
        u[:, IM2] = u[:, IDN] * gauss(xb, diff_coeff)
        eint = one / (gamma * (gamma - 1.0))
    elif iprob == 40:
        u[:, IB2] = gauss(xb, diff_coeff)
        eint = one / (gamma * (gamma - 1.0))
    else:
        raise ValueError(f"unknown diffusion iprob {iprob}")

    u[:, IEN] = (u[:, IDN] * eint
                 + 0.5 * (u[:, IM1] ** 2 + u[:, IM2] ** 2 + u[:, IM3] ** 2)
                 / u[:, IDN])
    if mhd:
        u[:, IEN] += 0.5 * (u[:, IB1] ** 2 + u[:, IB2] ** 2 + u[:, IB3] ** 2)
    return u
