"""Kelvin-Helmholtz instability (reference ``src/pgen/kh.cpp``): iprob 2-5
flavors incl. the Lecoanet et al. (2016) smooth setup (iprob=4, the one the
reference's ``kh-shear-lecoanet_2d.in`` deck drives)."""

from __future__ import annotations

import math

import numpy as np

from ..core.indices import IDN, IM1, IM2, IM3, IEN


def problem_generator(pin, mesh, cfg, eos):
    p = "problem/kh"
    vflow = pin.get_real(p, "vflow")
    iprob = pin.get_integer(p, "iprob")
    gm1 = pin.get_real("hydro", "gamma") - 1.0

    x, y, _ = mesh.cell_centers_mesh()
    shape = (mesh.nblocks,) + mesh.block_shape
    xb = np.broadcast_to(x, shape)
    yb = np.broadcast_to(y, shape)
    u = np.zeros((mesh.nblocks, cfg.nvar) + mesh.block_shape)
    tp = 2.0 * math.pi

    if iprob == 2:
        amp = pin.get_real(p, "amp")
        a, sigma = 0.02, 0.2
        u[:, IDN] = 1.0
        u[:, IM1] = vflow * np.tanh(yb / a)
        u[:, IM2] = amp * np.cos(tp * xb) * np.exp(-(yb ** 2) / sigma ** 2)
        u[:, IEN] = 1.0 / gm1 + 0.5 * (u[:, IM1] ** 2 + u[:, IM2] ** 2)
    elif iprob == 3:
        amp = pin.get_real(p, "amp")
        a, sigma = 0.01, 0.1
        ay = np.abs(yb)
        rho = 0.505 + 0.495 * np.tanh((ay - 0.5) / a)
        v1 = vflow * np.tanh((ay - 0.5) / a)
        v2 = amp * vflow * np.sin(tp * xb) * np.exp(
            -((ay - 0.5) ** 2) / sigma ** 2)
        v2 = np.where(yb < 0.0, -v2, v2)
        u[:, IDN] = rho
        u[:, IM1] = rho * v1
        u[:, IM2] = rho * v2
        u[:, IEN] = 1.0 / gm1 + 0.5 * (u[:, IM1] ** 2 + u[:, IM2] ** 2) / rho
    elif iprob == 4:
        # Lecoanet et al. 2016 eq 8; 'ave_sine' enforces x-symmetry
        amp = pin.get_real(p, "amp")
        drho_rho0 = pin.get_or_add_real(p, "drho_rho0", 0.0)
        vboost = pin.get_or_add_real(p, "vboost", 0.0)
        P0, a, sigma = 10.0, 0.05, 0.2
        z1, z2 = -0.5, 0.5
        rho = 1.0 + 0.5 * drho_rho0 * (np.tanh((yb - z1) / a)
                                       - np.tanh((yb - z2) / a))
        v1 = vflow * (np.tanh((yb - z1) / a) - np.tanh((yb - z2) / a)
                      - 1.0) + vboost
        ave_sine = np.sin(tp * xb)
        ave_sine = ave_sine - np.where(xb > 0.0, np.sin(tp * (-0.5 + xb)),
                                       np.sin(tp * (0.5 + xb)))
        ave_sine = ave_sine / 2.0
        v2 = -amp * ave_sine * (np.exp(-((yb - z1) ** 2) / sigma ** 2)
                                + np.exp(-((yb - z2) ** 2) / sigma ** 2))
        u[:, IDN] = rho
        u[:, IM1] = v1 * rho
        u[:, IM2] = v2 * rho
        u[:, IEN] = P0 / gm1 + 0.5 * (u[:, IM1] ** 2 + u[:, IM2] ** 2
                                      + u[:, IM3] ** 2) / rho
    elif iprob == 5:
        a = pin.get_real(p, "a")
        sigma = pin.get_real(p, "sigma")
        drat = pin.get_real(p, "drat")
        amp = pin.get_real(p, "amp")
        w = (np.tanh((np.abs(yb) - 0.25) / a) + 1.0) * 0.5
        rho = w + (1.0 - w) * drat
        u[:, IDN] = rho
        u[:, IM1] = rho * vflow * (w - 0.5)
        u[:, IM2] = rho * amp * np.cos(2.0 * tp * xb) * np.exp(
            -(np.abs(yb) - 0.25) ** 2 / sigma ** 2)
        u[:, IEN] = 2.5 / gm1 + 0.5 * (u[:, IM1] ** 2 + u[:, IM2] ** 2) / rho
    else:
        raise ValueError(f"unknown KH iprob {iprob}")
    return u
