"""Sod shock tube problem generator (reference ``src/pgen/sod.cpp``)."""

from __future__ import annotations

import numpy as np

from ..core.indices import IDN, IM1, IEN


def problem_generator(pin, mesh, cfg, eos):
    p = "problem/sod"
    rho_l = pin.get_or_add_real(p, "rho_l", 1.0)
    pres_l = pin.get_or_add_real(p, "pres_l", 1.0)
    u_l = pin.get_or_add_real(p, "u_l", 0.0)
    rho_r = pin.get_or_add_real(p, "rho_r", 0.125)
    pres_r = pin.get_or_add_real(p, "pres_r", 0.1)
    u_r = pin.get_or_add_real(p, "u_r", 0.0)
    x_discont = pin.get_or_add_real(p, "x_discont", 0.5)

    x, _, _ = mesh.cell_centers_mesh()
    left = x < x_discont
    shape = (mesh.nblocks,) + mesh.block_shape
    rho = np.broadcast_to(np.where(left, rho_l, rho_r), shape)
    vx = np.broadcast_to(np.where(left, u_l, u_r), shape)
    pres = np.broadcast_to(np.where(left, pres_l, pres_r), shape)
    # prim -> cons in numpy (eos.adiabatic.prim_to_cons with v2 = v3 = 0
    # and, for GLM-MHD, B = psi = 0; scalars start at zero)
    u = np.zeros((mesh.nblocks, cfg.nvar) + mesh.block_shape)
    u[:, IDN] = rho
    u[:, IM1] = rho * vx
    u[:, IEN] = pres / eos.gm1 + 0.5 * rho * (vx * vx)
    return u
