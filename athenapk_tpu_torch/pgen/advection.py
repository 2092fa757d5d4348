"""Smooth Gaussian-blob advection (reference ``src/pgen/advection.cpp``):
uniform flow advecting an over-density; tlim is rescaled so it counts
domain-diagonal crossings."""

from __future__ import annotations

import math

import numpy as np

from ..core.indices import IDN, IM1, IM2, IM3, IEN, NHYDRO, NGLMMHD, GLMMHD

_TINY = 1.0e-20


def init_user_mesh_data(pin):
    mb = "parthenon/mesh"
    x1size = pin.get_real(mb, "x1max") - pin.get_real(mb, "x1min")
    x2size = pin.get_real(mb, "x2max") - pin.get_real(mb, "x2min")
    x3size = pin.get_real(mb, "x3max") - pin.get_real(mb, "x3min")
    p = "problem/advection"
    vx = pin.get_or_add_real(p, "vx", 0.0)
    vy = pin.get_or_add_real(p, "vy", 0.0)
    vz = pin.get_or_add_real(p, "vz", 0.0)
    vmag = math.sqrt(vx * vx + vy * vy + vz * vz) + _TINY
    diag = math.sqrt(x1size ** 2 + x2size ** 2 + x3size ** 2)
    tlim = pin.get_real("parthenon/time", "tlim")
    pin.set("parthenon/time", "tlim", diag / vmag * tlim)


def problem_generator(pin, mesh, cfg, eos):
    p = "problem/advection"
    vx = pin.get_or_add_real(p, "vx", 0.0)
    vy = pin.get_or_add_real(p, "vy", 0.0)
    vz = pin.get_or_add_real(p, "vz", 0.0)
    rho_ratio = pin.get_or_add_real(p, "rho_ratio", 1.0)
    rho_radius = pin.get_or_add_real(p, "rho_radius", 0.0)
    rho_fraction_edge = pin.get_or_add_real(p, "rho_fraction_edge", 0.01)
    rho0 = pin.get_or_add_real(p, "rho0", 1.0)
    p0 = pin.get_or_add_real(p, "p0", 1.0)
    gm1 = pin.get_real("hydro", "gamma") - 1.0
    sigmasq = -rho_radius ** 2 / 2.0 / math.log(rho_fraction_edge)

    x, y, z = mesh.cell_centers_mesh()
    rsq = x ** 2 + y ** 2 + z ** 2
    if sigmasq > 0.0:
        rho = rho0 + np.where(rsq < rho_radius ** 2,
                              rho0 * rho_ratio * np.exp(-rsq / 2.0
                                                        / sigmasq),
                              0.0)
    else:
        # rho_radius = 0: uniform background (avoid a 0/0 inside the
        # unselected where-branch, which numpy still evaluates)
        rho = np.full_like(rsq, rho0)
    rho = np.broadcast_to(rho, (mesh.nblocks,) + mesh.block_shape)

    u = np.zeros((mesh.nblocks, cfg.nvar) + mesh.block_shape)
    u[:, IDN] = rho
    u[:, IM1] = rho * vx
    u[:, IM2] = rho * vy
    u[:, IM3] = rho * vz
    u[:, IEN] = p0 / gm1 + 0.5 * (u[:, IM1] ** 2 + u[:, IM2] ** 2
                                  + u[:, IM3] ** 2) / rho
    # passive scalars trace the blob (density-weighted)
    nbase = NGLMMHD if cfg.fluid == GLMMHD else NHYDRO
    for n in range(nbase, cfg.nvar):
        u[:, n] = rho - rho0
    return u
