"""Orszag-Tang vortex (reference ``src/pgen/orszag_tang.cpp``): standard 2D
MHD regression problem; B0 = 1/sqrt(4 pi)."""

from __future__ import annotations

import math

import numpy as np

from ..core.indices import IDN, IM1, IM2, IM3, IEN, IB1, IB2, IB3, IPS


def problem_generator(pin, mesh, cfg, eos):
    gm1 = pin.get_real("hydro", "gamma") - 1.0
    d0 = 25.0 / (36.0 * math.pi)
    v0 = 1.0
    p0 = 5.0 / (12.0 * math.pi)
    B0 = 1.0 / math.sqrt(4.0 * math.pi)

    x, y, _ = mesh.cell_centers_mesh()
    shape = (mesh.nblocks,) + mesh.block_shape
    xb = np.broadcast_to(x, shape)
    yb = np.broadcast_to(y, shape)

    u = np.zeros((mesh.nblocks, 9) + mesh.block_shape)
    u[:, IDN] = d0
    u[:, IM1] = d0 * v0 * np.sin(2.0 * math.pi * yb)
    u[:, IM2] = -d0 * v0 * np.sin(2.0 * math.pi * xb)
    u[:, IB1] = B0 * np.sin(2.0 * math.pi * yb)
    u[:, IB2] = B0 * np.sin(4.0 * math.pi * xb)
    u[:, IEN] = (p0 / gm1
                 + 0.5 * (u[:, IB1] ** 2 + u[:, IB2] ** 2 + u[:, IB3] ** 2)
                 + 0.5 * (u[:, IM1] ** 2 + u[:, IM2] ** 2 + u[:, IM3] ** 2)
                 / u[:, IDN])
    u[:, IPS] = 0.0
    return u
