"""Liska-Wendroff implosion (reference ``src/pgen/lw_implode.cpp``):
corner-symmetry preservation test (hydro only)."""

from __future__ import annotations

import numpy as np

from ..core.indices import IDN, IEN


def problem_generator(pin, mesh, cfg, eos):
    p = "problem/lw_implode"
    d_in = pin.get_real(p, "d_in")
    p_in = pin.get_real(p, "p_in")
    d_out = pin.get_real(p, "d_out")
    p_out = pin.get_real(p, "p_out")
    gm1 = pin.get_real("hydro", "gamma") - 1.0

    # diagonal through the midpoint, snapped to the cell face just above the
    # y midline (matches the reference's y0 adjustment for exact symmetry)
    y_mid = 0.5 * (mesh.x2max + mesh.x2min)
    ny_above = int(np.ceil((y_mid - mesh.x2min) / mesh.dx2 - 0.5))
    y0 = mesh.x2min + (ny_above + 1) * mesh.dx2

    x, y, _ = mesh.cell_centers_mesh()
    shape = (mesh.nblocks,) + mesh.block_shape
    xb = np.broadcast_to(x, shape)
    yb = np.broadcast_to(y, shape)

    outside = yb > (y0 - xb)
    u = np.zeros((mesh.nblocks, cfg.nvar) + mesh.block_shape)
    u[:, IDN] = np.where(outside, d_out, d_in)
    u[:, IEN] = np.where(outside, p_out / gm1, p_in / gm1)
    return u
