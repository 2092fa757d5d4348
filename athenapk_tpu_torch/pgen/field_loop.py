"""Advected magnetic field loop (reference ``src/pgen/field_loop.cpp``;
Gardiner & Stone 2005): weak B-loop advected diagonally; divB control and
field-decay regression.  iprob selects the loop plane/orientation; adds the
UserRelDivB history column."""

from __future__ import annotations

import math

import numpy as np

from ..core.indices import IDN, IM1, IM2, IM3, IEN, IB1, IB2, IB3


def problem_generator(pin, mesh, cfg, eos):
    p = "problem/field_loop"
    gm1 = pin.get_real("hydro", "gamma") - 1.0
    rad = pin.get_real(p, "rad")
    amp = pin.get_real(p, "amp")
    vflow = pin.get_real(p, "vflow")
    drat = pin.get_or_add_real(p, "drat", 1.0)
    iprob = pin.get_integer(p, "iprob")

    x1size = mesh.x1max - mesh.x1min
    x2size = mesh.x2max - mesh.x2min
    two_d = mesh.ndim < 3
    x3size = 0.0 if two_d else (mesh.x3max - mesh.x3min)

    x, y, z = mesh.cell_centers_mesh()
    shape = (mesh.nblocks,) + mesh.block_shape
    xb = np.broadcast_to(x, shape).copy()
    yb = np.broadcast_to(y, shape).copy()
    zb = np.broadcast_to(z, shape).copy()

    ax = np.zeros(shape)
    ay = np.zeros(shape)
    az = np.zeros(shape)

    def loop_pot(a, b):
        r = np.sqrt(a ** 2 + b ** 2)
        return np.where(r < rad, amp * (rad - r), 0.0)

    if iprob == 1:      # loop in x-y plane
        az = loop_pot(xb, yb)
    elif iprob == 2:    # loop in y-z plane
        ax = loop_pot(yb, zb)
    elif iprob == 3:    # loop in z-x plane
        ay = loop_pot(xb, zb)
    elif iprob == 4:    # rotated loop (2D in the tilted plane)
        if x1size == x3size:
            cos_a2 = sin_a2 = math.sqrt(0.5)
        else:
            ang_2 = math.atan(x1size / x3size)
            sin_a2, cos_a2 = math.sin(ang_2), math.cos(ang_2)
        lam = x1size * cos_a2 if cos_a2 >= sin_a2 else x3size * sin_a2
        xr = xb * cos_a2 + zb * sin_a2
        xr = (xr + 0.5 * lam) % lam - 0.5 * lam
        pot = loop_pot(xr, yb)
        ax = pot * (-sin_a2)
        az = pot * cos_a2
    elif iprob == 5:    # spherical "loop"
        r3 = np.sqrt(xb ** 2 + yb ** 2 + zb ** 2)
        pot = np.where(r3 < rad, amp * (rad - r3), 0.0)
        ay = pot
        az = pot
    else:
        raise ValueError(f"unknown field_loop iprob {iprob}")

    def d_dx(q):
        out = np.zeros_like(q)
        out[..., 1:-1] = (q[..., 2:] - q[..., :-2]) / (2 * mesh.dx1)
        return out

    def d_dy(q):
        out = np.zeros_like(q)
        out[..., 1:-1, :] = (q[..., 2:, :] - q[..., :-2, :]) / (2 * mesh.dx2)
        return out

    def d_dz(q):
        out = np.zeros_like(q)
        if not two_d:
            out[:, 1:-1] = (q[:, 2:] - q[:, :-2]) / (2 * mesh.dx3)
        return out

    b1 = d_dy(az) - d_dz(ay)
    b2 = d_dz(ax) - d_dx(az)
    b3 = d_dx(ay) - d_dy(ax)

    rsq3 = xb ** 2 + yb ** 2 + zb ** 2
    rho = np.where(rsq3 < rad * rad, drat, 1.0)

    u = np.zeros((mesh.nblocks, cfg.nvar) + mesh.block_shape)
    u[:, IDN] = rho
    u[:, IM1] = rho * vflow * x1size
    u[:, IM2] = rho * vflow * x2size
    u[:, IM3] = rho * vflow * x3size
    u[:, IB1] = b1
    u[:, IB2] = b2
    u[:, IB3] = b3
    u[:, IEN] = (1.0 / gm1 + 0.5 * (b1 ** 2 + b2 ** 2 + b3 ** 2)
                 + 0.5 * (u[:, IM1] ** 2 + u[:, IM2] ** 2 + u[:, IM3] ** 2)
                 / rho)
    return u
