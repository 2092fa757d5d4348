"""Circularly polarized Alfven wave (reference ``src/pgen/cpaw.cpp``;
Toth 2000, JCP 161, 605).  Nonlinear exact solution of ideal MHD — used for
MHD convergence testing; errors vs initial data go to ``cpaw-errors.dat``."""

from __future__ import annotations

import math

import numpy as np

from ..core.indices import IDN, IM1, IM2, IM3, IEN, IB1, IB2, IB3, IPS

import weakref

_cache = weakref.WeakKeyDictionary()


class _CpawGeom:
    def __init__(self, pin):
        p = "problem/cpaw"
        self.b_par = pin.get_real(p, "b_par")
        self.b_perp = pin.get_real(p, "b_perp")
        self.pres = pin.get_real(p, "pres")
        self.v_par = pin.get_or_add_real(p, "v_par", 0.0)
        self.dir = pin.get_or_add_integer(p, "dir", 1)
        self.gamma = pin.get_real("hydro", "gamma")
        ang_2 = pin.get_or_add_real(p, "ang_2", -999.9)
        ang_3 = pin.get_or_add_real(p, "ang_3", -999.9)
        self.den = 1.0

        mb = "parthenon/mesh"
        x1size = pin.get_real(mb, "x1max") - pin.get_real(mb, "x1min")
        x2size = pin.get_real(mb, "x2max") - pin.get_real(mb, "x2min")
        x3size = pin.get_real(mb, "x3max") - pin.get_real(mb, "x3min")
        if ang_3 == -999.9:
            ang_3 = math.atan(x1size / x2size)
        self.sin_a3, self.cos_a3 = math.sin(ang_3), math.cos(ang_3)
        if ang_2 == -999.9:
            ang_2 = math.atan(0.5 * (x1size * self.cos_a3
                                     + x2size * self.sin_a3) / x3size)
        self.sin_a2, self.cos_a2 = math.sin(ang_2), math.cos(ang_2)
        x1 = x1size * self.cos_a2 * self.cos_a3
        x2 = x2size * self.cos_a2 * self.sin_a3
        x3 = x3size * self.sin_a2
        lam = x1
        if pin.get_integer(mb, "nx2") > 1 and ang_3 != 0.0:
            lam = min(lam, x2)
        if pin.get_integer(mb, "nx3") > 1 and ang_2 != 0.0:
            lam = min(lam, x3)
        self.lam = lam
        self.k_par = 2.0 * math.pi / lam
        self.v_perp = self.b_perp / math.sqrt(self.den)
        self.fac = 1.0 if self.dir == 1 else -1.0

    def phase(self, x1, x2, x3):
        return (self.cos_a2 * (x1 * self.cos_a3 + x2 * self.sin_a3)
                + x3 * self.sin_a2)

    def rot(self, qx, qy, qz):
        q1 = (qx * self.cos_a2 * self.cos_a3 - qy * self.sin_a3
              - qz * self.sin_a2 * self.cos_a3)
        q2 = (qx * self.cos_a2 * self.sin_a3 + qy * self.cos_a3
              - qz * self.sin_a2 * self.sin_a3)
        q3 = qx * self.sin_a2 + qz * self.cos_a2
        return q1, q2, q3


def _geom(pin):
    if pin not in _cache:
        _cache[pin] = _CpawGeom(pin)
    return _cache[pin]


def _vector_potential(g, x1, x2, x3):
    x = (x1 * g.cos_a2 * g.cos_a3 + x2 * g.cos_a2 * g.sin_a3 + x3 * g.sin_a2)
    y = -x1 * g.sin_a3 + x2 * g.cos_a3
    Ay = g.fac * (g.b_perp / g.k_par) * np.sin(g.k_par * x)
    Az = (g.b_perp / g.k_par) * np.cos(g.k_par * x) + g.b_par * y
    a1 = -Ay * g.sin_a3 - Az * g.sin_a2 * g.cos_a3
    a2 = Ay * g.cos_a3 - Az * g.sin_a2 * g.sin_a3
    a3 = Az * g.cos_a2
    return a1, a2, a3


def problem_generator(pin, mesh, cfg, eos):
    g = _geom(pin)
    gm1 = g.gamma - 1.0
    x, y, z = mesh.cell_centers_mesh()
    shape = (mesh.nblocks,) + mesh.block_shape
    xb = np.broadcast_to(x, shape)
    yb = np.broadcast_to(y, shape)
    zb = np.broadcast_to(z, shape)

    xw = g.phase(xb, yb, zb)
    sn = np.sin(g.k_par * xw)
    cs = g.fac * np.cos(g.k_par * xw)

    mx = g.den * g.v_par * np.ones_like(xw)
    my = -g.fac * g.den * g.v_perp * sn
    mz = -g.fac * g.den * g.v_perp * cs
    m1, m2, m3 = g.rot(mx, my, mz)

    a1, a2, a3 = _vector_potential(g, xb, yb, zb)

    def d_dx(q):
        out = np.zeros_like(q)
        out[..., 1:-1] = (q[..., 2:] - q[..., :-2]) / (2 * mesh.dx1)
        return out

    def d_dy(q):
        out = np.zeros_like(q)
        if mesh.nx2 > 1:
            out[..., 1:-1, :] = (q[..., 2:, :] - q[..., :-2, :]) / (2 * mesh.dx2)
        return out

    def d_dz(q):
        out = np.zeros_like(q)
        if mesh.nx3 > 1:
            out[:, 1:-1] = (q[:, 2:] - q[:, :-2]) / (2 * mesh.dx3)
        return out

    b1 = d_dy(a3) - d_dz(a2)
    b2 = d_dz(a1) - d_dx(a3)
    b3 = d_dx(a2) - d_dy(a1)

    u = np.zeros((mesh.nblocks, 9) + mesh.block_shape)
    u[:, IDN] = g.den
    u[:, IM1] = m1
    u[:, IM2] = m2
    u[:, IM3] = m3
    u[:, IB1] = b1
    u[:, IB2] = b2
    u[:, IB3] = b3
    u[:, IEN] = (g.pres / gm1 + 0.5 * (b1 * b1 + b2 * b2 + b3 * b3)
                 + 0.5 / g.den * (m1 * m1 + m2 * m2 + m3 * m3))
    u[:, IPS] = 0.0
    return u


def user_work_after_loop(pin, mesh, cfg, eos, sim):
    if not pin.get_or_add_bool("problem/cpaw", "compute_error", False):
        return
    g = _geom(pin)
    gm1 = g.gamma - 1.0
    x, y, z = mesh.cell_centers_mesh()
    shape = (mesh.nblocks,) + mesh.block_shape
    xw = g.phase(np.broadcast_to(x, shape), np.broadcast_to(y, shape),
                 np.broadcast_to(z, shape))
    sn = np.sin(g.k_par * xw)
    cs = g.fac * np.cos(g.k_par * xw)

    # analytic solution: sampled point values (reference UserWorkAfterLoop)
    m1, m2, m3 = g.rot(g.den * g.v_par * np.ones_like(xw),
                       -g.fac * g.den * g.v_perp * sn,
                       -g.fac * g.den * g.v_perp * cs)
    b1, b2, b3 = g.rot(g.b_par * np.ones_like(xw), g.b_perp * sn,
                       g.b_perp * cs)
    e0 = (g.pres / gm1 + 0.5 * (m1 * m1 + m2 * m2 + m3 * m3) / g.den
          + 0.5 * (b1 * b1 + b2 * b2 + b3 * b3))

    u = sim.cons()
    sl = mesh.interior_slices
    total_cells = mesh.nx1 * mesh.nx2 * mesh.nx3
    refs = {IDN: g.den * np.ones_like(xw), IM1: m1, IM2: m2, IM3: m3,
            IEN: e0, IB1: b1, IB2: b2, IB3: b3}
    comp = [IDN, IM1, IM2, IM3, IEN, IB1, IB2, IB3]
    errs = []
    for c in comp:
        diff = np.abs(u[:, c][tuple([sl[0]] + list(sl[2:]))]
                      - refs[c][tuple([sl[0]] + list(sl[2:]))])
        errs.append(diff.sum() / total_cells)
    rms = math.sqrt(sum(e * e for e in errs))

    import os
    fname = "cpaw-errors.dat"
    new = not os.path.exists(fname)
    with open(fname, "a") as fh:
        if new:
            fh.write("# Nx1  Nx2  Nx3  Ncycle  RMS-Error  d  M1  M2  M3"
                     "  E  B1c  B2c  B3c\n")
        fh.write(f"{mesh.nx1}  {mesh.nx2}  {mesh.nx3}  {sim.ncycle}  "
                 f"{rms:e}  " + "  ".join(f"{e:e}" for e in errs) + "\n")
    sim.cpaw_errors = dict(l1=errs, rms=rms)
