"""Repeated random blasts in a magnetized medium (reference
``src/pgen/rand_blast.cpp``; the JAX package's ``pgen/rand_blast.py``): 30
tabulated blast sites fire at fixed intervals through a first-order split
source (a supernova-driven ISM set-up, cf. Balsara et al. 2004).

The source picks its blast on the host from ``t`` and ``dt`` and sets the
total energy of the cells inside the blast radius on the state's device.
On a refined mesh it runs per level through ``amr.driver.
adapt_split_source`` (the source is pointwise).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.ieee import sqrt
from ..core.indices import IB1, IB2, IB3, IDN, IEN, IM1, IM2, IM3

NUM_BLAST = 30
BLASTS = np.array([
    [7.825e-07, 1.32e-02, 7.56e-02], [-5.413e-02, -4.672e-02, -7.810e-02],
    [-3.211e-02, 6.793e-02, 9.346e-02], [-6.165e-02, 5.194e-02, -1.690e-02],
    [5.346e-03, 5.297e-02, 6.711e-02], [7.698e-04, -6.165e-02, -9.331e-02],
    [4.174e-02, 6.867e-02, 5.889e-02], [9.304e-02, -1.538e-02, 5.269e-02],
    [9.196e-03, -3.460e-02, -5.840e-02], [7.011e-02, 9.103e-02, -2.378e-02],
    [-7.375e-02, 4.746e-03, -2.639e-02], [3.653e-02, 2.470e-02, -1.745e-03],
    [7.268e-03, -3.683e-02, 8.847e-02], [-7.272e-02, 4.364e-02, 7.664e-02],
    [4.777e-02, -7.622e-02, -7.250e-02], [-1.023e-02, 9.08e-03, 6.06e-03],
    [-9.534e-03, -4.954e-02, 5.162e-02], [-9.092e-02, -5.223e-03, 7.374e-03],
    [9.138e-02, 5.297e-02, -5.355e-02], [9.409e-02, -9.499e-02, 7.615e-02],
    [7.702e-02, 8.278e-02, -8.746e-02], [-7.306e-02, -5.846e-02, 5.373e-02],
    [4.679e-02, 2.872e-02, -8.216e-02], [7.482e-02, 5.545e-02, 8.907e-02],
    [6.248e-02, -1.579e-02, -8.402e-02], [-9.090e-02, 2.745e-02, -5.857e-02],
    [-1.130e-02, 6.520e-02, -8.496e-02], [-3.186e-02, 3.858e-02, 3.877e-02],
    [4.997e-02, -8.524e-02, 5.871e-02], [8.455e-02, -4.098e-02, -4.438e-02],
])
DT_BETWEEN_BLASTS = 0.00125
BLAST_RADIUS = 0.005
BLAST_PRESSURE = 13649.6


def problem_generator(pin, mesh, cfg, eos):
    p = "problem/rand_blast"
    gm1 = pin.get_or_add_real("hydro", "gamma", 5.0 / 3.0) - 1.0
    p0 = pin.get_or_add_real(p, "p0", 0.3)
    rho0 = pin.get_or_add_real(p, "rho0", 1.0)
    bx0 = pin.get_or_add_real(p, "Bx0", 0.056117)
    u = np.zeros((mesh.nblocks, cfg.nvar) + mesh.block_shape)
    u[:, IDN] = rho0
    u[:, IB1] = bx0
    u[:, IEN] = p0 / gm1 + 0.5 * bx0 * bx0
    return u


def blast_index(t, dt):
    """The blast whose time falls in [t, t + dt), or -1 (host side)."""
    for i in range(NUM_BLAST):
        tb = (i + 1) * DT_BETWEEN_BLASTS
        if tb >= t and tb < t + float(dt):
            return i
    return -1


def problem_source_first_order(pin, mesh, cfg, eos):
    """Fire blast i when its time falls inside this cycle
    (``RandomBlasts``, rand_blast.cpp)."""
    gm1 = pin.get_real("hydro", "gamma") - 1.0
    x, y, z = mesh.cell_centers_mesh()
    shape = (mesh.nblocks,) + mesh.block_shape
    coords = [np.ascontiguousarray(np.broadcast_to(c, shape))
              for c in (x, y, z)]
    on = {}   # the coordinates on each device the source has seen

    def src(u, dt, t):
        blast_i = blast_index(t, dt)
        if blast_i < 0:
            return u
        if u.device not in on:
            # f64, as the JAX package's coordinates under x64
            on[u.device] = [torch.as_tensor(c, device=u.device)
                            for c in coords]
        xb, yb, zb = on[u.device]
        bx, by, bz = (float(v) for v in BLASTS[blast_i])
        dist = sqrt((xb - bx) ** 2 + (yb - by) ** 2 + (zb - bz) ** 2)
        inside = dist < BLAST_RADIUS
        e_new = (BLAST_PRESSURE / gm1
                 + 0.5 * (u[:, IB1] ** 2 + u[:, IB2] ** 2 + u[:, IB3] ** 2)
                 + 0.5 / u[:, IDN] * (u[:, IM1] ** 2 + u[:, IM2] ** 2
                                      + u[:, IM3] ** 2))
        u = u.clone()
        u[:, IEN] = torch.where(inside, e_new, u[:, IEN])
        return u

    return src
