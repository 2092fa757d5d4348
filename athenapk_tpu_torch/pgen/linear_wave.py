"""Hydro linear wave convergence problem (reference
``src/pgen/linear_wave.cpp``): single Roe eigenmode on an oblique
wavevector; after evolution, L1/max errors vs initial data are appended to
``linearwave-errors.dat`` (the convergence suite's protocol)."""

from __future__ import annotations

import numpy as np

from ..core.indices import IDN, IM1, IM2, IM3, IEN
from ._linwave_common import WaveGeometry, write_errors_file

import weakref

_geometry_cache = weakref.WeakKeyDictionary()


def _geom(pin):
    # keyed by the live pin object (WeakKeyDictionary): id()-based keys
    # collide when a freed ParameterInput's address is reused
    if pin not in _geometry_cache:
        _geometry_cache[pin] = WaveGeometry(pin, mhd=False)
    return _geometry_cache[pin]


def init_user_mesh_data(pin):
    """Runs before time params are read (may rescale tlim when test=true)."""
    _geom(pin)


def _exact_cons(geom, mesh):
    """Initial-condition conserved fields (also the t=n*period solution)."""
    x, y, z = mesh.cell_centers_mesh()
    xw = geom.wave_phase(x, y, z)
    sn = np.sin(geom.k_par * xw)
    a = geom.amp
    r = geom.rem
    f = geom.wave_flag
    gm1 = geom.gamma - 1.0

    d = geom.d0 + a * sn * r[0, f]
    mx = geom.d0 * geom.vflow + a * sn * r[1, f]
    my = a * sn * r[2, f]
    mz = a * sn * r[3, f]
    m1, m2, m3 = geom.rotate_to_grid(mx, my, mz)
    e = geom.p0 / gm1 + 0.5 * geom.d0 * geom.u0 ** 2 + a * sn * r[4, f]

    nb = mesh.nblocks
    u = np.zeros((nb, 5) + mesh.block_shape)
    u[:, IDN] = np.broadcast_to(d, u[:, IDN].shape)
    u[:, IM1] = np.broadcast_to(m1, u[:, IM1].shape)
    u[:, IM2] = np.broadcast_to(m2, u[:, IM2].shape)
    u[:, IM3] = np.broadcast_to(m3, u[:, IM3].shape)
    u[:, IEN] = np.broadcast_to(e, u[:, IEN].shape)
    return u


def problem_generator(pin, mesh, cfg, eos):
    return _exact_cons(_geom(pin), mesh)


def user_work_after_loop(pin, mesh, cfg, eos, sim):
    if not pin.get_or_add_bool("problem/linear_wave", "compute_error", False):
        return
    geom = _geom(pin)
    u_ref = _exact_cons(geom, mesh)
    u_now = sim.cons()
    sl = mesh.interior_slices
    diff = np.abs(u_now[sl] - u_ref[sl])
    vol = mesh.dx1 * mesh.dx2 * mesh.dx3
    total_vol = ((mesh.x1max - mesh.x1min) * (mesh.x2max - mesh.x2min)
                 * (mesh.x3max - mesh.x3min))
    l1 = diff.sum(axis=(0, 2, 3, 4)) * vol / total_vol
    mx = diff.max(axis=(0, 2, 3, 4))
    rms = write_errors_file("linearwave-errors.dat", mesh, sim.ncycle, l1, mx)
    sim.linear_wave_errors = dict(l1=l1, max=mx, rms=rms)
