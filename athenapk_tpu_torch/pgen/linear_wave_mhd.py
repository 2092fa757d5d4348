"""GLM-MHD linear wave convergence problem (reference
``src/pgen/linear_wave_mhd.cpp``): single Roe-Balsara eigenmode on an
oblique wavevector; B is initialized from a vector potential via central
differences at cell centers so the discrete (central-difference) divB of the
background vanishes.  Errors are appended to ``linearwave-errors.dat``."""

from __future__ import annotations

import numpy as np
import torch

from ..core.indices import IDN, IM1, IM2, IM3, IEN, IB1, IB2, IB3, IPS
from ._linwave_common import WaveGeometry, write_errors_file

import weakref

_geometry_cache = weakref.WeakKeyDictionary()


def _geom(pin):
    if pin not in _geometry_cache:
        _geometry_cache[pin] = WaveGeometry(pin, mhd=True)
    return _geometry_cache[pin]


def init_user_mesh_data(pin):
    _geom(pin)


def _vector_potential(geom, x1, x2, x3, dby, dbz):
    """Rotated vector potential (reference A1/A2/A3, gauge Ax_wave = 0)."""
    x = (x1 * geom.cos_a2 * geom.cos_a3 + x2 * geom.cos_a2 * geom.sin_a3
         + x3 * geom.sin_a2)
    y = -x1 * geom.sin_a3 + x2 * geom.cos_a3
    k = geom.k_par
    Ay = geom.bz0 * x - (dbz / k) * np.cos(k * x)
    Az = -geom.by0 * x + (dby / k) * np.cos(k * x) + geom.bx0 * y
    a1 = -Ay * geom.sin_a3 - Az * geom.sin_a2 * geom.cos_a3
    a2 = Ay * geom.cos_a3 - Az * geom.sin_a2 * geom.sin_a3
    a3 = Az * geom.cos_a2
    return a1, a2, a3


def _exact_cons(geom, mesh):
    x, y, z = mesh.cell_centers_mesh()
    xw = geom.wave_phase(x, y, z)
    sn = np.sin(geom.k_par * xw)
    a = geom.amp
    r = geom.rem
    f = geom.wave_flag
    gm1 = geom.gamma - 1.0

    dby = a * r[5, f]
    dbz = a * r[6, f]

    d = geom.d0 + a * sn * r[0, f]
    mx = geom.d0 * geom.vflow + a * sn * r[1, f]
    my = a * sn * r[2, f]
    mz = a * sn * r[3, f]
    m1, m2, m3 = geom.rotate_to_grid(mx, my, mz)
    e = (geom.p0 / gm1 + 0.5 * geom.d0 * geom.u0 ** 2 + a * sn * r[4, f]
         + 0.5 * (geom.bx0 ** 2 + geom.by0 ** 2 + geom.bz0 ** 2))

    # B from central differences of A at cell centers.  A is evaluated on a
    # one-cell-padded grid so EVERY stored cell gets a valid centered
    # difference — required for the ghost-free (nghost=0) layout where
    # domain-edge cells have no ghost fill to overwrite a garbage rim (A
    # itself is linear-plus-periodic, so it cannot be wrapped cyclically).
    p2 = 1 if mesh.nx2 > 1 else 0
    p3 = 1 if mesh.nx3 > 1 else 0
    xp = np.concatenate([x[..., :1] - mesh.dx1, x, x[..., -1:] + mesh.dx1],
                        axis=-1)
    yp = y if not p2 else np.concatenate(
        [y[..., :1, :] - mesh.dx2, y, y[..., -1:, :] + mesh.dx2], axis=-2)
    zp = z if not p3 else np.concatenate(
        [z[:, :1] - mesh.dx3, z, z[:, -1:] + mesh.dx3], axis=-3)
    pshape = (mesh.nblocks, mesh.NZ + 2 * p3, mesh.NY + 2 * p2, mesh.NX + 2)
    xb = np.broadcast_to(xp, pshape)
    yb = np.broadcast_to(yp, pshape)
    zb = np.broadcast_to(zp, pshape)
    a1, a2, a3 = _vector_potential(geom, xb, yb, zb, dby, dbz)

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

    crop = (slice(None), slice(p3, p3 + mesh.NZ), slice(p2, p2 + mesh.NY),
            slice(1, 1 + mesh.NX))
    b1 = (d_dy(a3) - d_dz(a2))[crop]
    b2 = (d_dz(a1) - d_dx(a3))[crop]
    b3 = (d_dx(a2) - d_dy(a1))[crop]

    nb = mesh.nblocks
    u = np.zeros((nb, 9) + mesh.block_shape)
    u[:, IDN] = np.broadcast_to(d, u[:, IDN].shape)
    u[:, IM1] = np.broadcast_to(m1, u[:, IM1].shape)
    u[:, IM2] = np.broadcast_to(m2, u[:, IM2].shape)
    u[:, IM3] = np.broadcast_to(m3, u[:, IM3].shape)
    u[:, IEN] = np.broadcast_to(e, u[:, IEN].shape)
    u[:, IB1] = b1
    u[:, IB2] = b2
    u[:, IB3] = b3
    u[:, IPS] = 0.0
    return u


def problem_generator(pin, mesh, cfg, eos):
    return _exact_cons(_geom(pin), mesh)


def history_columns(pin, mesh, cfg, eos):
    """Optional MaxAbsV2 history column (``dump_max_v2``; reference
    ``linear_wave_mhd.cpp:739-742``) — the observable the
    diffusion_linwave3d decay-rate suite fits."""
    if not pin.get_or_add_bool("problem/linear_wave", "dump_max_v2",
                               False):
        return ()

    def _max_v2(u, w, mesh):
        return float(torch.max(torch.abs(w[mesh.interior_slices][:, 2])))

    return [("MaxAbsV2", _max_v2)]


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
    # 8 error components: d, M1..M3, E, B1..B3 (psi excluded, as reference)
    comp = [IDN, IM1, IM2, IM3, IEN, IB1, IB2, IB3]
    l1 = diff[:, comp].sum(axis=(0, 2, 3, 4)) * vol / total_vol
    mx = diff[:, comp].max(axis=(0, 2, 3, 4))
    rms = write_errors_file("linearwave-errors.dat", mesh, sim.ncycle, l1, mx)
    sim.linear_wave_errors = dict(l1=l1, max=mx, rms=rms)
