"""OU-driven turbulence (reference ``src/pgen/turbulence.cpp``; the JAX
package's ``pgen/turbulence.py``).

Initial state: uniform rho0 / p0 (/ v0) with one of the B configurations
(uniform net flux, no net flux in two halves or as sin(z), a field loop),
B normalised so that the mean magnetic energy is b0^2 / 2 (the reference's
``MPI_Allreduce`` normalisation, ``turbulence.cpp:327``).

Driving (``turbulence.cpp:476``, a first-order split source): each cycle
the OU few-modes spectrum evolves on the host (``utils.few_modes_ft``),
the inverse transform gives the acceleration on the state's device (f64
whatever the state's dtype, cast only where it is added), the mean
momentum injection is subtracted and the field normalised to
``accel_rms``; then momentum and energy get their kicks.  The reductions
stay on the device as 0-d tensors: the driving reads the host nowhere.
On a refined mesh (``problem_source_first_order_smr``) one spectrum
drives every level, and the mean and the rms are reduced across levels,
volume-weighted.

The forcing driver is cached per ``ParameterInput`` (``forcing_driver``,
``forcing_driver_smr``): two runs built from one ``pin`` share one random
stream; on a remesh the refined driver keeps its spectrum and RNG and only
rebinds its phase tables.  ``load_state``'s ``forcing`` sets its state.

Tracers (``tracer_extra_fields``, ``problem_fill_tracers``, the
reference's ``ProblemInitTracerData`` and ``ProblemFillTracers``): every
tracer carries lookback vectors of s = log(rho) and its rate; after each
cycle they shift on the device and the mean correlations over the active
tracers are appended to ``correlations.csv``, one host read per cycle for
the whole row.
"""

from __future__ import annotations

import math
import weakref

import numpy as np
import torch
from torch.profiler import record_function

from ..core.ieee import sqrt
from ..core.indices import (GLMMHD, IB1, IB2, IB3, IDN, IEN, IM1, IM2, IM3,
                            IPR)
from ..utils.few_modes_ft import FewModesFT, FewModesFTSmr

_driver_cache = weakref.WeakKeyDictionary()
_smr_cache = weakref.WeakKeyDictionary()


def _parse_modes(pin):
    num_modes = pin.get_integer("problem/turbulence", "num_modes")
    k_vec = np.zeros((3, num_modes))
    for j in range(3):
        for i in range(1, num_modes + 1):
            k_vec[j, i - 1] = pin.get_integer("modes", f"k_{i}_{j}")
    return num_modes, k_vec


def _ou_args(pin):
    p = "problem/turbulence"
    num_modes, k_vec = _parse_modes(pin)
    return (num_modes, k_vec), dict(
        k_peak=pin.get_or_add_real(p, "kpeak", 0.0),
        sol_weight=pin.get_or_add_real(p, "sol_weight", 1.0),
        t_corr=pin.get_real(p, "corr_time"),
        rseed=pin.get_or_add_integer(p, "rseed", 31224))


def forcing_driver(pin, mesh):
    """The uniform mesh's ``FewModesFT`` of this ``pin`` (one per pin)."""
    if pin not in _driver_cache:
        args, kw = _ou_args(pin)
        _driver_cache[pin] = FewModesFT(mesh, *args, **kw)
    return _driver_cache[pin]


def forcing_driver_smr(pin, smesh):
    """The refined mesh's ``FewModesFTSmr`` of this ``pin``; rebound to
    ``smesh``'s leaves when they changed (the OU spectrum and the RNG
    stay, so the driving is continuous across a remesh)."""
    obj = _smr_cache.get(pin)
    if obj is None:
        args, kw = _ou_args(pin)
        obj = _smr_cache[pin] = FewModesFTSmr(smesh, *args, **kw)
    elif obj.smesh is not smesh:
        obj.rebind(smesh)
    return obj


def problem_generator(pin, mesh, cfg, eos):
    p = "problem/turbulence"
    gm1 = pin.get_real("hydro", "gamma") - 1.0
    p0 = pin.get_real(p, "p0")
    rho0 = pin.get_real(p, "rho0")
    v0 = [float(v) for v in
          pin.get_or_add_string(p, "v0", "0.0, 0.0, 0.0").replace(
              ",", " ").split()]

    u = np.zeros((mesh.nblocks, cfg.nvar) + mesh.block_shape)
    u[:, IDN] = rho0
    u[:, IM1] = rho0 * v0[0]
    u[:, IM2] = rho0 * v0[1]
    u[:, IM3] = rho0 * v0[2]
    u[:, IEN] = p0 / gm1 + 0.5 * rho0 * sum(v * v for v in v0)

    if cfg.fluid == GLMMHD:
        b0 = pin.get_real(p, "b0")
        b_config = pin.get_integer(p, "b_config")
        if b_config == 3:
            raise ValueError("random B fields not implemented (matches ref)")
        x, y, z = mesh.cell_centers_mesh()
        shape = (mesh.nblocks,) + mesh.block_shape
        zb = np.broadcast_to(z, shape)
        Lz = mesh.x3max - mesh.x3min
        kz = 2.0 * math.pi / Lz

        b1 = np.zeros(shape)
        b2 = np.zeros(shape)
        b3 = np.zeros(shape)
        if b_config == 0:      # uniform net-flux field
            b1[:] = b0
        elif b_config == 1:    # no net flux, uniform halves
            b1[:] = np.where(zb < mesh.x3min + Lz / 2.0, b0, -b0)
        elif b_config == 2:    # no net flux, sin(z)
            b1[:] = b0 / math.sqrt(0.5) * np.sin(kz * zb)
        elif b_config == 4:    # field loop
            x0 = pin.get_or_add_real(p, "x0", 0.5)
            y0 = pin.get_or_add_real(p, "y0", 0.5)
            # z0 is read (and recorded) as the reference reads it; the loop
            # potential is 2-D in (x, y), so it is not used
            pin.get_or_add_real(p, "z0", 0.5)
            rad = pin.get_or_add_real(p, "loop_rad", 0.25)
            xb = np.broadcast_to(x, shape)
            yb = np.broadcast_to(y, shape)
            rr = np.sqrt((xb - x0) ** 2 + (yb - y0) ** 2)
            az = np.where(rr < rad, b0 * (rad - rr), 0.0)
            b1p = np.zeros(shape)
            b2p = np.zeros(shape)
            b1p[..., 1:-1, :] = (az[..., 2:, :] - az[..., :-2, :]) \
                / (2 * mesh.dx2)
            b2p[..., 1:-1] = -(az[..., 2:] - az[..., :-2]) / (2 * mesh.dx1)
            b1 += b1p
            b2 += b2p
        else:
            raise ValueError(f"unknown b_config {b_config}")

        # normalise so that the mean magnetic energy is b0^2 / 2
        sl = mesh.interior_slices
        isl = tuple([sl[0]] + list(sl[2:]))
        e_mag_mean = (0.5 * (b1[isl] ** 2 + b2[isl] ** 2
                             + b3[isl] ** 2)).mean()
        b_norm = math.sqrt(e_mag_mean / (0.5 * b0 * b0))
        b1 /= b_norm
        b2 /= b_norm
        b3 /= b_norm
        u[:, IB1] = b1
        u[:, IB2] = b2
        u[:, IB3] = b3
        u[:, IEN] += 0.5 * (b1 ** 2 + b2 ** 2 + b3 ** 2)
    return u


def _kick(u, isl, acc, rho, dt):
    """Momentum and energy kicks of the (normalised, f64) acceleration on
    the interior ``isl`` of ``u``, in place; each increment is cast to the
    state's dtype where it is added."""
    m1 = u[:, IM1][isl]
    m2 = u[:, IM2][isl]
    m3 = u[:, IM3][isl]
    qa = dt * rho
    de = (m1 * dt * acc[0] + m2 * dt * acc[1] + m3 * dt * acc[2]
          + (acc[0] ** 2 + acc[1] ** 2 + acc[2] ** 2) * qa * qa
          / (2.0 * rho))
    for row, inc in ((IEN, de), (IM1, qa * acc[0]), (IM2, qa * acc[1]),
                     (IM3, qa * acc[2])):
        u[(slice(None), row) + isl[1:]] += inc.to(u.dtype)
    return u


def problem_source_first_order(pin, mesh, cfg, eos):
    """The per-cycle driving (``Generate`` + ``Perturb``)."""
    fmft = forcing_driver(pin, mesh)
    accel_rms = pin.get_real("problem/turbulence", "accel_rms")
    sl = mesh.interior_slices
    isl = tuple([sl[0]] + list(sl[2:]))    # the interior without var axis
    vol = mesh.dx1 * mesh.dx2 * mesh.dx3
    total_vol = ((mesh.x1max - mesh.x1min) * (mesh.x2max - mesh.x2min)
                 * (mesh.x3max - mesh.x3min))

    def driving(u, dt, t):
        acc = fmft.generate(float(dt), u.device)   # f64 [3, nb, nz, ny, nx]
        rho = u[:, IDN][isl]
        mass = torch.sum(rho) * vol
        mean_acc = [torch.sum(rho * acc[n]) * vol / mass for n in range(3)]
        for n in range(3):
            acc[n] -= mean_acc[n]
        ampl_sum = torch.sum(acc ** 2) * vol
        acc *= accel_rms / sqrt(ampl_sum / total_vol)
        u = _kick(u.clone(), isl, acc, rho, dt)
        del acc
        return u

    return driving


def problem_source_first_order_smr(pin, smesh, cfg, eos):
    """OU driving on a refined mesh: per-level accelerations from the ONE
    spectrum at each leaf's phases, the mean-momentum subtraction and the
    rms normalisation reduced volume-weighted ACROSS levels (the
    reference's mesh-wide reduction, ``turbulence.cpp:415-443``)."""
    forcing_driver_smr(pin, smesh)
    accel_rms = pin.get_real("problem/turbulence", "accel_rms")
    b = smesh.base
    isl = (slice(None), slice(b.ng3, b.ng3 + b.mbnx3),
           slice(b.ng2, b.ng2 + b.mbnx2), slice(b.ng1, b.ng1 + b.mbnx1))
    vols = {lev: float(np.prod(smesh.dx(lev))) for lev in smesh.level_ids}
    total_vol = ((b.x1max - b.x1min) * (b.x2max - b.x2min)
                 * (b.x3max - b.x3min))

    def driving(state, dt, t):
        # the shared driver, bound to this closure's leaves (an adaptive
        # run may come back to a leaf table it had before)
        fmft = forcing_driver_smr(pin, smesh)
        dev = next(iter(state.values())).device
        accs = fmft.generate(float(dt), dev)
        rhos = {lev: u[:, IDN][isl] for lev, u in state.items()}
        mass = sum(torch.sum(rhos[lev]) * vols[lev] for lev in state)
        mean_acc = [sum(torch.sum(rhos[lev] * accs[lev][n]) * vols[lev]
                        for lev in state) / mass for n in range(3)]
        for acc in accs.values():
            for n in range(3):
                acc[n] -= mean_acc[n]
        ampl_sum = sum(torch.sum(accs[lev] ** 2) * vols[lev]
                       for lev in state)
        norm = accel_rms / sqrt(ampl_sum / total_vol)
        out = {lev: _kick(u.clone(), isl, accs[lev] * norm, rhos[lev], dt)
               for lev, u in state.items()}
        del accs
        return out

    return driving


N_LOOKBACK = 12


def tracer_extra_fields(pin):
    """Per-tracer lookback vectors s = log(rho) and sdot
    (``ProblemInitTracerData``, ``turbulence.cpp:200-219``)."""
    return {"s": (N_LOOKBACK,), "sdot": (N_LOOKBACK,)}


def problem_fill_tracers(pin, mesh, cfg, state, ncycle, time, dt):
    """Shift the tracers' lookback entries and append the row of mean
    correlations to ``correlations.csv`` (``ProblemFillTracers``,
    ``turbulence.cpp:513-650``).

    Lookback slot ``idx`` (1..L-1) inherits slot ``idx-1`` every
    ``2^(idx-1)`` cycles, so the vector spans 1..2^(L-2) cycles of
    history; slot 0 is the current cycle.  The correlations are means over
    the active tracers of s[0]*s[idx] and sdot[0]*sdot[idx].  Everything
    stays on the state's device; the row comes to the host in one read."""
    L = N_LOOKBACK
    state = dict(state)
    dev = state["active"].device
    if "t_lookback" not in state:
        state["t_lookback"] = torch.zeros(L, dtype=torch.float64, device=dev)
    mask_np = np.zeros(L, bool)
    for idx in range(1, L):
        if ncycle % (1 << (idx - 1)) == 0:
            mask_np[idx] = True
    mask = torch.as_tensor(mask_np, device=dev)

    def shift(a):
        return torch.where(mask, torch.cat([a[..., :1], a[..., :-1]], -1), a)

    tlb = shift(state["t_lookback"])
    tlb[0] = time
    state["t_lookback"] = tlb
    s = shift(state["s"])
    sdot = shift(state["sdot"])
    act = state["active"]
    s0 = torch.where(act, torch.log(torch.clamp(state["rho"], min=1e-30)),
                     0.0)
    inv_dt = 1.0 / dt if dt > 0.0 else 0.0
    sdot0 = torch.where(act, (s0 - s[..., 1]) * inv_dt, 0.0)
    s[..., 0] = s0
    sdot[..., 0] = sdot0
    state["s"], state["sdot"] = s, sdot

    n_act = torch.clamp(act.sum(), min=1)
    aw = act[..., None]
    corr_s = torch.where(aw, s[..., :1] * s, 0.0).sum(dim=(0, 1)) / n_act
    corr_sdot = torch.where(aw, sdot[..., :1] * sdot, 0.0).sum(
        dim=(0, 1)) / n_act
    vals = torch.cat([torch.stack([s0.sum() / n_act, sdot0.sum() / n_act]),
                      corr_s, corr_sdot, tlb])
    with record_function("host_read"):
        row_vals = vals.tolist()

    with open("correlations.csv", "w" if ncycle == 0 else "a") as fh:
        if ncycle == 0:
            cols = ["cycle", "time", "s", "sdot"]
            for var in ("corr_s", "corr_sdot", "t_lookback"):
                cols += [f"{var}[{i}]" for i in range(L)]
            fh.write("# " + ", ".join(cols) + "\n")
        row = [str(ncycle), repr(float(time))]
        row += [repr(float(v)) for v in row_vals]
        fh.write(",".join(row) + "\n")
    return state


def history_columns(pin, mesh, cfg, eos):
    """Turbulence history: Ms, Ma, plasma beta (``TurbulenceHst``,
    ``turbulence.cpp:48-101``), volume-weighted RMS values."""
    gamma = pin.get_real("hydro", "gamma")

    def _ms(u, w, mesh):
        wi = w[mesh.interior_slices]
        v2 = (wi[:, 1] ** 2 + wi[:, 2] ** 2 + wi[:, 3] ** 2)
        cs2 = gamma * wi[:, IPR] / wi[:, IDN]
        return float(sqrt(torch.mean(v2 / cs2)))

    cols = [("Ms", _ms)]
    if cfg.fluid == GLMMHD:
        def _ma(u, w, mesh):
            wi = w[mesh.interior_slices]
            v2 = (wi[:, 1] ** 2 + wi[:, 2] ** 2 + wi[:, 3] ** 2)
            va2 = (wi[:, IB1] ** 2 + wi[:, IB2] ** 2
                   + wi[:, IB3] ** 2) / wi[:, IDN]
            return float(sqrt(torch.mean(v2 / torch.clamp(va2, min=1e-30))))

        def _beta(u, w, mesh):
            wi = w[mesh.interior_slices]
            pb = 0.5 * (wi[:, IB1] ** 2 + wi[:, IB2] ** 2 + wi[:, IB3] ** 2)
            return float(torch.mean(wi[:, IPR] / torch.clamp(pb, min=1e-30)))

        cols += [("Ma", _ma), ("plasma_beta", _beta)]
    return cols
