"""Cloud-in-wind (reference ``src/pgen/cloud.cpp``; counterpart of
``athenapk_tpu/pgen/cloud.py``): a dense cloud in a hot wind in pressure
equilibrium, with a tanh-smoothed edge, the inflow boundary
``cloud_inflow_x2``, an optional magnetic field set by the plasma beta, a
passive scalar marking the cloud material, and a refinement check on that
scalar.  With tabular cooling it is the cloud-crushing problem.

``problem_generator`` is numpy, as the JAX package's; the boundary hooks
write the wind state into the ghost cells in place, on the state's device;
``check_refinement_block`` tags blocks on the state's device.
"""

from __future__ import annotations

import math
import weakref

import numpy as np
import torch

from ..core.indices import (GLMMHD, IB1, IB2, IB3, IDN, IEN, IM2, NGLMMHD,
                            NHYDRO)
from ..utils.units import Units, mean_molecular_weights

_cache = weakref.WeakKeyDictionary()


class _CloudParams:
    def __init__(self, pin):
        units = Units(pin)
        gamma = pin.get_real("hydro", "gamma")
        gm1 = gamma - 1.0
        he_x = pin.get_real("hydro", "He_mass_fraction")
        mu, _ = mean_molecular_weights(he_x)
        mbar_over_kb = mu * units.mh() / units.k_boltzmann()
        p = "problem/cloud"
        self.r_cloud = pin.get_real(p, "r0_cgs") / units.code_length_cgs
        self.rho_cloud = (pin.get_real(p, "rho_cloud_cgs")
                          / units.code_density_cgs)
        self.rho_wind = (pin.get_real(p, "rho_wind_cgs")
                         / units.code_density_cgs)
        T_wind = pin.get_real(p, "T_wind_cgs")
        v_wind = pin.get_real(p, "v_wind_cgs") / (
            units.code_length_cgs / units.code_time_cgs)
        self.rhoe_wind = T_wind * self.rho_wind / mbar_over_kb / gm1
        pressure = gm1 * self.rhoe_wind
        chi0 = self.rho_cloud / self.rho_wind
        self.t_cc = self.r_cloud * math.sqrt(chi0) / v_wind
        self.mom_wind = self.rho_wind * v_wind
        self.Bx = self.By = self.Bz = 0.0
        beta = pin.get_or_add_real(p, "plasma_beta", -1.0)
        angle = pin.get_or_add_string(p, "mag_field_angle", "undefined")
        if beta > 0.0:
            if angle == "aligned":
                self.By = math.sqrt(2.0 * pressure / beta)
            elif angle == "transverse":
                self.Bx = math.sqrt(2.0 * pressure / beta)
            elif angle == "oblique":
                B = math.sqrt(2.0 * pressure / beta)
                self.Bx = B / math.sqrt(5.0)
                self.Bz = 2 * self.Bx
            else:
                raise ValueError("mag_field_angle must be aligned/"
                                 "transverse/oblique")
        # optional: tlim and the outputs' dt in cloud-crushing times
        if pin.get_or_add_bool(p, "rescale_code_time_to_tcc", False):
            pin.set("parthenon/time", "tlim",
                    pin.get_real("parthenon/time", "tlim") * self.t_cc)
            for blk in pin.output_blocks():
                if pin.has(blk, "dt"):
                    pin.set(blk, "dt", pin.get_real(blk, "dt") * self.t_cc)
            pin.set(p, "rescale_code_time_to_tcc", False)

    def wind(self, nvar, mhd):
        """The conserved wind state, one value per variable."""
        vals = [0.0] * nvar
        vals[IDN] = self.rho_wind
        vals[IM2] = self.mom_wind
        e = self.rhoe_wind + 0.5 * self.mom_wind ** 2 / self.rho_wind
        if mhd:
            vals[IB1], vals[IB2], vals[IB3] = self.Bx, self.By, self.Bz
            e += 0.5 * (self.Bx ** 2 + self.By ** 2 + self.Bz ** 2)
        vals[IEN] = e
        return vals


def _params(pin):
    if pin not in _cache:
        _cache[pin] = _CloudParams(pin)
    return _cache[pin]


def init_user_mesh_data(pin):
    _params(pin)


def problem_generator(pin, mesh, cfg, eos):
    cp = _params(pin)
    steep = pin.get_or_add_real("problem/cloud", "cloud_steepness", 10.0)
    mhd = cfg.fluid == GLMMHD
    if (cp.Bx or cp.By or cp.Bz) and not mhd:
        raise ValueError("plasma_beta > 0 requires glmmhd fluid")

    x, y, z = mesh.cell_centers_mesh()
    shape = (mesh.nblocks,) + mesh.block_shape
    rad = np.broadcast_to(np.sqrt(x ** 2 + y ** 2 + z ** 2), shape)
    rho = cp.rho_wind + 0.5 * (cp.rho_cloud - cp.rho_wind) * (
        1.0 - np.tanh(steep * (rad / cp.r_cloud - 1.0)))
    mom = np.where(rad > 1.3 * cp.r_cloud, cp.mom_wind, 0.0)

    u = np.zeros((mesh.nblocks, cfg.nvar) + mesh.block_shape)
    u[:, IDN] = rho
    u[:, IM2] = mom
    u[:, IEN] = cp.rhoe_wind + 0.5 * mom * mom / rho
    if mhd:
        u[:, IB1] = cp.Bx
        u[:, IB2] = cp.By
        u[:, IB3] = cp.Bz
        u[:, IEN] += 0.5 * (cp.Bx ** 2 + cp.By ** 2 + cp.Bz ** 2)
    # the passive scalar traces the cloud material (the refinement check
    # reads it)
    nbase = NGLMMHD if mhd else NHYDRO
    for n in range(nbase, cfg.nvar):
        u[:, n] = np.where(rad <= cp.r_cloud, rho, 0.0)
    return u


def register_boundary_conditions(pin, mesh, cfg, eos):
    """``cloud_inflow_x2``: the wind state in the inner-x2 ghosts
    (``InflowWindX2``, cloud.cpp), for ``core.boundaries``."""
    vals = _params(pin).wind(cfg.nvar, cfg.fluid == GLMMHD)

    def inflow(layer, ghost_slice, m, dirn, pos):
        wind = torch.tensor(vals, dtype=layer.dtype, device=layer.device)
        layer[ghost_slice] = wind.reshape(cfg.nvar, 1, 1, 1).expand_as(
            layer[ghost_slice])

    return {"cloud_inflow_x2": inflow}


def register_boundary_conditions_smr(pin, smesh, cfg, eos):
    """``cloud_inflow_x2`` on refined meshes: the same wind state in the
    ghosts of the level tensor's blocks ``didx`` (``amr.smr.SmrState``)."""
    vals = _params(pin).wind(cfg.nvar, cfg.fluid == GLMMHD)

    def inflow(u, didx, gsl, lev, axis, lo):
        wind = torch.tensor(vals, dtype=u.dtype, device=u.device)
        idx = (didx, slice(None)) + tuple(gsl)
        u[idx] = wind.reshape(1, cfg.nvar, 1, 1, 1).expand_as(u[idx])

    return {"cloud_inflow_x2": inflow}


def check_refinement_block(pin, mesh, cfg, eos, prim):
    """Scalar-concentration tagging (``ProblemCheckRefinementBlock``):
    refine where the block's largest scalar exceeds 0.01, derefine below
    0.001; -> [nblocks] int32 tags of {-1, 0, +1} on ``prim``'s device."""
    nbase = NGLMMHD if cfg.fluid == GLMMHD else NHYDRO
    sl = mesh.interior_slices
    s = prim[:, nbase][tuple([sl[0]] + list(sl[2:]))]
    mx = torch.amax(s, dim=(1, 2, 3))
    one = torch.ones_like(mx, dtype=torch.int32)
    return torch.where(mx > 0.01, one, torch.where(mx < 0.001, -one,
                                                   0 * one))
